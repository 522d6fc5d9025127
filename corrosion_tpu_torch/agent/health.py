"""Always-on event-loop health: the stall probe, promoted from bench.

The batching PRs (3–5) gate their benches on event-loop stall — a
serve/apply/write path that blocks the loop starves SWIM acks and sync
reads, and the only way those gates caught it was a bench-harness-side
probe (``bench.py _stall_probe``).  This module makes the same
measurement continuous in the agent itself, so a stall regression is
observable in production, not just in a bench run:

* ``corro_loop_stall_ms`` — histogram of per-sample scheduling gaps
  (how late the probe's ``sleep(interval)`` wakeup actually fired);
* ``corro_loop_stall_max_ms`` — lifetime max gauge (the bench gates'
  quantity, continuously maintained);
* ``corro_loop_slow_callbacks_total{site=…}`` — attribution: when a
  stall exceeds the slow threshold, a watchdog *thread* samples the
  loop thread's current Python frame (``sys._current_frames``) and
  counts the innermost in-package frame actually holding the loop.
  The probe coroutine cannot attribute its own starvation — it isn't
  running during the stall; only an out-of-band thread can look.

The probe costs one timer wakeup per ``interval`` (default 50 ms —
20/s) plus one histogram insert; the watchdog thread sleeps except
while a stall is in progress.  ``AgentConfig.stall_probe_interval = 0``
disables the whole thing.
"""

from __future__ import annotations

import asyncio
import sys
import threading
import time
from typing import Dict, Optional

# bounded attribution label set: sites beyond this collapse into
# "other" so a pathological workload cannot mint unbounded series
MAX_ATTRIBUTED_SITES = 32


class LoopHealthProbe:
    """One agent's event-loop stall probe + attribution watchdog."""

    def __init__(self, metrics, interval: float = 0.05,
                 slow_ms: float = 50.0, package: str = "corrosion_tpu_torch",
                 clock=None):
        from corrosion_tpu_torch.clock import SYSTEM_CLOCK

        self.metrics = metrics
        # the probe's wakeup timer rides the injectable clock; the
        # watchdog THREAD stays on real time — its whole job is an
        # out-of-band view of the loop, and thread-side waits are not
        # agent timers (docs/sim.md, virtual-time table)
        self._clock = clock or SYSTEM_CLOCK
        self.interval = max(0.001, float(interval))
        self.slow_ms = float(slow_ms)
        self.package = package
        self.max_stall_ms = 0.0
        self.last_stall_ms = 0.0
        self.samples = 0
        self.slow_sites: Dict[str, int] = {}
        self._beat = time.monotonic()
        self._loop_tid: Optional[int] = None
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None

    # -- the probe task (runs ON the loop) -----------------------------

    async def run(self) -> None:
        """Probe body: measure how late each periodic wakeup fires.
        Cancellation-clean — the agent owns the task's lifecycle."""
        loop = asyncio.get_running_loop()
        self._loop_tid = threading.get_ident()
        self._stop.clear()
        self._watchdog = threading.Thread(
            target=self._watch, name="corro-loop-watchdog", daemon=True
        )
        self._watchdog.start()
        last = loop.time()
        try:
            while True:
                self._beat = time.monotonic()
                await self._clock.sleep(self.interval)
                now = loop.time()
                stall_ms = max(0.0, (now - last - self.interval) * 1e3)
                last = now
                self.samples += 1
                self.last_stall_ms = stall_ms
                self.metrics.histogram("corro_loop_stall_ms", stall_ms)
                if stall_ms > self.max_stall_ms:
                    self.max_stall_ms = stall_ms
                    self.metrics.gauge(
                        "corro_loop_stall_max_ms", self.max_stall_ms
                    )
        finally:
            self._stop.set()

    # -- the watchdog (runs OFF the loop) ------------------------------

    def _watch(self) -> None:
        """Attribution thread: when the probe's heartbeat goes stale
        past the slow threshold, sample what the loop thread is
        executing RIGHT NOW — the only vantage point that can name the
        callback while it is still holding the loop."""
        threshold_s = self.interval + self.slow_ms / 1e3
        while not self._stop.is_set():
            age = time.monotonic() - self._beat
            if age > threshold_s and self._loop_tid is not None:
                site = self._sample_site()
                if site is not None:
                    n = self.slow_sites.get(site)
                    # the overflow bucket counts toward the bound: at
                    # most MAX_ATTRIBUTED_SITES keys INCLUDING "other"
                    if n is None and site != "other" and len(
                        self.slow_sites
                    ) >= MAX_ATTRIBUTED_SITES - 1:
                        site = "other"
                        n = self.slow_sites.get(site)
                    self.slow_sites[site] = (n or 0) + 1
                    self.metrics.counter(
                        "corro_loop_slow_callbacks_total", site=site
                    )
                # one attribution per stall: wait for the heartbeat to
                # move again before sampling anew, so a single long
                # stall counts once instead of once per poll
                beat = self._beat
                while not self._stop.wait(self.interval) \
                        and self._beat == beat:
                    pass
                continue
            self._stop.wait(self.interval)

    def _sample_site(self) -> Optional[str]:
        try:
            frame = sys._current_frames().get(self._loop_tid)
        except Exception:
            return None
        if frame is None:
            return None
        # innermost frame inside our package; an innermost frame in the
        # stdlib (e.g. select/epoll inside the loop itself) with no
        # package frame above it means the loop is idle-polling — skip
        best = None
        f = frame
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod.startswith(self.package):
                best = f"{mod}:{f.f_code.co_name}"
                break  # innermost package frame wins
            f = f.f_back
        return best

    # -- admin surface -------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "interval_s": self.interval,
            "slow_threshold_ms": self.slow_ms,
            "samples": self.samples,
            "max_stall_ms": round(self.max_stall_ms, 3),
            "last_stall_ms": round(self.last_stall_ms, 3),
            "slow_sites": dict(self.slow_sites),
        }
