"""Cluster flight recorder: HLC-stamped metric snapshots + the typed
event journal, in a bounded in-memory ring.

The convergence plane and the scenario matrix both
observe *end states*: a scrape is a point in time, and a failing matrix
cell says "did not converge" with no record of how the run evolved.
This module is the missing time axis — per-node history assembled into
one cluster timeline (``ClusterObserver.flight_timeline``):

* **snapshots** — on ``AgentConfig.flight_interval_s`` (default 1 s,
  wired like ``LoopHealthProbe``) the recorder captures counter DELTAS,
  current gauges, and windowed histogram quantiles from :class:`Metrics`
  in one registry-lock hold (``Metrics.snapshot_state``), HLC-stamped
  so cross-node alignment survives the clock-skew fault family (the
  HLC merges on every message receipt, pulling skewed nodes onto a
  shared axis the raw wall clock does not give);
* **events** — discrete protocol moments emitted at the seams that
  already exist in the runtime (sync session start/end, breaker and
  quarantine transitions, apply/write-group fallbacks, equivocation
  verdicts, crash/restart markers injected by
  ``devcluster.run_crash_schedule``), each a typed record from the
  :data:`EVENT_KINDS` registry — the doc-drift lint
  (``tests/test_telemetry.py``) keeps the registry and
  ``docs/telemetry.md`` in lockstep, like the metric series;
* **export** — optional on-disk jsonl (``[telemetry.flight] path``)
  with the spans-export discipline from ``tracing.py``: bounded file,
  ONE rotation to ``path.1``, further records dropped and counted
  (``corro_flight_export_dropped_total``);
* **crash dump** — an unhandled agent-task exception flushes the whole
  ring to ``<db dir>/flight_crash.jsonl`` (the agent's task supervisor
  calls :meth:`crash_dump`), so a dead loop ships its own post-mortem.

The ring itself is a ``deque(maxlen=ring_max)``: memory is bounded by
construction, and the admin ``flight dump`` / ``flight events``
commands read it live.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

# -- the typed event registry ------------------------------------------
#
# Every kind the journal may carry, with its meaning.  Emission sites
# call Agent._flight_event(kind, ...); an unknown kind raises — the
# registry IS the schema, and the doc-drift lint keeps docs/telemetry.md
# carrying one row per kind (and no phantom rows).

EVENT_KINDS: Dict[str, str] = {
    "sync_client_start": "outbound sync session opened (peer, needs)",
    "sync_client_end": "outbound sync session finished (changes, bytes,"
                       " complete flag)",
    "sync_server_start": "inbound sync session accepted (peer)",
    "sync_server_end": "inbound sync session finished (needs served,"
                       " bytes)",
    "breaker_open": "per-peer circuit breaker opened (addr)",
    "breaker_close": "per-peer circuit breaker closed on half-open"
                     " success (addr)",
    "quarantine": "member quarantine transition (actor/addr, on,"
                  " reason=breaker|equivocation|expired)",
    "apply_group_fallback": "merged apply transaction aborted, fell back"
                            " to per-changeset applies",
    "write_group_fallback": "write routed to the per-transaction oracle"
                            " (reason=stmt|abort)",
    "equivocation": "hostile-changeset verdict (actor, kind=content|"
                    "span|quarantined)",
    "snap_serve": "served one whole-database snapshot to a"
                  " bootstrapping peer (peer, bytes)",
    "snap_install": "installed a served snapshot: digest verified,"
                    " identity rewritten, file atomically swapped in"
                    " (peer, bytes)",
    "snap_abort": "discarded a staged snapshot cleanly (reason="
                  "snap_digest|snap_stream|snap_offer|snap_prepare|"
                  "snap_stale); the previous database is untouched",
    "crash": "non-graceful stop injected by devcluster.run_crash_schedule",
    "restart": "respawn from the same node directory after an injected"
               " crash",
    "crash_dump": "the flight ring was flushed by the unhandled-"
                  "exception supervisor (reason)",
}


class FlightRecorder:
    """One agent's flight ring: snapshots + events, HLC-stamped."""

    def __init__(self, metrics, clock, interval: float = 1.0,
                 ring_max: int = 512,
                 export_path: Optional[str] = None,
                 export_max_bytes: int = 64 * 1024 * 1024,
                 crash_path: Optional[str] = None,
                 node: Optional[str] = None,
                 timebase=None):
        from corrosion_tpu_torch.clock import SYSTEM_CLOCK

        self.metrics = metrics
        self.clock = clock
        # ``clock`` is the HLC (the merge axis); ``timebase`` is the
        # agent's injectable Clock — the wall half of every stamp and
        # the snapshot cadence, so a virtual-time campaign journals
        # deterministic timestamps
        self.timebase = timebase or SYSTEM_CLOCK
        self.interval = max(0.01, float(interval))
        self.node = node
        self._ring: deque = deque(maxlen=max(8, int(ring_max)))
        self._lock = threading.Lock()
        self._last_counters: Dict[str, float] = {}
        self.snapshots = 0
        self.events = 0
        self.crash_path = crash_path
        # jsonl export, spans-export discipline (tracing.py): bounded,
        # one rotation, then drops counted — but per-RECORDER state, not
        # process-global (each agent owns its own flight file)
        self._export_path = export_path
        self._export_max_bytes = max(0, int(export_max_bytes))
        self._export_bytes = 0
        self._export_rotated = False
        self._export_dead = False
        self.export_dropped = 0
        self._export_pending: List[str] = []
        # sink/rotation state lock, distinct from the ring lock: disk
        # writes must never block an event() on the loop (RLock: the
        # rotation paths drop-count while already holding it)
        self._io_lock = threading.RLock()
        self._sink = None
        if export_path:
            self._sink = open(export_path, "a", buffering=1)
            try:
                self._export_bytes = os.path.getsize(export_path)
            except OSError:
                self._export_bytes = 0

    # -- stamping ------------------------------------------------------

    def _stamp(self) -> tuple:
        """(hlc, wall) for one record: an HLC OBSERVATION (what
        new_timestamp would mint, without advancing the clock —
        telemetry must not mutate protocol clock state), the merge axis
        the cluster timeline sorts on."""
        return int(self.clock.observe_timestamp()), self.timebase.wall()

    # -- the event journal ---------------------------------------------

    def event(self, kind: str, /, **attrs) -> None:
        """Journal one typed event.  Thread-safe (seams fire from worker
        threads and the loop alike); unknown kinds raise — the registry
        is the schema and the doc lint depends on it being closed.
        ``kind`` is positional-only so an event may carry a ``kind``
        attribute of its own (an equivocation verdict's detection
        kind)."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unregistered flight event kind {kind!r}")
        hlc, wall = self._stamp()
        rec = {"t": "event", "kind": kind, "hlc": hlc, "wall": wall}
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            self._ring.append(rec)
            self.events += 1
        self._export(rec)

    # -- the snapshot loop (runs ON the loop, like LoopHealthProbe) ----

    async def run(self) -> None:
        import asyncio

        while True:
            await self.timebase.sleep(self.interval)
            # off-loop: the snapshot sorts every histogram window for
            # its quantiles — worker-thread work, not loop work (the
            # stall probe must never attribute a stall to its sibling)
            await asyncio.to_thread(self.snapshot_once)

    def snapshot_once(self) -> dict:
        """Capture one metric snapshot into the ring: counter deltas
        since the previous snapshot, current gauges, and windowed
        histogram p50/p99 — all from ONE registry-lock hold."""
        counters, gauges, quantiles = self.metrics.snapshot_state()
        hlc, wall = self._stamp()
        with self._lock:
            deltas = {
                k: round(v - self._last_counters.get(k, 0.0), 6)
                for k, v in counters.items()
                if v != self._last_counters.get(k, 0.0)
            }
            self._last_counters = counters
            rec = {
                "t": "snap", "hlc": hlc, "wall": wall,
                "counters_delta": deltas,
                "gauges": gauges,
                "quantiles": quantiles,
            }
            self._ring.append(rec)
            self.snapshots += 1
        self._export(rec)
        # the snapshot path runs off-loop (run()'s to_thread hop), so
        # it doubles as the export writer: events enqueued since the
        # last interval reach disk here
        self.flush_export()
        return rec

    # -- reading -------------------------------------------------------

    def entries(self, limit: int = 0, kind: Optional[str] = None
                ) -> List[dict]:
        """Ring contents oldest-first.  ``kind``: "snap"/"event" filter
        BEFORE the limit; non-positive limit = everything held."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e["t"] == kind]
        if limit > 0:
            out = out[-limit:]
        return out

    def snapshot(self) -> dict:
        """Recorder state summary (admin surface)."""
        with self._lock:
            held = len(self._ring)
        return {
            "interval_s": self.interval,
            "ring_max": self._ring.maxlen,
            "held": held,
            "snapshots": self.snapshots,
            "events": self.events,
            "export_path": self._export_path,
            "export_dropped": self.export_dropped,
        }

    # -- jsonl export (the spans-export rotation discipline) -----------
    #
    # Records ENQUEUE here and reach disk in flush_export(), which runs
    # off the event loop (the snapshot worker thread, close(), and the
    # crash dump): events are journaled inline at async protocol seams,
    # and a slow disk must stall a worker, never the loop the recorder
    # exists to observe.

    EXPORT_PENDING_MAX = 4096  # unflushed lines; beyond = counted drops

    def _export(self, rec: dict) -> None:
        if self._export_path is None:
            return
        line = json.dumps(
            rec if self.node is None else dict(rec, node=self.node)
        ) + "\n"
        with self._lock:
            if len(self._export_pending) >= self.EXPORT_PENDING_MAX:
                drop = True
            else:
                self._export_pending.append(line)
                drop = False
        if drop:
            self._drop(1)

    def flush_export(self) -> None:
        """Write pending export lines to the sink — worker-thread work
        (called from the snapshot loop's to_thread hop, close(), and
        crash_dump(); safe to call anytime).  The ring lock is held
        only to SWAP the pending list out: disk writes and rotation
        happen under the separate io lock, so an event() on the loop
        never waits behind a slow disk."""
        with self._lock:
            pending, self._export_pending = self._export_pending, []
        if not pending or self._export_path is None:
            return
        with self._io_lock:
            if self._sink is None:
                # a dead sink keeps COUNTING drops (the tracing.py
                # lesson: a frozen counter reads as a healthy export
                # while records vanish)
                if self._export_dead:
                    self._drop(len(pending))
                return
            for line in pending:
                if not self._make_room_io_locked(len(line)):
                    continue
                try:
                    self._sink.write(line)
                    self._export_bytes += len(line)
                except OSError:
                    pass

    def _drop(self, n: int) -> None:
        # RLock: callers may already hold the io lock (rotation paths)
        with self._io_lock:
            self.export_dropped += n
        self.metrics.counter("corro_flight_export_dropped_total", n)

    def _make_room_io_locked(self, line_len: int) -> bool:
        """Under ``_io_lock``: room for one more line, rotating ONCE at the
        byte cap, dropping (counted) after that — bounded exactly like
        the spans export (on-disk footprint ≤ 2 × max_bytes)."""
        if (self._export_max_bytes <= 0
                or self._export_bytes + line_len <= self._export_max_bytes):
            return True
        if self._export_rotated:
            self._drop(1)
            return False
        self._export_rotated = True
        try:
            self._sink.close()
        except OSError:
            pass
        try:
            os.replace(self._export_path, self._export_path + ".1")
        except OSError:
            pass
        try:
            self._sink = open(self._export_path, "w", buffering=1)
        except OSError:
            self._sink = None
            self._export_dead = True
            self._drop(1)
            return False
        self._export_bytes = 0
        return True

    def close(self) -> None:
        self.flush_export()
        with self._io_lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None

    # -- crash dump ----------------------------------------------------

    def crash_dump(self, reason: str) -> Optional[str]:
        """Flush the whole ring to ``crash_path`` (one json line per
        record, newest ring state, overwriting a previous dump) — called
        by the agent's task supervisor on an unhandled exception so the
        history leading up to the death survives it.  Returns the path
        written, or None when no crash path was configured."""
        try:
            self.event("crash_dump", reason=reason)
        except ValueError:  # pragma: no cover - registry is closed
            pass
        self.flush_export()
        if not self.crash_path:
            return None
        entries = self.entries()
        try:
            with open(self.crash_path, "w") as f:
                for rec in entries:
                    f.write(json.dumps(rec) + "\n")
        except OSError:
            return None
        return self.crash_path
