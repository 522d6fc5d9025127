"""Hybrid logical clock.

Parity: the reference uses the ``uhlc`` crate (NTP64 timestamps; see
``crates/corro-types/src/broadcast.rs:283`` and the 300 ms max clock delta at
``crates/corro-agent/src/agent/setup.rs``).  A ``Timestamp`` is a single u64:
the upper 48 bits are physical time (NTP64 truncated) and the low 16 bits a
logical counter, which preserves total ordering and survives wire round-trips
as one integer — the same packing the simulator uses on-device.
"""

from __future__ import annotations

import time
import threading

# Reject remote timestamps more than this far ahead of local physical time
# (reference: 300 ms max HLC delta, setup.rs).
MAX_CLOCK_DELTA_NS = 300_000_000

_LOGICAL_BITS = 16
_LOGICAL_MASK = (1 << _LOGICAL_BITS) - 1


class Timestamp(int):
    """u64 HLC timestamp: (physical_48 << 16) | logical_16."""

    __slots__ = ()
    MAX = (1 << 64) - 1

    def __new__(cls, value: int = 0):
        if not 0 <= int(value) <= cls.MAX:
            raise ValueError(f"Timestamp out of u64 range: {value!r}")
        return super().__new__(cls, value)

    @classmethod
    def pack(cls, physical_ns: int, logical: int) -> "Timestamp":
        # NTP64-style: seconds in the high 32 of the physical field would lose
        # resolution at 48 bits, so we store physical time as ns >> 16 (≈65 µs
        # granularity) — the logical counter disambiguates within a grain.
        return cls(((physical_ns >> _LOGICAL_BITS) << _LOGICAL_BITS) | (logical & _LOGICAL_MASK))

    @property
    def physical_ns(self) -> int:
        return int(self) & ~_LOGICAL_MASK

    @property
    def logical(self) -> int:
        return int(self) & _LOGICAL_MASK

    def wall_seconds(self) -> float:
        """Physical half as Unix seconds (≈65 µs granularity) — the
        provenance time base: origin-commit→apply lag is wall-now minus
        the changeset timestamp's wall seconds."""
        return self.physical_ns / 1e9

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Timestamp(phys_ns={self.physical_ns}, logical={self.logical})"


def skewed_now_ns(offset_ns: int = 0, drift: float = 0.0,
                  base=time.time_ns):
    """A ``now_ns`` source with a constant offset plus linear drift —
    the clock-skew fault seam (``faults.FaultPlan.node_clock``).

    ``drift`` is a ratio (e.g. ``50e-6`` = +50 ppm) applied to time
    elapsed since this factory was called, so a long-running node's
    clock error grows the way a real bad oscillator's does.  With both
    parameters zero the base source is returned untouched (the
    production path pays nothing)."""
    if not offset_ns and not drift:
        return base
    t0 = base()

    def now_ns() -> int:
        t = base()
        return int(t + offset_ns + (t - t0) * drift)

    return now_ns


class ClockDriftError(Exception):
    """Remote timestamp too far ahead of local physical time."""


class HLClock:
    """Thread-safe hybrid logical clock.

    ``new_timestamp`` stamps local events; ``update_with_timestamp`` merges a
    remote timestamp on message receipt (rejecting drift beyond
    ``max_delta_ns``, like the agent does for gossip clock updates).
    """

    def __init__(self, max_delta_ns: int = MAX_CLOCK_DELTA_NS, now_ns=time.time_ns):
        self._last = Timestamp(0)
        self._lock = threading.Lock()
        self._now_ns = now_ns
        self.max_delta_ns = max_delta_ns

    @property
    def last(self) -> Timestamp:
        return self._last

    def new_timestamp(self) -> Timestamp:
        with self._lock:
            phys = self._now_ns() & ~_LOGICAL_MASK
            if phys > self._last.physical_ns:
                ts = Timestamp.pack(phys, 0)
            else:
                ts = Timestamp(int(self._last) + 1)
            self._last = ts
            return ts

    def observe_timestamp(self) -> Timestamp:
        """The stamp :meth:`new_timestamp` WOULD mint, without advancing
        the clock — for observations (flight-recorder records,
        provenance first-seen stamps): telemetry must never mutate
        protocol clock state, so e.g. the 'merge rejected, local clock
        unpolluted' invariant of the 300 ms delta rule stays assertable
        to the exact tick.  Two observations inside one ~65 µs grain may
        stamp equal; observation streams are sorted, not deduped."""
        with self._lock:
            phys = self._now_ns() & ~_LOGICAL_MASK
            if phys > self._last.physical_ns:
                return Timestamp.pack(phys, 0)
            return Timestamp(int(self._last) + 1)

    def update_with_timestamp(self, remote: Timestamp) -> None:
        with self._lock:
            now = self._now_ns()
            if remote.physical_ns > now + self.max_delta_ns:
                raise ClockDriftError(
                    f"remote timestamp {remote!r} exceeds local time by more "
                    f"than {self.max_delta_ns} ns"
                )
            if int(remote) > int(self._last):
                self._last = Timestamp(int(remote))
