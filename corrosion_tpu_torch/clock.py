"""The agent's one injectable time source.

Every agent timer — ``asyncio.sleep`` loops (probe / gossip / sync /
broadcast-flush / maintenance / recorder cadence), ``time.monotonic``
state stamps (member ``last_seen``, suspicion deadlines, breaker
cooldowns, equivocation-quarantine windows, sync-session ages), wall
clocks (provenance lag, staleness, flight-record stamps) and the HLC
physical source — reads time through a single :class:`Clock` object
owned by the agent (``AgentConfig.clock``).  Two implementations:

* :class:`SystemClock` (the default, ``SYSTEM_CLOCK``): every method is
  a direct alias of the stdlib callable the code used before the
  refactor — ``time.monotonic`` / ``time.time`` / ``time.time_ns`` /
  ``asyncio.sleep`` / ``asyncio.wait_for`` — so the uninjected path is
  behavior- and wire-byte-identical to the pre-refactor agent;

* :class:`VirtualClock`: a discrete-event scheduler clock.  Time is a
  number that only moves when the owner pops the event heap
  (``advance``), so a cluster of hundreds of in-process agents runs a
  multi-minute fault campaign in however long the *events* take to
  execute — seconds — instead of waiting out timers (LiveStack,
  PAPERS.md: full-stack simulation by putting unmodified node software
  on virtual time).  The wall epoch is a fixed constant by default, so
  two runs with the same seed produce byte-identical timestamps —
  the determinism contract the virtual campaign tests assert
  (``tests/test_vtime.py``).

What is deliberately NOT virtualized (real time even under a
VirtualClock): worker-thread internals that never gate protocol
progress — the storage busy-retry sleep, lock-diagnostic stamps
(``agent/locks.py``), the DNS resolve TTL cache (``swim_foca.py``),
and trace span durations (``agent/tracing.py``).  See
``docs/sim.md`` (virtual time) for the full table.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import Any, Callable, List, Optional


class Clock:
    """The protocol.  ``SystemClock`` and ``VirtualClock`` implement it;
    type annotations reference this base."""

    def monotonic(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def wall(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def wall_ns(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    async def sleep(self, delay: float, result: Any = None):
        raise NotImplementedError  # pragma: no cover - interface

    async def wait_for(self, aw, timeout: Optional[float]):
        raise NotImplementedError  # pragma: no cover - interface


class SystemClock(Clock):
    """Real time.  Every method IS the stdlib callable (class-level
    aliases, zero indirection beyond one attribute hop), so the default
    path cannot drift from the pre-refactor behavior."""

    monotonic = staticmethod(time.monotonic)
    wall = staticmethod(time.time)
    wall_ns = staticmethod(time.time_ns)
    sleep = staticmethod(asyncio.sleep)
    wait_for = staticmethod(asyncio.wait_for)


#: the process default — what an Agent uses when no clock is injected
SYSTEM_CLOCK = SystemClock()


#: fixed virtual wall epoch (2020-09-13T12:26:40Z): a CONSTANT, not
#: ``time.time()`` at construction, so two virtual runs with the same
#: seed stamp byte-identical HLC timestamps and journal wall times
VIRTUAL_EPOCH_NS = 1_600_000_000 * 1_000_000_000


class _Event:
    """One heap entry.  ``cancelled`` keeps cancellation O(1) — the pop
    loop skips dead entries."""

    __slots__ = ("due", "seq", "fn", "cancelled")

    def __init__(self, due: float, seq: int, fn: Callable[[float], None]):
        self.due = due
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def __lt__(self, other: "_Event") -> bool:
        return (self.due, self.seq) < (other.due, other.seq)


class VirtualClock(Clock):
    """Discrete-event virtual time.

    ``monotonic()`` returns the current virtual instant; ``schedule``
    pushes a callback onto the heap; ``advance()`` pops the earliest
    event, moves time to its deadline and runs it.  Callbacks receive
    their *scheduled* due time, so a callback that fired late (because
    a :meth:`jump` — the loop-stall model — moved time past it) can
    measure its own lateness exactly the way the live
    ``LoopHealthProbe`` measures a late wakeup.

    Event order is a pure function of (deadlines, insertion order):
    ties break on a monotone sequence number, never on object identity
    or hash order — the byte-determinism contract of the virtual
    campaigns.

    Single-threaded by design: the scheduler that owns the clock is
    the only driver.  ``sleep``/``wait_for`` integrate with a running
    asyncio loop by resolving futures from heap pops, so real agent
    coroutines *can* be suspended on virtual time when a driver pumps
    ``advance()`` from within the loop.
    """

    def __init__(self, start: float = 0.0,
                 wall0_ns: int = VIRTUAL_EPOCH_NS):
        self._now = float(start)
        self._wall0_ns = int(wall0_ns)
        self._heap: List[_Event] = []
        self._seq = 0

    # -- reading -------------------------------------------------------

    def monotonic(self) -> float:
        return self._now

    def wall(self) -> float:
        return self._wall0_ns / 1e9 + self._now

    def wall_ns(self) -> int:
        return self._wall0_ns + int(round(self._now * 1e9))

    # -- scheduling ----------------------------------------------------

    def schedule(self, delay: float, fn: Callable[[float], None]) -> _Event:
        """Run ``fn(due)`` once virtual time reaches ``now + delay``."""
        return self.schedule_at(self._now + max(0.0, float(delay)), fn)

    def schedule_at(self, at: float, fn: Callable[[float], None]) -> _Event:
        ev = _Event(float(at), self._seq, fn)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    @staticmethod
    def cancel(ev: _Event) -> None:
        ev.cancelled = True

    def pending(self) -> int:
        """Live (uncancelled) events still queued."""
        return sum(1 for e in self._heap if not e.cancelled)

    def next_due(self) -> Optional[float]:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0].due if self._heap else None

    # -- driving -------------------------------------------------------

    def jump(self, dt: float) -> None:
        """Move time forward WITHOUT running the events in between —
        the virtual form of a blocked event loop (the stalled-loop
        fault family): everything due inside the jump fires late, and
        a lateness-measuring beat observes exactly ``dt``."""
        self._now += max(0.0, float(dt))

    def advance(self) -> bool:
        """Pop and run the earliest event; False when the heap is
        empty.  Time never moves backwards: an event already overdue
        (scheduled before a :meth:`jump`) runs at the current instant."""
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self._now = max(self._now, ev.due)
            ev.fn(ev.due)
            return True
        return False

    def run_until(self, t_stop: float) -> int:
        """Run every event due at or before ``t_stop``; returns how
        many ran.  Ends with ``monotonic() == t_stop`` (idle virtual
        time elapses for free — that is the whole point)."""
        ran = 0
        while True:
            nxt = self.next_due()
            if nxt is None or nxt > t_stop:
                break
            self.advance()
            ran += 1
        self._now = max(self._now, float(t_stop))
        return ran

    # -- asyncio integration ------------------------------------------

    async def sleep(self, delay: float, result: Any = None):
        """Suspend the calling coroutine until virtual time reaches
        ``now + delay``.  Requires a driver pumping :meth:`advance`
        (e.g. the virtual cluster's scheduler) — nothing resolves the
        future otherwise."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def _fire(_due: float) -> None:
            if fut.done():
                return
            try:
                fut.set_result(result)
            except RuntimeError:
                # the awaiting loop already closed (e.g. a private
                # serve loop torn down with the timer still queued) —
                # nothing is waiting, nothing to wake
                pass

        self.schedule(delay, _fire)
        return await fut

    async def wait_for(self, aw, timeout: Optional[float]):
        """Virtual-deadline ``wait_for``: the timeout elapses on THIS
        clock, not the loop's."""
        if timeout is None:
            return await aw
        task = asyncio.ensure_future(aw)
        sentinel = object()
        timer = asyncio.ensure_future(self.sleep(timeout, result=sentinel))
        try:
            done, _pending = await asyncio.wait(
                {task, timer}, return_when=asyncio.FIRST_COMPLETED
            )
            if task in done:
                return task.result()
            # stdlib-faithful timeout: cancel the awaitable and WAIT
            # for its cancellation to complete — and if it finished
            # anyway (e.g. a queue.get whose item landed in the same
            # cycle), hand the result back instead of dropping it
            task.cancel()
            try:
                return await task
            except asyncio.CancelledError:
                raise asyncio.TimeoutError() from None
        finally:
            if not timer.done():
                timer.cancel()
