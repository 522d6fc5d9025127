"""Lock observability.

Parity: the reference has no TSan — instead a bespoke ``LockRegistry``:
every counted-lock acquisition is registered with a label/state/started_at
(``corro-types/src/agent.rs:958-1181``), a watchdog logs locks held >10 s
(``setup.rs:186-230``), and ``corrosion locks`` surfaces it via admin.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class LockEntry:
    id: int
    label: str
    kind: str  # "write" | "apply" | "read"
    state: str  # "acquiring" | "locked"
    started_at: float


class LockRegistry:
    """Tracks in-flight lock acquisitions for the admin `locks` command."""

    def __init__(self):
        self._entries: Dict[int, LockEntry] = {}
        self._guard = threading.Lock()
        self._ids = itertools.count(1)
        self.slow_threshold_s = 10.0

    def begin(self, label: str, kind: str) -> int:
        lid = next(self._ids)
        with self._guard:
            self._entries[lid] = LockEntry(
                lid, label, kind, "acquiring", time.monotonic()
            )
        return lid

    def acquired(self, lid: int) -> None:
        with self._guard:
            e = self._entries.get(lid)
            if e:
                e.state = "locked"
                e.started_at = time.monotonic()

    def released(self, lid: int) -> None:
        with self._guard:
            self._entries.pop(lid, None)

    def snapshot(self) -> List[dict]:
        now = time.monotonic()
        with self._guard:
            return [
                {
                    "id": e.id,
                    "label": e.label,
                    "kind": e.kind,
                    "state": e.state,
                    "held_s": round(now - e.started_at, 3),
                }
                for e in self._entries.values()
            ]

    def slow(self) -> List[dict]:
        return [
            e for e in self.snapshot() if e["held_s"] > self.slow_threshold_s
        ]


PRIO_HIGH, PRIO_NORMAL, PRIO_LOW = 0, 1, 2


class PriorityLock:
    """Reentrant mutex with 3 acquisition tiers (write-pool parity).

    The reference splits writes across three priority pools — high for
    applying replicated changes, normal for API writes, low for
    background maintenance (``agent.rs:614-765``,
    ``sqlite-pool/src/lib.rs``).  One sqlite RW connection can't run
    concurrent transactions, so the pools collapse to a SCHEDULING
    question: when the writer frees, the highest-priority waiter goes
    next (FIFO-fair within a tier via Condition wakeup order being
    irrelevant — every waiter re-checks).  Plain ``with lock:`` takes
    NORMAL; hot paths say ``with lock.prio(PRIO_HIGH, "apply"):``.

    Optionally registers acquisitions in a LockRegistry so the admin
    ``locks`` surface sees priority waits like any other.
    """

    def __init__(self, registry: Optional[LockRegistry] = None,
                 default_label: str = "storage"):
        self._cv = threading.Condition()
        self._owner: Optional[int] = None
        self._count = 0
        self._waiting = [0, 0, 0]
        self.registry = registry
        self.default_label = default_label
        self._local = threading.local()  # per-thread entry-id stack

    def acquire(self, priority: int = PRIO_NORMAL,
                timeout: Optional[float] = None) -> bool:
        """Acquire at ``priority``; with ``timeout`` give up after that
        many seconds and return False (best-effort readers — e.g. the
        metrics scrape — must degrade to stale data, not block behind
        a long writer)."""
        me = threading.get_ident()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._owner == me:
                self._count += 1
                return True
            self._waiting[priority] += 1
            timed_out = False
            try:
                while self._owner is not None or any(
                    self._waiting[p] for p in range(priority)
                ):
                    remaining = (
                        None if deadline is None
                        else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        timed_out = True
                        return False
                    self._cv.wait(remaining)
                self._owner = me
                self._count = 1
                return True
            finally:
                self._waiting[priority] -= 1
                if timed_out:
                    # our _waiting slot may have gated lower tiers past
                    # a notify_all they consumed by re-waiting; now that
                    # the slot is gone, wake them so nobody sleeps on a
                    # free lock
                    self._cv.notify_all()

    def release(self) -> None:
        with self._cv:
            if self._owner != threading.get_ident():
                raise RuntimeError("release of un-owned PriorityLock")
            self._count -= 1
            if self._count == 0:
                self._owner = None
                self._cv.notify_all()

    def prio(self, priority: int, label: Optional[str] = None,
             kind: str = "write"):
        return _PrioHold(self, priority, label or self.default_label, kind)

    # plain `with lock:` == normal priority
    def __enter__(self):
        self._track_begin(self.default_label, "write")
        self.acquire(PRIO_NORMAL)
        self._track_acquired()
        return self

    def __exit__(self, *exc):
        self._track_released()
        self.release()
        return False

    # registry plumbing (no-ops when untracked)
    def _track_begin(self, label: str, kind: str) -> None:
        if self.registry is None:
            return
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(self.registry.begin(label, kind))

    def _track_acquired(self) -> None:
        if self.registry is None:
            return
        stack = getattr(self._local, "stack", [])
        if stack:
            self.registry.acquired(stack[-1])

    def _track_released(self) -> None:
        if self.registry is None:
            return
        stack = getattr(self._local, "stack", [])
        if stack:
            self.registry.released(stack.pop())


class _PrioHold:
    def __init__(self, lock: PriorityLock, priority: int, label: str,
                 kind: str):
        self.lock = lock
        self.priority = priority
        self.label = label
        self.kind = kind

    def __enter__(self):
        self.lock._track_begin(self.label, self.kind)
        self.lock.acquire(self.priority)
        self.lock._track_acquired()
        return self

    def __exit__(self, *exc):
        self.lock._track_released()
        self.lock.release()
        return False

