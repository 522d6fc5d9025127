"""Group-commit write combining for the local client write path.

The third leg of the batching trilogy (the batched apply and the batched
serve are the other two): the local write front door.  Concurrent callers of
``Agent.execute_transaction`` enqueue ``WriteRequest``s here; one of
them — the **leader** — claims the queue and drains it in groups.  Each
group takes the storage lock ONCE, runs every client batch under its
own SAVEPOINT inside one outer transaction (a failing batch rolls back
to its savepoint and fails only its caller), assigns version/db_version
spans in submission order, persists bookkeeping with one ``executemany``
pass, commits once, and triggers ONE change collection for the whole
group's db_version span (see ``Agent._execute_write_group`` /
``docs/writes.md``).

Flat-combining leadership: the leader is always a caller thread — no
dedicated drainer thread, no event-loop dependency — so the combiner
works identically for HTTP handler threads, pg-wire sessions, offline
agents, and the deterministic scheduler.  Leadership HANDS OFF rather
than monopolizing: a leader drains groups only until its own request
resolves, then releases the claim and wakes a parked waiter to take
over — under sustained open-system load no caller is stuck serving
other clients' groups forever after its own write committed.

The per-transaction path (``Agent._execute_transaction_single``) stays
as the parity oracle: converged DB state, bookkeeping, broadcast
changesets, and subscription events must be equivalent (pinned by
tests/test_write_combiner.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence

from corrosion_tpu_torch.agent.storage import unpack_stmt

# Statements that can escape a SAVEPOINT's blast radius (transaction
# control, schema/file-level commands): a "COMMIT" inside a client batch
# would commit half a group, a "ROLLBACK" would destroy the other
# callers' work.  Batches leading with any of these take the
# per-transaction oracle path instead (counted as a "stmt" fallback).
_TX_CONTROL = frozenset({
    "BEGIN", "COMMIT", "END", "ROLLBACK", "SAVEPOINT", "RELEASE",
    "ATTACH", "DETACH", "VACUUM", "PRAGMA",
})


def _leading_keyword(sql: str) -> str:
    """First keyword of ``sql``, with leading whitespace and SQL
    comments (``-- line`` and ``/* block */``) stripped — a comment
    prefix must not smuggle transaction control past the screen
    (``'/* x */ COMMIT'`` would otherwise commit half a group)."""
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
        elif sql.startswith("--", i):
            j = sql.find("\n", i)
            if j < 0:
                return ""
            i = j + 1
        elif sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                return ""
            i = j + 2
        else:
            break
    head = sql[i:].split(None, 1)
    return head[0].upper().rstrip(";") if head else ""


def has_tx_control(statements: Sequence) -> bool:
    """Does any statement open with a transaction-control / file-level
    keyword that must not run inside a shared group transaction?"""
    for stmt in statements:
        try:
            sql, _ = unpack_stmt(stmt)
        except Exception:
            return True  # malformed: let the oracle path raise its error
        if _leading_keyword(sql) in _TX_CONTROL:
            return True
    return False


class GroupAborted(Exception):
    """The group's OUTER transaction died (interrupt, disk error, a
    statement that terminated the transaction): savepoint-level
    recovery is impossible.  ``index`` is the batch whose statement
    surfaced the abort (None when the failure wasn't attributable to
    one batch); its caller gets ``error``.

    Usually the termination was a rollback — nothing committed — and
    every other batch is replayed through the per-transaction oracle
    path.  But a statement that COMMITTED the outer transaction
    mid-group (screening should prevent this; belt-and-braces) leaves
    the already-processed batches durable: those are finished in place
    (``Agent._recover_committed_group``) and listed in ``recovered`` as
    ``(version, db_version, last_seq, ts)`` entries so the abort path
    can still broadcast them — replaying them would double-apply."""

    def __init__(self, index: Optional[int], error: BaseException):
        super().__init__(f"write group aborted at batch {index}: {error!r}")
        self.index = index
        self.error = error
        self.recovered: List[tuple] = []


class WriteRequest:
    """One caller's buffered transaction: statements in, result or
    error out, ``done`` set exactly once by the group leader."""

    __slots__ = ("statements", "on_conn", "done", "result", "error",
                 "enqueued")

    def __init__(self, statements: Sequence, on_conn=None):
        self.statements = statements
        self.on_conn = on_conn
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        # combiner queueing delay (corro_write_group_wait_seconds):
        # the front-door half of a change's end-to-end provenance lag
        self.enqueued = time.perf_counter()

    def finish(self) -> dict:
        """Block until the leader resolves this request; raise its
        error or return its result (the oracle's return shape)."""
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.result


class WriteCombiner:
    """Flat-combining queue in front of ``Agent._execute_write_group``."""

    def __init__(self, agent, max_group: int = 64):
        self._agent = agent
        self._cv = threading.Condition()
        self._q: "deque[WriteRequest]" = deque()
        self._draining = False
        self.max_group = max(1, int(max_group))

    def depth(self) -> int:
        """Requests queued but not yet claimed by a leader (the
        ``corro_write_queue_depth`` gauge)."""
        with self._cv:
            return len(self._q)

    def submit(self, statements: Sequence, on_conn=None) -> dict:
        """Enqueue one client transaction and wait for its group to
        commit.  The calling thread becomes the leader when no drain is
        in flight; otherwise it parks on the combiner's condition until
        a leader resolves its request — or until leadership frees up
        with its request still queued, in which case it takes over."""
        req = WriteRequest(statements, on_conn)
        with self._cv:
            self._q.append(req)
            while True:
                if req.done.is_set():
                    return req.finish()
                if not self._draining:
                    self._draining = True
                    break  # this thread leads
                # the timeout is pure paranoia: every done-setting path
                # notifies, so this only bounds the damage of a lost
                # wakeup to 1 s of latency instead of a hang
                self._cv.wait(timeout=1.0)
        group: List[WriteRequest] = []
        try:
            while True:
                with self._cv:
                    if not self._q:
                        break
                    group = [
                        self._q.popleft()
                        for _ in range(min(len(self._q), self.max_group))
                    ]
                now = time.perf_counter()
                # time parked awaiting a leader: the local queuing half
                # of a change's end-to-end convergence lag — recorded
                # for the whole group under ONE metrics-lock hold
                self._agent.metrics.histogram_keyed_many(
                    "corro_write_group_wait_seconds",
                    [((), max(0.0, now - r.enqueued)) for r in group],
                )
                self._agent._execute_write_group(group)
                group = []
                with self._cv:
                    self._cv.notify_all()
                if req.done.is_set():
                    # leadership hand-off: own write is durable — stop
                    # serving other clients' groups; the release below
                    # wakes a parked waiter to take over the remainder
                    break
        except BaseException:
            # _execute_write_group routes every failure into its
            # requests and never raises; this is the belt-and-braces
            # path for a truly unexpected error (e.g. interpreter
            # shutdown).  The in-flight group was already popped — no
            # future leader can reach it — so fail its unresolved
            # members (and our own request) before re-raising; requests
            # still queued are left for the next leader the release
            # below elects.
            for r in [*group, req]:
                if not r.done.is_set():
                    r.error = RuntimeError("write combiner leader died")
                    r.done.set()
            raise
        finally:
            with self._cv:
                self._draining = False
                self._cv.notify_all()
        return req.finish()
