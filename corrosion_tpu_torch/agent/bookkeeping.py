"""Per-actor version bookkeeping: what we have, what's missing, what's
partially buffered, what's been cleared.

Parity: ``crates/corro-types/src/agent.rs`` — ``BookedVersions`` (needed
gaps as a range set, ``partials`` map, ``max``, ``last_cleared_ts``;
``agent.rs:1393-1578``), the ``VersionsSnapshot::insert_db`` gap-collapse
algorithm (``agent.rs:1231-1367``), ``store_empty_changeset`` cleared-range
merging (``corro-types/src/change.rs:314-436``), and the
``__corro_bookkeeping`` / ``__corro_seq_bookkeeping`` /
``__corro_buffered_changes`` / ``__corro_bookkeeping_gaps`` tables
(``agent.rs:430-512``).

Design: one ``Bookie`` owns a map actor → ``BookedVersions``; each
``BookedVersions`` keeps exact in-memory range sets (our
:class:`corrosion_tpu_torch.utils.ranges.RangeSet`) and persists through the
same sqlite connection as the storage engine, so a bookkeeping update
commits atomically with the change application that caused it.  Restart =
resume: everything rebuilds from the tables.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.types.hlc import Timestamp
from corrosion_tpu_torch.utils.ranges import RangeSet


@dataclass
class PartialVersion:
    """A version whose seq-chunks are still being assembled."""

    seqs: RangeSet = field(default_factory=RangeSet)
    last_seq: int = 0
    ts: Optional[Timestamp] = None

    def is_complete(self) -> bool:
        return self.seqs.contains_span(0, self.last_seq)

    def gaps(self) -> List[Tuple[int, int]]:
        return self.seqs.gaps(0, self.last_seq)


class BookedVersions:
    """One remote (or local) actor's version ledger."""

    def __init__(self, actor_id: bytes, on_mutate=None):
        self.actor_id = actor_id
        self.needed = RangeSet()  # versions we know exist but don't have
        self.partials: Dict[int, PartialVersion] = {}
        self.cleared = RangeSet()  # versions cleared/overwritten (empty)
        # version -> (db_version, last_seq) for locally-applied versions
        self.versions: Dict[int, Tuple[int, int]] = {}
        self.max_version: int = 0
        self.last_cleared_ts: Optional[Timestamp] = None
        # snapshot floor (docs/sync.md): versions 1..=snap_floor are
        # fully reflected in current table state, and their per-version
        # bookkeeping has been COMPACTED away — they can only be
        # obtained from this node via snapshot install, never
        # change-by-change.  Advanced by maintenance-driven history
        # compaction (runtime._advance_snapshot_floors)
        self.snap_floor: int = 0
        # dirty-flag hook (Bookie.gen): every mutation that can change a
        # generate_sync snapshot reports upward so the runtime can cache
        # the snapshot between bookkeeping changes
        self._on_mutate = on_mutate

    def _touch(self) -> None:
        if self._on_mutate is not None:
            self._on_mutate()

    # -- queries ---------------------------------------------------------

    def last(self) -> int:
        return self.max_version

    def contains_version(self, v: int) -> bool:
        """Do we fully have v (applied, known-cleared, or below the
        compacted snapshot floor)?"""
        if v > self.max_version:
            return False
        if v <= self.snap_floor:
            # the floor only ever advances over a fully-contained
            # prefix, so everything at or below it is held by contract
            return True
        if self.needed.contains(v):
            return False
        if v in self.partials:
            return False
        return True

    def contains_range(self, start: int, end: int) -> bool:
        return all(self.contains_version(v) for v in range(start, end + 1))

    def db_version_for(self, v: int) -> Optional[int]:
        entry = self.versions.get(v)
        return entry[0] if entry else None

    # -- mutation --------------------------------------------------------

    def _extend_max(self, version: int) -> None:
        """Seeing version v implies 1..v exist; anything between our old
        max and v that we didn't just get becomes a gap (insert_db
        semantics)."""
        if version > self.max_version:
            if version > self.max_version + 1:
                self.needed.insert(self.max_version + 1, version - 1)
            self.max_version = version

    def apply_version(
        self,
        version: int,
        db_version: int,
        last_seq: int,
        ts: Optional[Timestamp] = None,
    ) -> None:
        """A complete version has been applied to storage."""
        self._extend_max(version)
        self.needed.remove(version, version)
        self.partials.pop(version, None)
        self.versions[version] = (db_version, last_seq)
        self._touch()

    def mark_cleared(self, start: int, end: int) -> None:
        """Versions [start, end] are empty (overwritten or compacted).

        Does NOT advance ``last_cleared_ts``: the watermark moves only on
        *complete* information — our own compaction, or a whole sync
        EmptySet group — via :meth:`update_cleared_ts`.  A single
        broadcast empty changeset may be one of several ranges stamped
        with the same ts, so advancing here would make the sync
        Empty-need gate skip the rest forever (ref ``agent.rs:1541-1545``
        — the reference's watermark is likewise separate from clearing)."""
        self._extend_max(end)
        self.needed.remove(start, end)
        # iterate entries present, never the (remote-supplied) span width
        for v in [v for v in self.partials if start <= v <= end]:
            del self.partials[v]
        for v in [v for v in self.versions if start <= v <= end]:
            del self.versions[v]
        self.cleared.insert(start, end)
        self._touch()

    def update_cleared_ts(self, ts: Timestamp) -> None:
        """Advance the cleared watermark (``agent.rs:1541-1545``)."""
        if self.last_cleared_ts is None or int(ts) > int(self.last_cleared_ts):
            self.last_cleared_ts = ts
            self._touch()

    def insert_partial(
        self,
        version: int,
        seqs: Tuple[int, int],
        last_seq: int,
        ts: Optional[Timestamp] = None,
    ) -> PartialVersion:
        """Buffer a seq-range chunk of a large version; returns the
        partial (check ``is_complete`` to promote)."""
        self._extend_max(version)
        self.needed.remove(version, version)
        partial = self.partials.get(version)
        if partial is None:
            partial = self.partials[version] = PartialVersion(
                last_seq=last_seq, ts=ts
            )
        partial.last_seq = max(partial.last_seq, last_seq)
        if ts is not None:
            partial.ts = ts
        partial.seqs.insert(seqs[0], seqs[1])
        self._touch()
        return partial

    def contained_prefix(self) -> int:
        """The largest F with versions 1..=F all fully held (applied or
        cleared; no gaps, no partials) — the ceiling a snapshot floor
        may advance to."""
        hi = self.max_version
        spans = self.needed.spans()
        if spans:
            hi = min(hi, spans[0][0] - 1)
        for v in self.partials:
            if v <= hi:
                hi = v - 1
        return max(hi, 0)

    def set_snap_floor(self, floor: int) -> None:
        """Advance the snapshot floor, dropping the per-version
        in-memory ledger it compacts (the persisted rows go in the
        same transaction via ``Bookie.compact_below_floor``)."""
        if floor <= self.snap_floor:
            return
        self.snap_floor = floor
        if floor > self.max_version:
            self.max_version = floor
        for v in [v for v in self.versions if v <= floor]:
            del self.versions[v]
        for v in [v for v in self.partials if v <= floor]:
            del self.partials[v]
        # the floor only advances over a contained prefix, so this is
        # belt-and-braces against a reloaded inconsistent ledger
        self.needed.remove(1, floor)
        self._touch()

    # -- sync handshake feed ---------------------------------------------

    def needed_spans(self) -> List[Tuple[int, int]]:
        return self.needed.spans()

    def partial_needs(self) -> Dict[int, List[Tuple[int, int]]]:
        return {
            v: p.gaps() for v, p in self.partials.items() if not p.is_complete()
        }


class Bookie:
    """actor → BookedVersions, with sqlite persistence."""

    TABLES = """
CREATE TABLE IF NOT EXISTS __corro_bookkeeping (
  actor_id BLOB NOT NULL,
  start_version INTEGER NOT NULL,
  end_version INTEGER,          -- set => cleared range [start, end]
  db_version INTEGER,           -- set => concrete applied version
  last_seq INTEGER,
  ts INTEGER,
  PRIMARY KEY (actor_id, start_version)
);
CREATE TABLE IF NOT EXISTS __corro_seq_bookkeeping (
  actor_id BLOB NOT NULL,
  version INTEGER NOT NULL,
  start_seq INTEGER NOT NULL,
  end_seq INTEGER NOT NULL,
  last_seq INTEGER NOT NULL,
  ts INTEGER,
  PRIMARY KEY (actor_id, version, start_seq)
);
CREATE TABLE IF NOT EXISTS __corro_buffered_changes (
  actor_id BLOB NOT NULL,
  version INTEGER NOT NULL,
  seq INTEGER NOT NULL,
  change BLOB NOT NULL,
  PRIMARY KEY (actor_id, version, seq)
);
CREATE TABLE IF NOT EXISTS __corro_bookkeeping_gaps (
  actor_id BLOB NOT NULL,
  start INTEGER NOT NULL,
  end INTEGER NOT NULL,
  PRIMARY KEY (actor_id, start)
);
CREATE TABLE IF NOT EXISTS __corro_sync_state (
  actor_id BLOB PRIMARY KEY NOT NULL,
  last_cleared_ts INTEGER
);
CREATE TABLE IF NOT EXISTS __corro_snap_floors (
  actor_id BLOB PRIMARY KEY NOT NULL,
  floor INTEGER NOT NULL,
  ts INTEGER
);
"""

    def __init__(self, conn, lock: Optional[threading.RLock] = None):
        """conn: a sqlite3 connection (shared with the storage engine so
        commits are atomic with change application)."""
        self.conn = conn
        self._lock = lock or threading.RLock()
        with self._lock:
            conn.executescript(self.TABLES)
        self._actors: Dict[bytes, BookedVersions] = {}
        self._persisted_gaps: Dict[bytes, set] = {}
        # bookkeeping generation: bumped by every in-memory mutation
        # (any BookedVersions change, new actors, restores).  The
        # runtime caches its generate_sync snapshot against this, so
        # inbound sync handshakes stop re-walking every actor's
        # RangeSets when nothing changed.  Mutations happen under the
        # storage lock; readers compare under the same lock.
        self.gen = 0
        self._load()

    def _bump_gen(self) -> None:
        self.gen += 1

    # -- persistence -----------------------------------------------------

    def _load(self) -> None:
        with self._lock:
            for actor, start, end, dbv, last_seq, ts in self.conn.execute(
                "SELECT actor_id, start_version, end_version, db_version,"
                " last_seq, ts FROM __corro_bookkeeping"
            ):
                bv = self.for_actor(bytes(actor))
                if end is not None:
                    bv.mark_cleared(start, end)
                else:
                    bv.apply_version(
                        start, dbv or 0, last_seq or 0,
                        Timestamp(ts) if ts else None,
                    )
            for actor, version, s, e, last_seq, ts in self.conn.execute(
                "SELECT actor_id, version, start_seq, end_seq, last_seq, ts"
                " FROM __corro_seq_bookkeeping"
            ):
                bv = self.for_actor(bytes(actor))
                bv.insert_partial(
                    version, (s, e), last_seq, Timestamp(ts) if ts else None
                )
            for actor, start, end in self.conn.execute(
                "SELECT actor_id, start, end FROM __corro_bookkeeping_gaps"
            ):
                bv = self.for_actor(bytes(actor))
                bv.needed.insert(start, end)
                bv.max_version = max(bv.max_version, end)
            for actor, ts in self.conn.execute(
                "SELECT actor_id, last_cleared_ts FROM __corro_sync_state"
            ):
                if ts is not None:
                    self.for_actor(bytes(actor)).update_cleared_ts(
                        Timestamp(ts)
                    )
            for actor, floor in self.conn.execute(
                "SELECT actor_id, floor FROM __corro_snap_floors"
            ):
                # the floor record re-extends max_version: the concrete
                # rows below it were compacted away, so without it a
                # reloaded ledger would under-report the actor's head
                self.for_actor(bytes(actor)).set_snap_floor(int(floor))

    def backfill_own_sync_state(self, actor_id: bytes) -> None:
        """Restore OUR OWN cleared watermark from cleared-row timestamps
        when ``__corro_sync_state`` has no row (a DB written before the
        table existed).  Sound only for our own actor: our persisted
        cleared set is always complete information, while a remote
        actor's rows may be a subset of a ts group."""
        bv = self.for_actor(actor_id)
        if bv.last_cleared_ts is not None:
            return
        with self._lock:
            row = self.conn.execute(
                "SELECT MAX(ts) FROM __corro_bookkeeping "
                "WHERE actor_id=? AND end_version IS NOT NULL",
                (actor_id,),
            ).fetchone()
            if row and row[0] is not None:
                bv.update_cleared_ts(Timestamp(row[0]))
                self.persist_sync_state(actor_id, int(row[0]))

    def persist_version(
        self, actor_id: bytes, version: int, db_version: int, last_seq: int,
        ts: Optional[int] = None,
    ) -> None:
        """Write-through for apply_version (call inside the storage tx)."""
        self.conn.execute(
            "INSERT OR REPLACE INTO __corro_bookkeeping "
            "(actor_id, start_version, end_version, db_version, last_seq, ts)"
            " VALUES (?, ?, NULL, ?, ?, ?)",
            (actor_id, version, db_version, last_seq, ts),
        )
        self._persist_gaps(actor_id)

    def persist_versions(
        self, actor_id: bytes,
        rows: List[Tuple[int, int, int, Optional[int]]],
    ) -> None:
        """Batch write-through for several applied versions of one actor
        (the merged apply-transaction AND group-commit write paths): one
        executemany + ONE gap diff instead of a per-version
        write-through.  ``rows`` is ``(version, db_version, last_seq,
        ts)`` tuples; call inside the storage tx.  The gap diff reads
        the current in-memory needed set — for the LOCAL actor's
        group-commit writes that set is untouched by sequential version
        assignment, so calling before the in-memory ``apply_version``
        (which a commit-after-persist ordering requires) is sound; for
        merged remote applies call after them, as before."""
        if not rows:
            return
        self.conn.executemany(
            "INSERT OR REPLACE INTO __corro_bookkeeping "
            "(actor_id, start_version, end_version, db_version, last_seq, ts)"
            " VALUES (?, ?, NULL, ?, ?, ?)",
            [(actor_id, v, dbv, last_seq, ts)
             for v, dbv, last_seq, ts in rows],
        )
        self._persist_gaps(actor_id)

    def persist_cleared(self, actor_id: bytes, start: int, end: int,
                        ts: Optional[int] = None) -> None:
        """store_empty_changeset: merge with overlapping/adjacent cleared
        ranges instead of stacking rows."""
        rows = self.conn.execute(
            "SELECT start_version, end_version, ts FROM __corro_bookkeeping "
            "WHERE actor_id=? AND end_version IS NOT NULL "
            "AND start_version <= ? AND end_version >= ?",
            (actor_id, end + 1, start - 1),
        ).fetchall()
        lo, hi = start, end
        keep_ts = ts
        for s, e, row_ts in rows:
            lo, hi = min(lo, s), max(hi, e)
            if row_ts is not None and (keep_ts is None or row_ts > keep_ts):
                keep_ts = row_ts
            self.conn.execute(
                "DELETE FROM __corro_bookkeeping WHERE actor_id=? "
                "AND start_version=?",
                (actor_id, s),
            )
        # concrete rows swallowed by the cleared range go away too
        self.conn.execute(
            "DELETE FROM __corro_bookkeeping WHERE actor_id=? "
            "AND end_version IS NULL AND start_version BETWEEN ? AND ?",
            (actor_id, lo, hi),
        )
        self.conn.execute(
            "INSERT OR REPLACE INTO __corro_bookkeeping "
            "(actor_id, start_version, end_version, db_version, last_seq, ts)"
            " VALUES (?, ?, ?, NULL, NULL, ?)",
            (actor_id, lo, hi, keep_ts),
        )
        self._persist_gaps(actor_id)

    def persist_partial(
        self, actor_id: bytes, version: int, seqs: Tuple[int, int],
        last_seq: int, ts: Optional[int] = None,
    ) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO __corro_seq_bookkeeping "
            "(actor_id, version, start_seq, end_seq, last_seq, ts) "
            "VALUES (?, ?, ?, ?, ?, ?)",
            (actor_id, version, seqs[0], seqs[1], last_seq, ts),
        )
        self._persist_gaps(actor_id)

    def clear_partial(self, actor_id: bytes, version: int) -> None:
        self.clear_partials(actor_id, [version])

    def clear_partials(self, actor_id: bytes, versions: List[int]) -> None:
        """Batch variant of :meth:`clear_partial` (merged apply path)."""
        rows = [(actor_id, v) for v in versions]
        self.conn.executemany(
            "DELETE FROM __corro_seq_bookkeeping WHERE actor_id=? AND version=?",
            rows,
        )
        self.conn.executemany(
            "DELETE FROM __corro_buffered_changes WHERE actor_id=? AND version=?",
            rows,
        )

    def _persist_gaps(self, actor_id: bytes) -> None:
        """Differential write-through: only spans that changed are touched
        (a naive delete-all/rewrite amplifies every sync catch-up step)."""
        bv = self.for_actor(actor_id)
        new = set(bv.needed.spans())
        old = self._persisted_gaps.get(actor_id)
        if old is None:
            old = {
                (s, e)
                for s, e in self.conn.execute(
                    "SELECT start, end FROM __corro_bookkeeping_gaps "
                    "WHERE actor_id=?",
                    (actor_id,),
                )
            }
        if new == old:
            self._persisted_gaps[actor_id] = new
            return
        self.conn.executemany(
            "DELETE FROM __corro_bookkeeping_gaps WHERE actor_id=? AND start=?",
            [(actor_id, s) for s, e in old - new],
        )
        self.conn.executemany(
            "INSERT OR REPLACE INTO __corro_bookkeeping_gaps "
            "(actor_id, start, end) VALUES (?, ?, ?)",
            [(actor_id, s, e) for s, e in new - old],
        )
        self._persisted_gaps[actor_id] = new

    def persist_sync_state(self, actor_id: bytes, ts: int) -> None:
        """Write-through for ``update_cleared_ts`` (``agent.rs:1292-1300``
        — the watermark lives in its own ``__corro_sync_state`` table, it
        is never inferred from cleared-range row timestamps)."""
        self.conn.execute(
            "INSERT INTO __corro_sync_state (actor_id, last_cleared_ts) "
            "VALUES (?, ?) ON CONFLICT (actor_id) DO UPDATE SET "
            "last_cleared_ts = MAX(COALESCE(last_cleared_ts, 0),"
            " excluded.last_cleared_ts)",
            (actor_id, int(ts)),
        )

    def persist_floor(self, actor_id: bytes, floor: int,
                      ts: Optional[int] = None) -> None:
        """Write-through for a snapshot-floor advance (call inside the
        same transaction as :meth:`compact_below_floor`)."""
        self.conn.execute(
            "INSERT INTO __corro_snap_floors (actor_id, floor, ts) "
            "VALUES (?, ?, ?) ON CONFLICT (actor_id) DO UPDATE SET "
            "floor = MAX(floor, excluded.floor), ts = excluded.ts",
            (actor_id, int(floor), ts),
        )

    def compact_below_floor(self, actor_id: bytes, floor: int) -> int:
        """History compaction: delete the per-version bookkeeping this
        floor advance subsumes — concrete applied rows, partial seq
        rows, and buffered chunks at or below ``floor``.  Cleared-range
        rows are KEPT (they are already compact spans, and the
        EmptySet/watermark serving path still reads them).  Returns
        rows deleted; call inside the floor-advance transaction."""
        deleted = 0
        cur = self.conn.execute(
            "DELETE FROM __corro_bookkeeping WHERE actor_id=? "
            "AND end_version IS NULL AND start_version <= ?",
            (actor_id, int(floor)),
        )
        deleted += cur.rowcount
        for table in ("__corro_seq_bookkeeping", "__corro_buffered_changes"):
            cur = self.conn.execute(
                f"DELETE FROM {table} WHERE actor_id=? AND version <= ?",
                (actor_id, int(floor)),
            )
            deleted += cur.rowcount
        return deleted

    def reload(self, conn) -> None:
        """Rebuild the whole in-memory ledger from ``conn`` — the
        post-snapshot-install path: the database file was atomically
        swapped, so every actor's state re-derives from the installed
        tables.  The Bookie OBJECT survives (everything holding a
        reference keeps working); only its contents change."""
        self.conn = conn
        with self._lock:
            conn.executescript(self.TABLES)
            self._actors.clear()
            self._persisted_gaps.clear()
            self._bump_gen()
            self._load()

    def version_ts(self, actor_id: bytes, version: int) -> Optional[int]:
        """The HLC ts recorded when ``version`` was applied (the sync
        server stamps re-served Full changesets with it, like the
        reference reads ts back from ``__corro_bookkeeping``)."""
        with self._lock:
            row = self.conn.execute(
                "SELECT ts FROM __corro_bookkeeping WHERE actor_id=? "
                "AND start_version=? AND end_version IS NULL",
                (actor_id, version),
            ).fetchone()
        return row[0] if row else None

    _TS_CHUNK = 500  # bound parameters per IN (...) query

    def version_ts_many(
        self, actor_id: bytes, versions: List[int], conn=None,
    ) -> Dict[int, int]:
        """Batch variant of :meth:`version_ts`: one chunked ``IN (...)``
        query for a whole serve-range's versions instead of a point
        query each.  ``conn`` (e.g. a read-only pool connection) skips
        the storage lock — bookkeeping rows are committed data."""
        out: Dict[int, int] = {}

        def _run(c) -> None:
            for i in range(0, len(versions), self._TS_CHUNK):
                chunk = versions[i : i + self._TS_CHUNK]
                qs = ",".join("?" * len(chunk))
                for v, ts in c.execute(
                    "SELECT start_version, ts FROM __corro_bookkeeping "
                    "WHERE actor_id=? AND end_version IS NULL "
                    f"AND start_version IN ({qs})",
                    [actor_id, *chunk],
                ):
                    if ts is not None:
                        out[v] = ts

        if conn is not None:
            _run(conn)
        else:
            with self._lock:
                _run(self.conn)
        return out

    def cleared_since(
        self, actor_id: bytes, since_ts: Optional[int] = None
    ) -> List[Tuple[int, List[Tuple[int, int]]]]:
        """Cleared ranges strictly newer than ``since_ts``, grouped by
        the timestamp that stamped them, oldest group first (the sync
        Empty-need serving shape — ``peer.rs:715-762`` sends one EmptySet
        per distinct ts so the requester can advance its watermark one
        *complete* group at a time)."""
        with self._lock:
            sql = (
                "SELECT ts, start_version, end_version "
                "FROM __corro_bookkeeping "
                "WHERE actor_id=? AND end_version IS NOT NULL"
            )
            args: List = [actor_id]
            if since_ts is not None:
                sql += " AND ts > ?"
                args.append(int(since_ts))
            sql += " ORDER BY ts"
            groups: List[Tuple[int, List[Tuple[int, int]]]] = []
            for ts, s, e in self.conn.execute(sql, args).fetchall():
                ts = ts or 0
                if groups and groups[-1][0] == ts:
                    groups[-1][1].append((s, e))
                else:
                    groups.append((ts, [(s, e)]))
            return groups

    # -- buffered changes (partial version assembly) ---------------------

    def buffer_change(self, actor_id: bytes, version: int, seq: int,
                      blob: bytes) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO __corro_buffered_changes "
            "(actor_id, version, seq, change) VALUES (?, ?, ?, ?)",
            (actor_id, version, seq, blob),
        )

    def buffer_changes(
        self, actor_id: bytes, version: int,
        rows: List[Tuple[int, bytes]],
    ) -> None:
        """Batch variant of :meth:`buffer_change`: one executemany for a
        whole partial chunk's ``(seq, blob)`` rows."""
        self.conn.executemany(
            "INSERT OR REPLACE INTO __corro_buffered_changes "
            "(actor_id, version, seq, change) VALUES (?, ?, ?, ?)",
            [(actor_id, version, seq, blob) for seq, blob in rows],
        )

    def buffered_changes(self, actor_id: bytes, version: int,
                         conn=None) -> List[Tuple[int, bytes]]:
        """Buffered seq chunks of a partial version.  ``conn`` lets the
        off-loop sync server read through a pooled RO connection."""
        c = conn if conn is not None else self.conn
        return [
            (seq, bytes(blob))
            for seq, blob in c.execute(
                "SELECT seq, change FROM __corro_buffered_changes "
                "WHERE actor_id=? AND version=? ORDER BY seq",
                (actor_id, version),
            )
        ]

    # -- transactional snapshot (merged-apply failure recovery) ----------

    def snapshot_actor(self, actor_id: bytes) -> tuple:
        """Copy one actor's in-memory version state.  Paired with
        :meth:`restore_actor` around a multi-changeset transaction: if
        the tx rolls back after ``apply_version`` calls, memory must be
        rolled back too, or the lost versions read as already-applied
        and are never re-fetched until restart."""
        bv = self.for_actor(actor_id)
        needed = RangeSet()
        for s, e in bv.needed.spans():
            needed.insert(s, e)
        return (needed, dict(bv.partials), dict(bv.versions), bv.max_version)

    def restore_actor(self, actor_id: bytes, snapshot: tuple) -> None:
        bv = self.for_actor(actor_id)
        bv.needed, bv.partials, bv.versions, bv.max_version = snapshot
        # the gap write-through cache may now disagree with the rolled-
        # back DB rows: drop it so the next diff re-reads the table
        self._persisted_gaps.pop(actor_id, None)
        self._bump_gen()

    # -- access ----------------------------------------------------------

    def for_actor(self, actor_id: bytes) -> BookedVersions:
        bv = self._actors.get(actor_id)
        if bv is None:
            bv = self._actors[actor_id] = BookedVersions(
                actor_id, on_mutate=self._bump_gen
            )
            self._bump_gen()
        return bv

    def actors(self) -> Dict[bytes, BookedVersions]:
        return dict(self._actors)
