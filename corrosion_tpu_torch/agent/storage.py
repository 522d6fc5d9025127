"""CRDT storage engine: conflict-free replicated tables over stock sqlite3.

A copy of ``corrosion_tpu/agent/storage.py`` re-rooted on this package:
the batched apply resolves winners through this package's
``ops.merge.select_winners`` (the CUDA winners kernels from
``TORCH_AUTO_MIN`` changes when a card is present) and, with
``enable_device_cache``, seeds and stages through this package's
``ops.devcache`` (a ``TorchStore`` on the card by default).  SQL, UDFs,
the write-behind journal and the transaction boundary are the
reference's, unchanged.

This is our implementation of the semantics the reference gets from the
vendored cr-sqlite C extension (loaded at
``crates/corro-types/src/sqlite.rs:103-121``; semantics documented in
``doc/crdts.md``):

* ``as_crr(table)`` marks a table as a conflict-free replicated relation:
  a ``<t>__corro_clock`` table tracks a lamport ``col_version`` per
  (row, column) cell, and a ``<t>__corro_cl`` table tracks the row's
  **causal length** (odd = live, even = deleted);
* local writes run through generated AFTER INSERT/UPDATE/DELETE triggers
  that maintain the clock tables with (db_version, seq) stamps — any SQL
  write works, exactly like cr-sqlite's trigger machinery;
* ``collect_changes`` is the ``crsql_changes`` SELECT side: cell-level
  change rows, seq-ordered within a db_version;
* ``apply_changes`` is the ``crsql_changes`` INSERT side — the merge:
  bigger causal length wins the row; within an equal causal length the
  bigger ``col_version`` wins the cell, ties broken by the bigger value
  in cr-sqlite's type-enum order — INTEGER > FLOAT > TEXT > BLOB > NULL,
  numeric/bytewise within a type
  (:func:`corrosion_tpu_torch.agent.pack.value_cmp`, the reference's
  Python twin, which its tests pin against the real extension);
* ``site_id`` identifies this database (== the agent's ActorId), interned
  remote sites get small ordinals like cr-sqlite's site table.

Design difference from the reference (deliberate): no virtual tables —
change collection and application are plain queries + Python merge logic
(with a C fast path planned), because our hot path for bulk merges is the
device kernels behind :mod:`corrosion_tpu_torch.ops.merge`, not the sqlite
insert path.
"""

from __future__ import annotations

import operator
import re
import sqlite3
import threading
import uuid
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.agent.pack import pack_values, unpack_values, value_cmp
from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq
from corrosion_tpu_torch.types.change import Change, SENTINEL_CID

_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def unpack_stmt(stmt) -> Tuple[str, Sequence]:
    """One buffered statement → (sql, params).  Shared by the commit
    replay (runtime.execute_transaction) and the speculative sandbox so
    the two can never diverge on the statement shape."""
    if isinstance(stmt, str):
        return stmt, ()
    return stmt[0], stmt[1] if len(stmt) > 1 else ()


def _ident(name: str) -> str:
    if not _IDENT_RE.match(name):
        raise ValueError(f"invalid identifier: {name!r}")
    return name


@dataclass(frozen=True)
class TableInfo:
    name: str
    pk_cols: Tuple[str, ...]
    data_cols: Tuple[str, ...]  # non-pk columns
    all_cols: Tuple[str, ...] = ()  # DECLARATION order (RETURNING *)
    # every data column is nullable or has a DEFAULT: a fresh row can be
    # created listing only (pk + written cells) with the exact same
    # outcome as _ensure_row + per-cell UPDATEs.  When False the batched
    # apply keeps the conservative two-step shape, bug-for-bug with the
    # per-change path (whose pk-only INSERT OR IGNORE silently fails on
    # NOT-NULL-without-default columns).
    fused_insert_ok: bool = True


class _WriteBehind:
    """In-memory ledger of merged-but-unflushed table batches (the
    device-resident apply's async flush queue).  Each entry is
    ``(table, states, journal_id)``: the net merged ``states`` the
    flush will consume, and the ``__corro_flush_journal`` row that
    makes it crash-durable.

    Lifecycle: an apply stages entries on ``tx_staged`` (journal row
    inserted in the same transaction); commit moves them to
    ``pending``; a drain moves pending entries being flushed inside an
    open apply transaction to ``draining`` so a rollback can requeue
    them at the FRONT (their journal deletes roll back with the tx).
    ``unflushed`` maps table -> pks with any not-yet-flushed state —
    the overlap guard that forces a flush before SQLite is read for
    those rows."""

    __slots__ = ("pending", "draining", "tx_staged", "unflushed")

    def __init__(self):
        self.pending: List[tuple] = []
        self.draining: List[tuple] = []
        self.tx_staged: List[tuple] = []
        self.unflushed: Dict[str, set] = {}

    def recompute(self) -> None:
        u: Dict[str, set] = {}
        for t, states, _jid in self.pending:
            u.setdefault(t, set()).update(states)
        for t, states, _jid in self.tx_staged:
            u.setdefault(t, set()).update(states)
        self.unflushed = u

    def cells_pending(self) -> int:
        return sum(
            len(st[5]) + 1
            for _t, states, _j in self.pending
            for st in states.values()
        )


def _wb_coalesce(s1: list, s2: list) -> list:
    """Merge two staged net states for the same (table, pk), s2 newer.
    A newer generation (row replaced) supersedes everything earlier;
    otherwise the newer cells overlay the older ones.  Sound because s2
    was merged against a seed view that already included s1 (the cache
    shadow), so s2's decisions account for s1."""
    if s2[2]:  # GEN
        c1, c2 = s1[1], s2[1]
        if c1 is None:
            return s2
        out = list(s2)
        if c2 is None:
            # no cl write in s2: a sequential flush would have left
            # s1's cl row in place
            out[1] = c1
        elif c1[5] and not c2[5]:
            # sequential flushes MAX the sentinel flag across the
            # upsert (s1's row would already be in the DB) — coalescing
            # must not lose s1's flag before the DB ever sees it
            out[1] = c2[:5] + (1,)
        return out
    out = list(s1)
    if s2[1] is not None:
        c1 = s1[1]
        out[1] = (s2[1][:5] + (1,)
                  if c1 is not None and c1[5] and not s2[1][5]
                  else s2[1])
    if s2[0] is not None:
        out[0] = s2[0]
    out[4] = s1[4] or s2[4]  # ENSURE
    cells = dict(s1[5])
    cells.update(s2[5])
    out[5] = cells
    return out


def _wb_encode_states(states: Dict[bytes, list]) -> bytes:
    """Versioned net states for the flush journal.  Net STATES, not
    winner Changes: replaying winners through apply_changes is not
    idempotent for fresh implicit-cl rows (the generation branch of the
    per-change path wipes sibling cells a batched flush preserved), so
    the journal stores exactly what ``_flush_table_states`` consumes.

    pickle, not speedy: the encode runs inside the apply transaction's
    critical section on every device-path batch, and the per-field
    Python writer dominated the whole apply wall (55% in profile) where
    pickle's C encoder is noise.  This is safe ONLY because the journal
    never crosses a trust boundary: payloads are written and read by
    this node alone — boot recovery decodes bytes this process family
    wrote, and ``install_snapshot`` PURGES (never replays) journal rows
    arriving inside a donor's snapshot file."""
    import pickle

    return b"\x01" + pickle.dumps(states, protocol=4)


def _wb_decode_states(payload: bytes) -> Dict[bytes, list]:
    import pickle

    if payload[:1] != b"\x01":
        raise ValueError("unknown flush-journal payload version")
    return pickle.loads(payload[1:])


def register_udfs(conn: sqlite3.Connection) -> None:
    """Register every SQL function the CRR layer depends on.  ANY
    connection touching an agent database needs these: the CRR tables
    carry expression indexes on corro_pack, so even a plain VACUUM
    fails without it."""
    conn.create_function("corro_pack", -1, _udf_pack, deterministic=True)
    conn.create_function(
        "corro_json_contains", 2, _udf_json_contains, deterministic=True
    )
    # PG-compat identity functions: drivers call these in arbitrary
    # expression contexts ("SELECT current_database() AS name"), so they
    # must exist as real functions, not canned string matches (the
    # pgwire front-end routes such queries here; corro-pg parity)
    conn.create_function(
        "current_database", 0, lambda: "corrosion", deterministic=True
    )
    conn.create_function(
        "current_schema", 0, lambda: "public", deterministic=True
    )
    conn.create_function(
        "version", 0,
        lambda: "PostgreSQL 14.9 (corrosion-tpu sqlite CRDT)",
        deterministic=True,
    )


class CrConn:
    """A sqlite3 connection with the CRDT layer installed."""

    RO_POOL_SIZE = 20  # reference: 1 RW + 20 RO (agent.rs:614-765)

    def __init__(self, path: str, site_id: Optional[bytes] = None,
                 lock_registry=None):
        from corrosion_tpu_torch.agent.locks import PriorityLock

        self.path = path
        self.conn = self._connect_rw()
        # single RW connection behind a 3-tier priority mutex: applies
        # of replicated changes go first, API writes next, maintenance
        # last (the scheduling the reference gets from its split write
        # pools, agent.rs:614-765)
        self._lock = PriorityLock(lock_registry, "storage")
        self._init_meta(site_id)
        self._tables: Dict[str, TableInfo] = {}
        self._load_crr_tables()
        # read pool: up to RO_POOL_SIZE read-only connections created
        # lazily; concurrent readers no longer serialize on one conn
        self._ro_free: List[sqlite3.Connection] = []
        self._ro_all: List[sqlite3.Connection] = []
        self._ro_cv = threading.Condition()
        self._ro_closed = False
        # readers checked out across a snapshot install keep serving
        # their (pre-swap) WAL snapshot, then close on return instead
        # of re-pooling — the pool refills lazily against the new file
        self._ro_stale: set = set()
        # slow-disk fault seam (faults.FaultController.io_hook_for):
        # callable(op: "write"|"read") -> delay seconds, consulted once
        # per write batch and per change collection.  The sleep runs on
        # the worker/caller thread holding the storage path — a slow
        # disk stretches lock holds and serve windows, it does not
        # block the event loop directly.  None in production.
        self.io_fault = None
        # columnar merge kernel dispatch (docs/crdts.md): batched
        # applies at/above the threshold resolve winners through
        # ops/merge.py segment reductions; below it (or on encode
        # fallback) the per-change dict replay runs.  The agent mirrors
        # AgentConfig.columnar_merge / columnar_merge_min here.
        self.columnar_merge = True
        self.columnar_merge_min = 256
        # optional Metrics sink (set by the agent): merge-phase timing
        # lands in corro_apply_merge_seconds{kernel=}
        self.metrics = None
        # device-resident apply (docs/crdts.md "Device-resident apply"):
        # when enabled, batched applies seed from the cross-batch clock
        # cache and SQLite becomes the durable sink behind the
        # write-behind flush below.  None == classic prefetch path.
        self.device_cache = None
        # the device the batched apply's winner selection runs on
        # (ops.merge.select_winners): None = the card when present;
        # enable_device_cache and the agent set it
        self.device = None
        self._wb = _WriteBehind()
        # metric-delta snapshot for the cache's monotonic counters
        self._devcache_emitted: Dict = {}
        # flush-journal rows replayed at boot (crash between an apply
        # commit and its async flush); the agent re-emits this as
        # corro_apply_flush_recoveries_total once metrics attach
        self.flush_journal_recovered = 0
        self._recover_flush_journal()

    def _connect_rw(self) -> sqlite3.Connection:
        """The ONE RW-connection recipe, shared by construction and the
        post-snapshot-install reopen — a pragma added here applies to
        both, so a node that installed a snapshot never runs a
        differently-configured connection until restart."""
        conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.isolation_level = None  # manual transactions
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        conn.execute("PRAGMA foreign_keys=OFF")
        # transient SQLITE_BUSY (e.g. a checkpoint of a large WAL racing
        # a snapshot open) should wait, not raise: a raise on the
        # subscription delta path degrades it to a full re-evaluation
        conn.execute("PRAGMA busy_timeout=5000")
        register_udfs(conn)
        return conn

    def _io_delay(self, op: str) -> None:
        hook = self.io_fault
        if hook is None:
            return
        d = hook(op)
        if d and d > 0:
            import time

            time.sleep(d)

    def _new_ro(self) -> sqlite3.Connection:
        conn = sqlite3.connect(
            f"file:{self.path}?mode=ro", uri=True, check_same_thread=False,
        )
        conn.execute("PRAGMA busy_timeout=5000")  # see RW conn note
        # triggers resolve functions at prepare time, so RO conns need
        # them registered even though writes will fail
        register_udfs(conn)
        return conn

    @property
    def _ro_conn(self) -> sqlite3.Connection:
        """The pool's first reader — the instrumentation anchor: tests
        attach progress handlers here, and checkout PREFERS it whenever
        it is free, so single-threaded callers reliably land on it even
        after the pool has grown."""
        with self._ro_cv:
            if not self._ro_all:
                conn = self._new_ro()
                self._ro_all.append(conn)
                self._ro_free.append(conn)
            return self._ro_all[0]

    @contextmanager
    def reader(self):
        """Check a read-only connection out of the pool (split-pool
        parity).  Blocks when all RO_POOL_SIZE readers are in flight."""
        with self._ro_cv:
            while not self._ro_free and len(self._ro_all) >= self.RO_POOL_SIZE:
                if self._ro_closed:
                    raise sqlite3.ProgrammingError("storage is closed")
                self._ro_cv.wait()
            if self._ro_closed:
                raise sqlite3.ProgrammingError("storage is closed")
            if self._ro_free:
                # prefer the instrumented first reader when free
                first = self._ro_all[0] if self._ro_all else None
                if first is not None and first in self._ro_free:
                    self._ro_free.remove(first)
                    conn = first
                else:
                    conn = self._ro_free.pop()
            else:
                conn = self._new_ro()
                self._ro_all.append(conn)
        try:
            yield conn
        finally:
            with self._ro_cv:
                if self._ro_closed or conn in self._ro_stale:
                    conn.close()
                    self._ro_stale.discard(conn)
                    if conn in self._ro_all:
                        self._ro_all.remove(conn)
                    self._ro_cv.notify()
                else:
                    self._ro_free.append(conn)
                    self._ro_cv.notify()

    def read_query(self, sql: str, params: Sequence = (), on_conn=None):
        """Run a query on a pooled read-only connection.  Writes through
        this path fail with a sqlite 'readonly' error instead of
        corrupting version accounting.  ``on_conn`` (called with the
        checked-out connection, then with None on completion) lets a
        caller interrupt a long-running read — the PG front-end's
        CancelRequest path."""
        # write-behind barrier: serve reads (API queries, subscription
        # evaluation, snapshot assembly) must not observe a merged-but-
        # unflushed winner; no-op unless the device path staged state
        self.flush_barrier()
        with self.reader() as conn:
            if on_conn is not None:
                on_conn(conn)
            try:
                cur = conn.execute(sql, params)
                cols = [d[0] for d in cur.description or []]
                return cols, cur.fetchall()
            finally:
                if on_conn is not None:
                    on_conn(None)

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------

    def _init_meta(self, site_id: Optional[bytes]) -> None:
        c = self.conn
        c.execute(
            "CREATE TABLE IF NOT EXISTS __corro_state "
            "(key TEXT PRIMARY KEY, value INTEGER NOT NULL)"
        )
        c.execute(
            "INSERT OR IGNORE INTO __corro_state VALUES "
            "('db_version', 0), ('pending_db_version', 0), ('seq', 0), "
            "('apply_mode', 0)"
        )
        c.execute(
            "CREATE TABLE IF NOT EXISTS __corro_sites "
            "(ordinal INTEGER PRIMARY KEY AUTOINCREMENT, site_id BLOB NOT NULL UNIQUE)"
        )
        c.execute(
            "CREATE TABLE IF NOT EXISTS __corro_crr_tables (name TEXT PRIMARY KEY)"
        )
        c.execute(
            "CREATE TABLE IF NOT EXISTS __corro_backfills "
            "(db_version INTEGER PRIMARY KEY, last_seq INTEGER NOT NULL)"
        )
        # local versions whose clock rows were overwritten/deleted since
        # the last compaction sweep (find_overwritten_versions parity,
        # ref agent.rs:1753-1812; filled by the clock-change triggers)
        c.execute(
            "CREATE TABLE IF NOT EXISTS __corro_versions_impacted "
            "(site_ordinal INTEGER NOT NULL, db_version INTEGER NOT NULL, "
            " PRIMARY KEY (site_ordinal, db_version))"
        )
        # write-behind flush journal (device-resident apply): one row
        # per merged-but-unflushed table batch, inserted in the apply
        # transaction and deleted in the transaction that flushes it —
        # a crash in the window between the two replays at boot
        # (_recover_flush_journal), so no committed winner is ever lost
        c.execute(
            "CREATE TABLE IF NOT EXISTS __corro_flush_journal "
            "(id INTEGER PRIMARY KEY AUTOINCREMENT, "
            " tbl TEXT NOT NULL, payload BLOB NOT NULL)"
        )
        row = c.execute(
            "SELECT site_id FROM __corro_sites WHERE ordinal = 1"
        ).fetchone()
        if row is None:
            sid = site_id or uuid.uuid4().bytes
            c.execute("INSERT INTO __corro_sites (ordinal, site_id) VALUES (1, ?)", (sid,))
            self.site_id = sid
        else:
            self.site_id = bytes(row[0])

    def _load_crr_tables(self) -> None:
        for (name,) in self.conn.execute("SELECT name FROM __corro_crr_tables"):
            info = self._introspect(name)
            self._tables[name] = info
            # idempotent: databases created before the compaction feature
            # need the impact triggers installed on reopen
            self._create_impact_triggers(name)
            # likewise for the packed-pk expression index (without it,
            # change collection degrades to per-clock-row full scans)
            pack_expr = "corro_pack(" + ", ".join(
                f'"{p}"' for p in info.pk_cols
            ) + ")"
            self.conn.execute(
                f'CREATE INDEX IF NOT EXISTS "{name}__corro_packpk" '
                f'ON "{name}" ({pack_expr})'
            )

    def _introspect(self, table: str) -> TableInfo:
        info = self.conn.execute(f'PRAGMA table_info("{_ident(table)}")').fetchall()
        if not info:
            raise ValueError(f"no such table: {table}")
        pk = tuple(r[1] for r in sorted((r for r in info if r[5]), key=lambda r: r[5]))
        data = tuple(r[1] for r in info if not r[5])
        if not pk:
            raise ValueError(f"CRR table {table} must have a primary key")
        return TableInfo(
            name=table, pk_cols=pk, data_cols=data,
            all_cols=tuple(r[1] for r in info),
            fused_insert_ok=all(
                not r[3] or r[4] is not None for r in info if not r[5]
            ),
        )

    @property
    def tables(self) -> Dict[str, TableInfo]:
        return dict(self._tables)

    def declared_columns(self, table: str) -> Tuple[str, ...]:
        """A table's columns in DECLARATION order, cached per sqlite
        ``schema_version`` (which bumps on any DDL — runtime ALTERs
        over the wire invalidate the cache; one scalar PRAGMA per
        call otherwise)."""
        _, rows = self.read_query("PRAGMA schema_version")
        sv = rows[0][0]
        cached_sv, cols_by_table = getattr(
            self, "_declared_cols_cache", (None, {})
        )
        if cached_sv != sv:
            cols_by_table = {}
            self._declared_cols_cache = (sv, cols_by_table)
        if table not in cols_by_table:
            try:
                _, info = self.read_query(
                    f'PRAGMA table_info("{_ident(table)}")'
                )
            except (sqlite3.Error, ValueError):
                return ()
            cols_by_table[table] = tuple(r[1] for r in info)
        return cols_by_table[table]

    # ------------------------------------------------------------------
    # site interning
    # ------------------------------------------------------------------

    def site_ordinal(self, site_id: bytes) -> int:
        with self._lock:
            row = self.conn.execute(
                "SELECT ordinal FROM __corro_sites WHERE site_id = ?", (site_id,)
            ).fetchone()
            if row:
                return row[0]
            cur = self.conn.execute(
                "INSERT INTO __corro_sites (site_id) VALUES (?)", (site_id,)
            )
            return cur.lastrowid

    def site_for_ordinal(self, ordinal: int) -> bytes:
        row = self.conn.execute(
            "SELECT site_id FROM __corro_sites WHERE ordinal = ?", (ordinal,)
        ).fetchone()
        if row is None:
            raise KeyError(f"unknown site ordinal {ordinal}")
        return bytes(row[0])

    # ------------------------------------------------------------------
    # CRR setup (crsql_as_crr)
    # ------------------------------------------------------------------

    def as_crr(self, table: str) -> None:
        t = _ident(table)
        info = self._introspect(t)
        c = self.conn
        c.execute(
            f'CREATE TABLE IF NOT EXISTS "{t}__corro_clock" ('
            " pk BLOB NOT NULL, cid TEXT NOT NULL,"
            " col_version INTEGER NOT NULL, db_version INTEGER NOT NULL,"
            " seq INTEGER NOT NULL, site_ordinal INTEGER NOT NULL,"
            " PRIMARY KEY (pk, cid))"
        )
        c.execute(
            f'CREATE INDEX IF NOT EXISTS "{t}__corro_clock_dbv" '
            f'ON "{t}__corro_clock" (site_ordinal, db_version)'
        )
        # `sentinel`: 1 when the row-level event must ship as a '-1'
        # sentinel change (delete, resurrect, pk move, pk-only insert) —
        # plain inserts of tables with cells carry the row via cell rows
        # alone, matching cr-sqlite's clock contents exactly.
        c.execute(
            f'CREATE TABLE IF NOT EXISTS "{t}__corro_cl" ('
            " pk BLOB NOT NULL PRIMARY KEY, cl INTEGER NOT NULL,"
            " db_version INTEGER NOT NULL, seq INTEGER NOT NULL,"
            " site_ordinal INTEGER NOT NULL,"
            " sentinel INTEGER NOT NULL DEFAULT 0)"
        )
        have_cols = {
            r[1] for r in c.execute(f'PRAGMA table_info("{t}__corro_cl")')
        }
        if "sentinel" not in have_cols:
            c.execute(
                f'ALTER TABLE "{t}__corro_cl" '
                "ADD COLUMN sentinel INTEGER NOT NULL DEFAULT 0"
            )
        c.execute(
            f'CREATE INDEX IF NOT EXISTS "{t}__corro_cl_dbv" '
            f'ON "{t}__corro_cl" (site_ordinal, db_version)'
        )
        # expression index on the packed pk: change collection joins the
        # data table ON corro_pack(pk cols) = clock.pk — without this the
        # join is a per-clock-row full scan (quadratic in table size)
        pack_expr = "corro_pack(" + ", ".join(
            f'"{p}"' for p in info.pk_cols
        ) + ")"
        c.execute(
            f'CREATE INDEX IF NOT EXISTS "{t}__corro_packpk" '
            f'ON "{t}" ({pack_expr})'
        )
        self._create_triggers(info)
        self._create_impact_triggers(t)
        c.execute("INSERT OR IGNORE INTO __corro_crr_tables VALUES (?)", (t,))
        self._tables[t] = info
        if self.device_cache is not None:
            # (re-)declaring a CRR changes the cid ordinal space the
            # cache packs its keys with — drop its view of this table
            self.device_cache.invalidate_table(t)
        self._backfill(info)

    def _create_impact_triggers(self, t: str) -> None:
        """Record local (site_ordinal=1) versions whose change rows get
        overwritten or deleted, for compaction.

        Parity: the reference's clock-change triggers
        (``create_clock_change_trigger``, agent.rs:570-592) watch only
        local rows; cl entries matter only when they ship as sentinels.
        """
        imp = ("INSERT INTO __corro_versions_impacted (site_ordinal, "
               "db_version) VALUES (OLD.site_ordinal, OLD.db_version) "
               "ON CONFLICT (site_ordinal, db_version) DO NOTHING;")
        self.conn.executescript(f"""
CREATE TRIGGER IF NOT EXISTS "{t}__corro_impact_clock_upd"
AFTER UPDATE ON "{t}__corro_clock" FOR EACH ROW
WHEN OLD.site_ordinal = 1 AND (OLD.site_ordinal != NEW.site_ordinal
  OR OLD.db_version != NEW.db_version)
BEGIN
  {imp}
END;
CREATE TRIGGER IF NOT EXISTS "{t}__corro_impact_clock_del"
AFTER DELETE ON "{t}__corro_clock" FOR EACH ROW
WHEN OLD.site_ordinal = 1
BEGIN
  {imp}
END;
CREATE TRIGGER IF NOT EXISTS "{t}__corro_impact_cl_upd"
AFTER UPDATE ON "{t}__corro_cl" FOR EACH ROW
WHEN OLD.site_ordinal = 1 AND OLD.sentinel = 1
  AND (OLD.site_ordinal != NEW.site_ordinal
       OR OLD.db_version != NEW.db_version)
BEGIN
  {imp}
END;
CREATE TRIGGER IF NOT EXISTS "{t}__corro_impact_cl_del"
AFTER DELETE ON "{t}__corro_cl" FOR EACH ROW
WHEN OLD.site_ordinal = 1 AND OLD.sentinel = 1
BEGIN
  {imp}
END;
""")

    def overwritten_local_db_versions(self) -> Tuple[bool, List[int]]:
        """(any_impacted, gone): impacted local db_versions that no longer
        have ANY change row (cell clock or sentinel cl) — fully
        overwritten, compactable.  Read-only; the caller deletes
        __corro_versions_impacted in its transaction
        (``find_overwritten_versions`` parity)."""
        with self._lock:
            impacted = [
                r[0] for r in self.conn.execute(
                    "SELECT db_version FROM __corro_versions_impacted "
                    "WHERE site_ordinal = 1"
                )
            ]
            if not impacted:
                return False, []
            gone = []
            for dbv in impacted:
                exists = False
                for t in self._tables:
                    if self.conn.execute(
                        f'SELECT 1 FROM "{t}__corro_clock" '
                        "WHERE site_ordinal = 1 AND db_version = ? LIMIT 1",
                        (dbv,),
                    ).fetchone() or self.conn.execute(
                        f'SELECT 1 FROM "{t}__corro_cl" '
                        "WHERE site_ordinal = 1 AND sentinel = 1 "
                        "AND db_version = ? LIMIT 1",
                        (dbv,),
                    ).fetchone():
                        exists = True
                        break
                if not exists:
                    gone.append(dbv)
            return True, gone

    def _backfill(self, info: TableInfo) -> None:
        """Stamp rows that predate as_crr (or a new column) into the clock
        tables so they replicate.

        Parity: cr-sqlite's ``crsql_as_crr`` backfills existing rows —
        pinned by the golden probe: every pre-existing cell gets
        col_version=1 stamped with one freshly allocated db_version and
        sequential seqs.  Idempotent: only missing cl rows / clock cells
        are filled, so re-running after ALTER TABLE ADD COLUMN backfills
        just the new column.
        """
        t = info.name
        d_pk = "corro_pack(" + ", ".join(f'd."{p}"' for p in info.pk_cols) + ")"
        with self._lock:
            missing_rows = [
                bytes(r[0]) for r in self.conn.execute(
                    f'SELECT {d_pk} FROM "{t}" d '
                    f'LEFT JOIN "{t}__corro_cl" c ON c.pk = {d_pk} '
                    "WHERE c.pk IS NULL"
                )
            ]
            missing_cells = []  # (pk, cid)
            for col in info.data_cols:
                missing_cells.extend(
                    (bytes(r[0]), col) for r in self.conn.execute(
                        f'SELECT {d_pk} FROM "{t}" d '
                        f'LEFT JOIN "{t}__corro_clock" k '
                        f"ON k.pk = {d_pk} AND k.cid = ? "
                        "WHERE k.pk IS NULL",
                        (col,),
                    )
                )
            if not missing_rows and not missing_cells:
                return
            self.conn.execute("BEGIN IMMEDIATE")
            try:
                pending = self._state("db_version") + 1
                seq = 0
                for pk in missing_rows:
                    # pk-only rows replicate via sentinels (consume a seq
                    # slot); cell-bearing rows ride their cells alone
                    sentinel = 0 if info.data_cols else 1
                    self.conn.execute(
                        f'INSERT OR IGNORE INTO "{t}__corro_cl" '
                        "(pk, cl, db_version, seq, site_ordinal, sentinel) "
                        "VALUES (?, 1, ?, ?, 1, ?)",
                        (pk, pending, seq if sentinel else 0, sentinel),
                    )
                    if sentinel:
                        seq += 1
                for pk, cid in missing_cells:
                    self.conn.execute(
                        f'INSERT OR IGNORE INTO "{t}__corro_clock" '
                        "(pk, cid, col_version, db_version, seq, site_ordinal) "
                        "VALUES (?, ?, 1, ?, ?, 1)",
                        (pk, cid, pending, seq),
                    )
                    seq += 1
                self._set_state("db_version", pending)
                # durable pending-registration record: survives a crash
                # between this COMMIT and the agent registering the
                # version in its bookkeeping (drained transactionally)
                self.conn.execute(
                    "INSERT INTO __corro_backfills (db_version, last_seq) "
                    "VALUES (?, ?)",
                    (pending, seq - 1),
                )
            except BaseException:
                self.conn.execute("ROLLBACK")
                raise
            self.conn.execute("COMMIT")

    def peek_backfills(self) -> List[Tuple[int, int]]:
        with self._lock:
            return [
                (r[0], r[1]) for r in self.conn.execute(
                    "SELECT db_version, last_seq FROM __corro_backfills "
                    "ORDER BY db_version"
                )
            ]

    def clear_backfills(self) -> None:
        """Delete the pending-backfill records (inside the caller's tx)."""
        self.conn.execute("DELETE FROM __corro_backfills")

    def _create_triggers(self, info: TableInfo) -> None:
        t = info.name
        new_pk = "corro_pack(" + ", ".join(f'NEW."{p}"' for p in info.pk_cols) + ")"
        old_pk = "corro_pack(" + ", ".join(f'OLD."{p}"' for p in info.pk_cols) + ")"
        pending = "(SELECT value FROM __corro_state WHERE key='pending_db_version')"
        seq_now = "(SELECT value FROM __corro_state WHERE key='seq') - 1"
        not_applying = "(SELECT value FROM __corro_state WHERE key='apply_mode') = 0"
        bump_seq = "UPDATE __corro_state SET value = value + 1 WHERE key='seq'"

        def cell_upsert(pk_expr: str, col: str, guard: str = "") -> str:
            return (
                f"{bump_seq}{guard};\n"
                f'INSERT INTO "{t}__corro_clock" '
                "(pk, cid, col_version, db_version, seq, site_ordinal) "
                f"SELECT {pk_expr}, '{col}', 1, {pending}, {seq_now}, 1 "
                f"WHERE 1=1{guard} "
                "ON CONFLICT(pk, cid) DO UPDATE SET "
                "col_version = col_version + 1, "
                "db_version = excluded.db_version, "
                "seq = excluded.seq, site_ordinal = 1;"
            )

        ins_cells = "\n".join(cell_upsert(new_pk, c) for c in info.data_cols)
        upd_cells = "\n".join(
            cell_upsert(new_pk, c, f' AND NEW."{c}" IS NOT OLD."{c}"')
            for c in info.data_cols
        )
        cl_tbl = f'"{t}__corro_cl"'

        # Sentinel lifecycle pinned against cr-sqlite's clock contents
        # (tests/test_crsqlite_golden.py probes): a fresh insert of a
        # table WITH cells creates a non-sentinel cl entry that consumes
        # no seq slot (cells alone carry the row, seqs 0..n-1 exactly
        # like the reference); deletes, resurrects, pk moves, and
        # pk-only-table inserts produce sentinel entries that do consume
        # a seq slot and ship as '-1' changes.
        if info.data_cols:
            ins_row = f"""
  UPDATE __corro_state SET value = value + 1 WHERE key='seq'
    AND EXISTS (SELECT 1 FROM {cl_tbl} WHERE pk = {new_pk} AND cl % 2 = 0);
  UPDATE {cl_tbl} SET cl = cl + 1, db_version = {pending},
      seq = {seq_now}, site_ordinal = 1, sentinel = 1
    WHERE pk = {new_pk} AND cl % 2 = 0;
  INSERT OR IGNORE INTO {cl_tbl}
      (pk, cl, db_version, seq, site_ordinal, sentinel)
    VALUES ({new_pk}, 1, {pending}, 0, 1, 0);"""
        else:
            ins_row = f"""
  {bump_seq};
  INSERT INTO {cl_tbl} (pk, cl, db_version, seq, site_ordinal, sentinel)
    VALUES ({new_pk}, 1, {pending}, {seq_now}, 1, 1)
    ON CONFLICT(pk) DO UPDATE SET
      cl = CASE WHEN cl % 2 = 0 THEN cl + 1 ELSE cl END,
      db_version = excluded.db_version,
      seq = excluded.seq, site_ordinal = 1, sentinel = 1;"""

        # Primary-key updates change the row's identity: the old pk gets a
        # delete sentinel (even cl), the new pk an insert sentinel (odd
        # cl), both in the current version, and existing cell clock rows
        # are re-keyed in place keeping their original (db_version, seq)
        # stamps — so a delta-only transfer of the new version carries
        # just the sentinels (and heals fully via anti-entropy), exactly
        # like the reference extension.  The re-key uses an explicit
        # DELETE of conflicting target rows (NOT `UPDATE OR REPLACE`):
        # REPLACE conflict-deletes skip AFTER DELETE triggers, which
        # would lose the compaction impact record for the displaced rows.
        pk_moved = f"{new_pk} IS NOT {old_pk}"
        pk_move = f"""
  UPDATE __corro_state SET value = value + 1 WHERE key='seq' AND {pk_moved};
  INSERT INTO {cl_tbl} (pk, cl, db_version, seq, site_ordinal, sentinel)
    SELECT {old_pk}, 2, {pending}, {seq_now}, 1, 1 WHERE {pk_moved}
    ON CONFLICT(pk) DO UPDATE SET
      cl = CASE WHEN cl % 2 = 1 THEN cl + 1 ELSE cl END,
      db_version = excluded.db_version,
      seq = excluded.seq, site_ordinal = 1, sentinel = 1;
  UPDATE __corro_state SET value = value + 1 WHERE key='seq' AND {pk_moved};
  INSERT INTO {cl_tbl} (pk, cl, db_version, seq, site_ordinal, sentinel)
    SELECT {new_pk}, 1, {pending}, {seq_now}, 1, 1 WHERE {pk_moved}
    ON CONFLICT(pk) DO UPDATE SET
      cl = CASE WHEN cl % 2 = 0 THEN cl + 1 ELSE cl END,
      db_version = excluded.db_version,
      seq = excluded.seq, site_ordinal = 1, sentinel = 1;
  DELETE FROM "{t}__corro_clock" WHERE pk = {new_pk} AND {pk_moved};
  UPDATE "{t}__corro_clock" SET pk = {new_pk}
    WHERE pk = {old_pk} AND {pk_moved};"""

        self.conn.executescript(
            f"""
DROP TRIGGER IF EXISTS "{t}__corro_ins";
CREATE TRIGGER "{t}__corro_ins" AFTER INSERT ON "{t}"
WHEN {not_applying}
BEGIN
  {ins_row}
  {ins_cells}
END;
DROP TRIGGER IF EXISTS "{t}__corro_upd";
CREATE TRIGGER "{t}__corro_upd" AFTER UPDATE ON "{t}"
WHEN {not_applying}
BEGIN
  {pk_move}
  {upd_cells}
END;
DROP TRIGGER IF EXISTS "{t}__corro_del";
CREATE TRIGGER "{t}__corro_del" AFTER DELETE ON "{t}"
WHEN {not_applying}
BEGIN
  {bump_seq};
  INSERT INTO {cl_tbl} (pk, cl, db_version, seq, site_ordinal, sentinel)
    VALUES ({old_pk}, 2, {pending}, {seq_now}, 1, 1)
    ON CONFLICT(pk) DO UPDATE SET
      cl = CASE WHEN cl % 2 = 1 THEN cl + 1 ELSE cl END,
      db_version = excluded.db_version,
      seq = excluded.seq, site_ordinal = 1, sentinel = 1;
  DELETE FROM "{t}__corro_clock" WHERE pk = {old_pk};
END;
"""
        )

    # ------------------------------------------------------------------
    # versions & transactions
    # ------------------------------------------------------------------

    def db_version(self) -> int:
        """Last committed local db_version (crsql: current db version)."""
        with self._lock:
            return self._state("db_version")

    def next_db_version(self) -> int:
        return self.db_version() + 1

    def _state(self, key: str) -> int:
        (v,) = self.conn.execute(
            "SELECT value FROM __corro_state WHERE key=?", (key,)
        ).fetchone()
        return v

    def _set_state(self, key: str, value: int) -> None:
        self.conn.execute(
            "UPDATE __corro_state SET value=? WHERE key=?", (value, key)
        )

    def begin_write_batch(self) -> int:
        """Arm the trigger state for one local write batch inside an
        already-open transaction: allocate the next pending db_version
        and reset the seq counter.  Returns the pending db_version.
        Shared by :meth:`write_tx` (one batch per transaction) and the
        group-commit combiner (one batch per SAVEPOINT inside a shared
        outer transaction — ``runtime._run_write_group_locked``); the
        caller commits the allocation by setting ``db_version`` to the
        returned value iff the batch produced changes."""
        self._io_delay("write")
        pending = self._state("db_version") + 1
        self._set_state("pending_db_version", pending)
        self._set_state("seq", 0)
        return pending

    @contextmanager
    def write_tx(self):
        """One local transaction == at most one allocated db_version.

        Mirrors cr-sqlite: the version is only consumed if the transaction
        actually produced changes.  Client writes take the HIGH tier —
        the reference's API write path acquires ``write_priority()``
        (``api/public/mod.rs:59``) so users aren't queued behind
        replication or maintenance.
        """
        from corrosion_tpu_torch.agent.locks import PRIO_HIGH

        with self._lock.prio(PRIO_HIGH, "write", kind="write"):
            # local-write triggers read the clock tables (col_version
            # continuation), so any staged-but-unflushed winner must
            # land first; after COMMIT the trigger-written clocks make
            # the cache view stale — the write-combiner invalidation
            self._wb_drain_locked()
            self.conn.execute("BEGIN IMMEDIATE")
            pending = self.begin_write_batch()
            try:
                yield self.conn
            except BaseException:
                # an interrupt (CancelRequest) or constraint abort may
                # have rolled the tx back already; a second ROLLBACK
                # would mask the real error with "cannot rollback"
                if self.conn.in_transaction:
                    self.conn.execute("ROLLBACK")
                raise
            wrote = self._state("seq") > 0
            if wrote:
                self._set_state("db_version", pending)
            self.conn.execute("COMMIT")
            if wrote and self.device_cache is not None:
                self.device_cache.invalidate_all("local_write")
                self._emit_cache_metrics()

    def speculative_read(self, writes: Sequence, sql: str,
                         params: Sequence = ()):
        """Evaluate ``sql`` as if ``writes`` had been applied, then roll
        everything back — read-your-writes for a buffered interactive
        transaction (the PG session's BEGIN..COMMIT, which holds no
        lock across client round trips; PG's READ COMMITTED lets later
        committed state show between reads).

        The sandbox mirrors ``write_tx``'s state setup so the CRR
        triggers fire normally; ROLLBACK reverts data, clock tables and
        ``__corro_state`` alike (all same-database rows).  Cost is
        O(buffered writes) per read, bounded by the transaction size.
        """
        from corrosion_tpu_torch.agent.locks import PRIO_HIGH

        with self._lock.prio(PRIO_HIGH, "speculative-read", kind="write"):
            # the sandbox fires the CRR triggers, which read the clock
            # tables — staged-but-unflushed winners must land first
            self._wb_drain_locked()
            self.conn.execute("BEGIN")
            try:
                pending = self._state("db_version") + 1
                self._set_state("pending_db_version", pending)
                self._set_state("seq", 0)
                for stmt in writes:
                    w_sql, w_params = unpack_stmt(stmt)
                    self.conn.execute(w_sql, w_params)
                cur = self.conn.execute(sql, tuple(params))
                cols = [d[0] for d in cur.description or []]
                rows = cur.fetchall()
                return cols, rows
            finally:
                # a constraint abort may have auto-rolled-back already;
                # a second ROLLBACK would mask the real error
                if self.conn.in_transaction:
                    self.conn.execute("ROLLBACK")

    def execute(self, sql: str, params: Sequence = ()):
        """Run one write statement in its own transaction."""
        with self.write_tx() as conn:
            return conn.execute(sql, params)

    # ------------------------------------------------------------------
    # change collection (the SELECT side of crsql_changes)
    # ------------------------------------------------------------------

    def collect_changes(
        self,
        db_version_range: Tuple[int, int],
        site_id: Optional[bytes] = None,
    ) -> List[Change]:
        """All cell changes stamped with a db_version in the inclusive
        range, for one origin site (default: local)."""
        with self._lock:
            # barrier: collection reads the clock tables, which lag the
            # merge while the write-behind queue is non-empty
            self._wb_drain_locked()
            ordinal = 1 if site_id is None else self.site_ordinal(site_id)
            origin = self.site_id if site_id is None else site_id
            return self._collect_changes_on(
                self.conn, ordinal, origin, db_version_range
            )

    def site_ordinal_ro(self, conn, site_id: bytes) -> Optional[int]:
        """Read-only ordinal lookup on an explicit connection (no
        interning, no storage lock); None if the site was never seen."""
        row = conn.execute(
            "SELECT ordinal FROM __corro_sites WHERE site_id = ?",
            (site_id,),
        ).fetchone()
        return row[0] if row else None

    def collect_changes_ro(
        self,
        conn,
        db_version_range: Tuple[int, int],
        site_id: Optional[bytes] = None,
    ) -> List[Change]:
        """:meth:`collect_changes` on an explicit (read-only pool)
        connection, WITHOUT taking the storage lock — the sync serve
        path's off-loop range collection.  The site must already be
        interned (it is for any site we hold versions of); an unknown
        site collects nothing."""
        # write-behind barrier (docs/crdts.md ordering contract): any
        # version announced to a peer was journaled + enqueued inside
        # its apply commit, so draining here guarantees the serve read
        # never observes an unflushed winner for a requested version
        self.flush_barrier()
        if site_id is None:
            ordinal: Optional[int] = 1
            origin = self.site_id
        else:
            ordinal = self.site_ordinal_ro(conn, site_id)
            origin = site_id
        if ordinal is None:
            return []
        return self._collect_changes_on(
            conn, ordinal, origin, db_version_range
        )

    def _collect_changes_on(
        self, conn, ordinal: int, origin: bytes,
        db_version_range: Tuple[int, int],
    ) -> List[Change]:
        """Shared body: one sentinel + one cell query per table over the
        whole inclusive db_version range, sorted (db_version, seq)."""
        self._io_delay("read")
        lo, hi = db_version_range
        out: List[Change] = []
        for t, info in self._tables.items():
            # row-level '-1' sentinel changes: exactly the cl entries
            # flagged sentinel (deletes, resurrects, pk moves, pk-only
            # inserts) — plain inserts of cell-bearing tables ride
            # their cell rows alone, matching cr-sqlite's change
            # streams (pinned in tests/test_crsqlite_golden.py).
            for pk, cl, dbv, seq in conn.execute(
                f'SELECT pk, cl, db_version, seq FROM "{t}__corro_cl" '
                "WHERE site_ordinal=? AND db_version BETWEEN ? AND ? "
                "AND sentinel = 1",
                (ordinal, lo, hi),
            ):
                out.append(
                    Change(
                        table=t,
                        pk=bytes(pk),
                        cid=SENTINEL_CID,
                        val=None,
                        col_version=cl,
                        db_version=CrsqlDbVersion(dbv),
                        seq=CrsqlSeq(seq),
                        site_id=origin,
                        cl=cl,
                    )
                )
            if not info.data_cols:
                continue  # no cells to collect
            # cell-level rows with current values, one JOIN per table:
            # cl from the causal-length table, the live value picked out
            # of the data row by a generated CASE over the column name
            val_case = (
                "CASE k.cid "
                + " ".join(f"WHEN '{c}' THEN d.\"{c}\"" for c in info.data_cols)
                + " END"
            )
            d_pk = "corro_pack(" + ", ".join(f'd."{p}"' for p in info.pk_cols) + ")"
            for pk, cid, colv, dbv, seq, cl, val in conn.execute(
                f"SELECT k.pk, k.cid, k.col_version, k.db_version, k.seq,"
                f" COALESCE(c.cl, 1), {val_case} "
                f'FROM "{t}__corro_clock" k '
                f'LEFT JOIN "{t}__corro_cl" c ON c.pk = k.pk '
                f'LEFT JOIN "{t}" d ON {d_pk} = k.pk '
                "WHERE k.site_ordinal=? AND k.db_version BETWEEN ? AND ?",
                (ordinal, lo, hi),
            ):
                out.append(
                    Change(
                        table=t,
                        pk=bytes(pk),
                        cid=cid,
                        val=val,
                        col_version=colv,
                        db_version=CrsqlDbVersion(dbv),
                        seq=CrsqlSeq(seq),
                        site_id=origin,
                        cl=cl,
                    )
                )
        out.sort(key=lambda ch: (int(ch.db_version), int(ch.seq)))
        return out

    def changes_for_version(self, db_version: int, site_id: Optional[bytes] = None):
        return self.collect_changes((db_version, db_version), site_id)

    def _row_cl(self, table: str, pk: bytes) -> int:
        row = self._row_cl_entry(table, pk)
        return row[0] if row else 1

    def _cell_value(self, info: TableInfo, pk: bytes, cid: str):
        pk_vals = unpack_values(pk)
        where = " AND ".join(f'"{p}" IS ?' for p in info.pk_cols)
        row = self.conn.execute(
            f'SELECT "{_ident(cid)}" FROM "{info.name}" WHERE {where}', pk_vals
        ).fetchone()
        return row[0] if row else None

    # ------------------------------------------------------------------
    # change application (the INSERT side of crsql_changes: the merge)
    # ------------------------------------------------------------------

    @contextmanager
    def apply_tx(self):
        """Open one merge transaction; bookkeeping writes through the same
        connection commit atomically with the applied changes.  Applies
        take the NORMAL write tier — the reference runs
        ``process_multiple_changes`` on ``write_normal()``
        (``agent/util.rs:814``), below client API writes
        (``write_priority()``) and above maintenance (``write_low()``),
        so local writers stay responsive while replication streams in."""
        from corrosion_tpu_torch.agent.locks import PRIO_NORMAL

        with self._lock.prio(PRIO_NORMAL, "apply", kind="apply"):
            self._io_delay("write")
            self.conn.execute("BEGIN IMMEDIATE")
            try:
                self._set_state("apply_mode", 1)
                yield self.conn
            except BaseException:
                try:
                    self._set_state("apply_mode", 0)
                finally:
                    # see write_tx: the tx may have auto-rolled-back
                    if self.conn.in_transaction:
                        self.conn.execute("ROLLBACK")
                    self._tx_finish(False)
                raise
            self._set_state("apply_mode", 0)
            self.conn.execute("COMMIT")
            self._tx_finish(True)

    def apply_changes_in_tx(self, changes: Iterable[Change]) -> int:
        """Merge changes inside an open ``apply_tx``; returns rows impacted.

        Dispatches to the batched pipeline beyond a couple of changes —
        semantics are pinned identical to the per-change path by the
        randomized parity suite (tests/test_apply_batched.py)."""
        changes = list(changes)
        if len(changes) <= 2:
            return self._apply_small_in_tx(changes)
        return self._apply_changes_batched(changes)

    def _apply_small_in_tx(self, changes: List[Change]) -> int:
        """Per-change path with device-cache hygiene: ``_apply_one``
        reads and writes the clock tables directly, so staged state for
        the touched rows must flush first and the cache must forget
        them afterwards (their DB state changed behind its back)."""
        if self.device_cache is not None and changes:
            touched: Dict[str, List[bytes]] = {}
            for ch in changes:
                touched.setdefault(ch.table, []).append(ch.pk)
            for t, t_pks in touched.items():
                self._wb_overlap_flush_in_tx(t, t_pks)
            n = sum(self._apply_one(ch) for ch in changes)
            for t, t_pks in touched.items():
                self.device_cache.invalidate_pks(
                    t, t_pks, reason="small_apply"
                )
            return n
        return sum(self._apply_one(ch) for ch in changes)

    def apply_changes_sequential_in_tx(self, changes: Iterable[Change]) -> int:
        """The per-change reference path (one row-CL lookup + cell write +
        clock upsert per change).  Kept as the parity oracle for the
        batched pipeline and the ``bench.py --apply`` baseline."""
        changes = list(changes)
        if self.device_cache is not None:
            return self._apply_small_in_tx(changes)
        return sum(self._apply_one(ch) for ch in changes)

    def apply_changes(self, changes: Iterable[Change]) -> int:
        """Merge remote changes in their own transaction."""
        with self.apply_tx():
            return self.apply_changes_in_tx(changes)

    def apply_changes_batched(self, changes: Iterable[Change]) -> int:
        """Merge remote changes in their own transaction, always through
        the batched pipeline (no small-batch dispatch)."""
        with self.apply_tx():
            return self._apply_changes_batched(list(changes))

    def _apply_one(self, ch: Change) -> int:
        info = self._tables.get(ch.table)
        if info is None:
            return 0
        t = info.name
        ordinal = self.site_ordinal(ch.site_id)
        local_cl = self._row_cl_entry(t, ch.pk)

        if ch.cid == SENTINEL_CID:
            # row-level: delete (even cl) or bare resurrect marker
            if local_cl is not None and ch.cl <= local_cl[0]:
                return 0
            self._set_row_cl(
                t, ch.pk, ch.cl, ch.db_version, ch.seq, ordinal, sentinel=1
            )
            if ch.is_delete():
                self._delete_row(info, ch.pk)
                self.conn.execute(
                    f'DELETE FROM "{t}__corro_clock" WHERE pk=?', (ch.pk,)
                )
            else:
                # a new row generation: previous-generation cells are gone
                self._reset_row(info, ch.pk)
                self.conn.execute(
                    f'DELETE FROM "{t}__corro_clock" WHERE pk=?', (ch.pk,)
                )
            return 1

        # cell-level change
        have_cl = local_cl[0] if local_cl is not None else None
        if have_cl is not None and ch.cl < have_cl:
            return 0  # stale: our row history is causally ahead
        if have_cl is None or ch.cl > have_cl:
            # the change's row generation is ahead of ours: adopt it, and
            # reset the row so previous-generation cell values (now
            # untracked) can't linger in the data table
            self._set_row_cl(t, ch.pk, ch.cl, ch.db_version, ch.seq, ordinal)
            if ch.cl % 2 == 0:
                self._delete_row(info, ch.pk)
                self.conn.execute(
                    f'DELETE FROM "{t}__corro_clock" WHERE pk=?', (ch.pk,)
                )
                return 1
            self._reset_row(info, ch.pk)
            self.conn.execute(
                f'DELETE FROM "{t}__corro_clock" WHERE pk=?', (ch.pk,)
            )
        elif ch.cl % 2 == 0:
            return 0  # equal even cl: row already deleted
        else:
            self._ensure_row(info, ch.pk)

        # LWW on the cell
        row = self.conn.execute(
            f'SELECT col_version FROM "{t}__corro_clock" WHERE pk=? AND cid=?',
            (ch.pk, ch.cid),
        ).fetchone()
        if row is not None:
            local_ver = row[0]
            if ch.col_version < local_ver:
                return 0
            if ch.col_version == local_ver:
                cur = self._cell_value(info, ch.pk, ch.cid)
                if value_cmp(ch.val, cur) <= 0:
                    return 0
        self._write_cell(info, ch.pk, ch.cid, ch.val)
        self.conn.execute(
            f'INSERT INTO "{t}__corro_clock" '
            "(pk, cid, col_version, db_version, seq, site_ordinal) "
            "VALUES (?, ?, ?, ?, ?, ?) "
            "ON CONFLICT(pk, cid) DO UPDATE SET "
            "col_version=excluded.col_version, db_version=excluded.db_version,"
            "seq=excluded.seq, site_ordinal=excluded.site_ordinal",
            (ch.pk, ch.cid, ch.col_version, int(ch.db_version), int(ch.seq), ordinal),
        )
        return 1

    # -- batched application --------------------------------------------
    #
    # The ingest hot path: same merge as _apply_one, restructured around
    # batches — group per table, intern sites in first-appearance order,
    # prefetch row-CL / clock / current cell values with one IN (...)
    # query per table per kind, merge in memory (superseded cells
    # coalesce to the causally-winning write), then flush the net state
    # with executemany on per-(table, cid) cached SQL strings.  Final DB
    # state (data, clock, cl, impact records, site ordinals) is
    # identical to applying the same stream through _apply_one — pinned
    # by tests/test_apply_batched.py.
    #
    # Contract: change values are AFFINITY-STABLE for their columns —
    # the invariant every collect_changes-produced stream holds, since
    # an origin ships the value it already stored (post-affinity).  A
    # hostile stream writing e.g. an INTEGER into a TEXT column can make
    # this path diverge from _apply_one only on exact-value LWW ties,
    # where _apply_one compares against sqlite's affinity-converted
    # read-back while the in-batch winner here is the raw wire value.

    _PREFETCH_CHUNK = 500  # bound parameters per IN (...) query

    def _apply_sql(self, key: Tuple) -> str:
        """Cached SQL text for the batched flush statements; identical
        strings also let sqlite3's per-connection statement cache reuse
        prepared statements across batches."""
        cache = getattr(self, "_apply_sql_cache", None)
        if cache is None:
            cache = self._apply_sql_cache = {}
        sql = cache.get(key)
        if sql is None:
            kind, t = key[0], key[1]
            info = self._tables[t]
            pk_where = " AND ".join(f'"{p}" IS ?' for p in info.pk_cols)
            if kind == "cell_upd":
                sets = ", ".join(f'"{_ident(c)}" = ?' for c in key[2])
                sql = f'UPDATE "{t}" SET {sets} WHERE {pk_where}'
            elif kind == "row_del":
                sql = f'DELETE FROM "{t}" WHERE {pk_where}'
            elif kind == "row_ins":
                cols = ", ".join(f'"{p}"' for p in info.pk_cols)
                ph = ", ".join("?" for _ in info.pk_cols)
                sql = f'INSERT OR IGNORE INTO "{t}" ({cols}) VALUES ({ph})'
            elif kind == "row_ins_fused":
                names = list(info.pk_cols) + [_ident(c) for c in key[2]]
                cols = ", ".join(f'"{c}"' for c in names)
                ph = ", ".join("?" for _ in names)
                sql = f'INSERT OR IGNORE INTO "{t}" ({cols}) VALUES ({ph})'
            elif kind == "clock_ins":
                # plain INSERT: the caller proved no conflicting row can
                # exist (generation replaced, or absent in the prefetch);
                # a violated invariant fails loud instead of diverging
                sql = (
                    f'INSERT INTO "{t}__corro_clock" '
                    "(pk, cid, col_version, db_version, seq, site_ordinal) "
                    "VALUES (?, ?, ?, ?, ?, ?)"
                )
            elif kind == "clock_del":
                sql = f'DELETE FROM "{t}__corro_clock" WHERE pk=?'
            elif kind == "clock_ups":
                sql = (
                    f'INSERT INTO "{t}__corro_clock" '
                    "(pk, cid, col_version, db_version, seq, site_ordinal) "
                    "VALUES (?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(pk, cid) DO UPDATE SET "
                    "col_version=excluded.col_version, "
                    "db_version=excluded.db_version,"
                    "seq=excluded.seq, site_ordinal=excluded.site_ordinal"
                )
            elif kind == "cl_ins":
                # plain INSERT: no cl entry existed for this pk at batch
                # start (prefetch-proved), so no conflict is possible
                sql = (
                    f'INSERT INTO "{t}__corro_cl" '
                    "(pk, cl, db_version, seq, site_ordinal, sentinel) "
                    "VALUES (?, ?, ?, ?, ?, ?)"
                )
            elif kind == "cl_ups":
                sql = (
                    f'INSERT INTO "{t}__corro_cl" '
                    "(pk, cl, db_version, seq, site_ordinal, sentinel) "
                    "VALUES (?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(pk) DO UPDATE SET cl=excluded.cl, "
                    "db_version=excluded.db_version, seq=excluded.seq, "
                    "site_ordinal=excluded.site_ordinal, "
                    "sentinel=MAX(sentinel, excluded.sentinel)"
                )
            else:  # pragma: no cover - programming error
                raise KeyError(kind)
            cache[key] = sql
        return sql

    #: rows per multi-row VALUES statement are sized to stay under
    #: sqlite's default 999 bound-parameter limit
    _MULTIROW_PARAMS = 900

    def _flush_insert(self, key: Tuple, rows: List[Sequence]) -> None:
        """Flush one INSERT-shaped statement kind with multi-row
        ``VALUES (...), (...)`` batching (~30% fewer statement-dispatch
        cycles than per-row executemany at 10k rows; multi-row upserts
        apply per row exactly like their single-row form).  Non-insert
        shapes and small flushes fall through to plain executemany on
        the cached single-row SQL."""
        if not rows:
            return
        sql = self._apply_sql(key)
        cache = getattr(self, "_apply_sql_cache", None)
        i = 0
        head = sql.find(" VALUES (")
        if head >= 0 and len(rows) > 1:
            row_ph = sql[head + 8 : sql.index(")", head) + 1]
            width = row_ph.count("?")
            k = max(1, self._MULTIROW_PARAMS // max(1, width))
            if k > 1 and len(rows) >= k:
                msql = cache.get((key, k))
                if msql is None:
                    msql = cache[(key, k)] = (
                        sql[: head + 8]
                        + ",".join([row_ph] * k)
                        + sql[head + 8 + len(row_ph):]
                    )
                while i + k <= len(rows):
                    self.conn.execute(
                        msql,
                        [x for r in rows[i : i + k] for x in r],
                    )
                    i += k
        if i < len(rows):
            self.conn.executemany(sql, rows[i:])

    def _apply_changes_batched(self, changes: List[Change]) -> int:
        by_table: Dict[str, List[Change]] = {}
        ordinals: Dict[bytes, int] = {}
        for ch in changes:
            if ch.table not in self._tables:
                continue
            by_table.setdefault(ch.table, []).append(ch)
            # intern in first-appearance order: ordinal assignment must
            # match the per-change path byte for byte
            if ch.site_id not in ordinals:
                ordinals[ch.site_id] = self.site_ordinal(ch.site_id)
        impacted = 0
        apply_table = (
            self._apply_table_device if self.device_cache is not None
            else self._apply_table_batched
        )
        for t, t_changes in by_table.items():
            impacted += apply_table(
                self._tables[t], t_changes, ordinals
            )
        return impacted

    def _prefetch_sql(self, sql_head: str, n: int) -> str:
        """Cached full SQL text for one ``IN (...)`` prefetch chunk —
        per (head, chunk-size), like the flush path's per-(table,
        column-set) cached statements.  Chunk sizes are bucketed to
        powers of two (callers pad by repeating a key; ``IN`` is a set,
        duplicates are free) so each head caches O(log CHUNK) strings
        and sqlite3's per-connection statement cache gets identical
        text across batches."""
        cache = getattr(self, "_prefetch_sql_cache", None)
        if cache is None:
            cache = self._prefetch_sql_cache = {}
        sql = cache.get((sql_head, n))
        if sql is None:
            sql = cache[(sql_head, n)] = (
                sql_head + ",".join("?" * n) + ")"
            )
        return sql

    def _prefetch_rows(self, sql_head: str, keys: List[bytes]) -> list:
        """Run ``sql_head`` (ending in ``IN (``) over ``keys`` in bound-
        parameter-sized chunks; returns all rows."""
        out: list = []
        for i in range(0, len(keys), self._PREFETCH_CHUNK):
            chunk = keys[i : i + self._PREFETCH_CHUNK]
            n = 1
            while n < len(chunk):
                n <<= 1
            if n > len(chunk):  # pad to the bucket: IN is a set
                chunk = chunk + [chunk[-1]] * (n - len(chunk))
            out.extend(
                self.conn.execute(
                    self._prefetch_sql(sql_head, n), chunk
                ).fetchall()
            )
        return out

    @staticmethod
    def _batch_pks_cids(
        t_changes: List[Change],
    ) -> Tuple[List[bytes], set]:
        pks: List[bytes] = []
        seen_pk = set()
        ref_cids = set()
        for ch in t_changes:
            if ch.pk not in seen_pk:
                seen_pk.add(ch.pk)
                pks.append(ch.pk)
            if ch.cid != SENTINEL_CID:
                ref_cids.add(ch.cid)
        return pks, ref_cids

    def _prefetch_table_view(
        self, info: TableInfo, pks: List[bytes], ref_cids,
    ) -> Tuple[Dict[bytes, int], Dict[Tuple[bytes, str], int],
               Dict[bytes, dict]]:
        """One IN (...) prefetch per kind: row causal lengths, cell
        clock versions, and current cell values (the LWW tie-break
        operand).  With an empty ``ref_cids`` the value query selects
        only the packed pk — a pure row-existence view, which is all
        the write-behind flush needs."""
        t = info.name
        cl_by_pk: Dict[bytes, int] = {}
        for pk, cl in self._prefetch_rows(
            f'SELECT pk, cl FROM "{t}__corro_cl" WHERE pk IN (', pks
        ):
            cl_by_pk[bytes(pk)] = cl
        clock_by_cell: Dict[Tuple[bytes, str], int] = {}
        for pk, cid, colv in self._prefetch_rows(
            f'SELECT pk, cid, col_version FROM "{t}__corro_clock" '
            "WHERE pk IN (", pks
        ):
            clock_by_cell[(bytes(pk), cid)] = colv
        vals_by_pk: Dict[bytes, dict] = {}
        if info.data_cols:
            pk_expr = "corro_pack(" + ", ".join(
                f'"{p}"' for p in info.pk_cols
            ) + ")"
            # only columns the batch actually references are selected —
            # wide tables stop paying for untouched columns; the
            # pk-only row (still selected) keeps the row-existence view
            sel_cols = tuple(
                c for c in info.data_cols if c in ref_cids
            )
            sel = "".join(f', "{c}"' for c in sel_cols)
            for row in self._prefetch_rows(
                f'SELECT {pk_expr}{sel} FROM "{t}" WHERE {pk_expr} IN (',
                pks,
            ):
                vals_by_pk[bytes(row[0])] = dict(
                    zip(sel_cols, row[1:])
                )
        return cl_by_pk, clock_by_cell, vals_by_pk

    def _merge_table(
        self, info: TableInfo, t_changes: List[Change],
        ordinals: Dict[bytes, int],
        cl_by_pk: Dict[bytes, int],
        clock_by_cell: Optional[Dict[Tuple[bytes, str], int]],
        vals_by_pk,
        seed_cols: Optional[tuple] = None,
    ) -> Tuple[Dict[bytes, list], int]:
        """In-memory merge: the columnar kernel (ops/merge.py segment
        reductions) past the batch-size threshold, the per-change dict
        replay below it — and as the fallback when a hostile batch
        cannot encode.  Identical net state either way, pinned by the
        three-way parity suite (tests/test_apply_batched.py).  The
        merge timing lands in ``corro_apply_merge_seconds{kernel=}`` on
        EVERY path — including the encode-impossible fallback, which
        additionally counts ``corro_apply_columnar_fallbacks_total`` so
        the A/B series stays complete under hostile batches."""
        import time as _time

        t0 = _time.perf_counter()
        kernel = "dict"
        merged = None
        # the kernel's flat winner arrays, for the device cache's
        # vectorized commit promote (consumed by _apply_table_device)
        self._columnar_plan = None
        if (
            self.columnar_merge
            and len(t_changes) >= self.columnar_merge_min
        ):
            merged = self._merge_table_columnar(
                info, t_changes, ordinals, cl_by_pk, clock_by_cell,
                vals_by_pk, seed_cols=seed_cols,
            )
            if merged is not None:
                kernel = "columnar"
            elif self.metrics is not None:
                self.metrics.counter(
                    "corro_apply_columnar_fallbacks_total",
                    table=info.name,
                )
        if merged is None:
            if clock_by_cell is None:
                # device fast path handed us encoder-parallel seed
                # columns and a presence *set*; the dict oracle needs
                # the classic dict views — materialize them here, on
                # the rare fallback only.
                clock_by_cell = {}
                vals_dict: Dict[bytes, dict] = {
                    pk: {} for pk in vals_by_pk
                }
                if seed_cols is not None:
                    for pk, cid, ver, val in zip(*seed_cols):
                        clock_by_cell[(pk, cid)] = ver
                        vd = vals_dict.get(pk)
                        if vd is not None:
                            vd[cid] = val
                vals_by_pk = vals_dict
            merged = self._merge_table_dict(
                t_changes, ordinals, cl_by_pk, clock_by_cell, vals_by_pk
            )
        if self.metrics is not None:
            self.metrics.histogram(
                "corro_apply_merge_seconds",
                _time.perf_counter() - t0, kernel=kernel,
            )
        return merged

    def _apply_table_batched(
        self, info: TableInfo, t_changes: List[Change],
        ordinals: Dict[bytes, int],
    ) -> int:
        pks, ref_cids = self._batch_pks_cids(t_changes)
        cl_by_pk, clock_by_cell, vals_by_pk = self._prefetch_table_view(
            info, pks, ref_cids
        )
        states, impacted = self._merge_table(
            info, t_changes, ordinals, cl_by_pk, clock_by_cell,
            vals_by_pk,
        )
        self._flush_table_states(
            info, states, cl_by_pk, clock_by_cell, vals_by_pk
        )
        return impacted

    def _apply_table_device(
        self, info: TableInfo, t_changes: List[Change],
        ordinals: Dict[bytes, int],
    ) -> int:
        """Device-resident apply: seed the merge from the cross-batch
        clock cache instead of SQLite prefetches, stage the net result
        back into the cache's transaction shadow, and defer the SQL
        flush to the write-behind queue (journaled in this transaction,
        drained on the apply pool).  Cache misses fall back to the
        prefetch path for exactly the missed pks and install the
        fetched seeds."""
        dc = self.device_cache
        t = info.name
        pks, ref_cids = self._batch_pks_cids(t_changes)
        if not ref_cids <= set(info.data_cols):
            # junk cid outside the schema: uncacheable batch — flush
            # any staged state for these rows, then run the classic
            # prefetch path against consistent SQLite
            self._wb_overlap_flush_in_tx(t, pks)
            return self._apply_table_batched(info, t_changes, ordinals)
        # hot path: the seed view comes back in the columnar encoder's
        # native parallel-sequence form (plus a row-presence set) and
        # the per-cell dicts are never built; a live same-tx overlay
        # returns None and takes the dict route below
        seed_cols = None
        fast = dc.lookup_seed(info, pks, ref_cids)
        if fast is not None:
            miss, cl_by_pk, seed_cols, vals_by_pk = fast
            clock_by_cell = None
        else:
            miss, cl_by_pk, clock_by_cell, vals_by_pk = dc.lookup(
                info, pks, ref_cids
            )
        if miss:
            # a missed pk may carry unflushed staged state (rare:
            # value-unknown re-miss) — SQLite must be consistent for
            # those rows before the prefetch reads it
            self._wb_overlap_flush_in_tx(t, miss)
            p_cl, p_clock, p_vals = self._prefetch_table_view(
                info, miss, ref_cids
            )
            dc.install(info, miss, p_cl, p_clock, p_vals, ref_cids)
            # hit pks keep the cache view (it includes staged state the
            # DB may not have yet); miss pks come from the prefetch
            p_cl.update(cl_by_pk)
            cl_by_pk = p_cl
            if seed_cols is not None:
                s_pks, s_cids, s_vers, s_vals = seed_cols
                for (pk, cid), ver in p_clock.items():
                    s_pks.append(pk)
                    s_cids.append(cid)
                    s_vers.append(ver)
                    s_vals.append(p_vals.get(pk, {}).get(cid))
                vals_by_pk.update(p_vals)
            else:
                p_clock.update(clock_by_cell)
                clock_by_cell = p_clock
                p_vals.update(vals_by_pk)
                vals_by_pk = p_vals
        states, impacted = self._merge_table(
            info, t_changes, ordinals, cl_by_pk, clock_by_cell,
            vals_by_pk, seed_cols=seed_cols,
        )
        dc.stage_states(info, states, cl_by_pk, vals_by_pk,
                        columnar=self._columnar_plan)
        self._columnar_plan = None
        cur = self.conn.execute(
            "INSERT INTO __corro_flush_journal (tbl, payload) "
            "VALUES (?, ?)",
            (t, _wb_encode_states(states)),
        )
        self._wb.tx_staged.append((t, states, cur.lastrowid))
        self._wb.unflushed.setdefault(t, set()).update(states)
        return impacted

    def _merge_table_dict(
        self, t_changes: List[Change], ordinals: Dict[bytes, int],
        cl_by_pk: Dict[bytes, int],
        clock_by_cell: Dict[Tuple[bytes, str], int],
        vals_by_pk: Dict[bytes, dict],
    ) -> Tuple[Dict[bytes, list], int]:
        """The per-change decision replay against dict state —
        superseded same-(pk, cid) writes coalesce to the causal winner
        before any SQL runs.  Kept verbatim as the columnar kernel's
        parity oracle and the small-batch path."""
        CL, CLROW, GEN, ALIVE, ENSURE, CELLS, DBOK = range(7)
        states: Dict[bytes, list] = {}
        impacted = 0
        sentinel_cid = SENTINEL_CID
        cl_get = cl_by_pk.get
        clock_get = clock_by_cell.get
        for ch in t_changes:
            pk = ch.pk
            st = states.get(pk)
            if st is None:
                st = states[pk] = [
                    cl_get(pk), None, False, None, False, {}, True,
                ]
            cl = ch.cl

            if ch.cid == sentinel_cid:
                if st[CL] is not None and cl <= st[CL]:
                    continue
                # sentinel flag only ever upgrades; 1 is its maximum
                st[CLROW] = (pk, cl, int(ch.db_version), int(ch.seq),
                             ordinals[ch.site_id], 1)
                st[CL] = cl
                st[GEN], st[ALIVE], st[DBOK] = True, cl % 2 == 1, False
                st[CELLS] = {}
                impacted += 1
                continue

            have_cl = st[CL]
            if have_cl is not None and cl < have_cl:
                continue
            if have_cl is None or cl > have_cl:
                prev = st[CLROW]
                st[CLROW] = (pk, cl, int(ch.db_version), int(ch.seq),
                             ordinals[ch.site_id],
                             prev[5] if prev else 0)
                st[CL] = cl
                st[GEN], st[ALIVE], st[DBOK] = True, cl % 2 == 1, False
                st[CELLS] = {}
                if cl % 2 == 0:
                    impacted += 1
                    continue
            elif cl % 2 == 0:
                continue
            else:
                st[ENSURE] = True

            # LWW: in-batch winner first, else the (still valid) DB view
            cells = st[CELLS]
            cur = cells.get(ch.cid)
            if cur is not None:
                local_ver, cur_val = cur[1], cur[0]
            elif st[DBOK]:
                local_ver = clock_get((pk, ch.cid))
                cur_val = None
                if local_ver is not None:
                    row_vals = vals_by_pk.get(pk)
                    if row_vals is not None:
                        cur_val = row_vals.get(ch.cid)
            else:
                local_ver = None
            if local_ver is not None:
                if ch.col_version < local_ver:
                    continue
                if ch.col_version == local_ver and \
                        value_cmp(ch.val, cur_val) <= 0:
                    continue
            cells[ch.cid] = (
                ch.val, ch.col_version, int(ch.db_version), int(ch.seq),
                ordinals[ch.site_id],
            )
            impacted += 1
        return states, impacted

    def _merge_table_columnar(
        self, info: TableInfo, t_changes: List[Change],
        ordinals: Dict[bytes, int],
        cl_by_pk: Dict[bytes, int],
        clock_by_cell: Optional[Dict[Tuple[bytes, str], int]],
        vals_by_pk,
        seed_cols: Optional[tuple] = None,
    ) -> Optional[Tuple[Dict[bytes, list], int]]:
        """Columnar winner selection (docs/crdts.md "Columnar merge
        kernel"): encode the batch + the prefetched DB view to flat
        arrays, resolve causal/LWW winners through
        :func:`corrosion_tpu_torch.ops.merge.select_winners`, and decode the
        decision back into the same net ``states`` structure the flush
        consumes.  Returns ``None`` (fall back to the dict oracle) when
        the batch cannot encode — out-of-range hostile fields, unknown
        value types.  ``seed_cols`` — the device cache's native
        encoder-parallel seed columns — skips the dict flatten
        entirely; when absent the classic prefetch dicts are flattened
        here."""
        try:
            from corrosion_tpu_torch.ops import merge as mergeops
        except Exception:  # pragma: no cover - no-numpy deployments
            return None

        if seed_cols is not None:
            if not seed_cols[0]:
                seed_cols = None
        elif clock_by_cell:
            s_pks, s_cids = zip(*clock_by_cell)
            s_vers = list(clock_by_cell.values())
            _empty: dict = {}
            vals_get = vals_by_pk.get
            s_vals = [
                vals_get(pk, _empty).get(cid)
                for pk, cid in clock_by_cell
            ]
            seed_cols = (s_pks, s_cids, s_vers, s_vals)
        plan = mergeops.encode_change_batch(
            t_changes, SENTINEL_CID, cl_by_pk, seed_cols
        )
        if plan is None:
            return None
        dec = mergeops.select_winners(plan, device=self.device)

        states: Dict[bytes, list] = {}
        n_cid = plan.n_cid
        cid_values = plan.cid_values
        # tolist()/C-level maps: the decode loop reads every entry once
        # — plain Python ints and pre-extracted column lists beat
        # per-element numpy boxing and per-winner attribute chains
        gen_l = dec.gen.tolist()
        final_l = dec.final_cl.tolist()
        alive_l = dec.alive.tolist()
        ensure_l = dec.ensure.tolist()
        sentf_l = dec.sent_flag.tolist()
        clrow_l = dec.clrow_idx.tolist()
        win_l = dec.winner_idx.tolist()
        ag = operator.attrgetter
        val_l = plan.vals
        ver_l = plan.vers
        dbv_l = list(map(int, map(ag("db_version"), t_changes)))
        seq_l = list(map(int, map(ag("seq"), t_changes)))
        ord_l = list(map(
            ordinals.__getitem__, map(ag("site_id"), t_changes)
        ))
        # one C-level zip builds every winner cell tuple up front —
        # the decode loop then only indexes, never constructs
        cell_t = list(zip(val_l, ver_l, dbv_l, seq_l, ord_l))
        for p, pk in enumerate(plan.pk_values):
            gen = gen_l[p]
            final_cl = final_l[p]
            clrow = None
            ci = clrow_l[p]
            if ci >= 0:
                clrow = (
                    pk, final_cl, dbv_l[ci], seq_l[ci], ord_l[ci],
                    1 if sentf_l[p] else 0,
                )
            cells: Dict[str, tuple] = {}
            base = p * n_cid
            for c in range(n_cid):
                w = win_l[base + c]
                if w >= 0:
                    cells[cid_values[c]] = cell_t[w]
            states[pk] = [
                final_cl if (gen or pk in cl_by_pk) else None,
                clrow, gen,
                alive_l[p] if gen else None,
                ensure_l[p], cells, not gen,
            ]
        self._columnar_plan = (plan, dec)
        return states, int(dec.impacted)

    def _flush_table_states(
        self, info: TableInfo, states: Dict[bytes, list],
        cl_by_pk: Dict[bytes, int],
        clock_by_cell: Dict[Tuple[bytes, str], int],
        vals_by_pk: Dict[bytes, dict],
    ) -> None:
        """Flush the net merged state, each statement kind one
        executemany on a cached SQL string: cl upserts; row + clock
        deletes for changed generations; then rows/cells — fresh rows
        take a FUSED insert carrying their cell values when the schema
        allows (otherwise the conservative pk-only insert + grouped
        per-row UPDATE, bug-for-bug with the per-change path); clock
        rows split into pure inserts (no existing row possible) vs
        upserts."""
        t = info.name
        CL, CLROW, GEN, ALIVE, ENSURE, CELLS, DBOK = range(7)
        cl_ins = [
            st[CLROW] for pk, st in states.items()
            if st[CLROW] and pk not in cl_by_pk
        ]
        cl_ups = [
            st[CLROW] for pk, st in states.items()
            if st[CLROW] and pk in cl_by_pk
        ]
        self._flush_insert(("cl_ins", t), cl_ins)
        self._flush_insert(("cl_ups", t), cl_ups)
        # generation deletes: skipped for rows that provably have
        # nothing to delete (fresh pks), which is the whole of a cold
        # backfill — the per-change path issues those no-op DELETEs
        clock_pks = {pk for pk, _cid in clock_by_cell}
        know_rows = bool(info.data_cols)  # pk-only tables: no row view
        gen_pks = [pk for pk, st in states.items() if st[GEN]]
        row_dels = [
            unpack_values(pk) for pk in gen_pks
            if not know_rows or pk in vals_by_pk
        ]
        if row_dels:
            self.conn.executemany(self._apply_sql(("row_del", t)), row_dels)
        clock_dels = [(pk,) for pk in gen_pks if pk in clock_pks]
        if clock_dels:
            self.conn.executemany(
                self._apply_sql(("clock_del", t)), clock_dels
            )
        fused_ok = info.fused_insert_ok
        ins_plain: List[Sequence] = []
        ins_by_cids: Dict[tuple, List[list]] = {}
        upd_by_cids: Dict[tuple, List[list]] = {}
        clock_ins: List[tuple] = []
        clock_ups: List[tuple] = []
        for pk, st in states.items():
            cells = st[CELLS]
            gen = st[GEN]
            if cells:
                fresh_clock = not st[DBOK]  # generation replaced: clock
                # rows for this pk were just deleted, inserts can't
                # conflict; otherwise conflict iff the cell existed
                for cid, cell in cells.items():
                    row = (pk, cid, cell[1], cell[2], cell[3], cell[4])
                    if fresh_clock or (pk, cid) not in clock_by_cell:
                        clock_ins.append(row)
                    else:
                        clock_ups.append(row)
            needs_row = (gen and st[ALIVE]) or (not gen and st[ENSURE])
            if not needs_row:
                continue
            row_absent = gen or pk not in vals_by_pk
            if cells and fused_ok and row_absent:
                cids = tuple(cells)
                ins_by_cids.setdefault(cids, []).append(
                    list(unpack_values(pk)) + [cells[c][0] for c in cids]
                )
                continue
            if info.data_cols and not gen and pk in vals_by_pk:
                pass  # row already exists: the OR IGNORE would no-op
            else:
                ins_plain.append(unpack_values(pk))
            if cells:
                cids = tuple(cells)
                upd_by_cids.setdefault(cids, []).append(
                    [cells[c][0] for c in cids] + list(unpack_values(pk))
                )
        self._flush_insert(("row_ins", t), ins_plain)
        for cids, rows in ins_by_cids.items():
            self._flush_insert(("row_ins_fused", t, cids), rows)
        for cids, rows in upd_by_cids.items():
            self.conn.executemany(
                self._apply_sql(("cell_upd", t, cids)), rows
            )
        self._flush_insert(("clock_ins", t), clock_ins)
        self._flush_insert(("clock_ups", t), clock_ups)

    # ------------------------------------------------------------------
    # device-resident apply: cache wiring + write-behind flush
    # ------------------------------------------------------------------

    def enable_device_cache(self, slots: Optional[int] = None,
                            backend: str = "auto", device=None) -> None:
        """Switch batched applies to the device-resident path
        (docs/crdts.md "Device-resident apply").  Idempotent; the agent
        calls this from config wiring.  ``backend`` / ``device`` pick
        the cache's array store (``ops.devcache.make_store``)."""
        from corrosion_tpu_torch.ops.devcache import DEFAULT_SLOTS, \
            DeviceClockCache

        if self.device_cache is not None:
            return
        self.device = device
        self.device_cache = DeviceClockCache(
            slots=slots or DEFAULT_SLOTS, backend=backend, device=device
        )

    def flush_pending(self) -> None:
        """Drain the write-behind queue to SQLite.  The read-side
        BARRIER: any apply whose commit was observable before this call
        takes the lock has its winners durably in the clock tables when
        it returns (entries are journaled + enqueued inside the apply
        transaction itself).  Cheap no-op when nothing is pending."""
        wb = self._wb
        if not wb.pending and not wb.tx_staged:
            return
        from corrosion_tpu_torch.agent.locks import PRIO_HIGH

        with self._lock.prio(PRIO_HIGH, "flush-barrier", kind="apply"):
            self._wb_drain_locked()

    # the serve/snapshot/subscription read paths call it by this name
    flush_barrier = flush_pending

    def flush_should_drain(self) -> bool:
        """Scheduling hint for the apply pool: drain once enough
        batches (or cells) have accumulated to amortize the flush.
        Thresholds trade journal memory (each pending batch keeps its
        net states alive) against coalescing — crash safety is the
        journal's job either way, so these only bound RAM and the
        worst-case barrier latency for a serve-path read."""
        wb = self._wb
        return len(wb.pending) >= 64 or (
            len(wb.pending) > 0 and wb.cells_pending() >= 131072
        )

    def device_cache_invalidate(self, reason: str) -> None:
        """Whole-cache invalidation hook for out-of-band CRR rewrites
        (compaction floor advance, schema surgery).  Takes the storage
        lock; flushes first so no staged state is stranded."""
        if self.device_cache is None:
            return
        from corrosion_tpu_torch.agent.locks import PRIO_HIGH

        with self._lock.prio(PRIO_HIGH, "devcache-inval", kind="apply"):
            self._wb_drain_locked()
            self.device_cache.invalidate_all(reason)
            self._emit_cache_metrics()

    def _wb_drain_locked(self) -> None:
        """Drain with the storage lock held.  Outside a transaction the
        flush runs in its own BEGIN IMMEDIATE apply-mode transaction;
        inside one (reentrant barrier from an apply/collect path) it
        folds into the open transaction."""
        wb = self._wb
        if self.conn.in_transaction:
            self._wb_flush_all_in_tx()
            return
        if not wb.pending:
            return
        entries, wb.pending = wb.pending, []
        wb.recompute()
        self.conn.execute("BEGIN IMMEDIATE")
        try:
            self._set_state("apply_mode", 1)
            self._wb_flush_entries_in_tx(entries)
            self._set_state("apply_mode", 0)
        except BaseException:
            wb.pending = entries + wb.pending
            wb.recompute()
            if self.conn.in_transaction:
                self.conn.execute("ROLLBACK")
            raise
        self.conn.execute("COMMIT")
        self._emit_cache_metrics()

    def _wb_flush_all_in_tx(self) -> None:
        """Flush pending + current-transaction staged entries inside
        the OPEN transaction.  Pending entries move to ``draining`` so
        a rollback requeues them (their journal deletes roll back with
        the transaction); staged entries simply leave the ledger — on
        rollback their journal inserts and flushed rows vanish with the
        merge itself."""
        wb = self._wb
        entries = wb.pending + wb.tx_staged
        if not entries:
            return
        mode = self._state("apply_mode")
        if not mode:
            self._set_state("apply_mode", 1)
        try:
            self._wb_flush_entries_in_tx(entries)
        finally:
            if not mode:
                self._set_state("apply_mode", 0)
        wb.draining.extend(wb.pending)
        wb.pending = []
        wb.tx_staged = []
        wb.recompute()

    def _wb_overlap_flush_in_tx(self, table: str,
                                pks: Optional[List[bytes]] = None) -> None:
        """Order guard inside an open apply transaction: if any of
        ``pks`` (or any row of ``table`` when None) has unflushed
        staged state, flush everything so the imminent SQLite read sees
        a consistent view."""
        u = self._wb.unflushed.get(table)
        if not u:
            return
        if pks is not None and not any(pk in u for pk in pks):
            return
        self._wb_flush_all_in_tx()

    def _wb_flush_entries_in_tx(self, entries: List[tuple]) -> None:
        """The flush itself: coalesce per (table, pk), re-derive the
        presence views from SQLite (NOT the cache — the flush is the
        one consumer that must see the durable truth), run the ordered
        ``_flush_table_states`` executemany batches, and retire the
        journal rows in the same transaction."""
        by_table: Dict[str, Dict[bytes, list]] = {}
        for t, states, _jid in entries:
            d = by_table.setdefault(t, {})
            for pk, st in states.items():
                prev = d.get(pk)
                d[pk] = st if prev is None else _wb_coalesce(prev, st)
        for t, merged in by_table.items():
            info = self._tables.get(t)
            if info is None:
                continue  # table dropped since staging: nothing to do
            view = self._prefetch_table_view(info, list(merged), ())
            self._flush_table_states(info, merged, *view)
        self.conn.executemany(
            "DELETE FROM __corro_flush_journal WHERE id = ?",
            [(jid,) for _t, _s, jid in entries],
        )

    def _recover_flush_journal(self) -> None:
        """Boot classification of the crash window between a committed
        device-merge and its async flush: replay every surviving
        journal row (in id order, each in its own transaction deleting
        its row) through ``_flush_table_states`` against presence views
        re-derived from the database — exact by construction, because a
        flush transaction deletes its journal row atomically, so a
        surviving row's pre-state is exactly the merge-time view."""
        rows = self.conn.execute(
            "SELECT id, tbl, payload FROM __corro_flush_journal "
            "ORDER BY id"
        ).fetchall()
        for jid, tbl, payload in rows:
            self.conn.execute("BEGIN IMMEDIATE")
            try:
                self._set_state("apply_mode", 1)
                info = self._tables.get(tbl)
                if info is not None:
                    states = _wb_decode_states(bytes(payload))
                    view = self._prefetch_table_view(
                        info, list(states), ()
                    )
                    self._flush_table_states(info, states, *view)
                self.conn.execute(
                    "DELETE FROM __corro_flush_journal WHERE id = ?",
                    (jid,),
                )
                self._set_state("apply_mode", 0)
            except BaseException:
                self._set_state("apply_mode", 0)
                if self.conn.in_transaction:
                    self.conn.execute("ROLLBACK")
                raise
            self.conn.execute("COMMIT")
            self.flush_journal_recovered += 1

    def _tx_finish(self, committed: bool) -> None:
        """Transaction epilogue for the device-resident ledger: promote
        or discard the cache shadow, and move/requeue write-behind
        entries to match what the database actually did."""
        wb = self._wb
        dc = self.device_cache
        if dc is None and not (wb.draining or wb.tx_staged):
            return
        if committed:
            wb.draining = []
            wb.pending.extend(wb.tx_staged)
            wb.tx_staged = []
            if dc is not None:
                dc.commit_tx()
        else:
            wb.pending = wb.draining + wb.pending
            wb.draining = []
            wb.tx_staged = []
            if dc is not None:
                dc.abort_tx()
        wb.recompute()
        self._emit_cache_metrics()

    def _emit_cache_metrics(self) -> None:
        """Emit the cache's monotonic counters as metric deltas, plus
        the flush-queue depth gauge."""
        m = self.metrics
        dc = self.device_cache
        if m is None or dc is None:
            return
        snap = self._devcache_emitted
        for key, series in (
            ("hits", "corro_apply_cache_hits_total"),
            ("misses", "corro_apply_cache_misses_total"),
            ("evictions", "corro_apply_cache_evictions_total"),
        ):
            cur = dc.counters[key]
            d = cur - snap.get(key, 0.0)
            if d:
                m.counter(series, d)
                snap[key] = cur
        for reason, cur in dc.invalidations.items():
            d = cur - snap.get(("inv", reason), 0.0)
            if d:
                m.counter(
                    "corro_apply_cache_invalidations_total", d,
                    reason=reason,
                )
                snap[("inv", reason)] = cur
        m.gauge("corro_apply_flush_pending", float(len(self._wb.pending)))

    # -- row helpers ----------------------------------------------------

    def _row_cl_entry(self, table: str, pk: bytes):
        return self.conn.execute(
            f'SELECT cl FROM "{table}__corro_cl" WHERE pk=?', (pk,)
        ).fetchone()

    def _set_row_cl(self, table, pk, cl, db_version, seq, ordinal,
                    sentinel: int = 0) -> None:
        # sentinel only ever upgrades: a row once shipped as a '-1'
        # change keeps shipping its row-level state (cr-sqlite keeps the
        # sentinel clock row alive the same way)
        self.conn.execute(
            f'INSERT INTO "{table}__corro_cl" '
            "(pk, cl, db_version, seq, site_ordinal, sentinel) "
            "VALUES (?, ?, ?, ?, ?, ?) "
            "ON CONFLICT(pk) DO UPDATE SET cl=excluded.cl, "
            "db_version=excluded.db_version, seq=excluded.seq, "
            "site_ordinal=excluded.site_ordinal, "
            "sentinel=MAX(sentinel, excluded.sentinel)",
            (pk, cl, int(db_version), int(seq), ordinal, sentinel),
        )

    def _reset_row(self, info: TableInfo, pk: bytes) -> None:
        """Start a fresh row generation: drop any old values, re-create
        the row with column defaults (cr-sqlite resurrect semantics)."""
        self._delete_row(info, pk)
        self._ensure_row(info, pk)

    def _ensure_row(self, info: TableInfo, pk: bytes) -> None:
        pk_vals = unpack_values(pk)
        cols = ", ".join(f'"{p}"' for p in info.pk_cols)
        ph = ", ".join("?" for _ in info.pk_cols)
        self.conn.execute(
            f'INSERT OR IGNORE INTO "{info.name}" ({cols}) VALUES ({ph})',
            pk_vals,
        )

    def _delete_row(self, info: TableInfo, pk: bytes) -> None:
        pk_vals = unpack_values(pk)
        where = " AND ".join(f'"{p}" IS ?' for p in info.pk_cols)
        self.conn.execute(f'DELETE FROM "{info.name}" WHERE {where}', pk_vals)

    def _write_cell(self, info: TableInfo, pk: bytes, cid: str, val) -> None:
        pk_vals = unpack_values(pk)
        where = " AND ".join(f'"{p}" IS ?' for p in info.pk_cols)
        self.conn.execute(
            f'UPDATE "{info.name}" SET "{_ident(cid)}" = ? WHERE {where}',
            [val] + pk_vals,
        )

    @contextmanager
    def interruptible(self, budget_s: float):
        """Interrupt the RW connection if the enclosed work overruns its
        budget (InterruptibleTransaction parity,
        ``sqlite-pool/src/lib.rs:116``): a runaway maintenance statement
        surfaces as sqlite3.OperationalError('interrupted') instead of
        stalling high-priority applies behind it.

        The disarm is mutually exclusive with the firing: Timer.cancel()
        cannot stop a timer that already fired, and a stray interrupt
        after block exit would abort the NEXT holder's transaction."""
        guard = threading.Lock()
        state = {"armed": True}

        def fire():
            with guard:
                if state["armed"]:
                    self.conn.interrupt()

        timer = threading.Timer(budget_s, fire)
        timer.daemon = True
        timer.start()
        try:
            yield
        finally:
            with guard:
                state["armed"] = False
            timer.cancel()

    def install_snapshot(self, staged: str) -> None:
        """Atomically swap the database file for a fully-prepared
        staged snapshot (docs/sync.md, install state machine).

        Caller contract: holds ``self._lock``, has verified the staged
        content digest, run ``snapshot.prepare_staged`` (identity
        rewrite) on it, and written the ``installing`` journal marker —
        so a crash anywhere in here classifies at boot
        (``snapshot.recover_pending_install``).

        The RW connection closes first; FREE pool readers close; a
        reader checked out mid-query keeps its fd to the pre-swap
        inode (POSIX ``os.replace`` semantics), finishes its stale
        read, and closes on return instead of re-pooling.  The pool
        condvar is HELD across the swap itself: a ``reader()``
        checkout slipping between the drain and ``os.replace`` would
        open the pre-swap inode and be re-pooled — serving stale data
        forever — so checkouts block for the (brief) swap instead.
        Stale ``-wal``/``-shm`` files are removed AFTER the swap —
        they belong to the replaced inode, and the prepared snapshot
        is a single self-contained file."""
        import os

        from corrosion_tpu_torch.agent.snapshot import fsync_dir

        # device-resident apply: pending flushes target the file being
        # REPLACED — discard them (their journal rows live in the old
        # inode; if the swap fails and we come back up on the previous
        # file, _recover_flush_journal below replays them from there)
        # and drop every cached clock view of the outgoing database
        self._wb = _WriteBehind()
        if self.device_cache is not None:
            self.device_cache.invalidate_all("snapshot_install")
            self._emit_cache_metrics()
        self.conn.close()
        swapped = False
        try:
            with self._ro_cv:
                for conn in self._ro_free:
                    conn.close()
                    if conn in self._ro_all:
                        self._ro_all.remove(conn)
                self._ro_free.clear()
                self._ro_stale.update(self._ro_all)
                self._ro_all = []
                os.replace(staged, self.path)
                swapped = True
                fsync_dir(self.path)
                for ext in ("-wal", "-shm"):
                    p = self.path + ext
                    if os.path.exists(p):
                        os.unlink(p)
        finally:
            # ALWAYS come back up on whatever file now lives at
            # self.path — the previous database if the swap raised, the
            # installed snapshot if it completed.  Without this a
            # failed os.replace (disk full, EXDEV) would leave a LIVE
            # agent holding a closed RW connection, bricking every
            # subsequent write until restart.  (If connecting itself
            # fails the error propagates with the connection closed —
            # there is no file to come up on.)
            self.conn = self._connect_rw()
            # re-derive every cached view of the schema + identity; on
            # the success path the staged prep installed OUR site id at
            # ordinal 1, so _init_meta reads it back unchanged
            self._apply_sql_cache = {}
            self._init_meta(None)
            self._tables = {}
            self._load_crr_tables()
            if swapped:
                # the installed file came from a REMOTE donor: any
                # flush-journal rows it carries are the donor's intents
                # (normally none — the donor drains before building and
                # the snapshot scrub drops the table) and must be
                # purged, never replayed: this node only ever decodes
                # journal payloads it wrote itself
                self.conn.execute("DELETE FROM __corro_flush_journal")
                self.conn.commit()
            else:
                # failed swap: we came back up on OUR previous file —
                # replay our own journal rows before serving from it
                self._recover_flush_journal()

    def close(self) -> None:
        # drain the write-behind queue while the connection is still
        # usable; on failure the journal rows replay at next boot
        try:
            self.flush_pending()
        except Exception:
            pass
        with self._ro_cv:
            self._ro_closed = True
            # close only the FREE readers: a conn mid-query belongs to
            # its checkout and is closed by reader()'s finally; waiters
            # parked in reader() are woken to fail instead of hanging
            for conn in self._ro_free:
                conn.close()
                if conn in self._ro_all:
                    self._ro_all.remove(conn)
            self._ro_free.clear()
            self._ro_cv.notify_all()
        self.conn.close()


# ---------------------------------------------------------------------------
# UDFs
# ---------------------------------------------------------------------------


def _udf_pack(*args):
    return pack_values(args)


def _udf_json_contains(a, b) -> int:
    """corro_json_contains(a, b): does JSON doc a contain doc b?

    Parity: the reference registers this custom SQL function
    (``crates/sqlite-functions/src/lib.rs:5-51``) — recursive containment:
    every key/element of ``b`` must appear in ``a``.
    """
    import json

    def contains(x, y) -> bool:
        if isinstance(y, dict):
            return isinstance(x, dict) and all(
                k in x and contains(x[k], v) for k, v in y.items()
            )
        if isinstance(y, list):
            return isinstance(x, list) and all(
                any(contains(xi, yi) for xi in x) for yi in y
            )
        return x == y

    try:
        return int(contains(json.loads(a), json.loads(b)))
    except (TypeError, ValueError):
        return 0
