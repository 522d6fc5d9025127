"""Reactive query layer: streaming subscriptions + table-level updates.

Parity: ``crates/corro-types/src/pubsub.rs`` (the Matcher engine —
incremental materialized views over SQL subscriptions, per-subscription
persistence, buffered candidate batching, ``QueryEvent`` streams) and
``updates.rs`` (table-level notify streams), served over HTTP by
``api/public/pubsub.rs`` / ``update.rs``.

Design differences (deliberate):

* table extraction uses sqlite's authorizer hook during prepare — the
  database is the SQL parser (the reference rewrites ASTs with
  ``sqlite3-parser``);
* incremental maintenance is pk-scoped like the reference's candidate
  rewrite (``pubsub.rs:602-737,1432-1707``), achieved through the same
  core move — every referenced table's primary key columns are added to
  the projection as hidden ``__corro_pk_<table>_<i>`` aliases — but via
  top-level text splicing + query nesting instead of full AST surgery.
  A change batch on table t evaluates ``SELECT * FROM (<rewritten>)
  WHERE (t's hidden pk cols) IN (VALUES ...candidates...)``: sqlite's
  subquery flattening pushes the predicate onto t's pk index, so the
  work is proportional to the candidate rows — including multi-table
  JOIN subscriptions, where each changed table scopes its own delta
  (the analogue of the reference's per-table temp-pk-table scoping).
  Result rows are identity-keyed by the joined pk tuple, yielding true
  ``update`` events.  Ineligible queries (aggregates, DISTINCT, LIMIT,
  subqueries, set ops, windows, self-joins) keep the
  re-evaluate-and-diff path (correct, not incremental);
* per-subscription state (sql, rows, change log) persists in its own
  sqlite file under ``subs_path`` and is restored on boot
  (``pubsub.rs:819-856`` parity).

Event wire format (matches the reference's ``TypedQueryEvent``):
  {"columns": [...]}            first frame of a snapshot
  {"row": [row_id, cells]}      snapshot row
  {"eoq": {"time": t, "change_id": id}}
  {"change": [kind, row_id, cells, change_id]}   kind: insert|update|delete
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import re
import sqlite3
import threading
import time
import uuid
from typing import Dict, List, Optional, Set, Tuple

logger = logging.getLogger("corrosion_tpu_torch.agent.pubsub")

from corrosion_tpu_torch.agent import submatch
from corrosion_tpu_torch.agent.pack import jsonable_row, pack_values, unpack_values
from corrosion_tpu_torch.types.changeset import ChangeV1

DEBOUNCE_S = 0.05
MAX_CHANGE_LOG = 100_000
# more candidate pks than this per round -> full refresh is cheaper
DELTA_MAX_PKS = 2048
# row-fetch VALUES chunking: stay well under sqlite's host-parameter
# ceiling even for wide composite pks
FETCH_PARAM_BUDGET = 900
# words whose presence means a row's content or membership can depend on
# OTHER rows: pk-scoped delta evaluation would be wrong, so such queries
# use full refresh.  Deliberately over-broad (a column merely NAMED
# "count" costs only the optimization, never correctness).
_GLOBAL_WORDS = frozenset(
    (
        "DISTINCT", "GROUP", "HAVING", "UNION", "INTERSECT", "EXCEPT",
        "LIMIT", "OFFSET", "OVER", "WITH",
        # aggregates
        "COUNT", "SUM", "AVG", "TOTAL", "MAX", "MIN", "GROUP_CONCAT",
        "STRING_AGG",
        # join forms the textual item parser doesn't model
        "USING", "NATURAL",
    )
)

# RIGHT/FULL joins disqualify the delta path outright: they break the
# anchor property (the FIRST from-item's rows can then be NULL-extended,
# so no non-NULL pk tuple identifies every result row).  LEFT joins are
# handled: a change on a NULLABLE (left-joined) alias re-scopes through
# the anchor (see SubscriptionHandle._delta_nullable).
_OUTER_DISQUALIFY = frozenset(("RIGHT", "FULL"))
_ITEM_STOP_WORDS = frozenset(("ON", "WHERE", "ORDER", "AND", "OR"))


def _scan_top_level(sql: str):
    """Yield (index, char, depth) for chars outside string literals,
    with paren depth tracked."""
    depth = 0
    in_str: Optional[str] = None
    for i, ch in enumerate(sql):
        if in_str:
            if ch == in_str:
                in_str = None
            continue
        if ch in ("'", '"'):
            in_str = ch
            continue
        if ch == "(":
            depth += 1
            continue
        if ch == ")":
            depth -= 1
            continue
        yield i, ch, depth


def _top_level_word(sql: str, word: str, start: int = 0) -> int:
    """Index of the first depth-0 occurrence of ``word`` as a bare word
    outside strings, or -1."""
    up = sql.upper()
    w = word.upper()
    for i, ch, depth in _scan_top_level(sql):
        if depth != 0 or i < start:
            continue
        if up.startswith(w, i) and (i == 0 or not up[i - 1].isalnum()):
            end = i + len(w)
            if end == len(sql) or not (up[end].isalnum() or up[end] == "_"):
                return i
    return -1


def _mask_strings(s: str) -> str:
    """Copy of ``s`` with string-literal/quoted content blanked, so
    word regexes cannot match inside literals."""
    out = [" "] * len(s)
    for i, ch, _depth in _scan_top_level(s):
        out[i] = ch
    return "".join(out)


_CONN_RE = re.compile(
    r",|\bLEFT\s+OUTER\s+JOIN\b|\bLEFT\s+JOIN\b"
    r"|\b(?:INNER\s+|CROSS\s+)?JOIN\b",
    re.IGNORECASE,
)


def from_items_ex(nsql: str):
    """Top-level from-items of a normalized single SELECT.

    Returns ``(items, conn_spans)`` where ``items`` is a list of
    ``(table, alias, nullable)`` triples — ``nullable`` marks an item
    introduced by a LEFT [OUTER] JOIN, whose columns can be
    NULL-extended in the result — and ``conn_spans[j]`` is the absolute
    (start, end) span in ``nsql`` of the connector introducing item j
    (None for the anchor), used to build the inner-join scope variant
    for nullable deltas.  ``(None, None)`` when the shape is out of
    scope (subquery in FROM, USING/NATURAL/RIGHT/FULL joins, quoted
    exotica).  The textual counterpart of the reference's table
    extraction (``pubsub.rs:1813-2107``)."""
    fi = _top_level_word(nsql, "FROM")
    if fi < 0:
        return None, None
    end = len(nsql)
    for stop in ("WHERE", "ORDER", "GROUP", "LIMIT", "HAVING", "WINDOW"):
        si = _top_level_word(nsql, stop, fi + 4)
        if 0 <= si < end:
            end = si
    cstart = fi + 4
    clause = nsql[cstart:end]
    if "(" in clause:
        return None, None  # subquery or function in FROM
    masked = _mask_strings(clause)
    for w in re.findall(r"[A-Za-z_]+", masked.upper()):
        if w in _OUTER_DISQUALIFY:
            return None, None  # RIGHT/FULL: anchor property broken
        if w in ("NATURAL", "USING"):
            # join forms whose columns the splitter doesn't model —
            # without this, "t NATURAL JOIN u" would parse as table t
            # aliased NATURAL
            return None, None
    conns = list(_CONN_RE.finditer(masked))
    # item segments live between consecutive connectors
    bounds = []
    prev = 0
    for m in conns:
        bounds.append((prev, m.start()))
        prev = m.end()
    bounds.append((prev, len(clause)))
    items: List[Tuple[str, str, bool]] = []
    conn_spans: List[Optional[Tuple[int, int]]] = []
    for j, (s, e) in enumerate(bounds):
        seg = clause[s:e]
        seg_masked = masked[s:e]
        # keep only the item itself (strip any ON condition; located on
        # the masked copy so an 'ON' inside a literal cannot match)
        mo = re.search(r"\bON\b", seg_masked, flags=re.IGNORECASE)
        piece = (seg[: mo.start()] if mo else seg).strip()
        if not piece:
            if j == 0:
                return None, None  # leading connector
            continue
        toks = piece.replace('"', "").split()
        if not toks:
            return None, None
        table = toks[0]
        alias = table
        rest = [t for t in toks[1:] if t.upper() != "AS"]
        if rest:
            if len(rest) > 1 or rest[0].upper() in _ITEM_STOP_WORDS:
                return None, None
            alias = rest[0]
        if not re.fullmatch(r"\w+", table) or not re.fullmatch(
            r"\w+", alias
        ):
            return None, None
        conn = conns[j - 1] if j > 0 else None
        nullable = bool(
            conn and conn.group(0).upper().startswith("LEFT")
        )
        items.append((table, alias, nullable))
        conn_spans.append(
            (cstart + conn.start(), cstart + conn.end()) if conn else None
        )
    if not items:
        return None, None
    return items, conn_spans


def from_items(nsql: str) -> Optional[List[Tuple[str, str, bool]]]:
    """`from_items_ex` without the connector spans."""
    items, _spans = from_items_ex(nsql)
    return items


def group_by_exprs(nsql: str) -> Optional[List[str]]:
    """The GROUP BY expressions of a normalized single SELECT, when
    every one is a bare column or alias.column reference (the shapes
    the scoped re-aggregation can key on); None otherwise or when there
    is no GROUP BY."""
    gi = _top_level_word(nsql, "GROUP")
    if gi < 0:
        return None
    m = re.match(r"GROUP\s+BY\b", nsql[gi:], flags=re.IGNORECASE)
    if not m:
        return None
    start = gi + m.end()
    end = len(nsql)
    for stop in ("HAVING", "ORDER", "LIMIT", "WINDOW"):
        si = _top_level_word(nsql, stop, start)
        if 0 <= si < end:
            end = si
    exprs = [e.strip() for e in nsql[start:end].split(",")]
    for e in exprs:
        if not re.fullmatch(r"\w+(\.\w+)?", e):
            return None
    return exprs or None


def from_clause_text(nsql: str) -> str:
    """The text of the top-level FROM clause (between FROM and the
    first top-level stop word)."""
    fi = _top_level_word(nsql, "FROM")
    end = len(nsql)
    for stop in ("WHERE", "ORDER", "GROUP", "LIMIT", "HAVING", "WINDOW"):
        si = _top_level_word(nsql, stop, fi + 4)
        if 0 <= si < end:
            end = si
    return nsql[fi + 4:end].strip()


def splice_pk_cols(nsql: str, items: List[Tuple[str, str, bool]],
                   pk_cols: Dict[str, List[str]]) -> Tuple[str, int]:
    """Rewrite the SELECT to append every from-item's pk columns as
    hidden ``__corro_pk_<alias>_<i>`` aliases (the reference's
    ``__corro_pk`` projection tagging, ``pubsub.rs:602-737``).  Returns
    (rewritten sql, number of hidden columns)."""
    fi = _top_level_word(nsql, "FROM")
    extras = []
    for table, alias, _nullable in items:
        for i, col in enumerate(pk_cols[table]):
            extras.append(
                f'"{alias}"."{col}" AS __corro_pk_{alias}_{i}'
            )
    return (
        nsql[:fi].rstrip() + ", " + ", ".join(extras) + " " + nsql[fi:],
        len(extras),
    )


def plan_mentions(plan_text: str, op: str, name: str) -> bool:
    """Does an EXPLAIN QUERY PLAN transcript apply ``op`` (SEARCH/SCAN)
    to the from-item ``name``?  Handles both plan formats: sqlite >=
    3.36 prints ``SEARCH t``, older builds print ``SEARCH TABLE tests
    AS t`` (or ``SEARCH TABLE tests`` when unaliased).  Word-boundary
    matching, and a bare table-name hit directly followed by ``AS`` is
    rejected — there it is the TABLE of some other alias, not the
    from-item asked about."""
    return re.search(
        rf"{op} (?:TABLE )?(?:\w+ AS )?{re.escape(name)}\b(?!\s+AS\b)",
        plan_text,
    ) is not None


def normalize_sql(sql: str) -> str:
    """Collapse whitespace OUTSIDE string literals only."""
    out = []
    in_str: Optional[str] = None
    ws = False
    for ch in sql.strip().rstrip(";").strip():
        if in_str:
            out.append(ch)
            if ch == in_str:
                in_str = None
            continue
        if ch in ("'", '"'):
            in_str = ch
            out.append(ch)
            ws = False
        elif ch.isspace():
            ws = True
        else:
            if ws and out:
                out.append(" ")
            ws = False
            out.append(ch)
    return "".join(out)


def tables_of_query(conn: sqlite3.Connection, sql: str) -> Set[str]:
    """Which tables does this SELECT read?  The authorizer sees every
    SQLITE_READ during prepare."""
    tables: Set[str] = set()

    def auth(action, arg1, arg2, dbname, trigger):
        if action == sqlite3.SQLITE_READ and arg1:
            tables.add(arg1)
        return sqlite3.SQLITE_OK

    conn.set_authorizer(auth)
    try:
        conn.execute(f"EXPLAIN {sql}")
    finally:
        conn.set_authorizer(None)
    return tables


class SubscriptionHandle:
    """One live subscription; many HTTP streams can attach."""

    def __init__(self, manager: "SubsManager", sub_id: str, sql: str,
                 columns: List[str], tables: Set[str], db_path: str):
        self.manager = manager
        self.id = sub_id
        self.sql = sql
        self.columns = columns
        self.tables = tables
        self.db_path = db_path
        # zero-receiver GC bookkeeping (pubsub.rs:131-227 parity)
        self.last_receiver_at = time.time()
        # last SUCCESSFUL refresh/delta round (wall): the per-sub
        # staleness base — corro_subs_staleness_seconds{id=} rises from
        # here, so a sub silently losing its refreshes (counted in
        # corro_subs_refresh_failures_total) is visible as a rising age
        self.last_ok_at = time.time()
        self._lock = threading.RLock()
        # row identity -> (row_id, cells); change log for catch-up
        self.rows: Dict[str, Tuple[int, list]] = {}
        self.last_row_id = 0
        self.last_change_id = 0
        self._closed = False
        self._streams: List[queue.Queue] = []
        # pk-scoped incremental evaluation (set by the manager when the
        # query qualifies): the rewritten query with hidden
        # __corro_pk_* columns, the from-items in projection order, the
        # hidden-column index ranges per ALIAS (a self-join has one
        # scope per occurrence), and the identity index
        # (alias, pk-hex) -> [identities]
        self.exec_sql: Optional[str] = None
        self.n_hidden = 0
        self.pk_items: Optional[List[Tuple[str, str, bool]]] = None
        self.pk_idx: Dict[str, List[int]] = {}  # alias -> exec col idx
        self.by_pk: Dict[Tuple[str, str], List[str]] = {}
        self.pk_of: Dict[str, Dict[str, str]] = {}  # identity -> hexes
        # nullable alias -> (harvest select, scope-cols sql): the
        # affected-anchor harvest for LEFT-joined tables.  sqlite
        # cannot push a pk-IN predicate through a LEFT JOIN's nullable
        # side, and the user WHERE can hide a transition, so the
        # harvest selects the ANCHOR's pk columns over the from-clause
        # with that one connector flipped LEFT JOIN -> JOIN and NO user
        # WHERE — a superset of the affected anchors
        self.harvest_sql: Dict[str, Tuple[str, str]] = {}
        # aliases whose scoped delta cannot reach an index: a change on
        # their table falls back to one full refresh for the round
        self.full_refresh_aliases: Set[str] = set()
        # bounded re-evaluation mode (ORDER BY + LIMIT over an
        # index-served ordering): a change wave re-runs the whole query
        # but the index bounds the cost to O(limit), so it counts as a
        # delta round, not a full refresh
        self.bounded = False
        # COUNT(*)-only mode: the single count row is maintained
        # incrementally from per-pk membership transitions (the
        # pk_groups side table records which pks are currently counted)
        self.count_only = False
        self.count_full_probe: Optional[str] = None
        self.count_has_where = False
        self.count_pk_cols_sql = ""
        # columnar matcher spec (submatch.SubSpec) when the shape is
        # decidable from (pk, liveness, current row); None = this sub
        # stays on the per-sub oracle path
        self.columnar_spec = None
        # matcher shard this sub's candidate work routes to
        self.shard = 0
        # single-table GROUP BY aggregate mode: the group-key tuple is
        # the row identity; a delta probes the changed pks' CURRENT
        # groups (no user WHERE — it can hide a membership change),
        # unions them with the pks' previously-recorded groups (the
        # pk_groups side table), and re-aggregates only those groups
        # (the reference's scoped re-aggregation, pubsub.rs:1432-1707)
        self.agg = False
        self.agg_probe_sql: Optional[str] = None
        self.agg_pk_cols_sql = ""
        self.agg_n_grp = 0
        # (prefix, suffix, per-group conjunction): the scoped re-agg
        # splices its group predicate INTO the query's own WHERE ahead
        # of GROUP BY — sqlite does not push outer predicates into an
        # aggregate subquery, so wrapping would re-scan the table
        self.agg_scope_parts: Optional[Tuple[str, str, str]] = None
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.executescript(
            """
CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value TEXT);
CREATE TABLE IF NOT EXISTS rows (
  identity TEXT PRIMARY KEY, row_id INTEGER NOT NULL, cells TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS changes (
  change_id INTEGER PRIMARY KEY, kind TEXT NOT NULL,
  row_id INTEGER NOT NULL, cells TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS pk_groups (
  pk TEXT PRIMARY KEY, grp TEXT NOT NULL);
"""
        )
        have = {r[1] for r in self._db.execute("PRAGMA table_info(rows)")}
        if "pk" not in have:
            self._db.execute("ALTER TABLE rows ADD COLUMN pk TEXT")
        self._db.execute(
            "INSERT OR REPLACE INTO meta VALUES ('sql', ?)", (sql,)
        )
        self._db.commit()

    @property
    def incremental(self) -> bool:
        return self.pk_items is not None

    # -- persistence -----------------------------------------------------

    def _restore(self) -> bool:
        # read the change-log high-water mark FIRST: even with an empty
        # materialized set (all rows deleted pre-restart), new change ids
        # must continue after the persisted log or they collide
        last = self._db.execute("SELECT MAX(change_id) FROM changes").fetchone()
        self.last_change_id = last[0] or 0
        rows = self._db.execute(
            "SELECT identity, row_id, cells, pk FROM rows"
        ).fetchall()
        if self.incremental and rows and any(pk is None for *_r, pk in rows):
            # state persisted under the old hash-keyed identity scheme:
            # silently re-key (a diff against the restored identities
            # would read as a full-table delete+insert storm).  The old
            # change log references the now-dead row_ids, so truncate it
            # too — _can_catch_up then fails and resuming clients get a
            # fresh snapshot instead of events against unknown rids
            self._db.execute("DELETE FROM rows")
            self._db.execute("DELETE FROM changes")
            self._db.commit()
            self.last_row_id = max((r[1] for r in rows), default=0)
            self.refresh(initial=True)
            return True
        for identity, row_id, cells, pk in rows:
            self.rows[identity] = (row_id, json.loads(cells))
            self.last_row_id = max(self.last_row_id, row_id)
            if pk is not None and self.incremental:
                if pk.startswith("{"):
                    hexes = json.loads(pk)
                else:  # legacy single-table plain hex (alias == table)
                    hexes = {self.pk_items[0][1]: pk}
                self.pk_of[identity] = hexes
                for t, h in hexes.items():
                    self.by_pk.setdefault((t, h), []).append(identity)
        return bool(rows) or self.last_change_id > 0

    def _persist_rows(self, upserts, deletes, pks=None) -> None:
        def encode_pk(i):
            hexes = (pks or {}).get(i)
            if not hexes:
                return None
            first = self.pk_items[0][1] if self.pk_items else None
            if len(hexes) == 1 and next(iter(hexes)) == first:
                return next(iter(hexes.values()))  # legacy plain hex
            return json.dumps(hexes, sort_keys=True)

        self._db.executemany(
            "INSERT OR REPLACE INTO rows (identity, row_id, cells, pk) "
            "VALUES (?, ?, ?, ?)",
            [
                (i, rid, json.dumps(c), encode_pk(i))
                for i, (rid, c) in upserts.items()
            ],
        )
        self._db.executemany(
            "DELETE FROM rows WHERE identity=?", [(i,) for i in deletes]
        )

    def _persist_change(self, change_id, kind, row_id, cells) -> None:
        self._db.execute(
            "INSERT INTO changes (change_id, kind, row_id, cells) "
            "VALUES (?, ?, ?, ?)",
            (change_id, kind, row_id, json.dumps(cells)),
        )
        if change_id % 1000 == 0:
            self._db.execute(
                "DELETE FROM changes WHERE change_id <= ?",
                (change_id - MAX_CHANGE_LOG,),
            )

    # -- evaluation ------------------------------------------------------

    @staticmethod
    def _identity(cells: list, occurrence: int) -> str:
        """Row identity = content hash + occurrence index, so duplicate
        result rows keep multiset cardinality (a projection can make rows
        non-distinct)."""
        h = hashlib.blake2s(
            json.dumps(cells, sort_keys=True, default=str).encode(),
            digest_size=16,
        ).hexdigest()
        return f"{h}:{occurrence}"

    def _pk_keyed(self, rows):
        """identity -> user cells and identity -> {alias: pk-hex} for an
        exec-query result set: identities key on the joined tuple of
        every from-item's hidden pk columns (stable across evaluations
        — true update events; the single-table identity is the plain
        ``hex:occ`` the old format used, so persisted state carries
        over).  A NULL-extended left-join side packs its NULL pk values
        like any others — the anchor side keeps the identity unique."""
        new_ids: Dict[str, list] = {}
        pks_of: Dict[str, Dict[str, str]] = {}
        counts: Dict[str, int] = {}
        n_user = None
        for r in rows:
            if n_user is None:
                n_user = len(r) - self.n_hidden
            cells = jsonable_row(r[:n_user])
            hexes = {
                a: pack_values([r[i] for i in self.pk_idx[a]]).hex()
                for _t, a, _n in self.pk_items
            }
            joined = "|".join(hexes[a] for _t, a, _n in self.pk_items)
            occ = counts.get(joined, 0)
            counts[joined] = occ + 1
            identity = f"{joined}:{occ}"
            new_ids[identity] = cells
            pks_of[identity] = hexes
        return new_ids, pks_of

    def _grp_keyed(self, rows):
        """identity -> user cells and identity -> pseudo-alias hexes
        for an aggregate exec result: one row per group, identity keyed
        on the packed group-key tuple (stable — count changes arrive as
        in-place updates)."""
        new_ids: Dict[str, list] = {}
        pks_of: Dict[str, Dict[str, str]] = {}
        n_user = None
        for r in rows:
            if n_user is None:
                n_user = len(r) - self.agg_n_grp
            cells = jsonable_row(r[:n_user])
            h = pack_values(list(r[n_user:])).hex()
            identity = f"{h}:0"
            new_ids[identity] = cells
            pks_of[identity] = {"__corro_grp": h}
        return new_ids, pks_of

    def _rebuild_pk_groups(self) -> None:
        """Recompute the pk -> group side map wholesale (boot/refresh:
        rows may have moved groups while the map wasn't maintained).
        Caller holds ``self._lock``; caller commits."""
        _, rows = self.manager.agent.storage.read_query(self.agg_probe_sql)
        n = self.agg_n_grp
        self._db.execute("DELETE FROM pk_groups")
        self._db.executemany(
            "INSERT OR REPLACE INTO pk_groups VALUES (?, ?)",
            [
                (
                    pack_values(list(r[n:])).hex(),
                    pack_values(list(r[:n])).hex(),
                )
                for r in rows
            ],
        )

    def _apply_diff(self, new_ids, pks_of, scope_old, initial,
                    cand_keys=None) -> None:
        """Diff ``new_ids`` against ``scope_old`` (the materialized rows
        the evaluation could have produced), persist, emit events.
        ``cand_keys``: the (table, pk-hex) scope keys of a delta round,
        None for a full refresh.  Caller holds ``self._lock``."""
        upserts: Dict[str, Tuple[int, list]] = {}
        events = []
        for identity, cells in new_ids.items():
            old = scope_old.get(identity)
            if old is None:
                self.last_row_id += 1
                rid = self.last_row_id
                upserts[identity] = (rid, cells)
                if not initial:
                    self.last_change_id += 1
                    events.append(("insert", rid, cells, self.last_change_id))
            elif old[1] != cells:
                rid = old[0]
                upserts[identity] = (rid, cells)
                if not initial:
                    self.last_change_id += 1
                    events.append(("update", rid, cells, self.last_change_id))
        deletes = []
        for identity, (rid, cells) in scope_old.items():
            if identity not in new_ids:
                deletes.append(identity)
                if not initial:
                    self.last_change_id += 1
                    events.append(("delete", rid, cells, self.last_change_id))
        self.rows.update(upserts)
        for i in deletes:
            self.rows.pop(i, None)
        if self.incremental:
            if cand_keys is None:
                self.by_pk = {}
                self.pk_of = {}
            else:
                for i in deletes:
                    # drop the row from EVERY table's index (a delta
                    # scoped on one table deletes rows the other
                    # tables' entries still reference); prune emptied
                    # keys or delete churn grows by_pk without bound
                    for t, h in self.pk_of.pop(i, {}).items():
                        lst = self.by_pk.get((t, h))
                        if lst and i in lst:
                            lst.remove(i)
                        if lst is not None and not lst:
                            del self.by_pk[(t, h)]
            for identity, hexes in pks_of.items():
                self.pk_of[identity] = hexes
                for t, h in hexes.items():
                    lst = self.by_pk.setdefault((t, h), [])
                    if identity not in lst:
                        lst.append(identity)
        self._persist_rows(upserts, deletes, pks_of)
        for kind, rid, cells, cid in events:
            self._persist_change(cid, kind, rid, cells)
        self._db.commit()
        for kind, rid, cells, cid in events:
            self._fanout({"change": [kind, rid, cells, cid]})

    def refresh(self, initial: bool = False) -> None:
        """Re-evaluate the whole query and emit diff events."""
        self._refresh_inner(initial)
        # only a COMPLETED pass moves the staleness base (an exception
        # above propagates to the drain round's failure counter)
        self.last_ok_at = time.time()

    def _refresh_inner(self, initial: bool = False,
                       count: bool = True) -> None:
        # bounded (ORDER BY + LIMIT) re-evals run through here too but
        # count as delta rounds, not refreshes — the index bounds their
        # cost to O(limit)
        if count:
            self.manager.agent.metrics.counter("corro_subs_refresh_total")
        if self.incremental and self.count_only:
            cols, rows = self.manager.agent.storage.read_query(self.sql)
            with self._lock:
                self.columns = cols
                cells = jsonable_row(rows[0]) if rows else [0]
                self._apply_diff(
                    {"__corro_count:0": cells}, {"__corro_count:0": {}},
                    dict(self.rows), initial,
                )
                self._rebuild_count_members()
                self._db.commit()
            return
        if self.incremental and self.agg:
            cols, rows = self.manager.agent.storage.read_query(
                self.exec_sql
            )
            with self._lock:
                self.columns = cols[: len(cols) - self.agg_n_grp]
                new_ids, pks_of = self._grp_keyed(rows)
                self._apply_diff(new_ids, pks_of, dict(self.rows), initial)
                self._rebuild_pk_groups()
                self._db.commit()
            return
        if self.incremental:
            cols, rows = self.manager.agent.storage.read_query(
                self.exec_sql
            )
            with self._lock:
                self.columns = cols[: len(cols) - self.n_hidden]
                new_ids, pks_of = self._pk_keyed(rows)
                self._apply_diff(new_ids, pks_of, dict(self.rows), initial)
            return
        cols, rows = self.manager.agent.storage.read_query(self.sql)
        with self._lock:
            self.columns = cols
            new_ids = {}
            counts: Dict[str, int] = {}
            for r in rows:
                cells = jsonable_row(r)
                key = json.dumps(cells, sort_keys=True, default=str)
                occ = counts.get(key, 0)
                counts[key] = occ + 1
                new_ids[self._identity(cells, occ)] = cells
            self._apply_diff(new_ids, {}, dict(self.rows), initial)

    def delta(self, table_pks: Dict[str, Set[bytes]]) -> None:
        """Pk-scoped incremental evaluation (the candidate path,
        ``pubsub.rs:1432-1707``): work proportional to the candidate
        rows, not the table.  Each changed table scopes its own
        evaluation through its hidden pk columns, ONCE PER OCCURRENCE —
        a self-join re-evaluates each aliased occurrence separately —
        the join analogue of the reference's per-table temp-pk-table
        re-evaluation.  A change on a NULLABLE (left-joined) alias
        re-scopes through the anchor instead (``_delta_nullable``)."""
        self.manager.agent.metrics.counter("corro_subs_delta_rounds_total")
        if self.bounded:
            # ORDER BY + LIMIT: membership depends on OTHER rows (a new
            # row can push one out of the top-N), so the candidate pks
            # are irrelevant — re-run the bounded query whole.  The
            # ordering index caps the cost at O(limit).
            self.manager.agent.metrics.counter(
                "corro_subs_bounded_refresh_total"
            )
            self._refresh_inner(count=False)
            self.last_ok_at = time.time()
            return
        if self.count_only:
            pks = table_pks.get(self.pk_items[0][0])
            if pks:
                self._delta_count(pks)
            self.last_ok_at = time.time()
            return
        if self.agg:
            pks = table_pks.get(self.pk_items[0][0])
            if pks:
                self._delta_agg(pks)
            self.last_ok_at = time.time()
            return
        work = []
        need_refresh = False
        anchor_alias = self.pk_items[0][1] if self.pk_items else None
        for table, pks in table_pks.items():
            if not pks:
                continue
            for _t, alias, nullable in self.pk_items or ():
                if _t != table:
                    continue
                if alias in self.full_refresh_aliases or (
                    # a nullable delta re-scopes THROUGH the anchor, so
                    # a degraded anchor degrades it too
                    nullable and anchor_alias in self.full_refresh_aliases
                ):
                    # only the DEGRADED alias routes through refresh
                    # (one per round, at the end); sibling aliases keep
                    # their scoped deltas below, so their events emit
                    # without waiting on the full re-evaluation
                    need_refresh = True
                    continue
                work.append((alias, nullable, pks))
        for alias, nullable, pks in work:
            if nullable:
                self._delta_nullable(alias, pks)
            else:
                self._delta_scoped(alias, pks)
        if need_refresh:
            self.refresh()
        self.last_ok_at = time.time()

    def _scope_rows(self, alias: str, pk_values: List[tuple]):
        """Evaluate the exec query scoped to ``alias``'s pk tuples."""
        idx = self.pk_idx[alias]
        cols_sql = ", ".join(
            f"__corro_pk_{alias}_{i}" for i in range(len(idx))
        )
        row_ph = "(" + ", ".join("?" for _ in idx) + ")"
        values = ", ".join(row_ph for _ in pk_values)
        sql = (
            f"SELECT * FROM ({self.exec_sql}) "
            f"WHERE ({cols_sql}) IN (VALUES {values})"
        )
        params = [v for vals in pk_values for v in vals]
        _, rows = self.manager.agent.storage.read_query(sql, params)
        return rows

    def _delta_scoped(self, alias: str, pks: Set[bytes]) -> None:
        """One alias's direct pk-scoped delta round."""
        rows = self._scope_rows(alias, [tuple(unpack_values(p)) for p in pks])
        cand_keys = {(alias, pk.hex()) for pk in pks}
        with self._lock:
            new_ids, pks_of = self._pk_keyed(rows)
            scope_old = {
                i: self.rows[i]
                for k in cand_keys
                for i in self.by_pk.get(k, [])
                if i in self.rows
            }
            self._apply_diff(
                new_ids, pks_of, scope_old, initial=False,
                cand_keys=cand_keys,
            )

    def _delta_nullable(self, alias: str, pks: Set[bytes]) -> None:
        """Delta for a change on a LEFT-joined (nullable) alias.

        A pk-IN scope on the nullable side cannot see NULL-extension
        transitions: deleting the matched inner row must RE-EMIT the
        outer row NULL-extended, and inserting a first match must
        RETRACT it — both outside the changed pks' scope (their hidden
        pk columns are NULL there).  So the delta runs in two stages
        (the reference re-scopes through its per-table temp pk tables,
        ``pubsub.rs:602-737``):

        1. harvest the ANCHOR pks affected by the change — from the
           currently-JOINING rows (the harvest query: anchor pks over
           the from-clause with this alias's connector flipped to an
           inner join and NO user WHERE, since the WHERE can hide a
           transition) plus the previously-materialized rows that
           referenced the changed pks (``by_pk``);
        2. run a normal anchor-scoped delta for those anchor pks, which
           recomputes the affected outer rows in full — matched,
           filtered away, or NULL-extended.
        """
        anchor = self.pk_items[0][1]
        anchor_vals: Dict[tuple, None] = {}  # ordered de-dup
        harvest, scope_cols = self.harvest_sql[alias]
        pk_values = [tuple(unpack_values(p)) for p in pks]
        row_ph = "(" + ", ".join("?" for _ in pk_values[0]) + ")"
        values = ", ".join(row_ph for _ in pk_values)
        sql = f"{harvest} WHERE ({scope_cols}) IN (VALUES {values})"
        params = [v for vals in pk_values for v in vals]
        _, rows = self.manager.agent.storage.read_query(sql, params)
        for r in rows:
            anchor_vals[tuple(r)] = None
        with self._lock:
            for pk in pks:
                for i in self.by_pk.get((alias, pk.hex()), ()):
                    h = self.pk_of.get(i, {}).get(anchor)
                    if h is not None:
                        anchor_vals[tuple(unpack_values(bytes.fromhex(h)))] \
                            = None
        if not anchor_vals:
            return
        if len(anchor_vals) > DELTA_MAX_PKS:
            self.refresh()
            return
        self._delta_scoped(
            anchor, {pack_values(list(v)) for v in anchor_vals}
        )

    def _delta_agg(self, pks: Set[bytes]) -> None:
        """Scoped re-aggregation for a change batch on the aggregate's
        table.

        Affected groups = the changed rows' CURRENT groups (probed
        without the user WHERE, which can hide a membership change)
        UNION the groups those pks were last seen in (``pk_groups``) —
        a row that moved groups dirties both.  Only those groups are
        re-aggregated; a group whose last row left (or that fails
        HAVING) disappears from the scoped result and is emitted as a
        delete."""
        storage = self.manager.agent.storage
        pk_values = [tuple(unpack_values(p)) for p in pks]
        row_ph = "(" + ", ".join("?" for _ in pk_values[0]) + ")"
        values = ", ".join(row_ph for _ in pk_values)
        _, rows = storage.read_query(
            f"{self.agg_probe_sql} WHERE ({self.agg_pk_cols_sql}) IN "
            f"(VALUES {values})",
            [v for vals in pk_values for v in vals],
        )
        n = self.agg_n_grp
        current = {
            pack_values(list(r[n:])).hex(): tuple(r[:n]) for r in rows
        }
        affected: Dict[str, tuple] = {}
        with self._lock:
            for pk in pks:
                ph = pk.hex()
                old = self._db.execute(
                    "SELECT grp FROM pk_groups WHERE pk = ?", (ph,)
                ).fetchone()
                if old is not None:
                    affected[old[0]] = tuple(
                        unpack_values(bytes.fromhex(old[0]))
                    )
                grp = current.get(ph)
                if grp is not None:
                    gh = pack_values(list(grp)).hex()
                    affected[gh] = grp
                    self._db.execute(
                        "INSERT OR REPLACE INTO pk_groups VALUES (?, ?)",
                        (ph, gh),
                    )
                else:
                    self._db.execute(
                        "DELETE FROM pk_groups WHERE pk = ?", (ph,)
                    )
        if not affected:
            self._db.commit()
            return
        # group keys can be NULL (one NULL group per GROUP BY), and
        # NULL never matches IN — scope with IS conjunctions, spliced
        # into the query's own WHERE (see agg_scope_parts)
        prefix, suffix, conj = self.agg_scope_parts
        pred = " OR ".join(conj for _ in affected)
        _, rows2 = storage.read_query(
            prefix + pred + suffix,
            [v for grp in affected.values() for v in grp],
        )
        cand_keys = {("__corro_grp", h) for h in affected}
        with self._lock:
            new_ids, pks_of = self._grp_keyed(rows2)
            scope_old = {
                i: self.rows[i]
                for k in cand_keys
                for i in self.by_pk.get(k, [])
                if i in self.rows
            }
            self._apply_diff(
                new_ids, pks_of, scope_old, initial=False,
                cand_keys=cand_keys,
            )

    def _rebuild_count_members(self) -> None:
        """Recompute the counted-pk membership side table wholesale
        (boot/refresh).  Caller holds ``self._lock``; caller commits."""
        _, rows = self.manager.agent.storage.read_query(
            self.count_full_probe
        )
        self._db.execute("DELETE FROM pk_groups")
        self._db.executemany(
            "INSERT OR REPLACE INTO pk_groups VALUES (?, '1')",
            [(pack_values(list(r)).hex(),) for r in rows],
        )

    def _delta_count(self, pks: Set[bytes]) -> None:
        """Incremental COUNT(*) maintenance: probe the changed pks'
        CURRENT membership (the count query's own WHERE, scoped on the
        pk index), diff against each pk's recorded membership
        (``pk_groups``), and move the single count row by the net
        transition — no re-aggregation, no table scan."""
        pk_values = [tuple(unpack_values(p)) for p in pks]
        row_ph = "(" + ", ".join("?" for _ in pk_values[0]) + ")"
        values = ", ".join(row_ph for _ in pk_values)
        sep = " AND " if self.count_has_where else " WHERE "
        _, rows = self.manager.agent.storage.read_query(
            f"{self.count_full_probe}{sep}"
            f"(({self.count_pk_cols_sql}) IN (VALUES {values}))",
            [v for vals in pk_values for v in vals],
        )
        current = {pack_values(list(r)).hex() for r in rows}
        with self._lock:
            moved = 0
            for pk in pks:
                ph = pk.hex()
                was = self._db.execute(
                    "SELECT 1 FROM pk_groups WHERE pk = ?", (ph,)
                ).fetchone()
                if ph in current and was is None:
                    moved += 1
                    self._db.execute(
                        "INSERT OR REPLACE INTO pk_groups VALUES (?, '1')",
                        (ph,),
                    )
                elif ph not in current and was is not None:
                    moved -= 1
                    self._db.execute(
                        "DELETE FROM pk_groups WHERE pk = ?", (ph,)
                    )
            if not moved:
                self._db.commit()
                return
            identity = "__corro_count:0"
            old = self.rows.get(identity)
            old_n = old[1][0] if old else 0
            self._apply_diff(
                {identity: [old_n + moved]}, {identity: {}},
                dict(self.rows), initial=False, cand_keys=frozenset(),
            )

    def apply_columnar(self, verdicts: Dict[bytes, Optional[tuple]]) -> None:
        """Apply one shard wave's resolved verdicts (the columnar fast
        path): ``verdicts[pk]`` is the current row in declared column
        order (upsert) or None (delete).  Produces the exact rows,
        identities and events the per-sub oracle (``_delta_scoped``)
        would — pinned by tests/test_subs_parity.py."""
        alias = self.pk_items[0][1]
        spec = self.columnar_spec
        new_ids: Dict[str, list] = {}
        pks_of: Dict[str, Dict[str, str]] = {}
        cand_keys = set()
        for pk, row in verdicts.items():
            h = pk.hex()
            cand_keys.add((alias, h))
            if row is None:
                continue
            identity = f"{h}:0"
            new_ids[identity] = jsonable_row(
                [row[i] for i in spec.proj_idx]
            )
            pks_of[identity] = {alias: h}
        with self._lock:
            scope_old = {
                i: self.rows[i]
                for k in cand_keys
                for i in self.by_pk.get(k, [])
                if i in self.rows
            }
            self._apply_diff(
                new_ids, pks_of, scope_old, initial=False,
                cand_keys=cand_keys,
            )
        self.last_ok_at = time.time()

    def _fanout(self, event: dict) -> None:
        self.manager.agent.metrics.counter("corro_subs_events_total")
        for q in list(self._streams):
            try:
                q.put_nowait(event)
                continue
            except queue.Full:
                pass
            # bounded buffer, drop-OLDEST: a slow consumer loses its
            # oldest events (it must resubscribe from a snapshot anyway
            # once it notices the change-id gap) instead of silently
            # losing the newest — and the drop is counted, per sub
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            try:
                q.put_nowait(event)
            except queue.Full:
                pass
            self.manager.agent.metrics.counter(
                "corro_subs_events_dropped_total", sub_id=self.id
            )

    # -- streaming -------------------------------------------------------

    def stream(self, from_change_id: Optional[int] = None):
        """Generator of events: snapshot (or catch-up) then live tail."""
        q: queue.Queue = queue.Queue(maxsize=4096)
        with self._lock:
            self._streams.append(q)
            if from_change_id is not None and self._can_catch_up(from_change_id):
                backlog = [
                    {"change": [kind, rid, json.loads(cells), cid]}
                    for cid, kind, rid, cells in self._db.execute(
                        "SELECT change_id, kind, row_id, cells FROM changes "
                        "WHERE change_id > ? ORDER BY change_id",
                        (from_change_id,),
                    )
                ]
            else:
                backlog = [{"columns": self.columns}]
                backlog += [
                    {"row": [rid, cells]}
                    for rid, cells in sorted(self.rows.values())
                ]
                backlog.append(
                    {"eoq": {"time": 0.0, "change_id": self.last_change_id}}
                )
        try:
            for ev in backlog:
                yield ev
            while not self._closed:
                try:
                    ev = q.get(timeout=5.0)
                except queue.Empty:
                    continue
                if ev is None:  # close sentinel
                    return
                yield ev
        finally:
            with self._lock:
                if q in self._streams:
                    self._streams.remove(q)
                self.last_receiver_at = time.time()

    def unsubscribe_stream(self) -> None:
        pass  # generator finally-block handles removal

    def _can_catch_up(self, from_change_id: int) -> bool:
        row = self._db.execute("SELECT MIN(change_id) FROM changes").fetchone()
        lo = row[0]
        return lo is not None and from_change_id >= lo - 1

    def close(self) -> None:
        self._closed = True
        for q in list(self._streams):
            try:
                q.put_nowait(None)  # wake + end attached streams
            except queue.Full:
                pass
        self._db.close()


class _MatcherShard:
    """One matcher worker shard: its own pending sets, columnar wave
    buffers, predicate index, and drain thread.

    Subscriptions hash onto shards by sub_id (``submatch.shard_of``);
    ``SubsManager.on_change`` — called from the group-commit broadcast
    collector (the corro-wbcast worker) and the remote apply path —
    only ROUTES: per-table change waves to the shards holding columnar
    subs on that table, per-sub candidate pks to the owning shard's
    queues.  All matching (SQL or columnar) runs on shard threads, off
    the event loop and off the collector."""

    def __init__(self, mgr: "SubsManager", idx: int):
        self.mgr = mgr
        self.idx = idx
        self.index = submatch.ShardIndex()
        self.pending: Set[str] = set()
        self.pending_pks: Dict[str, Dict[str, Set[bytes]]] = {}
        self.waves: Dict[str, List] = {}
        self.draining = False
        self.wake = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name=f"corro-subs-{idx}", daemon=True
        )

    def depth(self) -> int:
        """Queued candidate work (caller holds the manager lock)."""
        return (
            len(self.pending)
            + sum(
                len(p)
                for per in self.pending_pks.values()
                for p in per.values()
            )
            + sum(len(chs) for chs in self.waves.values())
        )

    def overflow(self) -> None:
        """Bounded-depth enforcement (caller holds the manager lock):
        past the cap, queued precision work converts to full-refresh
        candidates — a refresh covers any candidate set, so nothing is
        lost, and the queue depth collapses to O(subs)."""
        self.mgr.agent.metrics.counter(
            "corro_subs_shard_overflow_total", shard=str(self.idx)
        )
        for sub_id in self.pending_pks:
            self.pending.add(sub_id)
        self.pending_pks = {}
        for table in self.waves:
            self.pending |= self.index.subs_on(table)
        self.waves = {}

    def _run(self) -> None:
        try:
            self._run_inner()
        except BaseException:
            # a dead worker must fail idle() loudly, not hang it
            # (draining stuck) or lie (popped batch never processed)
            self.mgr._worker_died = True
            raise

    def _run_inner(self) -> None:
        mgr = self.mgr
        last_gc = time.monotonic()
        while not mgr._closed:
            woke = self.wake.wait(timeout=mgr.GC_SWEEP_S)
            if mgr._closed:
                return
            # sweep on a deadline, NOT only when idle: a node with
            # steady write traffic never times the wait out.  Shard 0
            # carries the GC duty.
            if (
                self.idx == 0
                and time.monotonic() - last_gc >= mgr.GC_SWEEP_S
            ):
                mgr._gc_idle_subs()
                last_gc = time.monotonic()
            if not woke:
                continue
            time.sleep(DEBOUNCE_S)  # batch candidates
            self.wake.clear()
            with mgr._lock:
                pending, self.pending = self.pending, set()
                pending_pks, self.pending_pks = self.pending_pks, {}
                waves, self.waves = self.waves, {}
                # popped-but-unprocessed work keeps idle() false: the
                # sets alone go empty the instant a round is claimed,
                # long before its refresh/delta SQL has finished
                self.draining = bool(pending or pending_pks or waves)
            try:
                if waves:
                    # columnar waves first: a sub they degrade (fetch
                    # error, missing projection) lands in `pending` and
                    # is covered by the round's refresh pass below
                    mgr._drain_waves(self, waves, pending)
                mgr._drain_round(pending, pending_pks)
            finally:
                with mgr._lock:
                    self.draining = False


class SubsManager:
    """Owns all subscriptions + the table-update notify streams."""

    def __init__(self, agent, subs_path: Optional[str] = None):
        self.agent = agent
        self.subs_path = subs_path or os.path.join(
            os.path.dirname(agent.config.db_path) or ".", "subs"
        )
        os.makedirs(self.subs_path, exist_ok=True)
        self._subs: Dict[str, SubscriptionHandle] = {}
        self._by_sql: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._worker_died = False
        self._update_streams: Dict[str, List[queue.Queue]] = {}
        self._closed = False
        self._columnar = bool(
            getattr(agent.config, "subs_columnar", True)
        )
        self._shard_max = int(
            getattr(agent.config, "subs_shard_max_pending", 50_000)
        )
        n_shards = max(1, int(getattr(agent.config, "subs_shards", 4)))
        self._shards = [_MatcherShard(self, i) for i in range(n_shards)]
        for s in self._shards:
            s.thread.start()
        agent.on_change = self.on_change
        self._restore()

    # -- lifecycle -------------------------------------------------------

    def _restore(self) -> None:
        for fn in os.listdir(self.subs_path):
            if not fn.endswith(".db"):
                continue
            sub_id = fn[:-3]
            path = os.path.join(self.subs_path, fn)
            try:
                db = sqlite3.connect(path)
                row = db.execute(
                    "SELECT value FROM meta WHERE key='sql'"
                ).fetchone()
                db.close()
                if not row:
                    continue
                sql = row[0]
                handle = self._create(sub_id, sql)
                if not handle._restore():
                    handle.refresh(initial=True)
                else:
                    # state may have moved while we were down
                    handle.refresh(initial=False)
            except sqlite3.Error:
                continue

    def close(self) -> None:
        self._closed = True
        for s in self._shards:
            s.wake.set()
        for s in self._shards:
            s.thread.join(timeout=2)
        with self._lock:
            for h in self._subs.values():
                h.close()

    # -- subscription management ----------------------------------------

    def subscribe(self, sql: str) -> SubscriptionHandle:
        nsql = normalize_sql(sql)
        with self._lock:
            sub_id = self._by_sql.get(nsql)
            if sub_id:
                h = self._subs[sub_id]
                # hand-out counts as receiver activity: the caller gets
                # a full GC horizon to attach its stream
                h.last_receiver_at = time.time()
                return h
            # create while holding the lock: two racing subscribers with
            # the same new SQL must share one subscription
            handle = self._create(str(uuid.uuid4()), nsql)
        handle.refresh(initial=True)
        return handle

    def _create(self, sub_id: str, nsql: str) -> SubscriptionHandle:
        from corrosion_tpu_torch.agent.storage import register_udfs

        scratch = sqlite3.connect(self.agent.config.db_path)
        register_udfs(scratch)
        try:
            tables = tables_of_query(scratch, nsql)
        finally:
            scratch.close()
        raw_tables = set(tables)
        crr = set(self.agent.storage.tables)
        tables &= crr
        if not tables:
            raise ValueError("query does not read any replicated table")
        # columns are filled by the first refresh (probing with an extra
        # LIMIT clause would break queries that already have one)
        handle = SubscriptionHandle(
            self, sub_id, nsql, [], tables,
            os.path.join(self.subs_path, f"{sub_id}.db"),
        )
        handle.shard = submatch.shard_of(sub_id, len(self._shards))
        self._detect_incremental(handle, nsql, tables, raw_tables)
        if self._columnar:
            self._detect_columnar(handle, nsql)
        with self._lock:
            self._subs[sub_id] = handle
            self._by_sql[nsql] = sub_id
            if handle.columnar_spec is not None:
                self._shards[handle.shard].index.add(handle.columnar_spec)
        return handle

    def _detect_incremental(self, handle: SubscriptionHandle, nsql: str,
                            tables: Set[str],
                            raw_tables: Set[str]) -> None:
        """Qualify a query for pk-scoped delta evaluation by appending
        hidden ``__corro_pk_*`` columns for every from-item (the
        reference's projection tagging, ``pubsub.rs:602-737``).
        Requirements (conservative — a miss costs the optimization,
        never correctness):

        * a single top-level SELECT (no subqueries — a correlated or
          same-table subquery would make rows interdependent), no
          global operator / aggregate / set op / window / LIMIT;
        * a from-clause of inner-joined (plain/INNER/CROSS/comma)
          replicated tables, each referenced once (no self-joins; no
          outer joins — a row transitioning to its NULL-extended form
          escapes the inner table's pk filter; no local lookup tables —
          their changes aren't notified);
        * the per-table delta filter provably reaches that table's
          index (EXPLAIN QUERY PLAN shows a SEARCH, never a SCAN, of
          the scoped table).
        """
        up = nsql.upper()
        words = re.findall(r"[A-Za-z_]+", up)
        if words.count("SELECT") != 1:
            return
        hit = {w for w in words if w in _GLOBAL_WORDS}
        if hit:
            # escape hatches, so full refresh stays the exception:
            # ORDER BY + LIMIT over an index-served ordering gets
            # bounded re-evaluation, COUNT(*)-only gets incremental
            # membership counting, single-table GROUP BY aggregates get
            # scoped re-aggregation
            if hit == {"LIMIT"}:
                self._detect_incremental_bounded(
                    handle, nsql, tables, raw_tables
                )
                if handle.bounded:
                    return
            if hit == {"COUNT"}:
                self._detect_incremental_count(
                    handle, nsql, tables, raw_tables
                )
                if handle.count_only:
                    return
            self._detect_incremental_agg(handle, nsql, tables,
                                         raw_tables, words)
            return
        items, conn_spans = from_items_ex(nsql)
        if not items:
            return
        names = [t for t, _a, _n in items]
        aliases = [a for _t, a, _n in items]
        if len(set(aliases)) != len(aliases):
            return  # ambiguous occurrence scoping
        if any(a.startswith("__corro_") for a in aliases):
            return  # would collide with the hidden-column namespace
        if set(names) != raw_tables or not set(names) <= set(tables):
            # every table the query reads must be a replicated from-item
            # (raw_tables catches local lookup tables, whose changes
            # would never re-trigger evaluation)
            return
        infos = {}
        for t in names:
            info = self.agent.storage._tables.get(t)
            if info is None:
                return
            infos[t] = list(info.pk_cols)
        try:
            exec_sql, n_hidden = splice_pk_cols(nsql, items, infos)
            cols, _ = self.agent.storage.read_query(
                f"SELECT * FROM ({exec_sql}) LIMIT 0"
            )
        except (sqlite3.Error, ValueError):
            return
        # per-nullable-alias affected-anchor harvests: anchor pk
        # columns over the from-clause with that one connector flipped
        # LEFT JOIN -> JOIN, no user WHERE (see harvest_sql)
        anchor_t, anchor_a, _ = items[0]
        harvest_sql: Dict[str, Tuple[str, str]] = {}
        for j, (t, a, nullable) in enumerate(items):
            if not nullable:
                continue
            s, e = conn_spans[j]
            variant = nsql[:s] + "JOIN" + nsql[e:]
            anchor_cols = ", ".join(
                f'"{anchor_a}"."{c}"' for c in infos[anchor_t]
            )
            scope_cols = ", ".join(
                f'"{a}"."{c}"' for c in infos[t]
            )
            harvest = (
                f"SELECT {anchor_cols} FROM {from_clause_text(variant)}"
            )
            try:
                self.agent.storage.read_query(f"{harvest} LIMIT 0")
            except sqlite3.Error:
                return
            harvest_sql[a] = (harvest, scope_cols)
        # hidden-column projection indices per ALIAS (a self-join
        # scopes each occurrence separately)
        pk_idx: Dict[str, List[int]] = {}
        pos = len(cols) - n_hidden
        for t, a, _n in items:
            pk_idx[a] = list(range(pos, pos + len(infos[t])))
            pos += len(infos[t])
        # every delta plan must reach an index — a sibling with no
        # index on its join column would SCAN once per changed row,
        # costing O(sibling) per delta, worse than the full refresh
        # this path replaces (plans name the alias when used).  An
        # alias whose plan cannot reach an index DEGRADES individually:
        # changes on its table trigger one full refresh for the round
        # while the other aliases keep their scoped deltas.  If every
        # alias degrades the query is not incremental at all.
        full_refresh_aliases: Set[str] = set()

        def plan_of(sql: str, n_params: int):
            try:
                _, plan = self.agent.storage.read_query(
                    f"EXPLAIN QUERY PLAN {sql}", [None] * n_params
                )
            except sqlite3.Error:
                return None
            return " ".join(str(c) for row in plan for c in row)

        def in_plan(plan_text, op, name):
            # word-boundary matching: table "item" must not match the
            # plan line of its sibling "items" in the same join plan
            return plan_mentions(plan_text, op, name)

        for t, a, nullable in items:
            idx = pk_idx[a]
            if nullable:
                # the harvest is what this alias's delta runs; sqlite
                # may legally OMIT unused left-joined siblings from it
                # (absent is fine, SCAN is not), but the scoped alias
                # itself must SEARCH
                harvest, scope_cols = harvest_sql[a]
                row_ph = "(" + ", ".join("?" for _ in idx) + ")"
                plan_text = plan_of(
                    f"{harvest} WHERE ({scope_cols}) IN "
                    f"(VALUES {row_ph})",
                    len(idx),
                )
                ok = (
                    plan_text is not None
                    and in_plan(plan_text, "SEARCH", a)
                    and not any(
                        in_plan(plan_text, "SCAN", a2)
                        for _t2, a2, _n2 in items
                    )
                )
            else:
                cols_sql = ", ".join(
                    f"__corro_pk_{a}_{i}" for i in range(len(idx))
                )
                row_ph = "(" + ", ".join("?" for _ in idx) + ")"
                plan_text = plan_of(
                    f"SELECT * FROM ({exec_sql}) WHERE ({cols_sql}) "
                    f"IN (VALUES {row_ph})",
                    len(idx),
                )
                ok = plan_text is not None and all(
                    in_plan(plan_text, "SEARCH", a2)
                    and not in_plan(plan_text, "SCAN", a2)
                    for _t2, a2, _n2 in items
                )
            if not ok:
                full_refresh_aliases.add(a)
        if len(full_refresh_aliases) == len(items):
            return
        handle.exec_sql = exec_sql
        handle.harvest_sql = harvest_sql
        handle.full_refresh_aliases = full_refresh_aliases
        handle.n_hidden = n_hidden
        handle.pk_items = items
        handle.pk_idx = pk_idx

    def _detect_incremental_agg(self, handle: SubscriptionHandle,
                                nsql: str, tables: Set[str],
                                raw_tables: Set[str],
                                words: List[str]) -> None:
        """Qualify a single-table GROUP BY aggregate for scoped
        re-aggregation (``_delta_agg``).  Requirements:

        * GROUP BY on bare/qualified column names of ONE replicated
          from-item (HAVING and ORDER BY are fine — they ride inside
          the re-aggregated exec query);
        * no DISTINCT / set ops / windows / CTEs / LIMIT — their row
          content or membership depends on rows outside any group
          scope;
        * the group-scoped evaluation provably reaches an index on the
          group column(s) (EXPLAIN shows SEARCH, never SCAN).
        """
        for w in ("DISTINCT", "UNION", "INTERSECT", "EXCEPT", "LIMIT",
                  "OFFSET", "OVER", "WITH", "WINDOW", "USING",
                  "NATURAL"):
            if w in words:
                return
        grp_exprs = group_by_exprs(nsql)
        if not grp_exprs:
            return
        items, _spans = from_items_ex(nsql)
        if not items or len(items) != 1 or items[0][2]:
            return
        table, alias, _n = items[0]
        if alias.startswith("__corro_"):
            return
        if {table} != raw_tables or table not in tables:
            return
        info = self.agent.storage._tables.get(table)
        if info is None:
            return
        for e in grp_exprs:
            if "." in e and e.split(".", 1)[0] != alias:
                return
        n_grp = len(grp_exprs)
        fi = _top_level_word(nsql, "FROM")
        extras = ", ".join(
            f"{e} AS __corro_grp_{i}" for i, e in enumerate(grp_exprs)
        )
        exec_sql = (
            nsql[:fi].rstrip() + ", " + extras + " " + nsql[fi:]
        )
        pk_cols_sql = ", ".join(
            f'"{alias}"."{c}"' for c in info.pk_cols
        )
        probe = (
            f"SELECT {', '.join(grp_exprs)}, {pk_cols_sql} "
            f"FROM {from_clause_text(nsql)}"
        )
        # the scoped re-agg splices its predicate into the query's own
        # WHERE (ahead of GROUP BY): sqlite does not push an outer
        # predicate into an aggregate subquery
        gi = _top_level_word(exec_sql, "GROUP")
        wi = _top_level_word(exec_sql, "WHERE")
        if wi >= 0:
            # parenthesize the user WHERE: a top-level OR would
            # otherwise bind tighter than the appended AND and leak
            # unaffected groups into the scoped re-aggregation
            prefix = (
                exec_sql[:wi] + "WHERE (" + exec_sql[wi + 5:gi].strip()
                + ") AND ("
            )
        else:
            prefix = exec_sql[:gi] + "WHERE ("
        suffix = ") " + exec_sql[gi:]
        conj = "(" + " AND ".join(f"({e} IS ?)" for e in grp_exprs) + ")"
        try:
            self.agent.storage.read_query(
                f"SELECT * FROM ({exec_sql}) LIMIT 0"
            )
            self.agent.storage.read_query(f"{probe} LIMIT 0")
            _, plan = self.agent.storage.read_query(
                f"EXPLAIN QUERY PLAN {prefix}{conj}{suffix}",
                [None] * n_grp,
            )
        except sqlite3.Error:
            return
        plan_text = " ".join(str(c) for row in plan for c in row)
        if not plan_mentions(plan_text, "SEARCH", alias) or \
                plan_mentions(plan_text, "SCAN", alias):
            return
        handle.agg = True
        handle.exec_sql = exec_sql
        handle.agg_probe_sql = probe
        handle.agg_pk_cols_sql = pk_cols_sql
        handle.agg_n_grp = n_grp
        handle.agg_scope_parts = (prefix, suffix, conj)
        handle.pk_items = [items[0]]
        handle.pk_idx = {}

    def _detect_incremental_bounded(self, handle: SubscriptionHandle,
                                    nsql: str, tables: Set[str],
                                    raw_tables: Set[str]) -> None:
        """Qualify ORDER BY + LIMIT over an index-served ordering for
        bounded re-evaluation: membership depends on other rows (a new
        row can evict one from the top-N), so a change wave re-runs the
        WHOLE query — but only when EXPLAIN proves the ordering comes
        straight off an index (no ``USE TEMP B-TREE FOR ORDER BY``),
        which caps the cost at O(limit) regardless of table size.
        Counted as delta rounds (``corro_subs_bounded_refresh_total``),
        not full refreshes."""
        masked = _mask_strings(nsql).upper()
        if not re.search(r"\bLIMIT\s+\d+\s*$", masked):
            return  # OFFSET / expression limits keep full refresh
        if _top_level_word(nsql, "ORDER") < 0:
            return  # LIMIT without ORDER BY is nondeterministic
        items, _spans = from_items_ex(nsql)
        if not items or len(items) != 1 or items[0][2]:
            return
        table, alias, _n = items[0]
        if alias.startswith("__corro_"):
            return
        if {table} != raw_tables or table not in tables:
            return
        info = self.agent.storage._tables.get(table)
        if info is None:
            return
        try:
            exec_sql, n_hidden = splice_pk_cols(
                nsql, items, {table: list(info.pk_cols)}
            )
            cols, _ = self.agent.storage.read_query(
                f"SELECT * FROM ({exec_sql}) LIMIT 0"
            )
            _, plan = self.agent.storage.read_query(
                f"EXPLAIN QUERY PLAN {exec_sql}"
            )
        except (sqlite3.Error, ValueError):
            return
        plan_text = " ".join(
            str(c) for row in plan for c in row
        ).upper()
        if "TEMP B-TREE" in plan_text:
            # un-indexed sort: the re-eval would pay O(n log n) per
            # change wave — worse than the refresh path it replaces
            return
        handle.bounded = True
        handle.exec_sql = exec_sql
        handle.n_hidden = n_hidden
        handle.pk_items = items
        handle.pk_idx = {
            alias: list(range(len(cols) - n_hidden, len(cols)))
        }

    def _detect_incremental_count(self, handle: SubscriptionHandle,
                                  nsql: str, tables: Set[str],
                                  raw_tables: Set[str]) -> None:
        """Qualify ``SELECT COUNT(*) FROM t [WHERE …]`` for incremental
        membership counting (``_delta_count``): the single count row
        moves by the changed pks' net membership transitions, probed
        with the query's own WHERE scoped onto the pk index — never a
        re-aggregation.  Requirements: exactly that projection, one
        replicated from-item, and the scoped membership probe provably
        SEARCHes (never SCANs) the table."""
        if not re.match(r"SELECT\s+COUNT\(\s*\*\s*\)\s+FROM\b", nsql,
                        flags=re.IGNORECASE):
            return
        for stop in ("ORDER", "GROUP", "HAVING", "WINDOW"):
            if _top_level_word(nsql, stop) >= 0:
                return
        items, _spans = from_items_ex(nsql)
        if not items or len(items) != 1 or items[0][2]:
            return
        table, alias, _n = items[0]
        if alias.startswith("__corro_"):
            return
        if {table} != raw_tables or table not in tables:
            return
        info = self.agent.storage._tables.get(table)
        if info is None:
            return
        pk_cols_sql = ", ".join(
            f'"{alias}"."{c}"' for c in info.pk_cols
        )
        wi = _top_level_word(nsql, "WHERE")
        probe = (
            f"SELECT {pk_cols_sql} FROM {from_clause_text(nsql)}"
        )
        has_where = wi >= 0
        if has_where:
            # parenthesized so a top-level OR cannot out-bind the
            # scoping conjunction appended by _delta_count
            probe += f" WHERE ({nsql[wi + 5:].strip()})"
        row_ph = "(" + ", ".join("?" for _ in info.pk_cols) + ")"
        sep = " AND " if has_where else " WHERE "
        try:
            self.agent.storage.read_query(f"{probe} LIMIT 0")
            _, plan = self.agent.storage.read_query(
                f"EXPLAIN QUERY PLAN {probe}{sep}"
                f"(({pk_cols_sql}) IN (VALUES {row_ph}))",
                [None] * len(info.pk_cols),
            )
        except sqlite3.Error:
            return
        plan_text = " ".join(str(c) for row in plan for c in row)
        if not plan_mentions(plan_text, "SEARCH", alias) or \
                plan_mentions(plan_text, "SCAN", alias):
            return
        handle.count_only = True
        handle.count_full_probe = probe
        handle.count_has_where = has_where
        handle.count_pk_cols_sql = pk_cols_sql
        handle.pk_items = [items[0]]
        handle.pk_idx = {}

    def _detect_columnar(self, handle: SubscriptionHandle,
                         nsql: str) -> None:
        """Qualify an incremental single-table subscription for the
        shard matcher's columnar fast path: the verdict must be fully
        decidable from (pk, liveness, current row), i.e. a bare-column
        projection and either no WHERE or a pk IN-list predicate (the
        per-user subscription-list shape, single- or multi-column pk).
        Anything else keeps the per-sub oracle path."""
        if (
            not handle.incremental or handle.agg or handle.bounded
            or handle.count_only or handle.full_refresh_aliases
            or handle.pk_items is None or len(handle.pk_items) != 1
            or handle.pk_items[0][2]
        ):
            return
        table, alias, _n = handle.pk_items[0]
        info = self.agent.storage._tables.get(table)
        if info is None:
            return
        m = re.match(r"SELECT\s+", nsql, flags=re.IGNORECASE)
        fi = _top_level_word(nsql, "FROM")
        if not m or fi < 0:
            return
        for stop in ("ORDER", "GROUP", "LIMIT", "HAVING", "WINDOW"):
            if _top_level_word(nsql, stop) >= 0:
                return
        proj = self._parse_bare_projection(
            nsql[m.end():fi].strip(), alias, info.all_cols
        )
        if proj is None:
            return
        pk_filter = None
        wi = _top_level_word(nsql, "WHERE")
        if wi >= 0:
            pk_filter = self._parse_pk_in_list(
                nsql[wi + 5:].strip(), alias, table, list(info.pk_cols)
            )
            if pk_filter is None:
                return
        handle.columnar_spec = submatch.SubSpec(
            handle.id, table, tuple(proj), pk_filter
        )

    @staticmethod
    def _parse_bare_projection(sel: str, alias: str,
                               all_cols) -> Optional[List[int]]:
        """Map a select list of bare (optionally alias-qualified,
        optionally AS-renamed) column references onto declared-order
        column indices; None when any item is an expression."""
        col_pos = {c.lower(): i for i, c in enumerate(all_cols)}
        if sel == "*":
            return list(range(len(all_cols)))
        proj: List[int] = []
        # depth-0 comma split (an expression projection with a comma
        # inside parens never splits here — it just fails the regex)
        pieces, prev = [], 0
        for i, ch, depth in _scan_top_level(sel):
            if ch == "," and depth == 0:
                pieces.append(sel[prev:i])
                prev = i + 1
        pieces.append(sel[prev:])
        for piece in pieces:
            m = re.fullmatch(
                r'(?:(\w+)\.)?"?(\w+)"?(?:\s+AS\s+"?\w+"?)?',
                piece.strip(), flags=re.IGNORECASE,
            )
            if not m:
                return None
            qual, col = m.group(1), m.group(2)
            if qual is not None and qual != alias:
                return None
            pos = col_pos.get(col.lower())
            if pos is None:
                return None
            proj.append(pos)
        return proj

    def _parse_pk_in_list(self, where: str, alias: str, table: str,
                          pk_cols: List[str]):
        """Parse ``WHERE <pk> IN (…)`` / ``WHERE (<pk…>) IN (VALUES …)``
        into a packed-pk membership set, or None when the predicate is
        anything else.  Literal typing is affinity-checked against the
        declared pk column types: a quoted literal against an INTEGER
        pk (or vice versa) would rely on sqlite's affinity coercion,
        which Python-side packed-bytes equality cannot reproduce — such
        predicates stay on the oracle path."""
        try:
            _, tinfo = self.agent.storage.read_query(
                f'PRAGMA table_info("{table}")'
            )
        except sqlite3.Error:
            return None
        decl = {str(r[1]).lower(): str(r[2] or "").upper() for r in tinfo}

        def affinity(col: str) -> str:
            d = decl.get(col.lower(), "")
            if "INT" in d:
                return "int"
            if "CHAR" in d or "CLOB" in d or "TEXT" in d:
                return "text"
            return "other"

        def parse_lit(text: str, col: str):
            text = text.strip()
            aff = affinity(col)
            if re.fullmatch(r"-?\d+", text):
                return int(text) if aff == "int" else None
            m = re.fullmatch(r"'([^']*)'", text)
            if m is not None and aff == "text":
                return m.group(1)
            return None

        def col_ref(text: str) -> Optional[str]:
            m = re.fullmatch(
                r'(?:(\w+)\.)?"?(\w+)"?', text.strip()
            )
            if not m or (m.group(1) is not None and m.group(1) != alias):
                return None
            return m.group(2)

        pk_lower = [c.lower() for c in pk_cols]
        m = re.fullmatch(
            r"(.+?)\s+IN\s*\((.+)\)", where, flags=re.IGNORECASE | re.S
        )
        if not m:
            return None
        lhs, rhs = m.group(1).strip(), m.group(2).strip()
        if len(pk_cols) == 1 and not lhs.startswith("("):
            col = col_ref(lhs)
            if col is None or col.lower() != pk_lower[0]:
                return None
            vals = []
            for part in rhs.split(","):
                v = parse_lit(part, pk_cols[0])
                if v is None:
                    return None
                vals.append((v,))
            order = [0]
        else:
            mc = re.fullmatch(r"\((.+)\)", lhs, flags=re.S)
            if not mc:
                return None
            listed = []
            for part in mc.group(1).split(","):
                col = col_ref(part)
                if col is None:
                    return None
                listed.append(col.lower())
            # the listed columns must be exactly the pk, any order —
            # tuples are re-ordered into pk declaration order so the
            # packed bytes match the change stream's packed pks
            if sorted(listed) != sorted(pk_lower):
                return None
            order = [listed.index(c) for c in pk_lower]
            mv = re.match(r"VALUES\s*(.+)$", rhs,
                          flags=re.IGNORECASE | re.S)
            if not mv:
                return None
            tuples = re.findall(r"\(([^()]*)\)", mv.group(1))
            if not tuples:
                return None
            vals = []
            for tup in tuples:
                parts = tup.split(",")
                if len(parts) != len(pk_cols):
                    return None
                row = []
                for pos, col in zip(order, pk_cols):
                    v = parse_lit(parts[pos], col)
                    if v is None:
                        return None
                    row.append(v)
                vals.append(tuple(row))
        try:
            return frozenset(pack_values(list(v)) for v in vals)
        except Exception:
            return None

    def get(self, sub_id: str) -> Optional[SubscriptionHandle]:
        with self._lock:
            h = self._subs.get(sub_id)
            if h is not None:
                h.last_receiver_at = time.time()  # see subscribe()
            return h

    def list(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "id": h.id,
                    "sql": h.sql,
                    "tables": sorted(h.tables),
                    "rows": len(h.rows),
                    "last_change_id": h.last_change_id,
                    "incremental": h.incremental,
                    "receivers": len(h._streams),
                }
                for h in self._subs.values()
            ]

    def metric_gauges(self) -> List[tuple]:
        """Scrape-time subscription-plane gauges (the ROADMAP
        incremental-subs observability feed), emitted next to
        ``corro_subs_refresh_failures_total``:

        * ``corro_subs_pending_depth`` — queued candidate work summed
          across all matcher shards (full-refresh candidates + pk
          candidates + buffered wave changes), the pre-existing gauge;
        * ``corro_subs_matcher_queue_depth{shard=…}`` — one shard
          worker's whole backlog: queued candidates plus the round
          currently draining (a long-running refresh is load even
          after its candidates left the queue); a single hot shard is
          a routing skew, all shards hot is plane overload;
        * ``corro_subs_staleness_seconds{id=…}`` — seconds since each
          subscription's last SUCCESSFUL refresh/delta round; a rising
          series is a sub silently serving stale rows (its failures
          count in the refresh-failures counter)."""
        now = time.time()
        with self._lock:
            depths = [
                (s.idx, s.depth(), 1 if s.draining else 0)
                for s in self._shards
            ]
            stale = [
                (h.id, max(0.0, now - h.last_ok_at))
                for h in self._subs.values()
            ]
        out = [
            ("corro_subs_pending_depth",
             float(sum(d for _i, d, _dr in depths)), {}),
        ]
        out.extend(
            ("corro_subs_matcher_queue_depth", float(d + dr),
             {"shard": str(i)})
            for i, d, dr in depths
        )
        out.extend(
            ("corro_subs_staleness_seconds", round(age, 3), {"id": sid})
            for sid, age in stale
        )
        return out

    # -- change intake ---------------------------------------------------

    def on_change(self, cv: ChangeV1) -> None:
        """Called by the agent for every local commit + applied remote
        changeset (``match_changes`` parity) — from the group-commit
        broadcast collector (corro-wbcast) for local writes and the
        apply path for remote ones.  This method only ROUTES: per-table
        change waves to the shards indexing columnar subs on the table,
        per-sub pk candidates to the owning shard's queues.  No SQL, no
        matching — those run on the shard threads."""
        cs = cv.changeset
        touched: Dict[str, List] = {}
        for ch in cs.changes:
            touched.setdefault(ch.table, []).append(ch)
        woken: Set[int] = set()
        with self._lock:
            for h in self._subs.values():
                if h.columnar_spec is not None:
                    continue  # covered by the shard's wave buffer
                shard = self._shards[h.shard]
                if h.incremental:
                    hit = {t for t, _a, _n in h.pk_items if t in touched}
                    if hit:
                        per = shard.pending_pks.setdefault(h.id, {})
                        for t in hit:
                            per.setdefault(t, set()).update(
                                ch.pk for ch in touched[t]
                            )
                        woken.add(h.shard)
                elif any(t in h.tables for t in touched):
                    shard.pending.add(h.id)
                    woken.add(h.shard)
            for table, chs in touched.items():
                for shard in self._shards:
                    if shard.index.has(table):
                        shard.waves.setdefault(table, []).extend(chs)
                        woken.add(shard.idx)
            for i in woken:
                if self._shards[i].depth() > self._shard_max:
                    self._shards[i].overflow()
        for table, chs in touched.items():
            self._notify_updates(table, chs)
        for i in woken:
            self._shards[i].wake.set()

    SUB_GC_S = 120.0  # drop subs with no receivers this long (pubsub.rs GC)
    GC_SWEEP_S = 5.0

    def _fetch_rows(self, table: str, info,
                    pks: List[bytes]) -> Dict[bytes, tuple]:
        """Fetch current rows for a wave's live pks, ONCE per
        (table, wave) — the single database touch the columnar match
        pipeline makes.  Chunked to stay under sqlite's host-parameter
        limit; keyed back by packed pk so verdicts line up with the
        change stream's pk encoding."""
        pk_cols = list(info.pk_cols)
        npk = len(pk_cols)
        sel_cols = ", ".join(
            [f'"{c}"' for c in pk_cols]
            + [f'"{c}"' for c in info.all_cols]
        )
        key_sql = ", ".join(f'"{c}"' for c in pk_cols)
        chunk = max(1, FETCH_PARAM_BUDGET // npk)
        out: Dict[bytes, tuple] = {}
        for i in range(0, len(pks), chunk):
            batch = pks[i:i + chunk]
            values, params = [], []
            for pk in batch:
                cells = list(unpack_values(pk))
                if len(cells) != npk:
                    continue  # foreign-shaped pk cannot match a row
                values.append(
                    "(" + ", ".join("?" for _ in cells) + ")"
                )
                params.extend(cells)
            if not values:
                continue
            _, rows = self.agent.storage.read_query(
                f'SELECT {sel_cols} FROM "{table}"'
                f" WHERE ({key_sql}) IN (VALUES {', '.join(values)})",
                params,
            )
            for r in rows:
                out[pack_values(list(r[:npk]))] = tuple(r[npk:])
        return out

    def _drain_waves(self, shard: "_MatcherShard",
                     waves: Dict[str, List],
                     pending: Set[str]) -> None:
        """Columnar half of one shard round: resolve each table's
        buffered wave once through the merge kernel, fan verdicts to
        the shard's indexed predicates, and apply them per handle.  A
        handle the fast path cannot serve right now (no projection yet,
        fetch/apply error) degrades into ``pending`` — the oracle
        refresh in the same round covers it."""
        for table, changes in waves.items():
            subs = shard.index.subs_on(table)
            if not subs:
                continue
            self.agent.metrics.counter("corro_subs_columnar_rounds_total")
            info = self.agent.storage._tables.get(table)
            try:
                # the kernel coalesces the wave to one verdict slot per
                # pk; the fetch (DB truth) decides each slot's final
                # upsert/delete — see submatch.match_wave on why the
                # wave-local liveness bits are advisory only
                pks, _alive = submatch.resolve_wave(
                    changes, backend="numpy"
                )
                verdicts, n_pairs = submatch.match_wave(
                    shard.index, table, pks,
                    lambda need: self._fetch_rows(table, info, need),
                )
            except sqlite3.Error:
                self.agent.metrics.counter(
                    "corro_subs_delta_fallbacks_total"
                )
                pending |= subs
                continue
            if n_pairs:
                self.agent.metrics.counter(
                    "corro_subs_columnar_verdicts_total", n_pairs
                )
            now = time.time()
            for sub_id in subs:
                h = self._subs.get(sub_id)
                if h is None:
                    continue
                v = verdicts.get(sub_id)
                if not v:
                    # wave missed this sub's pk filter entirely — it is
                    # as fresh as a delta round that found no work
                    h.last_ok_at = now
                    continue
                if not h.columns:
                    # projection unknown until the initial refresh ran
                    pending.add(sub_id)
                    continue
                try:
                    h.apply_columnar(v)
                except sqlite3.Error:
                    self.agent.metrics.counter(
                        "corro_subs_delta_fallbacks_total"
                    )
                    pending.add(sub_id)

    def _drain_round(
        self, pending: Set[str],
        pending_pks: Dict[str, Dict[str, Set[bytes]]],
    ) -> None:
        """Process one popped batch of candidate work."""
        for sub_id, table_pks in pending_pks.items():
            if sub_id in pending:
                continue  # a full refresh covers the candidates
            h = self._subs.get(sub_id)
            if h is None:
                continue
            # the delta path needs the projection (first refresh) and
            # loses to a full pass beyond DELTA_MAX_PKS candidates
            total = sum(len(p) for p in table_pks.values())
            if not h.columns or total > DELTA_MAX_PKS:
                pending.add(sub_id)
                continue
            try:
                h.delta(table_pks)
            except sqlite3.Error:
                # correct but expensive; counted so a systemic
                # cause (e.g. busy storms) is visible in metrics
                self.agent.metrics.counter(
                    "corro_subs_delta_fallbacks_total"
                )
                pending.add(sub_id)  # fall back to a full pass
        with self._lock:
            handles = [self._subs[i] for i in pending if i in self._subs]
        for h in handles:
            try:
                h.refresh()
            except sqlite3.Error:
                # the candidate set stays pending-free, so the refresh
                # is simply LOST until the next change touches the sub's
                # tables — count it (a systemic cause, e.g. busy storms,
                # must be visible next to the delta-fallback counter)
                self.agent.metrics.counter(
                    "corro_subs_refresh_failures_total"
                )
                logger.debug(
                    "full refresh failed for sub %s", h.id, exc_info=True
                )

    def idle(self) -> bool:
        """True when no candidate work is queued OR in flight — the
        condition tests must wait on before measuring delta cost.
        Raises if the worker died: neither a hang (flag stuck) nor a
        silent True (batch never processed) is an acceptable answer."""
        if self._worker_died:
            raise RuntimeError("subscription worker thread died")
        with self._lock:
            return not any(
                s.pending or s.pending_pks or s.waves or s.draining
                for s in self._shards
            )

    def _gc_idle_subs(self) -> None:
        """Drop subscriptions nobody has streamed from in SUB_GC_S
        (``public/pubsub.rs:131-227``: matchers with zero receivers are
        garbage-collected after 120 s; a later identical subscribe
        simply recreates the state from a fresh snapshot)."""
        now = time.time()
        with self._lock:
            dead = [
                h for h in self._subs.values()
                if not h._streams and now - h.last_receiver_at > self.SUB_GC_S
            ]
            for h in dead:
                self._subs.pop(h.id, None)
                self._by_sql.pop(h.sql, None)
                self._shards[h.shard].index.remove(h.id)
        for h in dead:
            h.close()
            try:
                os.unlink(h.db_path)
            except OSError:
                pass
        if dead:
            self.agent.metrics.counter("corro_subs_gcd_total", len(dead))
        self.agent.metrics.gauge("corro_subs_active", len(self._subs))

    # -- table-level updates (updates.rs parity) -------------------------

    def table_updates(self, table: str):
        """Iterator of {"change": [kind, pk_cells]} events for one table.

        The queue registers EAGERLY (at call time), not lazily at the
        first ``next()``: since group commit moved ``on_change`` fan-out
        onto the wbcast worker, a write committed between creating the
        stream and first consuming it is delivered asynchronously — with
        lazy registration that event raced the first ``next()`` and,
        losing, was dropped, leaving the consumer blocked forever (an
        intermittent test_table_updates_stream hang).  An iterator
        OBJECT (not a generator): a generator abandoned before its
        first ``next()`` never runs its ``finally``, which would leak
        the eagerly-registered queue — close() is explicit and
        GC-backed."""
        q: queue.Queue = queue.Queue(maxsize=4096)
        self._update_streams.setdefault(table, []).append(q)
        return _TableUpdateStream(self, table, q)

    def _notify_updates(self, table: str, changes: List) -> None:
        streams = self._update_streams.get(table)
        if not streams:
            return
        seen_pks = set()
        for ch in changes:
            if ch.pk in seen_pks:
                continue
            seen_pks.add(ch.pk)
            # cl parity: even causal length means the row is deleted
            kind = "delete" if ch.cl % 2 == 0 else "upsert"
            cells = jsonable_row(unpack_values(ch.pk))
            for q in list(streams):
                try:
                    q.put_nowait({"change": [kind, cells]})
                except queue.Full:
                    # backpressure contract (docs/pubsub.md): a slow
                    # consumer loses its OLDEST buffered event, never
                    # stalls the intake path, and the loss is counted
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    try:
                        q.put_nowait({"change": [kind, cells]})
                    except queue.Full:
                        pass
                    self.agent.metrics.counter(
                        "corro_subs_updates_dropped_total", table=table
                    )



class _TableUpdateStream:
    """Blocking iterator over one table's update queue.

    Cleanup is explicit (``close``) and GC-backed (``__del__``): the
    queue registered eagerly in :meth:`SubsManager.table_updates`, so a
    consumer that errors out before its first ``next()`` must still
    unregister — a generator's ``finally`` never runs for a
    never-started generator."""

    def __init__(self, manager: "SubsManager", table: str,
                 q: "queue.Queue"):
        self._manager = manager
        self._table = table
        self._q = q
        self._closed = False

    def __iter__(self) -> "_TableUpdateStream":
        return self

    def __next__(self) -> dict:
        while True:
            try:
                return self._q.get(timeout=30.0)
            except queue.Empty:
                continue

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._manager._update_streams.get(
                self._table, []
            ).remove(self._q)
        except ValueError:
            pass

    def __del__(self) -> None:  # GC fallback for abandoned streams
        self.close()
