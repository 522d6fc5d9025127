"""PostgreSQL wire-protocol (v3) front-end.

Parity: ``crates/corro-pg`` ◆ — a pgwire server that lets any Postgres
client read and write the CRDT database: startup/auth handshake, the
**simple** query protocol, the **extended** protocol
(Parse/Bind/Describe/Execute/Close/Sync with prepared statements and
portals), transaction status tracking, and error responses.  Writes go
through the agent's versioned write path so they broadcast like any HTTP
transaction (``corro-pg/src/lib.rs:545``).

Implementation notes:

* SQL is parsed AST-FIRST by the recursive-descent statement parser
  (``agent/pgparse.py`` — the architecture of the reference's
  sqlparser→sqlite3-parser walk): statement class, catalog routing,
  RETURNING names, ON CONFLICT and command tags all come from the
  grammar, and $N order / casts / E'' strings / function mapping are
  applied by the shared token transforms during emission.  Statements
  outside the grammar fall back to the whole-string token pass
  (``agent/pgsql.py``), counted by corro_pg_parse_fallbacks_total.
* errors carry real SQLSTATEs (``agent/sqlstate.py``); SAVEPOINT /
  ROLLBACK TO / RELEASE work against the buffered transaction model;
  SET/SHOW/RESET are session GUCs; CancelRequest with a real
  BackendKeyData key interrupts the in-flight query (57014).
* the extended protocol honors Execute row limits with portal
  suspension (PortalSuspended / resume), and SSLRequest upgrades the
  stream to TLS when the agent has a cert configured (corro-pg TLS
  parity).
* parameters bind TYPED: the Parse message's declared OIDs (and binary
  format codes) decode ints as ints, floats as floats, bytea as bytes —
  so a PG-written row stores the same sqlite value a HTTP-written row
  does and the two merge identically under LWW (``corro-pg/src/lib.rs``
  name_to_type parity; the reference binds by declared OID the same
  way).
* results are sent in text format with per-column OIDs inferred from
  the row values (int8/float8/bool/bytea/text), which typed drivers
  parse back into native values.
* ``pg_catalog`` / ``information_schema`` queries run against a real
  sqlite rendering of the catalog (pg_class, pg_namespace,
  pg_attribute, pg_type + information_schema tables/columns) rebuilt
  from the live schema — the sqlite answer to the reference's
  ``corro-pg/src/vtab/`` virtual tables.
* BEGIN/COMMIT group writes into ONE replication version (buffered
  until COMMIT); reads inside the transaction see its own buffered
  writes (READ COMMITTED read-your-writes, evaluated in a rolled-back
  sandbox — no lock held across client round trips), other sessions
  see committed state only.
"""

from __future__ import annotations

import asyncio
import itertools
import re
import secrets
import struct
import threading
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

from corrosion_tpu_torch.agent import pgparse
from corrosion_tpu_torch.agent.sqlstate import PgError, SQLSTATE, sqlstate_for

if TYPE_CHECKING:
    from corrosion_tpu_torch.agent.runtime import Agent

PROTO_V3 = 196608
SSL_REQUEST = 80877103
CANCEL_REQUEST = 80877102

BOOL_OID = 16
BYTEA_OID = 17
INT8_OID = 20
INT2_OID = 21
INT4_OID = 23
TEXT_OID = 25
FLOAT4_OID = 700
FLOAT8_OID = 701
VARCHAR_OID = 1043
NUMERIC_OID = 1700

_INT_OIDS = (INT2_OID, INT4_OID, INT8_OID)
_FLOAT_OIDS = (FLOAT4_OID, FLOAT8_OID)


def _decode_param(data: bytes, oid: int, fmt: int):
    """Decode one Bind parameter into the native sqlite value its
    declared OID names (the typed-binding fix: TEXT-decoding everything
    made PG writes diverge from HTTP writes under LWW)."""
    if fmt == 1:  # binary
        if oid in _INT_OIDS:
            return int.from_bytes(data, "big", signed=True)
        if oid == FLOAT8_OID:
            return struct.unpack(">d", data)[0]
        if oid == FLOAT4_OID:
            return struct.unpack(">f", data)[0]
        if oid == BOOL_OID:
            return 1 if data and data[0] else 0
        if oid == BYTEA_OID:
            return data
        if oid in (TEXT_OID, VARCHAR_OID, 0):
            return data.decode()
        raise ValueError(f"binary format for OID {oid} not supported")
    s = data.decode()
    if oid in _INT_OIDS:
        return int(s)
    if oid in _FLOAT_OIDS:
        return float(s)
    if oid == NUMERIC_OID:
        return int(s) if re.fullmatch(r"[+-]?\d+", s) else float(s)
    if oid == BOOL_OID:
        return 1 if s.lower() in ("t", "true", "1", "yes", "on") else 0
    if oid == BYTEA_OID:
        return bytes.fromhex(s[2:]) if s.startswith("\\x") else s.encode()
    # unknown / text: sqlite column affinity does the rest, exactly as
    # it does for an HTTP-written JSON string
    return s


def _infer_oid(values) -> int:
    """Result-column OID from the first non-null value (the schema is
    sqlite's, so value type IS the column's storage class)."""
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return BOOL_OID
        if isinstance(v, int):
            return INT8_OID
        if isinstance(v, float):
            return FLOAT8_OID
        if isinstance(v, (bytes, bytearray, memoryview)):
            return BYTEA_OID
        return TEXT_OID
    return TEXT_OID


def _msg(tag: bytes, payload: bytes = b"") -> bytes:
    return tag + struct.pack(">I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


class _Buffer:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def int16(self) -> int:
        v = struct.unpack_from(">h", self.data, self.pos)[0]
        self.pos += 2
        return v

    def int32(self) -> int:
        v = struct.unpack_from(">i", self.data, self.pos)[0]
        self.pos += 4
        return v

    def string(self) -> str:
        end = self.data.index(b"\x00", self.pos)
        s = self.data[self.pos : end].decode()
        self.pos = end + 1
        return s

    def read(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v


# PG→SQLite translation: the tokenizer pass in agent/pgsql.py (the
# token-aware successor of the old regex translation; the reference
# does a full sqlparser→sqlite3-parser AST rewrite)
from corrosion_tpu_torch.agent.pgsql import (  # noqa: E402
    split_statements as _split_statements,
    translate_query,
)


def translate_sql(sql: str) -> str:
    return translate_query(sql)[0]


_WRITE_WORDS = frozenset((
    "INSERT", "UPDATE", "DELETE", "REPLACE", "CREATE", "DROP", "ALTER",
))


def _is_write(sql: str) -> bool:
    head = sql.lstrip().split(None, 1)
    if not head:
        return False
    first = head[0].upper()
    if first in _WRITE_WORDS:
        return True
    if first != "WITH":
        return False
    # CTE-led DML (WITH ... INSERT/UPDATE/DELETE) is a write: the DML
    # head follows the ')' closing the last CTE body at depth 0.  Only
    # INSERT/UPDATE/DELETE can head a statement after a CTE list, and
    # all three are reserved words in PG (unusable as bare aliases) —
    # so a write word in any other position (the function call in
    # WITH x AS (SELECT 1) SELECT replace(a, '1', '2'), or the alias
    # in SELECT (a+b) replace) is never one.  The call-opening check
    # guards the residual insert(...) extension-function shape.
    from corrosion_tpu_torch.agent.pgsql import tokenize

    try:
        depth = 0
        prev = None  # previous significant token text
        toks = [t for t in tokenize(sql) if t[0] not in ("ws", "comment")]
        for j, (k, txt) in enumerate(toks):
            if k == "op" and txt == "(":
                depth += 1
            elif k == "op" and txt == ")":
                depth -= 1
            elif (
                k == "word" and depth == 0
                and txt.upper() in ("INSERT", "UPDATE", "DELETE")
                and prev == ")"
                and not (j + 1 < len(toks) and toks[j + 1][1] == "(")
            ):
                return True
            prev = txt
    except Exception:
        pass
    return False


def _ast_returning_columns(raw: str, agent) -> Optional[List[str]]:
    """RETURNING column names from the AST (grammar-grounded), or None
    when the statement is outside the grammar / not a write / has no
    RETURNING clause.  Used by Describe so drivers see the row shape
    without executing."""
    try:
        node = pgparse.parse_statement(raw)
    except pgparse.Unsupported:
        return None
    if not isinstance(node, (pgparse.Insert, pgparse.Update,
                             pgparse.Delete)):
        return None
    return pgparse.returning_names(
        node, lambda t: _star_columns(agent, t)
    )


def _returning_columns(tsql: str, agent) -> Optional[List[str]]:
    """Column names a write's RETURNING clause will produce, or None
    when there is no RETURNING clause.  Token-derived FALLBACK for
    statements the parser does not cover (never matches inside
    literals): each item contributes its alias, else its last
    identifier; ``*`` expands to the target table's columns."""
    from corrosion_tpu_torch.agent.pgsql import tokenize

    try:
        tokens = [t for t in tokenize(tsql) if t[0] not in ("ws", "comment")]
    except Exception:
        return None
    idx = next(
        (i for i, (k, txt) in enumerate(tokens)
         if k == "word" and txt.upper() == "RETURNING"),
        None,
    )
    if idx is None:
        return None
    # split the tail into comma-separated items at paren depth 0
    # (RETURNING is last in sqlite's grammar, so the tail IS the list;
    # a comma inside coalesce(a, b) is NOT a separator)
    items: List[List[Tuple[str, str]]] = [[]]
    depth = 0
    for k, txt in tokens[idx + 1:]:
        if k == "op" and txt == "(":
            depth += 1
        elif k == "op" and txt == ")":
            depth -= 1
        if k == "op" and txt == "," and depth == 0:
            items.append([])
        else:
            items[-1].append((k, txt))
    cols: List[str] = []
    for item in items:
        if not item:
            continue
        if len(item) == 1 and item[0][1] == "*":
            # expand from the statement's target table (token after
            # INSERT INTO / UPDATE / DELETE FROM; quoted names count)
            names_toks = [
                (k, txt) for k, txt in tokens if k in ("word", "qident")
            ]
            table = None
            for i, (_k, w) in enumerate(names_toks):
                up = w.upper()
                if up in ("INTO", "UPDATE") or (
                    up == "FROM" and i > 0
                    and names_toks[i - 1][1].upper() == "DELETE"
                ):
                    if i + 1 < len(names_toks):
                        table = names_toks[i + 1][1].strip('"')
                    break
            cols.extend(_star_columns(agent, table))
            continue
        # alias (AS name / trailing bare word), else last identifier
        names = [txt for k, txt in item if k in ("word", "qident")]
        cols.append(names[-1].strip('"') if names else "?column?")
    return cols


def _star_columns(agent, table: Optional[str]) -> List[str]:
    """RETURNING * expansion in SQLite's DECLARATION order (pk-first
    reordering would mislabel the DataRow fields).  Served from the
    schema-version-keyed column cache so wire DDL (ALTER TABLE over
    PG) is picked up without a per-statement table_info scan."""
    if table:
        cols = agent.storage.declared_columns(table)
        if cols:
            return list(cols)
    return ["*"]


def _tag_for(sql: str, rowcount: int, nrows: int) -> str:
    word = sql.lstrip().split(None, 1)[0].upper() if sql.strip() else ""
    if word == "SELECT" or word == "WITH":
        return f"SELECT {nrows}"
    if word == "INSERT":
        return f"INSERT 0 {max(rowcount, 0)}"
    if word in ("UPDATE", "DELETE"):
        return f"{word} {max(rowcount, 0)}"
    return word or "OK"


_PG_TYPE_ROWS = [
    (BOOL_OID, "bool"), (BYTEA_OID, "bytea"), (INT8_OID, "int8"),
    (INT2_OID, "int2"), (INT4_OID, "int4"), (TEXT_OID, "text"),
    (FLOAT4_OID, "float4"), (FLOAT8_OID, "float8"),
    (VARCHAR_OID, "varchar"), (NUMERIC_OID, "numeric"),
]


def _decltype_oid(decl: str) -> int:
    d = (decl or "").upper()
    if "INT" in d:
        return INT8_OID
    if any(k in d for k in ("REAL", "FLOA", "DOUB")):
        return FLOAT8_OID
    if "BOOL" in d:
        return BOOL_OID
    if "BLOB" in d or not d:
        return BYTEA_OID
    return TEXT_OID


def _pg_typename(oid: int) -> str:
    return dict(_PG_TYPE_ROWS).get(oid, "text")


def build_catalog(agent: "Agent"):
    """Render the live schema as REAL pg_catalog / information_schema
    tables in a throwaway in-memory sqlite db, so clients can run
    actual catalog SQL (joins over pg_class/pg_attribute, \\d-style
    probes) instead of getting canned one-liners.  The sqlite answer to
    the reference's ``corro-pg/src/vtab/`` (pg_class.rs etc.) virtual
    tables, rebuilt per query from ``PRAGMA table_info``.
    """
    import sqlite3

    from corrosion_tpu_torch.agent.storage import register_udfs

    # sessions execute off-loop (asyncio.to_thread), so the cached
    # catalog connection is used from varying worker threads; access
    # is serialized per statement by the session round-trip
    cat = sqlite3.connect(":memory:", check_same_thread=False)
    register_udfs(cat)  # current_database() etc. inside catalog queries
    cat.executescript(
        """
CREATE TABLE pg_namespace (oid INTEGER PRIMARY KEY, nspname TEXT);
CREATE TABLE pg_class (
  oid INTEGER PRIMARY KEY, relname TEXT, relnamespace INTEGER,
  relkind TEXT, relnatts INTEGER);
CREATE TABLE pg_attribute (
  attrelid INTEGER, attname TEXT, atttypid INTEGER, attnum INTEGER,
  attnotnull INTEGER, attisdropped INTEGER DEFAULT 0);
CREATE TABLE pg_type (oid INTEGER PRIMARY KEY, typname TEXT);
CREATE TABLE pg_index (
  indexrelid INTEGER, indrelid INTEGER, indisprimary INTEGER,
  indkey TEXT);
CREATE TABLE pg_description (objoid INTEGER, description TEXT);
CREATE TABLE pg_database (
  oid INTEGER PRIMARY KEY, datname TEXT, datallowconn INTEGER DEFAULT 1);
CREATE TABLE pg_range (rngtypid INTEGER PRIMARY KEY, rngsubtype INTEGER);
-- information_schema (bare names: this db holds nothing else)
CREATE TABLE tables (
  table_catalog TEXT, table_schema TEXT, table_name TEXT,
  table_type TEXT);
CREATE TABLE columns (
  table_catalog TEXT, table_schema TEXT, table_name TEXT,
  column_name TEXT, ordinal_position INTEGER, data_type TEXT,
  is_nullable TEXT);
"""
    )
    cat.executemany("INSERT INTO pg_type VALUES (?, ?)", _PG_TYPE_ROWS)
    cat.execute("INSERT INTO pg_namespace VALUES (2200, 'public')")
    cat.execute("INSERT INTO pg_namespace VALUES (11, 'pg_catalog')")
    cat.execute("INSERT INTO pg_database VALUES (1, 'corrosion', 1)")
    rel_oid = 16384
    for t in sorted(agent.storage.tables):
        _, info = agent.storage.read_query(f'PRAGMA table_info("{t}")')
        cat.execute(
            "INSERT INTO pg_class VALUES (?, ?, 2200, 'r', ?)",
            (rel_oid, t, len(info)),
        )
        cat.execute(
            "INSERT INTO tables VALUES ('corrosion', 'public', ?, "
            "'BASE TABLE')", (t,),
        )
        pk_nums = []
        for cid, name, decl, notnull, _dflt, pk in info:
            oid = _decltype_oid(decl)
            cat.execute(
                "INSERT INTO pg_attribute VALUES (?, ?, ?, ?, ?, 0)",
                (rel_oid, name, oid, cid + 1, 1 if (notnull or pk) else 0),
            )
            cat.execute(
                "INSERT INTO columns VALUES ('corrosion', 'public', ?, ?, "
                "?, ?, ?)",
                (t, name, cid + 1, _pg_typename(oid),
                 "NO" if (notnull or pk) else "YES"),
            )
            if pk:
                pk_nums.append(str(cid + 1))
        if pk_nums:
            cat.execute(
                "INSERT INTO pg_index VALUES (?, ?, 1, ?)",
                (rel_oid + 1, rel_oid, " ".join(pk_nums)),
            )
        rel_oid += 2
    return cat


_SCHEMA_PREFIX_RE = re.compile(
    r"\b(?:pg_catalog|information_schema)\s*\.\s*", re.IGNORECASE
)

# catalog tables routed even when referenced unqualified — matched only
# in genuine table position (FROM/JOIN items) so a user column or alias
# merely *named* pg_class doesn't reroute the query
_CATALOG_TABLES = frozenset((
    "pg_database", "pg_class", "pg_namespace", "pg_attribute", "pg_type",
    "pg_index", "pg_description", "pg_range",
))
_JOIN_ITEM_RE = re.compile(r"\bjoin\s+(?:only\s+)?\"?(\w+)")
# a FROM clause runs to the keyword that can follow a from-list; commas
# inside it separate table refs (old-style joins)
_FROM_CLAUSE_RE = re.compile(
    r"\bfrom\s+(.*?)(?:\bwhere\b|\bgroup\s+by\b|\border\s+by\b|\bhaving\b"
    r"|\bwindow\b|\blimit\b|\bunion\b|\bexcept\b|\bintersect\b|$)",
    re.S,
)
_FROM_ITEM_RE = re.compile(r"^\(*\s*(?:only\s+)?\"?(\w+)")


def _strip_parens(sql: str) -> str:
    """Blank out parenthesized groups (subqueries, function args) so
    the from-clause scan below sees only top-level table refs — an
    inner subquery's WHERE must not terminate the outer from-list."""
    prev = None
    while prev != sql:
        prev = sql
        sql = re.sub(r"\([^()]*\)", " ", sql)
    return sql


def _unqualified_catalog_table(sql: str) -> Optional[str]:
    """First catalog table referenced in table position, or None.

    Scans with subqueries blanked, so a catalog ref *inside* a
    subquery's from-list is found by scanning each nesting level's
    stripped text via the recursion below.
    """
    for depth_text in _nesting_levels(sql):
        for m in _JOIN_ITEM_RE.finditer(depth_text):
            if m.group(1) in _CATALOG_TABLES:
                return m.group(1)
        for mf in _FROM_CLAUSE_RE.finditer(depth_text):
            for item in mf.group(1).split(","):
                mi = _FROM_ITEM_RE.match(item.strip())
                if mi and mi.group(1) in _CATALOG_TABLES:
                    return mi.group(1)
    return None


def _nesting_levels(sql: str, max_depth: int = 8):
    """The query text at each paren-nesting level, outermost first,
    each with its own inner groups blanked."""
    level = sql
    for _ in range(max_depth):
        yield _strip_parens(level)
        inners = re.findall(r"\(([^()]*(?:\([^()]*\)[^()]*)*)\)", level)
        if not inners:
            return
        level = " ; ".join(inners)

def _catalog_for(agent: "Agent"):
    """Cached rendered catalog (stored on the agent), invalidated by
    sqlite's schema_version counter (bumps on any DDL) — driver/ORM
    startup fires bursts of catalog queries and must not rebuild N
    tables' worth each time."""
    _, rows = agent.storage.read_query("PRAGMA schema_version")
    key = (rows[0][0], tuple(sorted(agent.storage.tables)))
    hit = getattr(agent, "_pg_catalog", None)
    if hit and hit[0] == key:
        return hit[1]
    cat = build_catalog(agent)
    # the stale connection is NOT closed here: another session's
    # off-loop catalog query may still be executing on it (sessions run
    # in worker threads since CancelRequest support); the in-memory db
    # is reclaimed when the last reference drops
    agent._pg_catalog = (key, cat)
    return cat


# guards lazy creation of an agent's catalog lock: a bare
# check-then-set would let two first-catalog-query sessions each
# install their OWN lock and both proceed onto the shared connection
_catalog_lock_init = threading.Lock()


def _agent_catalog_lock(agent: "Agent") -> threading.Lock:
    """The agent's catalog lock.  ``serve_pg`` installs it at server
    startup (single task, no race); this lazy path only serves direct
    callers (tests, tooling) and is made safe by the module-level
    init guard."""
    lock = getattr(agent, "_pg_catalog_lock", None)
    if lock is None:
        with _catalog_lock_init:
            lock = getattr(agent, "_pg_catalog_lock", None)
            if lock is None:
                lock = agent._pg_catalog_lock = threading.Lock()
    return lock


def _catalog_query(agent: "Agent", tsql: str, params,
                   on_conn=None) -> Tuple[list, list]:
    """Run one SELECT against the rendered catalog under the agent's
    catalog lock: sessions execute in worker threads, and one shared
    sqlite connection must not see concurrent cursors (sqlite3's
    serialized mode is a build option, not a guarantee).

    ``on_conn`` (called with the catalog connection while the query
    runs, then with None) makes catalog reads interruptible by a
    concurrent CancelRequest — the lock scope guarantees the tracked
    connection is running OUR statement, never another session's."""
    agent.metrics.counter("corro_pg_statements_total", kind="catalog")
    with _agent_catalog_lock(agent):
        conn = _catalog_for(agent)
        if on_conn is not None:
            on_conn(conn)
        try:
            cur = conn.execute(tsql, params)
            cols = [d[0] for d in cur.description or []]
            return cur.fetchall(), cols
        finally:
            if on_conn is not None:
                on_conn(None)


_GUC_DEFAULTS = {
    "server_version": "14.9",
    "server_encoding": "UTF8",
    "client_encoding": "UTF8",
    "datestyle": "ISO, MDY",
    "timezone": "UTC",
    "standard_conforming_strings": "on",
    "integer_datetimes": "on",
    "search_path": '"$user", public',
    "application_name": "",
    "transaction_isolation": "read committed",
    "statement_timeout": "0",
    "default_transaction_isolation": "read committed",
    "max_identifier_length": "63",
}


class _Session:
    def __init__(self, agent: "Agent"):
        self.agent = agent
        # name -> (raw, translated, declared param OIDs)
        self.stmts: Dict[str, Tuple[str, str, List[int]]] = {}
        # name -> {"stmt", "values", "described", "cached"}
        self.portals: Dict[str, dict] = {}
        self.in_txn = False
        self.txn_failed = False
        self.txn_writes: List[list] = []
        # savepoint stack: (name, buffered-write index at creation) —
        # ROLLBACK TO truncates the buffer back to the mark
        self.savepoints: List[Tuple[str, int]] = []
        # session GUCs (SET/SHOW/RESET); defaults overlay
        self.gucs: Dict[str, str] = {}
        # extended-protocol error recovery: after an error, further
        # Parse/Bind/Describe/Execute are discarded until Sync
        self.skip_until_sync = False
        # CancelRequest support: the read connection currently
        # executing this session's query, interruptible from any
        # thread.  The lock closes the return-to-pool race: read_query
        # clears the slot (under this lock) BEFORE the pooled reader is
        # handed to another session, so cancel() can never interrupt a
        # different session's query.
        self._active_conn = None
        self._cancel_lock = threading.Lock()
        self.backend_pid = 0
        self.backend_secret = 0
        # raw sql -> parsed AST node (None = outside the grammar);
        # bounded FIFO — prepare-once/execute-many must not re-parse
        self._ast_cache: Dict[str, object] = {}

    # -- cancellation ----------------------------------------------------

    def _track_conn(self, conn) -> None:
        with self._cancel_lock:
            self._active_conn = conn

    def cancel(self) -> None:
        """Interrupt the in-flight query, if any (CancelRequest:
        affects only the current statement; a cancel that lands
        between statements is a no-op, same as real PG's race)."""
        with self._cancel_lock:
            conn = self._active_conn
            if conn is not None:
                try:
                    conn.interrupt()
                except Exception:
                    pass

    # -- execution -------------------------------------------------------

    def execute(self, sql: str, params: Tuple = ()) -> Tuple[List[str], List[tuple], int, str]:
        """Returns (columns, rows, rowcount, tag)."""
        raw = sql.strip().rstrip(";")
        word = raw.split(None, 1)[0].upper() if raw else ""
        up_words = raw.upper().split()
        if word == "BEGIN" or word == "START":
            self.in_txn, self.txn_failed = True, False
            self.txn_writes, self.savepoints = [], []
            return [], [], 0, "BEGIN"
        if word == "COMMIT" or word == "END":
            writes, self.txn_writes = self.txn_writes, []
            self.in_txn, self.savepoints = False, []
            if self.txn_failed:
                self.txn_failed = False
                return [], [], 0, "ROLLBACK"
            if writes:
                # tracked: a CancelRequest landing mid-COMMIT interrupts
                # the buffered transaction's replay (57014).  Under
                # group commit the replay runs as one SAVEPOINT batch of
                # a combined group (docs/writes.md); an interrupt aborts
                # the group, the per-batch fallback replays the OTHER
                # sessions' batches, and this session still sees 57014
                self.agent.execute_transaction(
                    writes, on_conn=self._track_conn
                )
            return [], [], 0, "COMMIT"
        if word == "ROLLBACK" and "TO" in up_words[1:3]:
            # ROLLBACK [WORK] TO [SAVEPOINT] name: truncate the write
            # buffer to the mark and CLEAR the failed state (PG lets
            # the transaction continue past the savepoint)
            name = raw.split()[-1].lower()
            for i in range(len(self.savepoints) - 1, -1, -1):
                if self.savepoints[i][0] == name:
                    del self.txn_writes[self.savepoints[i][1]:]
                    del self.savepoints[i + 1:]
                    self.txn_failed = False
                    return [], [], 0, "ROLLBACK"
            raise PgError(
                SQLSTATE["invalid_savepoint_specification"],
                f'savepoint "{name}" does not exist',
            )
        if word == "ROLLBACK":
            self.in_txn, self.txn_failed = False, False
            self.txn_writes, self.savepoints = [], []
            return [], [], 0, "ROLLBACK"
        if self.txn_failed:
            # 25P02: everything except COMMIT/ROLLBACK is refused until
            # the failed transaction block ends (real PG behavior)
            raise PgError(
                SQLSTATE["in_failed_sql_transaction"],
                "current transaction is aborted, commands ignored "
                "until end of transaction block",
            )
        if word == "SAVEPOINT":
            if not self.in_txn:
                raise PgError(
                    SQLSTATE["no_active_sql_transaction"],
                    "SAVEPOINT can only be used in transaction blocks",
                )
            parts = raw.split()
            if len(parts) != 2:
                raise PgError(SQLSTATE["syntax_error"],
                              "syntax error in SAVEPOINT")
            self.savepoints.append((parts[1].lower(), len(self.txn_writes)))
            return [], [], 0, "SAVEPOINT"
        if word == "RELEASE":
            name = raw.split()[-1].lower()
            for i in range(len(self.savepoints) - 1, -1, -1):
                if self.savepoints[i][0] == name:
                    del self.savepoints[i:]
                    return [], [], 0, "RELEASE"
            raise PgError(
                SQLSTATE["invalid_savepoint_specification"],
                f'savepoint "{name}" does not exist',
            )
        if word in ("SET", "RESET", "SHOW"):
            return self._guc_statement(word, raw)
        if not raw:
            return [], [], 0, ""

        # AST-first: the recursive-descent parser (agent/pgparse.py)
        # grounds classification, catalog routing, RETURNING names and
        # command tags in grammar; statements outside its grammar fall
        # back to the token-pass pipeline below (counted).  Parsed
        # nodes are cached per session — prepare-once/execute-many is
        # the extended protocol's hot path
        if raw in self._ast_cache:
            node = self._ast_cache[raw]
        else:
            node = None
            try:
                node = pgparse.parse_statement(raw)
            except pgparse.Unsupported:
                self.agent.metrics.counter(
                    "corro_pg_parse_fallbacks_total"
                )
            if len(self._ast_cache) >= 256:
                self._ast_cache.pop(next(iter(self._ast_cache)))
            self._ast_cache[raw] = node
        if node is not None:
            try:
                return self._execute_ast(node, params)
            except pgparse.Unsupported:
                self.agent.metrics.counter(
                    "corro_pg_parse_fallbacks_total"
                )

        canned = self._canned(raw, params)
        if canned is not None:
            return canned

        tsql, order = translate_query(raw)
        # $N -> ? is positional in ? space: remap the bound values
        # into occurrence order (repeated/out-of-order $N refs)
        if order:
            params = self._remap(params, order)
        if _is_write(tsql):
            return self._run_write(
                tsql, params, lambda n: _tag_for(tsql, n, 0),
                _returning_columns(tsql, self.agent) is not None,
            )
        # the token-pass fallback READ path counts into the same
        # statement-mix metric as the AST pipeline (kind=read), so the
        # mix stays consistent whichever pipeline served the statement
        self.agent.metrics.counter(
            "corro_pg_statements_total", kind="read")
        # classify with leading parens stripped so a parenthesized
        # compound ("(SELECT ...) UNION ...") gets the same visibility
        # as its bare form; _is_write above already claimed CTE-led DML
        head = tsql.lstrip(" (").split(None, 1)
        is_select = bool(head) and head[0].upper() in (
            "SELECT", "WITH", "VALUES",
        )
        if is_select and self.in_txn and self.txn_writes:
            # read-your-writes inside BEGIN..COMMIT: evaluate against a
            # rolled-back sandbox that replays the buffered writes (the
            # ORM insert-then-select-by-pk shape).  Only genuine
            # queries take this path — a PRAGMA on the shared RW
            # connection would outlive the rollback
            cols, rows = self.agent.storage.speculative_read(
                self.txn_writes, tsql, params
            )
        else:
            # the tracked connection makes this read interruptible by a
            # concurrent CancelRequest ("interrupted" maps to 57014)
            cols, rows = self.agent.storage.read_query(
                tsql, params, on_conn=self._track_conn
            )
        return cols, rows, len(rows), _tag_for(tsql, -1, len(rows))

    def _remap(self, params: Tuple, order: List[int]) -> Tuple:
        if not order:
            return ()
        if max(order) > len(params):
            raise PgError(
                SQLSTATE["undefined_parameter"],
                f"there is no parameter ${max(order)}",
            )
        return tuple(params[i - 1] for i in order)

    def _execute_ast(self, node, params: Tuple):
        """Execute a parsed statement: routing, classification, tags
        and RETURNING names all come from the AST."""
        refs = pgparse.table_refs(node)
        # catalog routing: a qualified pg_catalog./information_schema.
        # ref always routes; an unqualified known catalog-table ref
        # routes unless shadowed by a user table of the same name
        user = self._user_tables()
        # (unqualified information_schema names deliberately do NOT
        # route: unlike pg_catalog, that schema is not on PG's default
        # search_path, so bare "columns" must stay a user-table ref)
        route_catalog = any(
            q.schema in ("pg_catalog", "information_schema")
            or (
                q.schema is None
                and q.base in _CATALOG_TABLES
                and q.base not in user
            )
            for q in refs
        )
        is_write = isinstance(
            node, (pgparse.Insert, pgparse.Update, pgparse.Delete)
        )
        if route_catalog:
            if is_write:
                if node.table.base in _CATALOG_TABLES or node.table.schema \
                        in ("pg_catalog", "information_schema"):
                    raise PgError(
                        SQLSTATE["insufficient_privilege"],
                        "catalog tables are read-only",
                    )
                # a user-table write whose SOURCE reads the catalog:
                # the catalog lives in a separate rendered db, so the
                # two cannot join in one statement
                raise PgError(
                    SQLSTATE["feature_not_supported"],
                    "mixing catalog reads into a write statement is "
                    "not supported",
                )
            tsql, order = pgparse.emit(
                node,
                strip_schemas=(
                    "public", "pg_catalog", "information_schema"
                ),
            )
            rows, cols = _catalog_query(
                self.agent, tsql, self._remap(params, order),
                on_conn=self._track_conn,
            )
            return cols, rows, len(rows), f"SELECT {len(rows)}"

        tsql, order = pgparse.emit(node)
        bound = self._remap(params, order)
        if is_write:
            tag_head = type(node).__name__.upper()
            return self._run_write(
                tsql, bound,
                lambda n: (f"INSERT 0 {n}" if tag_head == "INSERT"
                           else f"{tag_head} {n}"),
                node.returning is not None,
            )
        # Select / VALUES
        self.agent.metrics.counter(
            "corro_pg_statements_total", kind="read")
        if self.in_txn and self.txn_writes:
            cols, rows = self.agent.storage.speculative_read(
                self.txn_writes, tsql, bound
            )
        else:
            cols, rows = self.agent.storage.read_query(
                tsql, bound, on_conn=self._track_conn
            )
        return cols, rows, len(rows), f"SELECT {len(rows)}"

    def _run_write(self, tsql: str, bound, tag, has_returning: bool):
        """The shared write path for BOTH pipelines (AST + fallback):
        buffered inside BEGIN, versioned execute_transaction outside;
        ``tag`` maps the affected-row count to the command tag."""
        self.agent.metrics.counter(
            "corro_pg_statements_total", kind="write")
        stmt = [tsql, list(bound)] if bound else [tsql]
        if self.in_txn:
            if has_returning:
                # writes inside BEGIN are buffered until COMMIT, so
                # RETURNING rows don't exist yet — failing fast beats
                # silently returning none (ORMs would read a missing
                # primary key)
                raise PgError(
                    SQLSTATE["feature_not_supported"],
                    "RETURNING inside an explicit transaction is "
                    "not supported (writes are buffered until "
                    "COMMIT); run the statement in autocommit",
                )
            self.txn_writes.append(stmt)
            # rowcount unknown until commit; report optimistically
            return [], [], 1, tag(1)
        # tracked while the storage lock is held: a concurrent
        # CancelRequest interrupts the in-flight WRITE too (57014),
        # not just pooled reads
        out = self.agent.execute_transaction(
            [stmt], on_conn=self._track_conn
        )
        res = out["results"][0]
        rc = res.get("rows_affected", 0)
        if "rows" in res:
            # INSERT/UPDATE/DELETE ... RETURNING (the ORM write
            # shape): the versioned write path surfaces the rows
            cols, rows = res["columns"], res["rows"]
            return cols, rows, rc, tag(max(rc, len(rows)))
        return [], [], rc, tag(rc)

    def _guc_statement(self, word: str, raw: str):
        """SET / RESET / SHOW against the session's GUC store (real
        session state, not a canned reply: SET is visible to later
        SHOWs, RESET restores the default, SHOW ALL lists)."""
        self.agent.metrics.counter(
            "corro_pg_statements_total", kind="utility")
        body = raw.split(None, 1)[1].strip() if " " in raw else ""
        if word == "SET":
            # scope prefixes first, so SET LOCAL TIME ZONE etc. parse
            body = re.sub(r"^(?:SESSION|LOCAL)\s+", "", body,
                          flags=re.IGNORECASE)
            up = body.upper()
            # transaction-characteristics / role forms drivers and
            # poolers send at setup: accepted as no-ops — the storage
            # is single-writer READ COMMITTED with one implicit role
            if up.startswith((
                "TRANSACTION", "CHARACTERISTICS AS", "CONSTRAINTS",
                "ROLE", "AUTHORIZATION",
            )):
                return [], [], 0, "SET"
            m3 = re.match(r"NAMES\s+(.+)$", body, flags=re.IGNORECASE)
            if m3:
                self.gucs["client_encoding"] = m3.group(1).strip().strip("'")
                return [], [], 0, "SET"
            m2 = re.match(r"TIME\s+ZONE\s+(.+)$", body, flags=re.IGNORECASE)
            if m2:
                self.gucs["timezone"] = m2.group(1).strip().strip("'")
                return [], [], 0, "SET"
            # SET name {TO|=} value
            m = re.match(
                r"([A-Za-z_][\w.]*)\s*(?:=|\bTO\b)\s*(.+)$",
                body, flags=re.IGNORECASE | re.DOTALL,
            )
            if not m:
                raise PgError(SQLSTATE["syntax_error"],
                              f"syntax error in SET: {raw!r}")
            name = m.group(1).lower()
            val = m.group(2).strip()
            if val.upper() == "DEFAULT":
                self.gucs.pop(name, None)
            elif name == "search_path":
                # the one comma-LIST parameter clients actually SET:
                # normalize item spacing and quoting per element
                self.gucs[name] = ", ".join(
                    p.strip().strip("'") for p in val.split(",")
                )
            else:
                # scalar: strip one level of quoting whole, so a value
                # containing commas ('svc,primary') survives verbatim
                if len(val) >= 2 and val[0] == val[-1] == "'":
                    val = val[1:-1].replace("''", "'")
                self.gucs[name] = val
            return [], [], 0, "SET"
        if word == "RESET":
            if body.upper() == "ALL":
                self.gucs.clear()
            else:
                self.gucs.pop(body.lower(), None)
            return [], [], 0, "RESET"
        # SHOW
        name = body.lower()
        if name == "time zone":
            name = "timezone"
        if name == "all":
            rows = sorted(
                {**_GUC_DEFAULTS, **self.gucs}.items()
            )
            return (
                ["name", "setting", "description"],
                [(k, v, "") for k, v in rows],
                len(rows),
                f"SELECT {len(rows)}",
            )
        if name in ("transaction isolation level",):
            name = "transaction_isolation"
        val = self.gucs.get(name, _GUC_DEFAULTS.get(name))
        if val is None:
            raise PgError(
                SQLSTATE["undefined_object"],
                f'unrecognized configuration parameter "{name}"',
            )
        return [name], [(val,)], 1, "SELECT 1"

    def _user_tables(self) -> set:
        return {t.lower() for t in self.agent.storage.tables}

    def _canned(self, raw: str, params: Tuple = ()):
        """Catalog routing for the token-pass FALLBACK pipeline only —
        statements the recursive-descent parser handles never get here
        (their routing is AST-based in ``_execute_ast``).  The old
        SET/SHOW regex probes are gone (real GUC statements now); this
        residue keeps catalog queries working for shapes outside the
        grammar."""
        low = " ".join(raw.lower().split())
        # version()/current_database()/current_schema() are real SQL
        # functions (storage.register_udfs), so they work in any
        # expression context through the normal execution path
        # unqualified catalog routing must not fire on string literals
        # ("... WHERE note LIKE '%pg_class%'") and only reroutes reads
        no_literals = re.sub(r"'[^']*'", "''", low)
        unqualified = (
            no_literals.lstrip().startswith("select")
            and (name := _unqualified_catalog_table(no_literals)) is not None
            # a user table legitimately named e.g. pg_class wins over
            # unqualified catalog routing (qualified pg_catalog.* still
            # routes below)
            and name not in self._user_tables()
        )
        if (
            "pg_catalog" in no_literals
            or "information_schema" in no_literals
            or unqualified
        ):
            # run real catalog SQL against the rendered catalog —
            # including unqualified references: pg_catalog is always on
            # a real server's search_path, so drivers routinely write
            # bare "FROM pg_database"
            t, order = translate_query(raw)
            tsql = _SCHEMA_PREFIX_RE.sub("", t)
            if order:
                params = self._remap(params, order)
            rows, cols = _catalog_query(
                self.agent, tsql, params, on_conn=self._track_conn
            )
            return cols, rows, len(rows), f"SELECT {len(rows)}"
        return None


async def serve_pg(agent: "Agent", host: str = "127.0.0.1", port: int = 0):
    """Start the pgwire listener; returns the asyncio server.

    Live session writers are tracked on ``server.corro_conns`` so
    shutdown can abort them: ``Server.wait_closed()`` waits for every
    handler to return, and an idle client would otherwise hold
    ``Agent.stop()`` open indefinitely."""
    # the catalog lock exists BEFORE any session thread can race to
    # create it (sessions run catalog queries in worker threads)
    _agent_catalog_lock(agent)
    conns: set = set()

    async def handler(r, w):
        conns.add(w)
        try:
            await _handle_conn(agent, r, w)
        finally:
            conns.discard(w)

    server = await asyncio.start_server(handler, host, port)
    server.corro_conns = conns
    return server


def _pg_ssl_context(agent: "Agent"):
    """Per-agent cached server SSLContext (cert/key are read from disk
    once, not per connection)."""
    cfg = agent.config
    if not (cfg.tls_cert_file and cfg.tls_key_file):
        return None
    ctx = getattr(agent, "_pg_ssl_ctx", None)
    if ctx is None:
        from corrosion_tpu_torch.agent.tls import server_context

        # client-cert verification is PG's own knob (corro-pg
        # verify_client) — gossip mTLS must not lock SQL clients out
        ctx = server_context(
            cfg.tls_cert_file, cfg.tls_key_file,
            ca_file=cfg.tls_ca_file,
            require_client=cfg.pg_tls_verify_client,
        )
        agent._pg_ssl_ctx = ctx
    return ctx


_pg_pid_counter = itertools.count(1)


def _cancel_registry(agent: "Agent") -> Dict[Tuple[int, int], "_Session"]:
    reg = getattr(agent, "_pg_cancel_registry", None)
    if reg is None:
        reg = agent._pg_cancel_registry = {}
    return reg


async def _handle_conn(agent: "Agent", reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
    session = _Session(agent)
    agent.metrics.counter("corro_pg_connections_total")
    cancel_key = None
    try:
        # --- startup ----------------------------------------------------
        while True:
            head = await reader.readexactly(4)
            (length,) = struct.unpack(">I", head)
            body = await reader.readexactly(length - 4)
            (proto,) = struct.unpack_from(">I", body, 0)
            if proto == SSL_REQUEST:
                ctx = _pg_ssl_context(agent)
                if ctx is not None:
                    # corro-pg TLS parity: accept and upgrade in place
                    # (the agent's cert/key also serve the PG listener)
                    writer.write(b"S")
                    await writer.drain()
                    await writer.start_tls(ctx)
                else:
                    writer.write(b"N")  # no TLS configured
                    await writer.drain()
                continue
            if proto == CANCEL_REQUEST:
                # cancel-key connection (lib.rs:667-747 parity): look
                # up the (pid, secret) pair and interrupt that
                # session's in-flight query; never answer
                pid, secret = struct.unpack_from(">II", body, 4)
                target = _cancel_registry(agent).get((pid, secret))
                if target is not None:
                    target.cancel()
                    agent.metrics.counter("corro_pg_cancels_total")
                return
            if proto != PROTO_V3:
                _error(writer, SQLSTATE["protocol_violation"],
                       f"unsupported protocol {proto}")
                return
            break
        writer.write(_msg(b"R", struct.pack(">I", 0)))  # AuthenticationOk
        # ParameterStatus values come from the ONE GUC table SHOW reads
        for k, key in (
            ("server_version", "server_version"),
            ("server_encoding", "server_encoding"),
            ("client_encoding", "client_encoding"),
            ("DateStyle", "datestyle"),
            ("standard_conforming_strings", "standard_conforming_strings"),
            ("integer_datetimes", "integer_datetimes"),
            ("TimeZone", "timezone"),
        ):
            writer.write(_msg(b"S", _cstr(k) + _cstr(_GUC_DEFAULTS[key])))
        # a REAL cancellation key: a later CancelRequest bearing it
        # interrupts this session's running query
        session.backend_pid = next(_pg_pid_counter)
        session.backend_secret = secrets.randbits(31)
        cancel_key = (session.backend_pid, session.backend_secret)
        _cancel_registry(agent)[cancel_key] = session
        writer.write(_msg(b"K", struct.pack(">II", *cancel_key)))
        _ready(writer, session)
        await writer.drain()

        # --- message loop -----------------------------------------------
        while True:
            tag = await reader.readexactly(1)
            (length,) = struct.unpack(">I", await reader.readexactly(4))
            body = await reader.readexactly(length - 4)
            if tag == b"X":
                return
            if session.skip_until_sync and tag in (b"P", b"B", b"D",
                                                   b"E", b"C", b"H"):
                continue  # discard until Sync (extended-protocol rule)
            if tag == b"Q":
                session.skip_until_sync = False
                await _simple_query(writer, session, _Buffer(body).string())
            elif tag == b"P":
                b = _Buffer(body)
                name, query = b.string(), b.string()
                n_oids = b.int16()
                oids = [b.int32() for _ in range(n_oids)]
                session.stmts[name] = (query, translate_sql(query), oids)
                writer.write(_msg(b"1"))
            elif tag == b"B":
                _bind(writer, session, _Buffer(body))
            elif tag == b"D":
                await _describe(writer, session, _Buffer(body))
            elif tag == b"E":
                await _execute_portal(writer, session, _Buffer(body))
            elif tag == b"C":
                b = _Buffer(body)
                kind, name = b.read(1), b.string()
                (session.stmts if kind == b"S" else session.portals).pop(name, None)
                writer.write(_msg(b"3"))
            elif tag == b"S":
                session.skip_until_sync = False
                _ready(writer, session)
            elif tag == b"H":
                pass  # flush: we always flush below
            else:
                _error(writer, "08P01", f"unsupported message {tag!r}")
                _ready(writer, session)
            await writer.drain()
    except (asyncio.IncompleteReadError, ConnectionError):
        return
    finally:
        if cancel_key is not None:
            _cancel_registry(agent).pop(cancel_key, None)
        writer.close()


def _ready(writer, session: _Session) -> None:
    status = b"E" if session.txn_failed else (b"T" if session.in_txn else b"I")
    writer.write(_msg(b"Z", status))


def _error(writer, code: str, message: str) -> None:
    payload = (
        b"S" + _cstr("ERROR") + b"C" + _cstr(code) + b"M" + _cstr(message) + b"\x00"
    )
    writer.write(_msg(b"E", payload))


def _ext_error(writer, session: _Session, code: str, message: str) -> None:
    """ErrorResponse inside the extended protocol: subsequent messages
    are discarded until the client's Sync."""
    session.skip_until_sync = True
    _error(writer, code, message)


def _row_description(writer, cols: List[str],
                     oids: Optional[List[int]] = None) -> None:
    payload = struct.pack(">h", len(cols))
    for i, c in enumerate(cols):
        oid = oids[i] if oids else TEXT_OID
        payload += _cstr(c) + struct.pack(">IhIhih", 0, 0, oid, -1, -1, 0)
    writer.write(_msg(b"T", payload))


def _result_oids(rows: List[tuple], ncols: int) -> List[int]:
    return [_infer_oid(r[i] for r in rows) for i in range(ncols)]


def _data_rows(writer, rows: List[tuple]) -> None:
    for row in rows:
        payload = struct.pack(">h", len(row))
        for v in row:
            if v is None:
                payload += struct.pack(">i", -1)
            else:
                if isinstance(v, bool):
                    s = b"t" if v else b"f"
                elif isinstance(v, (bytes, bytearray, memoryview)):
                    s = b"\\x" + bytes(v).hex().encode()
                else:
                    s = str(v).encode()
                payload += struct.pack(">i", len(s)) + s
        writer.write(_msg(b"D", payload))


async def _simple_query(writer, session: _Session, query: str) -> None:
    parts = [p for p in _split_statements(query) if p.strip()]
    if not parts:
        writer.write(_msg(b"I"))  # EmptyQueryResponse
        _ready(writer, session)
        return
    for part in parts:
        try:
            # off-loop so a concurrent CancelRequest (its own
            # connection, same event loop) can interrupt this query
            cols, rows, rc, tag = await asyncio.to_thread(
                session.execute, part
            )
        except Exception as e:
            if session.in_txn:
                session.txn_failed = True
            _error(writer, sqlstate_for(e), str(e))
            break
        if cols:
            _row_description(writer, cols, _result_oids(rows, len(cols)))
            _data_rows(writer, rows)
        writer.write(_msg(b"C", _cstr(tag)))
    _ready(writer, session)


def _bind(writer, session: _Session, b: _Buffer) -> None:
    portal, stmt = b.string(), b.string()
    nfmt = b.int16()
    fmts = [b.int16() for _ in range(nfmt)]
    nparams = b.int16()
    raw_params: List[Optional[bytes]] = []
    for i in range(nparams):
        ln = b.int32()
        raw_params.append(None if ln == -1 else b.read(ln))
    nrfmt = b.int16()
    rfmts = [b.int16() for _ in range(nrfmt)]
    if stmt not in session.stmts:
        _ext_error(writer, session, "26000",
                   f"unknown prepared statement {stmt!r}")
        return
    if any(f == 1 for f in rfmts):
        _ext_error(writer, session, "0A000",
                   "binary result format not supported")
        return
    oids = session.stmts[stmt][2]
    values: List = []
    for i, data in enumerate(raw_params):
        # per-protocol: 0 fmts = all text, 1 fmt = applies to all
        fmt = fmts[i] if len(fmts) == nparams else (fmts[0] if fmts else 0)
        oid = oids[i] if i < len(oids) else 0
        if data is None:
            values.append(None)
            continue
        try:
            values.append(_decode_param(data, oid, fmt))
        except (ValueError, struct.error) as e:
            # the stale portal must not survive a failed Bind: a
            # pipelined Execute would silently re-run the old statement
            session.portals.pop(portal, None)
            _ext_error(writer, session, "22P02", f"parameter ${i + 1}: {e}")
            return
    session.portals[portal] = {
        "stmt": stmt, "values": values, "described": False, "cached": None,
    }
    writer.write(_msg(b"2"))


async def _describe(writer, session: _Session, b: _Buffer) -> None:
    kind, name = b.read(1), b.string()
    if kind == b"S":
        if name not in session.stmts:
            _ext_error(writer, session, "26000",
                       f"unknown prepared statement {name!r}")
            return
        raw, tsql, oids = session.stmts[name]
        # real placeholder count (translate_query is literal-aware;
        # counting '?' would also count ones inside strings)
        order = translate_query(raw)[1]
        nparams = len(set(order))
        payload = struct.pack(">h", nparams)
        for i in range(nparams):
            payload += struct.pack(
                ">I", oids[i] if i < len(oids) and oids[i] else TEXT_OID
            )
        writer.write(_msg(b"t", payload))
        # probe result columns without executing: NULL-bound LIMIT 0
        if tsql and not _is_write(tsql) and "pg_catalog" not in tsql.lower():
            try:
                cols, _rows = session.agent.storage.read_query(
                    f"SELECT * FROM ({tsql.rstrip(';')}) LIMIT 0",
                    [None] * len(order),
                )
                if cols:
                    _row_description(writer, cols, [TEXT_OID] * len(cols))
                    return
            except Exception:
                pass
        if tsql and _is_write(tsql):
            ret_cols = (
                _ast_returning_columns(raw, session.agent)
                or _returning_columns(tsql, session.agent)
            )
            if ret_cols:
                _row_description(
                    writer, ret_cols, [TEXT_OID] * len(ret_cols)
                )
                return
        writer.write(_msg(b"n"))
        return
    # Describe(portal): params are bound, so the query can run NOW —
    # the RowDescription carries the real inferred OIDs and Execute
    # replays the cached result instead of emitting a second (protocol-
    # violating) RowDescription.
    entry = session.portals.get(name)
    if entry is None or entry["stmt"] not in session.stmts:
        _ext_error(writer, session, "34000", f"unknown portal {name!r}")
        return
    if entry.get("pending") is not None:
        # describing a SUSPENDED portal must not re-execute (that
        # would emit a RowDescription mid-result-set and strand a
        # duplicate cached copy); answer from the in-flight result
        cols = entry["pending"][0]
        if cols:
            _row_description(writer, cols, _result_oids(
                entry["pending"][1], len(cols)))
        else:
            writer.write(_msg(b"n"))
        return
    raw = session.stmts[entry["stmt"]][0]
    tsql_w = translate_sql(raw)
    if _is_write(tsql_w):
        # a RETURNING write's row shape is derivable from the clause
        # without executing — drivers decide their fetch path from
        # this Describe answer, so it must be RowDescription, not
        # NoData (real PG behaves the same); grammar-derived names
        # first, token heuristic for out-of-grammar statements
        ret_cols = (
            _ast_returning_columns(raw, session.agent)
            or _returning_columns(tsql_w, session.agent)
        )
        if ret_cols:
            _row_description(writer, ret_cols, [TEXT_OID] * len(ret_cols))
            entry["described"] = True
        else:
            writer.write(_msg(b"n"))
        return
    try:
        cols, rows, rc, tag = await asyncio.to_thread(
            session.execute, raw, tuple(entry["values"])
        )
    except Exception as e:
        if session.in_txn:
            session.txn_failed = True
        _ext_error(writer, session, sqlstate_for(e), str(e))
        return
    entry["described"] = True
    entry["cached"] = (cols, rows, rc, tag)
    if cols:
        _row_description(writer, cols, _result_oids(rows, len(cols)))
    else:
        writer.write(_msg(b"n"))


async def _execute_portal(writer, session: _Session, b: _Buffer) -> None:
    portal = b.string()
    max_rows = b.int32()  # 0 = no limit
    entry = session.portals.get(portal)
    if entry is None or entry["stmt"] not in session.stmts:
        _ext_error(writer, session, "34000", f"unknown portal {portal!r}")
        return
    if entry.get("pending") is not None:
        # resuming a suspended portal: continue the SAME result set,
        # no new RowDescription (corro-pg portal max-row suspension)
        cols, rows, rc, tag = entry["pending"]
        entry["pending"] = None
    elif entry["cached"] is not None:
        cols, rows, rc, tag = entry["cached"]
        entry["cached"] = None
    else:
        raw = session.stmts[entry["stmt"]][0]
        try:
            cols, rows, rc, tag = await asyncio.to_thread(
                session.execute, raw, tuple(entry["values"])
            )
        except Exception as e:
            if session.in_txn:
                session.txn_failed = True
            _ext_error(writer, session, sqlstate_for(e), str(e))
            return
    if cols:
        if not entry["described"]:
            _row_description(writer, cols, _result_oids(rows, len(cols)))
            entry["described"] = True  # once per portal result set
        if max_rows > 0 and len(rows) > max_rows:
            _data_rows(writer, rows[:max_rows])
            entry["pending"] = (cols, rows[max_rows:], rc, tag)
            writer.write(_msg(b"s"))  # PortalSuspended
            return
        _data_rows(writer, rows)
    writer.write(_msg(b"C", _cstr(tag)))


