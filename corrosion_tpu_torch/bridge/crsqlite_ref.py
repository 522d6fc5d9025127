"""Golden-reference bridge to the real cr-sqlite extension.

The reference agent gets its CRDT semantics from a vendored native
cr-sqlite build (loaded at ``crates/corro-types/src/sqlite.rs:103-121``).
Our engine (:mod:`corrosion_tpu_torch.agent.storage`) re-implements those
semantics over stock sqlite3.  This bridge loads the *actual* vendored
``crsqlite-linux-x86_64.so`` into a Python ``sqlite3`` connection so
property tests can replay identical op sequences on both engines and
assert the final replicated states bit-match (the golden test).

Only used by tests/tools; the agent never depends on the extension.
"""

from __future__ import annotations

import os
import sqlite3
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

# Candidate locations for the vendored extension (first hit wins):
# CRSQLITE_SO, then the blob's place in this repository, beside the
# packages (the reference checks in prebuilt blobs under
# crates/corro-types/).
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SO_CANDIDATES = (
    os.environ.get("CRSQLITE_SO", ""),
    os.path.join(_REPO, "crates", "corro-types", "crsqlite-linux-x86_64.so"),
)

# Column list of the crsql_changes virtual table, in the order the reference
# reads and writes it (corro-agent/src/agent/util.rs:1314-1317).
CHANGES_COLS = (
    '"table"', "pk", "cid", "val", "col_version", "db_version",
    "site_id", "cl", "seq",
)
_SELECT_CHANGES = (
    f"SELECT {', '.join(CHANGES_COLS)} FROM crsql_changes"
)
_INSERT_CHANGES = (
    f"INSERT INTO crsql_changes ({', '.join(CHANGES_COLS)}) "
    "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)"
)


def find_crsqlite_so() -> Optional[str]:
    for cand in _SO_CANDIDATES:
        if cand and os.path.exists(cand):
            return cand
    return None


def crsqlite_available() -> bool:
    if find_crsqlite_so() is None:
        return False
    # Broad catch: loading can fail with TypeError (< 3.12: no `entrypoint`
    # kwarg), AttributeError (no loadable-extension support), or
    # sqlite3.Error — all mean "skip the golden tests", not "crash".
    conn = None
    try:
        conn = _connect(":memory:")
        return True
    except Exception:
        return False
    finally:
        if conn is not None:
            conn.close()


def _connect(path: str) -> sqlite3.Connection:
    so = find_crsqlite_so()
    if so is None:
        raise FileNotFoundError("cr-sqlite extension not found (set CRSQLITE_SO)")
    conn = sqlite3.connect(path, check_same_thread=False)
    conn.isolation_level = None  # explicit transactions only
    conn.enable_load_extension(True)
    # The filename-derived entrypoint would be sqlite3_crsqlitelinuxx_init;
    # the real symbol is the canonical one.
    conn.load_extension(os.path.splitext(so)[0], entrypoint="sqlite3_crsqlite_init")
    conn.enable_load_extension(False)
    return conn


class CrsqliteRef:
    """A replica backed by the real cr-sqlite extension.

    Mirrors the surface of :class:`corrosion_tpu_torch.agent.storage.CrConn`
    that the golden tests drive: schema setup, transactional writes,
    change collection, change application, and table reads.
    """

    def __init__(self, path: str = ":memory:"):
        self.conn = _connect(path)
        self.site_id: bytes = bytes(
            self.conn.execute("SELECT crsql_site_id()").fetchone()[0]
        )

    @contextmanager
    def tx(self):
        """One explicit transaction == one db_version (like CrConn.write_tx)."""
        self.conn.execute("BEGIN IMMEDIATE")
        try:
            yield self.conn
        except BaseException:
            self.conn.execute("ROLLBACK")
            raise
        self.conn.execute("COMMIT")

    def execute(self, sql: str, params: Sequence = ()):
        with self.tx() as conn:
            return conn.execute(sql, params)

    def as_crr(self, table: str) -> None:
        self.conn.execute("SELECT crsql_as_crr(?)", (table,))

    def db_version(self) -> int:
        return self.conn.execute("SELECT crsql_db_version()").fetchone()[0]

    def changes(self, since_db_version: int = 0) -> List[Tuple]:
        """All change rows this replica knows (any origin site), raw."""
        return self.conn.execute(
            _SELECT_CHANGES + " WHERE db_version > ? ORDER BY db_version, seq",
            (since_db_version,),
        ).fetchall()

    def apply(self, rows: Sequence[Tuple]) -> None:
        """Merge raw change rows (the INSERT side of crsql_changes)."""
        with self.tx() as conn:
            conn.executemany(_INSERT_CHANGES, rows)

    def data(self, table: str) -> List[Tuple]:
        """Full table contents in a canonical (rowid-independent) order."""
        cur = self.conn.execute(f'SELECT * FROM "{table}"')
        return sorted(cur.fetchall(), key=_sort_key)

    def close(self) -> None:
        try:
            self.conn.execute("SELECT crsql_finalize()")
        except sqlite3.Error:
            pass
        self.conn.close()


def _sort_key(row: Tuple):
    # total order across heterogenous sqlite values
    return tuple(
        (0, "") if v is None
        else (1, float(v)) if isinstance(v, (int, float))
        else (2, v) if isinstance(v, str)
        else (3, bytes(v).hex())
        for v in row
    )
