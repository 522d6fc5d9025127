"""Schema management: constrained CREATE TABLE application + migration.

Parity: ``crates/corro-types/src/schema.rs`` — the reference parses the
user's schema SQL, **constrains** it (``schema.rs:115-172``: no foreign
keys, no unique indexes, every NOT NULL column needs a DEFAULT, primary
keys must be plain columns), then diffs against the live schema and
migrates (``apply_schema``, ``schema.rs:276-530``: new tables become CRRs,
new columns are added in place, destructive changes are rejected).

Design: instead of a SQL AST parser we apply the candidate schema to a
scratch in-memory database and introspect it with PRAGMAs — the database
itself is the parser.  The same introspection drives the diff.
"""

from __future__ import annotations

import re
import sqlite3
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class SchemaError(Exception):
    pass


@dataclass(frozen=True)
class Column:
    name: str
    type: str
    notnull: bool
    default: Optional[str]
    pk_index: int  # 0 = not part of pk


@dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[Column, ...]
    sql: str

    @property
    def pk_cols(self) -> Tuple[str, ...]:
        return tuple(
            c.name for c in sorted(
                (c for c in self.columns if c.pk_index), key=lambda c: c.pk_index
            )
        )


@dataclass(frozen=True)
class Schema:
    tables: Dict[str, TableSchema]
    # non-unique secondary indexes: name -> CREATE INDEX sql
    # (schema.rs applies these alongside tables; unique ones are
    # rejected by constrain())
    indexes: Dict[str, str] = None  # type: ignore[assignment]


def parse_schema(sql: str) -> Schema:
    """Apply the schema SQL to a scratch db and introspect the result."""
    scratch = sqlite3.connect(":memory:")
    try:
        try:
            scratch.executescript(sql)
        except sqlite3.Error as e:
            raise SchemaError(f"schema SQL failed: {e}") from e
        return _introspect(scratch)
    finally:
        scratch.close()


# the CRR machinery interpolates table/column names into bookkeeping
# DDL and cached hot-path SQL as plain quoted identifiers — word
# identifiers only, enforced HERE so a hostile schema (user input via
# config or the schema API) is rejected cleanly at apply time instead
# of surfacing as a SQL syntax error mid-introspection (or worse,
# splicing into trigger bodies)
_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _introspect(conn: sqlite3.Connection) -> Schema:
    tables: Dict[str, TableSchema] = {}
    for name, create_sql in conn.execute(
        "SELECT name, sql FROM sqlite_master WHERE type='table' "
        "AND name NOT LIKE 'sqlite_%' AND name NOT LIKE '\\_\\_corro\\_%' ESCAPE '\\'"
    ).fetchall():
        if not _IDENT_RE.match(name):
            raise SchemaError(
                f"table name {name!r} is not a plain identifier "
                "([A-Za-z_][A-Za-z0-9_]*): quoted/special names cannot "
                "be CRRs"
            )
        cols = []
        for cid, cname, ctype, notnull, dflt, pk in conn.execute(
            f'PRAGMA table_info("{name}")'
        ):
            if not _IDENT_RE.match(cname):
                raise SchemaError(
                    f"table {name}: column name {cname!r} is not a "
                    "plain identifier"
                )
            cols.append(
                Column(
                    name=cname,
                    type=(ctype or "").upper(),
                    notnull=bool(notnull),
                    default=dflt,
                    pk_index=pk,
                )
            )
        tables[name] = TableSchema(name=name, columns=tuple(cols), sql=create_sql)
    # CRR bookkeeping lives in "<table>__corro_*" tables/indexes —
    # substring match, or re-applying a schema would drop them
    indexes = dict(
        conn.execute(
            "SELECT name, sql FROM sqlite_master WHERE type='index' "
            "AND sql IS NOT NULL AND name NOT LIKE 'sqlite_%' "
            "AND name NOT LIKE '%\\_\\_corro\\_%' ESCAPE '\\' "
            "AND tbl_name NOT LIKE '%\\_\\_corro\\_%' ESCAPE '\\'"
        ).fetchall()
    )
    return Schema(tables=tables, indexes=indexes)


def constrain(schema: Schema, scratch_sql: str) -> None:
    """Reject schema constructs that can't replicate conflict-free."""
    scratch = sqlite3.connect(":memory:")
    try:
        scratch.executescript(scratch_sql)
        for name, ts in schema.tables.items():
            if not ts.pk_cols:
                raise SchemaError(f"table {name}: a primary key is required")
            fks = scratch.execute(f'PRAGMA foreign_key_list("{name}")').fetchall()
            if fks:
                raise SchemaError(
                    f"table {name}: foreign keys are not supported in CRR tables"
                )
            for idx_name, unique, origin in (
                (r[1], r[2], r[3])
                for r in scratch.execute(f'PRAGMA index_list("{name}")')
            ):
                # origin 'pk' is the implicit primary-key index; explicit
                # UNIQUE constraints/indexes can't merge deterministically
                if unique and origin != "pk":
                    raise SchemaError(
                        f"table {name}: unique index {idx_name} is not "
                        "supported in CRR tables"
                    )
            for col in ts.columns:
                if col.pk_index:
                    if not col.notnull:
                        raise SchemaError(
                            f"table {name}: primary key column {col.name} "
                            "must be NOT NULL"
                        )
                    continue
                if col.notnull and col.default is None:
                    raise SchemaError(
                        f"table {name}: NOT NULL column {col.name} needs a "
                        "DEFAULT for conflict-free replication"
                    )
    finally:
        scratch.close()


def apply_schema(cr_conn, sql: str) -> List[str]:
    """Create/migrate CRR tables from a schema file's SQL.

    Returns the list of touched table names.  New tables are created and
    marked CRR; existing tables gain missing columns via ALTER TABLE ADD
    COLUMN; column removals/type changes are rejected.
    """
    target = parse_schema(sql)
    constrain(target, sql)
    live = _introspect(cr_conn.conn)
    touched: List[str] = []
    for name, ts in target.tables.items():
        if name not in live.tables:
            cr_conn.conn.execute(ts.sql)
            cr_conn.as_crr(name)
            touched.append(name)
            continue
        have = {c.name: c for c in live.tables[name].columns}
        want = {c.name: c for c in ts.columns}
        removed = set(have) - set(want)
        if removed:
            raise SchemaError(
                f"table {name}: dropping columns is not supported "
                f"({', '.join(sorted(removed))})"
            )
        added = [c for cn, c in want.items() if cn not in have]
        for c in added:
            if c.pk_index:
                raise SchemaError(
                    f"table {name}: cannot add primary key column {c.name}"
                )
            decl = f'"{c.name}" {c.type}'
            if c.notnull:
                if c.default is None:
                    raise SchemaError(
                        f"table {name}: new NOT NULL column {c.name} needs "
                        "a DEFAULT"
                    )
                decl += f" NOT NULL DEFAULT {c.default}"
            elif c.default is not None:
                decl += f" DEFAULT {c.default}"
            cr_conn.conn.execute(f'ALTER TABLE "{name}" ADD COLUMN {decl}')
            touched.append(name)
        if added:
            # refresh triggers to cover the new columns
            cr_conn.as_crr(name)
    # secondary (non-unique) indexes follow the schema file like
    # tables do (schema.rs:276-530): new ones are created, removed or
    # redefined ones are dropped (+ recreated)
    for iname, isql in sorted((target.indexes or {}).items()):
        if live.indexes.get(iname) == isql:
            continue
        if iname in (live.indexes or {}):
            cr_conn.conn.execute(f'DROP INDEX IF EXISTS "{iname}"')
        cr_conn.conn.execute(isql)
    for iname in sorted(set(live.indexes or {}) - set(target.indexes or {})):
        cr_conn.conn.execute(f'DROP INDEX IF EXISTS "{iname}"')
    return touched
