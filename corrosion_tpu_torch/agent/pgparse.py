"""Recursive-descent PG statement parser + SQLite emitter.

Parity: the reference parses client SQL with ``sqlparser`` into a full
AST and re-emits a SQLite AST (``corro-pg/src/lib.rs:324-330``, the
~6k-line translation walk).  This module is the same architecture over
the ``agent/pgsql.py`` lexer: a recursive-descent grammar for the
statements a SQL client actually sends — SELECT (joins, subqueries,
compounds, CTEs), INSERT (multi-row VALUES, SELECT source, ON
CONFLICT, RETURNING), UPDATE (SET, FROM, RETURNING), DELETE (USING,
RETURNING) — producing typed nodes that downstream code *queries*
instead of regex-probing: statement class (read/write), the referenced
tables (catalog routing), RETURNING column names, and the command tag
all come from the AST.

Expressions are parsed structurally (balanced, clause-bounded, with
embedded sub-SELECTs lifted into real nodes so their table refs are
visible) and carried as token runs; emission re-applies the shared
PG→SQLite token transforms (``pgsql.transform_tokens``: ``$N`` → ``?``
with order, ``::type`` casts, ``E''``/dollar strings, ``now()``,
``ILIKE``) per run — one transform implementation for both pipelines.

Out-of-grammar statements raise :class:`Unsupported`; the session
falls back to the token-pass translation (counted by a metric), so a
parser gap degrades to the token pass instead of an error.
PG-only clauses with no SQLite meaning are *dropped with intent*:
``FOR UPDATE/SHARE`` row locking (single-writer storage) and ``ONLY``
table modifiers (no inheritance).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from corrosion_tpu_torch.agent.pgsql import (
    PgSqlError,
    tokenize,
    transform_tokens,
)


class Unsupported(Exception):
    """Statement shape outside the grammar: caller falls back."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class QName:
    parts: List[str]  # ["public", "t"] or ["t"]; qidents keep quotes

    @property
    def base(self) -> str:
        return self.parts[-1].strip('"').lower()

    @property
    def schema(self) -> Optional[str]:
        return (
            self.parts[-2].strip('"').lower()
            if len(self.parts) > 1 else None
        )


# an expression is a run of lexer tokens with sub-SELECTs lifted out:
# elements are ("t", kind, text) or ("q", Select)
Expr = List[tuple]


@dataclass
class FromItem:
    name: Optional[QName] = None  # table reference
    select: Optional["Select"] = None  # (subquery)
    alias: Optional[str] = None


@dataclass
class Join:
    jtype: str  # "JOIN" / "LEFT JOIN" / "CROSS JOIN" / "," ...
    item: FromItem = None  # type: ignore[assignment]
    on: Optional[Expr] = None
    using: Optional[List[str]] = None


@dataclass
class SelectCore:
    distinct: bool = False
    items: List[Tuple[Expr, Optional[str]]] = field(default_factory=list)
    from_items: List[FromItem] = field(default_factory=list)
    joins: List[Join] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    # VALUES core instead of SELECT core
    values: Optional[List[List[Expr]]] = None


@dataclass
class Select:
    ctes: List[Tuple[str, Optional[List[str]], "Select"]] = field(
        default_factory=list
    )
    recursive: bool = False
    core: SelectCore = None  # type: ignore[assignment]
    compounds: List[Tuple[str, SelectCore]] = field(default_factory=list)
    order_by: List[Expr] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None


@dataclass
class Insert:
    ctes: List = field(default_factory=list)
    recursive: bool = False
    table: QName = None  # type: ignore[assignment]
    alias: Optional[str] = None
    columns: Optional[List[str]] = None
    values: Optional[List[List[Expr]]] = None
    select: Optional[Select] = None
    default_values: bool = False
    conflict_target: Optional[List[str]] = None
    conflict_action: Optional[str] = None  # "nothing" | "update"
    conflict_sets: List[Tuple[str, Expr]] = field(default_factory=list)
    conflict_where: Optional[Expr] = None
    returning: Optional[List[Tuple[Expr, Optional[str]]]] = None


@dataclass
class Update:
    ctes: List = field(default_factory=list)
    recursive: bool = False
    table: QName = None  # type: ignore[assignment]
    alias: Optional[str] = None
    sets: List[Tuple[str, Expr]] = field(default_factory=list)
    from_items: List[FromItem] = field(default_factory=list)
    joins: List[Join] = field(default_factory=list)
    where: Optional[Expr] = None
    returning: Optional[List[Tuple[Expr, Optional[str]]]] = None


@dataclass
class Delete:
    ctes: List = field(default_factory=list)
    recursive: bool = False
    table: QName = None  # type: ignore[assignment]
    alias: Optional[str] = None
    using: List[FromItem] = field(default_factory=list)
    where: Optional[Expr] = None
    returning: Optional[List[Tuple[Expr, Optional[str]]]] = None


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_COMPOUND_OPS = ("UNION", "INTERSECT", "EXCEPT")
_JOIN_WORDS = ("JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS")
# clause heads that end an expression at depth 0
_CLAUSE_STOPS = frozenset((
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET",
    "RETURNING", "ON", "USING", "SET", "VALUES", "UNION", "INTERSECT",
    "EXCEPT", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS",
    "NATURAL", "WINDOW", "FETCH", "FOR", "AS", "DO",
))


class _P:
    def __init__(self, sql: str):
        try:
            self.toks = [
                t for t in tokenize(sql) if t[0] not in ("ws", "comment")
            ]
        except PgSqlError as e:
            raise Unsupported(str(e))
        self.i = 0

    # -- stream ----------------------------------------------------------

    def peek(self, ahead: int = 0):
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else (None, None)

    def at_word(self, *words: str, ahead: int = 0) -> bool:
        k, t = self.peek(ahead)
        return k == "word" and t.upper() in words

    def at_op(self, op: str) -> bool:
        k, t = self.peek()
        return k == "op" and t == op

    def take(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_word(self, *words: str) -> str:
        if not self.at_word(*words):
            raise Unsupported(f"expected {'/'.join(words)} at {self.peek()}")
        return self.take()[1]

    def expect_op(self, op: str) -> None:
        if not self.at_op(op):
            raise Unsupported(f"expected {op!r} at {self.peek()}")
        self.take()

    def done(self) -> bool:
        return self.i >= len(self.toks) or (
            self.at_op(";") and self.i == len(self.toks) - 1
        )

    # -- terminals -------------------------------------------------------

    def ident(self) -> str:
        k, t = self.peek()
        if k == "word":
            if t.upper() in _CLAUSE_STOPS:
                raise Unsupported(f"identifier expected, got {t!r}")
            return self.take()[1]
        if k == "qident":
            return self.take()[1]
        raise Unsupported(f"identifier expected at {self.peek()}")

    def qname(self) -> QName:
        parts = [self.ident()]
        while self.at_op("."):
            self.take()
            parts.append(self.ident())
        if len(parts) > 3:
            raise Unsupported("name too qualified")
        return QName(parts)

    def opt_alias(self) -> Optional[str]:
        if self.at_word("AS"):
            self.take()
            return self.ident()
        k, t = self.peek()
        if k == "qident":
            return self.take()[1]
        if k == "word" and t.upper() not in _CLAUSE_STOPS and not self.at_word(
            *_COMPOUND_OPS
        ):
            return self.take()[1]
        return None

    def col_list(self) -> List[str]:
        self.expect_op("(")
        cols = [self.ident()]
        while self.at_op(","):
            self.take()
            cols.append(self.ident())
        self.expect_op(")")
        return cols

    # -- expressions -----------------------------------------------------

    def expr(self, stop_commas: bool = False) -> Expr:
        """Collect one expression: balanced token run ending at a
        depth-0 clause head (or comma when ``stop_commas``); descends
        into parens, lifting ``(SELECT ...)`` into Select nodes."""
        out: Expr = []
        started = False
        while True:
            k, t = self.peek()
            if k is None:
                break
            if k == "op" and t == ";":
                break
            if k == "op" and t == ")":
                break
            if stop_commas and k == "op" and t == ",":
                break
            if started and k == "word" and t.upper() in _CLAUSE_STOPS:
                break
            if not started and k == "word" and t.upper() in (
                "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT",
                "RETURNING",
            ):
                break
            if k == "op" and t == "(":
                self.take()
                if self.at_word("SELECT", "VALUES", "WITH"):
                    sub = self.select_stmt()
                    self.expect_op(")")
                    out.append(("q", sub))
                else:
                    out.append(("t", "op", "("))
                    out.extend(self._expr_group())
                    self.expect_op(")")
                    out.append(("t", "op", ")"))
                started = True
                continue
            if k == "word" and t.upper() == "CASE":
                out.extend(self._case_expr())
                started = True
                continue
            out.append(("t", k, t))
            self.take()
            started = True
        if not out:
            raise Unsupported(f"empty expression at {self.peek()}")
        return out

    def _expr_group(self) -> Expr:
        """Tokens inside parens up to the matching close, sub-SELECTs
        lifted, nested parens recursed."""
        out: Expr = []
        while True:
            k, t = self.peek()
            if k is None:
                raise Unsupported("unbalanced parens")
            if k == "op" and t == ")":
                return out
            if k == "op" and t == "(":
                self.take()
                if self.at_word("SELECT", "VALUES", "WITH"):
                    sub = self.select_stmt()
                    self.expect_op(")")
                    out.append(("q", sub))
                else:
                    out.append(("t", "op", "("))
                    out.extend(self._expr_group())
                    self.expect_op(")")
                    out.append(("t", "op", ")"))
                continue
            out.append(("t", k, t))
            self.take()

    def _case_expr(self) -> Expr:
        """CASE ... END consumed whole (WHEN/THEN/ELSE are not clause
        stops inside it)."""
        self.take()  # CASE
        out: Expr = [("t", "word", "CASE")]
        depth = 1
        while depth:
            k, t = self.peek()
            if k is None:
                raise Unsupported("unterminated CASE")
            if k == "word" and t.upper() == "CASE":
                depth += 1
            elif k == "word" and t.upper() == "END":
                depth -= 1
            if k == "op" and t == "(":
                self.take()
                if self.at_word("SELECT", "VALUES", "WITH"):
                    sub = self.select_stmt()
                    self.expect_op(")")
                    out.append(("q", sub))
                else:
                    out.append(("t", "op", "("))
                    out.extend(self._expr_group())
                    self.expect_op(")")
                    out.append(("t", "op", ")"))
                continue
            out.append(("t", k, t))
            self.take()
        return out

    # -- select ----------------------------------------------------------

    def with_clause(self):
        ctes = []
        recursive = False
        if self.at_word("WITH"):
            self.take()
            if self.at_word("RECURSIVE"):
                self.take()
                recursive = True
            while True:
                name = self.ident()
                cols = None
                if self.at_op("("):
                    cols = self.col_list()
                self.expect_word("AS")
                # MATERIALIZED hints: drop (sqlite decides itself)
                if self.at_word("NOT"):
                    self.take()
                    self.expect_word("MATERIALIZED")
                elif self.at_word("MATERIALIZED"):
                    self.take()
                self.expect_op("(")
                if not self.at_word("SELECT", "VALUES", "WITH"):
                    raise Unsupported("non-SELECT CTE body")
                body = self.select_stmt()
                self.expect_op(")")
                ctes.append((name, cols, body))
                if self.at_op(","):
                    self.take()
                    continue
                break
        return ctes, recursive

    def select_stmt(self, ctes=None, recursive=False) -> Select:
        if ctes is None:
            ctes, recursive = self.with_clause()
        node = Select(ctes=ctes, recursive=recursive)
        node.core = self.select_core()
        while self.at_word(*_COMPOUND_OPS):
            op = self.take()[1].upper()
            if self.at_word("ALL", "DISTINCT"):
                op += " " + self.take()[1].upper()
            node.compounds.append((op, self.select_core()))
        if self.at_word("ORDER"):
            self.take()
            self.expect_word("BY")
            node.order_by.append(self.expr(stop_commas=True))
            while self.at_op(","):
                self.take()
                node.order_by.append(self.expr(stop_commas=True))
        if self.at_word("LIMIT"):
            self.take()
            if self.at_word("ALL"):
                self.take()
            else:
                node.limit = self.expr(stop_commas=True)
        if self.at_word("OFFSET"):
            self.take()
            node.offset = self.expr(stop_commas=True)
            if self.at_word("ROW", "ROWS"):
                self.take()
        if self.at_word("FETCH"):
            raise Unsupported("FETCH FIRST")
        if self.at_word("FOR"):
            # FOR UPDATE / FOR SHARE [OF ...] [NOWAIT|SKIP LOCKED]:
            # dropped — storage is single-writer, there are no row locks
            self.take()
            while not self.done() and not self.at_op(")"):
                self.take()
        return node

    def select_core(self) -> SelectCore:
        core = SelectCore()
        if self.at_op("("):
            self.take()
            inner = self.select_stmt()
            self.expect_op(")")
            if inner.ctes or inner.compounds or inner.order_by or \
                    inner.limit or inner.offset:
                raise Unsupported("parenthesized compound member")
            return inner.core
        if self.at_word("VALUES"):
            self.take()
            core.values = [self._values_row()]
            while self.at_op(","):
                self.take()
                core.values.append(self._values_row())
            return core
        self.expect_word("SELECT")
        if self.at_word("ALL"):
            self.take()
        elif self.at_word("DISTINCT"):
            self.take()
            if self.at_word("ON"):
                raise Unsupported("DISTINCT ON")
            core.distinct = True
        while True:
            if self.at_op("*"):
                self.take()
                core.items.append(([("t", "op", "*")], None))
            else:
                e = self.expr(stop_commas=True)
                # tbl.* projections arrive as expr tokens — fine
                core.items.append((e, self._item_alias()))
            if self.at_op(","):
                self.take()
                continue
            break
        if self.at_word("FROM"):
            self.take()
            self._from_clause(core)
        if self.at_word("WHERE"):
            self.take()
            core.where = self.expr()
        if self.at_word("GROUP"):
            self.take()
            self.expect_word("BY")
            core.group_by.append(self.expr(stop_commas=True))
            while self.at_op(","):
                self.take()
                core.group_by.append(self.expr(stop_commas=True))
        if self.at_word("HAVING"):
            self.take()
            core.having = self.expr()
        if self.at_word("WINDOW"):
            raise Unsupported("WINDOW clause")
        return core

    def _values_row(self) -> List[Expr]:
        self.expect_op("(")
        row = [self.expr(stop_commas=True)]
        while self.at_op(","):
            self.take()
            row.append(self.expr(stop_commas=True))
        self.expect_op(")")
        return row

    def _item_alias(self) -> Optional[str]:
        if self.at_word("AS"):
            self.take()
            return self.ident()
        k, t = self.peek()
        if k == "qident":
            return self.take()[1]
        if k == "word" and t.upper() not in _CLAUSE_STOPS:
            return self.take()[1]
        return None

    def _from_item(self) -> FromItem:
        if self.at_op("("):
            self.take()
            if self.at_word("SELECT", "VALUES", "WITH"):
                sub = self.select_stmt()
                self.expect_op(")")
                alias = self.opt_alias()
                if alias and self.at_op("("):
                    raise Unsupported("column aliases on subquery")
                return FromItem(select=sub, alias=alias)
            raise Unsupported("parenthesized join in FROM")
        if self.at_word("ONLY"):
            self.take()  # no table inheritance: ONLY is a no-op
        if self.at_word("LATERAL"):
            raise Unsupported("LATERAL")
        name = self.qname()
        if self.at_op("("):
            raise Unsupported("table function in FROM")
        alias = self.opt_alias()
        return FromItem(name=name, alias=alias)

    def _from_clause(self, core) -> None:
        core.from_items.append(self._from_item())
        while True:
            if self.at_op(","):
                self.take()
                core.joins.append(Join(",", self._from_item()))
                continue
            if self.at_word("NATURAL"):
                raise Unsupported("NATURAL JOIN")
            if self.at_word(*_JOIN_WORDS):
                jt = [self.take()[1].upper()]
                if jt[0] in ("LEFT", "RIGHT", "FULL") and self.at_word(
                    "OUTER"
                ):
                    self.take()
                if jt[0] != "JOIN":
                    jt.append(self.expect_word("JOIN"))
                jtype = " ".join(
                    w if w == "JOIN" else w for w in jt
                )
                item = self._from_item()
                j = Join(jtype, item)
                if self.at_word("ON"):
                    self.take()
                    j.on = self.expr()
                elif self.at_word("USING"):
                    self.take()
                    j.using = self.col_list()
                elif "CROSS" not in jtype:
                    raise Unsupported("JOIN without ON/USING")
                core.joins.append(j)
                continue
            break

    # -- DML -------------------------------------------------------------

    def returning_clause(self):
        if not self.at_word("RETURNING"):
            return None
        self.take()
        items = []
        while True:
            if self.at_op("*"):
                self.take()
                items.append(([("t", "op", "*")], None))
            else:
                e = self.expr(stop_commas=True)
                items.append((e, self._item_alias()))
            if self.at_op(","):
                self.take()
                continue
            break
        return items

    def insert_stmt(self, ctes) -> Insert:
        self.expect_word("INSERT")
        self.expect_word("INTO")
        node = Insert(ctes=ctes, table=self.qname())
        if self.at_word("AS"):
            self.take()
            node.alias = self.ident()
        if self.at_op("("):
            node.columns = self.col_list()
        if self.at_word("DEFAULT"):
            self.take()
            self.expect_word("VALUES")
            node.default_values = True
        elif self.at_word("VALUES"):
            self.take()
            node.values = [self._values_row()]
            while self.at_op(","):
                self.take()
                node.values.append(self._values_row())
        elif self.at_word("SELECT", "WITH") or self.at_op("("):
            node.select = self.select_stmt()
        else:
            raise Unsupported("INSERT source")
        if self.at_word("ON"):
            self.take()
            self.expect_word("CONFLICT")
            if self.at_op("("):
                node.conflict_target = self.col_list()
                if self.at_word("WHERE"):
                    raise Unsupported("partial conflict target")
            elif self.at_word("ON"):
                raise Unsupported("ON CONSTRAINT")
            self.expect_word("DO")
            if self.at_word("NOTHING"):
                self.take()
                node.conflict_action = "nothing"
            else:
                self.expect_word("UPDATE")
                self.expect_word("SET")
                node.conflict_action = "update"
                node.conflict_sets.append(self._set_item())
                while self.at_op(","):
                    self.take()
                    node.conflict_sets.append(self._set_item())
                if self.at_word("WHERE"):
                    self.take()
                    node.conflict_where = self.expr()
        node.returning = self.returning_clause()
        return node

    def _set_item(self):
        if self.at_op("("):
            raise Unsupported("multi-column SET")
        col = self.ident()
        self.expect_op("=")
        return (col, self.expr(stop_commas=True))

    def update_stmt(self, ctes) -> Update:
        self.expect_word("UPDATE")
        if self.at_word("ONLY"):
            self.take()
        node = Update(ctes=ctes, table=self.qname())
        node.alias = None
        if self.at_word("AS"):
            self.take()
            node.alias = self.ident()
        elif not self.at_word("SET"):
            k, t = self.peek()
            if k in ("word", "qident"):
                node.alias = self.ident()
        self.expect_word("SET")
        node.sets.append(self._set_item())
        while self.at_op(","):
            self.take()
            node.sets.append(self._set_item())
        if self.at_word("FROM"):
            self.take()
            self._from_clause(node)
        if self.at_word("WHERE"):
            self.take()
            node.where = self.expr()
        node.returning = self.returning_clause()
        return node

    def delete_stmt(self, ctes) -> Delete:
        self.expect_word("DELETE")
        self.expect_word("FROM")
        if self.at_word("ONLY"):
            self.take()
        node = Delete(ctes=ctes, table=self.qname())
        node.alias = self.opt_alias()
        if self.at_word("USING"):
            self.take()
            node.using.append(self._from_item())
            while self.at_op(","):
                self.take()
                node.using.append(self._from_item())
        if self.at_word("WHERE"):
            self.take()
            node.where = self.expr()
        node.returning = self.returning_clause()
        return node

    def statement(self):
        ctes, recursive = self.with_clause()
        if self.at_word("SELECT", "VALUES") or self.at_op("("):
            node = self.select_stmt(ctes, recursive)
        elif self.at_word("INSERT"):
            node = self.insert_stmt(ctes)
            node.recursive = recursive
        elif self.at_word("UPDATE"):
            node = self.update_stmt(ctes)
            node.recursive = recursive
        elif self.at_word("DELETE"):
            node = self.delete_stmt(ctes)
            node.recursive = recursive
        else:
            raise Unsupported(f"statement head {self.peek()}")
        if not self.done():
            raise Unsupported(f"trailing tokens at {self.peek()}")
        return node


def parse_statement(sql: str):
    """Parse ONE statement into an AST node, or raise Unsupported."""
    return _P(sql).statement()


# ---------------------------------------------------------------------------
# AST queries
# ---------------------------------------------------------------------------


def table_refs(node) -> List[QName]:
    """Every table the statement references (targets, FROM items,
    joins, sub-SELECTs, CTE bodies) — CTE names themselves are NOT
    tables; they shadow same-named tables LEXICALLY (only within the
    statement that defines them and its descendants, never siblings)."""
    out: List[QName] = []

    def walk_expr(e: Optional[Expr], shadow: frozenset):
        for el in e or ():
            if el[0] == "q":
                walk(el[1], shadow)

    def walk_core(core: SelectCore, shadow: frozenset):
        for fi in core.from_items:
            walk_from(fi, shadow)
        for j in core.joins:
            walk_from(j.item, shadow)
            walk_expr(j.on, shadow)
        for e, _a in core.items:
            walk_expr(e, shadow)
        walk_expr(core.where, shadow)
        for e in core.group_by:
            walk_expr(e, shadow)
        walk_expr(core.having, shadow)
        for row in core.values or ():
            for e in row:
                walk_expr(e, shadow)

    def walk_from(fi: FromItem, shadow: frozenset):
        if fi.name is not None:
            if not (len(fi.name.parts) == 1 and fi.name.base in shadow):
                out.append(fi.name)
        if fi.select is not None:
            walk(fi.select, shadow)

    def walk(n, shadow: frozenset):
        rec = getattr(n, "recursive", False)
        for name, _cols, body in getattr(n, "ctes", ()) or ():
            body_shadow = shadow
            if rec:
                # WITH RECURSIVE: the CTE's own name IS visible inside
                # its body (the self-reference is not a table)
                body_shadow = shadow | {name.strip('"').lower()}
            walk(body, body_shadow)
            # earlier CTEs are visible to later ones + the main body
            shadow = shadow | {name.strip('"').lower()}
        if isinstance(n, Select):
            walk_core(n.core, shadow)
            for _op, c in n.compounds:
                walk_core(c, shadow)
            for e in n.order_by:
                walk_expr(e, shadow)
            walk_expr(n.limit, shadow)
            walk_expr(n.offset, shadow)
        elif isinstance(n, Insert):
            out.append(n.table)
            if n.select is not None:
                walk(n.select, shadow)
            for row in n.values or ():
                for e in row:
                    walk_expr(e, shadow)
            for _c, e in n.conflict_sets:
                walk_expr(e, shadow)
            walk_expr(n.conflict_where, shadow)
            for e, _a in n.returning or ():
                walk_expr(e, shadow)
        elif isinstance(n, Update):
            out.append(n.table)
            for _c, e in n.sets:
                walk_expr(e, shadow)
            for fi in n.from_items:
                walk_from(fi, shadow)
            for j in n.joins:
                walk_from(j.item, shadow)
                walk_expr(j.on, shadow)
            walk_expr(n.where, shadow)
            for e, _a in n.returning or ():
                walk_expr(e, shadow)
        elif isinstance(n, Delete):
            out.append(n.table)
            for fi in n.using:
                walk_from(fi, shadow)
            walk_expr(n.where, shadow)
            for e, _a in n.returning or ():
                walk_expr(e, shadow)

    walk(node, frozenset())
    return out


def returning_names(node, star_columns) -> Optional[List[str]]:
    """RETURNING column labels: alias, else the last identifier of the
    expression, else the expression text; ``*`` expands via
    ``star_columns(table_base_name)``."""
    items = getattr(node, "returning", None)
    if items is None:
        return None
    names: List[str] = []
    for e, alias in items:
        if alias:
            names.append(alias.strip('"'))
            continue
        if len(e) == 1 and e[0] == ("t", "op", "*"):
            names.extend(star_columns(node.table.base))
            continue
        label = None
        for el in reversed(e):
            if el[0] == "t" and el[1] in ("word", "qident"):
                label = el[2].strip('"')
                break
        names.append(label if label is not None else _expr_text(e))
    return names


def _expr_text(e: Expr) -> str:
    parts = []
    for el in e:
        parts.append("(...)" if el[0] == "q" else el[2])
    return " ".join(parts)


# ---------------------------------------------------------------------------
# emitter
# ---------------------------------------------------------------------------


class Emitter:
    """AST → SQLite SQL + $N order.  ``strip_schemas`` drops the given
    schema qualifiers from table names (public. for user tables;
    pg_catalog./information_schema. when routing to the catalog)."""

    def __init__(self, strip_schemas=("public",)):
        self.strip = set(strip_schemas)
        self.order: List[int] = []

    # -- pieces ----------------------------------------------------------

    def expr(self, e: Expr) -> str:
        out: List[str] = []
        run: List[tuple] = []

        def flush():
            if run:
                buf: List[str] = []
                transform_tokens(list(run), buf, self.order)
                out.append("".join(buf))
                run.clear()

        for el in e:
            if el[0] == "q":
                flush()
                out.append("(" + self.select(el[1]) + ")")
            else:
                if run:
                    run.append(("ws", " "))
                run.append((el[1], el[2]))
        flush()
        return " ".join(out)

    def qname(self, q: QName) -> str:
        parts = list(q.parts)
        while len(parts) > 1 and parts[0].strip('"').lower() in self.strip:
            parts = parts[1:]
        return ".".join(parts)

    def _items(self, items) -> str:
        return ", ".join(
            self.expr(e) + (f" AS {a}" if a else "")
            for e, a in items
        )

    def from_clause(self, from_items, joins) -> str:
        def item(fi: FromItem) -> str:
            if fi.select is not None:
                s = "(" + self.select(fi.select) + ")"
            else:
                s = self.qname(fi.name)
            return s + (f" AS {fi.alias}" if fi.alias else "")

        s = ", ".join(item(fi) for fi in from_items)
        for j in joins:
            if j.jtype == ",":
                s += ", " + item(j.item)
                continue
            s += f" {j.jtype} {item(j.item)}"
            if j.on is not None:
                s += " ON " + self.expr(j.on)
            elif j.using is not None:
                s += " USING (" + ", ".join(j.using) + ")"
        return s

    def core(self, c: SelectCore) -> str:
        if c.values is not None:
            return "VALUES " + ", ".join(
                "(" + ", ".join(self.expr(e) for e in row) + ")"
                for row in c.values
            )
        s = "SELECT "
        if c.distinct:
            s += "DISTINCT "
        s += self._items(c.items)
        if c.from_items:
            s += " FROM " + self.from_clause(c.from_items, c.joins)
        if c.where is not None:
            s += " WHERE " + self.expr(c.where)
        if c.group_by:
            s += " GROUP BY " + ", ".join(self.expr(e) for e in c.group_by)
        if c.having is not None:
            s += " HAVING " + self.expr(c.having)
        return s

    def select(self, n: Select) -> str:
        s = self._ctes(n)
        s += self.core(n.core)
        for op, c in n.compounds:
            s += f" {op} " + self.core(c)
        if n.order_by:
            s += " ORDER BY " + ", ".join(self.expr(e) for e in n.order_by)
        if n.limit is not None:
            s += " LIMIT " + self.expr(n.limit)
        if n.offset is not None:
            s += " OFFSET " + self.expr(n.offset)
        return s

    def _ctes(self, node) -> str:
        if not node.ctes:
            return ""
        head = "WITH RECURSIVE " if getattr(
            node, "recursive", False
        ) else "WITH "
        return head + ", ".join(
            name
            + (f" ({', '.join(cols)})" if cols else "")
            + " AS (" + self.select(body) + ")"
            for name, cols, body in node.ctes
        ) + " "

    def _returning(self, node) -> str:
        if node.returning is None:
            return ""
        return " RETURNING " + self._items(node.returning)

    def insert(self, n: Insert) -> str:
        s = self._ctes(n) + "INSERT INTO " + self.qname(n.table)
        if n.alias:
            s += f" AS {n.alias}"
        if n.columns:
            s += " (" + ", ".join(n.columns) + ")"
        if n.default_values:
            s += " DEFAULT VALUES"
        elif n.values is not None:
            s += " VALUES " + ", ".join(
                "(" + ", ".join(self.expr(e) for e in row) + ")"
                for row in n.values
            )
        else:
            sel = n.select
            if n.conflict_action and sel.core.values is None:
                # sqlite requires a WHERE on a SELECT source before an
                # upsert clause (documented parsing ambiguity)
                if sel.compounds or sel.ctes:
                    raise Unsupported(
                        "ON CONFLICT after a compound/CTE SELECT source"
                    )
                if sel.core.where is None:
                    sel.core.where = [("t", "word", "true")]
            s += " " + self.select(sel)
        if n.conflict_action:
            s += " ON CONFLICT"
            if n.conflict_target:
                s += " (" + ", ".join(n.conflict_target) + ")"
            if n.conflict_action == "nothing":
                s += " DO NOTHING"
            else:
                s += " DO UPDATE SET " + ", ".join(
                    f"{c} = " + self.expr(e) for c, e in n.conflict_sets
                )
                if n.conflict_where is not None:
                    s += " WHERE " + self.expr(n.conflict_where)
        return s + self._returning(n)

    def update(self, n: Update) -> str:
        s = self._ctes(n) + "UPDATE " + self.qname(n.table)
        if n.alias:
            s += f" AS {n.alias}"
        s += " SET " + ", ".join(
            f"{c} = " + self.expr(e) for c, e in n.sets
        )
        if n.from_items:
            s += " FROM " + self.from_clause(n.from_items, n.joins)
        if n.where is not None:
            s += " WHERE " + self.expr(n.where)
        return s + self._returning(n)

    def delete(self, n: Delete) -> str:
        s = self._ctes(n) + "DELETE FROM " + self.qname(n.table)
        if n.alias:
            s += f" AS {n.alias}"
        if n.using:
            # sqlite has no DELETE..USING: rewrite as a correlated
            # EXISTS would change semantics; refuse instead
            raise Unsupported("DELETE USING")
        if n.where is not None:
            s += " WHERE " + self.expr(n.where)
        return s + self._returning(n)

    def emit(self, node) -> str:
        if isinstance(node, Select):
            return self.select(node)
        if isinstance(node, Insert):
            return self.insert(node)
        if isinstance(node, Update):
            return self.update(node)
        if isinstance(node, Delete):
            return self.delete(node)
        raise Unsupported(f"emit {type(node).__name__}")


def emit(node, strip_schemas=("public",)) -> Tuple[str, List[int]]:
    """AST → (sqlite SQL, $N parameter order)."""
    em = Emitter(strip_schemas)
    sql = em.emit(node)
    return sql, em.order
