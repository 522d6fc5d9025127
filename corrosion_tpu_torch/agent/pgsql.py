"""PG→SQLite SQL translation over a real tokenizer.

The reference parses PG SQL with ``sqlparser`` and re-emits a SQLite
AST (``crates/corro-pg/src/lib.rs:545-``, ~6k lines).  SQLite's dialect
already overlaps PG's enough that a faithful token-level rewrite covers
the differences that matter on the wire; what this module guarantees —
and the old regex pass did not — is that every transformation is
TOKEN-AWARE: nothing ever rewrites inside string literals, quoted
identifiers, comments, or dollar-quoted bodies.

Lexed token kinds: ``str`` (standard ``'…'`` with doubled quotes),
``estr`` (``E'…'`` with backslash escapes), ``dollar`` (``$tag$…$tag$``
bodies), ``qident`` (``"…"``), ``param`` (``$N``), ``num``, ``word``,
``op`` (multi-char operators first: ``::``, ``<=``, ``>=``, ``<>``,
``!=``, ``||``), ``comment`` (``--`` and nested ``/* */``), ``ws``.

Translations applied:

* ``$N`` placeholders → ``?`` (param order returned for out-of-order /
  repeated references);
* ``::type`` / ``::type[]`` casts dropped (sqlite affinity governs);
* ``E'…'`` escape-strings and ``$tag$…$tag$`` dollar-quotes →
  standard quoted literals;
* ``now()`` / bare ``current_timestamp`` → ``datetime('now')``,
  ``current_date`` → ``date('now')``, ``current_time`` →
  ``time('now')``;
* ``ILIKE`` → ``LIKE`` (sqlite LIKE is already case-insensitive for
  ASCII);
* comments stripped (sqlite accepts them, but dropping them keeps the
  write-detection and catalog-routing heads honest).
"""

from __future__ import annotations

import re
from typing import List, Tuple

_OPS = ("::", "<=", ">=", "<>", "!=", "||", ":=")
_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_NUM_RE = re.compile(r"(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
_DOLLAR_RE = re.compile(r"\$([A-Za-z_]\w*)?\$")


class PgSqlError(ValueError):
    pass


def tokenize(sql: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        # comments ---------------------------------------------------
        if ch == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            j = n if j < 0 else j + 1
            out.append(("comment", sql[i:j]))
            i = j
            continue
        if ch == "/" and sql.startswith("/*", i):
            depth, j = 1, i + 2
            while j < n and depth:
                if sql.startswith("/*", j):
                    depth += 1
                    j += 2
                elif sql.startswith("*/", j):
                    depth -= 1
                    j += 2
                else:
                    j += 1
            out.append(("comment", sql[i:j]))
            i = j
            continue
        # strings ----------------------------------------------------
        if ch == "'" or (
            ch in "eE" and i + 1 < n and sql[i + 1] == "'"
        ):
            kind = "str" if ch == "'" else "estr"
            j = i + (1 if kind == "str" else 2)
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        j += 2
                        continue
                    break
                if kind == "estr" and sql[j] == "\\" and j + 1 < n:
                    j += 2
                    continue
                j += 1
            if j >= n:
                raise PgSqlError("unterminated string literal")
            out.append((kind, sql[i:j + 1]))
            i = j + 1
            continue
        if ch == '"':
            j = i + 1
            while j < n:
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        j += 2
                        continue
                    break
                j += 1
            if j >= n:
                raise PgSqlError("unterminated quoted identifier")
            out.append(("qident", sql[i:j + 1]))
            i = j + 1
            continue
        # dollar: $N param or $tag$…$tag$ quote ----------------------
        if ch == "$":
            if i + 1 < n and sql[i + 1].isdigit():
                j = i + 1
                while j < n and sql[j].isdigit():
                    j += 1
                out.append(("param", sql[i:j]))
                i = j
                continue
            m = _DOLLAR_RE.match(sql, i)
            if m:
                close = sql.find(m.group(0), m.end())
                if close < 0:
                    raise PgSqlError("unterminated dollar-quoted string")
                out.append(("dollar", sql[i:close + len(m.group(0))]))
                i = close + len(m.group(0))
                continue
            out.append(("op", "$"))
            i += 1
            continue
        # whitespace / words / numbers / operators -------------------
        if ch.isspace():
            j = i
            while j < n and sql[j].isspace():
                j += 1
            out.append(("ws", sql[i:j]))
            i = j
            continue
        m = _WORD_RE.match(sql, i)
        if m:
            out.append(("word", m.group(0)))
            i = m.end()
            continue
        m = _NUM_RE.match(sql, i)
        if m:
            out.append(("num", m.group(0)))
            i = m.end()
            continue
        for op in _OPS:
            if sql.startswith(op, i):
                out.append(("op", op))
                i += len(op)
                break
        else:
            out.append(("op", ch))
            i += 1
    return out


def _std_quote(body: str) -> str:
    return "'" + body.replace("'", "''") + "'"


_E_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
    "\\": "\\", "'": "'",
}


def _decode_estr(text: str) -> str:
    """E'…' body → plain string value (simple, hex, unicode and octal
    escapes per the PG escape-string rules)."""
    body = text[2:-1]
    out: List[str] = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt in _E_ESCAPES:
                out.append(_E_ESCAPES[nxt])
                i += 2
                continue
            if nxt == "x":
                m = re.match(r"[0-9A-Fa-f]{1,2}", body[i + 2:])
                if m:
                    out.append(chr(int(m.group(0), 16)))
                    i += 2 + len(m.group(0))
                    continue
            if nxt in ("u", "U"):
                width = 4 if nxt == "u" else 8
                m = re.match(rf"[0-9A-Fa-f]{{{width}}}", body[i + 2:])
                if m:
                    out.append(chr(int(m.group(0), 16)))
                    i += 2 + width
                    continue
                raise PgSqlError(f"invalid \\{nxt} escape")
            m = re.match(r"[0-7]{1,3}", body[i + 1:])
            if m:
                out.append(chr(int(m.group(0), 8)))
                i += 1 + len(m.group(0))
                continue
            out.append(nxt)
            i += 2
            continue
        if ch == "'" and i + 1 < len(body) and body[i + 1] == "'":
            out.append("'")
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


_BARE_FUNC_WORDS = {
    "current_timestamp": "datetime('now')",
    "current_date": "date('now')",
    "current_time": "time('now')",
}
_CALL_FUNC_WORDS = {
    "now": "datetime('now')",
}


def translate_query(sql: str) -> Tuple[str, List[int]]:
    """PG SQL → SQLite SQL + $N parameter order (tokenizer pass)."""
    try:
        tokens = tokenize(sql)
    except PgSqlError:
        # ship the text through unchanged; sqlite reports the error
        return sql, []
    out: List[str] = []
    order: List[int] = []
    transform_tokens(tokens, out, order)
    return "".join(out), order


def transform_tokens(tokens: List[Tuple[str, str]], out: List[str],
                     order: List[int]) -> None:
    """The PG→SQLite token transforms over one token run, appending
    text to ``out`` and $N indices to ``order``.  Shared by the whole-
    string :func:`translate_query` and the AST emitter
    (``agent/pgparse.py``), which applies it per expression slice."""

    def next_code(k: int) -> int:
        """Index of the next non-ws/comment token after k, or -1."""
        for j in range(k + 1, len(tokens)):
            if tokens[j][0] not in ("ws", "comment"):
                return j
        return -1

    i = 0
    while i < len(tokens):
        kind, text = tokens[i]
        if kind == "param":
            order.append(int(text[1:]))
            out.append("?")
        elif kind == "op" and text == "::":
            # drop the cast — and the FULL PG type name: a word or
            # "qident" head, an optional second word (double PRECISION,
            # character VARYING), an optional (precision[,scale]) group,
            # an optional WITH/WITHOUT TIME ZONE tail, an optional []
            j = next_code(i)
            if j >= 0 and tokens[j][0] in ("word", "qident"):
                end = j
                k = next_code(end)
                # schema-qualified type names (pg_catalog.int4): hop
                # each .qualifier before the shape suffixes
                while (
                    k >= 0 and tokens[k][1] == "."
                    and (m := next_code(k)) >= 0
                    and tokens[m][0] in ("word", "qident")
                ):
                    end, k = m, next_code(m)
                if (
                    k >= 0 and tokens[k][0] == "word"
                    and tokens[k][1].lower() in ("precision", "varying")
                ):
                    end, k = k, next_code(k)
                if k >= 0 and tokens[k][1] == "(":
                    depth, m = 1, k
                    while depth and (m := next_code(m)) >= 0:
                        if tokens[m][1] == "(":
                            depth += 1
                        elif tokens[m][1] == ")":
                            depth -= 1
                    if depth == 0:
                        end, k = m, next_code(m)
                if (
                    k >= 0 and tokens[k][0] == "word"
                    and tokens[k][1].lower() in ("with", "without")
                    and (m := next_code(k)) >= 0
                    and tokens[m][1].lower() == "time"
                    and (m2 := next_code(m)) >= 0
                    and tokens[m2][1].lower() == "zone"
                ):
                    end, k = m2, next_code(m2)
                if (
                    k >= 0 and tokens[k][1] == "["
                    and (m := next_code(k)) >= 0 and tokens[m][1] == "]"
                ):
                    end = m
                i = end + 1
                continue
            out.append(text)
        elif kind == "estr":
            out.append(_std_quote(_decode_estr(text)))
        elif kind == "dollar":
            tag_end = text.index("$", 1) + 1
            out.append(_std_quote(text[tag_end:-tag_end]))
        elif kind == "comment":
            out.append(" ")
        elif kind == "word":
            low = text.lower()
            if low in _BARE_FUNC_WORDS:
                j = next_code(i)
                if j < 0 or tokens[j][1] != "(":
                    out.append(_BARE_FUNC_WORDS[low])
                else:
                    out.append(text)
            elif low in _CALL_FUNC_WORDS:
                j = next_code(i)
                k = next_code(j) if j >= 0 else -1
                if (
                    j >= 0 and tokens[j][1] == "("
                    and k >= 0 and tokens[k][1] == ")"
                ):
                    out.append(_CALL_FUNC_WORDS[low])
                    i = k + 1
                    continue
                out.append(text)
            elif low == "ilike":
                out.append("LIKE")
            else:
                out.append(text)
        else:
            out.append(text)
        i += 1


def split_statements(query: str) -> List[str]:
    """Split on top-level semicolons, string/comment/dollar-aware."""
    try:
        tokens = tokenize(query)
    except PgSqlError:
        return [query]
    parts: List[str] = []
    buf: List[str] = []
    for kind, text in tokens:
        if kind == "op" and text == ";":
            parts.append("".join(buf))
            buf = []
        elif kind == "comment":
            # dropped here so downstream first-word dispatch (write
            # detection, BEGIN/COMMIT handling) sees real SQL
            buf.append(" ")
        else:
            buf.append(text)
    if "".join(buf).strip():
        parts.append("".join(buf))
    return parts
