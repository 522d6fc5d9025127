"""The port's PostgreSQL wire (``corrosion_tpu_torch/agent/pg.py`` over
``pgparse``, ``pgsql`` and ``sqlstate``) against the reference's.

* one session script, over ``tests/pgwire_client.PgClient``, against a
  port agent (``device="cpu"``) and a reference agent: every backend
  message of both, in order, equal once the BackendKeyData (pid and
  secret key) is masked.  The script covers the handshake, simple and
  extended queries, a transaction as one version, rollback, SQLSTATE
  codes, the catalog, RETURNING, savepoints, CTE DML, portal
  suspension, a failed Bind and a cancel;
* the pure functions (``pgsql.tokenize`` / ``translate_query`` /
  ``split_statements``, ``pg._is_write``, ``pgparse``'s parse, emit,
  table refs and RETURNING names, ``sqlstate.sqlstate_for``) on the
  SQL corpora of ``tests/test_pg*.py``, read from those files.
"""

import ast
import asyncio
import os
import sqlite3
import struct
import threading
import time

import pytest

from corrosion_tpu.agent import pg as ref_pg
from corrosion_tpu.agent import pgparse as ref_pgparse
from corrosion_tpu.agent import pgsql as ref_pgsql
from corrosion_tpu.agent import sqlstate as ref_sqlstate
from corrosion_tpu.agent import testing as ref_testing
from corrosion_tpu_torch.agent import pg as port_pg
from corrosion_tpu_torch.agent import pgparse as port_pgparse
from corrosion_tpu_torch.agent import pgsql as port_pgsql
from corrosion_tpu_torch.agent import sqlstate as port_sqlstate
from corrosion_tpu_torch.agent import testing as port_testing
from tests.pgwire_client import PgClient

SITE = bytes(range(40, 56))
HERE = os.path.dirname(os.path.abspath(__file__))


class RecClient(PgClient):
    """A ``PgClient`` that keeps every backend message it reads."""

    def __init__(self, host, port, log, **kw):
        self.log = log
        super().__init__(host, port, **kw)

    def _recv_msg(self):
        tag, payload = super()._recv_msg()
        self.log.append((tag, b"<key>" if tag == b"K" else payload))
        return tag, payload


def _script(agent, log, notes):
    """The session script, driven from a worker thread; ``notes`` gets
    what the agent itself shows between steps."""
    c = RecClient(*agent.pg_addr, log)
    assert c.backend_key and c.backend_key != (0, 0)
    q = c.query
    q("SELECT version()")
    q("SHOW server_version")
    # simple protocol, several statements in one message
    q("INSERT INTO tests (id, text) VALUES (1, 'one'); "
      "INSERT INTO tests (id, text) VALUES (2, 'two')")
    q("SELECT id, text FROM tests ORDER BY id")
    # extended protocol: text, declared types, binary parameters
    c.prepared("INSERT INTO tests (id, text) VALUES ($1, $2)", (5, "param"))
    c.prepared("SELECT text FROM tests WHERE id = $1", (5,))
    c.typed_query("SELECT id, text FROM tests WHERE id > $1 ORDER BY id",
                  (1,), param_oids=(20,), binary=True)
    c.prepared("INSERT INTO tests2 (id, text) VALUES ($1, $2)", (7, "typed"),
               param_oids=(20, 25))
    notes.append(("version", agent.bookie.for_actor(agent.actor_id).last()))
    # a transaction is one version
    q("BEGIN")
    q("INSERT INTO tests (id, text) VALUES (10, 'ten')")
    q("INSERT INTO tests (id, text) VALUES (11, 'eleven')")
    q("UPDATE tests SET text = 'uno' WHERE id = 1")
    q("SELECT id, text FROM tests WHERE id >= 10 ORDER BY id")
    q("COMMIT")
    notes.append(("version", agent.bookie.for_actor(agent.actor_id).last()))
    # rollback discards
    q("BEGIN")
    q("INSERT INTO tests (id, text) VALUES (20, 'gone')")
    q("ROLLBACK")
    q("SELECT count(*) FROM tests")
    notes.append(("version", agent.bookie.for_actor(agent.actor_id).last()))
    # SQLSTATE codes
    for sql in ("SELECT * FROM no_such_tbl", "SELECT no_such_col FROM tests",
                "SELECT no_such_fn(1)", "SELECT FROM WHERE",
                "INSERT INTO tests (id, text) VALUES (1, 'dup')",
                "SHOW no_such_guc"):
        q(sql)
    # the catalog
    q("SELECT c.relname, a.attname, t.typname FROM pg_catalog.pg_class c"
      " JOIN pg_catalog.pg_attribute a ON a.attrelid = c.oid"
      " JOIN pg_catalog.pg_type t ON t.oid = a.atttypid"
      " WHERE c.relnamespace = 2200 ORDER BY c.relname, a.attnum")
    q("SELECT table_name, column_name, data_type FROM"
      " information_schema.columns WHERE table_name = 'tests2'"
      " ORDER BY ordinal_position")
    q("SELECT datname FROM pg_database WHERE datallowconn = 1")
    q("SELECT current_database() AS name, current_schema()")
    q("SELECT t.typname FROM pg_class c, pg_type t WHERE t.oid = 20 LIMIT 1")
    # GUCs
    q("SET application_name = 'myapp'")
    q("SHOW application_name")
    q("RESET application_name")
    # RETURNING, simple and extended
    q("INSERT INTO tests (id, text) VALUES (30, 'r') RETURNING id, text")
    c.prepared("UPDATE tests SET text = $1 WHERE id = $2 RETURNING *",
               ("u", 30))
    q("DELETE FROM tests WHERE id = 30 RETURNING id")
    # savepoints
    q("BEGIN")
    q("INSERT INTO tests (id, text) VALUES (40, 'keep')")
    q("SAVEPOINT sp1")
    q("INSERT INTO tests (id, text) VALUES (41, 'drop')")
    q("ROLLBACK TO SAVEPOINT sp1")
    q("SAVEPOINT sp2")
    q("SELECT nonsense_fn()")
    q("SELECT 1")
    q("ROLLBACK TO sp2")
    q("RELEASE SAVEPOINT sp2")
    q("ROLLBACK TO nope")
    q("ROLLBACK")
    # CTE DML inside a transaction
    q("BEGIN")
    q("WITH src AS (SELECT 50 AS id) INSERT INTO tests SELECT id, 'cte' "
      "FROM src")
    q("SELECT id FROM tests WHERE id >= 40 UNION ALL SELECT 99 WHERE 1 = 0 "
      "ORDER BY id")
    q("COMMIT")
    notes.append(("version", agent.bookie.for_actor(agent.actor_id).last()))
    # portal suspension
    notes.append(("limited", c.execute_limited(
        "SELECT id FROM tests ORDER BY id", max_rows=3)))
    # a failed Bind discards the pipelined Execute until Sync
    parse = b"\x00INSERT INTO tests (id, text) VALUES ($1, 'x')\x00"
    c._send(b"P", parse + struct.pack(">hI", 1, 1082))  # a date OID
    c._send(b"B", b"\x00\x00" + struct.pack(">hhhii", 1, 1, 1, 4, 123)
            + struct.pack(">h", 0))
    c._send(b"E", b"\x00" + struct.pack(">i", 0))
    c._send(b"S")
    for _ in c._messages_until(b"Z"):
        pass
    # a cancel interrupts the running query; the session goes on
    key = c.backend_key

    def fire():
        time.sleep(0.4)
        PgClient.cancel_request(*agent.pg_addr, key)

    t = threading.Thread(target=fire)
    t.start()
    q("WITH RECURSIVE spin(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM spin"
      " WHERE n < 300000000) SELECT count(*) FROM spin")
    t.join()
    notes.append(("cancel", c.last_error_codes))
    q("SELECT id, text FROM tests ORDER BY id")
    c.close()


def test_session_equals_reference(tmp_path):
    """The same script on a reference agent and a port agent gives the
    same backend messages (BackendKeyData masked) and versions."""
    out = {}
    for name, testing, kw in (("ref", ref_testing, {}),
                              ("port", port_testing, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        log, notes = [], []

        async def main():
            a = await testing.launch_test_agent(
                tmpdir=str(d), pg_port=0, site_id=SITE, **kw)
            try:
                await asyncio.to_thread(_script, a, log, notes)
                notes.append(("rows", a.storage.read_query(
                    "SELECT id, text FROM tests ORDER BY id")[1]))
            finally:
                await a.stop()

        asyncio.run(asyncio.wait_for(main(), 60))
        out[name] = (log, notes)
    log, notes = out["port"]
    assert dict(notes)["cancel"] == ["57014"]
    # the three RETURNING statements are a version each
    assert [v for k, v in notes if k == "version"] == [4, 5, 5, 9]
    assert dict(notes)["limited"] == ([3, 3], 1, "SELECT 6", None)
    assert dict(notes)["rows"] == [(1, "uno"), (2, "two"), (5, "param"),
                                   (10, "ten"), (11, "eleven"), (50, "cte")]
    assert sum(tag == b"E" for tag, _ in log) >= 10
    assert out["port"] == out["ref"]


def test_tls_session_equals_reference(tmp_path):
    """SSLRequest answered ``S``, then the session over TLS, on both."""
    from corrosion_tpu_torch.agent.tls import generate_ca, generate_server_cert

    d = str(tmp_path)
    ca_cert, ca_key = generate_ca(d)
    srv_cert, srv_key = generate_server_cert(
        d, ca_cert, ca_key, ["127.0.0.1", "localhost"])
    out = {}
    for name, testing, kw in (("ref", ref_testing, {}),
                              ("port", port_testing, {"device": "cpu"})):
        log = []

        async def main():
            a = await testing.launch_test_agent(
                tmpdir=str(tmp_path / name), pg_port=0, site_id=SITE,
                tls_cert_file=srv_cert, tls_key_file=srv_key,
                tls_ca_file=ca_cert, **kw)

            def drive():
                c = RecClient(*a.pg_addr, log, tls=True, ca_file=ca_cert)
                c.query("INSERT INTO tests (id, text) VALUES (5, 'tls')")
                c.query("SELECT text FROM tests WHERE id = 5")
                c.close()

            try:
                await asyncio.to_thread(drive)
            finally:
                await a.stop()

        (tmp_path / name).mkdir()
        asyncio.run(asyncio.wait_for(main(), 60))
        out[name] = log
    assert (b"D", struct.pack(">hi", 1, 3) + b"tls") in out["port"]
    assert out["port"] == out["ref"]


# -- the pure functions on the reference tests' SQL --------------------

_SQL_HEADS = ("SELECT", "INSERT", "UPDATE", "DELETE", "WITH", "BEGIN",
              "COMMIT", "ROLLBACK", "SAVEPOINT", "RELEASE", "SET", "SHOW",
              "RESET", "VALUES", "CREATE", "ALTER", "DROP", "COPY",
              "DECLARE", "PRAGMA", "START", "END", "DISCARD", "EXPLAIN")


def _corpus():
    """Every string constant of ``tests/test_pg*.py`` that reads as SQL."""
    out = []
    for name in sorted(os.listdir(HERE)):
        if not (name.startswith("test_pg") and name.endswith(".py")):
            continue
        with open(os.path.join(HERE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                s = node.value.strip()
                if s.split(" ", 1)[0].upper().rstrip(";") in _SQL_HEADS:
                    out.append(node.value)
    return sorted(set(out))


CORPUS = _corpus()


def _outcome(fn, *args):
    try:
        return ("ok", _plain(fn(*args)))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", type(e).__name__, str(e))


def _plain(x):
    """An AST or value of either package as plain data, class names
    kept, so the two packages' results compare."""
    import dataclasses

    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, _plain(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _plain(v)) for k, v in x.items()))
    return x


def test_corpus_is_the_reference_tests_sql():
    assert len(CORPUS) > 150
    assert "SELECT * FROM t WHERE a = $2 AND b = $1 AND c = $2" in CORPUS


@pytest.mark.parametrize("part", range(4))
def test_pgsql_functions_equal_reference(part):
    for sql in CORPUS[part::4]:
        for fn in ("tokenize", "translate_query", "split_statements"):
            assert (_outcome(getattr(port_pgsql, fn), sql)
                    == _outcome(getattr(ref_pgsql, fn), sql)), (fn, sql)
        assert _outcome(port_pg._is_write, sql) == _outcome(
            ref_pg._is_write, sql), sql


@pytest.mark.parametrize("part", range(4))
def test_pgparse_equals_reference(part):
    def run(mod, sql):
        node = mod.parse_statement(sql)
        return (_plain(node), _outcome(mod.emit, node),
                _outcome(mod.emit, node, ()),
                _outcome(mod.table_refs, node),
                _outcome(mod.returning_names, node, ("id", "text")))

    parsed = 0
    for sql in CORPUS[part::4]:
        got = _outcome(run, port_pgparse, sql)
        assert got == _outcome(run, ref_pgparse, sql), sql
        parsed += got[0] == "ok"
    assert parsed > 10


def test_sqlstate_equals_reference():
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE t (id INTEGER PRIMARY KEY, a TEXT NOT NULL, "
                 "b INTEGER CHECK (b > 0), c INTEGER REFERENCES t(id))")
    conn.execute("PRAGMA foreign_keys = ON")
    conn.execute("INSERT INTO t (id, a, b) VALUES (1, 'x', 1)")
    errors = []
    for sql in ("SELECT * FROM nope", "SELECT nope FROM t", "SELECT nope(1)",
                "SELECT FROM WHERE", "INSERT INTO t (id, a) VALUES (1, 'y')",
                "INSERT INTO t (id) VALUES (2)",
                "INSERT INTO t (id, a, b) VALUES (3, 'z', -1)",
                "INSERT INTO t (id, a, c) VALUES (4, 'z', 99)",
                "SELECT 1 / 'x' + abs(-9223372036854775807 - 1)",
                "CREATE TABLE t (x)", "SELECT * FROM t WHERE",
                "INSERT INTO t VALUES (1, 2)"):
        try:
            conn.execute(sql)
        except sqlite3.Error as e:
            errors.append(e)
    assert len(errors) > 10
    # every fragment the reference classifies, under both error classes
    for frag, _ in ref_sqlstate._SQLITE_PATTERNS:
        errors += [sqlite3.OperationalError(f"x: {frag.upper()} y"),
                   sqlite3.IntegrityError(frag)]
    errors += [ValueError("x"), TypeError("t"), OverflowError("big"),
               RuntimeError("r"), sqlite3.InternalError("?"),
               sqlite3.IntegrityError("other")]
    for e in errors:
        assert port_sqlstate.sqlstate_for(e) == ref_sqlstate.sqlstate_for(
            e), e
    for code in ("22P02", "57014", "25P02"):
        assert (port_sqlstate.sqlstate_for(port_sqlstate.PgError(code, "m"))
                == ref_sqlstate.sqlstate_for(ref_sqlstate.PgError(code, "m"))
                == code)
    assert port_sqlstate.SQLSTATE == ref_sqlstate.SQLSTATE
