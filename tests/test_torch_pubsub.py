"""The port's subscriptions and HTTP API (``corrosion_tpu_torch/agent/
pubsub.py`` and ``agent/http.py``) against the reference's, on the CPU.

* the matcher: the seeded change streams of ``tests/test_subs_parity.py``
  fed, version by version, to a reference ``make_offline_agent`` with a
  ``SubsManager`` and to the port's give equal event streams for every
  subscription shape there (columns, rows, change kinds and change ids),
  in the sharded columnar arm and on the per-subscription oracle, and
  the query's rows over the final state;
* the HTTP API: a reference agent and a port agent that take the same
  requests (``/v1/transactions``, ``/v1/subscriptions[/<id>]``,
  ``/v1/updates/tests``, ``/v1/queries``, ``/v1/table_stats``,
  ``/v1/members``, an unknown route) answer with equal JSON bodies,
  apart from time fields and the subscription's id;
* restore: subscriptions a reference agent persisted under its
  ``subs_path`` come back in a port agent started on the same
  directory, and their rows and change ids go on as the reference's.
"""

import asyncio
import http.client
import json
import os
import random
import shutil
import socket
import threading
import urllib.error
import urllib.request

import pytest

from corrosion_tpu.agent import testing as ref_testing
from corrosion_tpu.agent.pubsub import SubsManager as RefSubsManager
from corrosion_tpu.agent.runtime import ChangeSource as RefChangeSource
from corrosion_tpu.types import ActorId as RefActorId
from corrosion_tpu.types import Version as RefVersion
from corrosion_tpu.types.changeset import Changeset as RefChangeset
from corrosion_tpu.types.changeset import ChangeV1 as RefChangeV1
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.agent import testing as port_testing
from corrosion_tpu_torch.agent.pack import jsonable_row
from corrosion_tpu_torch.agent.pubsub import SubsManager as PortSubsManager
from corrosion_tpu_torch.agent.runtime import ChangeSource as PortChangeSource
from corrosion_tpu_torch.types import ActorId as PortActorId
from corrosion_tpu_torch.types import Version as PortVersion
from corrosion_tpu_torch.types.changeset import Changeset as PortChangeset
from corrosion_tpu_torch.types.changeset import ChangeV1 as PortChangeV1
from tests.test_subs_parity import ACTOR, SUB_SQLS, _random_stream, _wait_idle

REF = dict(testing=ref_testing, subs=RefSubsManager, source=RefChangeSource,
           actor=RefActorId, version=RefVersion, changeset=RefChangeset,
           change_v1=RefChangeV1, changes=list)
PORT = dict(testing=port_testing, subs=PortSubsManager,
            source=PortChangeSource, actor=PortActorId, version=PortVersion,
            changeset=PortChangeset, change_v1=PortChangeV1,
            changes=convert.changes_from_reference)
PORT_KW = dict(device="cpu")


def _order(stream, seed, shuffle, duplicate):
    """The feed order of ``stream``'s versions, duplicates included."""
    rng = random.Random(seed + 1)
    order = list(stream)
    if shuffle:
        rng.shuffle(order)
    out = []
    for item in order:
        out += [item] * (2 if duplicate and rng.random() < 0.3 else 1)
    return out


def _feed_one(pkg, agent, item):
    v, _table, changes = item
    cs = pkg["changeset"].full(
        pkg["version"](v), pkg["changes"](changes), (0, len(changes) - 1),
        len(changes) - 1, agent.clock.new_timestamp())
    agent.handle_change(
        pkg["change_v1"](actor_id=pkg["actor"](ACTOR), changeset=cs),
        pkg["source"].SYNC, rebroadcast=False)


def _last_cid(events):
    for ev in reversed(events):
        if "change" in ev:
            return ev["change"][3]
        if "eoq" in ev:
            return ev["eoq"]["change_id"]
    return None


def _take(gen, handle, events, start=None):
    """Append ``gen``'s queued events up to ``handle``'s last change id:
    a snapshot's, or those after ``start`` on a catch-up stream.  Every
    wave has drained, so none is left to block on."""
    while (_last_cid(events) if events else start) != handle.last_change_id:
        events.append(next(gen))


def _matcher_run(pkg, tmpdir, stream, seed, shuffle, duplicate, **cfg):
    os.makedirs(tmpdir, exist_ok=True)
    kw = PORT_KW if pkg is PORT else {}
    a = pkg["testing"].make_offline_agent(tmpdir, **kw, **cfg)
    mgr = pkg["subs"](a, tmpdir + "/subs")
    try:
        handles = [mgr.subscribe(sql) for sql in SUB_SQLS]
        gens = [h.stream() for h in handles]
        events = [[] for _ in handles]
        for item in _order(stream, seed, shuffle, duplicate):
            _feed_one(pkg, a, item)
            _wait_idle(mgr)
            for h, g, evs in zip(handles, gens, events):
                _take(g, h, evs)
        truths = [a.storage.read_query(sql)[1] for sql in SUB_SQLS]
        rows = [sorted(h.rows.values()) for h in handles]
        for g in gens:
            g.close()
        return events, rows, truths
    finally:
        mgr.close()
        a.storage.close()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("arm", ["columnar", "oracle"])
def test_matcher_events_equal_reference(seed, arm, tmp_path):
    rng = random.Random(9100 + seed)
    stream = _random_stream(rng, n_versions=16)
    cfg = (dict(subs_shards=3, subs_columnar=True) if arm == "columnar"
           else dict(subs_shards=1, subs_columnar=False))
    args = (stream, 9100 + seed, seed % 2 == 1, seed >= 2)
    want = _matcher_run(REF, str(tmp_path / "ref"), *args, **cfg)
    got = _matcher_run(PORT, str(tmp_path / "port"), *args, **cfg)
    events, rows, truths = got
    assert truths == want[2]
    assert rows == want[1]
    for sql, e_got, e_want in zip(SUB_SQLS, events, want[0]):
        assert e_got == e_want, sql
    # the streams carry live changes, not only snapshots
    assert sum(1 for evs in events for ev in evs if "change" in ev) > 20
    kinds = {ev["change"][0] for evs in events for ev in evs
             if "change" in ev}
    assert kinds == {"insert", "update", "delete"}


# -- the HTTP API ------------------------------------------------------

def _strip(x):
    """``x`` without its time fields."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "time"}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _request(agent, path, body=None):
    url = f"http://{agent.api_addr[0]}:{agent.api_addr[1]}{path}"
    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _ndjson(raw):
    return [json.loads(line) for line in raw.splitlines() if line.strip()]


class _Stream:
    """NDJSON events of one streaming request, read on a thread."""

    def __init__(self, agent, path, body=None):
        self.events = []
        self._conn = http.client.HTTPConnection(*agent.api_addr, timeout=20)
        if body is None:
            self._conn.request("GET", path)
        else:
            self._conn.request("POST", path, json.dumps(body).encode())
        self._resp = self._conn.getresponse()
        self.headers = dict(self._resp.headers)
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        try:
            for line in self._resp:
                self.events.append(json.loads(line))
        except (OSError, ValueError, http.client.HTTPException):
            pass  # the stream ends with the socket

    def close(self):
        # unblock the reader at once: the agent holds the stream open
        self._conn.sock.shutdown(socket.SHUT_RDWR)
        self._t.join(timeout=10)
        self._conn.close()


async def _http_session(pkg, tmpdir):
    kw = PORT_KW if pkg is PORT else {}
    a = await pkg["testing"].launch_test_agent(tmpdir=tmpdir, **kw)
    out = {}
    streams = []
    try:
        def call(name, path, body=None):
            out[name] = _request(a, path, body)

        await asyncio.to_thread(call, "tx1", "/v1/transactions", [
            ["INSERT INTO tests (id, text) VALUES (?, ?)", [i, f"t{i}"]]
            for i in range(1, 6)])
        sub = await asyncio.to_thread(
            _Stream, a, "/v1/subscriptions", "SELECT id, text FROM tests")
        upd = await asyncio.to_thread(_Stream, a, "/v1/updates/tests")
        streams += [sub, upd]
        await pkg["testing"].wait_for(
            lambda: any("eoq" in e for e in sub.events), timeout=10)
        await asyncio.to_thread(call, "tx2", "/v1/transactions", [
            ["INSERT INTO tests (id, text) VALUES (6, 'six')"],
            ["UPDATE tests SET text = 'two' WHERE id = 2"],
            ["DELETE FROM tests WHERE id = 3"]])
        await pkg["testing"].wait_for(
            lambda: sum("change" in e for e in sub.events) == 3
            and len(upd.events) == 3, timeout=10)
        sid = sub.headers["x-corro-query-id"]
        assert sid == a.subs.list()[0]["id"]
        catch = await asyncio.to_thread(
            _Stream, a, f"/v1/subscriptions/{sid}?from=0")
        streams.append(catch)
        await pkg["testing"].wait_for(lambda: len(catch.events) == 3,
                                      timeout=10)
        await asyncio.to_thread(call, "query", "/v1/queries",
                                "SELECT id, text FROM tests ORDER BY id")
        await asyncio.to_thread(call, "query_args", "/v1/queries",
                                ["SELECT text FROM tests WHERE id > ?", [3]])
        await asyncio.to_thread(call, "bad_tx", "/v1/transactions", {})
        await asyncio.to_thread(call, "stats", "/v1/table_stats")
        await asyncio.to_thread(call, "members", "/v1/members")
        await asyncio.to_thread(call, "no_sub", "/v1/subscriptions/nope")
        await asyncio.to_thread(call, "no_table", "/v1/updates/nope")
        await asyncio.to_thread(call, "missing", "/v1/nothing")
        status, metrics = await asyncio.to_thread(_request, a, "/metrics")
        assert status == 200
        assert b'corro_http_requests_total{endpoint="/v1/queries"}' \
            in metrics
        # the catch-up replays the persisted log: the live changes
        changes = [e for e in sub.events if "change" in e]
        assert catch.events == changes
        # the order of one wave's events is the matcher's (a set's) in
        # both packages: compare each wave's changes as a set and its
        # ids as a range
        snapshot = [e for e in sub.events if "change" not in e]
        out["sub"] = (snapshot, sub.headers["Content-Type"],
                      sorted((e["change"][:3] for e in changes), key=repr),
                      sorted(e["change"][3] for e in changes))
        out["updates"] = upd.events
        for k in ("tx1", "tx2", "query", "query_args", "bad_tx", "stats",
                  "members", "no_sub", "no_table", "missing"):
            status, raw = out[k]
            body = (_ndjson(raw) if k.startswith("query")
                    else json.loads(raw))
            out[k] = (status, _strip(body))
        out["sub"] = (_strip(out["sub"][0]),) + out["sub"][1:]
        return out
    finally:
        for s in streams:
            s.close()
        await a.stop()


def test_http_bodies_equal_reference(tmp_path):
    async def main():
        want = await _http_session(REF, str(tmp_path / "ref"))
        got = await _http_session(PORT, str(tmp_path / "port"))
        return want, got

    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want, got = asyncio.run(asyncio.wait_for(main(), 50))
    assert got == want
    assert got["tx2"][0] == 200 and got["tx2"][1]["version"] == 2
    assert [c[0] for c in got["sub"][2]] == ["delete", "insert", "update"]
    assert got["sub"][3] == [1, 2, 3]
    assert got["stats"][1] == {"tables": {
        "tests": {"row_count": 5}, "tests2": {"row_count": 0},
        "testsblob": {"row_count": 0}}}
    assert [s for s, _ in (got["no_sub"], got["no_table"], got["missing"],
                           got["bad_tx"])] == [404, 404, 404, 400]


# -- restore -----------------------------------------------------------

def test_port_restores_a_reference_subscription(tmp_path):
    """A reference agent subscribes and takes the first half of a seeded
    stream, then stops.  Its directory, copied twice, boots a reference
    agent and a port agent: both restore the subscriptions, and the
    second half of the stream gives both the same rows and the same
    change events, their ids going on from the persisted log."""
    rng = random.Random(4242)
    stream = _random_stream(rng, n_versions=20)
    first, second = stream[:10], stream[10:]
    base = str(tmp_path / "base")
    os.makedirs(base)

    async def make_base():
        a = await ref_testing.launch_test_agent(tmpdir=base)
        try:
            for sql in SUB_SQLS:
                a.subs.subscribe(sql)
            for item in first:
                _feed_one(REF, a, item)
                await asyncio.to_thread(_wait_idle, a.subs)
        finally:
            await a.stop()

    async def resume(pkg, d):
        kw = PORT_KW if pkg is PORT else {}
        a = await pkg["testing"].launch_test_agent(tmpdir=d, **kw)
        try:
            subs = sorted(a.subs.list(), key=lambda s: s["sql"])
            handles = [a.subs.get(s["id"]) for s in subs]
            start = [(h.id, h.last_change_id, sorted(h.rows.values()))
                     for h in handles]
            gens = [h.stream(from_change_id=h.last_change_id)
                    for h in handles]
            events = [[] for _ in handles]
            for item in second:
                _feed_one(pkg, a, item)
                await asyncio.to_thread(_wait_idle, a.subs)
                for h, g, evs, (_, cid0, _) in zip(handles, gens, events,
                                                   start):
                    _take(g, h, evs, start=cid0)
            for g in gens:
                g.close()
            end = [(h.last_change_id, sorted(h.rows.values()))
                   for h in handles]
            return [s["sql"] for s in subs], start, events, end
        finally:
            await a.stop()

    async def main():
        await make_base()
        shutil.copytree(base, str(tmp_path / "ref"))
        shutil.copytree(base, str(tmp_path / "port"))
        want = await resume(REF, str(tmp_path / "ref"))
        got = await resume(PORT, str(tmp_path / "port"))
        return want, got

    want, got = asyncio.run(asyncio.wait_for(main(), 50))
    assert got[0] == want[0] == sorted(SUB_SQLS)
    assert got[1] == want[1]
    assert any(cid > 0 for _, cid, _ in got[1])
    assert got[2] == want[2]
    assert got[3] == want[3]
    # change ids continue after the persisted log, one a change
    for (_, cid0, _), evs in zip(got[1], got[2]):
        ids = [ev["change"][3] for ev in evs]
        assert ids == list(range(cid0 + 1, cid0 + 1 + len(ids)))
    assert sum(len(evs) for evs in got[2]) > 10


# -- a version delivered in chunks ---------------------------------------

def _chunked_run(pkg, tmpdir, whole):
    """Three small foreign versions, then one of 2,000 changes in four
    chunks (``whole``: as one complete changeset), through
    ``handle_change`` into a node whose subscriptions stream."""
    from tests import test_torch_agent as ta

    os.makedirs(tmpdir)
    kw = PORT_KW if pkg is PORT else {}
    a = pkg["testing"].make_offline_agent(tmpdir, **kw)
    mgr = pkg["subs"](a, tmpdir + "/subs")
    try:
        handles = [mgr.subscribe(sql) for sql in SUB_SQLS]
        gens = [h.stream() for h in handles]
        events = [[] for _ in handles]
        cvs = ta._foreign_versions(ta.PORT if pkg is PORT else ta.REF, 0,
                                   big=2000)
        if whole:
            parts = [cv.changeset for cv in cvs[3:]]
            changes = [c for cs in parts for c in cs.changes]
            cs = pkg["changeset"].full(
                parts[0].version, changes, (0, len(changes) - 1),
                len(changes) - 1, parts[0].ts)
            cvs = cvs[:3] + [pkg["change_v1"](actor_id=cvs[0].actor_id,
                                              changeset=cs)]
        for cv in cvs:
            a.handle_change(cv, pkg["source"].SYNC, rebroadcast=False)
            _wait_idle(mgr)
            for h, g, evs in zip(handles, gens, events):
                _take(g, h, evs)
        truths = [sorted((tuple(jsonable_row(r))
                          for r in a.storage.read_query(sql)[1]), key=repr)
                  for sql in SUB_SQLS]
        rows = [sorted((tuple(c) for _, c in h.rows.values()), key=repr)
                for h in handles]
        for g in gens:
            g.close()
        return events, rows, truths
    finally:
        mgr.close()
        a.storage.close()


def test_chunked_version_reaches_subscriptions_whole(tmp_path):
    """A version that arrives in chunks is buffered until its last chunk
    applies it: the port's subscriptions then see the whole version in
    one wave, the events the reference gives for the same version
    delivered whole, and rows equal to the query's."""
    want = _chunked_run(REF, str(tmp_path / "ref"), whole=True)
    got = _chunked_run(PORT, str(tmp_path / "port"), whole=False)
    assert got == want
    events, rows, truths = got
    assert rows == truths and len(truths[0]) > 900
    assert sum("change" in ev for ev in events[0]) > 900
