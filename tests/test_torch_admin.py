"""The port's admin socket (``corrosion_tpu_torch/agent/admin.py``)
against the reference's.

Two agents of each package (fixed site ids, the same writes, one
subscription) answer every command of the reference's list on the first
node's socket.  The deterministic replies are equal field for field;
the ones that carry addresses, times or measured RTTs are equal in
their shape (keys, and the types of their values) and in their
deterministic fields.  Each package's client also talks to the other's
socket.
"""

import asyncio
import re

import pytest

from corrosion_tpu.agent import admin as ref_admin
from corrosion_tpu.agent import testing as ref_testing
from corrosion_tpu_torch.agent import admin as port_admin
from corrosion_tpu_torch.agent import testing as port_testing

SITE_A = bytes(range(60, 76))
SITE_B = bytes(range(80, 96))
SUB_SQL = "SELECT id, text FROM tests"

# (command, arguments): the reference's list (admin.py), each answered
EXACT = (
    ("ping", {}),
    ("sync_generate", {}),
    ("sync_reconcile_gaps", {}),
    ("faults", {}),
    ("cluster_rejoin", {}),
    ("cluster_set_id", {"cluster_id": 0}),
    ("actor_version", {}),
    ("actor_version", {"actor": SITE_B.hex()}),
    ("subs_info", {"id": "no-such-id"}),
    ("db_info", {}),
    ("rtt_dump", {"tier_edges_ms": [5.0, 1.0]}),
    ("cluster_set_id", {}),
    ("no_such_command", {}),
)
SHAPED = (
    ("cluster_members", {}),
    ("rtt_dump", {}),
    ("rtt_dump", {"tier_edges_ms": [1.0, 10.0]}),
    ("transport_stats", {}),
    ("health", {}),
    ("flight_dump", {}),
    ("flight_events", {}),
    ("sync_sessions", {}),
    ("locks", {}),
    ("subs_list", {}),
)

# the fields of each row of the replies that list what is live
LIVE_ROWS = {
    "locks": ("held_s", "id", "kind", "label", "state"),
    "sync_sessions": ("age_s", "bytes", "changes", "id", "needs_done",
                      "needs_remaining", "needs_total", "peer", "role"),
}

# the fields of each binned member of ``rtt_dump``
RTT_NODE = ("actor", "ring0", "rtt_ms", "samples", "tier")


def _shape(x):
    """``x`` with every value replaced by its type, lists by the set of
    their items' shapes and ``host:port`` keys by one mark."""
    if isinstance(x, dict):
        return {("<addr>" if re.fullmatch(r"[\d.]+:\d+", str(k)) else k):
                _shape(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return ("list", sorted({repr(_shape(v)) for v in x}))
    if isinstance(x, bool) or x is None:
        return type(x).__name__
    if isinstance(x, (int, float)):
        return "number"
    return type(x).__name__


def _view(cmd, reply):
    """What of a reply in ``SHAPED`` two runs must share: its shape; of
    the flight ring (whose records follow the run's timing) the
    recorder's shape and the kinds of the records."""
    status, x = reply
    if status != "ok":
        return reply
    if cmd == "health":
        # its lag paths, slow sites and staleness follow the run's timing
        return (_shape({k: v for k, v in x.items()
                        if k not in ("loop", "convergence_lag",
                                     "origin_staleness_s")}),
                sorted(x["loop"]), type(x["convergence_lag"]).__name__,
                type(x["origin_staleness_s"]).__name__)
    if cmd in LIVE_ROWS:
        # the rows live at the moment of the call, each of its format
        return all(tuple(sorted(e)) == LIVE_ROWS[cmd] for e in x)
    if cmd == "rtt_dump":
        # a member is binned once its ring holds a sample: the script's
        # ``cluster_set_id`` forgets the members and the re-announce
        # adds the peer back with an empty ring, so whether it is
        # binned by the call follows the run's timing; shared are the
        # member count, the binned rows' format and the bins' sum
        return (_shape({k: v for k, v in x.items()
                        if k not in ("weights", "nodes")}),
                x["members_sampled"] + x["members_unsampled"],
                sum(x["weights"]) == len(x["nodes"]) == x["members_sampled"],
                all(tuple(sorted(n)) == RTT_NODE for n in x["nodes"]))
    if cmd == "flight_dump":
        return (_shape(x["recorder"]),
                all(e["t"] in ("snap", "event") for e in x["entries"]))
    if cmd == "flight_events":
        return all(e["t"] == "event" for e in x)
    return _shape(reply)


def _call(client, cmd, kw):
    try:
        return ("ok", client.call(cmd, **kw))
    except RuntimeError as e:
        return ("error", str(e))


def _replies(testing, mod, tmp, **kw):
    """The replies on node A's socket, and a few facts besides (the
    sockets beside ``tmp``, whose paths stay short)."""
    socks = {n: str(tmp.parent / f"{tmp.name[0]}{n}.sock") for n in "ab"}

    async def main():
        a = await testing.launch_test_agent(
            tmpdir=str(tmp / "a"), site_id=SITE_A,
            admin_path=socks["a"], **kw)
        b = None
        try:
            b = await testing.launch_test_agent(
                tmpdir=str(tmp / "b"), site_id=SITE_B,
                admin_path=socks["b"],
                bootstrap=[f"{a.gossip_addr[0]}:{a.gossip_addr[1]}"], **kw)
            await testing.wait_for(
                lambda: a.members.alive() and b.members.alive(), timeout=10)
            for w in (
                [("INSERT INTO tests (id, text) VALUES (?, ?)", (i, f"t{i}"))
                 for i in range(20)],
                [("UPDATE tests SET text = 'x' WHERE id % 3 = 0",)],
                [("DELETE FROM tests WHERE id = 4",)],
            ):
                await asyncio.to_thread(a.execute_transaction, w)
            await asyncio.to_thread(b.execute_transaction, [
                ("INSERT INTO tests2 (id, text) VALUES (1, 'b')",)])
            await testing.wait_for(
                lambda: b.bookie.for_actor(a.actor_id).last() == 3
                and a.bookie.for_actor(b.actor_id).last() == 1, timeout=10)
            sub = a.subs.subscribe(SUB_SQL)
            # the subscription settled and B's RTT measured on both sides
            await testing.wait_for(
                lambda: a.subs.idle()
                and a.members.get(b.actor_id).rtt_ms is not None
                and b.members.get(a.actor_id).rtt_ms is not None,
                timeout=10)

            def drive():
                c = mod.AdminClient(socks["a"])
                try:
                    exact = [_call(c, cmd, kw) for cmd, kw in EXACT]
                    info = _call(c, "subs_info", {"id": sub.id})
                    shaped = [_call(c, cmd, kw) for cmd, kw in SHAPED]
                    spans = c.call("trace_spans", limit=500)
                    members = c.call("cluster_members")
                    subs = c.call("subs_list")
                finally:
                    c.close()
                return exact, info, shaped, spans, members, subs

            exact, info, shaped, spans, members, subs = (
                await asyncio.to_thread(drive))
            return dict(exact=exact, info=info, shaped=shaped, spans=spans,
                        members=members, subs=subs, sub_id=sub.id)
        finally:
            if b is not None:
                await b.stop()
            await a.stop()

    (tmp / "a").mkdir()
    (tmp / "b").mkdir()
    return asyncio.run(asyncio.wait_for(main(), 60))


def test_every_command_answers_as_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _replies(ref_testing, ref_admin, tmp_path / "ref")
    got = _replies(port_testing, port_admin, tmp_path / "port", device="cpu")
    assert got["exact"] == want["exact"]
    assert got["exact"][0] == ("ok", "pong")
    assert got["exact"][-1] == ("error", "unknown command 'no_such_command'")
    assert dict(got["exact"][9][1])["db_version"] == 3
    # the subscription's info, its random id aside
    for r in (got, want):
        assert r["info"][0] == "ok" and r["info"][1].pop("id") == r["sub_id"]
        assert [s.pop("id") for s in r["subs"]] == [r["sub_id"]]
    assert got["info"] == want["info"]
    assert got["info"][1]["rows"] == 19
    assert got["subs"] == want["subs"]
    # the peer's record: its deterministic fields equal (ring0 follows
    # the measured RTT)
    keep = ("actor", "state", "quarantined", "quarantine_reason", "breaker")
    assert [{k: m[k] for k in keep} for m in got["members"]] == [
        {k: m[k] for k in keep} for m in want["members"]]
    assert [m["actor"] for m in got["members"]] == [SITE_B.hex()]
    assert [_view(cmd, r) for (cmd, _), r in zip(SHAPED, got["shaped"])] == [
        _view(cmd, r) for (cmd, _), r in zip(SHAPED, want["shaped"])]
    assert all(r[0] == "ok" for r in got["shaped"])
    # the spans (one ring a process for each package): the same fields,
    # and the writes' spans under the same names
    for r in (got, want):
        assert r["spans"] and {tuple(sp) for sp in r["spans"]} == {(
            "name", "trace_id", "span_id", "parent_id", "start", "dur_ms",
            "attrs")}
    names = [{sp["name"] for sp in r["spans"]
              if sp["name"].startswith("write.")} for r in (got, want)]
    assert names[0] == names[1] and names[0]


@pytest.mark.parametrize("pair", ["port_client_ref_socket",
                                  "ref_client_port_socket"])
def test_clients_speak_each_others_socket(pair, tmp_path):
    serve, client = ((ref_testing, port_admin) if pair.startswith("port")
                     else (port_testing, ref_admin))
    kw = {"device": "cpu"} if serve is port_testing else {}

    async def main():
        a = await serve.launch_test_agent(
            tmpdir=str(tmp_path), site_id=SITE_A,
            admin_path=str(tmp_path / "x.sock"), **kw)
        try:
            await asyncio.to_thread(a.execute_transaction, [
                ("INSERT INTO tests (id, text) VALUES (1, 'x')",)])

            def drive():
                c = client.AdminClient(str(tmp_path / "x.sock"))
                try:
                    return (c.call("ping"), c.call("actor_version"),
                            _call(c, "nope", {}))
                finally:
                    c.close()

            return await asyncio.to_thread(drive)
        finally:
            await a.stop()

    ping, version, err = asyncio.run(asyncio.wait_for(main(), 30))
    assert ping == "pong"
    assert version == {"actor": SITE_A.hex(), "last": 1, "needed": [],
                       "partials": {}, "cleared": []}
    assert err == ("error", "unknown command 'nope'")
