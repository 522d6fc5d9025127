"""The port's live agent (``corrosion_tpu_torch/agent/runtime.py`` and its
host modules) against the reference's, on the CPU.

* the codecs: speedy frames, ``ChangeV1`` / ``Changeset``, the sync
  messages, ``Timestamp`` / ``HLClock`` and ``RangeSet`` give the
  reference's bytes and values on the same seeded inputs;
* an offline node: the same transactions and foreign changesets through
  both packages' ``make_offline_agent`` leave equal tables, clock state
  and bookkeeping, and ``_serve_need`` writes the reference's frames;
* the device path on the CPU: the clock cache on (a torch store on the
  CPU) and the winner selection's plain torch core give the cache-off
  state;
* a mixed cluster: a reference agent and a port agent meet on loopback,
  write on both sides and converge;
* resume: a port agent boots on a reference agent's database;
* refusals: the card without one, and every unported surface.
"""

import asyncio
import dataclasses
import enum
import random

import pytest

from corrosion_tpu import clock as ref_clock
from corrosion_tpu import types as ref_types
from corrosion_tpu.agent import pack as ref_pack
from corrosion_tpu.agent import testing as ref_testing
from corrosion_tpu.agent.runtime import ChangeSource as RefChangeSource
from corrosion_tpu.bridge import speedy as ref_speedy
from corrosion_tpu.types import change as ref_change
from corrosion_tpu.utils.ranges import RangeSet as RefRangeSet
from corrosion_tpu_torch import clock as port_clock
from corrosion_tpu_torch import types as port_types
from corrosion_tpu_torch.agent import pack as port_pack
from corrosion_tpu_torch.agent import runtime as port_runtime
from corrosion_tpu_torch.agent import testing as port_testing
from corrosion_tpu_torch.bridge import speedy as port_speedy
from corrosion_tpu_torch.types import change as port_change
from corrosion_tpu_torch.utils.ranges import RangeSet as PortRangeSet

REF = dict(types=ref_types, change=ref_change, speedy=ref_speedy,
           pack=ref_pack, clock=ref_clock, testing=ref_testing,
           source=RefChangeSource)
PORT = dict(types=port_types, change=port_change, speedy=port_speedy,
            pack=port_pack, clock=port_clock, testing=port_testing,
            source=port_runtime.ChangeSource)

SITE = bytes(range(16))
FOREIGN = bytes(range(100, 116))


def _plain(x):
    """A value of either package as plain hashable Python data, class
    names kept: two packages' objects compare equal exactly when their
    fields do."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return ("dict", tuple(sorted(
            ((_plain(k), _plain(v)) for k, v in x.items()), key=repr)))
    if isinstance(x, bool) or x is None:
        return x
    if isinstance(x, int):
        return int(x)
    if hasattr(x, "spans"):  # RangeSet
        return ("RangeSet", tuple(tuple(s) for s in x.spans()))
    return x


def _value(rng):
    k = rng.randrange(5)
    if k == 0:
        return rng.randrange(-2**62, 2**62)
    if k == 1:
        return rng.random() * 1e6
    if k == 2:
        return "".join(rng.choice("abcé✓ ") for _ in range(rng.randrange(12)))
    if k == 3:
        return bytes(rng.randrange(256) for _ in range(rng.randrange(9)))
    return None


def _changes(pkg, seed, n, site=FOREIGN, table="tests"):
    rng = random.Random(seed)
    ch = pkg["change"]
    out = []
    for i in range(n):
        out.append(ch.Change(
            table=table, pk=pkg["pack"].pack_values([rng.randrange(50)]),
            cid="text", val=_value(rng),
            col_version=rng.randrange(1, 9),
            db_version=ch.CrsqlDbVersion(1 + i // 3),
            seq=ch.CrsqlSeq(i), site_id=site, cl=1 + 2 * rng.randrange(3),
        ))
    return out


def _changesets(pkg, seed):
    t = pkg["types"]
    ts = t.Timestamp.pack(1_700_000_000_123_456_789, 7)
    chs = _changes(pkg, seed, 9)
    return [
        t.Changeset.full(t.Version(3), chs, (0, 8), 8, ts),
        t.Changeset.full(t.Version(4), chs[:4], (0, 3), 11, ts),
        t.Changeset.empty((5, 9), ts),
        t.Changeset.empty_set([(2, 2), (6, 8)], ts),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codecs_equal_reference(seed):
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        t, sp = pkg["types"], pkg["speedy"]
        got = []
        for cs in _changesets(pkg, seed):
            cv = t.ChangeV1(actor_id=t.ActorId(FOREIGN), changeset=cs)
            payload = sp.encode_uni_payload(t.UniPayload(
                broadcast=t.BroadcastV1(change=cv),
                cluster_id=t.ClusterId(3)))
            traced = sp.encode_traced_uni(payload, "00-ab-cd-01", 2)
            frames = sp.frame(payload) + sp.frame(traced)
            back = [sp.decode_uni_envelope(p)
                    for p in sp.FrameReader().feed(frames)]
            got.append((payload, traced, frames, _plain(back),
                        _plain(sp.decode_uni_payload(payload))))
            got.append(sp.encode_sync_message(cv))
        for ch in _changes(pkg, seed + 10, 6):
            b = sp.encode_change(ch)
            got.append((b, _plain(sp.decode_change(b))))
        state = t.SyncStateV1(actor_id=t.ActorId(SITE))
        state.heads[t.ActorId(FOREIGN)] = t.Version(9)
        state.need[t.ActorId(FOREIGN)] = [(2, 4), (7, 7)]
        state.partial_need[t.ActorId(FOREIGN)] = {t.Version(8): [(0, 5)]}
        needs = [t.SyncNeedV1.full(1, 5), t.SyncNeedV1.partial(8, [(0, 5)]),
                 t.SyncNeedV1.empty(t.Timestamp.pack(10**18, 1))]
        request = ("request", [(t.ActorId(FOREIGN), needs),
                               (t.ActorId(SITE), needs[:1])])
        for msg in (state, request, t.Timestamp.pack(10**18, 3),
                    ("rejection", 1)):
            b = sp.encode_sync_message(msg)
            got.append((b, _plain(sp.decode_sync_message(b))))
        # the hybrid logical clock on a fixed physical source
        phys = [5_000, 5_000, 4_000, 9_000, 9_000, 12_000]
        hlc = t.HLClock(now_ns=lambda: phys.pop(0) if len(phys) > 1
                        else phys[0])
        stamps = [hlc.new_timestamp() for _ in range(3)]
        hlc.update_with_timestamp(t.Timestamp.pack(8_000, 40))
        stamps += [hlc.new_timestamp(), hlc.observe_timestamp(), hlc.last]
        got.append([(int(s), s.physical_ns, s.logical) for s in stamps])
        out[name] = got
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("seed", [0, 1])
def test_rangeset_equals_reference(seed):
    rng = random.Random(seed)
    ops = []
    for _ in range(200):
        a = rng.randrange(60)
        ops.append((rng.choice(("insert", "remove")), a, a + rng.randrange(6)))
    sets = {}
    for name, cls in (("ref", RefRangeSet), ("port", PortRangeSet)):
        rs, trail = cls(), []
        for op, a, b in ops:
            getattr(rs, op)(a, b)
            trail.append((rs.spans(), rs.count(), rs.contains(a),
                          rs.gaps(0, 70), rs.intersection_spans(a, b + 3)))
        sets[name] = trail
    assert sets["port"] == sets["ref"]


# -- offline node ------------------------------------------------------

WRITES = [
    [("INSERT INTO tests (id, text) VALUES (?, ?)", (i, f"t{i}"))
     for i in range(40)],
    [("UPDATE tests SET text = ? WHERE id % 3 = 0", ("three",)),
     ("INSERT INTO tests2 (id, text) VALUES (?, ?)", (1, "x"))],
    [("DELETE FROM tests WHERE id % 5 = 1",)],
    [("INSERT INTO testsblob (id, text) VALUES (?, ?)", (b"\x01\x02", "b"))],
    [("INSERT INTO tests (id, text) VALUES (?, ?)", (1, "back"))],
]


def _dump(agent):
    c = agent.storage.conn
    out = {}
    for t in ("tests", "tests2", "testsblob"):
        out[t] = c.execute(f'SELECT * FROM "{t}" ORDER BY id').fetchall()
        out[t + ".clock"] = c.execute(
            f'SELECT c.pk, c.cid, c.col_version, s.site_id '
            f'FROM "{t}__corro_clock" c JOIN __corro_sites s '
            f'ON s.ordinal = c.site_ordinal ORDER BY c.pk, c.cid'
        ).fetchall()
        out[t + ".cl"] = c.execute(
            f'SELECT pk, cl FROM "{t}__corro_cl" ORDER BY pk').fetchall()
    return out


def _books(agent):
    return {
        bytes(actor): (bv.needed.spans(), bv.cleared.spans(),
                       dict(bv.versions), bv.max_version,
                       sorted(int(v) for v in bv.partials),
                       _plain(bv.last_cleared_ts), bv.snap_floor)
        for actor, bv in agent.bookie.actors().items()
    }


def _foreign_versions(pkg, seed, big=0):
    """Foreign changesets for ``handle_change``: small ones, then (with
    ``big``) one version of ``big`` changes in 4 chunks."""
    t, ch = pkg["types"], pkg["change"]
    ts = t.Timestamp.pack(1_600_000_000_000_000_000, 0)
    out = []
    for v in range(1, 4):
        chs = _changes(pkg, seed + v, 5)
        chs = [dataclasses.replace(c, seq=ch.CrsqlSeq(i),
                                   db_version=ch.CrsqlDbVersion(v))
               for i, c in enumerate(chs)]
        out.append(t.Changeset.full(t.Version(v), chs, (0, 4), 4, ts))
    if big:
        rng = random.Random(seed)
        chs = [ch.Change(
            table="tests", pk=pkg["pack"].pack_values([i % (big // 2)]),
            cid="text", val=f"big{rng.randrange(1000)}",
            col_version=1 + rng.randrange(3),
            db_version=ch.CrsqlDbVersion(4), seq=ch.CrsqlSeq(i),
            site_id=FOREIGN, cl=1) for i in range(big)]
        step = big // 4
        for k in range(4):
            part = chs[k * step:(k + 1) * step]
            out.append(t.Changeset.full(
                t.Version(4), part, (k * step, (k + 1) * step - 1),
                big - 1, ts))
    return [t.ChangeV1(actor_id=t.ActorId(FOREIGN), changeset=cs)
            for cs in out]


def _offline(pkg, tmp, seed, big=0, **kw):
    ag = pkg["testing"].make_offline_agent(
        tmpdir=str(tmp), site_id=SITE, clock=pkg["clock"].VirtualClock(),
        **kw)
    try:
        results = [ag.execute_transaction(w) for w in WRITES]
        for cv in _foreign_versions(pkg, seed, big):
            ag.handle_change(cv, pkg["source"].SYNC, rebroadcast=False)
        ag.storage.flush_pending()
        frames = []

        async def serve():
            for actor in (SITE, FOREIGN):
                for need in (pkg["types"].SyncNeedV1.full(1, 5),
                             pkg["types"].SyncNeedV1.partial(2, [(1, 3)])):
                    w = pkg["testing"].CaptureWriter()
                    await ag._serve_need(w, actor, need)
                    frames.append(bytes(w.buf))

        asyncio.run(serve())
        sync = pkg["speedy"].encode_sync_message(ag.generate_sync())
        return dict(results=[(r["version"], r.get("rows_affected"))
                             for r in results],
                    dump=_dump(ag), books=_books(ag), frames=frames,
                    sync=sync, actor=ag.actor_id)
    finally:
        ag.storage.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_offline_node_equals_reference(seed, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _offline(REF, tmp_path / "ref", seed)
    got = _offline(PORT, tmp_path / "port", seed, device="cpu")
    assert want["dump"]["tests"] and want["frames"][0]
    assert got == want


@pytest.mark.parametrize("arm", ["cache", "cache_torch_winners",
                                 "nocache_torch_winners"])
def test_device_path_on_cpu_equals_reference(arm, tmp_path, monkeypatch):
    """The device-resident apply on the CPU (the clock cache's torch
    store, the winner selection's plain torch core from a threshold
    lowered to this batch's 1,024 changes) leaves the reference's state
    in the same arm, and the cache-off tables and clock state.  (With the
    cache on, both packages leave the overwritten-version sweep of the
    own actor's versions to a later pass, so bookkeeping is compared
    arm by arm.)"""
    from corrosion_tpu_torch.ops import merge

    cache = arm.startswith("cache")
    for d in ("ref", "off", "on"):
        (tmp_path / d).mkdir()
    want = _offline(REF, tmp_path / "ref", 0, big=1024, device_cache=cache)
    off = _offline(PORT, tmp_path / "off", 0, big=1024, device="cpu",
                   device_cache=False)
    calls = []
    real = merge._winners_torch

    def spy(plan, device):
        calls.append((plan.n, str(device)))
        return real(plan, device)

    monkeypatch.setattr(merge, "_winners_torch", spy)
    if arm.endswith("torch_winners"):
        monkeypatch.setattr(merge, "TORCH_AUTO_MIN", 1024)
    on = _offline(PORT, tmp_path / "on", 0, big=1024, device="cpu",
                  device_cache=cache)
    assert on == want
    assert on["dump"] == off["dump"]
    assert on["results"] == off["results"]
    if arm.endswith("torch_winners"):
        assert (1024, "cpu") in calls
    else:
        assert calls == []


def test_offline_agent_keeps_the_cache_on_its_device(tmp_path):
    ag = port_testing.make_offline_agent(tmpdir=str(tmp_path), device="cpu",
                                         device_cache=True)
    try:
        for cv in _foreign_versions(PORT, 0):
            ag.handle_change(cv, port_runtime.ChangeSource.SYNC,
                             rebroadcast=False)
        ag.storage.flush_pending()
        dc = ag.storage.device_cache
        assert dc.backend == "torch" and dc.store.device.type == "cpu"
        assert ag.storage.device.type == "cpu"
        arrays = [tc.row_cl for tc in dc._tables.values()]
        arrays += [tc.cell_ver for tc in dc._tables.values()]
        assert arrays and all(a.device.type == "cpu" for a in arrays)
    finally:
        ag.storage.close()
    # auto: off on the CPU, as the reference's rule on a CPU backend
    (tmp_path / "auto").mkdir()
    ag = port_testing.make_offline_agent(tmpdir=str(tmp_path / "auto"),
                                         device="cpu")
    try:
        assert ag.storage.device_cache is None
    finally:
        ag.storage.close()


# -- a mixed cluster ---------------------------------------------------

MIXED = dict(swim_wire="json", transport_mux=False, api_port=None,
             subs_enabled=False)


def _rows(agent):
    return agent.storage.read_query(
        "SELECT id, text FROM tests ORDER BY id")[1]


def test_mixed_cluster_converges_on_loopback(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()

    async def main():
        ref = await ref_testing.launch_test_agent(tmpdir=str(tmp_path / "ref"),
                                                  **MIXED)
        port = None
        try:
            port = await port_testing.launch_test_agent(
                bootstrap=[f"{ref.gossip_addr[0]}:{ref.gossip_addr[1]}"],
                tmpdir=str(tmp_path / "port"), device="cpu")
            await port_testing.wait_for(
                lambda: ref.members.alive() and port.members.alive(),
                timeout=10)
            await asyncio.to_thread(ref.execute_transaction, [
                ("INSERT INTO tests (id, text) VALUES (?, ?)", (i, f"r{i}"))
                for i in range(20)])
            await asyncio.to_thread(port.execute_transaction, [
                ("INSERT INTO tests (id, text) VALUES (?, ?)", (i, f"p{i}"))
                for i in range(20, 30)])
            await asyncio.to_thread(port.execute_transaction, [
                ("UPDATE tests SET text = 'both' WHERE id % 4 = 0",)])
            await port_testing.wait_for(
                lambda: len(_rows(ref)) == 30 and _rows(ref) == _rows(port),
                timeout=10)
            await port_testing.wait_for(
                lambda: _dump(ref) == _dump(port), timeout=10)
            assert ref.bookie.for_actor(port.actor_id).contains_version(2)
            assert port.bookie.for_actor(ref.actor_id).contains_version(1)
        finally:
            if port is not None:
                await port.stop()
            await ref.stop()

    asyncio.run(asyncio.wait_for(main(), 60))


# -- resume ------------------------------------------------------------

def test_port_agent_resumes_a_reference_database(tmp_path):
    ref = ref_testing.make_offline_agent(tmpdir=str(tmp_path))
    for w in WRITES:
        ref.execute_transaction(w)
    want = dict(actor=ref.actor_id, dump=_dump(ref), books=_books(ref),
                sync=ref_speedy.encode_sync_message(ref.generate_sync()),
                incarnation=ref.incarnation)
    ref.storage.close()
    port = port_testing.make_offline_agent(tmpdir=str(tmp_path), device="cpu")
    try:
        assert port.actor_id == want["actor"]
        assert _dump(port) == want["dump"]
        assert _books(port) == want["books"]
        assert port_speedy.encode_sync_message(
            port.generate_sync()) == want["sync"]
        assert port.incarnation == want["incarnation"] + 1
        res = port.execute_transaction(
            [("INSERT INTO tests (id, text) VALUES (?, ?)", (99, "port"))])
        assert res["version"] == len(WRITES) + 1
    finally:
        port.storage.close()


# -- refusals ----------------------------------------------------------

def test_card_without_one_raises_before_opening(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = tmp_path / "corrosion.db"
    cfg = port_runtime.AgentConfig(db_path=str(db), **MIXED)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_runtime.Agent(cfg)
    assert not db.exists()


UNPORTED = {
    "api_port": 0,
    "subs_enabled": True,
    "admin_path": "admin.sock",
    "pg_port": 0,
    "transport_mux": True,
    "swim_wire": "foca",
    "sig_secret": bytes(32),
    "sig_key_file": "key.hex",
    "sig_pubkeys": {},
}


@pytest.mark.parametrize("field", list(UNPORTED))
def test_unported_surface_raises(field, tmp_path):
    assert {s[0] for s in port_runtime.UNPORTED_SURFACES} == set(UNPORTED)
    assert port_runtime.PORTED_ONLY == {
        s[0]: s[1] for s in port_runtime.UNPORTED_SURFACES}
    kw = dict(MIXED, device="cpu")
    kw[field] = UNPORTED[field]
    db = tmp_path / "corrosion.db"
    with pytest.raises(NotImplementedError, match=f"AgentConfig.{field} "):
        port_runtime.Agent(port_runtime.AgentConfig(db_path=str(db), **kw))
    assert not db.exists()


def test_reference_defaults_ask_for_unported_surfaces(tmp_path):
    # AgentConfig keeps the reference's defaults: the HTTP API comes
    # first among the surfaces they ask for
    with pytest.raises(NotImplementedError, match="AgentConfig.api_port "):
        port_runtime.Agent(port_runtime.AgentConfig(
            db_path=str(tmp_path / "c.db"), device="cpu"))


def test_foca_datagram_and_mux_stream_raise(tmp_path):
    async def main():
        a = await port_testing.launch_test_agent(tmpdir=str(tmp_path),
                                                 device="cpu")
        try:
            proto = port_runtime._UdpProtocol(a)
            with pytest.raises(NotImplementedError, match="swim_wire"):
                proto.datagram_received(b"\x10" + bytes(16), ("127.0.0.1", 1))
            # data that is neither JSON nor foca is dropped, as the JSON
            # branch drops a malformed envelope
            for junk in (b"", b"\x00junk", b"\xff" * 9, b"{not json"):
                proto.datagram_received(junk, ("127.0.0.1", 1))
            r, w = await asyncio.open_connection(*a.gossip_addr)
            w.write(port_runtime.STREAM_MUX)
            await w.drain()
            # the server closes the stream and raises in its handler
            assert await asyncio.wait_for(r.read(), 5) == b""
            w.close()
        finally:
            await a.stop()

    asyncio.run(asyncio.wait_for(main(), 30))
