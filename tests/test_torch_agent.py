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
  write on both sides and converge, on the JSON wire with a connection
  per channel class and at the reference's defaults (foca SWIM, the
  multiplexed transport, HTTP and subscriptions on);
* resume: a port agent boots on a reference agent's database;
* the defaults: a bare ``AgentConfig`` starts, serves ``/v1/members``
  and stops;
* every further surface (the admin socket, the PostgreSQL wire, signed
  attribution by key, key file or trust directory) starts, serves and
  stops; a signed conflicting pair gives the reference's verdict and
  proof row;
* refusal: the card without one.
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


def _count_datagrams(monkeypatch):
    """Count, per package, the SWIM datagrams its agents decode as foca
    and as JSON envelopes."""
    from corrosion_tpu.agent import swim_foca as ref_foca
    from corrosion_tpu.agent import wire as ref_wire
    from corrosion_tpu_torch.agent import swim_foca as port_foca
    from corrosion_tpu_torch.agent import wire as port_wire

    seen = {(p, w): 0 for p in ("ref", "port") for w in ("foca", "json")}
    for pkg, mod, name, w in (
            ("ref", ref_foca, "handle_datagram", "foca"),
            ("port", port_foca, "handle_datagram", "foca"),
            ("ref", ref_wire, "decode_datagram", "json"),
            ("port", port_wire, "decode_datagram", "json")):
        def counted(*a, _real=getattr(mod, name), _key=(pkg, w)):
            seen[_key] += 1
            return _real(*a)
        monkeypatch.setattr(mod, name, counted)
    return seen


def _mux_counts(agent):
    """(uni mux frames sent, bi mux channels opened) by ``agent``."""
    m = agent.metrics
    return (m.get_counter("corro_transport_frames_total", channel="uni"),
            m.get_counter("corro_transport_bi_channels_total"))


@pytest.mark.parametrize("cfg", [MIXED, {}], ids=["mixed", "defaults"])
def test_mixed_cluster_converges_on_loopback(cfg, tmp_path, monkeypatch):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    seen = _count_datagrams(monkeypatch)

    async def main():
        ref = await ref_testing.launch_test_agent(tmpdir=str(tmp_path / "ref"),
                                                  **cfg)
        port = None
        try:
            port = await port_testing.launch_test_agent(
                bootstrap=[f"{ref.gossip_addr[0]}:{ref.gossip_addr[1]}"],
                tmpdir=str(tmp_path / "port"), device="cpu", **cfg)
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
            await port.sync_round()
            await ref.sync_round()
            for name, a in (("ref", ref), ("port", port)):
                foca_in, json_in = seen[name, "foca"], seen[name, "json"]
                uni, bi = _mux_counts(a)
                if cfg:
                    assert foca_in == 0 and json_in > 0
                    assert uni == 0 and bi == 0
                else:
                    assert foca_in > 0 and json_in == 0
                    assert uni > 0 and bi > 0
                    assert a.api_addr[1] != 0 and a.subs is not None
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


def _threads_left(before):
    """The threads started since ``before`` that do not end within 5 s."""
    import threading

    left = []
    for t in set(threading.enumerate()) - before:
        t.join(timeout=5)
        if t.is_alive():
            left.append(t.name)
    return left


# each surface the reference's config offers beyond its defaults, on
SURFACES = ("admin_path", "pg_port", "sig_secret", "sig_key_file",
            "sig_pubkeys")


@pytest.mark.parametrize("field", SURFACES)
def test_surface_starts_serves_and_stops(field, tmp_path):
    """A CPU port agent with ``field`` on starts, serves the surface
    and stops, leaving none of its threads behind: the admin socket
    answers, a write over the PostgreSQL wire reaches the peer, and a
    signed write (the key given, or read from a file) is verified on the
    peer whose directory holds the signer's key."""
    import threading

    from corrosion_tpu_torch.agent.admin import AdminClient
    from corrosion_tpu_torch.types import crypto
    from tests.pgwire_client import PgClient

    sec, pub = crypto.seed_keypair(b"surface-" + field.encode())
    key_file = tmp_path / "key.hex"
    key_file.write_text(sec.hex() + "\n")
    directory = {}
    on = {
        "admin_path": dict(admin_path=str(tmp_path / "admin.sock")),
        "pg_port": dict(pg_port=0),
        "sig_secret": dict(sig_secret=sec),
        "sig_key_file": dict(sig_key_file=str(key_file)),
        "sig_pubkeys": dict(sig_pubkeys=directory, sig_spot_check_rate=1.0),
    }[field]
    # the peer: it verifies the signer's writes, or signs its own
    peer_kw = (dict(sig_secret=sec) if field == "sig_pubkeys" else
               dict(sig_pubkeys=directory, sig_spot_check_rate=1.0))
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    before = set(threading.enumerate())

    async def main():
        a = await port_testing.launch_test_agent(
            tmpdir=str(tmp_path / "a"), device="cpu", **on)
        b = None
        try:
            b = await port_testing.launch_test_agent(
                bootstrap=[f"{a.gossip_addr[0]}:{a.gossip_addr[1]}"],
                tmpdir=str(tmp_path / "b"), device="cpu", **peer_kw)
            signer, verifier = (b, a) if field == "sig_pubkeys" else (a, b)
            directory[signer.actor_id] = pub
            await port_testing.wait_for(
                lambda: a.members.alive() and b.members.alive(), timeout=10)
            if field == "pg_port":
                def drive():
                    c = PgClient(*a.pg_addr)
                    try:
                        return c.query(
                            "INSERT INTO tests (id, text) VALUES (1, 'pg')")
                    finally:
                        c.close()

                assert (await asyncio.to_thread(drive))[2] == ["INSERT 0 1"]
            else:
                await asyncio.to_thread(signer.execute_transaction, [
                    ("INSERT INTO tests (id, text) VALUES (1, 'pg')",)])
            peer = a if signer is b else b
            await port_testing.wait_for(
                lambda: _rows(peer) == [(1, "pg")], timeout=10)
            if field == "admin_path":
                def admin():
                    c = AdminClient(on["admin_path"])
                    try:
                        return c.call("ping"), c.call("cluster_members")
                    finally:
                        c.close()

                pong, members = await asyncio.to_thread(admin)
                assert pong == "pong"
                assert [m["actor"] for m in members] == [b.actor_id.hex()]
            elif field.startswith("sig_"):
                assert signer._sig_pub == pub
                await port_testing.wait_for(
                    lambda: verifier.metrics.get_counter(
                        "corro_sig_verifications_total", result="ok") >= 1,
                    timeout=10)
                assert verifier.metrics.get_counter(
                    "corro_sig_verifications_total", result="fail") == 0
        finally:
            if b is not None:
                await b.stop()
            await a.stop()

    asyncio.run(asyncio.wait_for(main(), 60))
    assert _threads_left(before) == []


def _signed_verdict(pkg, runtime, crypto, tmp):
    """A signed conflicting pair (two full changesets of one actor's
    version 1, each signed by the actor's key) delivered to an offline
    node of ``pkg``: what each delivery returned, the signatures, the
    verdict, the member record and the proof row."""
    import hashlib
    import math

    t, ch = pkg["types"], pkg["change"]
    sec, pub = crypto.seed_keypair(b"keyed-hostile")
    actor = hashlib.blake2b(b"equivocator:3", digest_size=16).digest()
    ts = t.Timestamp.pack(1_650_000_000_000_000_000, 0)
    pair = []
    for text in ("honest", "forked"):
        c = ch.Change(table="tests", pk=pkg["pack"].pack_values([1]),
                      cid="text", val=text, col_version=1,
                      db_version=ch.CrsqlDbVersion(1), seq=ch.CrsqlSeq(0),
                      site_id=actor, cl=1)
        cs = t.Changeset.full(t.Version(1), [c], (0, 0), 0, ts)
        pair.append(t.ChangeV1(actor_id=t.ActorId(actor), changeset=cs))
    sigs = [crypto.sign(sec, runtime.sig_message(actor, cv.changeset))
            for cv in pair]
    kw = {"device": "cpu"} if pkg is PORT else {}
    a = pkg["testing"].make_offline_agent(
        tmpdir=str(tmp), sig_pubkeys={actor: pub}, equiv_quarantine_s=5.0,
        **kw)
    try:
        a.members.upsert(actor, ("x", 1))
        took = [a.handle_change(cv, pkg["source"].BROADCAST,
                                rebroadcast=False, meta=(None, 0, sig, None))
                for cv, sig in zip(pair, sigs)]
        m = a.members.get(actor)
        return dict(
            took=took, sigs=sigs,
            permanent=a._equiv_quarantined.get(actor) == math.inf,
            member=(m.quarantined, m.quarantine_reason),
            proofs=a.storage.conn.execute(
                "SELECT * FROM __corro_equiv_proofs").fetchall(),
            verified=a.metrics.get_counter(
                "corro_sig_verifications_total", result="ok"),
            rows=_rows(a))
    finally:
        a.storage.close()


def test_signed_equivocation_equals_reference(tmp_path):
    from corrosion_tpu.agent import runtime as ref_runtime
    from corrosion_tpu.types import crypto as ref_crypto
    from corrosion_tpu_torch.types import crypto as port_crypto

    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _signed_verdict(REF, ref_runtime, ref_crypto, tmp_path / "ref")
    got = _signed_verdict(PORT, port_runtime, port_crypto, tmp_path / "port")
    assert got["took"] == [True, False]
    assert got["permanent"] and got["member"] == (True, "signed_equivocation")
    assert len(got["proofs"]) == 1 and got["verified"] >= 1
    assert got == want


def test_bare_config_starts_at_the_reference_defaults(tmp_path):
    """A bare ``AgentConfig`` asks for the reference's surfaces, which
    the port now runs: it starts, serves ``/v1/members`` over HTTP and
    stops, leaving none of its threads behind."""
    import json
    import threading
    import urllib.request

    from corrosion_tpu.agent.runtime import AgentConfig as RefAgentConfig

    ref_cfg = RefAgentConfig(db_path="x")
    cfg = port_runtime.AgentConfig(db_path=str(tmp_path / "c.db"),
                                   device="cpu",
                                   schema_sql=port_testing.TEST_SCHEMA)
    for name in ("api_port", "subs_enabled", "transport_mux", "swim_wire"):
        assert getattr(cfg, name) == getattr(ref_cfg, name)
    before = set(threading.enumerate())

    async def main():
        a = port_runtime.Agent(cfg)
        await a.start()
        try:
            assert a.transport.mux and a.subs is not None
            url = f"http://{a.api_addr[0]}:{a.api_addr[1]}/v1/members"
            body = await asyncio.to_thread(
                lambda: urllib.request.urlopen(url, timeout=10).read())
            assert json.loads(body) == {"members": []}
        finally:
            await a.stop()

    asyncio.run(asyncio.wait_for(main(), 30))
    assert _threads_left(before) == []


SURFACE_MODULES = ("bridge/bincode.py", "bridge/foca.py",
                   "agent/swim_foca.py", "agent/mux.py", "agent/http.py",
                   "agent/pubsub.py", "agent/sqlstate.py", "agent/pgsql.py",
                   "agent/pgparse.py", "agent/pg.py", "agent/admin.py",
                   "types/crypto.py", "bridge/crsqlite_ref.py",
                   "native/__init__.py")


def test_port_imports_neither_jax_nor_the_reference():
    """No module of the port, its agent's surfaces included, and not
    ``chip_smoke.py``, imports ``jax`` or ``corrosion_tpu``: read from
    the sources, and from ``sys.modules`` after importing the surfaces
    and starting an agent with every surface on."""
    import ast
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    pkg = root / "corrosion_tpu_torch"
    for rel in SURFACE_MODULES:
        assert (pkg / rel).is_file(), rel
    files = [f for f in pkg.rglob("*.py") if "build" not in f.parts]
    files.append(root / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "jax", "jaxlib", "corrosion_tpu"), (f, mod)
    code = (
        "import asyncio, sys, tempfile\n"
        + "".join("import corrosion_tpu_torch."
                  f"{m[:-3].replace('/', '.').removesuffix('.__init__')}\n"
                  for m in SURFACE_MODULES)
        + "from corrosion_tpu_torch.agent import runtime, testing\n"
        "async def main():\n"
        "    d = tempfile.mkdtemp()\n"
        "    a = runtime.Agent(runtime.AgentConfig(\n"
        "        db_path=d + '/c.db', device='cpu',\n"
        "        schema_sql=testing.TEST_SCHEMA, pg_port=0,\n"
        "        admin_path=d + '/admin.sock', sig_secret=bytes(32),\n"
        "        sig_pubkeys={}))\n"
        "    await a.start()\n"
        "    await a.stop()\n"
        "asyncio.run(asyncio.wait_for(main(), 30))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)
