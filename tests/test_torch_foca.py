"""The port's foca SWIM wire (``corrosion_tpu_torch/bridge/bincode.py``,
``bridge/foca.py``, ``agent/swim_foca.py``) against the reference's, on
the CPU.

* bincode: seeded unsigned varints and zigzag signed varints give the
  reference's bytes, and each side reads the other's;
* foca datagrams: every message kind over seeded actors and member
  records, the packet-cap fill included, gives the reference's bytes,
  and each side decodes the other's into the same fields;
* live: a reference agent and a port agent, both on ``swim_wire="foca"``,
  meet, probe each other, and a suspicion of the port agent raised by
  the reference agent comes back refuted.
"""

import asyncio
import dataclasses
import random

import pytest

from corrosion_tpu.agent import swim_foca as ref_swim
from corrosion_tpu.agent import testing as ref_testing
from corrosion_tpu.bridge import bincode as ref_bincode
from corrosion_tpu.bridge import foca as ref_foca
from corrosion_tpu_torch.agent import swim_foca as port_swim
from corrosion_tpu_torch.agent import testing as port_testing
from corrosion_tpu_torch.bridge import bincode as port_bincode
from corrosion_tpu_torch.bridge import foca as port_foca

SEEDS = range(4)


def _ints(seed, signed):
    """Seeded values around every varint width's edges."""
    rng = random.Random(seed)
    edges = [0, 1, 250, 251, 0xFFFF, 0x10000, 0xFFFF_FFFF, 0x1_0000_0000,
             2**63 - 1]
    out = list(edges)
    for _ in range(200):
        bits = rng.choice((8, 16, 32, 63))
        out.append(rng.randrange(2**bits))
    if signed:
        out += [-v - 1 for v in out] + [-(2**63)]
    else:
        out.append(2**64 - 1)
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("signed", [False, True], ids=["varint", "zigzag"])
def test_bincode_bytes_equal_reference(seed, signed):
    vals = _ints(seed, signed)
    put = "signed_varint" if signed else "varint"
    bufs = {}
    for name, bc in (("ref", ref_bincode), ("port", port_bincode)):
        w = bc.BWriter()
        for v in vals:
            getattr(w, put)(v)
        w.lp_bytes(bytes(range(seed + 3))).u8(seed)
        bufs[name] = w.getvalue()
    assert bufs["port"] == bufs["ref"]
    for reader, data in ((port_bincode.BReader, bufs["ref"]),
                         (ref_bincode.BReader, bufs["port"])):
        r = reader(data)
        assert [getattr(r, put)() for _ in vals] == vals
        assert r.lp_bytes() == bytes(range(seed + 3)) and r.u8() == seed
        assert r.remaining() == 0


def test_bincode_refusals_equal_reference():
    for bc in (ref_bincode, port_bincode):
        for bad in (lambda w: w.varint(-1), lambda w: w.varint(2**64),
                    lambda w: w.u8(256),
                    lambda w: w.signed_varint(-(2**63) - 1)):
            with pytest.raises(bc.BincodeError):
                bad(bc.BWriter())
        with pytest.raises(bc.BincodeError, match="EOF"):
            bc.BReader(b"\xfc\x00").varint()
        with pytest.raises(bc.BincodeError, match="marker"):
            bc.BReader(b"\xfe" + bytes(16)).varint()


# -- foca datagrams ----------------------------------------------------

def _addr(rng):
    if rng.random() < 0.3:
        return ("::%x:%x" % (rng.randrange(1, 2**16), rng.randrange(2**16)),
                rng.randrange(2**16))
    return (".".join(str(rng.randrange(256)) for _ in range(4)),
            rng.randrange(2**16))


def _actor(foca, rng, cid):
    return foca.FocaActor(id=bytes(rng.randrange(256) for _ in range(16)),
                          addr=_addr(rng), ts=rng.randrange(2**63),
                          cluster_id=cid)


def _datagrams(foca, seed, n_updates):
    """One datagram a message kind over seeded records, built with
    ``foca``'s own classes."""
    rng = random.Random(seed)
    cid = rng.randrange(2**16)
    src, dst, peer = (_actor(foca, rng, cid) for _ in range(3))
    updates = [foca.FocaMember(actor=_actor(foca, rng, cid),
                               incarnation=rng.randrange(2**32),
                               state=rng.randrange(3))
               for _ in range(n_updates)]
    out = []
    for tag in range(11):
        if tag in (foca.PING, foca.ACK):
            msg = foca.FocaMessage(tag=tag, probe_number=rng.randrange(2**16))
        elif tag < foca.ANNOUNCE:
            msg = foca.FocaMessage(tag=tag, peer=peer,
                                   probe_number=rng.randrange(2**16))
        else:
            msg = foca.FocaMessage(tag=tag)
        out.append(foca.FocaDatagram(
            src=src, src_incarnation=rng.randrange(2**32), dst=dst,
            message=msg, updates=list(updates)))
    return out


def _fields(x):
    """A foca value of either package as plain nested tuples."""
    if dataclasses.is_dataclass(x):
        return tuple(_fields(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_fields(v) for v in x)
    return x


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_updates", [0, 3, 200], ids=["none", "few",
                                                        "packet_cap"])
def test_datagrams_equal_reference(seed, n_updates):
    want = [ref_foca.encode_datagram(d)
            for d in _datagrams(ref_foca, seed, n_updates)]
    got = [port_foca.encode_datagram(d)
           for d in _datagrams(port_foca, seed, n_updates)]
    assert got == want
    assert {d[0] for d in want} == {0x10}  # the wire sniff's first byte
    for ref_bytes in want:
        assert len(ref_bytes) <= ref_foca.MAX_PACKET
        p = port_foca.decode_datagram(ref_bytes)
        r = ref_foca.decode_datagram(ref_bytes)
        assert _fields(p) == _fields(r)
        assert port_foca.encode_datagram(p) == ref_bytes
        assert ref_foca.encode_datagram(r) == ref_bytes
        if n_updates == 200:  # filled to the cap, then stopped
            assert 0 < len(p.updates) < n_updates
            member = port_foca.BWriter()
            port_foca._w_member(member, p.updates[0])
            assert len(ref_bytes) + len(member.getvalue()) > \
                port_foca.MAX_PACKET


@pytest.mark.parametrize("seed", SEEDS)
def test_malformed_datagrams_refused_alike(seed):
    rng = random.Random(seed)
    good = ref_foca.encode_datagram(_datagrams(ref_foca, seed, 2)[2])
    cases = [good[:k] for k in sorted(rng.sample(range(1, len(good)), 8))]
    cases += [b"\x10" + bytes(rng.randrange(256) for _ in range(40))
              for _ in range(8)]
    for data in cases:
        outs = []
        for foca in (ref_foca, port_foca):
            try:
                outs.append(_fields(foca.decode_datagram(data)))
            except ValueError as e:
                outs.append(("refused", isinstance(e, foca.FocaError)))
        assert outs[0] == outs[1], data


# -- live: a reference agent and a port agent on the foca wire ---------

def _member_of(a, actor_id):
    m = a.members.get(actor_id)
    return None if m is None else (m.state.value, m.incarnation)


def test_reference_and_port_agents_meet_probe_and_refute(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()

    async def main():
        ref = await ref_testing.launch_test_agent(
            tmpdir=str(tmp_path / "ref"), swim_wire="foca")
        port = None
        try:
            port = await port_testing.launch_test_agent(
                bootstrap=[f"{ref.gossip_addr[0]}:{ref.gossip_addr[1]}"],
                tmpdir=str(tmp_path / "port"), device="cpu",
                swim_wire="foca")
            # meet: each holds the other alive
            await port_testing.wait_for(
                lambda: _member_of(ref, port.actor_id)
                == ("alive", port.incarnation)
                and _member_of(port, ref.actor_id)
                == ("alive", ref.incarnation),
                timeout=10)
            # probe: each has pinged the other and taken its acks
            recv = "corro_gossip_datagrams_received_total"
            await port_testing.wait_for(
                lambda: all(a.metrics.get_counter(recv, kind=k) > 0
                            for a in (ref, port) for k in ("probe", "ack")),
                timeout=10)
            for a in (ref, port):
                assert a.metrics.get_counter(recv, kind="other") == 0
            # refute: the reference agent tells the port agent it
            # suspects it; the port bumps its incarnation and the
            # reference sees the port alive at the new one
            base = port.incarnation
            suspect = ref_foca.FocaMember(
                actor=ref_swim._member_actor(ref, port.actor_id,
                                             port.gossip_addr),
                incarnation=base, state=ref_foca.STATE_SUSPECT)
            ref_swim.send(ref, tuple(port.gossip_addr), suspect.actor,
                          ref_foca.FocaMessage(tag=ref_foca.GOSSIP),
                          updates=[suspect])
            await port_testing.wait_for(lambda: port.incarnation > base,
                                        timeout=10)
            await port_testing.wait_for(
                lambda: _member_of(ref, port.actor_id)
                == ("alive", port.incarnation), timeout=10)
            # and the same from the port's side
            base = ref.incarnation
            suspect = port_foca.FocaMember(
                actor=port_swim._member_actor(port, ref.actor_id,
                                              ref.gossip_addr),
                incarnation=base, state=port_foca.STATE_SUSPECT)
            port_swim.send(port, tuple(ref.gossip_addr), suspect.actor,
                           port_foca.FocaMessage(tag=port_foca.GOSSIP),
                           updates=[suspect])
            await port_testing.wait_for(lambda: ref.incarnation > base,
                                        timeout=10)
            await port_testing.wait_for(
                lambda: _member_of(port, ref.actor_id)
                == ("alive", ref.incarnation), timeout=10)
        finally:
            if port is not None:
                await port.stop()
            await ref.stop()

    asyncio.run(asyncio.wait_for(main(), 45))


@pytest.mark.parametrize("seed", SEEDS)
def test_wire_sniff_drops_what_neither_wire_reads(seed, tmp_path):
    """The UDP receiver reads a datagram as JSON when it starts with
    ``{`` and as foca otherwise, as the reference's does: junk on either
    side is dropped, and a foca announce from a stranger is answered."""
    from corrosion_tpu_torch.agent import runtime as port_runtime

    rng = random.Random(seed)
    junk = [b"", b"\x00junk", b"\xff" * 9, b"{not json", b"\x10" + bytes(16)]
    junk += [bytes(rng.randrange(256) for _ in range(rng.randrange(1, 80)))
             for _ in range(20)]

    async def main():
        a = await port_testing.launch_test_agent(tmpdir=str(tmp_path),
                                                 device="cpu")
        try:
            proto = port_runtime._UdpProtocol(a)
            for data in junk:
                proto.datagram_received(data, ("127.0.0.1", 1))
            assert a.members.all() == []
            stranger = port_foca.FocaActor(id=bytes([seed + 1]) * 16,
                                           addr=("127.0.0.1", 9), ts=1)
            nil = port_foca.FocaActor(id=bytes(16),
                                      addr=tuple(a.gossip_addr))
            proto.datagram_received(port_foca.encode_datagram(
                port_foca.FocaDatagram(
                    src=stranger, src_incarnation=0, dst=nil,
                    message=port_foca.FocaMessage(tag=port_foca.ANNOUNCE))),
                ("127.0.0.1", 9))
            assert [m.actor_id for m in a.members.all()] == [stranger.id]
            assert a.metrics.get_counter(
                "corro_gossip_datagrams_sent_total", kind="feed") == 1
        finally:
            await a.stop()

    asyncio.run(asyncio.wait_for(main(), 30))
