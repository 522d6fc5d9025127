"""The port's multiplexed transport (``corrosion_tpu_torch/agent/mux.py``
and the mux side of ``agent/transport.py``) against the reference's, on
the CPU.

* the pieces: ``lane_of``, the frame bytes and ``TombstoneSet`` give the
  reference's values on the same seeded inputs, and each side's frame
  reader parses the other's frames;
* live: a reference agent and a port agent at the reference's defaults
  share one mux connection a direction, which carries broadcasts (uni)
  and concurrent sync sessions (bi) both ways; a garbage channel aborts
  alone and the connection survives it;
* a frame that claims more than the cap tears the connection down.
"""

import asyncio
import random
import struct

import pytest

from corrosion_tpu.agent import mux as ref_mux
from corrosion_tpu.agent import testing as ref_testing
from corrosion_tpu_torch.agent import mux as port_mux
from corrosion_tpu_torch.agent import testing as port_testing

SEEDS = range(4)


def _addrs(seed, n=300):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        if rng.random() < 0.2:
            host = "fe80::%x" % rng.randrange(2**16)
        elif rng.random() < 0.2:
            host = "node-%d.example" % rng.randrange(1000)
        else:
            host = ".".join(str(rng.randrange(256)) for _ in range(4))
        out.append((host, rng.randrange(2**16)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_of_equals_reference(seed):
    addrs = _addrs(seed)
    for lanes in (port_mux.LANES, 3, 1):
        want = [ref_mux.lane_of(a, lanes) for a in addrs]
        assert [port_mux.lane_of(a, lanes) for a in addrs] == want
    assert port_mux.LANES == ref_mux.LANES
    assert {port_mux.lane_of(a) for a in addrs} == set(range(port_mux.LANES))


def _frames(seed, n=40):
    rng = random.Random(seed)
    return [(rng.randrange(4), rng.randrange(2**32),
             bytes(rng.randrange(256) for _ in range(rng.choice(
                 (0, 1, rng.randrange(2, 3000))))))
            for _ in range(n)]


async def _parse(mux, data):
    r = asyncio.StreamReader()
    r.feed_data(data)
    r.feed_eof()
    out = []
    try:
        async for f in mux.read_frames(r):
            out.append(f)
    except asyncio.IncompleteReadError:
        pass
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_frames_equal_reference(seed):
    frames = _frames(seed)
    want = b"".join(ref_mux.frame(*f) for f in frames)
    got = b"".join(port_mux.frame(*f) for f in frames)
    assert got == want
    assert port_mux.STREAM_MUX == ref_mux.STREAM_MUX
    assert port_mux.MAX_MUX_FRAME == ref_mux.MAX_MUX_FRAME
    assert asyncio.run(_parse(port_mux, want)) == frames
    assert asyncio.run(_parse(ref_mux, got)) == frames


@pytest.mark.parametrize("seed", SEEDS)
def test_tombstones_equal_reference(seed):
    rng = random.Random(seed)
    cap = rng.choice((1, 4, 16, 100))
    ids = list(range(1, 600))
    # closes mostly in id order, some late, some twice
    for i in range(0, len(ids) - 8, 8):
        chunk = ids[i:i + 8]
        rng.shuffle(chunk)
        ids[i:i + 8] = chunk
    ids += rng.sample(ids, 50)
    ref, port = ref_mux.TombstoneSet(cap), port_mux.TombstoneSet(cap)
    for k, ch in enumerate(ids):
        ref.add(ch)
        port.add(ch)
        assert len(port) == len(ref) <= cap
        if k % 37 == 0:
            probe = range(0, 650)
            assert [c in port for c in probe] == [c in ref for c in probe]
    assert [c in port for c in range(700)] == [c in ref for c in range(700)]


# -- live --------------------------------------------------------------

def _rows(agent):
    return agent.storage.read_query(
        "SELECT id, text FROM tests ORDER BY id")[1]


def test_one_connection_carries_uni_and_sync_both_ways(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()

    async def main():
        ref = await ref_testing.launch_test_agent(tmpdir=str(tmp_path / "ref"))
        port = None
        try:
            port = await port_testing.launch_test_agent(
                bootstrap=[f"{ref.gossip_addr[0]}:{ref.gossip_addr[1]}"],
                tmpdir=str(tmp_path / "port"), device="cpu")
            assert ref.transport.mux and port.transport.mux
            await port_testing.wait_for(
                lambda: ref.members.alive() and port.members.alive(),
                timeout=10)
            # uni: each side's write reaches the other as a broadcast
            await asyncio.to_thread(ref.execute_transaction, [
                ("INSERT INTO tests (id, text) VALUES (?, ?)", (i, f"r{i}"))
                for i in range(10)])
            await asyncio.to_thread(port.execute_transaction, [
                ("INSERT INTO tests (id, text) VALUES (?, ?)", (i, f"p{i}"))
                for i in range(10, 20)])
            await port_testing.wait_for(
                lambda: len(_rows(ref)) == 20 and _rows(ref) == _rows(port),
                timeout=10)
            # bi: concurrent sync sessions, each way
            for a, b in ((port, ref), (ref, port)):
                m = a.members.get(b.actor_id)
                counts = await asyncio.gather(
                    *(a.parallel_sync([m]) for _ in range(3)))
                assert all(c >= 0 for c in counts)
            # a garbage channel aborts alone: the connection survives
            m = port.members.get(ref.actor_id)
            reader, writer = await port.transport.open_bi(tuple(m.addr))
            writer.write(b"\x00\x00\x00\x04junk")
            await writer.drain()
            writer.write_eof()
            got = b""
            try:
                while chunk := await asyncio.wait_for(reader.read(4096), 5):
                    got += chunk
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
            assert b"corro" not in got.lower()
            writer.close()
            await asyncio.to_thread(ref.execute_transaction, [
                ("INSERT INTO tests (id, text) VALUES (?, ?)", (99, "late"))])
            assert await port.parallel_sync([m]) >= 0
            await port_testing.wait_for(
                lambda: _rows(ref) == _rows(port), timeout=10)
            for a, b in ((port, ref), (ref, port)):
                peer = tuple(b.gossip_addr)
                assert list(a.transport._muxes) == [peer]
                assert a.transport.stats[peer].connects == 1
                assert a.metrics.get_counter(
                    "corro_transport_frames_total", channel="uni") > 0
                assert a.metrics.get_counter(
                    "corro_transport_bytes_total", channel="bi") > 0
                assert a.metrics.get_counter(
                    "corro_transport_bi_channels_total") >= 3
        finally:
            if port is not None:
                await port.stop()
            await ref.stop()

    asyncio.run(asyncio.wait_for(main(), 45))


@pytest.mark.parametrize("length", [port_mux.MAX_MUX_FRAME + 1, 0xFFFFFFFF])
def test_hostile_frame_length_tears_connection(length, tmp_path):
    async def main():
        a = await port_testing.launch_test_agent(tmpdir=str(tmp_path),
                                                 device="cpu")
        try:
            r, w = await asyncio.open_connection(*a.gossip_addr)
            w.write(port_mux.STREAM_MUX + struct.pack(">BII", 1, 1, length))
            await w.drain()
            # the server closes on us and reads no payload
            assert await asyncio.wait_for(r.read(16), 5) == b""
            w.close()
            # the agent still serves a well-formed mux connection
            r, w = await asyncio.open_connection(*a.gossip_addr)
            w.write(port_mux.STREAM_MUX + port_mux.frame(
                port_mux.CLASS_UNI, 0, b""))
            await w.drain()
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(r.read(16), 0.3)
            w.close()
        finally:
            await a.stop()

    asyncio.run(asyncio.wait_for(main(), 30))
