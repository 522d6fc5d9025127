"""The port's shard fabric (``corrosion_tpu_torch.mesh``) and its
broadcast and seq-sync fabrics against ``corrosion_tpu.models.sharded``
on the 8-device virtual JAX mesh.

Bitwise, tick by tick, from the same numpy-seeded inputs and keys: the
wire bit packing, the all_gather broadcast fabric, the
destination-sorted ring fabric (lossless at the default cap, with an
exact overflow count at a starved cap) and the seq-sync fabric, each
through a ``LocalFabric`` of 8 shards on the CPU.  Then the fabric's
byte counters against the reference's wire contract for the same
ticks, and the design rule: a shard's local function that reads
another shard's leaves fails.  The exact sampler's layouts are
``tests/test_torch_sharded_exact.py``; ``torch.distributed`` ranks are
``tests/test_torch_dist.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from corrosion_tpu.models import broadcast as jb
from corrosion_tpu.models import sharded as js
from corrosion_tpu.models import sync as jsync
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import fabric
from corrosion_tpu_torch.mesh import (
    Collective,
    ForeignLeafError,
    LocalFabric,
    Mesh,
    Sharded,
    all_gather,
    all_to_all,
)
from corrosion_tpu_torch.models import broadcast as tb
from corrosion_tpu_torch.models import sharded as ts
from corrosion_tpu_torch.models import sync as tsync

D = 8
N, R = 256, 4


def _jax_mesh(axis="nodes"):
    return JaxMesh(np.array(jax.devices()[:D]), (axis,))


def _mesh(axis="nodes"):
    return Mesh(axis, LocalFabric(D, "cpu"))


def _tkey(key):
    return convert.key_from_numpy(np.asarray(key))


@pytest.mark.parametrize("shape", [(64,), (3, 8), (2, 5, 24), (1, 4096),
                                   (2, 1000)])
def test_bit_packing_matches_reference(shape):
    mask = np.random.default_rng(sum(shape)).random(shape) < 0.4
    want = np.asarray(js._pack_bits(jnp.asarray(mask)))
    got = fabric.bits_pack(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.asarray(js._unpack_bits(jnp.asarray(want), shape[-1]))
    np.testing.assert_array_equal(
        fabric.bits_unpack(got, shape[-1]).numpy(), back)
    np.testing.assert_array_equal(back, mask)


def test_bit_packing_refuses_ragged_rows():
    with pytest.raises(ValueError, match="multiple of 8"):
        fabric.bits_pack(torch.zeros((2, 12), dtype=torch.bool))
    with pytest.raises(ValueError, match="uint8"):
        fabric.bits_unpack(torch.zeros((2, 3), dtype=torch.uint8), 16)


def _broadcast_inputs(seed, all_active=False, max_tx=4):
    """Packed key rows (the writer's ahead of the rest), budgets, msgs."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 20, (N, R)).astype(np.int32)
    rows[0] = (1 << 21) + rng.integers(0, 1 << 20, R)
    tx = np.zeros(N, np.int32)
    tx[0] = max_tx
    if all_active:
        tx[:] = max_tx
    return rows, tx, rng.integers(0, 9, N).astype(np.int32)


def _jax_sharded(mesh, *arrays):
    spec = NamedSharding(mesh, P("nodes"))
    return [jax.device_put(jnp.asarray(a), spec) for a in arrays]


def _port_sharded(mesh, rows, tx, msgs):
    state = ts.BroadcastShard(*(torch.from_numpy(a.copy())
                                for a in (rows, tx, msgs)))
    return convert.shard_state(state, ts.BroadcastShard(0, 0, 0), mesh)


def _assert_broadcast_equal(port, ref, where):
    got = convert.unshard_state(port, ts.BroadcastShard(0, 0, 0))
    for name, g, w in zip(("rows", "tx", "msgs"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{where}: {name}")


BROADCAST_PARAMS = {
    "global-loss": dict(fanout_ring0=0, fanout_global=3, ring0_size=1,
                        max_transmissions=4, loss=0.1),
    "ring0-loss": dict(fanout_ring0=1, fanout_global=2, ring0_size=16,
                       max_transmissions=4, loss=0.1),
}


@pytest.mark.parametrize("fabric_kind", ["all_gather", "ring"])
@pytest.mark.parametrize("case", sorted(BROADCAST_PARAMS))
def test_broadcast_fabrics_match_reference(fabric_kind, case):
    """Both fabrics, tick by tick, against the reference's fabric of the
    same name on the virtual mesh (and so against ``broadcast_step``)."""
    jparams = jb.BroadcastParams(n_nodes=N, **BROADCAST_PARAMS[case])
    tparams = tb.BroadcastParams(n_nodes=N, **BROADCAST_PARAMS[case])
    rows, tx, msgs = _broadcast_inputs(7)
    jmesh, mesh = _jax_mesh(), _mesh()
    ring = fabric_kind == "ring"
    jstep = (js.sharded_broadcast_step_ring(jmesh, jparams) if ring
             else js.sharded_broadcast_step(jmesh, jparams))
    step = (ts.sharded_broadcast_step_ring(mesh, tparams) if ring
            else ts.sharded_broadcast_step(mesh, tparams))
    ref = _jax_sharded(jmesh, rows, tx, msgs)
    port = _port_sharded(mesh, rows, tx, msgs)
    key = jax.random.PRNGKey(3)
    for t in range(6):
        k = jax.random.fold_in(key, t)
        out = jstep(*ref, k)
        got = step(port, _tkey(k))
        if ring:
            assert int(out[3]) == 0 and got[1] == 0
            out, got = out[:3], got[0]
        ref, port = list(out), got
        _assert_broadcast_equal(port, ref, f"tick {t}")
    # the news crossed shard boundaries
    assert int((np.asarray(ref[0]) == rows[0]).all(axis=1).sum()) > D


@pytest.mark.parametrize("cap", [1, 3])
def test_ring_fabric_small_cap_reports_overflow(cap):
    """A starved slot cap: the same exact overflow count and the same
    rows as the reference (every delivered row a true sender row)."""
    kw = dict(n_nodes=N, fanout_ring0=0, fanout_global=3, ring0_size=1,
              max_transmissions=8)
    rows, tx, msgs = _broadcast_inputs(11, all_active=True, max_tx=8)
    jmesh, mesh = _jax_mesh(), _mesh()
    out = js.sharded_broadcast_step_ring(
        jmesh, jb.BroadcastParams(**kw), slot_cap=cap)(
        *_jax_sharded(jmesh, rows, tx, msgs), jax.random.PRNGKey(1))
    port, overflow = ts.sharded_broadcast_step_ring(
        mesh, tb.BroadcastParams(**kw), slot_cap=cap)(
        _port_sharded(mesh, rows, tx, msgs), _tkey(jax.random.PRNGKey(1)))
    assert overflow == int(out[3]) > 0
    _assert_broadcast_equal(port, out[:3], "starved cap")


def test_route_pack_compacts_in_ascending_order():
    """``route_pack``'s packing is the reference's sort of (index or
    n_local) scores: ascending local index, -1 pads, exact overflow."""
    n_local, d, k = 16, 4, 3
    rng = np.random.default_rng(5)
    senders = torch.from_numpy(np.stack(
        [rng.permutation(n_local * d) for _ in range(k)]).astype(np.int32))
    active = torch.from_numpy(rng.random(n_local) < 0.7)
    rows = torch.from_numpy(rng.integers(0, 99, (n_local, 2)).astype(
        np.int32))
    ids, out, overflow = fabric.route_pack(senders, active, rows, 1, 3)
    lo = n_local
    for dest in range(d):
        recv = senders[:, dest * n_local:(dest + 1) * n_local].reshape(-1)
        need = sorted({int(s) - lo for s in recv
                       if lo <= s < lo + n_local and active[int(s) - lo]})
        want = [lo + i for i in need[:3]] + [-1] * (3 - len(need[:3]))
        assert ids[dest].tolist() == want
        for slot, i in enumerate(need[:3]):
            assert out[dest, slot].tolist() == rows[i].tolist()
    total = sum(len({int(s) for s in senders[:, dd * n_local:(dd + 1)
                                              * n_local].reshape(-1)
                     if lo <= s < lo + n_local and active[int(s) - lo]})
                for dd in range(d))
    assert int(overflow[0]) == total - int((ids >= 0).sum())
    # one destination's ids are unique, as a receiver's are
    slot_of = fabric.route_slots_plain(ids[2], n_local * d)
    for q, i in enumerate(ids[2].tolist()):
        if i >= 0:
            assert int(slot_of[i]) == q
    assert int((slot_of >= 0).sum()) == int((ids[2] >= 0).sum())


def test_seq_sync_fabric_matches_reference():
    kw = dict(n_nodes=N, n_seqs=32, peers_per_round=2, seqs_per_chunk=4,
              chunk_budget=3, loss=0.1)
    bits = np.zeros((N, 32), bool)
    bits[0] = True
    bits[5 * N // D + 1, :16] = True  # a partial holder on shard 5
    msgs = np.zeros(N, np.int32)
    jmesh, mesh = _jax_mesh(), _mesh()
    jstep = js.sharded_seq_sync_step(jmesh, jsync.SeqSyncParams(**kw))
    step = ts.sharded_seq_sync_step(mesh, tsync.SeqSyncParams(**kw))
    ref = _jax_sharded(jmesh, bits, msgs)
    lay = ts.SeqShard(0, 0)
    port = convert.shard_state(ts.SeqShard(torch.from_numpy(bits.copy()),
                                           torch.from_numpy(msgs.copy())),
                               lay, mesh)
    key = jax.random.PRNGKey(9)
    for t in range(10):
        k = jax.random.fold_in(key, t)
        ref = list(jstep(*ref, k))
        port = step(port, _tkey(k))
        got = convert.unshard_state(port, lay)
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref[0]),
                                      err_msg=f"tick {t} bits")
        np.testing.assert_array_equal(got.msgs.numpy(), np.asarray(ref[1]),
                                      err_msg=f"tick {t} msgs")
    assert int(np.asarray(ref[0]).any(axis=1).sum()) > 2


def test_fabric_bytes_match_the_reference_wire_contract():
    """Per tick: the all_gather fabric moves every shard's rows and
    activity bytes to every other shard (as the reference's two tiled
    all_gathers); the ring fabric one all_to_all of D x cap ids and rows
    and a psum of one int32; seq sync the bitmaps and msgs once."""
    tparams = tb.BroadcastParams(n_nodes=N, **BROADCAST_PARAMS["ring0-loss"])
    rows, tx, msgs = _broadcast_inputs(2)
    ticks = 3
    for ring in (False, True):
        mesh = _mesh()
        step = (ts.sharded_broadcast_step_ring(mesh, tparams) if ring
                else ts.sharded_broadcast_step(mesh, tparams))
        port = _port_sharded(mesh, rows, tx, msgs)
        for t in range(ticks):
            port = step(port, _tkey(jax.random.PRNGKey(t)))
            port = port[0] if ring else port
        cap = N // D
        if ring:
            want = {"ids": ticks * D * (D - 1) * cap * 4,
                    "rows": ticks * D * (D - 1) * cap * R * 4,
                    "overflow": ticks * D * (D - 1) * 4}
        else:
            want = {"rows": ticks * (D - 1) * N * R * 4,
                    "active": ticks * (D - 1) * N}
        assert mesh.fabric.bytes == want
        assert mesh.fabric.calls == {k: ticks for k in want}
    mesh = _mesh()
    seq = convert.shard_state(
        ts.SeqShard(torch.zeros((N, 32), dtype=torch.bool),
                    torch.zeros(N, dtype=torch.int32)), ts.SeqShard(0, 0),
        mesh)
    ts.sharded_seq_sync_step(mesh, tsync.SeqSyncParams(n_nodes=N, n_seqs=32))(
        seq, _tkey(jax.random.PRNGKey(0)))
    assert mesh.fabric.bytes == {"seq": (D - 1) * N * 32,
                                 "msgs": (D - 1) * N * 4}


def test_local_function_reading_a_foreign_leaf_fails():
    """The design rule: a shard sees only its own leaves and what the
    fabric hands it.  Reaching into the sharded state for another
    shard's leaf — or any shard's but its own — raises, and so does
    reading a shard this process does not hold."""
    mesh = _mesh()
    rows, tx, msgs = _broadcast_inputs(0)
    state = _port_sharded(mesh, rows, tx, msgs)

    def honest(sh, st):
        got = yield all_gather(st.tx, "tx")
        return int(got.sum())

    def nosy(sh, st):
        other = state[(sh + 3) % D]  # another shard's leaves
        got = yield all_gather(st.tx + other.tx, "tx")
        return int(got.sum())

    out = mesh.run(honest, {sh: (state[sh],) for sh in range(D)})
    assert set(out.values()) == {int(tx.sum())}
    with pytest.raises(ForeignLeafError, match="read shard 3"):
        mesh.run(nosy, {sh: (state[sh],) for sh in range(D)})
    partial = Sharded(mesh, {0: state[0]})
    with pytest.raises(ForeignLeafError, match="not held"):
        partial[1]


def test_mesh_refuses_divergent_collectives_and_bad_axes():
    mesh = _mesh()

    def split_brain(sh, x):
        if sh == 2:
            got = yield all_to_all(torch.zeros((D, 1)), "a")
        else:
            got = yield all_gather(x, "a")
        return got

    with pytest.raises(RuntimeError, match="different collectives"):
        mesh.run(split_brain, {sh: (torch.ones(1),) for sh in range(D)})

    def early_exit(sh, x):
        if sh == 0:
            return None
        got = yield all_gather(x, "a")
        return got

    with pytest.raises(RuntimeError, match="different paths"):
        mesh.run(early_exit, {sh: (torch.ones(1),) for sh in range(D)})
    with pytest.raises(ValueError, match="mesh axis"):
        Mesh("seeds", LocalFabric(D, "cpu"))
    with pytest.raises(ValueError, match="divide"):
        ts.sharded_broadcast_step(
            Mesh("nodes", LocalFabric(3, "cpu")),
            tb.BroadcastParams(n_nodes=N))
    assert Collective("all_gather", torch.ones(1), "a").dim == 0
