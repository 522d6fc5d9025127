"""``route_pack``'s decomposition on the card (csrc/fabric.cu) as a NumPy
model, held against ``route_pack_plain`` and against the reference's
ring fabric (``corrosion_tpu.models.sharded.sharded_broadcast_step_ring``
on the 8-device virtual JAX mesh).

The model follows the kernels step by step: marks as 32-bit words a
destination (bit ``s - lo`` for each of my active senders that one of
the destination's receivers drew); tiles of ``TILE`` local indices and
a count for each (the popcounts of its words); each tile's exclusive
offset within its destination; a needed row's slot = that offset + its
rank in the tile; the pad range ``[min(total, cap), cap)`` written by
the tiles whose slot window ``[t * TILE, (t + 1) * TILE)`` it crosses;
and the overflow, the sum over destinations of ``max(0, total - cap)``.
Every slot must be written exactly once.  Inputs come from NumPy seeds;
the card's own comparison is ``chip_smoke.py`` phase 17a.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P
import jax.numpy as jnp

from corrosion_tpu.models import broadcast as jb
from corrosion_tpu.models import sharded as js
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import fabric
from corrosion_tpu_torch.mesh import LocalFabric, Mesh
from corrosion_tpu_torch.models import broadcast as tb
from corrosion_tpu_torch.models import sharded as ts

TILE = 256  # csrc/fabric.cu: a 256-thread block, a warp a mark word


def _popcount(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.astype("<u4").view(np.uint8))
    return bits.reshape(*words.shape, 32).sum(-1).astype(np.int64)


def model_route_pack(senders, active, rows, shard: int, cap: int,
                     tile: int = TILE, inclusive: bool = False):
    """NumPy twin of the three kernels: returns (send_ids, send_rows,
    overflow, writes), ``writes`` the number of times each slot was
    written.  ``inclusive`` takes each tile's inclusive count as its
    offset (a deliberate fault, for the negative control)."""
    k, n = senders.shape
    n_local, r = rows.shape
    d, lo = n // n_local, shard * n_local
    words, tiles, tile_words = -(-n_local // 32), -(-n_local // tile), \
        tile // 32
    # 1. mark
    marks = np.zeros((d, tiles * tile_words), np.uint32)
    il = senders.astype(np.int64) - lo
    dest = np.broadcast_to(np.arange(n) // n_local, (k, n))
    mine = (il >= 0) & (il < n_local)
    mine[mine] = active[il[mine]]
    np.bitwise_or.at(marks, (dest[mine], il[mine] >> 5),
                     (np.uint32(1) << (il[mine] & 31).astype(np.uint32)))
    assert not marks[:, words:].any()
    # 2. count: a tile's words' popcounts
    pops = _popcount(marks).reshape(d, tiles, tile_words)
    counts = pops.sum(2)
    # 3. write: offsets, slots by rank, pads by slot window, overflow
    before = np.cumsum(counts, 1) - (0 if inclusive else counts)
    total = counts.sum(1)
    ids = np.zeros((d, cap), np.int64)
    out = np.zeros((d, cap, r), np.int64)
    writes = np.zeros((d, cap), np.int64)
    lanes = np.arange(32, dtype=np.uint32)
    below = (np.uint32(1) << lanes) - np.uint32(1)
    for e in range(d):
        for t in range(tiles):
            wprefix = np.cumsum(pops[e, t]) - pops[e, t]
            for v in range(tile_words):
                word = marks[e, t * tile_words + v]
                hit = (word >> lanes) & 1 == 1
                rank = wprefix[v] + _popcount(word & below)
                slot = before[e, t] + rank[hit]
                local = (t * tile_words + v) * 32 + np.flatnonzero(hit)
                keep = slot < cap
                ids[e, slot[keep]] = lo + local[keep]
                out[e, slot[keep]] = rows[local[keep]]
                writes[e, slot[keep]] += 1
            pad = np.arange(max(t * tile, min(total[e], cap)),
                            min((t + 1) * tile, cap))
            ids[e, pad] = -1
            out[e, pad] = 0
            writes[e, pad] += 1
    overflow = int(np.maximum(total - cap, 0).sum())
    return (ids.astype(np.int32), out.astype(np.int32),
            np.array([overflow], np.int32), writes)


def _inputs(seed, n, d, k, r, active="some", rows_offset=0):
    rng = np.random.default_rng(seed)
    n_local = n // d
    senders = rng.integers(0, n, (k, n)).astype(np.int32)
    keys = rng.integers(0, 1 << 20, n_local * r + rows_offset).astype(
        np.int32)[rows_offset:].reshape(n_local, r)
    busy = {"some": rng.random(n_local) < 0.33,
            "none": np.zeros(n_local, bool),
            "all": np.ones(n_local, bool)}[active]
    return senders, busy, keys


# (nodes, shards, maps, R, shard, cap, active, rows offset in words):
# every cap edge, the first and last shard, no and every sender active,
# one, two, eight and 64 destinations, one map, a shard width that is no
# multiple of the tile (99,976 over 8: 12,497 rows, the last tile 209
# wide), R = 6 with rows 4 bytes past a 16-byte boundary
EDGES = [
    (4096, 8, 4, 8, 3, 512, "some", 0),
    (4096, 8, 4, 8, 3, 1, "some", 0),
    (4096, 8, 4, 8, 3, 256, "some", 0),
    (4096, 8, 4, 8, 0, 512, "some", 0),
    (4096, 8, 4, 8, 7, 256, "some", 0),
    (4096, 8, 4, 8, 3, 512, "none", 0),
    (4096, 8, 4, 8, 3, 256, "all", 0),
    (4096, 8, 4, 8, 3, 512, "all", 0),
    (4096, 1, 4, 8, 0, 4096, "some", 0),
    (4096, 1, 4, 8, 0, 256, "some", 0),
    (4096, 2, 4, 8, 1, 2048, "some", 0),
    (4096, 2, 4, 8, 0, 1, "some", 0),
    (4096, 64, 4, 8, 63, 64, "some", 0),
    (4096, 64, 4, 8, 5, 3, "all", 0),
    (4096, 8, 1, 8, 3, 512, "some", 0),
    (99_976, 8, 4, 8, 7, 12_497, "some", 0),
    (99_976, 8, 4, 8, 0, 256, "all", 0),
    (4096, 8, 4, 6, 3, 512, "some", 1),
    (4096, 8, 4, 6, 3, 1, "some", 1),
    (2000, 8, 3, 5, 4, 250, "some", 3),
]


@pytest.mark.parametrize("case", EDGES, ids=lambda c: "-".join(map(str, c)))
def test_model_matches_plain_at_edges(case):
    """The NumPy model equals ``route_pack_plain`` (and the CPU wrapper)
    bitwise, and writes every slot exactly once."""
    n, d, k, r, shard, cap, active, off = case
    senders, busy, keys = _inputs(sum(case[:6]), n, d, k, r, active, off)
    ids, out, overflow, writes = model_route_pack(senders, busy, keys,
                                                  shard, cap)
    assert (writes == 1).all()
    args = (torch.from_numpy(senders), torch.from_numpy(busy))
    buf = torch.zeros(keys.size + off, dtype=torch.int32)  # 64-byte aligned
    rows_l = buf[off:].view(keys.shape).copy_(torch.from_numpy(keys))
    assert rows_l.data_ptr() % 16 == 4 * off % 16
    for fn in (fabric.route_pack_plain, fabric.route_pack):
        got = fn(*args, rows_l, shard, cap)
        np.testing.assert_array_equal(got[0].numpy(), ids)
        np.testing.assert_array_equal(got[1].numpy(), out)
        np.testing.assert_array_equal(got[2].numpy(), overflow)


@pytest.mark.parametrize("tile", [32, 128, 512])
@pytest.mark.parametrize("cap", [1, 100, 512])
def test_model_is_independent_of_the_tile(tile, cap):
    """Any tile width gives the same packing: the offsets, ranks and pad
    windows only cut the same stable compaction differently."""
    senders, busy, keys = _inputs(tile + cap, 4096, 8, 4, 8)
    want = fabric.route_pack_plain(torch.from_numpy(senders),
                                   torch.from_numpy(busy),
                                   torch.from_numpy(keys), 5, cap)
    got = model_route_pack(senders, busy, keys, 5, cap, tile)
    assert (got[3] == 1).all()
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g, w.numpy())


def test_model_with_inclusive_offsets_differs_from_plain():
    """Negative control: a tile offset that counts the tile itself moves
    every needed row after the first tile, and the comparison sees it."""
    senders, busy, keys = _inputs(3, 4096, 8, 4, 8)
    want = fabric.route_pack_plain(torch.from_numpy(senders),
                                   torch.from_numpy(busy),
                                   torch.from_numpy(keys), 3, 512)
    got = model_route_pack(senders, busy, keys, 3, 512, inclusive=True)
    assert not np.array_equal(got[0], want[0].numpy())


N, R, D = 256, 4, 8
RING_PARAMS = {
    "global-loss": dict(fanout_ring0=0, fanout_global=3, ring0_size=1,
                        max_transmissions=4, loss=0.1),
    "ring0-loss": dict(fanout_ring0=1, fanout_global=2, ring0_size=16,
                       max_transmissions=4, loss=0.1),
}


def _model_wrapper(senders, active_l, rows_l, shard, cap):
    ids, out, overflow, writes = model_route_pack(
        senders.numpy(), active_l.numpy(), rows_l.numpy(), shard, cap)
    assert (writes == 1).all()
    return (torch.from_numpy(ids), torch.from_numpy(out),
            torch.from_numpy(overflow))


@pytest.mark.parametrize("case", sorted(RING_PARAMS))
@pytest.mark.parametrize("shards,cap", [(8, None), (8, 1), (8, 3), (2, 5),
                                        (2, None)])
def test_model_inside_the_ring_fabric_matches_reference(monkeypatch, case,
                                                        shards, cap):
    """The port's ring fabric with its pack replaced by the model equals
    the reference's ring fabric on the virtual mesh, tick by tick: the
    rows, budgets and msgs after delivery and the exact overflow."""
    monkeypatch.setattr(ts, "route_pack", _model_wrapper)
    kw = dict(n_nodes=N, **RING_PARAMS[case])
    rng = np.random.default_rng(shards * 100 + (cap or 0))
    rows = rng.integers(0, 1 << 20, (N, R)).astype(np.int32)
    rows[0] = (1 << 21) + rng.integers(0, 1 << 20, R)
    tx = np.where(rng.random(N) < 0.5, 4, 0).astype(np.int32)
    msgs = rng.integers(0, 9, N).astype(np.int32)
    jmesh = JaxMesh(np.array(jax.devices()[:shards]), ("nodes",))
    mesh = Mesh("nodes", LocalFabric(shards, "cpu"))
    jstep = js.sharded_broadcast_step_ring(jmesh, jb.BroadcastParams(**kw),
                                           slot_cap=cap)
    step = ts.sharded_broadcast_step_ring(mesh, tb.BroadcastParams(**kw),
                                          slot_cap=cap)
    spec = NamedSharding(jmesh, P("nodes"))
    ref = [jax.device_put(jnp.asarray(a), spec) for a in (rows, tx, msgs)]
    port = convert.shard_state(
        ts.BroadcastShard(*(torch.from_numpy(a.copy())
                            for a in (rows, tx, msgs))),
        ts.BroadcastShard(0, 0, 0), mesh)
    key = jax.random.PRNGKey(9)
    overflow = 0
    for t in range(3):
        k = jax.random.fold_in(key, t)
        out = jstep(*ref, k)
        port, got_overflow = step(port, convert.key_from_numpy(
            np.asarray(k)))
        assert got_overflow == int(out[3])
        overflow += got_overflow
        ref = list(out[:3])
        got = convert.unshard_state(port, ts.BroadcastShard(0, 0, 0))
        for name, g, w in zip(("rows", "tx", "msgs"), got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"tick {t}: {name}")
    assert (overflow > 0) == (cap is not None)
