"""``ring_receive``'s decomposition on the card (csrc/deliver_perm.cu) as a
NumPy model, held against its plain version (``route_slots_plain`` and
``deliver_perm_plain``) and against the reference's ring fabric
(``corrosion_tpu.models.sharded.sharded_broadcast_step_ring`` on the
8-device virtual JAX mesh).

The model follows the two kernels step by step.  The slot map is kept
between calls and never filled: an entry is a 64-bit tag, (generation
<< 32) | slot, and each call takes the next generation.  1. A thread a
received slot q checks ``route_pack``'s contract on its id (section e =
q // cap ascends within shard e's rows, then -1 pads) and writes
``tags[id] = gen << 32 | q``, or the generation into the flag word
``tags[N]`` where the contract fails.  2. A thread a receiver loads its
K sender ids and loss draws, then those columns' tags together
(``COLUMNS`` at a time), takes a slot only where its tag carries this
call's generation, then the rows of the slots it takes, and max-merges
them; the epilogue decays tx and counts msgs; the flag is this call's
where the flag word holds its generation.  Inputs come from NumPy
seeds; the card's own comparison is ``chip_smoke.py`` phase 17a.
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
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import fabric
from corrosion_tpu_torch.mesh import LocalFabric, Mesh
from corrosion_tpu_torch.models import broadcast as tb
from corrosion_tpu_torch.models import sharded as ts

COLUMNS = 4  # csrc/deliver_perm.cu: the columns whose loads are in flight


class SlotMap:
    """The kernels' slot map between calls: [N + 1] uint64 tags, zero
    when made, and the generation of the last call."""

    def __init__(self, n: int):
        self.tags = np.zeros(n + 1, np.uint64)
        self.gen = 0


def model_slots(recv_ids, n: int, slots: SlotMap) -> int:
    """Step 1 on a new generation: scatter each received id's tag where
    ``route_pack``'s contract holds for it, else set the flag word.
    Returns the generation."""
    slots.gen += 1
    gen = np.uint64(slots.gen)
    d, cap = recv_ids.shape
    n_local = n // d
    flat = recv_ids.reshape(-1).astype(np.int64)
    q = np.arange(flat.size)
    lo = q // cap * n_local
    first = q % cap == 0
    prev = np.where(first, 0, np.roll(flat, 1))
    valid = flat >= 0
    ok = np.where(valid, (flat >= lo) & (flat < lo + n_local)
                  & (first | ((prev >= 0) & (prev < flat))), flat == -1)
    if not ok.all():
        slots.tags[n] = gen
    hit = ok & valid
    slots.tags[flat[hit]] = (gen << np.uint64(32)) | q[hit].astype(np.uint64)
    return slots.gen


def model_deliver(rows, tx, msgs, senders, recv_rows, loss_u, loss: float,
                  max_tx: int, lo: int, slots: SlotMap, gen: int,
                  check_generation: bool = True):
    """Step 2: returns (rows, tx, msgs, bad).  ``check_generation=False``
    takes every tag's slot whatever its generation (a deliberate fault,
    for the negative control)."""
    k, n_global = senders.shape
    n, r = rows.shape
    tg = lo + np.arange(n)
    src = recv_rows.reshape(-1, r)
    acc = rows.copy()
    for j0 in range(0, k, COLUMNS):
        js = np.arange(j0, min(j0 + COLUMNS, k))
        s = senders[js][:, tg].astype(np.int64)  # [c, n] sender ids
        lost = ((loss_u[tg][:, js].T < loss) if loss_u is not None
                else np.zeros(s.shape, bool))
        tag = slots.tags[s]  # the c tags, loaded together
        slot = (tag & np.uint64(0xFFFFFFFF)).astype(np.int64)
        if check_generation:
            slot = np.where(tag >> np.uint64(32) == np.uint64(gen), slot, -1)
        take = ~lost & (slot >= 0)
        got = src[np.where(take, slot, 0)]  # [c, n, r] the rows taken
        acc = np.maximum(acc, np.where(take[..., None], got, acc).max(0))
    learned = (acc != rows).any(1)
    act = tx > 0
    tx_out = np.where(learned, max_tx, np.where(act, tx - 1, tx))
    msgs_out = msgs + np.where(act, k, 0)
    bad = np.array([int(slots.tags[n_global] == np.uint64(gen))], np.int32)
    return (acc.astype(np.int32), tx_out.astype(np.int32),
            msgs_out.astype(np.int32), bad)


def model_ring_receive(rows, tx, msgs, senders, recv_ids, recv_rows, loss_u,
                       loss, max_tx, lo, slots: SlotMap, **kw):
    gen = model_slots(recv_ids, senders.shape[1], slots)
    return model_deliver(rows, tx, msgs, senders, recv_rows, loss_u, loss,
                         max_tx, lo, slots, gen, **kw)


def _state(seed, n, k, r, active="some"):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n, (k, n)).astype(np.int32)
    rows = rng.integers(0, 1 << 20, (n, r)).astype(np.int32)
    busy = {"some": rng.random(n) < 0.33, "none": np.zeros(n, bool),
            "all": np.ones(n, bool)}[active]
    tx = np.where(busy, rng.integers(1, 9, n), 0).astype(np.int32)
    msgs = rng.integers(0, 99, n).astype(np.int32)
    loss_u = rng.random((n, k)).astype(np.float32)
    return senders, rows, tx, msgs, loss_u


def _received(senders, rows, tx, d, shard, cap):
    """Shard ``shard``'s recv_ids [d, cap] and recv_rows [d, cap, R]: every
    source shard's ``route_pack_plain`` buffers for it."""
    n_local = rows.shape[0] // d
    t = [torch.from_numpy(a) for a in (senders, rows, tx)]
    sends = [fabric.route_pack_plain(t[0], t[2][e * n_local:(e + 1)
                                                * n_local] > 0,
                                     t[1][e * n_local:(e + 1) * n_local],
                                     e, cap)
             for e in range(d)]
    return (torch.stack([s[0][shard] for s in sends]).numpy(),
            torch.stack([s[1][shard] for s in sends]).numpy())


def _window(arrays, n_local, shard):
    w = slice(shard * n_local, (shard + 1) * n_local)
    return [np.ascontiguousarray(a[w]) for a in arrays]


def _plain(rows, tx, msgs, senders, recv_ids, recv_rows, loss_u, lo,
           loss=0.05, max_tx=8):
    t = [torch.from_numpy(a) for a in (rows, tx, msgs, senders, recv_ids,
                                       recv_rows, loss_u)]
    out = {}
    for fn in (fabric.ring_receive_plain, fabric.ring_receive):
        out[fn.__name__] = [x.numpy() for x in fn(
            *t[:6], loss_u=t[6], loss=loss, max_tx=max_tx, lo=lo)]
    np.testing.assert_equal(out["ring_receive"], out["ring_receive_plain"])
    return out["ring_receive_plain"]


# (nodes, shards, maps, R, shard, cap, active): caps 1, 3 and n_local;
# one, two and eight shards; K = 1, 4 and 5 (two groups of columns);
# R = 4, 6 and 8; no and every sender active; a shard of 12,497 rows
EDGES = [
    (4096, 8, 4, 8, 3, 512, "some"),
    (4096, 8, 4, 8, 3, 1, "some"),
    (4096, 8, 4, 8, 3, 3, "some"),
    (4096, 8, 4, 8, 0, 512, "some"),
    (4096, 8, 4, 8, 7, 3, "some"),
    (4096, 8, 4, 8, 3, 512, "none"),
    (4096, 8, 4, 8, 3, 512, "all"),
    (4096, 8, 4, 8, 5, 3, "all"),
    (4096, 1, 4, 8, 0, 4096, "some"),
    (4096, 1, 4, 8, 0, 3, "some"),
    (4096, 2, 4, 8, 1, 2048, "some"),
    (4096, 2, 4, 8, 0, 1, "some"),
    (4096, 8, 1, 8, 3, 512, "some"),
    (4096, 8, 5, 8, 3, 512, "some"),
    (4096, 8, 4, 4, 3, 512, "some"),
    (4096, 8, 4, 6, 3, 512, "some"),
    (4096, 8, 4, 6, 6, 1, "all"),
    (99_976, 8, 4, 8, 7, 12_497, "some"),
    (99_976, 8, 4, 8, 0, 3, "some"),
]


@pytest.mark.parametrize("case", EDGES, ids=lambda c: "-".join(map(str, c)))
def test_model_matches_plain_at_edges(case):
    """The NumPy model equals ``ring_receive_plain`` (and the CPU
    wrapper) bitwise, flag clear, on a map that an earlier call (another
    shard's) left its tags in."""
    n, d, k, r, shard, cap, active = case
    senders, rows, tx, msgs, loss_u = _state(sum(case[:6]), n, k, r, active)
    n_local = n // d
    slots = SlotMap(n)
    other = (shard + 1) % d
    model_ring_receive(*_window((rows, tx, msgs), n_local, other), senders,
                       *_received(senders, rows, tx, d, other, cap), loss_u,
                       0.05, 8, other * n_local, slots)
    recv = _received(senders, rows, tx, d, shard, cap)
    mine = _window((rows, tx, msgs), n_local, shard)
    got = model_ring_receive(*mine, senders, *recv, loss_u, 0.05, 8,
                             shard * n_local, slots)
    want = _plain(*mine, senders, *recv, loss_u, shard * n_local)
    for name, g, w in zip(("rows", "tx", "msgs", "bad"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3][0] == 0


def test_model_without_the_generation_check_differs_from_plain():
    """Negative control: taking a stale tag's slot (left by the earlier
    call) merges rows the sender never sent, and the comparison sees
    it."""
    n, d, cap = 4096, 8, 512
    senders, rows, tx, msgs, loss_u = _state(11, n, 4, 8)
    n_local = n // d
    slots = SlotMap(n)
    model_ring_receive(*_window((rows, tx, msgs), n_local, 2), senders,
                       *_received(senders, rows, tx, d, 2, cap), loss_u,
                       0.05, 8, 2 * n_local, slots)
    recv = _received(senders, rows, tx, d, 3, cap)
    mine = _window((rows, tx, msgs), n_local, 3)
    got = model_ring_receive(*mine, senders, *recv, loss_u, 0.05, 8,
                             3 * n_local, slots, check_generation=False)
    want = _plain(*mine, senders, *recv, loss_u, 3 * n_local)
    assert not np.array_equal(got[0], want[0])


def _break(ids, e: int, kind: str, n_local: int):
    """``ids`` [d, cap] with route_pack's order broken in section e."""
    bad = ids.copy()
    last = int((ids[e] >= 0).sum()) - 1
    if kind == "swapped":
        bad[e, 0], bad[e, 1] = ids[e, 1], ids[e, 0]
    elif kind == "after the pads":
        bad[e, last + 2] = ids[e, last] + 1
    elif kind == "another shard's row":
        bad[e, 0] = (e + 1) % len(ids) * n_local + n_local // 2
    elif kind == "a pad not -1":
        bad[e, last + 1] = -2
    return bad


BROKEN = ["swapped", "after the pads", "another shard's row",
          "a pad not -1"]


@pytest.mark.parametrize("kind", BROKEN)
def test_broken_order_is_flagged(kind):
    """Each break of route_pack's order sets the flag, in the model and
    in the plain version; the intact ids set neither."""
    n, d, cap, shard = 4096, 8, 512, 3
    senders, rows, tx, msgs, loss_u = _state(5, n, 4, 8)
    n_local = n // d
    ids, recv_rows = _received(senders, rows, tx, d, shard, cap)
    mine = _window((rows, tx, msgs), n_local, shard)
    slots = SlotMap(n)
    for broken, flag in ((ids, 0), (_break(ids, 2, kind, n_local), 1)):
        got = model_ring_receive(*mine, senders, broken, recv_rows, loss_u,
                                 0.05, 8, shard * n_local, slots)
        assert got[3][0] == flag
        assert int(fabric.route_order_bad(torch.from_numpy(broken), n)) \
            == flag


N, R, D = 256, 4, 8
RING_PARAMS = {
    "global-loss": dict(fanout_ring0=0, fanout_global=3, ring0_size=1,
                        max_transmissions=4, loss=0.1),
    "ring0-loss": dict(fanout_ring0=1, fanout_global=2, ring0_size=16,
                       max_transmissions=4, loss=0.1),
    "wide-fanout": dict(fanout_ring0=2, fanout_global=4, ring0_size=16,
                        max_transmissions=4, loss=0.1),
}


def _model_wrapper(slots: SlotMap):
    """``ring_receive``'s signature over the model, one map for every
    shard and tick, as the card keeps one a device and stream."""
    def receive(rows, tx, msgs, senders, recv_ids, recv_rows, *, loss_u,
                loss, max_tx, lo):
        arrays = [None if a is None else a.numpy()
                  for a in (rows, tx, msgs, senders, recv_ids, recv_rows,
                            loss_u)]
        return tuple(torch.from_numpy(a) for a in model_ring_receive(
            *arrays, loss, max_tx, lo, slots))
    return receive


def _ring_run(monkeypatch, case, shards, cap, receive):
    """The reference's ring fabric and the port's (``ring_receive``
    replaced by ``receive``), three ticks from one seeded state; yields
    (tick, the port's overflow, the reference's, port leaves, reference
    leaves)."""
    monkeypatch.setattr(ts, "ring_receive", receive)
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
    for t in range(3):
        k = jax.random.fold_in(key, t)
        out = jstep(*ref, k)
        port, got_overflow = step(port, convert.key_from_numpy(
            np.asarray(k)))
        ref = list(out[:3])
        yield (t, got_overflow, int(out[3]),
               convert.unshard_state(port, ts.BroadcastShard(0, 0, 0)), ref)


@pytest.mark.parametrize("case", sorted(RING_PARAMS))
@pytest.mark.parametrize("shards,cap", [(8, None), (8, 1), (8, 3), (2, 5),
                                        (2, None), (1, None)])
def test_model_inside_the_ring_fabric_matches_reference(monkeypatch, case,
                                                        shards, cap):
    """The port's ring fabric with its receive side replaced by the model
    equals the reference's ring fabric on the virtual mesh, tick by
    tick: the rows, budgets and msgs after delivery and the exact
    overflow."""
    slots = SlotMap(N)
    overflow = 0
    for t, got, want, port, ref in _ring_run(monkeypatch, case, shards, cap,
                                            _model_wrapper(slots)):
        assert got == want
        overflow += got
        for name, g, w in zip(("rows", "tx", "msgs"), port, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"tick {t}: {name}")
    assert slots.gen == 3 * shards
    assert (overflow > 0) == (cap is not None and shards > 1)


@pytest.mark.parametrize("kind", BROKEN)
def test_ring_fabric_raises_on_a_broken_order(monkeypatch, kind):
    """Negative control: a pack that breaks route_pack's order in what
    shard 0 sends shard 3 makes the ring fabric's step raise (the flag
    is read with the overflow)."""
    pack = ts.route_pack

    def broken_pack(senders, active_l, rows_l, shard, cap):
        ids, rows, overflow = pack(senders, active_l, rows_l, shard, cap)
        if shard == 0:
            ids = ids.clone()
            ids[3] = torch.from_numpy(_break(ids[3:4].numpy(), 0, kind,
                                             N // D)[0])
        return ids, rows, overflow

    monkeypatch.setattr(ts, "route_pack", broken_pack)
    with pytest.raises(RuntimeError, match="route_pack's order"):
        for _ in _ring_run(monkeypatch, "ring0-loss", D, None,
                           fabric.ring_receive):
            pass
