"""The port's twin of the multi-chip dry run (``corrosion_tpu_torch.entry``)
against ``__graft_entry__.py`` on the 8-device virtual JAX mesh.

Bitwise, tick by tick, from the same inputs and keys: the vmapped
epidemic tick sharded over a ``("seeds", "nodes")`` mesh of 2 x 4
shards (``models.sharded.sharded_epidemic_tick``) against the
reference's GSPMD ``jax.vmap(epidemic_tick)`` under
``epidemic_shardings`` (partition-active, heal and sync ticks, hops on
and off, a one-way partition with backoff, and the 40-tick convergence
case of ``tests/test_sharding.py``); the SWIM step with its viewer rows
over the ``nodes`` axis (``sharded_swim_step``) against ``swim_step``
under ``swim_shardings``, at 256 nodes and through a 64-node churn
schedule; the placements leaf for leaf; the delivery and sync
kernels' plain versions in window form against slices of their whole
calls; the dry run itself; and the mesh's one-axis callers, whose
collectives and counters the second axis leaves as they were.  Each
shard is a ``LocalFabric`` shard on the CPU; ranks over
``torch.distributed`` are ``tests/test_torch_dist.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as ge
from corrosion_tpu.models.swim import SwimParams as JSwimParams
from corrosion_tpu.models.swim import swim_init as j_swim_init
from corrosion_tpu.models.swim import swim_step as j_swim_step
from corrosion_tpu.sim.epidemic import EpidemicConfig as JConfig
from corrosion_tpu.sim.epidemic import epidemic_init as j_init
from corrosion_tpu.sim.epidemic import epidemic_tick as j_tick
from corrosion_tpu_torch import convert, entry
from corrosion_tpu_torch.kernels.deliver import (
    HOP_UNSET,
    deliver_perm,
    deliver_perm_plain,
    sender_hops,
)
from corrosion_tpu_torch.kernels.sync_pull import sync_pull
from corrosion_tpu_torch.mesh import (
    MESH_AXES,
    LocalFabric,
    Mesh,
    all_gather,
    all_reduce,
    all_to_all,
)
from corrosion_tpu_torch.models.common import severance_matrix
from corrosion_tpu_torch.models.sharded import (
    sharded_epidemic_tick,
    sharded_swim_step,
)
from corrosion_tpu_torch.models.swim import SwimParams, swim_init
from corrosion_tpu_torch.sim.churn import ChurnConfig, _schedule
from corrosion_tpu_torch.sim.epidemic import EpidemicConfig, epidemic_init

SHAPE = (2, 4)
EPIDEMIC = dict(n_nodes=256, n_rows=4, ring0_size=16, loss=0.05,
                partition_blocks=2, heal_tick=2, sync_interval=2)
VARIANTS = {
    "hops": {},
    "no_hops": dict(track_hops=False),
    "oneway_backoff": dict(heal_tick=4, oneway_blocks=((0, 1),),
                           backoff_ticks=1.5, sync_peers=2),
}


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh(np.array(jax.devices()[:8]).reshape(SHAPE),
                   ("seeds", "nodes"))


def _mesh():
    return Mesh(MESH_AXES, LocalFabric(8, "cpu"), SHAPE)


def _tkey(key):
    return convert.key_from_numpy(np.asarray(key))


def _ref_batched(cfg, n_seeds):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n_seeds,) + x.shape),
                        j_init(cfg))


def _assert_epidemic_equal(got, want, label):
    for f in ("rows", "tx_remaining", "msgs", "hops", "next_send"):
        w = getattr(want, f)
        g = getattr(got, f)
        if w is None:
            assert g is None, (label, f)
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{label} {f}")
    assert set(np.asarray(want.tick).tolist()) == {got.tick}, label


def _run_epidemic(jmesh, cfg_kw, n_seeds, ticks, key_seed, until=None):
    """The reference's GSPMD vmapped tick and the port's sharded tick
    side by side for ``ticks`` ticks; returns the ticks run and the
    port's last global state."""
    jcfg, tcfg = JConfig(**cfg_kw), EpidemicConfig(**cfg_kw)
    batched = _ref_batched(jcfg, n_seeds)
    shardings = ge.epidemic_shardings(jmesh, batched)
    batched = jax.device_put(batched, shardings)
    jstep = jax.jit(jax.vmap(lambda st, k: j_tick(st, k, jcfg)),
                    out_shardings=shardings)
    mesh = _mesh()
    port = entry.batch_state(epidemic_init(tcfg, device="cpu"), n_seeds)
    specs = entry.epidemic_shardings(mesh, port)
    state = entry.shard_state(port, mesh, specs)
    step = sharded_epidemic_tick(mesh, tcfg)
    key = jax.random.PRNGKey(key_seed)
    for t in range(ticks):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, n_seeds)
        batched = jstep(batched, jax.device_put(
            keys, NamedSharding(jmesh, P("seeds"))))
        state = step(state, [_tkey(k) for k in np.asarray(keys)])
        got = entry.unshard_state(state, specs)
        _assert_epidemic_equal(got, batched, f"tick {t}")
        if until is not None and until(got):
            return t + 1, got
    return ticks, got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_epidemic_tick_matches_reference(jmesh, variant):
    """4 seeds x 256 nodes over (2, 4), 10 ticks: the partition holds,
    heals, and the sync runs on ticks 1, 3, 5, 7, 9."""
    _, got = _run_epidemic(jmesh, {**EPIDEMIC, **VARIANTS[variant]}, 4, 10,
                           key_seed=7)
    assert int(got.msgs.sum()) > 0


def test_sharded_epidemic_converges_like_reference(jmesh):
    """tests/test_sharding.py's 40-tick convergence case, bitwise every
    tick until the writer's rows reach every node of both seeds."""
    cfg_kw = dict(n_nodes=256, n_rows=4, ring0_size=32, fanout_ring0=3,
                  fanout_global=3, max_transmissions=8, loss=0.0,
                  sync_interval=2)
    target = epidemic_init(EpidemicConfig(**cfg_kw), device="cpu").rows[0]
    ticks, got = _run_epidemic(
        jmesh, cfg_kw, 2, 40, key_seed=3,
        until=lambda st: bool((st.rows == target).all()))
    assert bool((got.rows == target).all()), f"not converged in {ticks}"


def test_sharded_epidemic_refuses_what_it_does_not_shard():
    mesh = _mesh()
    for kw in (dict(track_sent=True), dict(n_universes=2),
               dict(topology="wan_two_region")):
        with pytest.raises(NotImplementedError):
            sharded_epidemic_tick(mesh, EpidemicConfig(n_nodes=64, **kw))


def _swim_run(jmesh, n, ticks, params_kw, schedule=None):
    sp_kw = dict(n_nodes=n, **params_kw)
    jsp, tsp = JSwimParams(**sp_kw), SwimParams(**sp_kw)
    jsw = j_swim_init(n)
    sw_shard = ge.swim_shardings(jmesh, jsw)
    jsw = jax.device_put(jsw, sw_shard)
    jstep = jax.jit(lambda st, k, t, a, r: j_swim_step(st, k, t, jsp, a, r),
                    out_shardings=sw_shard)
    mesh = _mesh()
    sw = swim_init(n, device="cpu")
    specs = entry.swim_shardings(mesh, sw)
    state = entry.shard_state(sw, mesh, specs)
    step = sharded_swim_step(mesh, tsp)
    flags = torch.zeros(2, dtype=torch.int32)
    want_flags = np.zeros(2, np.int64)
    for t in range(ticks):
        victim, alive, revived = 0, np.ones(n, bool), np.zeros(n, bool)
        if schedule is not None:
            victim, dead, rev = _schedule(schedule, t)
            alive[victim] = not dead
            revived[victim] = rev
        key = jax.random.fold_in(jax.random.PRNGKey(11), t)
        jsw = jstep(jsw, key, jnp.int32(t), jnp.asarray(alive),
                    jnp.asarray(revived))
        state = step(state, _tkey(key), t, torch.from_numpy(alive),
                     torch.from_numpy(revived), victim=victim, flags=flags)
        got = entry.unshard_state(state, specs)
        for f in got._fields:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(jsw, f)),
                err_msg=f"tick {t} {f}")
        col = np.asarray(jsw.view)[:, victim] % 4
        others = np.arange(n) != victim
        want_flags += [((col == 2) & others).sum(),
                       ((col == 0) & others).sum()]
        assert flags.tolist() == want_flags.tolist(), t
    assert np.asarray(jsw.view).shape == (n, n)
    return got


def test_sharded_swim_step_matches_reference(jmesh):
    got = _swim_run(jmesh, 256, 6, dict(loss=0.1))
    assert int(got.msgs.sum()) > 0


def test_sharded_swim_churn_matches_reference(jmesh):
    """64 nodes through kill, suspicion, DOWN, revive and rejoin."""
    cfg = ChurnConfig(n_nodes=64, cycles=2, cycle_period=32, kill_tick=2,
                      revive_tick=20)
    params = {f: getattr(cfg.params, f) for f in (
        "suspect_timeout", "update_tx_limit")}
    got = _swim_run(jmesh, 64, 56, dict(params, loss=0.15,
                                        gossip_entries=10), schedule=cfg)
    assert int(got.incarnation.max()) > 0  # a refutation or a rejoin ran


def _spec(sharding):
    return tuple(sharding.spec)


@pytest.mark.parametrize("kw", [{}, dict(track_hops=False),
                                dict(track_sent=True, n_nodes=64)])
def test_placements_match_reference(jmesh, kw):
    cfg_kw = {**EPIDEMIC, **kw}
    ref = ge.epidemic_shardings(jmesh, _ref_batched(JConfig(**cfg_kw), 4))
    port = entry.epidemic_shardings(_mesh(), entry.batch_state(
        epidemic_init(EpidemicConfig(**cfg_kw), device="cpu"), 4))
    for f in port._fields:
        r, p = getattr(ref, f), getattr(port, f)
        assert (None if r is None else _spec(r)) == p, f
    ref_sw = ge.swim_shardings(jmesh, j_swim_init(64))
    port_sw = entry.swim_shardings(_mesh(), swim_init(64, device="cpu"))
    for f in port_sw._fields:
        assert _spec(getattr(ref_sw, f)) == getattr(port_sw, f), f


def test_shard_state_round_trip_and_none_leaves():
    mesh = _mesh()
    cfg = EpidemicConfig(**EPIDEMIC, track_hops=False)
    batched = entry.batch_state(epidemic_init(cfg, device="cpu"), 4)
    batched = batched._replace(msgs=torch.arange(4 * 256, dtype=torch.int32)
                               .reshape(4, 256))
    specs = entry.epidemic_shardings(mesh, batched)
    sharded = entry.shard_state(batched, mesh, specs)
    part = sharded[6]  # seeds row 1, node shard 2
    assert part.hops is None and part.sent is None
    assert torch.equal(part.msgs, batched.msgs[2:4, 128:192])
    back = entry.unshard_state(sharded, specs)
    for a, b in zip(back, batched):
        assert (a is None and b is None) or (
            a == b if isinstance(a, int) else torch.equal(a, b))
    sw_specs = entry.swim_shardings(mesh, swim_init(64, device="cpu"))
    sw = entry.shard_state(swim_init(64, device="cpu"), mesh, sw_specs)
    assert sw[1].view.shape == (16, 64)
    assert torch.equal(sw[1].view, sw[5].view)  # replicated over seeds
    bad = entry.Sharded(mesh, {**{sh: sw[sh] for sh in range(8)},
                               5: sw[5]._replace(msgs=sw[5].msgs + 1)})
    with pytest.raises(ValueError, match="replica"):
        entry.unshard_state(bad, sw_specs)


def _window_inputs(seed, n=96, r=4, k=3):
    g = np.random.default_rng(seed)
    rows = torch.from_numpy(g.integers(0, 50, (n, r)).astype(np.int32))
    tx = torch.from_numpy(g.integers(0, 3, n).astype(np.int32))
    hops = torch.from_numpy(np.where(g.random(n) < 0.5, g.integers(0, 6, n),
                                     HOP_UNSET).astype(np.int32))
    nxt = torch.from_numpy(g.integers(0, 6, n).astype(np.int32))
    senders = torch.from_numpy(np.stack([g.permutation(n) for _ in range(k)])
                               .astype(np.int32))
    loss_u = torch.from_numpy(g.random((n, k)).astype(np.float32))
    part = torch.from_numpy((np.arange(n) * 3 // n).astype(np.int32))
    return rows, tx, torch.zeros(n, dtype=torch.int32), hops, nxt, senders, \
        loss_u, part


@pytest.mark.parametrize("variant", ["plain", "no_hops", "partition",
                                     "oneway"])
def test_deliver_window_is_a_slice_of_the_whole(variant):
    rows, tx, msgs, hops, nxt, senders, loss_u, part = _window_inputs(3)
    if variant == "no_hops":
        hops = None
    kw = dict(next_send=nxt, tick=3, loss_u=loss_u, loss=0.2, max_tx=5,
              backoff=1.5)
    if variant in ("partition", "oneway"):
        kw.update(partition_id=part, partition_active=True)
    if variant == "oneway":
        kw["sev"] = severance_matrix(((0, 1), (2, 0)), "cpu")
    whole = deliver_perm(rows, tx, msgs, senders, hops=hops, **kw)
    shops = sender_hops(tx, nxt, 3, hops)
    for lo in (0, 32, 64):
        w = slice(lo, lo + 32)
        got = deliver_perm(rows[w], tx[w], msgs[w], senders,
                           hops=None if hops is None else hops[w],
                           **{**kw, "next_send": nxt[w]}, src_rows=rows,
                           shops=shops, lo=lo)
        for a, b in zip(got, whole):
            assert (a is None and b is None) or torch.equal(a, b[w]), lo
    # a slot map's source: present senders carry hop candidate 0
    slot_of = torch.where(shops < HOP_UNSET,
                          torch.arange(96, dtype=torch.int32), -1).to(
        torch.int32)
    got = deliver_perm_plain(rows[32:64], tx[32:64], msgs[32:64], senders,
                             **{**kw, "next_send": nxt[32:64]},
                             src_rows=rows, slot_of=slot_of, lo=32)
    want = deliver_perm_plain(rows[32:64], tx[32:64], msgs[32:64], senders,
                              **{**kw, "next_send": nxt[32:64]},
                              src_rows=rows, shops=torch.where(
                                  shops < HOP_UNSET, 0, HOP_UNSET).to(
                                  torch.int32), lo=32)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="topology"):
        deliver_perm(rows[:32], tx[:32], msgs[:32], senders, src_rows=rows,
                     shops=shops, tier=part, lo=0)


@pytest.mark.parametrize("variant", ["plain", "partition", "three_peers"])
def test_sync_window_is_a_slice_of_the_whole(variant):
    rows, _, msgs, _, _, _, _, part = _window_inputs(5)
    msgs = torch.arange(96, dtype=torch.int32)
    g = np.random.default_rng(6)
    p = 3 if variant == "three_peers" else 1
    offs = torch.from_numpy(g.integers(1, 96, (96, p)).astype(np.int32))
    kw = dict(cells_per_chunk=2, handshake_msgs=2)
    if variant == "partition":
        kw.update(partition_id=part, partition_active=True,
                  sev=severance_matrix(((1, 2),), "cpu"))
    whole_rows, whole_msgs = sync_pull(rows, msgs, offs, 96, **kw)
    served = torch.zeros(96, dtype=torch.int32)
    mine = []
    for lo in (0, 24, 48, 72):
        w = slice(lo, lo + 24)
        r, m, delta = sync_pull(rows[w], msgs[w], offs, 96, src_rows=rows,
                                lo=lo, **kw)
        assert torch.equal(r, whole_rows[w]), lo
        served += delta
        mine.append((w, m))
    for w, m in mine:
        assert torch.equal(m + served[w], whole_msgs[w])


def test_dryrun_multichip_inline_path(capsys):
    out = entry.dryrun_multichip(8, device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("dryrun_multichip ok: mesh={'seeds': 2, "
                                 "'nodes': 4}")
    shape = out["headline_shape"]
    assert shape["n_nodes"] == 16384 and shape["n_seeds"] == 4
    assert shape["ring_overflow_last_tick"] == 0
    assert shape["sharded_tick_bytes"]["rows"] > 0
    for kind in ("rows", "hops", "sync", "swim_select", "swim_ping", "ids"):
        assert out["fabric"]["bytes"][kind] > 0, kind


def test_one_axis_mesh_callers_unchanged():
    """A one-axis mesh keeps one group over every shard: its collectives
    and counters as before; a two-axis mesh runs them per seeds row and
    refuses the seeds axis."""
    xs = {sh: torch.full((2, 3), sh, dtype=torch.int32) for sh in range(4)}

    def local(sh, x, d):
        a = yield all_gather(x, "g", dim=1)
        b = yield all_reduce(x, "r")
        c = yield all_to_all(torch.stack([x[0]] * d), "a")
        return a, b, c

    for axis in ("nodes", "hosts"):
        fabric = LocalFabric(4, "cpu")
        mesh = Mesh(axis, fabric)
        assert (mesh.axes, mesh.shape, mesh.coords(3)) == ((axis,), (4,),
                                                          (3,))
        out = mesh.run(local, {sh: (xs[sh], 4) for sh in range(4)})
        for sh in range(4):
            a, b, c = out[sh]
            assert torch.equal(a, torch.cat([xs[i] for i in range(4)], 1))
            assert torch.equal(b, torch.full((2, 3), 6, dtype=torch.int32))
            assert torch.equal(c[:, 0], torch.arange(4, dtype=torch.int32))
        assert fabric.bytes == {"g": 3 * 4 * 24, "r": 3 * 4 * 24,
                                "a": 12 * 12}
        assert fabric.calls == {"g": 1, "r": 1, "a": 1}
    fabric = LocalFabric(4, "cpu")
    two = Mesh(MESH_AXES, fabric, (2, 2))
    assert two.axis is None and two.coords(3) == (1, 1)
    out = two.run(local, {sh: (xs[sh], 2) for sh in range(4)})
    assert torch.equal(out[3][0], torch.cat([xs[2], xs[3]], 1))
    assert torch.equal(out[3][2][:, 0], torch.tensor([2, 3],
                                                     dtype=torch.int32))
    assert torch.equal(out[0][1], torch.full((2, 3), 1, dtype=torch.int32))
    assert fabric.bytes == {"g": 2 * 2 * 24, "r": 2 * 2 * 24,
                            "a": 2 * 2 * 12}
    assert fabric.calls == {"g": 2, "r": 2, "a": 2}

    def seeds_axis(sh, x):
        yield all_gather(x, "g", axis="seeds")

    with pytest.raises(ValueError, match="nodes"):
        two.run(seeds_axis, {sh: (xs[sh],) for sh in range(4)})
    with pytest.raises(ValueError):
        Mesh(MESH_AXES, LocalFabric(6, "cpu"), (2, 2))
    with pytest.raises(ValueError):
        Mesh(("nodes", "seeds"), LocalFabric(4, "cpu"), (2, 2))


def test_entry_round_runs_on_the_cpu():
    fn, (state, key) = entry.entry(device="cpu")
    out = fn(state, key)
    assert out.rows.shape == (4096, 8) and out.tick == 1
    with pytest.raises(ValueError):
        entry.epidemic_shardings(Mesh("nodes", LocalFabric(2, "cpu")),
                                 state)
