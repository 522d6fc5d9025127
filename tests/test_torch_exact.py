"""The port's exact sampler (``corrosion_tpu_torch.sim.calibrate``, dense
bitmap) against ``corrosion_tpu.sim.calibrate``.

Per tick and bitwise on every leaf, bitmap included: the port's
seed-batched dense tick against the reference's ``packed_exact_tick``
run seed by seed, on the six scenario families ``tests/test_frontier.py``
pins, with a seeded corruption that must break the equality.  Also the
reuse of the ``sync_pull`` kernel as the reference's ``_sync_pull``,
the seed-batched chunk statistics (flags exact, floats to rtol 1e-6:
the port sums msgs exactly and divides once), the seed-batch policies,
the config validation, the topology maps, the converters and the
entry point's refusals.  The sparse kernel's twin is
``tests/test_torch_frontier.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import calibrate as jc
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import exact_send as es
from corrosion_tpu_torch.kernels import sync_pull, threefry, tick_stats
from corrosion_tpu_torch.kernels.tick_stats import (
    CONVERGED,
    MSGS_MEAN,
    MSGS_P99,
)
from corrosion_tpu_torch.sim import calibrate as tc

DENSE_FIELDS = ("infected", "tx", "next_send", "msgs", "pending")
MEASURED_WEIGHTS = (0, 0, 2, 2, 6, 1)
UNPARTITIONED = dict(partition_blocks=1, heal_tick=0)
# tests/test_frontier.py:67-95: (overrides, ticks)
FAMILIES = {
    "headline": ({}, 16),
    "het_ring": (dict(topology="het_ring", **UNPARTITIONED), 20),
    "wan_two_region": (dict(topology="wan_two_region", **UNPARTITIONED), 20),
    "measured_ring": (dict(topology="measured_ring",
                           rtt_tier_weights=MEASURED_WEIGHTS,
                           **UNPARTITIONED), 20),
    "wan_latency": (dict(topology="wan_two_region", wan_cross_loss=0.0,
                         wan_latency_ticks=2, **UNPARTITIONED), 20),
    "wan_latency_plus_loss": (dict(topology="wan_two_region",
                                   wan_latency_ticks=3, **UNPARTITIONED),
                              20),
}
SEEDS = (5, 6)

_jit_packed = jax.jit(jc.packed_exact_tick, static_argnames=("cfg",))


def _cfgs(n=256, **over):
    """The headline shape of tests/test_frontier.py ``_headline_cfg``
    (ring0 tier, loss, partition healing at tick 3, sync every 2 ticks,
    backoff 0.5) for both packages."""
    kw = dict(n_nodes=n, fanout=4, ring0_size=64, max_transmissions=8,
              loss=0.05, partition_blocks=2, heal_tick=3, sync_interval=2,
              backoff_ticks=0.5, max_ticks=48, chunk_ticks=8)
    kw.update(over)
    return jc.HeadlineExactConfig(**kw), tc.HeadlineExactConfig(**kw)


def _tkeys(keys):
    return [convert.key_from_numpy(k) for k in keys]


def assert_seeds_equal(port, refs, fields, where):
    """Every listed leaf of a port state (seed axis) equals the list of
    single-seed reference states (or numpy arrays per seed)."""
    got = convert.exact_state_to_numpy(port)
    for s, ref in enumerate(refs):
        assert got["tick"] == int(ref.tick), where
        for f in fields:
            np.testing.assert_array_equal(
                got[f][s], np.asarray(getattr(ref, f)),
                err_msg=f"{where}: seed {s} {f}")


def dense_lockstep(jcfg, tcfg, ticks, corrupt_at=None,
                   fields=DENSE_FIELDS + ("sent",)):
    """Port dense (both seeds in one batch) and reference packed (seed
    by seed) tick for tick, comparing ``fields`` after every tick;
    ``corrupt_at`` = (tick, fn) edits the port's state before that
    tick.  Returns the reference states."""
    seeds = [jax.random.PRNGKey(s) for s in SEEDS]
    init_keys = [jax.random.fold_in(k, 2**20) for k in seeds]
    refs = [jc.packed_exact_init(jcfg, k) for k in init_keys]
    port = tc.packed_exact_init(tcfg, _tkeys(init_keys), device="cpu")
    assert_seeds_equal(port, refs, DENSE_FIELDS + ("sent",), "init")
    for t in range(ticks):
        kt = [jax.random.fold_in(k, t) for k in seeds]
        if corrupt_at is not None and corrupt_at[0] == t:
            port = corrupt_at[1](port, refs, kt)
        refs = [_jit_packed(r, k, jcfg) for r, k in zip(refs, kt)]
        port = tc.packed_exact_tick(port, _tkeys(kt), tcfg)
        assert_seeds_equal(port, refs, fields, f"tick {t}")
    return refs


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dense_tick_matches_packed_exact_tick_bitwise(family):
    over, ticks = FAMILIES[family]
    jcfg, tcfg = _cfgs(**over)
    refs = dense_lockstep(jcfg, tcfg, ticks)
    # real spread, not the equality of two empty runs
    assert all(np.asarray(r.infected).sum() > 64 for r in refs)


def test_flipped_bitmap_bit_breaks_the_lockstep():
    """Negative control: before tick 1, set in the port's bitmap the
    bit of a target the writer is about to send to.  Its rejection loop
    must then refuse that tuple, so the trajectories part — the
    equality has discriminating power beyond the flipped bit itself."""
    jcfg, tcfg = _cfgs(loss=0.0, **UNPARTITIONED, backoff_ticks=0.0)

    def flip(port, refs, kt):
        nxt = _jit_packed(refs[0], kt[0], jcfg)
        fresh = np.asarray(nxt.sent[0]) & ~np.asarray(refs[0].sent[0])
        byte = int(np.flatnonzero(fresh)[0])
        bit = int(fresh[byte]) & -int(fresh[byte])
        port.sent[0, 0, byte] |= bit
        return port

    # the dense leaves only: the bitmap differs from the flip on
    with pytest.raises(AssertionError, match="seed 0"):
        dense_lockstep(jcfg, tcfg, 12, corrupt_at=(1, flip),
                       fields=("infected", "tx", "next_send", "msgs"))


@pytest.mark.parametrize("part_active", [True, False])
@pytest.mark.parametrize("p", [1, 2])
def test_sync_pull_reuse_matches_reference(part_active, p):
    """``_sync_pull`` through the ``sync_pull`` kernel's plain version
    (R = 1, one universe per seed, offsets (peer - local) mod N, self
    draws as self-sessions) against the reference's algebra."""
    jcfg, tcfg = _cfgs(n=300, sync_peers=p)
    rng = np.random.default_rng(p)
    s, n = 3, jcfg.n_nodes
    infected = rng.random((s, n)) < 0.4
    msgs = rng.integers(0, 50, (s, n)).astype(np.int32)
    peers = rng.integers(0, n, (s, n, p)).astype(np.int32)
    peers[0, :5, 0] = np.arange(5)  # self-sessions
    part = np.asarray(jc._partition_of(jcfg))
    reach = np.ones((s, n, p), bool)
    if part_active:
        reach &= part[:, None] == part[peers]
    healed, pay = jc._sync_pull(jnp.asarray(infected), jnp.asarray(peers),
                                jnp.asarray(reach), jcfg)
    got_inf, got_msgs = tc._sync_pull(
        torch.from_numpy(infected), torch.from_numpy(msgs),
        torch.from_numpy(peers), tcfg,
        part=tc._partition_of(tcfg, "cpu"), part_active=part_active)
    np.testing.assert_array_equal(got_inf.numpy(),
                                  infected | np.asarray(healed))
    np.testing.assert_array_equal(got_msgs.numpy(), msgs + np.asarray(pay))


def _batched_init(jcfg, init_fn, seeds):
    base = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    return base, jax.vmap(
        lambda kk: init_fn(jcfg, jax.random.fold_in(kk, 2**20)))(base)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_chunk_stats_match_reference(kind):
    """Two seed-batched chunks (3 seeds): the port's per-tick
    ``tick_stats`` rows against the reference's [C, S] all-infected
    flags (exact) and msgs mean / p99 (rtol 1e-6), state bitwise."""
    jcfg, tcfg = _cfgs()
    if kind == "dense":
        j_init, j_chunk = jc.packed_exact_init, jc._packed_scan_chunk_batch
        from_np, t_chunk = (convert.packed_state_from_numpy,
                            tc._packed_scan_chunk_batch)
    else:
        j_init, j_chunk = (jc.frontier_exact_init,
                           jc._frontier_scan_chunk_batch)
        from_np, t_chunk = (convert.frontier_state_from_numpy,
                            tc._frontier_scan_chunk_batch)
    base, jstate = _batched_init(jcfg, j_init, (0, 1, 2))
    port = from_np(jax.tree.map(np.asarray, jstate), device="cpu")
    tkeys = _tkeys(list(base))
    for _ in range(2):
        jstate, (conv, mean, p99) = j_chunk(jstate, base, jcfg)
        port, stats = t_chunk(port, tkeys, tcfg)
        np.testing.assert_array_equal(stats[..., CONVERGED].numpy() == 1.0,
                                      np.asarray(conv))
        np.testing.assert_allclose(stats[..., MSGS_MEAN].numpy(),
                                   np.asarray(mean), rtol=1e-6)
        np.testing.assert_allclose(stats[..., MSGS_P99].numpy(),
                                   np.asarray(p99), rtol=1e-6)
        got = convert.exact_state_to_numpy(port)
        for f, v in jstate._asdict().items():
            if f != "tick":
                np.testing.assert_array_equal(got[f], np.asarray(v), f)
    assert np.asarray(conv)[-1].all()


@pytest.mark.parametrize("n,seeds,budget", [
    (100_000, 16, 40 << 30), (100_000, 16, 8 << 30),
    (100_000, 16, 2 << 30), (1_000_000, 4, 40 << 30),
    (1_000_000, 64, 1 << 30), (1000, 3, None), (2000, 40, 1 << 40),
])
def test_seed_batch_policies_match_reference(n, seeds, budget):
    """The reference's policies, at one shard and at eight (nodes; and
    hosts, with a budget)."""
    jcfg, tcfg = _cfgs(n=n)
    for shards in (1, 8):
        assert tc.exact_seed_batch(tcfg, seeds, shards, budget) == (
            jc.exact_seed_batch(jcfg, seeds, shards, budget))
        assert tc.frontier_seed_batch(tcfg, seeds, shards, budget) == (
            jc.frontier_seed_batch(jcfg, seeds, shards, budget))
        if budget is not None:
            assert tc.frontier_seed_batch(
                tcfg, seeds, shards, budget, host_sharded=True) == (
                jc.frontier_seed_batch(jcfg, seeds, shards, budget,
                                       host_sharded=True))


@pytest.mark.parametrize("capped", [0, 2])
def test_capped_rows_raise(capped):
    """A kernel row that hits the round cap sends nothing and can only
    count itself; the host check of the counters must raise on it."""
    diag = np.array([10, 12, 3, capped], np.int64)
    if capped:
        with pytest.raises(RuntimeError, match="2 rows found no valid"):
            es.raise_on_capped(diag)
    else:
        es.raise_on_capped(diag)


@pytest.mark.parametrize("bad", [
    dict(topology="ring"), dict(topology="het_ring", rtt_tiers=0),
    dict(topology="wan_two_region", wan_blocks=1),
    dict(topology="measured_ring"),
    dict(topology="measured_ring", rtt_tier_weights=(1.0, -1.0)),
    dict(wan_latency_ticks=-1), dict(wan_latency_ticks=2),
    dict(n_nodes=300, ring0_size=256),
])
def test_config_validation_matches_reference(bad):
    kw = {"n_nodes": 1000, **bad}
    with pytest.raises(ValueError) as ref:
        jc.HeadlineExactConfig(**kw)
    with pytest.raises(ValueError) as port:
        tc.HeadlineExactConfig(**kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("over", [
    {}, dict(topology="het_ring", rtt_tiers=3),
    dict(topology="measured_ring", rtt_tier_weights=MEASURED_WEIGHTS),
    dict(topology="wan_two_region", wan_blocks=3),
    dict(topology="wan_two_region", wan_cross_loss=0.0,
         wan_latency_ticks=2),
    dict(partition_blocks=3),
])
def test_topology_maps_match_reference(over):
    jcfg, tcfg = _cfgs(n=997, **over)
    for name in ("_partition_of", "_rtt_tier_of", "_region_of",
                 "_latency_region_of"):
        want = getattr(jc, name)(jcfg)
        got = getattr(tc, name)(tcfg, "cpu")
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          name)


def test_mesh_and_host_sharded_raise():
    """A mesh that is not the port's, and ``host_sharded`` without a
    mesh, are refused (the layouts themselves:
    tests/test_torch_sharded_exact.py)."""
    _, tcfg = _cfgs(n=1000)
    with pytest.raises(ValueError, match="mesh must be"):
        tc.run_exact_headline(tcfg, n_seeds=1, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="host_sharded needs"):
        tc.run_exact_headline(tcfg, n_seeds=1, device="cpu",
                              host_sharded=True, kernel="sparse")
    with pytest.raises(ValueError, match="unknown kernel"):
        tc.run_exact_headline(tcfg, kernel="ring", device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the call would run")
    _, tcfg = _cfgs(n=1000)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_exact_headline(tcfg, n_seeds=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.packed_exact_init(tcfg, [(0, 1)])  # the default is the card


def test_cpu_run_launches_no_kernel_and_counts_rounds():
    counted = (es.exact_send, es.exact_commit, sync_pull.sync_pull,
               tick_stats.tick_stats, threefry.threefry_bits)
    before = [f.launches for f in counted]
    _, tcfg = _cfgs()
    res = tc.run_exact_headline(tcfg, n_seeds=2, device="cpu")
    assert [f.launches for f in counted] == before
    assert res["converged_frac"] == 1.0
    rej = res["rejection"]
    assert rej["active_rows"] > 0 and 1.0 <= rej["rounds_mean"]
    assert rej["rounds_max"] >= 1
    assert res["budget_source"] == "cpu_default_8GiB"


@pytest.mark.parametrize("batched", [False, True])
def test_convert_exact_states_roundtrip(batched):
    jcfg, _ = _cfgs()
    for init, from_np in ((jc.packed_exact_init,
                           convert.packed_state_from_numpy),
                          (jc.frontier_exact_init,
                           convert.frontier_state_from_numpy)):
        if batched:
            _, ref = _batched_init(jcfg, init, (3, 4))
        else:
            ref = init(jcfg, jax.random.PRNGKey(3))
        ref = jax.tree.map(np.asarray, ref)
        port = from_np(ref, device="cpu")
        back = from_np(convert.exact_state_to_numpy(port), device="cpu")
        got = convert.exact_state_to_numpy(back)
        for f, v in ref._asdict().items():
            if f == "tick":
                assert got[f] == 0
            else:
                np.testing.assert_array_equal(
                    got[f], v if batched else v[None], f)
