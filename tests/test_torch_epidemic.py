"""The port's epidemic simulator against ``corrosion_tpu.sim.epidemic``.

Per-tick state is held bitwise over two chunks that include sync ticks
and the heal tick, for every topology; the stats dicts are held with
ints exact and floats to rtol 1e-6 (the port sums msgs exactly and
divides once, the reference's float32 reduction may round elsewhere).
Also: the package imports neither JAX nor the JAX package, and asking
for a card that is not there raises."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import epidemic as je
from corrosion_tpu_torch import convert, kernels
from corrosion_tpu_torch.kernels import deliver, sync_pull, threefry
from corrosion_tpu_torch.kernels import tick_stats as tstats
from corrosion_tpu_torch.random import fold_in
from corrosion_tpu_torch.sim import epidemic as te

ROOT = Path(__file__).resolve().parent.parent

BASE = dict(
    n_nodes=400, n_rows=8, fanout_ring0=2, fanout_global=2, ring0_size=32,
    max_transmissions=6, loss=0.05, partition_blocks=2, heal_tick=12,
    sync_interval=8, sync_peers=1, max_ticks=64, chunk_ticks=8,
)

TOPOLOGIES = {
    "uniform-loss-heal": {},
    "het-ring-backoff": dict(topology="het_ring", rtt_tiers=3,
                             backoff_ticks=1.5),
    "wan-two-region": dict(topology="wan_two_region", partition_blocks=1),
    "measured-ring": dict(topology="measured_ring",
                          rtt_tier_weights=(2.0, 1.0, 1.0),
                          backoff_ticks=2.5),
    "oneway-blocks": dict(oneway_blocks=((0, 1),), sync_peers=2),
}

_jit_tick = jax.jit(je.epidemic_tick, static_argnames=("cfg",))


def _cfgs(extra, **more):
    kw = {**BASE, **extra, **more}
    return je.EpidemicConfig(**kw), te.EpidemicConfig(**kw)


def _assert_state_equal(port, ref, where):
    ref = ref._asdict()
    got = convert.state_to_numpy(port)
    assert got["tick"] == int(ref["tick"]), where
    for f in convert.TENSOR_FIELDS:
        if ref[f] is None:
            assert got[f] is None, (where, f)
        else:
            np.testing.assert_array_equal(got[f], np.asarray(ref[f]),
                                          err_msg=f"{where}: {f}")


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_per_tick_state_matches_jax_bitwise(name):
    jcfg, tcfg = _cfgs(TOPOLOGIES[name], n_universes=3)
    jstate = je.epidemic_init(jcfg)
    tstate = convert.state_from_numpy(jstate, device="cpu")
    _assert_state_equal(tstate, jstate, "init")
    seed_key = jax.random.PRNGKey(4)
    tkey = convert.key_from_numpy(seed_key)
    # two chunks: sync ticks 7 and 15, the heal at 12
    for t in range(2 * jcfg.chunk_ticks):
        jstate = _jit_tick(jstate, jax.random.fold_in(seed_key, t), jcfg)
        tstate = te.epidemic_tick(tstate, fold_in(tkey, t), tcfg)
        _assert_state_equal(tstate, jstate, f"tick {t}")


def _assert_stats_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "wall_s":
            continue
        if w is None or isinstance(w, int) or k in ("converged_frac",
                                                   "ticks_p50", "ticks_p99"):
            assert g == w, (k, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("extra", [
    {}, dict(TOPOLOGIES["het-ring-backoff"], track_hops=False),
])
def test_run_epidemic_seeds_stats_match_jax(extra):
    jcfg, tcfg = _cfgs(extra)
    want = je.run_epidemic_seeds(jcfg, n_seeds=4, seed=2)
    got = te.run_epidemic_seeds(tcfg, n_seeds=4, seed=2, device="cpu")
    _assert_stats_close(got, want)
    assert got["converged_frac"] == 1.0


def test_run_epidemic_single_universe_matches_jax():
    jcfg, tcfg = _cfgs({})
    _assert_stats_close(te.run_epidemic(tcfg, seed=5, device="cpu"),
                        je.run_epidemic(jcfg, seed=5))


@pytest.mark.parametrize("oneway", [((0, 1),), ((1, 0),)])
def test_run_epidemic_coverage_truncates_like_jax(oneway):
    # the directed-partition cell of tests/test_epidemic_sim.py: with the
    # free direction (1, 0) the run ends at the first fully covered chunk
    kw = dict(n_nodes=64, n_rows=4, fanout_ring0=0, fanout_global=3,
              ring0_size=1, max_transmissions=5, partition_blocks=2,
              heal_tick=24, backoff_ticks=2.5, sync_interval=8,
              sync_peers=1, max_ticks=256, chunk_ticks=8,
              oneway_blocks=oneway)
    want = je.run_epidemic_coverage(je.EpidemicConfig(**kw), n_seeds=4)
    got = te.run_epidemic_coverage(te.EpidemicConfig(**kw), n_seeds=4,
                                   device="cpu")
    assert got["ticks_run"] == want["ticks_run"]
    assert len(got["coverage"]) == got["ticks_run"]
    assert got["converged_frac"] == want["converged_frac"]
    for k in ("coverage", "coverage_p10", "coverage_p90"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("track_hops", [True, False])
def test_tick_stats_plain_matches_jnp_percentiles(track_hops):
    rng = np.random.default_rng(9)
    s, n, r = 4, 301, 3
    rows = rng.integers(0, 2, (s * n, r)).astype(np.int32)
    rows[:n] = 1  # universe 0 converged
    target = np.ones(r, np.int32)
    msgs = rng.integers(0, 90, s * n).astype(np.int32)
    msgs[2 * n: 3 * n] += rng.integers(0, 10_000, n).astype(np.int32)
    hops = rng.integers(0, 12, s * n).astype(np.int32)
    unset = rng.random(s * n) < 0.3
    hops[unset] = np.where(rng.random(unset.sum()) < 0.5,
                           te.HOP_UNSET, te.HOP_UNSET - 1)
    hops[3 * n:] = te.HOP_UNSET  # universe 3: no measured depth
    out = tstats.tick_stats(
        torch.from_numpy(rows), torch.from_numpy(target),
        torch.from_numpy(msgs),
        torch.from_numpy(hops) if track_hops else None, s,
    ).numpy()

    holds = (rows.reshape(s, n, r) == target).all(axis=2)
    msgs_f = msgs.reshape(s, n).astype(np.float32)
    np.testing.assert_array_equal(out[:, tstats.CONVERGED],
                                  holds.all(axis=1).astype(np.float32))
    np.testing.assert_allclose(out[:, tstats.COVERAGE],
                               np.asarray(jnp.mean(holds, axis=1)),
                               rtol=1e-6)
    np.testing.assert_allclose(out[:, tstats.MSGS_MEAN],
                               np.asarray(jnp.mean(msgs_f, axis=1)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        out[:, tstats.MSGS_P99],
        np.asarray(jnp.percentile(msgs_f, 99, axis=1)), rtol=1e-6)
    if not track_hops:
        assert np.isnan(out[:, tstats.HOPS_P50]).all()
        assert (out[:, tstats.HOPS_COV] == 0).all()
        return
    hops_f = np.where(hops >= te.HOP_UNSET - 1, np.nan,
                      hops.astype(np.float32)).reshape(s, n)
    for col, q in ((tstats.HOPS_P50, 50), (tstats.HOPS_P99, 99)):
        np.testing.assert_allclose(
            out[:, col], np.asarray(jnp.nanpercentile(hops_f, q, axis=1)),
            rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(
        out[:, tstats.HOPS_COV],
        np.asarray(jnp.mean(~np.isnan(hops_f), axis=1)), rtol=1e-6)


@pytest.mark.parametrize("col", ["MSGS_P99", "HOPS_P50", "HOPS_P99"])
def test_stats_flagged_too_wide_raise(col):
    stats = np.ones((3, 4, len(tstats.STATS)), np.float32)
    stats[:, :, tstats.HOPS_P99] = np.nan  # no measured depth: no error
    tstats.raise_on_overflow(stats)
    stats[1, 2, getattr(tstats, col)] = np.inf
    with pytest.raises(ValueError, match="histogram"):
        tstats.raise_on_overflow(stats)


def test_cpu_runs_launch_no_kernel():
    counted = (threefry.threefry_bits, deliver.deliver_perm,
               sync_pull.sync_pull, tstats.tick_stats)
    before = [f.launches for f in counted]
    te.run_epidemic_seeds(te.EpidemicConfig(**BASE), n_seeds=2,
                          device="cpu")
    assert [f.launches for f in counted] == before


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the call would run")
    cfg = te.EpidemicConfig(**BASE)
    with pytest.raises(RuntimeError, match="CUDA"):
        te.run_epidemic_seeds(cfg, n_seeds=2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        te.epidemic_init(cfg)  # the default device is the card


def test_convert_roundtrip():
    jcfg, _ = _cfgs({}, n_universes=2)
    ref = je.epidemic_init(jcfg)
    port = convert.state_from_numpy(ref, device="cpu")
    back = convert.state_from_numpy(convert.state_to_numpy(port), "cpu")
    _assert_state_equal(back, ref, "roundtrip")
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        convert.key_to_numpy(convert.key_from_numpy(key)), np.asarray(key))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    # the package's sources; the kernels' build directory is output
    files = sorted(f for f in (ROOT / "corrosion_tpu_torch").rglob("*.py")
                   if kernels.BUILD_DIR not in f.parents)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "corrosion_tpu"), (f, mod)
    code = (
        "import sys\n"
        "import corrosion_tpu_torch.sim.epidemic\n"
        "import corrosion_tpu_torch.sim.calibrate\n"
        "import corrosion_tpu_torch.convert\n"
        "import corrosion_tpu_torch.profile_tick, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
