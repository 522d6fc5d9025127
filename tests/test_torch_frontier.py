"""The port's frontier-sparse exact kernel against the reference.

Per tick and bitwise: the port's seed-batched sparse tick against the
reference's ``frontier_exact_tick`` (every dense leaf and the ring
itself) and against the reference's dense ``packed_exact_tick``
(through ``frontier_sent_bitmap``), on the six scenario families of
``tests/test_frontier.py``, with a seeded ring corruption that must
break the equality.  Then ``run_exact_headline`` against the
reference for both representations, and dense against sparse in the
port (identical per-seed statistics).
"""

import jax
import numpy as np
import pytest

from corrosion_tpu.sim import calibrate as jc
from corrosion_tpu_torch.sim import calibrate as tc
from tests.test_torch_exact import (
    DENSE_FIELDS,
    FAMILIES,
    SEEDS,
    UNPARTITIONED,
    _cfgs,
    _jit_packed,
    _tkeys,
    assert_seeds_equal,
)


def sparse_lockstep(jcfg, tcfg, ticks, corrupt_at=None,
                    fields=DENSE_FIELDS + ("ring",)):
    """Port sparse (one batch) against the reference frontier and packed
    kernels (seed by seed), comparing ``fields`` with the frontier's
    and the decoded bitmap with the packed ``sent`` after every tick
    (the bitmap too when ``fields`` holds ``ring``)."""
    seeds = [jax.random.PRNGKey(s) for s in SEEDS]
    init_keys = [jax.random.fold_in(k, 2**20) for k in seeds]
    fronts = [jc.frontier_exact_init(jcfg, k) for k in init_keys]
    packs = [jc.packed_exact_init(jcfg, k) for k in init_keys]
    port = tc.frontier_exact_init(tcfg, _tkeys(init_keys), device="cpu")
    assert_seeds_equal(port, fronts, DENSE_FIELDS + ("ring",), "init")
    for t in range(ticks):
        kt = [jax.random.fold_in(k, t) for k in seeds]
        if corrupt_at is not None and corrupt_at[0] == t:
            port = corrupt_at[1](port, fronts, kt)
        fronts = [jc.frontier_exact_tick(f, k, jcfg)
                  for f, k in zip(fronts, kt)]
        packs = [_jit_packed(p, k, jcfg) for p, k in zip(packs, kt)]
        port = tc.frontier_exact_tick(port, _tkeys(kt), tcfg)
        assert_seeds_equal(port, fronts, fields, f"tick {t}")
        assert_seeds_equal(port, packs, [f for f in fields if f != "ring"],
                           f"tick {t} against the dense kernel")
        if "ring" in fields:
            bitmap = tc.frontier_sent_bitmap(port, tcfg)
            for s, p in enumerate(packs):
                np.testing.assert_array_equal(
                    bitmap[s], np.asarray(p.sent),
                    err_msg=f"tick {t}: seed {s} decoded bitmap")
    return fronts


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sparse_tick_matches_reference_bitwise(family):
    over, ticks = FAMILIES[family]
    jcfg, tcfg = _cfgs(**over)
    fronts = sparse_lockstep(jcfg, tcfg, ticks)
    assert all(np.asarray(f.infected).sum() > 64 for f in fronts)


def test_flipped_ring_slot_breaks_the_lockstep():
    """Negative control: before tick 1, write into an empty slot of the
    port writer's ring a target the writer is about to send to; its
    rejection loop must refuse that tuple and the trajectories part."""
    jcfg, tcfg = _cfgs(loss=0.0, **UNPARTITIONED, backoff_ticks=0.0)

    def flip(port, fronts, kt):
        nxt = jc.frontier_exact_tick(fronts[0], kt[0], jcfg)
        fresh = np.setdiff1d(np.asarray(nxt.ring[0]),
                             np.asarray(fronts[0].ring[0]))
        port.ring[0, 0, -1] = int(fresh[0])
        return port

    with pytest.raises(AssertionError, match="seed 0"):
        sparse_lockstep(jcfg, tcfg, 12, corrupt_at=(1, flip),
                        fields=("infected", "tx", "next_send", "msgs"))


RUN_KEYS = ("n_nodes", "n_seeds", "delivery_model", "kernel", "n_hosts",
            "converged_frac", "ticks_p50", "ticks_p99", "seed_batch",
            "n_shards")


@pytest.mark.parametrize("kernel", ["dense", "sparse"])
def test_run_exact_headline_matches_reference(kernel):
    """N = 1000 x 3 seeds, partition and loss: the reference's keys,
    ints and ticks exact, msgs/node to rtol 1e-6."""
    jcfg, tcfg = _cfgs(n=1000, heal_tick=6, sync_interval=4,
                       backoff_ticks=0.0, max_ticks=64)
    want = jc.run_exact_headline(jcfg, n_seeds=3, seed=0, kernel=kernel)
    got = tc.run_exact_headline(tcfg, n_seeds=3, seed=0, kernel=kernel,
                                device="cpu")
    assert set(want) <= set(got)
    assert {k: got[k] for k in RUN_KEYS} == {k: want[k] for k in RUN_KEYS}
    for k in ("msgs_per_node_mean", "msgs_per_node_p99"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["converged_frac"] == 1.0


def test_dense_and_sparse_runs_agree_per_seed():
    """The representation never moves a result: identical per-seed
    ticks and msgs from both kernels (4 seeds in batches of 3 and 1)."""
    _, tcfg = _cfgs(n=600, max_ticks=32)
    runs = [tc.run_exact_headline(tcfg, n_seeds=4, seed=2, kernel=k,
                                  seed_batch=3, device="cpu")
            for k in ("dense", "sparse")]
    for k in ("seed_ticks", "seed_msgs_mean", "seed_msgs_p99",
              "rejection"):
        assert runs[0][k] == runs[1][k], k
    assert runs[0]["converged_frac"] == 1.0
