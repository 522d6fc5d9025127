"""The port's ``tick_stats`` byte-row form and its block plan.

The byte form (the exact runners' bool / uint8 ``infected``, no target)
must give what the int32 form gives for the same flags, and what the
reference's chunk statistics give (``corrosion_tpu/sim/calibrate.py``
``_packed_scan_chunk_batch``: all infected exactly, msgs mean and p99
to rtol 1e-6, the port summing exactly and dividing once).  The exact
runners' ``_stats_into`` must reach the statistics it reached through
the int32 form.  ``stats_plan`` must cover every row of a universe
exactly once, with more than one block a universe at the main path's
shapes on an H100's 132 SMs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu_torch.kernels import tick_stats as ts
from corrosion_tpu_torch.sim import calibrate as tc

H100_SMS = 132
# the statistics shapes of the main path: the headline, exact dense and
# sparse, the mesh's host-sparse 10M (a copy a host)
MAIN_SHAPES = ((32, 100_000), (16, 100_000), (4, 1_000_000),
               (2, 10_000_000))


def _flags_and_msgs(seed: int, s: int, n: int, density: float):
    rng = np.random.default_rng(seed)
    infected = rng.random((s, n)) < density
    infected[0] = True  # one seed converged
    msgs = (rng.integers(0, 9, (s, n)) * 4
            + rng.integers(0, 3, (s, n))).astype(np.int32)
    msgs[-1] += rng.integers(0, 3000, n).astype(np.int32)
    return infected, msgs


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
@pytest.mark.parametrize("seed,s,n,density", [
    (0, 3, 257, 0.5), (1, 1, 1000, 0.9), (2, 5, 4099, 0.99),
    (3, 2, 64, 0.0),
])
def test_byte_rows_match_int32_rows_and_reference(dtype, seed, s, n,
                                                  density):
    infected, msgs = _flags_and_msgs(seed, s, n, density)
    flags = torch.from_numpy(infected).to(dtype)
    m = torch.from_numpy(msgs.reshape(-1))
    out = torch.empty((s, len(ts.STATS)), dtype=torch.float32)
    got = ts.tick_stats(flags, None, m, None, s, out=out).clone()
    as_int = ts.tick_stats_plain(
        torch.from_numpy(infected.astype(np.int32)).reshape(-1, 1),
        torch.ones(1, dtype=torch.int32), m, None, s, torch.empty_like(out))
    np.testing.assert_array_equal(got.numpy(), as_int.numpy())
    msgs_f = msgs.astype(np.float32)
    np.testing.assert_array_equal(got[:, ts.CONVERGED].numpy() == 1.0,
                                  np.asarray(jnp.all(infected, axis=1)))
    np.testing.assert_allclose(got[:, ts.COVERAGE].numpy(),
                               np.asarray(jnp.mean(infected, axis=1)),
                               rtol=1e-6)
    np.testing.assert_allclose(got[:, ts.MSGS_MEAN].numpy(),
                               np.asarray(jnp.mean(msgs_f, axis=1)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        got[:, ts.MSGS_P99].numpy(),
        np.asarray(jnp.percentile(msgs_f, 99, axis=1)), rtol=1e-6)
    assert np.isnan(got[:, ts.HOPS_P50].numpy()).all()
    assert (got[:, ts.HOPS_COV].numpy() == 0).all()


def test_stats_into_reads_the_flags_as_they_are():
    """``_stats_into`` over a chunk of [S, N] bool states: the same
    [C, S, 7] statistics as the int32 rows of ones it used to build."""
    c, s, n = 4, 3, 777
    got = torch.empty((c, s, len(ts.STATS)), dtype=torch.float32)
    want = torch.empty_like(got)
    for t in range(c):
        infected, msgs = _flags_and_msgs(10 + t, s, n, 0.3 + 0.2 * t)
        inf, m = torch.from_numpy(infected), torch.from_numpy(msgs)
        tc._stats_into(inf, m, got[t])
        ts.tick_stats(inf.to(torch.int32).reshape(-1, 1),
                      torch.ones(1, dtype=torch.int32), m.reshape(-1), None,
                      s, out=want[t])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("rows,target,msg", [
    (torch.zeros(12, dtype=torch.bool), torch.ones(1, dtype=torch.int32),
     "byte rows take no target"),
    (torch.zeros(10, dtype=torch.uint8), None, "byte rows take no target"),
    (torch.zeros((12, 2), dtype=torch.int32), None, "R-cell target"),
])
def test_row_forms_are_checked(rows, target, msg):
    with pytest.raises(ValueError, match=msg):
        ts.tick_stats(rows, target, torch.zeros(12, dtype=torch.int32),
                      None, 3)


@pytest.mark.parametrize("s,n,sms", [
    *((s, n, H100_SMS) for s, n in MAIN_SHAPES),
    (1, 1, 132), (1, 4095, 132), (1, 4097, 132), (3, 100_003, 132),
    (600, 1000, 132), (7, 12_345_679, 8), (2, 8193, 1), (33, 50_000, 132),
])
def test_stats_plan_covers_every_row_once(s, n, sms):
    blocks, chunk = ts.stats_plan(s, n, sms)
    assert blocks >= 1 and chunk >= 1
    covered = np.zeros(n, np.int64)
    for b in range(blocks):
        lo, hi = b * chunk, min(n, (b + 1) * chunk)
        assert lo < hi, f"block {b} of {blocks} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert s * blocks <= max(s, ts.BLOCKS_PER_SM * sms)


@pytest.mark.parametrize("s,n", MAIN_SHAPES)
def test_main_shapes_split_every_universe(s, n):
    blocks, _ = ts.stats_plan(s, n, H100_SMS)
    assert blocks > 1
    assert s * blocks >= H100_SMS  # every SM gets a block
