"""``tick_stats``: per-universe convergence statistics of one tick
(csrc/tick_stats.cu).

Replaces the per-tick reductions of corrosion_tpu/sim/epidemic.py
``_scan_chunk`` (:272-309) and ``_scan_chunk_coverage`` (:351-359).
Bound on the H100: bytes — the rows and the msgs / hops series read
once.  The kernel takes exact order statistics from a shared-memory
histogram of ``NBINS`` bins, so no per-tick sort runs.  A series that
spans ``NBINS`` values or more gets +inf in place of its percentiles,
never a clipped rank; ``raise_on_overflow`` raises on it where the
runner fetches a chunk's statistics.

Output ``[S, 7]`` float32, one row per universe, columns ``STATS``.
The mean is the exact integer sum rounded to float32 and divided by n:
equal to the reference's float32 mean while the sum stays below 2**24,
within float32 rounding above it.  Percentiles follow
``jnp.percentile``'s linear rule in float32; hop depths at or above
``HOP_UNSET - 1`` count as NaN, as the reference maps them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.deliver import HOP_UNSET, MAX_ROWS

STATS = ("converged", "coverage", "msgs_mean", "msgs_p99", "hops_p50",
         "hops_p99", "hops_cov")
CONVERGED, COVERAGE, MSGS_MEAN, MSGS_P99, HOPS_P50, HOPS_P99, HOPS_COV = (
    range(len(STATS))
)
# the quantiles exactly as jnp.percentile forms them: float32(q) / 100
Q99 = float(np.float32(99) / np.float32(100))
Q50 = float(np.float32(50) / np.float32(100))
NBINS = 4096  # the kernel's histogram bins (csrc/tick_stats.cu)

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
)


def _percentile(sorted_vals, count, q: float):
    """Linear-rule quantile q of the first ``count`` values of each
    sorted row, in float32 as jnp.percentile computes it (NaN when
    ``count`` is 0)."""
    cf = count.to(torch.float32)
    last = cf - 1
    pos = torch.tensor(q, dtype=torch.float32) * last
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    lw = 1 - hw
    zero = torch.zeros_like(last)
    klo = torch.maximum(zero, torch.minimum(lo, last)).to(torch.int64)
    khi = torch.maximum(zero, torch.minimum(hi, last)).to(torch.int64)
    vlo = sorted_vals.gather(1, klo[:, None])[:, 0].to(torch.float32)
    vhi = sorted_vals.gather(1, khi[:, None])[:, 0].to(torch.float32)
    res = vlo * lw + vhi * hw
    return torch.where(count > 0, res, torch.full_like(res, float("nan")))


def raise_on_overflow(stats: np.ndarray) -> None:
    """Raise where the kernel flagged a series too wide for its bins
    (+inf percentiles in fetched ``[..., len(STATS)]`` statistics)."""
    if np.isposinf(stats).any():
        raise ValueError(
            f"tick_stats: a universe's msgs or hop depths span {NBINS} "
            "values or more, past the kernel's histogram")


def tick_stats_plain(rows, target, msgs, hops, n_universes, out):
    """Plain PyTorch version of the kernel: sorts for the order
    statistics."""
    s = n_universes
    n = msgs.shape[0] // s
    # a full divisor tensor: PyTorch's CUDA division by a scalar
    # multiplies by its reciprocal, which can differ in the last bit
    nf = torch.full((s,), n, dtype=torch.float32, device=msgs.device)
    holds = torch.all(rows.reshape(s, n, -1) == target, dim=2).sum(dim=1)
    out[:, CONVERGED] = (holds == n).to(torch.float32)
    out[:, COVERAGE] = holds.to(torch.float32) / nf
    m = msgs.reshape(s, n)
    msum = m.sum(dim=1, dtype=torch.int64)
    out[:, MSGS_MEAN] = msum.to(torch.float32) / nf
    full = torch.full((s,), n, dtype=torch.int64, device=msgs.device)
    out[:, MSGS_P99] = _percentile(torch.sort(m, dim=1).values, full, Q99)
    if hops is None:
        out[:, HOPS_P50] = float("nan")
        out[:, HOPS_P99] = float("nan")
        out[:, HOPS_COV] = 0.0
        return out
    h = hops.reshape(s, n)
    valid = h < HOP_UNSET - 1
    cnt = valid.sum(dim=1)
    # unmeasured depths sort past every measured one
    hs = torch.sort(torch.where(valid, h, torch.iinfo(torch.int32).max),
                    dim=1).values
    out[:, HOPS_P50] = _percentile(hs, cnt, Q50)
    out[:, HOPS_P99] = _percentile(hs, cnt, Q99)
    out[:, HOPS_COV] = cnt.to(torch.float32) / nf
    return out


def tick_stats(rows, target, msgs, hops, n_universes, out=None):
    """Statistics of every universe after a tick.

    rows [S*n, R] int32, target [R] int32 (the converged row), msgs
    [S*n] int32, hops [S*n] int32 or None (untracked: NaN percentiles,
    hop coverage 0).  Writes and returns ``out`` ([S, 7] float32,
    allocated when None)."""
    s = n_universes
    total, r = rows.shape
    if s < 1 or total % s or msgs.shape != (total,):
        raise ValueError("tick_stats: rows / msgs must hold S equal "
                         "universes")
    if out is None:
        out = torch.empty((s, len(STATS)), dtype=torch.float32,
                          device=rows.device)
    if kernels.on_cpu(rows, target, msgs, hops, out):
        return tick_stats_plain(rows, target, msgs, hops, s, out)
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"tick_stats: the kernel takes 1..{MAX_ROWS} cells "
                         f"per row, got {r}")
    i32 = torch.int32
    kernels.check("tick_stats rows", rows, i32, (total, r))
    kernels.check("tick_stats target", target, i32, (r,))
    kernels.check("tick_stats msgs", msgs, i32, (total,))
    if hops is not None:
        kernels.check("tick_stats hops", hops, i32, (total,))
    kernels.check("tick_stats out", out, torch.float32, (s, len(STATS)))
    p = kernels.ptr
    fn = kernels.function("tick_stats", "tick_stats_launch", _ARGTYPES)
    code = fn(p(rows), p(target), p(msgs), p(hops), p(out), s, total // s,
              r, Q99, Q50, kernels.stream(rows))
    tick_stats.launches += 1
    kernels.raise_on_error("tick_stats", code)
    return out


tick_stats.launches = 0
