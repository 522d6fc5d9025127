"""``tick_stats``: per-universe convergence statistics of one tick
(csrc/tick_stats.cu).

Replaces the per-tick reductions of corrosion_tpu/sim/epidemic.py
``_scan_chunk`` (:272-309) and ``_scan_chunk_coverage`` (:351-359),
and the exact runners' chunk statistics (corrosion_tpu/sim/
calibrate.py:744, :1301).  Rows come as R int32 cells held against an
R-cell target, or as one byte a node (bool or uint8, no target), held
where nonzero: the exact runners' ``infected``, read as it is.

Bound on the H100: bytes — the rows and the msgs / hops series read
once.  Each universe is split over the blocks ``stats_plan`` gives it,
so every shape fills the card; their partials and histogram counts
meet in a scratch buffer (``_scratch``, one a device and stream) that
the kernel leaves all zero.  The kernel takes exact order statistics
from a histogram of value mod ``NBINS``, so no per-tick sort runs.  A
series that spans ``NBINS`` values or more gets +inf in place of its
percentiles, never a clipped rank; ``raise_on_overflow`` raises on it
where the runner fetches a chunk's statistics.

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
BLOCKS_PER_SM = 2  # blocks of 512 threads a launch puts on an SM
MIN_ROWS = 4096  # rows below which a universe takes no further block
# how a universe's last step is reached: one launch with a ticket, or a
# second launch under programmatic dependent launch (the kernel's
# `design` 0 and 1).  The ticket is faster at up to 16 blocks a
# universe, the second launch from 66 (chip_smoke.py phase 2 times
# both at the main path's shapes; PERF.md row 5).
DESIGNS = ("ticket", "dependent_launch")
TICKET_MAX_BLOCKS = 32

_ARGTYPES = (
    *(ctypes.c_void_p,) * 6, *(ctypes.c_int,) * 5, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
)
_SCRATCH: dict = {}


def stats_plan(s: int, n: int, sms: int) -> tuple:
    """(blocks, chunk): each of ``s`` universes of ``n`` rows split over
    ``blocks`` blocks of ``chunk`` rows, block b taking rows
    ``[b * chunk, min(n, (b + 1) * chunk))``: about ``BLOCKS_PER_SM``
    blocks an SM of ``sms`` in all, none below ``MIN_ROWS`` rows where a
    universe has more, none empty."""
    want = max(1, BLOCKS_PER_SM * sms // s)
    blocks = max(1, min(want, -(-n // MIN_ROWS)))
    chunk = -(-n // blocks)
    return -(-n // chunk), chunk


def _scratch(device, words: int) -> torch.Tensor:
    """The kernel's zeroed scratch of at least ``words`` int32 on
    ``device``'s current stream (kept between calls: the kernel leaves
    it zero)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _holds(rows, target, s: int, n: int):
    """[S] rows held: equal to ``target``, or nonzero in the byte
    form (``target`` None)."""
    if target is None:
        return (rows.reshape(s, n) != 0).sum(dim=1)
    return torch.all(rows.reshape(s, n, -1) == target, dim=2).sum(dim=1)


def tick_stats_plain(rows, target, msgs, hops, n_universes, out):
    """Plain PyTorch version of the kernel: sorts for the order
    statistics."""
    s = n_universes
    n = msgs.shape[0] // s
    # a full divisor tensor: PyTorch's CUDA division by a scalar
    # multiplies by its reciprocal, which can differ in the last bit
    nf = torch.full((s,), n, dtype=torch.float32, device=msgs.device)
    holds = _holds(rows, target, s, n)
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


BYTE_ROWS = (torch.bool, torch.uint8)


def _check_rows(rows, target, total: int) -> int:
    """R of int32 rows [total, R] against target [R], or 0 for byte
    rows of ``total`` elements (any shape) without a target."""
    if rows.dtype in BYTE_ROWS:
        if target is not None or rows.numel() != total:
            raise ValueError(f"tick_stats: byte rows take no target and "
                             f"hold one flag a node ({total})")
        return 0
    if rows.dim() != 2 or rows.shape[0] != total or target is None:
        raise ValueError("tick_stats: int32 rows must be [S*n, R] with an "
                         "R-cell target")
    return rows.shape[1]


def tick_stats(rows, target, msgs, hops, n_universes, out=None):
    """Statistics of every universe after a tick.

    rows [S*n, R] int32 with target [R] int32 (the converged row), or
    S*n bool / uint8 flags (any shape, e.g. [S, n]) with target None;
    msgs [S*n] int32, hops [S*n] int32 or None (untracked: NaN
    percentiles, hop coverage 0).  Writes and returns ``out`` ([S, 7]
    float32, allocated when None)."""
    s = n_universes
    total = msgs.shape[0]
    if s < 1 or total % s or msgs.shape != (total,):
        raise ValueError("tick_stats: rows / msgs must hold S equal "
                         "universes")
    r = _check_rows(rows, target, total)
    if out is None:
        out = torch.empty((s, len(STATS)), dtype=torch.float32,
                          device=rows.device)
    if kernels.on_cpu(rows, target, msgs, hops, out):
        return tick_stats_plain(rows, target, msgs, hops, s, out)
    if r > MAX_ROWS:
        raise ValueError(f"tick_stats: the kernel takes 1..{MAX_ROWS} cells "
                         f"per row, got {r}")
    i32 = torch.int32
    if r:
        kernels.check("tick_stats rows", rows, i32, (total, r),
                      align=16 if r % 4 == 0 else 4)
        kernels.check("tick_stats target", target, i32, (r,))
    else:
        kernels.check("tick_stats rows", rows, rows.dtype, align=1)
    kernels.check("tick_stats msgs", msgs, i32, (total,))
    if hops is not None:
        kernels.check("tick_stats hops", hops, i32, (total,))
    kernels.check("tick_stats out", out, torch.float32, (s, len(STATS)))
    return _launch(rows, target, msgs, hops, s, out)


def _launch(rows, target, msgs, hops, s: int, out, design=None):
    """The kernel on checked CUDA tensors; ``design`` (an index into
    ``DESIGNS``) None to choose by the blocks a universe takes."""
    n = msgs.shape[0] // s
    blocks, chunk = stats_plan(s, n, _sms(rows.device))
    if design is None:
        design = int(blocks > TICKET_MAX_BLOCKS)
    p = kernels.ptr
    words = kernels.function("tick_stats", "tick_stats_scratch_words", ())()
    scratch = _scratch(rows.device, s * words)
    fn = kernels.function("tick_stats", "tick_stats_launch", _ARGTYPES)
    code = fn(p(rows), p(target), p(msgs), p(hops), p(out), p(scratch), s, n,
              rows.shape[1] if target is not None else 0, blocks, chunk,
              Q99, Q50, design, kernels.stream(rows))
    tick_stats.launches += 1
    kernels.raise_on_error("tick_stats", code)
    return out


tick_stats.launches = 0
