"""``seq_sync`` and ``seq_stats``: one round of sequence-chunked
anti-entropy and the tick's per-universe statistics
(csrc/seq_sync.cu).

``seq_sync`` replaces corrosion_tpu/models/sync.py ``seq_sync_step``
(:166-212) with its ``session_msgs`` charge (:66) and the
``rand_peers`` draw (models/common.py :35); ``seq_stats`` replaces the
per-tick reductions of corrosion_tpu/sim/antientropy.py ``_scan_chunk``
(:77-82).  Bound on the H100: bytes — the own row, one random peer row
per draw, the written row and the [N] counters; the stats pass re-reads
the bitmap and msgs.  One thread a node holds its row as bit masks,
draws its peers and the per-chunk loss in registers, serves the needs
mask in ascending order, and charges the serving peer with an integer
``atomicAdd``.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.sync_pull import session_msgs
from corrosion_tpu_torch.kernels.threefry import threefry_bits_plain
from corrosion_tpu_torch.models.common import peers_from_offsets

MAX_SEQS = 128  # two 64-bit masks a node
MAX_BUDGET = 32  # a session's lost chunks as one 32-bit mask
STATS = ("converged", "msgs_mean")
CONVERGED, MSGS_MEAN = range(len(STATS))

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
)
_STATS_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def seq_sync_plain(bits, msgs, peer_keys, drop_key, u, span, mult, *,
                   peers_per_round, seqs_per_chunk, chunk_budget, loss,
                   handshake_msgs):
    """Plain PyTorch version of the kernel (same arguments and results
    as :func:`seq_sync`): the reference's gather, cumsum rank and
    per-chunk loss expansion."""
    n, _ = bits.shape
    p, spc, budget = peers_per_round, seqs_per_chunk, chunk_budget
    offs = torch.empty((n, p), dtype=torch.int32, device=bits.device)
    threefry_bits_plain(offs, peer_keys[0], peer_keys[1], span=span,
                        mult=mult, minval=1)
    peers = peers_from_offsets(offs, u).to(torch.int64)  # [N, P]
    needs = bits[peers] & ~bits[:, None, :]  # [N, P, S]
    order = torch.cumsum(needs.to(torch.int32), dim=2)  # 1-based rank
    served = needs & (order <= budget * spc)
    chunk_of = torch.clamp((order - 1) // spc, 0, budget - 1)
    drop_u = torch.empty((n, p, budget), dtype=torch.float32,
                         device=bits.device)
    threefry_bits_plain(drop_u, drop_key)
    dropped = drop_u < loss
    arrived = served & ~dropped.gather(2, chunk_of.to(torch.int64))
    new_bits = bits | arrived.any(dim=1)
    chunks = -(-served.sum(dim=2) // spc)
    return new_bits, session_msgs(msgs, peers, chunks, handshake_msgs)


def seq_sync(bits, msgs, peer_keys, drop_key, u, span, mult, *,
             peers_per_round, seqs_per_chunk, chunk_budget, loss,
             handshake_msgs):
    """Every node pulls from its P peers ``base + (local + offset) % u``
    (offsets ``randint(1, u)`` under ``peer_keys``, the two words of
    ``split(k_peers)``; ``span``/``mult`` from ``randint_span``), takes
    the first ``chunk_budget * seqs_per_chunk`` seqs it needs in
    ascending order, and loses chunk b of session (i, q) where the
    uniform under ``drop_key`` at ``(i * P + q) * budget + b`` is below
    ``loss``.

    bits [N, S] bool, msgs [N] int32.  Returns (bits, msgs) as new
    tensors."""
    kw = dict(peers_per_round=peers_per_round, seqs_per_chunk=seqs_per_chunk,
              chunk_budget=chunk_budget, loss=loss,
              handshake_msgs=handshake_msgs)
    if kernels.on_cpu(bits, msgs):
        return seq_sync_plain(bits, msgs, peer_keys, drop_key, u, span, mult,
                              **kw)
    n, s = bits.shape
    p = peers_per_round
    if not (1 <= s <= MAX_SEQS and p >= 1
            and 1 <= chunk_budget <= MAX_BUDGET and seqs_per_chunk >= 1):
        raise ValueError(
            f"seq_sync: the kernel takes 1..{MAX_SEQS} seqs, a peer or more "
            f"and a budget of 1..{MAX_BUDGET} chunks, got S={s}, P={p}, "
            f"budget={chunk_budget}")
    if not 1 <= u <= n or n % u:
        raise ValueError("seq_sync: the universe width must divide N")
    kernels.check("seq_sync bits", bits, torch.bool, (n, s), align=1)
    kernels.check("seq_sync msgs", msgs, torch.int32, (n,))
    bits_out = torch.empty_like(bits)
    msgs_out = msgs.clone()
    fn = kernels.function("seq_sync", "seq_sync_launch", _ARGTYPES)
    (ph0, ph1), (pl0, pl1) = peer_keys
    code = fn(kernels.ptr(bits), kernels.ptr(bits_out), kernels.ptr(msgs_out),
              n, s, p, u, ph0, ph1, pl0, pl1, span, mult, drop_key[0],
              drop_key[1], seqs_per_chunk, chunk_budget, loss,
              handshake_msgs, kernels.stream(bits))
    seq_sync.launches += 1
    kernels.raise_on_error("seq_sync", code)
    return bits_out, msgs_out


seq_sync.launches = 0


def seq_stats_plain(bits, msgs, n_universes, out):
    """Plain PyTorch version of :func:`seq_stats`."""
    s = n_universes
    n = msgs.shape[0] // s
    # a full divisor tensor: PyTorch's CUDA division by a scalar
    # multiplies by its reciprocal, which can differ in the last bit
    nf = torch.full((s,), n, dtype=torch.float32, device=msgs.device)
    out[:, CONVERGED] = bits.reshape(s, -1).all(dim=1).to(torch.float32)
    msum = msgs.reshape(s, n).sum(dim=1, dtype=torch.int64)
    out[:, MSGS_MEAN] = msum.to(torch.float32) / nf
    return out


def seq_stats(bits, msgs, n_universes, out=None):
    """Per universe after a tick: 1.0 where every node holds every seq
    (else 0.0) and the float32 mean of msgs (exact int64 sum over n,
    rounded once, divided by n).

    bits [S*n, seqs] bool, msgs [S*n] int32.  Writes and returns ``out``
    ([S, 2] float32, columns ``STATS``; allocated when None)."""
    s = n_universes
    total, seqs = bits.shape
    if s < 1 or total % s or msgs.shape != (total,):
        raise ValueError("seq_stats: bits / msgs must hold S equal "
                         "universes")
    if out is None:
        out = torch.empty((s, len(STATS)), dtype=torch.float32,
                          device=bits.device)
    if kernels.on_cpu(bits, msgs, out):
        return seq_stats_plain(bits, msgs, s, out)
    kernels.check("seq_stats bits", bits, torch.bool, (total, seqs), align=1)
    kernels.check("seq_stats msgs", msgs, torch.int32, (total,))
    kernels.check("seq_stats out", out, torch.float32, (s, len(STATS)))
    fn = kernels.function("seq_sync", "seq_stats_launch", _STATS_ARGTYPES)
    code = fn(kernels.ptr(bits), kernels.ptr(msgs), kernels.ptr(out), s,
              total // s, seqs, kernels.stream(bits))
    seq_stats.launches += 1
    kernels.raise_on_error("seq_stats", code)
    return out


seq_stats.launches = 0
