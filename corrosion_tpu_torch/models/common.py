"""Shared topology primitives for the protocol models (port of
``corrosion_tpu/models/common.py``).

Seed-flattening: multi-universe simulations place their S independent
universes side by side in ONE flat index space of ``S * n`` nodes.
``universe`` below is the universe (block) width: peer draws stay
inside the caller's own universe, which keeps the universes
statistically independent while every gather in the tick runs at full
width.
"""

from __future__ import annotations

from typing import Optional

import torch

from corrosion_tpu_torch.random import randint


def universe_width(n: int, universe: Optional[int]) -> int:
    """The block width ``u`` of block-local arithmetic (``n`` when not
    seed-flattened); raises when ``universe`` does not divide ``n``
    (a partial trailing block would draw out-of-range peers)."""
    if universe is None:
        return n
    if n % universe:
        raise ValueError(f"universe {universe} must divide n_nodes {n}")
    return universe


def peers_from_offsets(offs: torch.Tensor, u: int) -> torch.Tensor:
    """[N, ...] peer ids ``base + (local + offs) % u`` of node i = row i
    (``local = i % u``, ``base = i - local``)."""
    n = offs.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=offs.device).reshape(
        (n,) + (1,) * (offs.dim() - 1)
    )
    local = rows % u
    return rows - local + (local + offs) % u


def rand_peers(key, n: int, shape, universe: Optional[int] = None,
               device="cuda") -> torch.Tensor:
    """Uniform random peers, never self.

    shape's leading dim must be n (one row per node); each entry is
    drawn as ``(local + offset) % u`` with offset in 1..u-1, where ``u``
    is the universe width (defaults to the whole cluster)."""
    u = universe_width(n, universe)
    offs = randint(key, shape, 1, max(u, 2), device=device)
    return peers_from_offsets(offs, u)


def severance_matrix(oneway, device) -> torch.Tensor:
    """Directed-severance lookup for one-way partitions: ``[B, B]`` bool
    on ``device`` where ``m[s, d]`` = traffic from block ``s`` to block
    ``d`` is cut.  Sized one past the largest listed block so clamped
    ids (blocks never named by a pair) land on an all-False pad
    row/column — unlisted directions always flow."""
    b = max(max(s, d) for s, d in oneway) + 2
    m = torch.zeros((b, b), dtype=torch.bool)
    for s, d in oneway:
        m[s, d] = True
    return m.to(device)


def blocks_cross(src, dst, sev=None, bidirectional: bool = False):
    """True where traffic from block ``src`` to block ``dst`` is cut by
    a partition in force: any pair of different blocks when ``sev`` is
    None (symmetric), else the listed directions of the ``[B, B]``
    severance matrix (block ids clamped to its all-False pad row);
    ``bidirectional`` cuts a link when either direction is listed."""
    if sev is None:
        return src != dst
    b = sev.shape[0]
    s = torch.clamp_max(src, b - 1).to(torch.int64)
    d = torch.clamp_max(dst, b - 1).to(torch.int64)
    cross = sev[s, d]
    if bidirectional:
        cross = cross | sev[d, s]
    return cross


def partition_ok(partition_id, senders_axis_targets, active,
                 oneway=None, bidirectional: bool = False):
    """True where a message does NOT cross an active partition boundary.

    partition_id: [N] block ids or None (no partition).
    senders_axis_targets: [N, ...] target indices (row i = sender i).
    active: bool (partition currently in force).
    oneway: tuple of directed ``(src_block, dst_block)`` pairs — exactly
            those directions sever; None/empty = symmetric.
    bidirectional: the link needs BOTH directions up (a sync session's
            bi-stream)."""
    if partition_id is None:
        return True
    targets = senders_axis_targets
    src = partition_id.to(torch.int32).reshape(
        (-1,) + (1,) * (targets.dim() - 1)
    )
    dst = partition_id.to(torch.int32)[targets.to(torch.int64)]
    sev = None
    if oneway:
        sev = severance_matrix(oneway, device=partition_id.device)
    return ~(blocks_cross(src, dst, sev, bidirectional) & bool(active))
