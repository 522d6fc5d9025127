"""Epidemic broadcast fanout (port of
``corrosion_tpu/models/broadcast.py``).

A node holding a changeset transmits it to a random sample of peers —
its ring0 (lowest-RTT) block first, then the whole universe — and
retransmits on later rounds until its budget is spent; nodes that
learn something new rebroadcast with a fresh budget.

Delivery is receiver-side permutation fanout: each fanout column is a
random within-block permutation, so every receiver hears from the
unique sender that picked it.  ``_perm_senders`` draws the
receiver→sender map of a column: raw threefry bits, whose top 23 bits
are the reference's uniform scores, sorted within segments by the
stable ``seg_argsort`` kernel (``jnp.argsort`` is stable); the
``deliver_perm`` kernel runs the K gathers, validity masks, merge and
epilogue in one pass.

The exact sender-side sampler (``sent``: the agents' per-payload
``sent_to`` exclusion, calibration scale) runs through the
``sent_select`` / ``sent_commit`` kernels instead, both from one
``sent_tick`` call, for S universes of N nodes at once
(``deliver_sent``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from corrosion_tpu_torch.kernels.deliver import (  # noqa: F401 - HOP_UNSET
    HOP_UNSET,
    deliver_perm,
)
from corrosion_tpu_torch.kernels.seg_sort import seg_argsort
from corrosion_tpu_torch.kernels.sent_sampler import key_tensor, sent_tick
from corrosion_tpu_torch.models.common import severance_matrix
from corrosion_tpu_torch.random import bits, fold_in, randint, split, uniform


@dataclass(frozen=True)
class BroadcastParams:
    n_nodes: int
    fanout_ring0: int = 2  # sends/tick into the ring0 block
    fanout_global: int = 2  # sends/tick into the whole universe
    ring0_size: int = 256  # ring0 block width (RTT<6ms tier stand-in)
    max_transmissions: int = 8  # retransmit decay budget per payload
    loss: float = 0.0  # per-message drop probability
    # the nth retransmission waits backoff_ticks*n after the previous
    # send; 0 = send every tick (synchronous rounds)
    backoff_ticks: float = 0.0
    # seed-flattening: n_nodes is S side-by-side universes of this
    # width and peer draws stay inside the sender's own universe
    universe: Optional[int] = None
    # one-way partitions: exactly these directed (src_block, dst_block)
    # pairs sever while the partition is active; None = symmetric
    oneway_blocks: Optional[tuple] = None
    # scenario families: "uniform", "het_ring" (RTT tier 1 +
    # local*rtt_tiers//u scales the retransmit gap and first forward),
    # "wan_two_region" (an extra wan_cross_loss drop on gossip crossing
    # regions), "measured_ring" (het_ring with tiers from measured
    # per-tier node-count weights)
    topology: str = "uniform"
    rtt_tiers: int = 4
    wan_blocks: int = 2
    wan_cross_loss: float = 0.25
    rtt_tier_weights: Optional[tuple] = None

    @property
    def fanout(self) -> int:
        return self.fanout_ring0 + self.fanout_global


def measured_tier_map(n: int, weights) -> np.ndarray:
    """[n] int32 tier map (1..len(weights)) from measured per-tier
    node-count weights: tier t covers the next ``round(n *
    weights[t-1] / sum)`` ids of the ring."""
    w = np.asarray(weights, np.float64)
    if w.ndim != 1 or w.size < 1 or (w < 0).any() or w.sum() <= 0:
        raise ValueError(
            "measured tier weights must be a non-empty 1-D sequence "
            "of non-negative values with a positive sum"
        )
    bounds = np.ceil(np.cumsum(w) / w.sum() * n).astype(np.int64)
    bounds[-1] = n  # guard the float tail: the last tier always closes
    tiers = 1 + np.searchsorted(bounds, np.arange(n), side="right")
    return tiers.astype(np.int32)


def _local_ids(params: BroadcastParams, device) -> torch.Tensor:
    u = params.universe or params.n_nodes
    return torch.arange(params.n_nodes, dtype=torch.int32, device=device) % u


def _rtt_tier(params: BroadcastParams, device) -> Optional[torch.Tensor]:
    """[N] int32 RTT tier (universe-local) of the het_ring or
    measured_ring topology, or None on other topologies."""
    if params.topology == "measured_ring":
        u = params.universe or params.n_nodes
        per_u = torch.from_numpy(
            measured_tier_map(u, params.rtt_tier_weights)
        ).to(device)
        reps = -(-params.n_nodes // u)
        return per_u.repeat(reps)[: params.n_nodes]
    if params.topology != "het_ring":
        return None
    u = params.universe or params.n_nodes
    return 1 + (_local_ids(params, device) * params.rtt_tiers) // u


def _wan_region(params: BroadcastParams, device) -> Optional[torch.Tensor]:
    """[N] int32 wan_two_region region id (universe-local), else None."""
    if params.topology != "wan_two_region" or params.wan_cross_loss <= 0.0:
        return None
    u = params.universe or params.n_nodes
    return (_local_ids(params, device) * params.wan_blocks) // u


class BroadcastStep(NamedTuple):
    """Result of :func:`broadcast_step`; optional outputs are None when
    the corresponding input wasn't supplied."""

    rows: torch.Tensor
    tx_remaining: torch.Tensor
    msgs_sent: torch.Tensor
    hops: Optional[torch.Tensor] = None
    next_send: Optional[torch.Tensor] = None
    sent: Optional[torch.Tensor] = None


def _largest_divisor_upto(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    cap = max(1, min(cap, n))
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def _perm_senders(key_t, j: int, n: int, u: int, ring0: bool,
                  ring0_size: int, device="cuda") -> torch.Tensor:
    """[N] int32 receiver->sender map for fanout column ``j``.

    Global columns: inverse of a uniform random permutation within each
    width-``u`` universe (one stable sort of uniform scores per
    universe: ``uniform`` is ``(bits >> 9) * 2**-23``, one-to-one and
    monotone, so the stable ``seg_argsort`` of the 23-bit ``bits >> 9``
    is the reference's ``jnp.argsort(uniform)``).  Ring0 columns:
    permutation within aligned blocks of b0 | u nodes, b0 the largest
    divisor of u <= ring0_size; when u has no useful divisor, a
    receiver-side sliding-window draw ``sender = t - off``, off in
    [1, min(ring0_size, u-1)]."""
    kj = fold_in(key_t, j)
    if ring0:
        b0 = _largest_divisor_upto(u, ring0_size)
        if b0 < 2 or b0 < min(ring0_size, u - 1) // 4:
            hi = min(ring0_size, u - 1) if u > 1 else 1
            offs = randint(kj, (n,), 1, hi + 1, device=device)
            idx = torch.arange(n, dtype=torch.int32, device=device)
            local = idx % u
            return idx - local + (local - offs) % u
        block = b0
    else:
        block = u
    # the sort's flat indices are the senders: segment * block + local
    raw = bits(kj, (n // block, block), device=device)
    return seg_argsort(raw, key_bits=23, shift=9).reshape(-1)


def _deliver_perm(rows, tx_remaining, msgs_sent, hops, tick, next_send,
                  key_t, key_l, params: BroadcastParams, partition_id,
                  partition_active):
    """Permutation-fanout delivery and the broadcast epilogue: draws
    the column maps and the loss / WAN uniforms, then runs the
    ``deliver_perm`` kernel (its plain version on the CPU)."""
    n, k = params.n_nodes, params.fanout
    u = params.universe or n
    device = rows.device
    senders = torch.stack([
        _perm_senders(key_t, j, n, u, j < params.fanout_ring0,
                      params.ring0_size, device=device)
        for j in range(k)
    ])
    loss_u = uniform(key_l, (n, k), device) if params.loss > 0.0 else None
    region = _wan_region(params, device)
    wan_u = None
    if region is not None:
        # wan-only extra draw: other configs' streams stay byte-equal
        wan_u = uniform(fold_in(key_l, 1), (n, k), device)
    part = None
    if partition_id is not None:
        part = partition_id.to(torch.int32)
    sev = None
    if params.oneway_blocks:
        sev = severance_matrix(params.oneway_blocks, device=device)
    return deliver_perm(
        rows, tx_remaining, msgs_sent, senders, hops=hops,
        next_send=next_send, tick=tick if tick is not None else 0,
        loss_u=loss_u, wan_u=wan_u, region=region, partition_id=part,
        sev=sev, partition_active=bool(partition_active),
        tier=_rtt_tier(params, device), loss=params.loss,
        wan_loss=params.wan_cross_loss, max_tx=params.max_transmissions,
        backoff=params.backoff_ticks,
    )


def sent_inputs(rows, tx_remaining, msgs_sent, hops, tick, next_send, sent,
                keys, params: BroadcastParams, partition_id=None,
                partition_active=False):
    """(select, commit): the keyword arguments of a tick's
    ``sent_select`` call and of its ``sent_commit`` call (less the
    selection's outputs; together those of its ``sent_tick`` call), for
    S universes of N nodes (``params.n_nodes`` = N): every leaf [S, N, ...], ``sent`` [S, N, N] bool, ``keys`` S
    host pairs ``(key_t, key_l)`` (each universe's ``split`` of its
    broadcast key), ``partition_id`` [N] int32 or None."""
    n = params.n_nodes
    device = rows.device
    sev = None
    if params.oneway_blocks:
        sev = severance_matrix(params.oneway_blocks, device=device)
    tick = 0 if tick is None else int(tick)
    select = dict(
        sent=sent, keys=key_tensor([[t] for t, _ in keys], device),
        fanout=params.fanout, chunk=n, tx=tx_remaining, next_send=next_send,
        tick=tick, rows=rows, hops=hops,
        # loss uniforms under key_l; the WAN drop under fold_in(key_l, 1)
        loss_keys=key_tensor([[l, fold_in(l, 1)] for _, l in keys],
                              device),
        loss=params.loss, wan_loss=params.wan_cross_loss,
        region=_wan_region(params, device),
        partition_id=(None if partition_id is None
                      else partition_id.to(torch.int32)),
        sev=sev, partition_active=bool(partition_active))
    commit = dict(
        tx=tx_remaining, msgs=msgs_sent, tick=tick,
        max_tx=params.max_transmissions, backoff=params.backoff_ticks,
        next_send=next_send, rows=rows, hops=hops,
        tier=_rtt_tier(params, device))
    return select, commit


def deliver_sent(rows, tx_remaining, msgs_sent, hops, tick, next_send, sent,
                 keys, params: BroadcastParams, partition_id=None,
                 partition_active=False):
    """The exact ``sent_to`` sampler's delivery and epilogue for S
    universes (arguments as :func:`sent_inputs`): each active sender
    sends to the ``fanout`` peers of lowest uniform score it has not
    sent to yet (``sent_select``; ``sent`` is marked in place), then
    ``sent_commit`` runs the epilogue, both from one ``sent_tick`` call.
    Returns (rows, tx, msgs, hops, next_send) as fresh tensors."""
    select, commit = sent_inputs(rows, tx_remaining, msgs_sent, hops, tick,
                                 next_send, sent, keys, params, partition_id,
                                 partition_active)
    new_rows, _, _, tx, msgs, new_hops, nxt = sent_tick(**{**select,
                                                           **commit})
    return new_rows, tx, msgs, new_hops, nxt


def broadcast_step(rows, tx_remaining, msgs_sent, key,
                   params: BroadcastParams, partition_id=None,
                   partition_active=False, hops=None, tick=None,
                   next_send=None, sent=None) -> BroadcastStep:
    """One gossip tick for every node at once.

    rows:         [N, R] int32 packed CRDT keys (int64 with ``sent``
                  for a wide codec)
    tx_remaining: [N] int32 remaining transmissions (0 = quiescent)
    msgs_sent:    [N] int32 cumulative sent-message counter
    key:          uint32[2] PRNG key for this tick
    partition_id: [N] int32 block ids; messages crossing blocks are
                  dropped while ``partition_active`` (a host bool)
    hops:         optional [N] int32 infection-tree depth (HOP_UNSET =
                  not infected)
    tick:         host int, needed with ``next_send``
    next_send:    optional [N] int32 earliest tick of the next send
    sent:         optional [N, N] bool per-payload transmission memory
                  (the agents' ``sent_to``): draws become uniform
                  without replacement over the peers not sent to yet,
                  the ring0/global split is ignored, the marks are set
                  on send (before loss) and each send is charged.
                  Marked IN PLACE; the result's ``sent`` is the same
                  tensor.  Calibration scale only: incompatible with
                  seed-flattened universes.

    Runs on the device of ``rows``."""
    if next_send is not None and tick is None:
        raise ValueError("next_send requires tick")
    key_t, key_l = split(key)
    if sent is not None:
        if params.universe is not None:
            raise ValueError(
                "sent-tracking ([N, N] memory) is calibration-scale "
                "only and incompatible with seed-flattened universes"
            )

        def one(x):
            return None if x is None else x[None]

        out = deliver_sent(
            rows[None], tx_remaining[None], msgs_sent[None], one(hops), tick,
            one(next_send), sent[None], [(key_t, key_l)], params,
            partition_id, partition_active)
        return BroadcastStep(*(None if x is None else x[0] for x in out),
                             sent=sent)
    out = _deliver_perm(rows, tx_remaining, msgs_sent, hops, tick,
                        next_send, key_t, key_l, params, partition_id,
                        partition_active)
    return BroadcastStep(*out)
