"""Epidemic broadcast + anti-entropy convergence simulation (port of
``corrosion_tpu/sim/epidemic.py``).

A writer commits one changeset; gossip fanout with retransmit decay
spreads it; periodic anti-entropy heals what loss and partitions
dropped; a universe converges when every node's CRDT row state equals
the writer's.  The measured quantities are the north-star metrics:
ticks (protocol rounds) to convergence and messages per node.

One tick is a short sequence of kernels (threefry draws, a stable sort
per fanout column, ``deliver_perm``, ``sync_pull`` on the sync cadence,
``tick_stats``).  The reference's ``lax.scan`` over a chunk becomes a
Python loop over ticks with the tick counter on the host, so the sync
cadence is a plain ``if``; per-tick statistics stay on the device and
come back to the host once per chunk, where the runner checks
convergence.  The S seeds are laid side by side in one flat index
space (seed-flattening), as in the reference.

``track_sent`` (the agents' exact ``sent_to`` sampler, [N, N] bool
memory per universe) takes the reference's vmapped path instead: every
leaf gains a leading seed axis, each seed is one universe of N nodes
with its own key, and one ``sent_select`` / ``sent_commit`` launch
serves all seeds (``_run_epidemic_seeds_sent``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.kernels.tick_stats import (
    CONVERGED,
    COVERAGE,
    HOPS_COV,
    HOPS_P50,
    HOPS_P99,
    MSGS_MEAN,
    MSGS_P99,
    STATS,
    raise_on_overflow,
    tick_stats,
)
from corrosion_tpu_torch.kernels.sync_pull import sync_pull
from corrosion_tpu_torch.models.broadcast import (
    HOP_UNSET,
    BroadcastParams,
    broadcast_step,
    deliver_sent,
)
from corrosion_tpu_torch.models.common import severance_matrix
from corrosion_tpu_torch.models.sync import SyncParams, sync_step
from corrosion_tpu_torch.ops.keys import DEFAULT_CODEC
from corrosion_tpu_torch.random import PRNGKey, fold_in, randint, split


@dataclass(frozen=True)
class EpidemicConfig:
    n_nodes: int
    n_rows: int = 8  # CRDT cells carried by the changeset
    fanout_ring0: int = 2
    fanout_global: int = 2
    ring0_size: int = 256
    max_transmissions: int = 8
    loss: float = 0.0
    # partition: nodes are split into `partition_blocks` blocks whose
    # cross-traffic is dropped until `heal_tick`
    partition_blocks: int = 1
    heal_tick: int = 0
    # one-way partitions: exactly these directed (src_block, dst_block)
    # pairs sever while the partition is active; None = symmetric
    oneway_blocks: Optional[tuple] = None
    # nth retransmission waits backoff_ticks*n; 0 = send every tick
    backoff_ticks: float = 0.0
    # model the agents' per-payload sent_to exclusion exactly ([N, N]
    # bool memory per universe: calibration scale only)
    track_sent: bool = False
    # infection-depth (hop) tracking
    track_hops: bool = True
    # anti-entropy cadence (0 = disabled)
    sync_interval: int = 8
    sync_peers: int = 1
    cells_per_chunk: int = 64
    max_ticks: int = 256
    chunk_ticks: int = 16  # ticks between host convergence checks
    # seed-flattening: S universes of n_nodes side by side in one flat
    # index space; None = single universe
    n_universes: Optional[int] = None
    # scenario families (models/broadcast.py BroadcastParams)
    topology: str = "uniform"
    rtt_tiers: int = 4
    wan_blocks: int = 2
    wan_cross_loss: float = 0.25
    rtt_tier_weights: Optional[tuple] = None

    def __post_init__(self):
        if self.topology not in (
            "uniform", "het_ring", "wan_two_region", "measured_ring"
        ):
            raise ValueError(f"unknown topology {self.topology!r}")
        if self.topology == "het_ring" and self.rtt_tiers < 1:
            raise ValueError("het_ring needs rtt_tiers >= 1")
        if self.topology == "wan_two_region" and self.wan_blocks < 2:
            raise ValueError("wan_two_region needs wan_blocks >= 2")
        if self.topology == "measured_ring":
            w = self.rtt_tier_weights
            if not w or any(x < 0 for x in w) or sum(w) <= 0:
                raise ValueError(
                    "measured_ring needs rtt_tier_weights: non-empty, "
                    "non-negative, positive sum (corro admin rtt dump)"
                )

    @property
    def flat_nodes(self) -> int:
        return self.n_nodes * (self.n_universes or 1)

    @property
    def _universe(self) -> Optional[int]:
        return self.n_nodes if self.n_universes else None

    @property
    def broadcast_params(self) -> BroadcastParams:
        return BroadcastParams(
            n_nodes=self.flat_nodes,
            fanout_ring0=self.fanout_ring0,
            fanout_global=self.fanout_global,
            ring0_size=min(self.ring0_size, self.n_nodes),
            max_transmissions=self.max_transmissions,
            loss=self.loss,
            backoff_ticks=self.backoff_ticks,
            universe=self._universe,
            oneway_blocks=self.oneway_blocks,
            topology=self.topology,
            rtt_tiers=self.rtt_tiers,
            wan_blocks=self.wan_blocks,
            wan_cross_loss=self.wan_cross_loss,
            rtt_tier_weights=self.rtt_tier_weights,
        )

    @property
    def sync_params(self) -> SyncParams:
        return SyncParams(
            n_nodes=self.flat_nodes,
            peers_per_round=self.sync_peers,
            cells_per_chunk=self.cells_per_chunk,
            universe=self._universe,
            oneway_blocks=self.oneway_blocks,
        )


# BASELINE config #5, the system's headline: 100k nodes, 5% loss, two
# partition blocks healing at tick 12 (bench.py ``_headline_cfg`` with
# its default --rows 8; run with 32 seeds)
HEADLINE = EpidemicConfig(
    n_nodes=100_000, n_rows=8, fanout_ring0=2, fanout_global=2,
    ring0_size=256, max_transmissions=8, loss=0.05, partition_blocks=2,
    heal_tick=12, sync_interval=8, sync_peers=1, max_ticks=192,
    chunk_ticks=16,
)
HEADLINE_SEEDS = 32


def sent_trace_cfg(n: int, sync_interval: int = 0,
                   chunk_ticks: int = 8) -> EpidemicConfig:
    """The ``track_sent`` config the sim-vs-agents comparisons run:
    corrosion_tpu/sim/simdiff.py ``sim_trace`` (:68-84; its ``sync``
    is ``sync_interval=8``), and with ``sync_interval=8,
    chunk_ticks=16`` sim/obs.py ``sim_obs_trace`` (:53-67).  Uniform
    sampling without a ring0 tier, fanout 3, 5 transmissions, no loss,
    the agents' backoff ratio of 2.5 ticks; run with 8 seeds."""
    return EpidemicConfig(
        n_nodes=n, n_rows=4, fanout_ring0=0, fanout_global=3, ring0_size=1,
        max_transmissions=5, loss=0.0, backoff_ticks=2.5, track_sent=True,
        sync_interval=sync_interval, sync_peers=1, max_ticks=256,
        chunk_ticks=chunk_ticks,
    )


class EpidemicState(NamedTuple):
    rows: torch.Tensor  # [N, R] int32 packed CRDT keys
    tx_remaining: torch.Tensor  # [N] int32
    msgs: torch.Tensor  # [N] int32
    tick: int  # host counter
    # [N] int32 infection depth (HOP_UNSET = not yet); None when
    # cfg.track_hops is off
    hops: Optional[torch.Tensor]
    next_send: torch.Tensor  # [N] int32 earliest tick of the next send
    # [N, N] bool sent_to memory when cfg.track_sent, else None
    sent: Optional[torch.Tensor] = None


def epidemic_init(cfg: EpidemicConfig, writer: int = 0,
                  device="cuda") -> EpidemicState:
    """All nodes at the base state; each universe's writer holds one
    committed changeset (col_version 2) ready to broadcast."""
    device = resolve_device(device)
    codec = DEFAULT_CODEC
    n, r = cfg.flat_nodes, cfg.n_rows
    i32 = dict(dtype=torch.int32, device=device)
    rows = codec.pack(torch.ones((n, r), **i32), torch.ones((n, r), **i32),
                      torch.zeros((n, r), **i32))
    news = codec.pack(torch.ones((r,), **i32), torch.full((r,), 2, **i32),
                      torch.ones((r,), **i32))
    # one writer per universe at the same local offset
    writers = (writer + torch.arange(cfg.n_universes or 1, device=device)
               * cfg.n_nodes)
    rows[writers] = news
    tx = torch.zeros((n,), **i32)
    tx[writers] = cfg.max_transmissions
    hops = None
    if cfg.track_hops:
        hops = torch.full((n,), HOP_UNSET, **i32)
        hops[writers] = 0
    sent = None
    if cfg.track_sent:
        sent = torch.zeros((n, n), dtype=torch.bool, device=device)
    return EpidemicState(rows=rows, tx_remaining=tx,
                         msgs=torch.zeros((n,), **i32), tick=0, hops=hops,
                         next_send=torch.zeros((n,), **i32), sent=sent)


def _partition_ids(cfg: EpidemicConfig, device) -> Optional[torch.Tensor]:
    if cfg.partition_blocks <= 1:
        return None
    local = (torch.arange(cfg.flat_nodes, dtype=torch.int32, device=device)
             % cfg.n_nodes)
    return local * cfg.partition_blocks // cfg.n_nodes


def epidemic_tick(state: EpidemicState, key,
                  cfg: EpidemicConfig) -> EpidemicState:
    """One protocol round: gossip fanout, then (on cadence)
    anti-entropy.  Runs on the device of ``state``; with
    ``cfg.track_sent`` the state's ``sent`` is marked in place and
    passes through the sync unchanged."""
    part = _partition_ids(cfg, state.rows.device)
    part_active = state.tick < cfg.heal_tick
    k_b, k_s = split(key)
    rows, tx, msgs, hops, next_send, sent = broadcast_step(
        state.rows, state.tx_remaining, state.msgs, k_b,
        cfg.broadcast_params, partition_id=part,
        partition_active=part_active, hops=state.hops, tick=state.tick,
        next_send=state.next_send,
        sent=state.sent if cfg.track_sent else None,
    )
    if sent is None:
        sent = state.sent
    if _sync_due(cfg, state.tick):
        rows, msgs = sync_step(rows, msgs, k_s, cfg.sync_params,
                               partition_id=part,
                               partition_active=part_active)
    return EpidemicState(rows, tx, msgs, state.tick + 1, hops, next_send,
                         sent)


def _sync_due(cfg: EpidemicConfig, tick: int) -> bool:
    return (cfg.sync_interval > 0
            and tick % cfg.sync_interval == cfg.sync_interval - 1)


def _scan_chunk(state: EpidemicState, seed_key, target_row,
                cfg: EpidemicConfig):
    """Run cfg.chunk_ticks rounds; record every tick's per-universe
    statistics (``kernels.tick_stats.STATS`` columns).

    Returns (state, [C, S, len(STATS)] float32 on the state's device)."""
    s = cfg.n_universes or 1
    stats = torch.empty((cfg.chunk_ticks, s, len(STATS)),
                        dtype=torch.float32, device=state.rows.device)
    for c in range(cfg.chunk_ticks):
        state = epidemic_tick(state, fold_in(seed_key, state.tick), cfg)
        tick_stats(state.rows, target_row, state.msgs, state.hops, s,
                   out=stats[c])
    return state, stats


def _scan_chunk_coverage(state: EpidemicState, seed_key, target_row,
                         cfg: EpidemicConfig):
    """Run cfg.chunk_ticks rounds recording the per-tick coverage
    fraction (share of nodes whose rows equal the target) per universe:
    (state, [C, S])."""
    state, stats = _scan_chunk(state, seed_key, target_row, cfg)
    return state, stats[:, :, COVERAGE]


def seed_convergence(allflags):
    """Per-seed convergence extraction shared by the sim runners.

    allflags: [S, T] bool per-tick convergence.  Returns (converged
    mask, index of each seed's OWN convergence tick — last tick run if
    it never converged — and 1-based first tick, inf if never)."""
    converged = allflags.any(axis=1)
    first_idx = np.where(
        converged, allflags.argmax(axis=1), allflags.shape[1] - 1
    )
    first = np.where(converged, first_idx + 1, np.inf)
    return converged, first_idx, first


def stats_at_convergence(allflags, *series):
    """Each [S, T] per-tick series read at that seed's OWN convergence
    tick, never at global loop stop.

    Returns (converged mask [S], 1-based first tick [S] (inf if
    never), and one [S] value array per input series)."""
    converged, first_idx, first = seed_convergence(allflags)
    rows = np.arange(allflags.shape[0])
    return converged, first, [s[rows, first_idx] for s in series]


def run_epidemic_coverage(cfg: EpidemicConfig, n_seeds: int = 8,
                          seed: int = 0, device="cuda"):
    """Per-tick predicted coverage curve, seed-flattened.  Returns::

        {"coverage": [mean coverage at tick 1..T],
         "coverage_p10": ..., "coverage_p90": ...,  # seed spread
         "ticks_run": T, "converged_frac": ...}

    The run stops at the end of the first chunk where every universe
    holds coverage 1.0 (or at ``max_ticks``), so the curve may end
    before a tick a caller probes."""
    device = resolve_device(device)
    if cfg.track_sent:
        raise ValueError(
            "run_epidemic_coverage runs the seed-flattened layout only "
            "(track_sent needs the [N, N] vmap path)"
        )
    flat_cfg = replace(cfg, n_universes=n_seeds)
    key = PRNGKey(seed)
    state = epidemic_init(flat_cfg, device=device)
    target = state.rows[0]
    chunks = []
    ticks_done = 0
    while ticks_done < cfg.max_ticks:
        state, cov = _scan_chunk_coverage(state, key, target, flat_cfg)
        cov = cov.cpu().numpy().T  # [C, S] -> [S, C]
        chunks.append(cov)
        ticks_done += cfg.chunk_ticks
        if (cov[:, -1] >= 1.0).all():
            break
    allcov = np.concatenate(chunks, axis=1)  # [S, T]
    return {
        "coverage": [float(v) for v in allcov.mean(axis=0)],
        "coverage_p10": [
            float(v) for v in np.percentile(allcov, 10, axis=0)
        ],
        "coverage_p90": [
            float(v) for v in np.percentile(allcov, 90, axis=0)
        ],
        "ticks_run": int(allcov.shape[1]),
        "converged_frac": float((allcov[:, -1] >= 1.0).mean()),
    }


def run_epidemic(cfg: EpidemicConfig, seed: int = 0, device="cuda"):
    """Single-universe run.  Returns a stats dict (host values)."""
    stats = run_epidemic_seeds(cfg, n_seeds=1, seed=seed, device=device)
    stats["ticks_to_converge"] = stats.pop("ticks_p99")
    return stats


def run_epidemic_seeds(cfg: EpidemicConfig, n_seeds: int = 16,
                       seed: int = 0, device="cuda"):
    """Multi-seed run; returns convergence distribution stats.

    The S universes advance together in chunks; the host loop stops as
    soon as every universe has converged (or max_ticks hit).  They are
    seed-flattened, except with ``track_sent``, which runs
    ``_run_epidemic_seeds_sent`` (the reference's vmap path)."""
    device = resolve_device(device)
    if cfg.track_sent:
        return _run_epidemic_seeds_sent(cfg, n_seeds, seed, device)
    flat_cfg = replace(cfg, n_universes=n_seeds)
    key = PRNGKey(seed)
    state = epidemic_init(flat_cfg, device=device)
    # convergence target = the writer's committed state
    target = state.rows[0]

    return _run_chunks(cfg, n_seeds, lambda st: _scan_chunk(
        st, key, target, flat_cfg), state)


def _run_chunks(cfg: EpidemicConfig, n_seeds: int, chunk_fn, state):
    """Advance ``state`` chunk by chunk (``chunk_fn``: state -> (state,
    [C, S, len(STATS)] stats)) until every universe has converged or
    ``max_ticks`` is reached; fold the statistics into the stats
    dict."""
    t0 = time.perf_counter()
    chunks = []  # [S, C, len(STATS)] per chunk
    ticks_done = 0
    while ticks_done < cfg.max_ticks:
        state, stats = chunk_fn(state)
        stats = stats.cpu().numpy().transpose(1, 0, 2)
        raise_on_overflow(stats)
        chunks.append(stats)
        ticks_done += cfg.chunk_ticks
        if (stats[:, -1, CONVERGED] == 1.0).all():
            break
    wall = time.perf_counter() - t0

    def col(j):
        return [c[:, :, j] for c in chunks]

    return _epidemic_stats(
        cfg, n_seeds, [c[:, :, CONVERGED] == 1.0 for c in chunks],
        col(MSGS_MEAN), col(MSGS_P99), col(HOPS_P50), col(HOPS_P99),
        col(HOPS_COV), wall, ticks_done,
    )


# -- track_sent: the seed-batched [S, N, N] path ------------------------


def sent_seeds_init(cfg: EpidemicConfig, n_seeds: int,
                    device="cuda") -> EpidemicState:
    """``epidemic_init(cfg)`` (one universe, ``sent`` [N, N]) repeated
    for S seeds: every leaf [S, N, ...], ``sent`` [S, N, N]."""
    one = epidemic_init(cfg, device=device)
    return EpidemicState(*(
        x if x is None or isinstance(x, int)
        else x.expand((n_seeds,) + tuple(x.shape)).clone()
        for x in one
    ))


def _sync_seeds(rows, msgs, k_sync: list, cfg: EpidemicConfig, part,
                part_active: bool):
    """``sync_step`` of every seed with its own key, one ``sync_pull``
    launch: each seed's peer offsets ``randint(k_s, (N, P), 1, max(N,
    2))``, the S universes side by side (u = N).  rows [S, N, R], msgs
    [S, N]; part [N] or None."""
    s, n, r = rows.shape
    p = cfg.sync_peers
    device = rows.device
    offs = torch.cat([randint(k, (n, p), 1, max(n, 2), device=device)
                      for k in k_sync])
    sev = None
    if cfg.oneway_blocks:
        sev = severance_matrix(cfg.oneway_blocks, device=device)
    rows, msgs = sync_pull(
        rows.reshape(s * n, r), msgs.reshape(s * n), offs, n,
        partition_id=None if part is None else part.repeat(s), sev=sev,
        partition_active=part_active, cells_per_chunk=cfg.cells_per_chunk,
        handshake_msgs=cfg.sync_params.handshake_msgs,
    )
    return rows.reshape(s, n, r), msgs.reshape(s, n)


def sent_seeds_tick(state: EpidemicState, keys: list,
                    cfg: EpidemicConfig) -> EpidemicState:
    """``epidemic_tick`` of every seed at once (``keys`` the seeds' tick
    keys), on the batched state of ``sent_seeds_init``: one broadcast
    through the exact sampler for all seeds, then the sync on cadence.
    ``sent`` is marked in place."""
    part = _partition_ids(cfg, state.rows.device)
    part_active = state.tick < cfg.heal_tick
    pairs, k_sync = [], []
    for key in keys:
        k_b, k_s = split(key)
        key_t, key_l = split(k_b)
        pairs.append((key_t, key_l))
        k_sync.append(k_s)
    rows, tx, msgs, hops, next_send = deliver_sent(
        state.rows, state.tx_remaining, state.msgs, state.hops, state.tick,
        state.next_send, state.sent, pairs, cfg.broadcast_params,
        partition_id=part, partition_active=part_active)
    if _sync_due(cfg, state.tick):
        rows, msgs = _sync_seeds(rows, msgs, k_sync, cfg, part, part_active)
    return EpidemicState(rows, tx, msgs, state.tick + 1, hops, next_send,
                         state.sent)


def _sent_scan_chunk(state: EpidemicState, seed_keys: list, target_row,
                     cfg: EpidemicConfig):
    """``cfg.chunk_ticks`` batched ticks, tick keys ``fold_in(seed key,
    tick)``; every tick's per-seed statistics from ``tick_stats`` over
    the S universes.  Returns (state, [C, S, len(STATS)])."""
    s, n, r = state.rows.shape
    stats = torch.empty((cfg.chunk_ticks, s, len(STATS)),
                        dtype=torch.float32, device=state.rows.device)
    for c in range(cfg.chunk_ticks):
        state = sent_seeds_tick(
            state, [fold_in(k, state.tick) for k in seed_keys], cfg)
        hops = None if state.hops is None else state.hops.reshape(s * n)
        tick_stats(state.rows.reshape(s * n, r), target_row,
                   state.msgs.reshape(s * n), hops, s, out=stats[c])
    return state, stats


def _run_epidemic_seeds_sent(cfg: EpidemicConfig, n_seeds: int, seed: int,
                             device):
    """The reference's vmapped multi-seed path (``track_sent``'s [N, N]
    per-universe memory): seed s runs under ``split(PRNGKey(seed),
    S)[s]`` with tick keys ``fold_in(seed key, tick)``."""
    if cfg.n_universes is not None:
        raise ValueError("track_sent runs one universe per seed: leave "
                         "n_universes unset")
    seed_keys = list(split(PRNGKey(seed), n_seeds))
    state = sent_seeds_init(cfg, n_seeds, device=device)
    target = state.rows[0, 0]
    return _run_chunks(cfg, n_seeds, lambda st: _sent_scan_chunk(
        st, seed_keys, target, cfg), state)


def _epidemic_stats(cfg, n_seeds, flags, means, p99s, h50s, h99s, hcovs,
                    wall, ticks_done):
    """Fold per-chunk [S, C] stat arrays into the result dict.

    Hop percentiles are measured over broadcast-infected nodes only; a
    percentile whose rank exceeds the measured coverage is reported as
    None, never a sentinel.  ``hops_broadcast_frac`` carries the
    coverage so the reader can see why."""
    allflags = np.concatenate(flags, axis=1)  # [S, T]
    converged, first, (m_at, p_at, h50_at, h99_at, hcov_at) = (
        stats_at_convergence(
            allflags,
            np.concatenate(means, axis=1),
            np.concatenate(p99s, axis=1),
            np.concatenate(h50s, axis=1),
            np.concatenate(h99s, axis=1),
            np.concatenate(hcovs, axis=1),
        )
    )
    hcov = float(hcov_at.mean()) if cfg.track_hops else None

    def hop_stat(vals_at, needed_cov):
        if not cfg.track_hops or hcov is None or hcov < needed_cov:
            return None
        v = float(np.nanmean(vals_at))
        return None if np.isnan(v) else v

    return {
        "n_nodes": cfg.n_nodes,
        "n_seeds": n_seeds,
        "converged_frac": float(converged.mean()),
        "ticks_p50": float(np.percentile(first, 50)),
        "ticks_p99": float(np.percentile(first, 99)),
        "msgs_per_node_mean": float(m_at.mean()),
        "msgs_per_node_p99": float(p_at.mean()),
        "hops_p50": hop_stat(h50_at, 0.50),
        "hops_p99": hop_stat(h99_at, 0.99),
        "hops_broadcast_frac": hcov,
        "wall_s": wall,
        "ticks_run": ticks_done,
    }
