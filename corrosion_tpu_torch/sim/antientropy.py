"""Anti-entropy reassembly simulation, BASELINE.md config #4 (port of
``corrosion_tpu/sim/antientropy.py``).

10k nodes, periodic sync with subset peer selection, broadcast
disabled: one writer holds a chunked changeset and every other node
reassembles it purely through sync rounds (chunk-budgeted sessions,
per-chunk loss, out-of-order arrival, gap healing) with
``models.sync.seq_sync_step``.  Runs on the device given to the entry
point: the ``seq_sync`` / ``seq_stats`` kernels on a card, their plain
versions on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.kernels.seq_sync import (
    CONVERGED,
    MSGS_MEAN,
    STATS,
    seq_stats,
)
from corrosion_tpu_torch.models.sync import SeqSyncParams, seq_sync_step
from corrosion_tpu_torch.random import PRNGKey, fold_in
from corrosion_tpu_torch.sim.epidemic import seed_convergence


@dataclass(frozen=True)
class AntiEntropyConfig:
    n_nodes: int = 10_000
    n_seqs: int = 64  # seqs in the disseminating changeset
    peers_per_round: int = 1
    seqs_per_chunk: int = 8
    chunk_budget: int = 4
    loss: float = 0.02  # per-chunk drop (exercises gap healing)
    max_ticks: int = 96
    chunk_ticks: int = 8
    # seed-flattening (models/common.py): S universes side by side
    n_universes: Optional[int] = None

    @property
    def flat_nodes(self) -> int:
        return self.n_nodes * (self.n_universes or 1)

    @property
    def params(self) -> SeqSyncParams:
        return SeqSyncParams(
            n_nodes=self.flat_nodes,
            n_seqs=self.n_seqs,
            peers_per_round=self.peers_per_round,
            seqs_per_chunk=self.seqs_per_chunk,
            chunk_budget=self.chunk_budget,
            loss=self.loss,
            universe=self.n_nodes if self.n_universes else None,
        )


# BASELINE config #4 as bench.py runs it (``_anti_entropy``,
# bench.py:3203-3216, ``--seeds 32``)
CONFIG4 = AntiEntropyConfig()
CONFIG4_SEEDS = 32


def anti_entropy_init(cfg: AntiEntropyConfig, writer: int = 0,
                      device="cuda"):
    """(bits [flat, S] bool, msgs [flat] int32): each universe's
    ``writer`` holds every seq, nobody else any."""
    device = resolve_device(device)
    bits = torch.zeros((cfg.flat_nodes, cfg.n_seqs), dtype=torch.bool,
                       device=device)
    bits[writer::cfg.n_nodes] = True
    msgs = torch.zeros((cfg.flat_nodes,), dtype=torch.int32, device=device)
    return bits, msgs


def _scan_chunk(carry, seed_key, start_tick: int, cfg: AntiEntropyConfig):
    """``cfg.chunk_ticks`` rounds, tick keys ``fold_in(seed_key, t)``;
    every tick's per-universe statistics (``STATS`` columns: all seqs
    everywhere, float32 mean msgs).  Returns (carry, [C, S, 2] float32
    on the carry's device)."""
    s = cfg.n_universes or 1
    bits, msgs = carry
    stats = torch.empty((cfg.chunk_ticks, s, len(STATS)),
                        dtype=torch.float32, device=bits.device)
    for c in range(cfg.chunk_ticks):
        key = fold_in(seed_key, start_tick + c)
        bits, msgs = seq_sync_step(bits, msgs, key, cfg.params)
        seq_stats(bits, msgs, s, out=stats[c])
    return (bits, msgs), stats


def run_anti_entropy_seeds(cfg: AntiEntropyConfig, n_seeds: int = 16,
                           seed: int = 0, device="cuda"):
    """Multi-universe run (seed-flattened); convergence stats, one host
    fetch a chunk."""
    device = resolve_device(device)
    flat_cfg = replace(cfg, n_universes=n_seeds)
    key = PRNGKey(seed)
    carry = anti_entropy_init(flat_cfg, device=device)

    t0 = time.perf_counter()
    flags, means = [], []
    ticks_done = 0
    while ticks_done < cfg.max_ticks:
        carry, stats = _scan_chunk(carry, key, ticks_done, flat_cfg)
        stats = stats.cpu().numpy().transpose(1, 0, 2)  # [S, C, 2]
        conv = stats[:, :, CONVERGED] == 1.0
        flags.append(conv)
        means.append(stats[:, :, MSGS_MEAN])
        ticks_done += cfg.chunk_ticks
        if conv[:, -1].all():
            break
    wall = time.perf_counter() - t0

    allflags = np.concatenate(flags, axis=1)  # [S, T]
    allmeans = np.concatenate(means, axis=1)
    converged, first_idx, first = seed_convergence(allflags)
    msgs_at_conv = allmeans[np.arange(n_seeds), first_idx]
    return {
        "n_nodes": cfg.n_nodes,
        "n_seeds": n_seeds,
        "converged_frac": float(converged.mean()),
        "ticks_p50": float(np.percentile(first, 50)),
        "ticks_p99": float(np.percentile(first, 99)),
        "msgs_per_node_mean": float(msgs_at_conv.mean()),
        "wall_s": wall,
        "ticks_run": ticks_done,
    }
