"""SWIM membership churn simulation, BASELINE.md config #2 (port of
``corrosion_tpu/sim/churn.py``).

A cluster runs the SWIM model while the ground-truth liveness schedule
kills and revives nodes; the measured quantities are failure-detection
latency (ticks from death until every live node marks the victim down)
and rejoin propagation (ticks until every live node sees the revived
node alive again), plus msgs/node.  Runs on the device given to the
entry point: the ``swim`` kernels on a card, their plain version on the
CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.models.swim import SwimParams, swim_init, swim_step
from corrosion_tpu_torch.random import PRNGKey, fold_in


@dataclass(frozen=True)
class ChurnConfig:
    n_nodes: int = 64
    params: SwimParams = None  # type: ignore[assignment]
    kill_tick: int = 4  # when the victim dies (offset within a cycle)
    revive_tick: int = 40  # when it comes back (offset within a cycle)
    victim: int = 1
    max_ticks: int = 128
    # repeated join/suspect/leave cycles: cycle c kills victim
    # (victim + c) % n at c*cycle_period + kill_tick and revives it at
    # + revive_tick.  cycles=1 is the single cycle.
    cycles: int = 1
    cycle_period: int = 64
    # ticks between host fetches of the per-tick flags
    chunk_ticks: int = 32

    def __post_init__(self):
        if self.params is None:
            # cluster-size-scaled SWIM parameters: at N=64 the suspicion
            # deadline is 4 * ceil(log10(65)) = 8 probe ticks and updates
            # ride at most 8 gossip rounds
            object.__setattr__(
                self, "params", SwimParams.scaled(self.n_nodes)
            )


def _schedule(cfg: ChurnConfig, t: int):
    """(victim, dead, revived) at tick t."""
    if cfg.cycles <= 1:
        victim, off = cfg.victim, t
    else:
        cyc = min(t // cfg.cycle_period, cfg.cycles - 1)
        off = t - cyc * cfg.cycle_period
        victim = (cfg.victim + cyc) % cfg.n_nodes
    if not 0 <= victim < cfg.n_nodes:
        raise ValueError(f"victim {victim} is not a node of {cfg.n_nodes}")
    return victim, cfg.kill_tick <= off < cfg.revive_tick, off == cfg.revive_tick


def _scan_chunk(state, seed_key, start_tick: int, cfg: ChurnConfig):
    """``cfg.chunk_ticks`` protocol periods from ``start_tick`` under the
    churn schedule, tick keys ``fold_in(seed_key, t)``.  Returns (state,
    (detected [C] bool, rejoined [C] bool)) after one host fetch: every
    other node holds the victim DOWN / ALIVE after the tick."""
    n, c = cfg.n_nodes, cfg.chunk_ticks
    dev = state.view.device
    alive = np.ones((c, n), dtype=bool)
    revived = np.zeros((c, n), dtype=bool)
    victims = []
    for i in range(c):
        victim, dead, rev = _schedule(cfg, start_tick + i)
        alive[i, victim] = not dead
        revived[i, victim] = rev
        victims.append(victim)
    alive_t = torch.from_numpy(alive).to(dev)
    revived_t = torch.from_numpy(revived).to(dev)
    flags = torch.zeros((c, 2), dtype=torch.int32, device=dev)
    for i in range(c):
        t = start_tick + i
        state = swim_step(state, fold_in(seed_key, t), t, cfg.params,
                          alive_t[i], revived=revived_t[i],
                          victim=victims[i], flags=flags[i])
    counts = flags.cpu().numpy()
    return state, (counts[:, 0] == n - 1, counts[:, 1] == n - 1)


def _chunks(cfg: ChurnConfig, seed: int, device, total: int, stop=None):
    """Run chunks until ``total`` ticks (or ``stop(rejoined flags,
    ticks)``); returns (state, detected [T], rejoined [T], ticks, wall)."""
    state = swim_init(cfg.n_nodes, device=device)
    seed_key = PRNGKey(seed)
    t0 = time.perf_counter()
    det_flags, rej_flags = [], []
    ticks = 0
    while ticks < total:
        state, (det, rej) = _scan_chunk(state, seed_key, ticks, cfg)
        det_flags.append(det)
        rej_flags.append(rej)
        ticks += cfg.chunk_ticks
        if stop is not None and stop(rej, ticks):
            break
    wall = time.perf_counter() - t0
    return (state, np.concatenate(det_flags), np.concatenate(rej_flags),
            ticks, wall)


def run_churn_cycles(cfg: ChurnConfig, seed: int = 0, device="cuda"):
    """Repeated join/suspect/leave cycles: per-cycle detection/rejoin
    latencies plus aggregates.  Latencies are in ticks (= probe
    periods), offsets from each cycle's own kill/revive tick."""
    device = resolve_device(device)
    if cfg.cycles < 1 or cfg.revive_tick >= cfg.cycle_period:
        raise ValueError("churn cycles need cycles >= 1 and revive_tick "
                         "< cycle_period")
    total = cfg.cycles * cfg.cycle_period + cfg.cycle_period // 2
    total = -(-total // cfg.chunk_ticks) * cfg.chunk_ticks
    state, det, rej, ticks, wall = _chunks(cfg, seed, device, total)

    def first_true(flags, start, end):
        w = flags[start:end]
        return int(w.argmax()) if w.any() else None

    per_cycle = []
    for c in range(cfg.cycles):
        lo = c * cfg.cycle_period
        hi = (c + 1) * cfg.cycle_period if c < cfg.cycles - 1 else ticks
        per_cycle.append({
            "victim": (cfg.victim + c) % cfg.n_nodes,
            "detect_latency": first_true(det, lo + cfg.kill_tick, hi),
            "rejoin_latency": first_true(rej, lo + cfg.revive_tick, hi),
        })
    msgs = state.msgs.cpu().numpy()
    dets = [c["detect_latency"] for c in per_cycle
            if c["detect_latency"] is not None]
    rejs = [c["rejoin_latency"] for c in per_cycle
            if c["rejoin_latency"] is not None]
    return {
        "n_nodes": cfg.n_nodes,
        "cycles": cfg.cycles,
        "per_cycle": per_cycle,
        "detect_latency_mean": float(np.mean(dets)) if dets else None,
        "rejoin_latency_mean": float(np.mean(rejs)) if rejs else None,
        "msgs_per_node_per_tick": float(msgs.mean()) / max(ticks, 1),
        "wall_s": wall,
        "ticks_run": ticks,
    }


def run_churn(cfg: ChurnConfig, seed: int = 0, device="cuda"):
    """Detection/rejoin latency stats for one churn cycle."""
    device = resolve_device(device)
    state, det, rej, ticks, wall = _chunks(
        cfg, seed, device, cfg.max_ticks,
        stop=lambda rej, ticks: ticks > cfg.revive_tick and rej[-1])
    detect_tick = int(det.argmax()) if det.any() else None
    # rejoin counts only after the revive tick
    rej[: cfg.revive_tick] = False
    rejoin_tick = int(rej.argmax()) if rej.any() else None
    msgs = state.msgs.cpu().numpy()
    return {
        "n_nodes": cfg.n_nodes,
        "detect_latency": (
            None if detect_tick is None else detect_tick - cfg.kill_tick
        ),
        "rejoin_latency": (
            None if rejoin_tick is None else rejoin_tick - cfg.revive_tick
        ),
        "msgs_per_node_mean": float(msgs.mean()),
        # run-length-independent rate
        "msgs_per_node_per_tick": float(msgs.mean()) / max(ticks, 1),
        "wall_s": wall,
        "ticks_run": ticks,
    }
