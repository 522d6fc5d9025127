"""Chaos soak, the prediction half (port of
``corrosion_tpu/sim/chaos.py``).

The reference injects the epidemic kernel's fault family (loss,
partition-heal, churn) into a live cluster through a ``FaultPlan`` and
diffs convergence time and msgs/node against the kernel's
degraded-mode prediction.  This module is the prediction: loss +
partition-heal (+ one-way partitions) with anti-entropy enabled.  Up
to 128 nodes it runs the agents' exact ``sent_to`` sampler
(``track_sent``, [N, N] memory a seed); past that the perm-fanout path,
which predicts the same coverage dynamics with msgs as a lower bound.

Twin here: ``sim_chaos_trace`` (chaos.py:41).  Left for the live
agent's port: ``agent_chaos_trace`` (:106) and ``run_chaos`` (:252),
which need the live agent, ``devcluster`` and ``faults``.
"""

from __future__ import annotations

from typing import Dict

from corrosion_tpu_torch.sim.epidemic import (
    EpidemicConfig,
    run_epidemic_seeds,
)
from corrosion_tpu_torch.sim.simdiff import _finite


def sim_chaos_trace(
    n: int,
    loss: float = 0.05,
    partition_blocks: int = 2,
    heal_tick: int = 32,
    fanout: int = 3,
    max_transmissions: int = 5,
    seeds: int = 8,
    oneway_blocks=None,
    track_sent: bool = None,
    device="cuda",
) -> Dict:
    """Epidemic-kernel prediction for the faulted regime on ``device``:
    loss + partition-heal with anti-entropy enabled (the headline family
    at chaos scale).  ``track_sent`` defaults to ``n <= 128``.
    ``wall_s`` is the runner's host clock."""
    cfg = EpidemicConfig(
        n_nodes=n,
        n_rows=4,
        fanout_ring0=0,
        fanout_global=fanout,
        ring0_size=1,  # agents sample uniformly under quarantine too
        max_transmissions=max_transmissions,
        loss=loss,
        partition_blocks=partition_blocks,
        heal_tick=heal_tick,
        oneway_blocks=(
            tuple(tuple(p) for p in oneway_blocks)
            if oneway_blocks else None
        ),
        backoff_ticks=2.5,  # the agents' rebroadcast_delay/flush ratio
        # the exact sampler's [N, N] memory is calibration scale only
        track_sent=(n <= 128) if track_sent is None else track_sent,
        sync_interval=8,  # anti-entropy must heal what faults dropped
        sync_peers=1,
        max_ticks=512,
        chunk_ticks=16,
    )
    stats = run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device=device)
    return {
        "runtime": "tpu-sim",
        "n_nodes": n,
        "loss": loss,
        "partition_blocks": partition_blocks,
        "heal_tick": heal_tick,
        "oneway_blocks": (
            [list(p) for p in oneway_blocks] if oneway_blocks else None
        ),
        "converged_frac": stats["converged_frac"],
        "ticks_to_converge_p50": _finite(stats["ticks_p50"]),
        "ticks_to_converge_p99": _finite(stats["ticks_p99"]),
        "msgs_per_node": stats["msgs_per_node_mean"],
        "wall_s": stats["wall_s"],
    }
