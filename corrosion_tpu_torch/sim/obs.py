"""Observability soak, the prediction half (port of
``corrosion_tpu/sim/obs.py``).

The reference's soak measures a live cluster's convergence three ways
(the agents' own telemetry, harness ground truth, and the epidemic
kernel's prediction) and writes them side by side.  This module is the
prediction: the fault-free convergence depth at the soak's (n, fanout,
max_transmissions) on the simdiff tick base, with anti-entropy every 8
ticks, through ``run_epidemic_seeds``' ``track_sent`` path.

Twins here: ``TICK_S`` (obs.py:37) and ``sim_obs_trace`` (:40).  Left
for the live agent's port: ``agent_obs_trace`` (:88) and ``run_obs``
(:286), which boot real agents.
"""

from __future__ import annotations

from typing import Dict

from corrosion_tpu_torch.sim.epidemic import (
    run_epidemic_seeds,
    sent_trace_cfg,
)
from corrosion_tpu_torch.sim.simdiff import _finite

# the simdiff/chaos time base: one kernel tick ≈ the agents' broadcast
# flush interval (the agents' bcast_flush_interval is 0.02 s)
TICK_S = 0.02


def sim_obs_trace(
    n: int,
    fanout: int = 3,
    max_transmissions: int = 5,
    seeds: int = 8,
    device="cuda",
) -> Dict:
    """Fault-free epidemic-kernel prediction at obs scale on
    ``device``: convergence depth in ticks under uniform sampling (the
    agents run with ring0 disabled for comparability, like the chaos
    soak).  ``wall_s`` is the runner's host clock."""
    cfg = sent_trace_cfg(n, sync_interval=8, chunk_ticks=16, fanout=fanout,
                         max_transmissions=max_transmissions)
    stats = run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device=device)
    p50, p99 = _finite(stats["ticks_p50"]), _finite(stats["ticks_p99"])
    return {
        "runtime": "tpu-sim",
        "n_nodes": n,
        "converged_frac": stats["converged_frac"],
        "ticks_p50": p50,
        "ticks_p99": p99,
        "predicted_wall_p50_s": p50 * TICK_S if p50 is not None else None,
        "predicted_wall_p99_s": p99 * TICK_S if p99 is not None else None,
        "msgs_per_node": stats["msgs_per_node_mean"],
        "tick_seconds": TICK_S,
        "wall_s": stats["wall_s"],
    }
