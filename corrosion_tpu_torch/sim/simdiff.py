"""Sim-vs-agent trace diff, the prediction half (port of
``corrosion_tpu/sim/simdiff.py``).

The reference calibrates the epidemic simulator against a real
in-process agent cluster under matched parameters (uniform k-fanout,
the same ``max_transmissions``, no loss, no anti-entropy) and diffs the
measured quantities of both sides: msgs/node until convergence and the
infection-tree depth percentiles.  The simulator models the agents'
per-payload ``sent_to`` exclusion exactly (``track_sent``), so this
side runs ``run_epidemic_seeds``' seed-batched [S, N, N] path.

Twins here: ``sim_trace`` (simdiff.py:51), ``_finite`` (:99),
``_percentile`` (:106) and ``diff_traces`` (:248).  Left for the live
agent's port: ``agent_trace`` (:114) and ``run_simdiff`` (:284), which
boot real agents.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from corrosion_tpu_torch.sim.epidemic import (
    run_epidemic_seeds,
    sent_trace_cfg,
)


def sim_trace(
    n: int,
    fanout: int = 3,
    max_transmissions: int = 5,
    seeds: int = 8,
    sync: bool = False,
    backoff_ticks: float = 2.5,
    device="cuda",
) -> Dict:
    """Run the epidemic sim at matched parameters on ``device``; return
    trace stats.

    One tick = one agent flush interval (the fastest forward latency for
    a FRESH payload); the nth retransmission waits ``backoff_ticks*n``
    more, matching the agents' rebroadcast_delay/flush_interval ratio
    (0.05/0.02 = 2.5 by default).  ``sync`` runs anti-entropy every 8
    ticks.  ``wall_s`` is the runner's host clock."""
    cfg = sent_trace_cfg(
        n, sync_interval=8 if sync else 0, chunk_ticks=8, fanout=fanout,
        max_transmissions=max_transmissions, backoff_ticks=backoff_ticks)
    stats = run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device=device)
    return {
        "runtime": "tpu-sim",
        "n_nodes": n,
        "converged_frac": stats["converged_frac"],
        "ticks_to_converge_p50": _finite(stats["ticks_p50"]),
        "ticks_to_converge_p99": _finite(stats["ticks_p99"]),
        "msgs_per_node": stats["msgs_per_node_mean"],
        "hops_p50": stats["hops_p50"],
        "hops_p99": stats["hops_p99"],
        "wall_s": stats["wall_s"],
    }


def _finite(v: Optional[float]) -> Optional[float]:
    """inf/nan (a seed never converged) → None so the JSON stays strict."""
    if v is None or not math.isfinite(v):
        return None
    return v


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    import numpy as np

    return float(np.percentile(vals, q, method="nearest"))


def diff_traces(sim: Dict, agents: Dict) -> Dict:
    """Join the two traces into one recorded diff."""
    def ratio(a, b):
        # a hop percentile can be None (measured coverage below the
        # percentile rank, sim/epidemic.py hop_stat); no ratio then
        if a is None or b is None:
            return None
        return round(a / max(b, 1e-9), 3)

    return {
        "n_nodes": sim["n_nodes"],
        "sim": sim,
        "agents": agents,
        "diff": {
            "msgs_per_node_ratio": ratio(
                sim["msgs_per_node"], agents["msgs_per_node"]
            ),
            "hops_p50_ratio": ratio(sim["hops_p50"], agents["hops_p50"]),
            "hops_p99_ratio": ratio(sim["hops_p99"], agents["hops_p99"]),
            "both_converged": (
                sim["converged_frac"] == 1.0
                and agents["converged_frac"] == 1.0
            ),
            "residual_note": (
                "sim models the agents' sent_to exclusion (hop depths "
                "match); the residual msgs/node gap is time "
                "quantization — the tick grid and the agents' "
                "wall-clock retransmit schedule fit slightly different "
                "numbers of redundant retransmissions before their "
                "respective convergence cutoffs, so the ratio lands "
                "near 1 on either side"
            ),
        },
    }
