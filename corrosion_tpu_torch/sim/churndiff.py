"""SWIM churn calibration, the model half (port of
``corrosion_tpu/sim/churndiff.py``).

The reference crashes and relaunches real agents with active SWIM
probing and compares the wall time until every survivor holds the
victim DOWN (and ALIVE again) with the SWIM model's latencies under the
same cluster-size-scaled parameters, both in probe periods (the
model's tick is one probe interval).  This module is the model side,
through ``run_churn`` / ``run_churn_cycles``.

Twin here: ``model_churn_trace`` (churndiff.py:157).  Left for the live
agent's port: ``host_churn_trace`` (:31), ``run_churndiff`` (:195) and
the ``main()`` artifact generator (:280).
"""

from __future__ import annotations

from typing import Dict

from corrosion_tpu_torch.sim.churn import (
    ChurnConfig,
    run_churn,
    run_churn_cycles,
)


def model_churn_trace(n: int = 64, cycles: int = 1, device="cuda") -> Dict:
    """The SWIM model's churn cycles on ``device`` under the same scaled
    parameters; latencies already in ticks (= probe periods)."""
    if cycles <= 1:
        stats = run_churn(ChurnConfig(n_nodes=n), device=device)
        return {
            "runtime": "tpu-sim",
            "n_nodes": n,
            "detect_ticks": stats["detect_latency"],
            "rejoin_ticks": stats["rejoin_latency"],
            "msgs_per_node_per_tick": round(
                stats["msgs_per_node_per_tick"], 2),
        }
    # cycle windows sized to the scaled suspicion deadline so a cold
    # first cycle still resolves inside its own window
    period = 48 if n <= 64 else 72
    stats = run_churn_cycles(ChurnConfig(
        n_nodes=n, cycles=cycles, cycle_period=period,
        kill_tick=4, revive_tick=period - 16,
    ), device=device)
    return {
        "runtime": "tpu-sim",
        "n_nodes": n,
        "cycles": cycles,
        "per_cycle": stats["per_cycle"],
        "detect_ticks": stats["detect_latency_mean"],
        "rejoin_ticks": stats["rejoin_latency_mean"],
        "msgs_per_node_per_tick": round(
            stats["msgs_per_node_per_tick"], 2),
    }
