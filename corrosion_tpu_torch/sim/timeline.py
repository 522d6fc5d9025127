"""Timeline campaign, the prediction half and the gates (port of
``corrosion_tpu/sim/timeline.py``).

The reference's campaign compares the SHAPE of a live partition-heal
run (writes on both sides of a symmetric 2-block split, each wave's
time-resolved coverage curve from the flight recorder) with the
epidemic kernel's per-tick coverage prediction, under named
tolerances: the plateau just before the heal, the partition held in
both worlds, and the recovery within a budget of the kernel's
full-coverage offset.  This module is the kernel's curve
(``run_epidemic_coverage``, the seed-flattened perm-fanout path) and
the pure gate arithmetic.

Twins here: the tolerances (timeline.py:43-58),
``kernel_coverage_prediction`` (:61), ``curve_value_at`` (:122) and
``trajectory_gates`` (:274).  Left for the live agent's port:
``agent_timeline_cell`` (:134), ``run_timeline`` (:332) and the
virtual and parity cells (:400-662), which need the live agent,
``devcluster``, ``faults`` or ``vcluster``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from corrosion_tpu_torch.sim.epidemic import (
    EpidemicConfig,
    run_epidemic_coverage,
)

# the simdiff/chaos time base: one kernel tick ≈ the agents' broadcast
# flush interval (the agents' bcast_flush_interval is 0.02 s)
TICK_S = 0.02

# named trajectory tolerances (recorded in the artifact).  The plateau
# is probed at the maximal guaranteed-pre-heal offset (heal delay − the
# last write's offset from the split − a guard), so in-block
# propagation has the whole partition window to complete.
PLATEAU_GUARD_S = 0.1      # keep the probe strictly before the heal
PLATEAU_PROBE_MIN_S = 0.1  # floor when writes ran long
PLATEAU_TOL = 0.20         # |live - predicted| plateau coverage, absolute
FULL_COV = 0.99            # "full coverage" threshold for gating
RECOVERY_FACTOR = 6.0      # live full-coverage offset vs kernel's
RECOVERY_SLACK_S = 2.0     # additive slack on top of the factor


def kernel_coverage_prediction(
    n: int,
    heal_tick: int,
    fanout: int = 3,
    max_transmissions: int = 5,
    seeds: int = 8,
    device="cuda",
) -> Dict:
    """The kernel's per-tick coverage curve on ``device`` for the
    partition-heal family (loss-free, symmetric 2-block split healing
    at ``heal_tick``): the prediction the live trajectory gates
    against.  Seed-flattened layout (no per-payload sent tracking: at
    loss 0 the exclusion shifts msgs, not the coverage dynamics)."""
    cfg = EpidemicConfig(
        n_nodes=n,
        n_rows=4,
        fanout_ring0=0,
        fanout_global=fanout,
        ring0_size=1,
        max_transmissions=max_transmissions,
        loss=0.0,
        partition_blocks=2,
        heal_tick=heal_tick,
        backoff_ticks=2.5,
        sync_interval=8,
        sync_peers=1,
        max_ticks=512,
        chunk_ticks=16,
    )
    cov = run_epidemic_coverage(cfg, n_seeds=seeds, seed=0, device=device)
    curve = cov["coverage"]
    times = [round((i + 1) * TICK_S, 4) for i in range(len(curve))]

    def t_at(c: float) -> Optional[float]:
        for t, v in zip(times, curve):
            if v >= c:
                return t
        return None

    return {
        "runtime": "tpu-sim",
        "n_nodes": n,
        "heal_tick": heal_tick,
        "heal_s": round(heal_tick * TICK_S, 4),
        "tick_seconds": TICK_S,
        "times_s": times,
        "coverage": [round(v, 4) for v in curve],
        "coverage_p10": [round(v, 4) for v in cov["coverage_p10"]],
        "coverage_p90": [round(v, 4) for v in cov["coverage_p90"]],
        "converged_frac": cov["converged_frac"],
        "t_at_coverage": {
            str(c): t_at(c) for c in (0.5, 0.75, 0.9, 0.99, 1.0)
        },
    }


def curve_value_at(times: List[float], coverage: List[float],
                   t: float) -> float:
    """Predicted coverage at offset ``t`` (step interpolation; 0 before
    the first tick)."""
    v = 0.0
    for tt, cc in zip(times, coverage):
        if tt > t:
            break
        v = cc
    return v


def trajectory_gates(live: Dict, pred: Dict,
                     heal_after: float) -> Dict:
    """The named-tolerance trajectory comparison: plateau / held /
    recovery, each gate a boolean next to its operands."""
    probe_t = max(
        PLATEAU_PROBE_MIN_S,
        heal_after - live.get("last_write_offset_s", 0.0)
        - PLATEAU_GUARD_S,
    )
    curve = live["coverage"]
    offsets = curve["offsets_s"]
    expected = max(1, curve["expected"])
    live_plateau = sum(1 for d in offsets if d <= probe_t) / expected
    pred_plateau = curve_value_at(
        pred["times_s"], pred["coverage"], probe_t
    )
    live_full = curve["t_at_coverage"].get(str(FULL_COV))
    pred_full = pred["t_at_coverage"].get(str(FULL_COV))
    recovery_budget = (
        None if pred_full is None
        else round(RECOVERY_FACTOR * pred_full + RECOVERY_SLACK_S, 3)
    )
    gates = {
        "converged": bool(live["converged"]),
        # mid-partition both worlds sit at the severed-block fraction
        "plateau_matches": abs(live_plateau - pred_plateau)
        <= PLATEAU_TOL,
        # the partition held: neither curve near-full before the heal
        "partition_held": live_plateau < FULL_COV
        and pred_plateau < FULL_COV,
        # post-heal the live wave completes within the named budget
        "recovery_within_budget": (
            live_full is not None
            and recovery_budget is not None
            and live_full <= recovery_budget
        ),
    }
    return {
        "gates": gates,
        "plateau_probe_s": round(probe_t, 4),
        "live_plateau_cov": round(live_plateau, 4),
        "predicted_plateau_cov": round(pred_plateau, 4),
        "plateau_tolerance": PLATEAU_TOL,
        "live_full_coverage_s": live_full,
        "predicted_full_coverage_s": pred_full,
        "recovery_budget_s": recovery_budget,
        "recovery_factor": RECOVERY_FACTOR,
        "recovery_slack_s": RECOVERY_SLACK_S,
        "residual": (
            "the kernel's tick grid does not model TCP reconnects, "
            "breaker cooldowns or the anti-entropy cadence; live "
            "recovery runs a documented ~3-4x slower than predicted "
            "(CHAOS_N32), bounded here by recovery_factor instead of "
            "hidden"
        ),
    }
