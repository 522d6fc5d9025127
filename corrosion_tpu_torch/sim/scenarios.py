"""Adversarial scenario matrix, the prediction half (port of
``corrosion_tpu/sim/scenarios.py``).

The reference runs each hostile fault family (clock skew, one-way
partition, slow IO, equivocation, and all at once) in a live cluster,
gated on convergence and no divergence, next to the epidemic kernel's
prediction of the cell.  This module is that prediction: the directed
(one-way) partition families through ``chaos.sim_chaos_trace``, the
others, whose faults alter timestamps, lock holds and screening but
not the message dynamics, through the fault-free ``obs.sim_obs_trace``,
each with its modelling residual named.

Twins here: ``TICK_S`` (scenarios.py:61), ``FAMILIES`` (:63) and
``sim_prediction`` (:115).  Left for the live agent's port:
``build_plan`` (:72), the live and virtual cells and their runners
(:155-1731), which need the live agent, ``devcluster``, ``faults`` or
``vcluster``.
"""

from __future__ import annotations

from typing import Dict

from corrosion_tpu_torch.sim.chaos import sim_chaos_trace
from corrosion_tpu_torch.sim.obs import sim_obs_trace

# the simdiff/chaos time base: one kernel tick ≈ the agents' broadcast
# flush interval (the agents' bcast_flush_interval is 0.02 s)
TICK_S = 0.02

FAMILIES = (
    "clock_skew",
    "asym_partition",
    "slow_io",
    "equivocation",
    "compound",
)


def sim_prediction(family: str, n: int, heal_after: float,
                   seeds: int = 8, device="cuda") -> Dict:
    """The epidemic kernel's prediction for the cell on ``device``,
    with any modelling residual named.  The kernel models loss and
    partitions including the directed (one-way) shape, so the
    asym_partition cell compares against the directed prediction with
    no partition residual.  Skew / slow IO / equivocation alter
    timestamps, lock holds and screening, not the message dynamics, so
    those cells compare against the fault-free prediction and keep
    their residual."""
    heal_tick = max(1, int(round(heal_after / TICK_S)))
    if family in ("asym_partition", "compound"):
        loss = 0.05 if family == "compound" else 0.0
        pred = sim_chaos_trace(
            n, loss=loss, partition_blocks=2, heal_tick=heal_tick,
            seeds=seeds, oneway_blocks=((0, 1),), device=device,
        )
        if family == "compound":
            pred["residual"] = (
                "the kernel models the cell's loss + one-way partition "
                "exactly; clock skew (the cell's third fault) alters "
                "timestamps, not message dynamics, and carries no "
                "kernel-side model"
            )
        return pred
    pred = sim_obs_trace(n, seeds=seeds, device=device)
    pred["residual"] = (
        "the kernel does not model clock skew / disk latency / hostile "
        "peers — they alter timestamps, lock holds and screening, not "
        "the message dynamics — so the cell compares against the "
        "fault-free prediction"
    )
    return pred
