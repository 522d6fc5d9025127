"""Simulation runners (port of ``corrosion_tpu.sim``)."""

from corrosion_tpu_torch.sim.antientropy import (  # noqa: F401
    AntiEntropyConfig,
    run_anti_entropy_seeds,
)
from corrosion_tpu_torch.sim.churn import (  # noqa: F401
    ChurnConfig,
    run_churn,
    run_churn_cycles,
)
from corrosion_tpu_torch.sim.epidemic import (  # noqa: F401
    EpidemicConfig,
    run_epidemic,
    run_epidemic_seeds,
)
