"""PyTorch/CUDA port of the corrosion_tpu convergence simulator.

The JAX package ``corrosion_tpu`` is the reference; this package mirrors
its layout (``ops/``, ``models/``, ``sim/``, ``utils/``) so each
module's counterpart is easy to find, and runs the headline epidemic
simulation, the exact-sampler column, anti-entropy reassembly, SWIM
churn, the calibration-scale exact ``sent_to`` sampler and the
columnar CRDT winner selection of a batched apply through hand-written
CUDA kernels (``kernels/``).  The entry points:
``sim.run_epidemic_seeds`` (``track_sent`` included),
``sim.calibrate.run_exact_headline``,
``sim.calibrate.run_msgs_calibration``, ``sim.calibrate.run_exact``,
``sim.run_anti_entropy_seeds``, ``sim.run_churn``,
``sim.run_churn_cycles`` and ``ops.merge.select_winners``.

Every entry point takes an explicit ``device`` (default ``"cuda"``).
Asking for ``"cuda"`` without a card raises; pass ``device="cpu"`` for
the plain-PyTorch path the CPU tests hold against the reference.  The
package imports neither ``jax`` nor anything of ``corrosion_tpu``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises instead of quietly running on the CPU when a card is asked
    for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
