"""PyTorch/CUDA port of the corrosion_tpu convergence simulator.

The JAX package ``corrosion_tpu`` is the reference; this package mirrors
its layout (``ops/``, ``models/``, ``sim/``, ``utils/``, ``agent/``,
``types/``) so each module's counterpart is easy to find, and runs the
headline epidemic simulation, the exact-sampler column, anti-entropy
reassembly, SWIM churn, the calibration-scale exact ``sent_to``
sampler, the columnar CRDT winner selection of a batched apply and the
device-resident apply path (the storage engine's batched apply over a
clock cache kept on the card), and the multi-device layouts of the
exact sampler and the gossip fabrics over a ``mesh.Mesh``, through
hand-written CUDA kernels (``kernels/``).  The entry points:
``sim.run_epidemic_seeds`` (``track_sent`` included),
``sim.calibrate.run_exact_headline`` (with ``mesh=`` and
``host_sharded=``), ``models.sharded``'s fabrics,
``sim.calibrate.run_msgs_calibration``, ``sim.calibrate.run_exact``,
``sim.run_anti_entropy_seeds``, ``sim.run_churn``,
``sim.run_churn_cycles``, ``ops.merge.select_winners``,
``ops.devcache.DeviceClockCache`` and ``agent.storage.CrConn`` (with
``enable_device_cache``).

Every simulator entry point takes an explicit ``device`` (default
``"cuda"``).  Asking for ``"cuda"`` without a card raises; pass
``device="cpu"`` for the plain-PyTorch path the CPU tests hold against
the reference.  The host layers follow the reference's defaults:
``select_winners`` and the clock cache's ``backend="auto"`` take the
card when one is present and the NumPy twin otherwise, and an explicit
``backend="torch"`` without a card raises.  The package imports neither
``jax`` nor anything of ``corrosion_tpu``.
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
