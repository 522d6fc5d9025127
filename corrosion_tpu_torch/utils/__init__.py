"""Plain-Python helpers (port of ``corrosion_tpu.utils``)."""

from corrosion_tpu_torch.utils.ranges import RangeSet

__all__ = ["RangeSet"]
