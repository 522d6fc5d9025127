"""The wire codecs the agent speaks (port of ``corrosion_tpu.bridge``:
``speedy``, the Python twin of the reference's native codec, and
``foca``, the SWIM datagram codec over ``bincode``).  The reference's
golden cr-sqlite engine (``bridge/crsqlite_ref``) serves its tests only
and is not ported."""

from corrosion_tpu_torch.bridge import foca, speedy  # noqa: F401

__all__ = ["foca", "speedy"]
