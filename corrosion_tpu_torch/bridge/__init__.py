"""The speedy wire codec the agent speaks (port of
``corrosion_tpu.bridge``: ``speedy``, the Python twin of the reference's
native codec).  The reference's golden cr-sqlite engine
(``bridge/crsqlite_ref``) serves its tests only and is not ported."""

from corrosion_tpu_torch.bridge import speedy  # noqa: F401

__all__ = ["speedy"]
