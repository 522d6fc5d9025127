"""The change types the storage engine applies (port of
``corrosion_tpu.types``: ``base`` and ``change``, plain copies)."""

from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq, Version
from corrosion_tpu_torch.types.change import (
    MAX_CHANGES_BYTE_SIZE,
    SENTINEL_CID,
    Change,
    ChunkedChanges,
)

__all__ = ["Version", "CrsqlDbVersion", "CrsqlSeq", "Change",
           "ChunkedChanges", "MAX_CHANGES_BYTE_SIZE", "SENTINEL_CID"]
