"""Core value types shared by the simulator and the host agent (port of
``corrosion_tpu.types``: plain copies of its modules, ``crypto`` left
out until the agent's signed attribution is ported)."""

from corrosion_tpu_torch.types.base import Version, CrsqlDbVersion, CrsqlSeq
from corrosion_tpu_torch.types.actor import ActorId, Actor, ClusterId
from corrosion_tpu_torch.types.hlc import Timestamp, HLClock, MAX_CLOCK_DELTA_NS
from corrosion_tpu_torch.types.change import (
    Change,
    ChunkedChanges,
    MAX_CHANGES_BYTE_SIZE,
    SENTINEL_CID,
)
from corrosion_tpu_torch.types.changeset import Changeset, ChangesetKind, ChangeV1, ChangeSource
from corrosion_tpu_torch.types.payload import (
    BroadcastV1,
    UniPayload,
    BiPayload,
    SyncStateV1,
    SyncNeedV1,
)

__all__ = [
    "Version",
    "CrsqlDbVersion",
    "CrsqlSeq",
    "ActorId",
    "Actor",
    "ClusterId",
    "Timestamp",
    "HLClock",
    "MAX_CLOCK_DELTA_NS",
    "Change",
    "ChunkedChanges",
    "MAX_CHANGES_BYTE_SIZE",
    "SENTINEL_CID",
    "Changeset",
    "ChangesetKind",
    "ChangeV1",
    "ChangeSource",
    "BroadcastV1",
    "UniPayload",
    "BiPayload",
    "SyncStateV1",
    "SyncNeedV1",
]
