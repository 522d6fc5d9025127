"""Actor identity.

Parity: ``crates/corro-types/src/actor.rs:26,133-210,222`` — ``ActorId`` is a
uuid equal to the storage engine's site id; ``Actor`` is the SWIM identity
(id + gossip addr + HLC timestamp + cluster id) whose ``renew()`` bumps the
timestamp so a node declared down can rejoin under the same id, and whose
``has_same_prefix`` compares everything except the timestamp.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, replace, field

from corrosion_tpu_torch.types.hlc import Timestamp


class ClusterId(int):
    """u16 cluster id; members of different clusters never gossip."""

    __slots__ = ()
    MAX = (1 << 16) - 1

    def __new__(cls, value: int = 0):
        if not 0 <= int(value) <= cls.MAX:
            raise ValueError(f"ClusterId out of u16 range: {value!r}")
        return super().__new__(cls, value)


@dataclass(frozen=True, order=True)
class ActorId:
    """16-byte actor id == storage site id (uuid)."""

    bytes: bytes = field(default=b"\x00" * 16)

    def __post_init__(self):
        if len(self.bytes) != 16:
            raise ValueError("ActorId must be 16 bytes")

    @classmethod
    def generate(cls) -> "ActorId":
        return cls(uuid.uuid4().bytes)

    @classmethod
    def from_uuid(cls, u: uuid.UUID) -> "ActorId":
        return cls(u.bytes)

    @classmethod
    def from_hex(cls, s: str) -> "ActorId":
        return cls(uuid.UUID(s).bytes)

    def to_uuid(self) -> uuid.UUID:
        return uuid.UUID(bytes=self.bytes)

    def as_u128(self) -> int:
        return int.from_bytes(self.bytes, "big")

    def __str__(self) -> str:
        return str(self.to_uuid())

    def __hash__(self) -> int:
        return hash(self.bytes)


@dataclass(frozen=True)
class Actor:
    """SWIM member identity (the foca ``Identity`` impl in the reference)."""

    id: ActorId
    addr: str  # "host:port" gossip address
    ts: Timestamp = field(default_factory=lambda: Timestamp(0))
    cluster_id: ClusterId = field(default_factory=ClusterId)

    def has_same_prefix(self, other: "Actor") -> bool:
        """Identity equality ignoring the (renewable) timestamp."""
        return (
            self.id == other.id
            and self.addr == other.addr
            and self.cluster_id == other.cluster_id
        )

    def renew(self, now: Timestamp) -> "Actor":
        """Auto-rejoin: same identity, fresh timestamp (actor.rs:199-210)."""
        return replace(self, ts=now)
