"""Wire payloads + the sync needs algebra.

Parity: ``crates/corro-types/src/broadcast.rs:37-67`` (``UniPayload`` /
``BiPayload``), ``sync.rs:80-273`` (``SyncStateV1`` / ``SyncNeedV1`` /
``compute_available_needs``).  The needs algebra here is the exact host-side
implementation; :mod:`corrosion_tpu_torch.models.sync` carries the dense-tensor
version used by the simulator, and the two are cross-checked in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.types.actor import ActorId, ClusterId
from corrosion_tpu_torch.types.base import Version
from corrosion_tpu_torch.types.changeset import ChangeV1
from corrosion_tpu_torch.types.hlc import Timestamp
from corrosion_tpu_torch.utils.ranges import RangeSet

Span = Tuple[int, int]


# ---------------------------------------------------------------------------
# Dissemination payloads
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BroadcastV1:
    """Broadcast payload: a change message (optionally a rebroadcast)."""

    change: ChangeV1


@dataclass(frozen=True)
class UniPayload:
    """Uni-stream payload: broadcast data + originating cluster, priority flag."""

    broadcast: BroadcastV1
    cluster_id: ClusterId = ClusterId(0)
    priority: bool = False


@dataclass(frozen=True)
class BiPayload:
    """Bi-stream (sync session) opener: who wants to sync, with trace ctx."""

    actor_id: ActorId
    trace_ctx: Optional[dict] = None


# ---------------------------------------------------------------------------
# Sync state + needs algebra
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SyncNeedV1:
    """One need: Full version range | Partial seq ranges | Empty (cleared)."""

    kind: str  # "full" | "partial" | "empty"
    versions: Optional[Span] = None  # full: inclusive version range
    version: Optional[Version] = None  # partial
    seqs: Tuple[Span, ...] = ()  # partial: inclusive seq ranges
    ts: Optional[Timestamp] = None  # empty

    @classmethod
    def full(cls, start: int, end: int) -> "SyncNeedV1":
        return cls(kind="full", versions=(int(start), int(end)))

    @classmethod
    def partial(cls, version: int, seqs) -> "SyncNeedV1":
        return cls(kind="partial", version=Version(version), seqs=tuple(tuple(s) for s in seqs))

    @classmethod
    def empty(cls, ts: Optional[Timestamp] = None) -> "SyncNeedV1":
        return cls(kind="empty", ts=ts)

    def count(self) -> int:
        if self.kind == "full":
            assert self.versions is not None
            return self.versions[1] - self.versions[0] + 1
        return 1


@dataclass
class SyncStateV1:
    """A node's sync handshake: per-actor heads, gaps, partials, cleared ts."""

    actor_id: ActorId = field(default_factory=ActorId)
    heads: Dict[ActorId, Version] = field(default_factory=dict)
    need: Dict[ActorId, List[Span]] = field(default_factory=dict)
    partial_need: Dict[ActorId, Dict[Version, List[Span]]] = field(default_factory=dict)
    last_cleared_ts: Optional[Timestamp] = None
    # snapshot-serve extension (docs/sync.md): per-actor snapshot
    # floors — versions 1..=floor are only obtainable from this node
    # via snapshot install (their per-version bookkeeping is
    # compacted).  Empty = the pre-snapshot wire bytes, exactly.
    snap_floors: Dict[ActorId, int] = field(default_factory=dict)

    def need_len(self) -> int:
        full = sum(e - s + 1 for spans in self.need.values() for s, e in spans)
        partial_seqs = sum(
            e - s + 1
            for partials in self.partial_need.values()
            for spans in partials.values()
            for s, e in spans
        )
        # partial needs count as "chunks" at a nominal 50 seqs/chunk, like the
        # reference's need_len heuristic.
        return full + partial_seqs // 50

    def need_len_for_actor(self, actor_id: ActorId) -> int:
        full = sum(e - s + 1 for s, e in self.need.get(actor_id, []))
        return full + len(self.partial_need.get(actor_id, {}))

    def compute_available_needs(
        self, other: "SyncStateV1"
    ) -> Dict[ActorId, List[SyncNeedV1]]:
        """What WE need that OTHER can serve.

        For every actor the peer has a head for: take the versions the peer
        *fully* has (1..=head minus its own needs and partials), intersect
        with our needed ranges; offer partial-seq completion where either the
        peer has the full version or has complementary seqs of the same
        partial; and ask for everything above our head.
        """
        needs: Dict[ActorId, List[SyncNeedV1]] = {}

        def push(actor: ActorId, need: SyncNeedV1) -> None:
            needs.setdefault(actor, []).append(need)

        for actor_id, head in other.heads.items():
            if actor_id == self.actor_id or int(head) == 0:
                continue

            other_haves = RangeSet([(1, int(head))])
            for s, e in other.need.get(actor_id, []):
                other_haves.remove(s, e)
            for v in other.partial_need.get(actor_id, {}):
                other_haves.remove(int(v), int(v))

            for s, e in self.need.get(actor_id, []):
                for os_, oe in other_haves.intersection_spans(s, e):
                    push(actor_id, SyncNeedV1.full(os_, oe))

            for v, seq_spans in self.partial_need.get(actor_id, {}).items():
                if other_haves.contains(int(v)):
                    push(actor_id, SyncNeedV1.partial(int(v), seq_spans))
                    continue
                other_seqs = other.partial_need.get(actor_id, {}).get(v)
                if other_seqs is None:
                    continue
                ends = [e for _, e in other_seqs] + [e for _, e in seq_spans]
                if not ends:
                    continue
                # seqs the peer HAS within its partial = [0, max_end] minus
                # the seqs it still needs.
                other_seq_haves = RangeSet([(0, max(ends))])
                for s, e in other_seqs:
                    other_seq_haves.remove(s, e)
                overlaps = [
                    clipped
                    for s, e in seq_spans
                    for clipped in other_seq_haves.intersection_spans(s, e)
                ]
                if overlaps:
                    push(actor_id, SyncNeedV1.partial(int(v), overlaps))

            our_head = self.heads.get(actor_id)
            if our_head is None:
                push(actor_id, SyncNeedV1.full(1, int(head)))
            elif int(head) > int(our_head):
                push(actor_id, SyncNeedV1.full(int(our_head) + 1, int(head)))

        return needs
