"""Changesets — the unit of dissemination.

Parity: ``crates/corro-types/src/broadcast.rs:104-137`` — ``ChangeV1`` wraps
an actor id plus a ``Changeset`` with three variants: ``Empty`` (versions
cleared/overwritten), ``Full`` (a version's changes with seq range, last_seq
and ts) and ``EmptySet`` (many cleared ranges with a timestamp).  A ``Full``
changeset whose seq range doesn't reach ``last_seq`` is *partial* and gets
buffered until the gaps arrive.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Version, CrsqlSeq
from corrosion_tpu_torch.types.change import Change
from corrosion_tpu_torch.types.hlc import Timestamp


class ChangeSource(enum.Enum):
    BROADCAST = "broadcast"
    SYNC = "sync"


class ChangesetKind(enum.Enum):
    FULL = "full"
    EMPTY = "empty"
    EMPTY_SET = "empty_set"


@dataclass(frozen=True)
class Changeset:
    """Tagged union with an explicit variant tag.

    * FULL:      ``version`` + ``changes`` + ``seqs`` + ``last_seq`` + ``ts``.
    * EMPTY:     ``versions`` range cleared, optional ``ts``.
    * EMPTY_SET: ``ranges`` (cleared version ranges, may be empty) + ``ts``.
    """

    kind: ChangesetKind
    # Full
    version: Optional[Version] = None
    changes: Tuple[Change, ...] = ()
    seqs: Optional[Tuple[CrsqlSeq, CrsqlSeq]] = None  # inclusive
    last_seq: Optional[CrsqlSeq] = None
    ts: Optional[Timestamp] = None
    # Empty
    versions: Optional[Tuple[Version, Version]] = None  # inclusive range
    # EmptySet
    ranges: Tuple[Tuple[Version, Version], ...] = ()

    @classmethod
    def full(
        cls,
        version: Version,
        changes,
        seqs: Tuple[CrsqlSeq, CrsqlSeq],
        last_seq: CrsqlSeq,
        ts: Timestamp,
    ) -> "Changeset":
        return cls(
            kind=ChangesetKind.FULL,
            version=version,
            changes=tuple(changes),
            seqs=seqs,
            last_seq=last_seq,
            ts=ts,
        )

    @classmethod
    def empty(
        cls, versions: Tuple[Version, Version], ts: Optional[Timestamp] = None
    ) -> "Changeset":
        return cls(kind=ChangesetKind.EMPTY, versions=versions, ts=ts)

    @classmethod
    def empty_set(cls, ranges, ts: Timestamp) -> "Changeset":
        return cls(
            kind=ChangesetKind.EMPTY_SET,
            ranges=tuple(tuple(r) for r in ranges),
            ts=ts,
        )

    @property
    def is_full(self) -> bool:
        return self.kind is ChangesetKind.FULL

    @property
    def is_empty_variant(self) -> bool:
        return self.kind is ChangesetKind.EMPTY

    @property
    def is_empty_set(self) -> bool:
        return self.kind is ChangesetKind.EMPTY_SET

    def is_complete(self) -> bool:
        """A Full changeset is complete iff its seq range covers 0..=last_seq."""
        if not self.is_full:
            return True
        assert self.seqs is not None and self.last_seq is not None
        return int(self.seqs[0]) == 0 and int(self.seqs[1]) == int(self.last_seq)

    def max_db_version(self) -> int:
        return max((int(c.db_version) for c in self.changes), default=0)


@dataclass(frozen=True)
class ChangeV1:
    """Wire change message: originating actor + changeset."""

    actor_id: ActorId
    changeset: Changeset
