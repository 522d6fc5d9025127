"""Inclusive integer range sets — the backbone of version/gap bookkeeping.

Parity: the reference leans on ``rangemap::RangeInclusiveSet`` everywhere
(needed-version gaps in ``BookedVersions``, seq gaps in partial versions,
cleared-version tracking; e.g. ``crates/corro-types/src/agent.rs:1393-1578``,
``sync.rs:127-248``).  This is our own implementation: a sorted list of
disjoint inclusive ``[start, end]`` spans that coalesces touching spans
(integers are discrete, so ``[1,5]`` + ``[6,9]`` → ``[1,9]``), with the
operations the sync/bookkeeping algebra needs: insert, remove, overlap
query, gap enumeration.

Host-side this is exact; the simulator mirrors it with dense bitmaps in
:mod:`corrosion_tpu_torch.ops.intervals`.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Iterable, Iterator, List, Tuple

Span = Tuple[int, int]  # inclusive


class RangeSet:
    """Set of integers stored as sorted disjoint inclusive spans."""

    __slots__ = ("_starts", "_ends")

    def __init__(self, spans: Iterable[Span] = ()):
        self._starts: List[int] = []
        self._ends: List[int] = []
        for s, e in spans:
            self.insert(s, e)

    # -- construction -----------------------------------------------------

    def copy(self) -> "RangeSet":
        new = RangeSet()
        new._starts = list(self._starts)
        new._ends = list(self._ends)
        return new

    def insert(self, start: int, end: int) -> None:
        """Insert inclusive [start, end], coalescing with touching spans."""
        if end < start:
            raise ValueError(f"invalid span [{start}, {end}]")
        # find spans overlapping or adjacent to [start-1, end+1]
        lo = bisect_left(self._ends, start - 1)
        hi = bisect_right(self._starts, end + 1)
        if lo < hi:
            start = min(start, self._starts[lo])
            end = max(end, self._ends[hi - 1])
        self._starts[lo:hi] = [start]
        self._ends[lo:hi] = [end]

    def remove(self, start: int, end: int) -> None:
        """Remove all integers in inclusive [start, end]."""
        if end < start:
            raise ValueError(f"invalid span [{start}, {end}]")
        lo = bisect_left(self._ends, start)
        hi = bisect_right(self._starts, end)
        if lo >= hi:
            return
        new_starts: List[int] = []
        new_ends: List[int] = []
        if self._starts[lo] < start:
            new_starts.append(self._starts[lo])
            new_ends.append(start - 1)
        if self._ends[hi - 1] > end:
            new_starts.append(end + 1)
            new_ends.append(self._ends[hi - 1])
        self._starts[lo:hi] = new_starts
        self._ends[lo:hi] = new_ends

    def insert_all(self, other: "RangeSet") -> None:
        for s, e in other:
            self.insert(s, e)

    def remove_all(self, other: "RangeSet") -> None:
        for s, e in other:
            self.remove(s, e)

    # -- queries ----------------------------------------------------------

    def __iter__(self) -> Iterator[Span]:
        return iter(zip(self._starts, self._ends))

    def __len__(self) -> int:
        return len(self._starts)

    def __bool__(self) -> bool:
        return bool(self._starts)

    def __eq__(self, other) -> bool:
        if not isinstance(other, RangeSet):
            return NotImplemented
        return self._starts == other._starts and self._ends == other._ends

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"RangeSet({[(s, e) for s, e in self]})"

    def spans(self) -> List[Span]:
        return list(self)

    def contains(self, value: int) -> bool:
        i = bisect_right(self._starts, value) - 1
        return i >= 0 and value <= self._ends[i]

    def contains_span(self, start: int, end: int) -> bool:
        """True iff the whole inclusive [start, end] is in one stored span."""
        i = bisect_right(self._starts, start) - 1
        return i >= 0 and end <= self._ends[i]

    def overlapping(self, start: int, end: int) -> Iterator[Span]:
        """Stored spans intersecting inclusive [start, end]."""
        lo = bisect_left(self._ends, start)
        hi = bisect_right(self._starts, end)
        for i in range(lo, hi):
            yield self._starts[i], self._ends[i]

    def intersection_spans(self, start: int, end: int) -> List[Span]:
        """Overlaps clipped to [start, end]."""
        return [
            (max(s, start), min(e, end)) for s, e in self.overlapping(start, end)
        ]

    def gaps(self, start: int, end: int) -> List[Span]:
        """Maximal spans of [start, end] NOT covered by this set."""
        out: List[Span] = []
        cursor = start
        for s, e in self.overlapping(start, end):
            if s > cursor:
                out.append((cursor, s - 1))
            cursor = max(cursor, e + 1)
            if cursor > end:
                break
        if cursor <= end:
            out.append((cursor, end))
        return out

    def count(self) -> int:
        """Total number of integers covered."""
        return sum(e - s + 1 for s, e in self)

    def min(self):
        return self._starts[0] if self._starts else None

    def max(self):
        return self._ends[-1] if self._ends else None
