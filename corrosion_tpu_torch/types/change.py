"""Change rows and the byte-budget chunker.

Parity: ``crates/corro-types/src/change.rs:19-29`` (the ``Change`` row — one
cell-level CRDT mutation), ``change.rs:63-171`` (``ChunkedChanges``: split one
version's seq-ordered change stream into ≤8 KiB messages so large
transactions ship as out-of-order reassemblable chunks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Tuple

from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq

# Per-message byte budget for broadcast and sync (change.rs:171, peer.rs:344).
MAX_CHANGES_BYTE_SIZE = 8 * 1024

# Sentinel column name used for causal-length-only (delete/resurrect) rows.
SENTINEL_CID = "-1"


@dataclass(frozen=True)
class Change:
    """One cell-level change: (table, pk) row, ``cid`` column, new value.

    ``col_version`` is the per-cell lamport clock, ``db_version`` the
    originating node's storage version, ``seq`` the position inside that
    version's change stream, ``site_id`` the originating actor, and ``cl``
    the row's causal length (odd = live, even = deleted).
    """

    table: str
    pk: bytes
    cid: str
    val: object  # None | int | float | str | bytes
    col_version: int
    db_version: CrsqlDbVersion
    seq: CrsqlSeq
    site_id: bytes
    cl: int

    def is_delete(self) -> bool:
        return self.cl % 2 == 0

    def estimated_byte_size(self) -> int:
        # Mirrors the reference's struct-size + heap-payload estimate used for
        # the 8 KiB budget; exact bytes don't matter, stable accounting does.
        val = self.val
        if isinstance(val, (bytes, bytearray)):
            vsize = len(val)
        elif isinstance(val, str):
            vsize = len(val.encode("utf-8"))
        elif val is None:
            vsize = 1
        else:
            vsize = 8
        return 64 + len(self.table) + len(self.pk) + len(self.cid) + vsize


class ChunkedChanges:
    """Iterate ``(changes, seq_range)`` chunks under a byte budget.

    Yields ``(list_of_changes, (start_seq, end_seq))`` where the seq range is
    *inclusive* and contiguous with the next chunk's range; the final chunk's
    range always extends to ``last_seq`` so receivers can detect completion
    even when trailing changes were elided (empty iterators still yield one
    empty chunk covering the whole range, as the reference does for
    cleared-version serving).
    """

    def __init__(
        self,
        changes: Iterable[Change],
        start_seq: int,
        last_seq: int,
        max_buf_size: int = MAX_CHANGES_BYTE_SIZE,
    ):
        self._iter = iter(changes)
        self._next_start = CrsqlSeq(start_seq)
        self._last_seq = CrsqlSeq(last_seq)
        self._max_buf_size = max_buf_size
        self._done = False

    def __iter__(self) -> Iterator[Tuple[List[Change], Tuple[CrsqlSeq, CrsqlSeq]]]:
        # One-shot: a second iteration would restart the seq accounting from
        # the original start and emit ranges that omit already-yielded rows.
        if self._done:
            raise RuntimeError("ChunkedChanges can only be iterated once")
        self._done = True
        buf: List[Change] = []
        buf_size = 0
        start = self._next_start
        _end = object()
        nxt = next(self._iter, _end)
        while nxt is not _end:
            change = nxt
            nxt = next(self._iter, _end)
            buf.append(change)
            buf_size += change.estimated_byte_size()
            if int(change.seq) >= int(self._last_seq):
                # the advertised range ends here: trailing rows beyond
                # last_seq are elided, never emitted outside the range
                # (change.rs test_change_chunker, last_seq==0 scenario)
                break
            if buf_size >= self._max_buf_size and nxt is not _end:
                # flush on budget only when more rows are coming — an
                # exhausted iterator folds into the final chunk whose
                # range extends to last_seq (gap-absorption semantics)
                yield buf, (start, change.seq)
                start = change.seq.succ()
                buf = []
                buf_size = 0
        yield buf, (start, self._last_seq)
