"""Stable binary codec for primary keys and a total order over SQL values.

Parity targets:

* the reference packs multi-column primary keys into a single blob for
  wire transport and subscription bookkeeping
  (``crates/corro-types/src/pubsub.rs:2302-2449``);
* cr-sqlite's merge tie-break needs a total order over SQLite values
  ("biggest value wins", ``doc/crdts.md:13-16``).  Empirically (pinned by
  tests/test_crsqlite_golden.py against the vendored extension), cr-sqlite
  does NOT use SQLite's ORDER BY cross-type order: it compares the
  ``sqlite3_value_type`` enum first, where a *smaller* enum wins —
  INTEGER > FLOAT > TEXT > BLOB > NULL — and only compares
  numerically/bytewise within one type.

The codec here is our own format (tag byte + big-endian payload) chosen so
that packed blobs are self-describing and roundtrip exactly.
"""

from __future__ import annotations

import struct
from typing import Iterable, List

SqlValue = object  # None | int | float | str | bytes

_T_NULL = 0
_T_INT = 1
_T_REAL = 2
_T_TEXT = 3
_T_BLOB = 4


def _type_rank(v: SqlValue) -> int:
    """cr-sqlite tie-break rank: NULL < BLOB < TEXT < REAL < INTEGER.

    This is the inverse of the ``sqlite3_value_type`` enum (INTEGER=1,
    FLOAT=2, TEXT=3, BLOB=4, NULL=5): cr-sqlite's merge treats the value
    with the smaller type enum as "bigger".  Pinned empirically against
    the vendored extension in tests/test_crsqlite_golden.py — note this
    differs from SQLite's ORDER BY order (NULL < numeric < text < blob).
    """
    if v is None:
        return 0
    if isinstance(v, bool):
        return 4  # bools bind as INTEGER
    if isinstance(v, int):
        return 4
    if isinstance(v, float):
        return 3
    if isinstance(v, str):
        return 2
    if isinstance(v, (bytes, bytearray, memoryview)):
        return 1
    raise TypeError(f"unsupported SQL value: {type(v)!r}")


def value_cmp(a: SqlValue, b: SqlValue) -> int:
    """cr-sqlite merge-tie-break comparison (see :func:`_type_rank`)."""
    ra, rb = _type_rank(a), _type_rank(b)
    if ra != rb:
        return -1 if ra < rb else 1
    if ra == 0:
        return 0
    if ra in (3, 4):
        return (a > b) - (a < b)
    if ra == 2:
        ab, bb = a.encode("utf-8"), b.encode("utf-8")
        return (ab > bb) - (ab < bb)
    ab, bb = bytes(a), bytes(b)
    return (ab > bb) - (ab < bb)


def jsonable_row(row: Iterable) -> List:
    """Coerce a SQL result row for JSON transport (bytes -> hex)."""
    out: List = []
    for v in row:
        if isinstance(v, (bytes, bytearray, memoryview)):
            out.append(bytes(v).hex())
        else:
            out.append(v)
    return out


def pack_values(values: Iterable[SqlValue]) -> bytes:
    """Pack a tuple of SQL values into one self-describing blob."""
    out = bytearray()
    for v in values:
        if v is None:
            out.append(_T_NULL)
        elif isinstance(v, bool):
            out.append(_T_INT)
            out += struct.pack(">q", int(v))
        elif isinstance(v, int):
            out.append(_T_INT)
            try:
                out += struct.pack(">q", v)
            except struct.error:
                # same exception type as the native kernel
                raise OverflowError("int too large for packed i64") from None
        elif isinstance(v, float):
            out.append(_T_REAL)
            out += struct.pack(">d", v)
        elif isinstance(v, str):
            b = v.encode("utf-8")
            out.append(_T_TEXT)
            out += struct.pack(">I", len(b)) + b
        elif isinstance(v, (bytes, bytearray, memoryview)):
            b = bytes(v)
            out.append(_T_BLOB)
            out += struct.pack(">I", len(b)) + b
        else:
            raise TypeError(f"unsupported SQL value: {type(v)!r}")
    return bytes(out)


def unpack_values(blob: bytes) -> List[SqlValue]:
    """Inverse of :func:`pack_values`."""
    out: List[SqlValue] = []
    i = 0
    n = len(blob)
    while i < n:
        tag = blob[i]
        i += 1
        if tag == _T_NULL:
            out.append(None)
        elif tag == _T_INT:
            if i + 8 > n:
                raise ValueError("truncated packed value")
            (v,) = struct.unpack_from(">q", blob, i)
            i += 8
            out.append(v)
        elif tag == _T_REAL:
            if i + 8 > n:
                raise ValueError("truncated packed value")
            (v,) = struct.unpack_from(">d", blob, i)
            i += 8
            out.append(v)
        elif tag in (_T_TEXT, _T_BLOB):
            if i + 4 > n:
                raise ValueError("truncated packed value")
            (ln,) = struct.unpack_from(">I", blob, i)
            i += 4
            raw = blob[i : i + ln]
            if len(raw) != ln:
                raise ValueError("truncated packed value")
            i += ln
            out.append(raw.decode("utf-8") if tag == _T_TEXT else raw)
        else:
            raise ValueError(f"bad tag {tag} at offset {i-1}")
    return out


# keep the Python twins importable for cross-checking, then prefer the
# native kernels (corrosion_tpu_torch/native) — these run inside the CRR
# triggers on every row write, so the constant factor matters
_py_pack_values = pack_values
_py_unpack_values = unpack_values
_py_value_cmp = value_cmp

from corrosion_tpu_torch.native import load_or_none as _load_native

_native = _load_native()
if _native is not None:
    pack_values = _native.pack_values  # type: ignore[assignment]
    unpack_values = _native.unpack_values  # type: ignore[assignment]
    value_cmp = _native.value_cmp  # type: ignore[assignment]
