"""bincode 1.3 ``DefaultOptions`` primitives.

The reference's SWIM layer serializes foca protocol types with
``bincode::DefaultOptions::new()``
(``crates/corro-agent/src/broadcast/mod.rs:141``), i.e. bincode 1.3.3
(workspace ``Cargo.toml:15``) in its *varint* configuration:

* u8/i8: one raw byte;
* u16/u32/u64: varint — values ``0..=250`` as a single byte, then a
  marker byte ``251``/``252``/``253`` followed by the value as
  little-endian u16/u32/u64 (smallest width that fits);
* i16/i32/i64: zigzag-mapped to unsigned, then varint;
* enum discriminants: u32 varint;
* ``serialize_bytes``/Vec/String: u64-varint length + raw bytes;
* fixed arrays and tuples/structs: fields back-to-back, no framing;
* Option: one 0/1 byte, then the value.

This module implements exactly that spec; ``bridge/foca.py`` builds the
foca/Actor types on top.
"""

from __future__ import annotations

import struct
from typing import List


class BincodeError(ValueError):
    pass


class BWriter:
    def __init__(self):
        self._parts: List[bytes] = []

    def u8(self, v: int) -> "BWriter":
        if not 0 <= v <= 0xFF:
            raise BincodeError(f"u8 out of range: {v}")
        self._parts.append(bytes((v,)))
        return self

    def varint(self, v: int) -> "BWriter":
        """Unsigned varint (u16/u32/u64/usize/discriminant/length)."""
        if v < 0:
            raise BincodeError(f"negative unsigned: {v}")
        if v <= 250:
            self._parts.append(bytes((v,)))
        elif v <= 0xFFFF:
            self._parts.append(b"\xfb" + struct.pack("<H", v))
        elif v <= 0xFFFF_FFFF:
            self._parts.append(b"\xfc" + struct.pack("<I", v))
        elif v <= 0xFFFF_FFFF_FFFF_FFFF:
            self._parts.append(b"\xfd" + struct.pack("<Q", v))
        else:
            raise BincodeError(f"u64 out of range: {v}")
        return self

    def signed_varint(self, v: int) -> "BWriter":
        """Zigzag + varint (i16/i32/i64)."""
        return self.varint((v << 1) ^ (v >> 63) if v >= -(1 << 63)
                           else self._range_err(v))

    def _range_err(self, v):
        raise BincodeError(f"i64 out of range: {v}")

    def raw(self, b: bytes) -> "BWriter":
        self._parts.append(bytes(b))
        return self

    def lp_bytes(self, b: bytes) -> "BWriter":
        """serialize_bytes: u64-varint length + raw bytes."""
        return self.varint(len(b)).raw(b)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class BReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = bytes(data)
        self.pos = pos

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise BincodeError(
                f"unexpected EOF at {self.pos}+{n} of {len(self.data)}"
            )
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def varint(self) -> int:
        b = self.u8()
        if b <= 250:
            return b
        if b == 251:
            return struct.unpack("<H", self._take(2))[0]
        if b == 252:
            return struct.unpack("<I", self._take(4))[0]
        if b == 253:
            return struct.unpack("<Q", self._take(8))[0]
        raise BincodeError(f"unsupported varint marker {b} (u128?)")

    def signed_varint(self) -> int:
        u = self.varint()
        return (u >> 1) ^ -(u & 1)

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def lp_bytes(self) -> bytes:
        return self._take(self.varint())
