"""Packed CRDT cell keys (port of ``corrosion_tpu/ops/keys.py``).

The cr-sqlite merge rule is a lexicographic max over ``(cl,
col_version, value)`` per cell: larger causal length wins, then larger
``col_version``, then the larger value.  The three fields pack into one
integer whose numeric order equals that lexicographic order, so every
merge — pairwise, over replicas, or on delivery — is a plain ``max``.

The default codec packs into int32; ``WIDE_CODEC`` packs into int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class KeyCodec:
    """Bit layout for packed (cl, col_version, value_rank) keys.

    value_rank must be a non-negative int that preserves the desired
    value order (the sim uses small ints directly)."""

    cl_bits: int = 4
    ver_bits: int = 13
    val_bits: int = 14

    def __post_init__(self):
        total = self.cl_bits + self.ver_bits + self.val_bits
        if total > 62:
            raise ValueError(f"key layout needs {total} bits; max is 62")

    @property
    def total_bits(self) -> int:
        return self.cl_bits + self.ver_bits + self.val_bits

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32 if self.total_bits <= 31 else torch.int64

    @property
    def max_cl(self) -> int:
        return (1 << self.cl_bits) - 1

    @property
    def max_ver(self) -> int:
        return (1 << self.ver_bits) - 1

    @property
    def max_val(self) -> int:
        return (1 << self.val_bits) - 1

    def pack(self, cl, col_version, value_rank) -> torch.Tensor:
        """Pack field tensors into one key tensor (fields must be in
        range); the result lies on the fields' device."""
        cl = torch.as_tensor(cl, dtype=self.dtype)
        ver = torch.as_tensor(col_version, dtype=self.dtype)
        val = torch.as_tensor(value_rank, dtype=self.dtype)
        return (
            (cl << (self.ver_bits + self.val_bits))
            | (ver << self.val_bits)
            | val
        )

    def unpack(self, key):
        key = torch.as_tensor(key, dtype=self.dtype)
        val = key & self.max_val
        ver = (key >> self.val_bits) & self.max_ver
        cl = (key >> (self.val_bits + self.ver_bits)) & self.max_cl
        return cl, ver, val

    def is_live(self, key) -> torch.Tensor:
        """Row live iff causal length is odd (cl parity)."""
        cl, _, _ = self.unpack(key)
        return (cl & 1) == 1


DEFAULT_CODEC = KeyCodec()

# Deeper spaces: 16-bit cl, 24-bit versions, 22-bit values.
WIDE_CODEC = KeyCodec(cl_bits=16, ver_bits=24, val_bits=22)
