"""``seg_argsort``: the stable argsort of integer keys within equal
segments (csrc/seg_sort.cu).

Replaces ``jnp.argsort`` in corrosion_tpu/models/broadcast.py
``_perm_senders`` (:321) and the two stable lexsorts of
corrosion_tpu/ops/merge.py ``_winners_jax_core`` (:618, :657).  Keys
are uint32 (the headline's raw threefry bits, ``shift`` 9 giving the
23-bit scores) or non-negative int64 (the merge's ordinals, one
segment).  Segments of up to 4096 sort as unique (key, index)
composites in shared memory; longer ones by a stable LSD radix sort
with 8-bit digits.  Bound on the H100: bytes, the keys read and the
int32 indices written once.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels

SMALL_MAX = 4096  # the longest segment the shared-memory sort takes
# positions a radix block ranks, by key type (csrc ``Tile``)
RADIX_TILE = {torch.uint32: 4096, torch.int64: 2048}
_WIDTH = {torch.uint32: 32, torch.int64: 63}
_SMALL_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)
_RADIX_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)


def _check_args(keys: torch.Tensor, key_bits: int, shift: int) -> None:
    width = _WIDTH.get(keys.dtype)
    if width is None:
        raise ValueError(f"seg_argsort: keys must be uint32 or int64, got "
                         f"{keys.dtype}")
    if keys.dim() != 2:
        raise ValueError("seg_argsort: keys must be [segments, length]")
    if not (0 <= key_bits and 0 <= shift and key_bits + shift <= width):
        raise ValueError(f"seg_argsort: {key_bits} key bits above a shift "
                         f"of {shift} do not fit {keys.dtype}")


def seg_argsort_plain(keys: torch.Tensor, key_bits: int,
                      shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort(stable=True)`` of
    ``keys >> shift`` (through int64, which takes the shift on the CPU)
    per row, indices as int32."""
    _check_args(keys, key_bits, shift)
    k = keys.to(torch.int64) >> shift
    return torch.sort(k, dim=1, stable=True).indices.to(torch.int32)


def seg_argsort(keys: torch.Tensor, key_bits: int,
                shift: int = 0) -> torch.Tensor:
    """[S, L] int32: for each row of ``keys`` ([S, L] uint32 or
    non-negative int64) the stable argsort of ``keys >> shift``, which
    the caller promises is below ``2 ** key_bits`` (a wider key sorts
    wrong on the card).  Ties keep index order, as ``jnp.argsort`` and
    ``np.argsort(kind="stable")`` do."""
    if kernels.on_cpu(keys):
        return seg_argsort_plain(keys, key_bits, shift)
    _check_args(keys, key_bits, shift)
    kernels.check("seg_argsort keys", keys, keys.dtype,
                  align=keys.element_size())
    s, length = keys.shape
    out = torch.empty((s, length), dtype=torch.int32, device=keys.device)
    if out.numel() == 0:
        return out
    wide = int(keys.dtype == torch.int64)
    lbits = max(0, (length - 1).bit_length())
    pt = kernels.ptr
    if length <= SMALL_MAX and key_bits + lbits <= 64:
        fn = kernels.function("seg_sort", "seg_sort_small_launch",
                              _SMALL_ARGTYPES)
        code = fn(pt(keys), wide, pt(out), s, length, 1 << lbits, lbits,
                  shift, int(key_bits + lbits > 32), kernels.stream(keys))
    else:
        n = s * length
        two_bufs = key_bits > 8
        kbuf = torch.empty(2 * n if two_bufs else 0, dtype=keys.dtype,
                           device=keys.device)
        vbuf = torch.empty(2 * n if two_bufs else 0, dtype=torch.int32,
                           device=keys.device)
        tiles = -(-length // RADIX_TILE[keys.dtype])
        hist = torch.empty(s * 256 * (tiles + 1), dtype=torch.int32,
                           device=keys.device)
        ka, kb = (kbuf[:n], kbuf[n:]) if two_bufs else (None, None)
        va, vb = (vbuf[:n], vbuf[n:]) if two_bufs else (None, None)
        fn = kernels.function("seg_sort", "seg_sort_radix_launch",
                              _RADIX_ARGTYPES)
        code = fn(pt(keys), wide, pt(out), s, length, key_bits, shift,
                  pt(ka), pt(kb), pt(va), pt(vb), pt(hist),
                  kernels.stream(keys))
    seg_argsort.launches += 1
    kernels.raise_on_error("seg_argsort", code)
    return out


seg_argsort.launches = 0
