"""``seg_argsort``: the stable argsort of integer keys within equal
segments, as flat indices into the input (csrc/seg_sort.cu).

Replaces ``jnp.argsort`` in corrosion_tpu/models/broadcast.py
``_perm_senders`` (:321) and the two stable lexsorts of
corrosion_tpu/ops/merge.py ``_winners_jax_core`` (:618, :657).  Keys
are uint32 (the headline's raw threefry bits, ``shift`` 9 giving the
23-bit scores) or non-negative int64 (the merge's ordinals, one
segment).  Segments of up to 256 sort as unique (key, index) composites
in a warp's registers, up to 4096 in shared memory; longer ones by a
one-sweep stable LSD radix sort with 8-bit digits.  Bound on the H100:
bytes, the keys read and the int32 indices written once.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels

SMALL_MAX = 4096  # the longest segment the composite sorts take
RADIX_TILE = 4096  # positions a radix block ranks (csrc ``TILE``)
RADIX_BITS = 8  # the radix regime's digit width (csrc ``RADIX_BITS``)
MAX_FLAT = 2**31  # S * L must stay below: the indices are int32
_WIDTH = {torch.uint32: 32, torch.int64: 63}
_SMALL_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_RADIX_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
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
    if keys.numel() >= MAX_FLAT:
        raise ValueError(f"seg_argsort: {list(keys.shape)} has 2**31 or "
                         "more elements, past the int32 flat index")


def seg_argsort_plain(keys: torch.Tensor, key_bits: int,
                      shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort(stable=True)`` of
    ``keys >> shift`` (through int64, which takes the shift on the CPU)
    per row, as int32 flat indices ``row * L + local``."""
    _check_args(keys, key_bits, shift)
    s, length = keys.shape
    k = keys.to(torch.int64) >> shift
    local = torch.sort(k, dim=1, stable=True).indices
    row0 = torch.arange(s, dtype=torch.int64, device=keys.device) * length
    return (local + row0[:, None]).to(torch.int32)


def _radix_scratch(keys: torch.Tensor, key_bits: int):
    """The radix regime's scratch for ``keys``: (the int32 words the
    launch zeroes, two key buffers, two index buffers); the buffers are
    None for a one-pass sort."""
    s, length = keys.shape
    passes = max(1, -(-key_bits // RADIX_BITS))
    bins = 1 << RADIX_BITS
    tiles = -(-length // RADIX_TILE)
    dev = keys.device
    zero = torch.empty(s * passes * bins * (1 + tiles) + passes,
                       dtype=torch.int32, device=dev)
    if passes == 1:
        return zero, None, None, None, None
    n = s * length
    kbuf = torch.empty(2 * n, dtype=keys.dtype, device=dev)
    vbuf = torch.empty(2 * n, dtype=torch.int32, device=dev)
    return zero, kbuf[:n], kbuf[n:], vbuf[:n], vbuf[n:]


def seg_argsort(keys: torch.Tensor, key_bits: int,
                shift: int = 0) -> torch.Tensor:
    """[S, L] int32: for each row of ``keys`` ([S, L] uint32 or
    non-negative int64, S * L < 2**31) the stable argsort of
    ``keys >> shift``, which the caller promises is below
    ``2 ** key_bits`` (a wider key sorts wrong on the card), as flat
    indices ``row * L + local`` into ``keys``: for one row, the local
    indices.  Ties keep index order, as ``jnp.argsort`` and
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
    lbits = max(0, (length - 1).bit_length())
    if length <= SMALL_MAX and key_bits + lbits <= 64:
        fn = kernels.function("seg_sort", "seg_sort_small_launch",
                              _SMALL_ARGTYPES)
        code = fn(kernels.ptr(keys), int(keys.dtype == torch.int64),
                  kernels.ptr(out), s, length, lbits, shift,
                  int(key_bits + lbits > 32), kernels.stream(keys))
    else:
        fn = kernels.function("seg_sort", "seg_sort_radix_launch",
                              _RADIX_ARGTYPES)
        code = fn(kernels.ptr(keys), int(keys.dtype == torch.int64),
                  kernels.ptr(out), s, length, key_bits, shift,
                  *(kernels.ptr(t) for t in _radix_scratch(keys, key_bits)),
                  kernels.stream(keys))
    seg_argsort.launches += 1
    kernels.raise_on_error("seg_argsort", code)
    return out


seg_argsort.launches = 0
