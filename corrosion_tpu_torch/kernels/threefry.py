"""``threefry_bits``: the counter-based random draws (csrc/threefry.cu).

Replaces ``jax.random``'s partitionable threefry2x32 sampling
(jax/_src/prng.py ``_threefry_random_bits_partitionable``) with the
``uniform`` and ``randint`` epilogues of jax/_src/random.py fused in.
The output tensor's dtype picks the epilogue: ``uint32`` raw bits,
``float32`` a uniform in [0, 1), ``int32`` a randint (second key,
span, multiplier and minval given).

Bound on the H100: integer operations (about 70 per hash, two hashes
per randint word) rather than the 4 bytes written per word.  See the
source for the design.  The kernel takes randint's remainders by
Lemire's fastmod: ``fastmod_m`` is the constant the host computes once
a call and ``fastmod`` the remainder the kernel computes, both twinned
here for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels

MASK32 = 0xFFFFFFFF
MASK64 = 2**64 - 1
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MODES = {torch.uint32: 0, torch.float32: 1, torch.int32: 2}
# csrc/threefry.cu U: the consecutive words a thread makes a loop trip
WORDS_A_THREAD = 4
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py
    ``_threefry2x32_lowering``) on Python ints, or on int64 tensors
    holding uint32 values (every sum is masked to 32 bits)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fastmod_m(span: int) -> int:
    """Lemire's fastmod constant of ``span`` in [1, 2**32): floor((2**64
    - 1) / span) + 1 in 64 bits (0 for span 1)."""
    return ((MASK64 // span) + 1) & MASK64


def fastmod(a: int, m: int, span: int) -> int:
    """``a % span`` for a uint32 ``a``, as the kernel computes it: the
    high 64 bits of (m * a mod 2**64) * span, m = ``fastmod_m(span)``."""
    return (((m * a) & MASK64) * span) >> 64


def threefry_bits_plain(out: torch.Tensor, key, key2=None, span: int = 0,
                        mult: int = 0, minval: int = 0) -> torch.Tensor:
    """Plain PyTorch version: uint32 emulated in int64 with masks."""
    i = torch.arange(out.numel(), dtype=torch.int64, device=out.device)
    hi, lo = i >> 32, i & MASK32
    x0, x1 = threefry2x32(key[0], key[1], hi, lo)
    b = x0 ^ x1
    dst = out
    if out.dtype == torch.uint32:
        # written through an int32 view: uint32 tensors take few ops
        res = torch.where(b >= 2**31, b - 2**32, b)
        dst = out.view(torch.int32)
    elif out.dtype == torch.float32:
        # (bits >> 9) as a mantissa of [1, 2) minus 1 is exactly
        # (bits >> 9) * 2**-23
        res = (b >> 9).to(torch.float32) * 2.0**-23
    else:
        y0, y1 = threefry2x32(key2[0], key2[1], hi, lo)
        lb = y0 ^ y1
        off = ((((b % span) * mult) & MASK32) + lb % span) & MASK32
        res = minval + off % span
    dst.copy_(res.reshape(out.shape))
    return out


def launch(out: torch.Tensor, key, key2=None, span: int = 0, mult: int = 0,
           minval: int = 0, index64: bool = False) -> None:
    """One launch of the kernel on the CUDA tensor ``out`` (no count);
    ``index64`` takes the 64-bit group index even where 32 bits do."""
    mode = _MODES[out.dtype]
    kernels.check("threefry_bits", out, out.dtype)
    kb = key2 if key2 is not None else (0, 0)
    m = fastmod_m(span) if mode == 2 else 0
    fn = kernels.function("threefry", "threefry_launch", _ARGTYPES)
    code = fn(kernels.ptr(out), out.numel(), key[0], key[1], kb[0], kb[1],
              mode, span, mult, minval, m, int(index64), kernels.stream(out))
    kernels.raise_on_error("threefry_bits", code)


def threefry_bits(out: torch.Tensor, key, key2=None, span: int = 0,
                  mult: int = 0, minval: int = 0) -> torch.Tensor:
    """Fill ``out`` with the draws of ``key`` (two uint32 ints) at every
    flat index; the epilogue follows ``out.dtype`` (module docstring).
    ``key2``/``span``/``mult``/``minval`` are randint's."""
    mode = _MODES.get(out.dtype)
    if mode is None:
        raise ValueError(f"threefry_bits: no epilogue for {out.dtype}")
    if mode == 2 and (key2 is None or not 1 <= span <= MASK32):
        raise ValueError("threefry_bits: randint needs key2 and a span in "
                         "[1, 2**32)")
    if kernels.on_cpu(out):
        return threefry_bits_plain(out, key, key2, span, mult, minval)
    launch(out, key, key2, span, mult, minval)
    threefry_bits.launches += 1
    return out


threefry_bits.launches = 0
