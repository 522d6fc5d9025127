"""Bit-exact twin of the ``jax.random`` subset the simulator draws from.

The reference runs ``jax.random`` with the threefry2x32 generator and
``jax_threefry_partitionable=True``.  Under that setting every sampler
is a pure function of (key, row-major flat index of the output
element), so this module reproduces the reference's bits exactly and
the port can be held to it bitwise, tick by tick:

* ``PRNGKey(seed)`` is ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``,
  and ``split(key, num)[i]`` hashes ``(0, i)`` — the same value;
* ``bits(key, shape)[i]`` hashes ``(i >> 32, i & 0xFFFFFFFF)`` and
  returns the XOR of the two output words;
* ``uniform`` keeps the top 23 bits as a float32 mantissa in [1, 2) and
  subtracts 1;
* ``randint`` folds two bit streams (keys ``split(key)``) into the span
  with JAX's 32-bit multiplier, wrap-arounds included.

Keys are ``uint32[2]`` tensors on the host: deriving one is 20 rounds
on two words, and the sampling kernel takes the words as launch
arguments.  The samplers fill tensors on the requested device through
``kernels.threefry`` (the CUDA kernel for a card, its plain version for
the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.kernels.threefry import (
    MASK32,
    threefry2x32,
    threefry_bits,
)


def key_words(key) -> tuple:
    """(k0, k1) Python ints of a ``uint32[2]`` key tensor or array."""
    if isinstance(key, torch.Tensor):
        words = key.reshape(-1).tolist()
    else:
        words = np.asarray(key).reshape(-1).tolist()
    if len(words) != 2:
        raise ValueError(f"a key has two uint32 words, got {words!r}")
    return int(words[0]) & MASK32, int(words[1]) & MASK32


def _key(k0: int, k1: int) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.uint32)


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 - mirrors jax.random
    """Key of an int32 seed, as ``jax.random.PRNGKey`` builds it."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return _key(0, seed & MASK32)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, data)."""
    k0, k1 = key_words(key)
    return _key(*threefry2x32(k0, k1, 0, int(data) & MASK32))


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``[num, 2]`` keys, row i the
    hash of the counter pair (0, i)."""
    k0, k1 = key_words(key)
    rows = [threefry2x32(k0, k1, i >> 32, i & MASK32) for i in range(num)]
    return torch.tensor(rows, dtype=torch.uint32).reshape(num, 2)


def bits(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.bits``: uint32 words of the given shape."""
    out = torch.empty(shape, dtype=torch.uint32, device=resolve_device(device))
    threefry_bits(out, key_words(key))
    return out


def uniform(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    out = torch.empty(shape, dtype=torch.float32,
                      device=resolve_device(device))
    threefry_bits(out, key_words(key))
    return out


def randint_span(minval: int, maxval: int) -> tuple:
    """(span, multiplier) of ``jax.random.randint`` for int32 output:
    span = maxval - minval (1 when empty), multiplier = (2**16 % span)**2
    % span in uint32 arithmetic — the square wraps to 0 once span >
    2**16, so the high draw then contributes nothing, exactly as in the
    reference (jax/_src/random.py ``_randint``)."""
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise OverflowError("randint bounds must fit int32")
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (((2**16 % span) ** 2) & MASK32) % span
    return span, mult


def randint(key, shape, minval: int, maxval: int,
            device="cuda") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)``: int32."""
    span, mult = randint_span(int(minval), int(maxval))
    hi_key, lo_key = split(key)
    out = torch.empty(shape, dtype=torch.int32, device=resolve_device(device))
    threefry_bits(out, key_words(hi_key), key_words(lo_key), span=span,
                  mult=mult, minval=int(minval))
    return out
