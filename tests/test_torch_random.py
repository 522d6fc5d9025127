"""The port's threefry twin against ``jax.random``, bit for bit.

Every draw of the simulator's tick goes through these samplers, so the
per-tick bitwise parity of the port rests on them.  Shapes and ranges
are the ones the path uses: [N, K] loss draws, [N/b, b] permutation
scores, [N, P] sync peer offsets and ring0 window offsets."""

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu_torch import random as trandom
from corrosion_tpu_torch.convert import key_from_numpy, key_to_numpy

SEEDS = [0, 1, 42, 2**31 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_match_jax(seed):
    jk = _jkey(seed)
    tk = trandom.PRNGKey(seed)
    np.testing.assert_array_equal(key_to_numpy(tk), np.asarray(jk))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            trandom.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num)),
        )
    for d in (0, 1, 17, 191, 2**32 - 1):
        np.testing.assert_array_equal(
            key_to_numpy(trandom.fold_in(tk, d)),
            np.asarray(jax.random.fold_in(jk, d)),
        )


@pytest.mark.parametrize("shape", [(7,), (16, 4), (3, 250)])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_bits_match_jax(seed, shape):
    got = trandom.bits(trandom.PRNGKey(seed), shape, device="cpu")
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    want = np.asarray(jax.random.bits(_jkey(seed), shape))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1000, 4), (4, 250), (3, 1000), (1,)])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_uniform_matches_jax(seed, shape):
    key = jax.random.fold_in(_jkey(seed), 3)
    got = trandom.uniform(key_from_numpy(key), shape, device="cpu")
    want = np.asarray(jax.random.uniform(key, shape))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,lo,hi", [
    ((1024, 1), 1, 1024),       # sync peer offsets, one universe
    ((500, 2), 1, 100_000),     # headline universe: span > 2**16
    ((777,), 1, 257),           # ring0 sliding-window offsets
    ((300,), -10, 70_000),      # negative minval
    ((64,), 0, 2**16 + 1),      # span just past the multiplier wrap
    ((64,), 0, 2**16),          # span at it
    ((64,), 5, 5),              # empty range -> minval
    ((33,), 1, 2),              # u = 1 peer draw
])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_randint_matches_jax(seed, shape, lo, hi):
    key = jax.random.fold_in(_jkey(seed), 11)
    got = trandom.randint(key_from_numpy(key), shape, lo, hi, device="cpu")
    want = np.asarray(jax.random.randint(key, shape, lo, hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_keys_are_host_tensors_and_words_roundtrip():
    k = trandom.PRNGKey(7)
    assert k.dtype == torch.uint32 and k.device.type == "cpu"
    assert trandom.key_words(k) == (0, 7)
    assert trandom.key_words(key_to_numpy(k)) == (0, 7)
    with pytest.raises(OverflowError):
        trandom.PRNGKey(2**31)
