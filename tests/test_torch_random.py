"""The port's threefry twin against ``jax.random``, bit for bit.

Every draw of the simulator's tick goes through these samplers, so the
per-tick bitwise parity of the port rests on them.  Shapes and ranges
are the ones the path uses: [N, K] loss draws, [N/b, b] permutation
scores, [N, P] sync peer offsets and ring0 window offsets."""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.extend.random import threefry_2x32

from corrosion_tpu_torch import random as trandom
from corrosion_tpu_torch.convert import key_from_numpy, key_to_numpy
from corrosion_tpu_torch.kernels import threefry as tf

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
    ((64,), -2**31, 2**31 - 1),  # the widest span, 2**32 - 1
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


# counter pairs whose high word is set: a draw's words from flat index
# 2**32 on, which only an output of 2**32 words or more reaches
@pytest.mark.parametrize("hi", [1, 2**31, 2**32 - 1])
@pytest.mark.parametrize("key", [(0, 0), (0x12345678, 0x9ABCDEF0),
                                 (2**32 - 1, 2**32 - 1)])
def test_threefry2x32_high_counters_match_jax(key, hi):
    los = [2**32 - 4100, 2**32 - 5, 2**32 - 4, 2**32 - 2, 2**32 - 1, 0, 3]
    m = len(los)
    count = np.array([hi] * m + los, dtype=np.uint32)  # x0s, then x1s
    want = np.asarray(threefry_2x32(np.array(key, np.uint32), count))
    want = want.astype(np.int64)
    for j, lo in enumerate(los):
        assert tf.threefry2x32(*key, hi, lo) == (want[j], want[m + j])
    x0, x1 = tf.threefry2x32(*key, torch.full((m,), hi, dtype=torch.int64),
                             torch.tensor(los, dtype=torch.int64))
    np.testing.assert_array_equal(x0.numpy(), want[:m])
    np.testing.assert_array_equal(x1.numpy(), want[m:])


EDGE_SPANS = [1, 2, 3, 2**16, 2**16 + 1, 99_999, 2**31, 2**32 - 1]
EDGE_WORDS = [0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 2,
              2**32 - 1]


@pytest.mark.parametrize("span", EDGE_SPANS)
def test_fastmod_edges(span):
    m = tf.fastmod_m(span)
    assert 0 <= m < 2**64 and (m == 0) == (span == 1)
    words = EDGE_WORDS + [span - 1, span, span + 1, 2 * span - 1,
                          (2**32 - 1) // span * span]
    for a in words:
        a &= tf.MASK32
        assert tf.fastmod(a, m, span) == a % span


@settings(max_examples=400, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 2**32 - 1))
def test_fastmod_is_remainder(a, span):
    assert tf.fastmod(a, tf.fastmod_m(span), span) == a % span


@pytest.mark.parametrize("lo,hi", [(1, 2), (0, 2**16), (0, 2**16 + 1),
                                   (1, 100_000), (-2**31, 2**31 - 1)])
def test_randint_epilogue_by_fastmod_matches_plain(lo, hi):
    """The kernel's randint epilogue (three fastmod remainders on the
    two words) on the plain version's raw bits gives its int32 draws."""
    span, mult = trandom.randint_span(lo, hi)
    key, key2 = (7, 0xDEADBEEF), (0xFEEDFACE, 11)
    shape = (257,)
    hi_bits = torch.empty(shape, dtype=torch.uint32)
    lo_bits = torch.empty(shape, dtype=torch.uint32)
    tf.threefry_bits(hi_bits, key)
    tf.threefry_bits(lo_bits, key2)
    got = torch.empty(shape, dtype=torch.int32)
    tf.threefry_bits(got, key, key2, span=span, mult=mult, minval=lo)
    m = tf.fastmod_m(span)
    want = []
    for h, low in zip(hi_bits.tolist(), lo_bits.tolist()):
        off = (tf.fastmod(h, m, span) * mult + tf.fastmod(low, m, span))
        want.append(lo + tf.fastmod(off & tf.MASK32, m, span))
    assert got.tolist() == want


def test_randint_span_out_of_range_raises():
    out = torch.empty(4, dtype=torch.int32)
    for span in (0, 2**32):
        with pytest.raises(ValueError, match="span"):
            tf.threefry_bits(out, (1, 2), (3, 4), span=span)


def test_launch_refuses_a_cpu_tensor():
    """The kernel's launch takes a CUDA tensor or raises: the plain
    version is the wrapper's, for CPU tensors only."""
    with pytest.raises(ValueError, match="CUDA"):
        tf.launch(torch.empty(4, dtype=torch.uint32), (1, 2))
