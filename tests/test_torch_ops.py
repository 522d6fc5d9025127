"""The port's packed keys and merge against ``corrosion_tpu.ops``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import keys as jkeys
from corrosion_tpu.ops import merge as jmerge
from corrosion_tpu_torch.ops import keys as tkeys
from corrosion_tpu_torch.ops import merge as tmerge


def _fields(rng, codec, shape):
    return (
        rng.integers(0, codec.max_cl + 1, shape),
        rng.integers(0, codec.max_ver + 1, shape),
        rng.integers(0, codec.max_val + 1, shape),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_default_codec_pack_unpack_is_live_match_jax(seed):
    rng = np.random.default_rng(seed)
    cl, ver, val = _fields(rng, tkeys.DEFAULT_CODEC, (64, 8))
    got = tkeys.DEFAULT_CODEC.pack(torch.from_numpy(cl), torch.from_numpy(ver),
                                   torch.from_numpy(val))
    want = jkeys.DEFAULT_CODEC.pack(cl, ver, val)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(tkeys.DEFAULT_CODEC.unpack(got),
                    jkeys.DEFAULT_CODEC.unpack(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tkeys.DEFAULT_CODEC.is_live(got).numpy(),
        np.asarray(jkeys.DEFAULT_CODEC.is_live(want)),
    )


def test_wide_codec_is_int64_and_roundtrips():
    # the reference needs jax_enable_x64 for this codec; hold the port
    # to the packing formula instead
    codec = tkeys.WIDE_CODEC
    rng = np.random.default_rng(3)
    cl, ver, val = _fields(rng, codec, (32,))
    key = codec.pack(torch.from_numpy(cl), torch.from_numpy(ver),
                     torch.from_numpy(val))
    assert codec.dtype == torch.int64 and key.dtype == torch.int64
    want = ((cl << (codec.ver_bits + codec.val_bits))
            | (ver << codec.val_bits) | val)
    np.testing.assert_array_equal(key.numpy(), want)
    for g, w in zip(codec.unpack(key), (cl, ver, val)):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        tkeys.KeyCodec(cl_bits=30, ver_bits=30, val_bits=30)


def test_packed_order_is_lexicographic():
    codec = tkeys.DEFAULT_CODEC
    a = codec.pack(torch.tensor([3, 2, 2]), torch.tensor([1, 9, 9]),
                   torch.tensor([0, 0, 5]))
    # cl dominates col_version, which dominates the value
    assert a[0] > a[1] and a[2] > a[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_keys_and_cells_match_jax(seed):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 2**31 - 1, (5, 40, 8), dtype=np.int32)
    t = torch.from_numpy(states)
    np.testing.assert_array_equal(
        tmerge.merge_keys(t[0], t[1]).numpy(),
        np.asarray(jmerge.merge_keys(jnp.asarray(states[0]),
                                     jnp.asarray(states[1]))),
    )
    np.testing.assert_array_equal(
        tmerge.merge_cells(t).numpy(),
        np.asarray(jmerge.merge_cells(jnp.asarray(states))),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_merge_matches_jax_drop_mode(seed):
    rng = np.random.default_rng(seed)
    n, m = 30, 90
    state = rng.integers(0, 1000, (n, 4), dtype=np.int32)
    msgs = rng.integers(0, 1000, (m, 4), dtype=np.int32)
    # repeats, the dead row n (the sim's masked delivery), negative
    # indices and indices past every row
    targets = rng.integers(-n - 5, n + 5, (m,)).astype(np.int32)
    targets[:10] = n
    got = tmerge.scatter_merge(torch.from_numpy(state),
                               torch.from_numpy(targets),
                               torch.from_numpy(msgs))
    want = jmerge.scatter_merge(jnp.asarray(state), jnp.asarray(targets),
                                jnp.asarray(msgs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
