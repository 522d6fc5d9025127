"""The port's segmented stable argsort (``kernels/seg_sort.py``) against
numpy's and JAX's stable argsort, and ``_perm_senders`` on it against
``corrosion_tpu.models.broadcast``, bit for bit.

Keys are made with numpy from a seed; on the CPU ``seg_argsort`` runs
its plain version, the yardstick the card's kernel is held to in
``chip_smoke.py``.  Everything is integer: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import broadcast as jb
from corrosion_tpu_torch.convert import key_from_numpy
from corrosion_tpu_torch.kernels.seg_sort import seg_argsort
from corrosion_tpu_torch.models import broadcast as tb


def _raw_bits(rng, shape, distinct):
    """uint32 words whose top 23 bits take ``distinct`` values (many
    ties) and whose low 9 bits are noise the shift must drop."""
    top = rng.integers(0, distinct, shape).astype(np.uint32)
    if distinct > 1:
        top = top * np.uint32(((1 << 23) - 1) // (distinct - 1))
    return (top << np.uint32(9)) | rng.integers(0, 512, shape).astype(
        np.uint32)


@pytest.mark.parametrize("distinct", [1, 2, 37])
@pytest.mark.parametrize("length", [1, 2, 7, 250, 256, 1000])
def test_seg_argsort_23bit_matches_numpy_and_jax(length, distinct):
    rng = np.random.default_rng(length * 100 + distinct)
    raw = _raw_bits(rng, (5, length), distinct)
    got = seg_argsort(torch.from_numpy(raw), key_bits=23, shift=9)
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, length)
    keys = raw >> np.uint32(9)
    np.testing.assert_array_equal(
        got.numpy(), np.argsort(keys, axis=1, kind="stable"))
    # the reference sorts the uniform scores (bits >> 9) * 2**-23
    scores = jnp.asarray(keys.astype(np.float32) * np.float32(2.0**-23))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.argsort(scores, axis=1)))
    if distinct == 1:  # all equal: the identity in every segment
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(np.arange(length), (5, length)))


@pytest.mark.parametrize("segments,length,key_bits", [
    (1, 1000, 40), (1, 5000, 21), (3, 4097, 8), (2, 300, 62)])
def test_seg_argsort_int64_matches_numpy(segments, length, key_bits):
    rng = np.random.default_rng(key_bits)
    keys = rng.integers(0, 1 << key_bits, (segments, length))
    keys[:, ::3] = keys[:, :1]  # ties
    got = seg_argsort(torch.from_numpy(keys), key_bits=key_bits)
    np.testing.assert_array_equal(
        got.numpy(), np.argsort(keys, axis=1, kind="stable"))


@pytest.mark.parametrize("n,n_pk,n_cid", [(257, 60, 3), (1000, 250, 4)])
def test_seg_argsort_gives_the_merge_lexsorts(n, n_pk, n_cid):
    """The winner selection's two sorts: the stable argsort of pk and of
    ``pk * (n_cid + 2) + cid + 1`` are ``lexsort((idx, pk))`` and
    ``lexsort((idx, cid, pk))``, sentinels (cid -1) included."""
    rng = np.random.default_rng(n)
    pk = rng.integers(0, n_pk, n)
    cid = rng.integers(-1, n_cid, n)
    idx = np.arange(n)
    comp = pk * (n_cid + 2) + cid + 1
    o_a = seg_argsort(torch.from_numpy(pk)[None],
                      key_bits=(n_pk - 1).bit_length())[0]
    o_b = seg_argsort(torch.from_numpy(comp)[None],
                      key_bits=int(comp.max()).bit_length())[0]
    np.testing.assert_array_equal(o_a.numpy(), np.lexsort((idx, pk)))
    np.testing.assert_array_equal(o_b.numpy(), np.lexsort((idx, cid, pk)))


@pytest.mark.parametrize("bad", ["float", "1d", "wide_uint32", "wide_int64"])
def test_seg_argsort_refuses_what_the_kernel_cannot_take(bad):
    keys, kw = {
        "float": (torch.zeros((2, 4)), dict(key_bits=8)),
        "1d": (torch.zeros(4, dtype=torch.int64), dict(key_bits=8)),
        "wide_uint32": (torch.zeros((2, 4), dtype=torch.uint32),
                        dict(key_bits=24, shift=9)),
        "wide_int64": (torch.zeros((2, 4), dtype=torch.int64),
                       dict(key_bits=64)),
    }[bad]
    with pytest.raises(ValueError):
        seg_argsort(keys, **kw)


@pytest.mark.parametrize("n,u,ring0,ring0_size", [
    (100_000, 100_000, False, 256),  # a headline universe, global column
    (2000, 1000, True, 256),         # the headline's ring0: b0 = 250
    (1024, 256, True, 256),          # b0 = 256, the 256k sweep's block
    (2048, 1024, False, 64),         # two universes, global
    (4500, 4500, False, 64),         # a universe past the shared sort
    (597, 199, True, 16),            # prime universe: sliding window
])
def test_perm_senders_match_reference(n, u, ring0, ring0_size):
    for seed, j in ((11, 0), (12, 1), (13, 3)):
        key = jax.random.PRNGKey(seed)
        want = jb._perm_senders(key, j, n, u, ring0, ring0_size)
        got = tb._perm_senders(key_from_numpy(key), j, n, u, ring0,
                               ring0_size, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
