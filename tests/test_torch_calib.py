"""The port's calibration-scale exact sampler
(``corrosion_tpu_torch.sim.calibrate``: ``exact_tick``, ``run_exact``,
``run_msgs_calibration``) against ``corrosion_tpu.sim.calibrate``.

``exact_tick`` is held bitwise per tick on every leaf, ``sent``
included, with a short last sender chunk, with and without backoff, and
at N = 16 where rows run out of peers; the runners' dicts are held
equal, wall aside.  The plain selection is held against ``lax.top_k``
on crafted rows with ties and with fewer than k peers available, and a
flipped ``sent`` bit or a wrong chunk key must break the equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import calibrate as jc
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import sent_sampler as ss
from corrosion_tpu_torch.random import fold_in
from corrosion_tpu_torch.sim import calibrate as tc

FIELDS = ("infected", "tx", "next_send", "sent", "msgs")
# (config, ticks run): a short last chunk (1000 = 2 * 384 + 232), the
# backoff schedule, and N = 16 with a budget of 8 x 4 sends, where every
# row exhausts its 15 peers and retires
CASES = {
    "chunked": (dict(n_nodes=1000, sender_chunk=384), 9),
    "chunked_backoff": (dict(n_nodes=1000, sender_chunk=384,
                             backoff_ticks=1.5), 14),
    "exhausted_16": (dict(n_nodes=16, fanout=4, max_transmissions=8), 12),
}

_jit_tick = jax.jit(jc.exact_tick, static_argnames=("cfg",))


def _assert_equal(port, ref, where):
    got = convert.exact_state_to_numpy(port)
    assert got["tick"] == int(ref.tick), where
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)),
                                      err_msg=f"{where}: {f}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_tick_matches_reference_per_tick(case):
    kw, ticks = CASES[case]
    jcfg, tcfg = jc.ExactConfig(**kw), tc.ExactConfig(**kw)
    ref = jc.exact_init(jcfg)
    port = tc.exact_init(tcfg, device="cpu")
    _assert_equal(port, ref, "init")
    key = jax.random.PRNGKey(11)
    exhausted = 0
    for t in range(ticks):
        k = jax.random.fold_in(key, t)
        ref = _jit_tick(ref, k, jcfg)
        port = tc.exact_tick(port, convert.key_from_numpy(k), tcfg)
        _assert_equal(port, ref, f"{case} tick {t}")
        exhausted += int(((np.asarray(ref.tx) == 0)
                          & np.asarray(ref.infected)).sum())
    assert bool(np.asarray(ref.infected).all())
    if case == "exhausted_16":
        # rows ran out of peers: every row sent to all 15 others
        assert np.asarray(ref.sent).sum() == 16 * 15
        assert exhausted > 0


def test_exact_init_matches_reference():
    for writer in (0, 5):
        ref = jc.exact_init(jc.ExactConfig(40), writer=writer)
        port = tc.exact_init(tc.ExactConfig(40), writer=writer,
                             device="cpu")
        _assert_equal(port, ref, f"writer {writer}")


@pytest.mark.parametrize("seed", [0, 3])
def test_run_exact_matches_reference(seed):
    cfg = dict(n_nodes=300, sender_chunk=128)
    want = jc.run_exact(jc.ExactConfig(**cfg), seed=seed)
    got = tc.run_exact(tc.ExactConfig(**cfg), seed=seed, device="cpu")
    want.pop("wall_s")
    got.pop("wall_s")
    assert got == want


def test_run_msgs_calibration_matches_reference(tmp_path):
    out = tmp_path / "calib.json"
    want = jc.run_msgs_calibration(ns=(200, 500), seeds=2)
    got = tc.run_msgs_calibration(ns=(200, 500), seeds=2, device="cpu",
                                  out_path=str(out))
    assert got == want
    assert out.exists()
    for n in (100, 200, 400, 900):
        assert tc.ratio_for(got, n) == jc.ratio_for(want, n)
    assert tc.ratio_for({"points": []}, 10) is None


def _crafted_rows():
    """Score rows with ties inside and across the k + 1 smallest, +inf
    (excluded) entries among them, and rows with fewer than k finite
    scores."""
    rng = np.random.default_rng(4)
    levels = np.float32([0.0, 2.0**-23, 0.25, 0.25 + 2.0**-23, 0.5])
    rows = rng.choice(levels, (40, 24)).astype(np.float32)
    rows[rng.random((40, 24)) < 0.3] = np.inf
    rows[0] = np.inf
    rows[1, :] = np.inf
    rows[1, [3, 17]] = 0.25  # two available, k = 4
    rows[2, :] = 0.5  # every score tied
    return rows


@pytest.mark.parametrize("k", [1, 4, 5, 8])
def test_selection_matches_top_k(k):
    scores = _crafted_rows()
    neg, want_t = jax.lax.top_k(-jnp.asarray(scores), k)
    want_avail = np.asarray(neg) > -np.inf
    got_t, got_avail = ss.select_k(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_avail.numpy(), want_avail)
    # the available slots name the same peers in the same order; the
    # unavailable ones are masked away by every caller
    np.testing.assert_array_equal(
        np.where(want_avail, got_t.numpy(), -1),
        np.where(want_avail, np.asarray(want_t), -1))
    # the stable argsort of the track_sent path agrees too
    order = np.asarray(jnp.argsort(jnp.asarray(scores), axis=1))[:, :k]
    np.testing.assert_array_equal(
        np.where(want_avail, got_t.numpy(), -1),
        np.where(want_avail, order, -1))


def _tick_pair(n=300, chunk=128, ticks=3):
    """A reference and a port state ``ticks`` into a run, the next
    tick's key and the configs."""
    jcfg = jc.ExactConfig(n_nodes=n, sender_chunk=chunk)
    tcfg = tc.ExactConfig(n_nodes=n, sender_chunk=chunk)
    ref = jc.exact_init(jcfg)
    key = jax.random.PRNGKey(2)
    for t in range(ticks):
        ref = _jit_tick(ref, jax.random.fold_in(key, t), jcfg)
    port = convert.exact_state_from_numpy(
        {f: np.asarray(v) for f, v in ref._asdict().items()}, device="cpu")
    return ref, port, jax.random.fold_in(key, ticks), jcfg, tcfg


def test_flipped_sent_bit_breaks_equality():
    ref, port, key, jcfg, tcfg = _tick_pair()
    want = _jit_tick(ref, key, jcfg)
    # flip a mark of the lowest-scoring unsent peer of an active row:
    # the row must then pick another peer
    select, _ = tc.exact_inputs(port, convert.key_from_numpy(key), tcfg)
    active = ss.active_rows(select["tx"], select["next_send"],
                            select["tick"], select["infected"])[0]
    i = int(torch.nonzero(active)[0, 0])
    c = select["chunk"]
    start = i // c * c
    scores = ss.chunk_scores(port.sent[start:start + c],
                             select["keys"][0][i // c].tolist(), start)
    t = int(torch.argmin(scores[i - start]))
    assert bool(np.asarray(want.sent)[i, t])  # the reference sends to t
    port.sent[i, t] = True
    got = tc.exact_tick(port, convert.key_from_numpy(key), tcfg)
    assert not np.array_equal(got.sent.numpy(), np.asarray(want.sent))


def test_wrong_chunk_key_breaks_equality():
    ref, port, key, jcfg, tcfg = _tick_pair()
    want = _jit_tick(ref, key, jcfg)
    select, _ = tc.exact_inputs(port, convert.key_from_numpy(key), tcfg)
    active = ss.active_rows(select["tx"], select["next_send"],
                            select["tick"], select["infected"])[0]
    assert bool(active[128:256].any())  # chunk 1 has senders
    keys = select["keys"].clone()
    # chunk 1 starts at row 128: its key is fold_in(key, 128)
    keys[0, 1] = fold_in(convert.key_from_numpy(key), 129)
    ss.sent_select(**{**select, "keys": keys})
    assert not np.array_equal(select["sent"][0].numpy(),
                              np.asarray(want.sent))
    # the right key reproduces the reference, on a fresh copy
    port2 = convert.exact_state_from_numpy(
        {f: np.asarray(v) for f, v in ref._asdict().items()}, device="cpu")
    _assert_equal(tc.exact_tick(port2, convert.key_from_numpy(key), tcfg),
                  want, "right key")


def test_exact_state_convert_round_trip():
    ref, port, _, _, _ = _tick_pair(n=64, chunk=64, ticks=4)
    _assert_equal(port, ref, "from numpy")
    back = convert.exact_state_from_numpy(convert.exact_state_to_numpy(port),
                                          device="cpu")
    _assert_equal(back, ref, "round trip")
    assert back.sent.dtype == torch.bool and back.tx.dtype == torch.int32


def test_cpu_calibration_launches_no_kernel():
    counted = (ss.sent_select, ss.sent_commit)
    before = [f.launches for f in counted]
    tc.run_exact(tc.ExactConfig(100), device="cpu")
    assert [f.launches for f in counted] == before


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the call would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_exact(tc.ExactConfig(100))
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_msgs_calibration(ns=(100,), seeds=1)


def test_select_refuses_bad_arguments():
    s, n = 1, 20
    z = torch.zeros((s, n), dtype=torch.int32)
    sent = torch.zeros((s, n, n), dtype=torch.bool)
    keys = torch.zeros((s, 3, 2), dtype=torch.uint32)
    inf = torch.ones((s, n), dtype=torch.bool)
    with pytest.raises(ValueError, match="keys"):
        ss.sent_select(sent, keys, 4, n, tx=z, next_send=z, infected=inf)
    with pytest.raises(ValueError, match="not both"):
        ss.sent_select(sent, keys[:, :1], 4, n, tx=z, next_send=z,
                       infected=inf, rows=torch.zeros((s, n, 2)))
    with pytest.raises(ValueError, match="sent"):
        ss.sent_select(sent[:, :5], keys, 4, 7, tx=z, next_send=z,
                       infected=inf)
    with pytest.raises(ValueError, match="one chunk"):
        ss.sent_select(sent, keys, 4, 7, tx=z,
                       rows=torch.zeros((s, n, 2), dtype=torch.int32),
                       loss_keys=torch.zeros((s, 2, 2), dtype=torch.uint32))
    with pytest.raises(ValueError, match="new_infected"):
        ss.sent_commit(z, z, z, tick=0, max_tx=8, next_send=z, infected=inf)


# -- the ordering the sent_select kernel relies on -------------------------
#
# The kernel orders a row's columns by the 64-bit key (bits >> 9, column)
# of each score's threefry word, and its filter keeps the columns whose
# word is at most ``hit_bits(n, k)``.  The score of a word is
# ``(bits >> 9) * 2**-23`` exactly (jax.random.uniform), so that key
# order is the reference's: ``lax.top_k(-scores)`` and the stable argsort.

MAX_K = ss.MAX_FANOUT


def _uniform_of(bits):
    """jax.random.uniform's float32 of uint32 ``bits``."""
    return ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - 1.0


def _crafted_words(k):
    """[40, 24] uint32 words whose k + 1 smallest mantissas tie within a
    row while their low 9 bits fall as the column rises, with further
    ties and distinct words elsewhere."""
    rng = np.random.default_rng(40 + k)
    mant = rng.integers(100, 110, (40, 24)).astype(np.uint32)
    low = rng.integers(0, 512, (40, 24)).astype(np.uint32)
    for r in range(40):
        cols = np.sort(rng.choice(24, k + 1, replace=False))
        mant[r, cols] = 7
        low[r, cols] = np.sort(rng.choice(512, k + 1, replace=False))[::-1]
    return (mant << 9) | low


@functools.lru_cache(maxsize=1)
def _drawn_words():
    """jax.random bits of 4 rows x 2**21 columns: a row's uniforms are
    4 mantissa levels apart on average, so its 9 smallest tie more
    often than not."""
    key = jax.random.PRNGKey(0)
    shape = (4, 1 << 21)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(
        _uniform_of(bits), np.asarray(jax.random.uniform(key, shape)))
    return bits


def _key_order(words, k):
    """The first k columns of each row by (bits >> 9, column)."""
    cols = np.broadcast_to(np.arange(words.shape[1]), words.shape)
    return np.lexsort((cols, words >> 9), axis=1)[:, :k]


@functools.lru_cache(maxsize=2)
def _orders(source):
    """(words, scores, the (bits >> 9, column) order, the stable argsort
    of the scores and the port's select_k of MAX_K), each row's first
    MAX_K columns: the k-independent parts, once a source."""
    words = _crafted_words(MAX_K) if source == "crafted" else _drawn_words()
    scores = _uniform_of(words)
    order = np.asarray(jnp.argsort(jnp.asarray(scores), axis=1,
                                   stable=True))[:, :MAX_K]
    t, avail = ss.select_k(torch.from_numpy(scores), MAX_K)
    assert bool(avail.all())
    return words, scores, _key_order(words, MAX_K), order, t.numpy()


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("source", ["crafted", "drawn"])
def test_mantissa_key_order_is_the_reference_order(source, k):
    words, scores, got, order, port = _orders(source)
    _, top = jax.lax.top_k(-jnp.asarray(scores), k)
    np.testing.assert_array_equal(got[:, :k], np.asarray(top))
    np.testing.assert_array_equal(got[:, :k], order[:, :k])
    np.testing.assert_array_equal(got[:, :k], port[:, :k])
    # the ties are there to be broken: among the MAX_K + 1 smallest
    low = np.sort(words >> 9, axis=1)[:, :MAX_K + 1]
    assert (np.diff(low, axis=1) == 0).any()


@pytest.mark.parametrize("k", range(1, 9))
def test_raw_word_order_breaks_ties_the_wrong_way(k):
    words = _crafted_words(k)
    raw = np.argsort(words, axis=1, kind="stable")[:, :k]
    want = _key_order(words, k)
    # every crafted row ties its k + 1 smallest: the raw word puts the
    # highest of those columns first, the reference the lowest
    assert (raw != want).any(axis=1).all()


def _filter_select(words, excluded, k, bound):
    """The kernel's selection on one row: the non-excluded columns whose
    word is at most ``bound``, ranked by (bits >> 9, column); the full
    ranking when fewer than k come through and the bound did not take
    every column (the fallback).  Returns (columns, took_fallback)."""
    cols = np.arange(words.shape[0])
    keep = (words <= bound) & ~excluded
    full = bound == 0xFFFFFFFF
    if keep.sum() < k and not full:
        keep, took = ~excluded, True
    else:
        took = False
    c = cols[keep]
    return c[np.lexsort((c, words[keep] >> 9))][:k], took


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("n", [9, 33, 512, 16_000])
def test_filter_and_fallback_select_the_k_smallest(n, k):
    rng = np.random.default_rng(n + k)
    bound = ss.hit_bits(n, k)
    fallbacks = 0
    for r in range(24):
        words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        excluded = rng.random(n) < (0.99 if r % 4 == 3 else 0.05)
        excluded[r % n] = True  # the row itself
        got, took = _filter_select(words, excluded, k, bound)
        fallbacks += took
        scores = np.where(excluded, np.inf, _uniform_of(words))
        neg, top = jax.lax.top_k(-jnp.asarray(scores), k)
        avail = np.asarray(neg) > -np.inf
        np.testing.assert_array_equal(got, np.asarray(top)[avail])
    if n >= 512:  # rows with 1% of their peers left need the fallback
        assert fallbacks > 0


def test_hit_bits_is_a_mantissa_bound_with_slack():
    for n in (2, 20, 33, 34, 512, 4_000, 16_000, 65_537, 10**7):
        for k in range(1, 9):
            b = ss.hit_bits(n, k)
            assert b & 511 == 511  # every word of a mantissa or none
            if n - 1 <= 2 * k + ss.HIT_SLACK:
                assert b == 0xFFFFFFFF
                continue
            expected = (n - 1) * ((b >> 9) + 1) / 2**23
            assert 2 * k + ss.HIT_SLACK <= expected
            assert expected < 2 * k + ss.HIT_SLACK + (n - 1) / 2**23 + 1e-9
    # the words that pass are as many as predicted, here with ties
    k, n = 4, 16_000
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(9), (64, n),
                                      jnp.uint32))
    passed = (bits <= ss.hit_bits(n, k)).sum(axis=1)
    assert 18 <= passed.mean() <= 30 and passed.min() >= k
