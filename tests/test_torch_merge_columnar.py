"""The port's columnar CRDT winner selection (``ops/merge.py`` part B,
``kernels/winners.py``) against ``corrosion_tpu.ops.merge``, bit for
bit: the encoders field by field, and ``select_winners`` on the torch
backend (its plain versions here on the CPU) against the reference's
NumPy twin and its jitted JAX path.

Batches are drawn with numpy from a seed: sizes 255, 256, 257 and 1000
(either side of the reference's power-of-two buckets), pk-grouped or
interleaved, cold (no database view) or warm.  The reference's JAX path
needs int64 lanes, so it runs inside ``jax.enable_x64(True)``, which
leaves the process-wide flag as it was.  Everything is integer: every
comparison is exact.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import merge as ref
from corrosion_tpu_torch.convert import (
    decision_diff,
    merge_plan_from_reference,
)
from corrosion_tpu_torch.kernels import winners as kw
from corrosion_tpu_torch.ops import merge as port

VALUES = (None, 1, -4, 2.5, "x", b"\x01", "yy", "", True, 7)
SIZES = (255, 256, 257, 1000)
PLAN_FIELDS = ("n", "n_pk", "n_cid", "pk", "cid", "sent", "cl", "key",
               "seed_cl", "seed_key", "pk_values", "cid_values", "vals",
               "vers")


def _batch(seed, n, interleaved, warm):
    """(records, seed_cls, seed_cells) of one table batch: about n / 4
    rows, 4 columns, a quarter row sentinels, cl 1..5, col_version
    1..4, values of every type."""
    rng = np.random.default_rng(seed)
    n_pk = max(1, n // 4)
    pk = rng.integers(0, n_pk, n)
    if not interleaved:
        pk = np.sort(pk, kind="stable")
    sentinel = rng.random(n) < 0.25
    cid = rng.integers(0, 4, n)
    cl = rng.integers(1, 6, n)
    ver = rng.integers(1, 5, n)
    val = rng.integers(0, len(VALUES), n)
    records = [
        (f"p{p}", None, c, 0, None) if s
        else (f"p{p}", f"c{ci}", c, v, VALUES[x])
        for p, s, ci, c, v, x in zip(pk.tolist(), sentinel.tolist(),
                                     cid.tolist(), cl.tolist(), ver.tolist(),
                                     val.tolist())
    ]
    if not warm:
        return records, {}, {}
    seed_cls = {f"p{p}": int(c) for p, c in
                zip(range(n_pk), rng.integers(1, 5, n_pk))
                if rng.random() < 0.9}
    seed_cells = {}
    for p in seed_cls:
        for c in range(4):
            if rng.random() < 0.5:
                seed_cells[(p, f"c{c}")] = (int(rng.integers(1, 5)),
                                            VALUES[int(rng.integers(0, 4))])
    return records, seed_cls, seed_cells


def _ref_jax(plan):
    with jax.enable_x64(True):
        return ref._winners_jax(plan)


def _assert_plans_equal(a, b):
    for f in PLAN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert list(x) == list(y) if f.endswith("values") else x == y, f


CASES = [(size, order, mode, seed)
         for size in SIZES
         for order in ("pk_grouped", "interleaved")
         for mode in ("cold", "warm")
         for seed in (0, 1)]


@pytest.mark.parametrize("size,order,mode,seed", CASES)
def test_select_winners_matches_reference(size, order, mode, seed):
    records, seed_cls, seed_cells = _batch(
        seed * 7919 + size, size, order == "interleaved", mode == "warm")
    rplan = ref.encode_changes(records, seed_cls, seed_cells)
    plan = port.encode_changes(records, seed_cls, seed_cells)
    assert plan is not None and rplan is not None
    _assert_plans_equal(plan, rplan)
    want = ref._winners_np(rplan)
    assert decision_diff(_ref_jax(rplan), want) == []
    got = port.select_winners(plan, backend="torch", device="cpu")
    assert decision_diff(got, want) == []
    assert decision_diff(port.select_winners(plan, backend="numpy"),
                         want) == []
    # the case decides something: winners, raises and accepts
    assert (got.winner_idx >= 0).any() and got.gen.any()
    assert got.impacted > 0


def test_x64_stays_off_outside_the_reference_call():
    """The reference's int64 path turns x64 on only inside its call, so
    nothing leaks into the int32 tests a worker runs next."""
    _ref_jax(port.encode_changes(_batch(6, 256, True, True)[0]))
    assert not jax.config.jax_enable_x64


def test_interleaved_batches_need_both_sorts():
    """Neither sort is the identity on an interleaved batch, and the
    pk-grouped batch makes the first sort the identity (so both sort
    paths of the reference's NumPy twin are compared above)."""
    for interleaved in (False, True):
        plan = port.encode_changes(*_batch(5, 1000, interleaved, True))
        idx = np.arange(plan.n)
        o_a = np.lexsort((idx, plan.pk))
        o_b = np.lexsort((idx, plan.cid, plan.pk))
        assert np.array_equal(o_a, idx) != interleaved
        assert not np.array_equal(o_b, idx)


def test_folded_epilogue_equals_the_reference_mask():
    """``winners_b`` keeps an accept only at its row's final causal
    length instead of masking the scatter-max afterwards
    (merge.py:679-683).  Pin that on batches where the mask removes
    winners: a later generation raise wipes a cell's accepts."""
    masked = 0
    for trial in range(12):
        records, seed_cls, seed_cells = _batch(trial, 400, trial % 2,
                                               trial % 3)
        plan = port.encode_changes(records, seed_cls, seed_cells)
        t = {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
             for f in ("pk", "cid", "sent", "cl", "key", "seed_cl",
                       "seed_key")}
        res = port._winners_torch_core(
            t["pk"], t["cid"], t["sent"], t["cl"], t["key"], t["seed_cl"],
            t["seed_key"], plan.n_cid)
        n_pk = plan.n_pk
        final_cl = res[:n_pk]
        folded = res[4 * n_pk:-3]
        # the reference's form: scatter-max of every accept, then mask
        comp = t["pk"] * (plan.n_cid + 2) + t["cid"] + 1
        o_b = torch.from_numpy(np.lexsort((np.arange(plan.n), plan.cid,
                                           plan.pk)).astype(np.int32))
        o_a = torch.from_numpy(np.lexsort((np.arange(plan.n),
                                           plan.pk)).astype(np.int32))
        part = torch.empty(plan.n, dtype=torch.bool)
        scratch = torch.zeros(3 * n_pk + 3, dtype=torch.int64)
        kw.winners_a_plain(
            o_a, kw.seg_cummax_plain(o_a, t["pk"], t["cl"]), t["pk"],
            t["cl"], t["sent"], t["seed_cl"], t["seed_cl"].clone(),
            scratch[:n_pk], scratch[n_pk:2 * n_pk], part, scratch[-3:])
        prev = kw.seg_cummax_plain(o_b, comp, t["key"], mask=part)
        o = o_b.long()
        cell = t["pk"][o] * plan.n_cid + t["cid"][o].clamp(min=0)
        seed_b = torch.where(t["cid"][o] >= 0, t["seed_key"][cell],
                             kw.NEG_KEY)
        accept = part[o] & (t["key"][o] > torch.maximum(seed_b, prev))
        winner = torch.full_like(folded, -1).scatter_reduce_(
            0, cell, torch.where(accept, o, -1), "amax")
        wcl = torch.where(winner >= 0, t["cl"][winner.clamp(min=0)], -1)
        wpk = torch.arange(winner.shape[0]) // plan.n_cid
        want = torch.where((winner >= 0) & (wcl == final_cl[wpk]), winner,
                           -1)
        assert torch.equal(folded, want)
        masked += int(((winner >= 0) & (want < 0)).sum())
    assert masked > 0  # the mask mattered somewhere


def test_seg_cummax_plain_matches_reference_scan():
    rng = np.random.default_rng(3)
    for n in (1, 5, 300, 2049):
        seg = np.sort(rng.integers(0, max(1, n // 7), n))
        vals = rng.integers(-5, 1 << 40, n)
        order = np.arange(n, dtype=np.int32)
        want = ref._seg_cummax_np(vals, seg)
        args = (torch.from_numpy(order), torch.from_numpy(seg),
                torch.from_numpy(vals))
        got = kw.seg_cummax_plain(*args, exclusive=False)
        np.testing.assert_array_equal(got.numpy(), want)
        starts = np.r_[True, seg[1:] != seg[:-1]]
        excl = np.where(starts, ref.NEG_KEY, np.r_[ref.NEG_KEY, want[:-1]])
        np.testing.assert_array_equal(
            kw.seg_cummax(*args, exclusive=True).numpy(), excl)


def test_encode_change_batch_matches_reference():
    for seed in range(4):
        records, seed_cls, seed_cells = _batch(seed, 300, seed % 2, True)
        marker = object()
        changes = [SimpleNamespace(pk=p, cid=marker if c is None else c,
                                   cl=cl, col_version=v, val=x)
                   for p, c, cl, v, x in records]
        cells = (tuple(k[0] for k in seed_cells),
                 tuple(k[1] for k in seed_cells),
                 tuple(v[0] for v in seed_cells.values()),
                 tuple(v[1] for v in seed_cells.values()))
        want = ref.encode_change_batch(changes, marker, seed_cls, cells)
        got = port.encode_change_batch(changes, marker, seed_cls, cells)
        _assert_plans_equal(got, want)
        assert decision_diff(
            port.select_winners(got, backend="torch", device="cpu"),
            ref._winners_np(want)) == []


def test_value_ranks_match_reference():
    class Sub(int):
        pass

    pools = [
        [None, b"b", b"a", "b", "a", 2.5, -1.0, 3, True, False, None],
        [bytearray(b"z"), memoryview(b"y"), Sub(5), 4, "s", 0.5],
        ["only", "strings", "only"],
        [3, 1, 2, 3],
        [],
    ]
    for pool in pools:
        np.testing.assert_array_equal(port.value_ranks(pool),
                                      ref.value_ranks(pool))
    for bad, err in (([object(), 1], TypeError),
                     ([float("nan"), 0.5], ValueError),
                     ([1, float("nan"), "x"], ValueError)):
        with pytest.raises(err):
            port.value_ranks(bad)
        with pytest.raises(err):
            ref.value_ranks(bad)


@pytest.mark.parametrize("records", [
    [],
    [("p", "a", -1, 1, "v")],
    [("p", "a", 1 << 63, 1, "v")],
    [("p", "a", 1, 1, object()), ("p", "a", 1, 1, object())],
    [("p", "a", 1, 1, float("nan")), ("p", "a", 1, 1, 0.5)],
    [("p", "a", 1.5, 1, "v")],
])
def test_hostile_batches_fall_back_like_the_reference(records):
    assert ref.encode_changes(records) is None
    assert port.encode_changes(records) is None


def test_untied_hostile_values_still_encode():
    records = [("p", "a", 1, 1, object())]
    assert ref.encode_changes(records) is not None
    assert port.encode_changes(records) is not None


def test_plan_from_reference_round_trip():
    records, seed_cls, seed_cells = _batch(9, 257, True, True)
    rplan = ref.encode_changes(records, seed_cls, seed_cells)
    plan = merge_plan_from_reference(rplan)
    assert isinstance(plan, port.MergePlan)
    _assert_plans_equal(plan, port.encode_changes(records, seed_cls,
                                                  seed_cells))
    assert decision_diff(port.select_winners(plan, backend="torch",
                                             device="cpu"),
                         _ref_jax(rplan)) == []


def test_corrupted_seed_key_changes_the_decision():
    """Negative control: one cell's database clock raised above every
    batch candidate takes its winner away, and the comparison sees
    it."""
    records, seed_cls, seed_cells = _batch(4, 1000, True, True)
    plan = port.encode_changes(records, seed_cls, seed_cells)
    good = port.select_winners(plan, backend="torch", device="cpu")
    cell = int(np.flatnonzero(good.winner_idx >= 0)[0])
    seed_key = plan.seed_key.copy()
    seed_key[cell] = int(plan.key.max()) + 1
    bad_plan = port.MergePlan(**{**plan.__dict__, "seed_key": seed_key})
    bad = port.select_winners(bad_plan, backend="torch", device="cpu")
    assert "winner_idx" in decision_diff(bad, good)
    assert bad.winner_idx[cell] == -1
    assert decision_diff(bad, ref._winners_np(bad_plan)) == []


def test_card_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the request is honoured")
    plan = port.encode_changes(_batch(2, 256, False, False)[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.select_winners(plan, backend="torch", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.select_winners(plan, backend="torch")


def test_auto_backend_dispatches_by_size(monkeypatch):
    plan = port.encode_changes(*_batch(3, 1000, True, True))
    calls = []

    def fake_torch(p, device="cuda"):
        calls.append(device)
        return port._winners_np(p)

    monkeypatch.setattr(port, "_winners_torch", fake_torch)
    port.select_winners(plan, backend="auto", device="cpu")
    assert calls == []  # below TORCH_AUTO_MIN: the NumPy twin
    monkeypatch.setattr(port, "TORCH_AUTO_MIN", plan.n)
    port.select_winners(plan, backend="auto", device="cpu")
    assert calls == ["cpu"]
    with pytest.raises(ValueError):
        port.select_winners(plan, backend="jax")


@pytest.mark.parametrize("n", [1, 255, 256, 257, 70000])
def test_bucket_pow2_matches_reference(n):
    assert port.bucket_pow2(n) == ref.bucket_pow2(n)


def test_auto_with_no_device_answers_by_the_twin_on_a_host_with_no_card():
    """``select_winners(plan)`` at ``TORCH_AUTO_MIN`` changes with no
    device argument (storage's call) returns the NumPy twin's decision
    on a host with no card, as the reference's ``auto`` answers there;
    it used to ask for the card and raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: auto takes the kernels")
    plan = port.encode_changes(*_batch(11, port.TORCH_AUTO_MIN, True, True))
    assert plan.n == port.TORCH_AUTO_MIN
    assert decision_diff(port.select_winners(plan),
                         port._winners_np(plan)) == []
    assert decision_diff(port.select_winners(plan, backend="auto",
                                             device="cuda"),
                         port._winners_np(plan)) == []
