"""A NumPy model of the winner selection's two kernels as
``kernels/csrc/winners.cu`` decomposes them, held bit for bit to their
plain versions (``winners_a_plain`` / ``winners_b_plain``) and, put in
the kernels' place inside ``_winners_torch_core``, the whole call held
to the reference's NumPy twin and its jitted JAX path.

The model follows the kernels' tiling: four consecutive positions a
thread, 32 lanes a warp (a warp's tile of 128 positions), the
segmented scans of a tile in its lanes (the same operators, identities
and shuffles), one write at the last position of each piece of a run,
a plain store where the piece is a whole run and an atomic where the
run may cross the tile's edge, and one count atomic a block.  Writes of
different warps land in any order on the card, so the model applies
them forward, reversed and shuffled, and each order must give the
plain version's outputs.  Without the atomic at the edge a long row
goes wrong (the negative control).

Batches come from records drawn with numpy from a seed through both
encoders: edge sizes, one row longer than many tiles, rows of one
change, a cell whose accepts span two warps, sentinels only, one and 64
columns, cold and warm, pk-grouped and interleaved.  The reference's
JAX path needs int64, so it runs inside ``jax.enable_x64(True)``.
Everything is integer: every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from corrosion_tpu.ops import merge as ref
from corrosion_tpu_torch.convert import decision_diff
from corrosion_tpu_torch.kernels import winners as kw
from corrosion_tpu_torch.ops import merge as port

ITEMS, LANES, WARPS = 4, 32, 8  # winners.cu ITEMS, a warp, THREADS / 32
WARP_TILE = ITEMS * LANES  # 128
BLOCK_TILE = WARPS * WARP_TILE  # 1024
INT_MAX = 2**31 - 1
NO_ROW = -1
NEG_KEY = kw.NEG_KEY
ORDERS = ("forward", "reverse", "shuffle")
VALUES = (None, 1, -4, 2.5, "x", b"\x01", "yy", "")


# -- the model -----------------------------------------------------------

def _lanes(a, fill):
    """[n] -> [warps, 32, 4]: position w * 128 + lane * 4 + k."""
    w = max(1, -(-a.shape[0] // WARP_TILE))
    out = np.full(w * WARP_TILE, fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out.reshape(w, LANES, ITEMS)


def _shfl_up(x, off):
    """``__shfl_up_sync``: lane l reads lane l - off, lanes below off
    their own value."""
    y = x.copy()
    y[:, off:] = x[:, :-off]
    return y


def _shfl_down(x, off):
    y = x.copy()
    y[:, :-off] = x[:, off:]
    return y


def _row_or(x, y):
    """RowOr's combine: (run start in the span, or of the flags)."""
    return x[0] | y[0], np.where(y[0] != 0, y[1], x[1] | y[1])


def _cell_min_max(x, y):
    """CellMinMax's combine: (bit 0 row start, bit 1 cell start), the
    segmented min over rows and max over cells."""
    return (x[0] | y[0], np.where(y[0] & 1, y[1], np.minimum(x[1], y[1])),
            np.where(y[0] & 2, y[2], np.maximum(x[2], y[2])))


def _warp_exclusive(agg, combine, identity):
    """The kernels' ``warp_exclusive``: Hillis-Steele over the lanes by
    shuffles, then each lane takes its left neighbour's (lane 0 the
    identity)."""
    lane = np.arange(LANES)[None, :]
    for off in (1, 2, 4, 8, 16):
        up = tuple(_shfl_up(a, off) for a in agg)
        agg = tuple(np.where(lane >= off, c, a)
                    for c, a in zip(combine(up, agg), agg))
    ex = tuple(_shfl_up(a, 1) for a in agg)
    return tuple(np.where(lane > 0, e, i) for e, i in zip(ex, identity))


def _fold(parts, combine, identity, shape):
    agg = tuple(np.full(shape, i, np.int64) for i in identity)
    for k in range(ITEMS):
        agg = combine(agg, tuple(p[..., k] for p in parts))
    return agg


def _apply(writes, order, seed=0):
    """Apply (position, array, index, value, kind) writes in ``order``:
    a store overwrites, an atomic takes the max or min."""
    if order == "reverse":
        writes = writes[::-1]
    elif order == "shuffle":
        writes = [writes[i] for i in
                  np.random.default_rng(seed).permutation(len(writes))]
    for _, arr, ix, v, kind in writes:
        if kind == "store":
            arr[ix] = v
        elif kind == "max":
            arr[ix] = max(arr[ix], v)
        else:
            arr[ix] = min(arr[ix], v)


def _block_sums(flags, n):
    """One count atomic a block: the per-block sums of [n] flags."""
    pad = np.zeros(max(1, -(-n // BLOCK_TILE)) * BLOCK_TILE, np.int64)
    pad[:n] = flags
    return pad.reshape(-1, BLOCK_TILE).sum(axis=1)


def model_a(oA, prev, pk, cl, sent, seed_cl, final_cl, sent_flag, ensure,
            part, counts, *, order="forward", edge_atomic=True, log=None):
    """``winners_a`` as the kernel decomposes it (the plain version's
    arguments and result, CPU tensors)."""
    o_s = oA.numpy().astype(np.int64)
    n = o_s.shape[0]
    pk_n = pk.numpy()
    live = _lanes(np.ones(n, bool), False)
    o = _lanes(o_s, -1)
    p = _lanes(pk_n[o_s], NO_ROW)
    c = _lanes(cl.numpy()[o_s], 0)
    s = _lanes(sent.numpy()[o_s], True)
    pv = _lanes(prev.numpy(), NEG_KEY)
    before = np.where(live, np.maximum(seed_cl.numpy()[np.maximum(p, 0)],
                                       pv), 0)
    odd = (c & 1) == 1
    rise = live & (c > before)
    cell = live & ~s
    part.numpy()[o[live]] = (cell & odd & (c >= before))[live]
    lane = np.arange(LANES)[None, :]
    p_up = _shfl_up(p[..., ITEMS - 1], 1)
    p_down = _shfl_down(p[..., 0], 1)
    f = np.zeros(p.shape, np.int64)
    f[..., 0] = (lane > 0) & (p[..., 0] != p_up)
    f[..., 1:] = p[..., 1:] != p[..., :-1]
    a = ((rise & s).astype(np.int64)
         | (cell & odd & (c == before)).astype(np.int64) << 1)
    cur = _warp_exclusive(_fold((f, a), _row_or, (0, 0), p.shape[:2]),
                          _row_or, (0, 0))
    pos = _lanes(np.arange(n), -1)
    writes = []
    targets = (final_cl.numpy(), sent_flag.numpy(), ensure.numpy())
    for k in range(ITEMS):
        cur = _row_or(cur, (f[..., k], a[..., k]))
        edge = (k == ITEMS - 1) & (lane == LANES - 1)
        nxt = p[..., k + 1] if k + 1 < ITEMS else p_down
        end = live[..., k] & (edge | (nxt != p[..., k]))
        fin = np.maximum(before[..., k], c[..., k])
        for w, ln in zip(*np.nonzero(end)):
            at, row = pos[w, ln, k], p[w, ln, k]
            atomic = edge_atomic and ln == LANES - 1 and k == ITEMS - 1
            writes.append((at, targets[0], row, fin[w, ln],
                           "max" if atomic else "store"))
            for bit, arr in ((1, targets[1]), (2, targets[2])):
                if cur[1][w, ln] & bit:
                    writes.append((at, arr, row, 1, "store"))
    _apply(writes, order)
    if log is not None:
        log.extend(w[:3] + (w[4],) for w in writes if w[1] is targets[0])
    counts[0] += int(_block_sums((rise & s)[live], n).sum())
    counts[1] += int(_block_sums((rise & cell & ~odd)[live], n).sum())
    return torch.from_numpy(pk_n[o_s])


def model_b(oB, prev, pk_pos, cid, cl, key, part, seed_key, final_cl,
            n_cid, winner, clrow, counts, *, order="forward",
            edge_atomic=True, log=None):
    """``winners_b`` as the kernel decomposes it (the plain version's
    arguments, CPU tensors)."""
    o_s = oB.numpy().astype(np.int64)
    n = o_s.shape[0]
    live = _lanes(np.ones(n, bool), False)
    o = _lanes(o_s, -1)
    p = _lanes(pk_pos.numpy(), NO_ROW)
    ci = _lanes(cid.numpy()[o_s], -2)
    c = _lanes(cl.numpy()[o_s], 0)
    pt = _lanes(part.numpy()[o_s], False)
    pv = _lanes(prev.numpy(), NEG_KEY)
    fcl = np.where(live, final_cl.numpy()[np.maximum(p, 0)], 1)
    ky = np.where(pt, _lanes(key.numpy()[o_s], NEG_KEY), NEG_KEY)
    cell_ix = np.maximum(p, 0) * n_cid + np.maximum(ci, 0)
    sk = np.where(pt & (ci >= 0), seed_key.numpy()[np.where(
        pt & (ci >= 0), cell_ix, 0)], NEG_KEY)
    at_final = live & (c == fcl)
    accept = pt & (ky > np.maximum(sk, pv))
    lane = np.arange(LANES)[None, :]
    p_up, ci_up = _shfl_up(p[..., -1], 1), _shfl_up(ci[..., -1], 1)
    p_down, ci_down = _shfl_down(p[..., 0], 1), _shfl_down(ci[..., 0], 1)
    pp = np.concatenate([p_up[..., None], p[..., :-1]], axis=2)
    cp = np.concatenate([ci_up[..., None], ci[..., :-1]], axis=2)
    first = np.ones(p.shape, bool)
    first[:, 0, 0] = False  # lane 0's first: the tile's edge
    f = np.where(first & (p != pp), 3, np.where(first & (ci != cp), 2, 0))
    mn = np.where(at_final, o, INT_MAX)
    mx = np.where(accept & at_final, o, -1)
    cur = _warp_exclusive(
        _fold((f, mn, mx), _cell_min_max, (0, INT_MAX, -1), p.shape[:2]),
        _cell_min_max, (0, INT_MAX, -1))
    pos = _lanes(np.arange(n), -1)
    writes = []
    clrow_n, winner_n = clrow.numpy(), winner.numpy()
    for k in range(ITEMS):
        cur = _cell_min_max(cur, (f[..., k], mn[..., k], mx[..., k]))
        edge = (k == ITEMS - 1) & (lane == LANES - 1)
        pn = p[..., k + 1] if k + 1 < ITEMS else p_down
        cn = ci[..., k + 1] if k + 1 < ITEMS else ci_down
        row_end = live[..., k] & (edge | (pn != p[..., k]))
        cell_end = live[..., k] & (row_end | (cn != ci[..., k]))
        for w, ln in zip(*np.nonzero(row_end | cell_end)):
            at, row = pos[w, ln, k], p[w, ln, k]
            at_edge = ln == LANES - 1 and k == ITEMS - 1
            fw = cur[0][w, ln]
            if row_end[w, ln] and cur[1][w, ln] != INT_MAX:
                whole = not at_edge and fw & 1
                writes.append((at, clrow_n, row, cur[1][w, ln],
                               "min" if edge_atomic and not whole
                               else "store"))
            if cell_end[w, ln] and cur[2][w, ln] >= 0:
                whole = not at_edge and fw & 2
                kind = "max" if edge_atomic and not whole else "store"
                writes.append((at, winner_n,
                               row * n_cid + max(ci[w, ln, k], 0),
                               cur[2][w, ln], kind))
    _apply(writes, order)
    if log is not None:
        log.extend(w[:3] + (w[4],) for w in writes)
    counts[2] += int(_block_sums(accept[live], n).sum())


# -- the batches -----------------------------------------------------------

def _records(rng, pks, cols, sentinel_frac=0.25, cl=None, ver=None):
    n = len(pks)
    sentinel = rng.random(n) < sentinel_frac
    cid = rng.integers(0, cols, n)
    cl = rng.integers(1, 6, n) if cl is None else cl
    ver = rng.integers(1, 5, n) if ver is None else ver
    val = rng.integers(0, len(VALUES), n)
    return [(f"p{p}", None, int(c), 0, None) if s
            else (f"p{p}", f"c{ci}", int(c), int(v), VALUES[x])
            for p, s, ci, c, v, x in zip(pks, sentinel, cid, cl, ver, val)]


def _warm(rng, rows, cols):
    seed_cls = {f"p{p}": int(rng.integers(1, 5)) for p in rows
                if rng.random() < 0.9}
    seed_cells = {(p, f"c{c}"): (int(rng.integers(1, 5)),
                                 VALUES[int(rng.integers(0, 4))])
                  for p in seed_cls for c in range(cols)
                  if rng.random() < 0.5}
    return seed_cls, seed_cells


def _batch(name, seed):
    """(records, seed_cls, seed_cells) of the named case."""
    rng = np.random.default_rng(seed)
    kind, _, arg = name.partition(":")
    warm = name.endswith("warm")
    cols = 4
    if kind in ("n", "grouped", "interleaved"):
        n = int(arg.split("_")[0])
        pks = rng.integers(0, max(1, n // 4), n)
        if kind == "grouped":
            pks = np.sort(pks)
    elif kind == "long_row":
        # 5,000 changes of one row between short rows, cl rising with the
        # stream, so a tile's partial max is below the row's final
        pks = np.r_[rng.integers(1, 20, 37), np.zeros(5000, np.int64),
                    rng.integers(1, 20, 91)]
        recs = _records(rng, pks, cols)
        recs[37:5037] = _records(rng, np.zeros(5000, np.int64), cols,
                                 cl=1 + np.arange(5000) * 5 // 5000)
        return (recs, *(_warm(rng, [f"p{p}" for p in range(20)], cols)
                        if warm else ({}, {})))
    elif kind == "single_rows":
        pks = rng.permutation(1000)
    elif kind == "cell_two_warps":
        # one cell's 300 changes, cl 1 and rising col_versions (each an
        # accept at the row's final causal length), after 50 others
        head = _records(rng, rng.integers(1, 10, 50), cols)
        cell = [("p0", "c1", 1, v + 1, VALUES[v % 8]) for v in range(300)]
        recs = head + cell
        if arg.startswith("interleaved"):
            recs = [recs[i] for i in rng.permutation(len(recs))]
        return (recs, *(_warm(rng, [f"p{p}" for p in range(10)], cols)
                        if warm else ({}, {})))
    elif kind == "sentinels":
        pks = rng.integers(0, 120, 500)
        recs = _records(rng, pks, cols, sentinel_frac=1.0)
        return (recs, *(_warm(rng, [f"p{p}" for p in range(120)], cols)
                        if warm else ({}, {})))
    elif kind == "cols":
        cols = int(arg.split("_")[0])
        pks = rng.integers(0, 300, 2000)
    else:
        raise ValueError(name)
    recs = _records(rng, pks, cols)
    rows = sorted({r[0] for r in recs})
    return (recs, *(_warm(rng, rows, cols) if warm else ({}, {})))


CASES = (
    [f"n:{n}_{m}" for n in (1, 31, 32, 33, 4097) for m in ("cold", "warm")]
    + [f"{o}:1000_{m}" for o in ("grouped", "interleaved")
       for m in ("cold", "warm")]
    + ["long_row:cold", "long_row:warm", "single_rows:warm",
       "cell_two_warps:grouped_cold", "cell_two_warps:interleaved_warm",
       "sentinels:cold", "sentinels:warm", "cols:1_warm", "cols:64_warm",
       "cols:64_cold"])


def _plans(name):
    records, seed_cls, seed_cells = _batch(name, CASES.index(name) + 11)
    plan = port.encode_changes(records, seed_cls, seed_cells)
    rplan = ref.encode_changes(records, seed_cls, seed_cells)
    assert plan is not None and rplan is not None
    return plan, rplan


def _tensors(plan):
    return {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
            for f in ("pk", "cid", "sent", "cl", "key", "seed_cl",
                      "seed_key")}


def _orders(t, n_cid):
    comp = t["pk"] * (n_cid + 2) + t["cid"] + 1
    idx = np.arange(t["pk"].shape[0])
    o_a = torch.from_numpy(np.lexsort((idx, t["pk"].numpy()))
                           .astype(np.int32))
    o_b = torch.from_numpy(np.lexsort((idx, t["cid"].numpy(),
                                       t["pk"].numpy())).astype(np.int32))
    return o_a, o_b, comp


def _outputs(n, n_pk, n_cid, seed_cl):
    z = torch.zeros(n_pk, dtype=torch.int64)
    return dict(final_cl=seed_cl.clone(), sent_flag=z.clone(),
                ensure=z.clone(), part=torch.zeros(n, dtype=torch.bool),
                counts=torch.zeros(3, dtype=torch.int64),
                winner=torch.full((n_pk * n_cid,), -1, dtype=torch.int64),
                clrow=torch.full((n_pk,), kw.BIG, dtype=torch.int64))


def _run(plan, run_a, run_b):
    """Domain A then B on the plan's intermediates with the given
    passes; returns every output and A's pk_pos."""
    t = _tensors(plan)
    n, n_pk, n_cid = plan.n, plan.n_pk, plan.n_cid
    o_a, o_b, comp = _orders(t, n_cid)
    out = _outputs(n, n_pk, n_cid, t["seed_cl"])
    prev_a = kw.seg_cummax_plain(o_a, t["pk"], t["cl"])
    pk_pos = run_a(o_a, prev_a, t["pk"], t["cl"], t["sent"], t["seed_cl"],
                   out["final_cl"], out["sent_flag"], out["ensure"],
                   out["part"], out["counts"])
    prev_b = kw.seg_cummax_plain(o_b, comp, t["key"], mask=out["part"])
    run_b(o_b, prev_b, pk_pos, t["cid"], t["cl"], t["key"], out["part"],
          t["seed_key"], out["final_cl"], n_cid, out["winner"],
          out["clrow"], out["counts"])
    return out, pk_pos


def _assert_same(got, want):
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- the tests -------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain_versions(name):
    """The model, its writes in any of three orders, equals
    ``winners_a_plain`` / ``winners_b_plain`` on every output, pk_pos
    included; every plain store of final_cl, clrow and winner is the
    only one to its index, and a warp's tile takes at most two atomics
    an output."""
    plan, _ = _plans(name)
    want, want_pos = _run(plan, kw.winners_a_plain, kw.winners_b_plain)
    for order in ORDERS:
        log_a, log_b = [], []
        got, got_pos = _run(
            plan,
            lambda *a: model_a(*a, order=order, log=log_a),
            lambda *a: model_b(*a, order=order, log=log_b))
        _assert_same(got, want)
        assert torch.equal(got_pos, want_pos)
        stores, atomics = {}, {}
        for at, arr, ix, kind in log_a + log_b:
            key = ((id(arr), ix) if kind == "store"
                   else (id(arr), at // WARP_TILE))
            count = stores if kind == "store" else atomics
            count[key] = count.get(key, 0) + 1
        assert max(stores.values(), default=0) <= 1
        assert max(atomics.values(), default=0) <= 2
    assert want["counts"].sum() > 0 or name.startswith("n:1_")


@pytest.mark.parametrize("name", CASES)
def test_model_in_the_core_matches_reference(name, monkeypatch):
    """The model in the kernels' place (``_winners_torch_core`` on the
    CPU) against the reference's NumPy twin and jitted JAX path, every
    ``MergeDecision`` field and ``impacted``."""
    plan, rplan = _plans(name)
    want = ref._winners_np(rplan)
    with jax.enable_x64(True):
        assert decision_diff(ref._winners_jax(rplan), want) == []
    for order in ("reverse", "shuffle"):
        monkeypatch.setattr(kw, "winners_a",
                            lambda *a: model_a(*a, order=order))
        monkeypatch.setattr(kw, "winners_b",
                            lambda *a: model_b(*a, order=order))
        got = port.select_winners(plan, backend="torch", device="cpu")
        assert decision_diff(got, want) == []
    assert decision_diff(port.select_winners(plan, backend="numpy"),
                         want) == []


@pytest.mark.parametrize("name", CASES)
def test_both_orders_share_pk_by_position(name):
    """pk[oA] == pk[oB] at every position (both sort by pk first): the
    invariant that lets winners_b read winners_a's pk_pos."""
    plan, _ = _plans(name)
    t = _tensors(plan)
    o_a, o_b, _ = _orders(t, plan.n_cid)
    assert torch.equal(t["pk"][o_a.long()], t["pk"][o_b.long()])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 6), st.integers(-1, 3)),
                min_size=1, max_size=300))
def test_pk_by_position_property(pairs):
    """The invariant on arbitrary (pk, cid) streams."""
    pk = np.array([p for p, _ in pairs])
    cid = np.array([c for _, c in pairs])
    idx = np.arange(len(pairs))
    o_a = np.lexsort((idx, pk))
    o_b = np.lexsort((idx, cid, pk))
    assert np.array_equal(pk[o_a], pk[o_b])


def test_the_edge_cases_cross_tiles():
    """The long row spans many warp tiles in both orders, and the
    two-warp cell's accepts lie in two tiles: the crossing-edge atomics
    run."""
    plan, _ = _plans("long_row:cold")
    rows = np.flatnonzero(plan.pk[np.lexsort((np.arange(plan.n),
                                              plan.pk))] == plan.pk[40])
    assert rows.size == 5000 and rows[0] // WARP_TILE < rows[-1] // WARP_TILE
    plan, _ = _plans("cell_two_warps:grouped_cold")
    log = []
    _run(plan, kw.winners_a_plain,
         lambda *a: model_b(*a, log=log))
    assert sum(1 for *_, kind in log if kind == "max") >= 2


@pytest.mark.parametrize("name", ["long_row:cold", "long_row:warm",
                                  "cell_two_warps:grouped_cold"])
def test_negative_control_without_edge_atomic(name):
    """The model with plain stores where a run crosses a tile's edge,
    its writes reversed (the last to land is the first tile's partial),
    differs from the plain version: the edge atomics are what make a
    long run right."""
    plan, _ = _plans(name)
    want, _ = _run(plan, kw.winners_a_plain, kw.winners_b_plain)
    got, _ = _run(
        plan,
        lambda *a: model_a(*a, order="reverse", edge_atomic=False),
        lambda *a: model_b(*a, order="reverse", edge_atomic=False))
    assert any(not torch.equal(got[k], want[k]) for k in want)
    right, _ = _run(plan, lambda *a: model_a(*a, order="reverse"),
                    lambda *a: model_b(*a, order="reverse"))
    _assert_same(right, want)
