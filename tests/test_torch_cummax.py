"""A NumPy model of ``seg_cummax``'s single-pass kernel as
``kernels/csrc/winners.cu`` builds it, held bit for bit to
``seg_cummax_plain``, to the reference's two scans (``_seg_cummax_np``
and ``_seg_cummax_jnp``) and, put in the kernel's place inside
``_winners_torch_core``, the whole winner selection to the reference's
NumPy twin.

The model follows the kernel: a tile of ``ITEMS`` positions a thread,
``lanes`` threads a warp and ``warps`` warps a tile (8 and 32 positions
here, so that a small n makes many tiles); each position gathers its
segment key once, and the start flag compares it with the previous
position's, held by the same thread, its left lane or, across a warp's
edge and a tile's, read once; the segmented-max operator scanned over a
thread's positions, its warp's lanes and the tile's warps; every tile
claims a ticket in order, publishes its aggregate (complete at once
where the tile holds a start) and folds its predecessors' published
words, a window of them at once, back to the first complete one.

A schedule decides which tile moves next: tiles claim their tickets in
order, at most ``resident`` at a time, and then scan, look back (a
window a step, blocked while a word of the window is unpublished) and
finish in the order the schedule picks, lowest tile first, highest
first or at random.  Each order must give the plain version's output
and none may deadlock.  Words left by an earlier call carry an older
epoch and are never read as this call's: a tile reads the epoch with
its ticket, and the call's last claim resets the count and advances
the epoch.  A look-back that stops at its first predecessor's word,
complete or not, gets a long segment wrong (the negative control).
Everything is integer: every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import merge as ref
from corrosion_tpu_torch.convert import decision_diff
from corrosion_tpu_torch.kernels import winners as kw
from corrosion_tpu_torch.ops import merge as port

NEG_KEY = kw.NEG_KEY
TOP = (1 << 62) - 1
ITEMS = 4  # winners.cu CM_ITEMS
PARTIAL, DONE = 1, 2  # winners.cu TILE_PARTIAL, TILE_DONE
SCHEDULES = ("forward", "reverse", "shuffle")
# (lanes a warp, warps a tile, look-back window): tiles of 8 and 32
GEOMETRIES = {"tile8": (2, 1, 4), "tile32": (4, 2, 3)}


# -- the model -------------------------------------------------------------

def _combine(x, y):
    """SegMax's combine: (a start in the span, the max since its last
    start)."""
    return x[0] | y[0], np.where(y[0] != 0, y[1], np.maximum(x[1], y[1]))


def _shfl_up(x, off, axis):
    """``__shfl_up_sync`` along ``axis``: index i reads i - off, those
    below off their own value."""
    y = x.copy()
    src = [slice(None)] * x.ndim
    dst = [slice(None)] * x.ndim
    src[axis], dst[axis] = slice(None, -off), slice(off, None)
    y[tuple(dst)] = x[tuple(src)]
    return y


def _inclusive(x, axis):
    """Hillis-Steele over ``axis`` by shuffles, as the kernel's warp
    scans."""
    size = x[0].shape[axis]
    idx = np.arange(size).reshape([-1 if a == axis else 1
                                   for a in range(x[0].ndim)])
    off = 1
    while off < size:
        up = tuple(_shfl_up(a, off, axis) for a in x)
        both = _combine(up, x)
        x = tuple(np.where(idx >= off, b, a) for b, a in zip(both, x))
        off <<= 1
    return x


class Words:
    """The scratch across calls: its head (the epoch and the tickets
    claimed, one word in winners.cu) and the tiles' published words,
    (value, epoch << 2 | status).  A tile reads the epoch with its
    ticket and only that epoch's words; the last claim resets the count
    and advances the epoch."""

    def __init__(self):
        self.value, self.tag = {}, {}
        self.ticket = self.epoch = 0

    def stale(self, tiles, rng):
        """Words of earlier calls at every tile: random values and
        earlier epochs, some complete, some partial."""
        for t in range(tiles):
            self.value[t] = int(rng.integers(NEG_KEY, TOP))
            self.tag[t] = (int(rng.integers(0, self.epoch)) << 2
                           | int(rng.integers(1, 3)))

    def claim(self, tiles):
        """(tile, epoch): the next ticket and this call's epoch, read
        together."""
        got = self.ticket, self.epoch
        self.ticket += 1
        if self.ticket == tiles:
            self.ticket, self.epoch = 0, self.epoch + 1
        return got

    def publish(self, t, value, status, epoch):
        self.value[t], self.tag[t] = value, (epoch << 2) | status

    def read(self, t, epoch):
        """(value, status), status 0 while unpublished in this call."""
        tag = self.tag.get(t, 0)
        return self.value.get(t, 0), (tag & 3 if tag >> 2 == epoch else 0)


class Tile:
    """One tile's local scan (the kernel up to its second barrier) and
    its look-back state."""

    def __init__(self, t, g, order, seg, values, mask, n, count):
        lanes, warps, self.window = g
        shape = (warps, lanes, ITEMS)
        self.size = warps * lanes * ITEMS
        t0 = t * self.size
        pos = t0 + np.arange(self.size).reshape(shape)
        live = pos < n
        o = np.where(live, order[np.minimum(pos, n - 1)], 0)
        s = seg[o]  # one gather a position, at clamped indices
        m = np.ones(shape, bool) if mask is None else mask[o]
        v = values[np.where(m, o, 0)]  # under a mask, only where it keeps
        count["seg"] += s.size
        count["values"] += int(m.sum())
        s_pred = 0
        if t0 > 0:  # the tile's first position's predecessor, read once
            s_pred = seg[order[t0 - 1]]
            count["seg"] += 1
        up = _shfl_up(s[:, :, -1], 1, 1)
        prev = np.concatenate([up[:, :, None], s[:, :, :-1]], axis=2)
        first = (np.arange(ITEMS)[None, None, :] > 0) | (
            np.arange(lanes)[None, :, None] > 0)
        flag = (live & first & (s != prev)).astype(np.int64)
        v = np.where(live & m, v, NEG_KEY)
        run = (np.zeros((warps, lanes), np.int64),
               np.full((warps, lanes), NEG_KEY, np.int64))
        for k in range(ITEMS):
            run = _combine(run, (flag[..., k], v[..., k]))
        incl = _inclusive(run, 1)
        lane_ex = tuple(_shfl_up(a, 1, 1) for a in incl)
        tot = tuple(a[:, -1] for a in incl)
        w0 = t0 + np.arange(warps) * lanes * ITEMS
        start = np.zeros(warps, np.int64)
        start[0] = t0 == 0 or s[0, 0, 0] != s_pred
        start[1:] = (w0[1:] < n) & (s[1:, 0, 0] != s[:-1, -1, -1])
        wtot = (tot[0] | start, tot[1])
        inc = _inclusive(wtot, 0)
        ex = tuple(_shfl_up(a, 1, 0) for a in inc)
        ex = (np.where(np.arange(warps) > 0, ex[0], 0),
              np.where(np.arange(warps) > 0, ex[1], NEG_KEY))
        self.t, self.pos, self.live = t, pos, live
        self.flag, self.v, self.start = flag, v, start
        self.ex, self.lane_ex = ex, lane_ex
        self.agg = (int(inc[0][-1]), int(inc[1][-1]))
        self.carry = NEG_KEY
        self.hi = t - 1
        self.looking = t > 0 and not start[0]

    def look_back(self, words, limit=None):
        """One window of predecessors' words: False while one of them
        is unpublished (the kernel's lanes spin), else fold them back to
        the nearest complete word; True when done.  ``limit`` stops after
        that many predecessors whatever their words say (the negative
        control)."""
        pts = self.hi - np.arange(self.window)
        got = [words.read(int(p), self.epoch) if p >= 0 else (NEG_KEY, DONE)
               for p in pts]
        if any(st == 0 for _, st in got):
            return False
        done = [st == DONE for _, st in got]
        stop = done.index(True) if any(done) else self.window - 1
        if limit is not None:
            stop = min(stop, limit - 1)
        self.carry = max(self.carry, max(val for val, _ in got[:stop + 1]))
        if any(done) or limit is not None:
            self.looking = False
        self.hi -= self.window
        return True

    def finish(self, words, exclusive, out):
        """Publish the inclusive word where the tile holds no start,
        then write every position once."""
        if self.t > 0 and not self.start[0] and not self.agg[0]:
            words.publish(self.t, max(self.carry, self.agg[1]), DONE,
                          self.epoch)
        flag = self.flag.copy()
        wstart = self.start[:, None]
        lane = np.arange(flag.shape[1])[None, :]
        lf = np.where(lane > 0, self.lane_ex[0] | wstart, 0)
        la = np.where(lane > 0, self.lane_ex[1], NEG_KEY)
        pre = _combine((self.ex[0][:, None], self.ex[1][:, None]), (lf, la))
        flag[:, 0, 0] = self.start
        cur = np.where(pre[0] != 0, pre[1], np.maximum(self.carry, pre[1]))
        for k in range(ITEMS):
            f = flag[..., k] != 0
            before = np.where(f, NEG_KEY, cur)
            cur = np.where(f, self.v[..., k], np.maximum(cur, self.v[..., k]))
            r = before if exclusive else cur
            live = self.live[..., k]
            out[self.pos[..., k][live]] = r[live]


def model_seg_cummax(order, seg, values, mask=None, exclusive=True, *,
                     geometry="tile8", schedule="forward", resident=None,
                     words=None, limit=None, seed=0, count=None):
    """``seg_cummax`` as the single-pass kernel computes it (the plain
    version's arguments and result, CPU tensors)."""
    g = GEOMETRIES[geometry]
    order_n = order.numpy().astype(np.int64)
    seg_n, val_n = seg.numpy(), values.numpy()
    mask_n = None if mask is None else mask.numpy()
    n = order_n.shape[0]
    out = np.zeros(n, np.int64)
    if n == 0:
        return torch.from_numpy(out)
    tile = g[0] * g[1] * ITEMS
    tiles = -(-n // tile)
    words = Words() if words is None else words
    assert words.ticket == 0
    count = {"seg": 0, "values": 0} if count is None else count
    resident = tiles if resident is None else resident
    rng = np.random.default_rng(seed)
    claimed, running, finished = 0, {}, 0
    while finished < tiles:
        events = []  # (tile, what)
        if claimed < tiles and len(running) < resident:
            events.append((claimed, "claim"))
        for t, st in running.items():
            if not isinstance(st, Tile):  # claimed: its epoch
                events.append((t, "scan"))
            elif st.looking:
                events.append((t, "look"))
            else:
                events.append((t, "finish"))
        if schedule == "shuffle":
            rng.shuffle(events)
        else:
            events.sort(reverse=schedule == "reverse")
        for t, what in events:
            if what == "claim":
                tile_claimed, epoch = words.claim(tiles)
                assert tile_claimed == t
                running[t] = epoch
                claimed += 1
            elif what == "scan":
                epoch = running[t]
                st = running[t] = Tile(t, g, order_n, seg_n, val_n, mask_n,
                                       n, count)
                st.epoch = epoch
                words.publish(t, st.agg[1], DONE if st.agg[0] else PARTIAL,
                              epoch)
            elif what == "look":
                if not running[t].look_back(words, limit):
                    continue  # blocked on an unpublished word
            else:
                running.pop(t).finish(words, exclusive, out)
                finished += 1
            break
        else:
            raise AssertionError(f"deadlock: {sorted(running)} wait")
    count["tiles"] = count.get("tiles", 0) + tiles
    return torch.from_numpy(out)


# -- inputs -----------------------------------------------------------------

def _case(name, rng):
    """(seg, values, mask) by position, [n] each (mask None or bool)."""
    kind, _, arg = name.partition(":")
    if kind == "n":
        n = int(arg)
        seg = np.cumsum(rng.random(n) < 0.3)
        return seg, rng.integers(NEG_KEY, TOP, n), rng.random(n) < 0.7
    n = 300
    vals = rng.integers(NEG_KEY, TOP, n)
    if kind == "one_segment":
        return np.zeros(n, np.int64), vals, None
    if kind == "rising":  # one segment, the max moves every position
        return np.zeros(n, np.int64), np.arange(n, dtype=np.int64), None
    if kind == "falling":  # one segment, the max is the first position's
        return np.zeros(n, np.int64), -np.arange(n, dtype=np.int64), None
    if kind == "tile_edges":  # a start at every tile's first position
        return np.arange(n) // int(arg), vals, None
    if kind == "singles":
        return np.arange(n), vals, None
    if kind == "mask_false":
        return np.arange(n) // 7, vals, np.zeros(n, bool)
    if kind == "mask_true":
        return np.arange(n) // 7, vals, np.ones(n, bool)
    if kind == "extremes":
        pick = np.array([NEG_KEY, NEG_KEY + 1, TOP, TOP - 1], np.int64)
        return np.arange(n) // 11, rng.choice(pick, n), rng.random(n) < 0.8
    raise ValueError(name)


CASES = (["n:1", "n:7", "n:8", "n:9", "n:31", "n:32", "n:33", "n:257"]
         + ["one_segment", "rising", "falling", "tile_edges:8",
            "tile_edges:32", "singles", "mask_false", "mask_true",
            "extremes"])


def _inputs(name, seed=0):
    """CPU tensors (order, seg, values, mask) whose position i reads
    seg, values and mask at order[i], a random permutation."""
    rng = np.random.default_rng(CASES.index(name) * 7 + seed)
    seg, vals, mask = _case(name, rng)
    n = seg.shape[0]
    order = rng.permutation(n).astype(np.int32)
    s_st, v_st = np.empty(n, np.int64), np.empty(n, np.int64)
    s_st[order], v_st[order] = seg, vals
    m_st = None
    if mask is not None:
        m_st = np.empty(n, bool)
        m_st[order] = mask
    return (torch.from_numpy(order), torch.from_numpy(s_st),
            torch.from_numpy(v_st),
            None if m_st is None else torch.from_numpy(m_st))


def _by_position(order, seg, values, mask):
    """The reference scans' inputs: values by position (NEG_KEY where
    masked out) and segment ids from the starts."""
    o = order.numpy().astype(np.int64)
    s, v = seg.numpy()[o], values.numpy()[o]
    if mask is not None:
        v = np.where(mask.numpy()[o], v, NEG_KEY)
    starts = np.r_[True, s[1:] != s[:-1]]
    return v, np.cumsum(starts) - 1, starts


def _exclusive(incl, starts):
    return np.where(starts, NEG_KEY, np.r_[NEG_KEY, incl[:-1]])


# -- the tests ----------------------------------------------------------------

@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain_version(name, geometry):
    """The model in three schedules, exclusive and inclusive, with few
    tiles resident at once and with all, equals ``seg_cummax_plain``."""
    args = _inputs(name)
    for exclusive in (True, False):
        want = kw.seg_cummax_plain(*args, exclusive=exclusive)
        for schedule in SCHEDULES:
            for resident in (None, 3):
                got = model_seg_cummax(*args, exclusive=exclusive,
                                       geometry=geometry, schedule=schedule,
                                       resident=resident)
                assert torch.equal(got, want), (schedule, resident)


@pytest.mark.parametrize("name", CASES)
def test_model_matches_reference_scans(name):
    """The model against the reference's NumPy scan and its JAX scan
    (int64, inside ``jax.enable_x64(True)``), inclusive and exclusive."""
    args = _inputs(name, seed=1)
    v, seg_ids, starts = _by_position(*args)
    want_np = ref._seg_cummax_np(v, seg_ids)
    with jax.enable_x64(True):
        import jax.numpy as jnp

        want_jnp = np.asarray(ref._seg_cummax_jnp(
            jnp.asarray(v), jnp.asarray(seg_ids), v.shape[0]))
    np.testing.assert_array_equal(want_jnp, want_np)
    for schedule in SCHEDULES:
        got = model_seg_cummax(*args, exclusive=False, geometry="tile32",
                               schedule=schedule, seed=3)
        np.testing.assert_array_equal(got.numpy(), want_np)
        got = model_seg_cummax(*args, exclusive=True, geometry="tile8",
                               schedule=schedule, seed=4)
        np.testing.assert_array_equal(got.numpy(),
                                      _exclusive(want_np, starts))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_one_seg_gather_a_position(geometry, masked):
    """Each position gathers its segment key once, and each tile but
    the first one more, its predecessor's; a value once where no mask is
    given, else only where the mask keeps it (the positions past n read
    index 0)."""
    order, seg, values, mask = _inputs("n:257")
    if not masked:
        mask = None
    count = {"seg": 0, "values": 0}
    model_seg_cummax(order, seg, values, mask, geometry=geometry,
                     count=count)
    lanes, warps, _ = GEOMETRIES[geometry]
    tile = lanes * warps * ITEMS
    tiles = -(-257 // tile)
    kept = (tiles * tile if mask is None else
            int(mask.sum()) + (tiles * tile - 257) * int(mask[0]))
    assert count == {"seg": tiles * tile + tiles - 1, "values": kept,
                     "tiles": tiles}


def test_tile_words_kept_and_grown():
    """The wrapper's scratch (CPU tensors here): zero when made, the
    same words for a later call of as many tiles or fewer, new zeroed
    words, at least twice as many, for a call of more."""
    key = ("test_tile_words", 0)
    try:
        held = kw._tile_words(key, "cpu", 3)
        assert held.numel() == 8 and not held.any()
        held[2:4] = torch.tensor([7, 1 << 2 | 2])  # a tile's word
        assert kw._tile_words(key, "cpu", 2) is held
        assert held[3] == 1 << 2 | 2  # kept: its epoch tells it apart
        bigger = kw._tile_words(key, "cpu", 5)
        assert bigger.numel() == 16 and not bigger.any()
        assert kw._tile_words(key, "cpu", 9).numel() == 32
    finally:
        kw._TILE_WORDS.pop(key, None)


def test_each_call_leaves_the_header_ready():
    """After every call, whatever order its tiles finish in, the ticket
    is 0 and the epoch one more, so the same call made again on the
    same words (a replayed CUDA graph) is right again."""
    words = Words()
    args = _inputs("one_segment")
    want = kw.seg_cummax_plain(*args)
    for i, schedule in enumerate(SCHEDULES * 2):
        got = model_seg_cummax(*args, schedule=schedule, words=words,
                               seed=i)
        assert torch.equal(got, want), schedule
        assert (words.ticket, words.epoch) == (0, i + 1)


def test_stale_words_of_larger_calls_are_never_read():
    """Calls at falling n on one set of words, an earlier call's words
    (complete and partial, random values) under every tile: each call
    reads only its own epoch's words."""
    words = Words()
    words.epoch = 5
    words.stale(200, np.random.default_rng(9))
    for name in ("one_segment", "n:257", "n:33", "rising", "n:9"):
        args = _inputs(name)
        for schedule in SCHEDULES:
            got = model_seg_cummax(*args, schedule=schedule, words=words,
                                   seed=words.epoch)
            assert torch.equal(got, kw.seg_cummax_plain(*args)), name


@pytest.mark.parametrize("schedule", ["reverse", "shuffle"])
def test_negative_control_look_back_of_one(schedule):
    """A look-back that stops at its first predecessor's word, whatever
    that word says, gets one segment across many tiles wrong: a partial
    word there is no carry.  The full look-back gets it right."""
    args = _inputs("falling")
    want = kw.seg_cummax_plain(*args)
    bad = model_seg_cummax(*args, schedule=schedule, limit=1, seed=2)
    assert not torch.equal(bad, want)
    assert torch.equal(model_seg_cummax(*args, schedule=schedule, seed=2),
                       want)


# -- the model in the kernel's place --------------------------------------

VALUES = (None, 1, -4, 2.5, "x", b"\x01", "yy", "")


def _records(rng, pks, cols, sentinel=0.25, cl=None):
    n = len(pks)
    sent = rng.random(n) < sentinel
    cid = rng.integers(0, cols, n)
    cl = rng.integers(1, 6, n) if cl is None else cl
    ver = rng.integers(1, 5, n)
    val = rng.integers(0, len(VALUES), n)
    return [(f"p{p}", None, int(c), 0, None) if s
            else (f"p{p}", f"c{ci}", int(c), int(v), VALUES[x])
            for p, s, ci, c, v, x in zip(pks, sent, cid, cl, ver, val)]


BATCHES = ("n:1", "n:9", "n:33", "n:300", "long_row", "single_rows",
           "one_cell", "sentinels")


def _batch(name, warm):
    rng = np.random.default_rng(BATCHES.index(name) + 40)
    kind, _, arg = name.partition(":")
    if kind == "n":
        n = int(arg)
        recs = _records(rng, rng.integers(0, max(1, n // 4), n), 4)
    elif kind == "long_row":  # one row across many tiles, cl rising
        recs = (_records(rng, rng.integers(1, 9, 13), 4)
                + _records(rng, np.zeros(400, np.int64), 4,
                           cl=1 + np.arange(400) * 5 // 400)
                + _records(rng, rng.integers(1, 9, 21), 4))
    elif kind == "single_rows":
        recs = _records(rng, rng.permutation(150), 4)
    elif kind == "one_cell":  # one cell's rising accepts, shuffled in
        recs = (_records(rng, rng.integers(1, 6, 40), 4)
                + [("p0", "c1", 1, v + 1, VALUES[v % 8]) for v in range(120)])
        recs = [recs[i] for i in rng.permutation(len(recs))]
    else:
        recs = _records(rng, rng.integers(0, 60, 200), 4, sentinel=1.0)
    if not warm:
        return recs, {}, {}
    rows = sorted({r[0] for r in recs})
    seed_cls = {p: int(rng.integers(1, 5)) for p in rows
                if rng.random() < 0.9}
    seed_cells = {(p, f"c{c}"): (int(rng.integers(1, 5)),
                                 VALUES[int(rng.integers(0, 4))])
                  for p in seed_cls for c in range(4) if rng.random() < 0.5}
    return recs, seed_cls, seed_cells


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name", BATCHES)
def test_model_in_the_core_matches_reference(name, warm, monkeypatch):
    """The model in the kernel's place (``_winners_torch_core`` on the
    CPU, both domains) against the reference's NumPy twin, every
    ``MergeDecision`` field and ``impacted``."""
    records, seed_cls, seed_cells = _batch(name, warm)
    plan = port.encode_changes(records, seed_cls, seed_cells)
    rplan = ref.encode_changes(records, seed_cls, seed_cells)
    want = ref._winners_np(rplan)
    calls = []
    for schedule in ("reverse", "shuffle"):
        def model(*a, **k):
            calls.append(1)
            return model_seg_cummax(*a, **k, schedule=schedule,
                                    geometry="tile8", resident=3)
        monkeypatch.setattr(kw, "seg_cummax", model)
        got = port.select_winners(plan, backend="torch", device="cpu")
        assert decision_diff(got, want) == []
    assert len(calls) == 4  # domain A and domain B, each schedule
