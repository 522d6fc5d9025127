"""The exact sampler's learners' commit (``kernels/exact_send.py``
``exact_commit``, ``csrc/exact_send.cu`` ``exact_commit_kernel``) on
[S, n] windows of wider mask rows.

On the CPU the wrapper runs ``exact_commit_plain``.  These tests hold:
the plain version on windows (``x[:, lo:lo + n]`` of [S, N] masks, read
in place) against the same call on ``.contiguous()`` copies and against
the reference's formula (``corrosion_tpu/sim/calibrate.py:658-661``,
``:1232-1236``); a NumPy model of the kernel's index math (a warp's
tile of 512 positions, a lane's 16 by one 16-byte load of each mask or
by bytes at a row's head and tail, the learned bits shuffled to the
lane that stores each position) against the plain version, the words
around ``tx`` / ``next_send`` untouched, with negative controls; the
wrapper's argument checks; and the host layout's tick, which hands the
kernel its windows of the replicated masks without a copy.
"""

import numpy as np
import pytest
import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels import exact_send as es
from corrosion_tpu_torch.mesh import LocalFabric, Mesh
from corrosion_tpu_torch.models import sharded as ts
from corrosion_tpu_torch.sim import calibrate as tc

LANE = 16  # positions a lane loads: one 16-byte load of each mask
TILE = 32 * LANE  # positions a warp takes at once
TICK, MAX_TX = 7, 8
SENTINEL = 0x7F7F7F7F
PAD = 37  # sentinel words before and after tx / next_send


def _windows():
    """(N, S, lo, width): the full row, windows at lo 0, 3, 16 and N / 2
    of widths 1, 15, 16 and 17 (where they fit), and rows of 12,500
    (the sharded-dense shard's) in a row of 25,000."""
    out = []
    for n_full in (16, 1000, 4096):
        for s in (1, 3):
            out.append((n_full, s, 0, n_full))
            for lo in (0, 3, 16, n_full // 2):
                for width in (1, 15, 16, 17):
                    if lo + width <= n_full:
                        out.append((n_full, s, lo, width))
    for s in (1, 3):
        for lo in (0, 3, 12_500):
            out.append((25_000, s, lo, 12_500))
    return out


WINDOWS = _windows()


def _masks(n_full: int, s: int, lo: int, width: int, seed: int):
    """Seeded [S, N] masks with learners (new & ~infected) at the
    window's first and last byte, and a tier map of the window."""
    rng = np.random.default_rng(seed)
    inf = rng.random((s, n_full)) < 0.4
    new = inf | (rng.random((s, n_full)) < 0.3)
    for c in (lo, lo + width - 1):
        inf[:, c], new[:, c] = False, True
    tier = rng.integers(1, 6, width).astype(np.int32)
    return inf, new, tier


def _state(s: int, width: int, seed: int):
    rng = np.random.default_rng(seed + 1)
    tx = rng.integers(0, MAX_TX + 1, (s, width)).astype(np.int32)
    ns = rng.integers(0, 30, (s, width)).astype(np.int32)
    return tx, ns


def _reference(inf, new, tx, ns, tier):
    """The reference's commit: ``learned = new & ~infected``, a fresh
    budget, the first forward at ``tick + tier`` (``tick + 1``
    without tiers)."""
    learned = new & ~inf
    first = 1 if tier is None else tier[None, :]
    return (np.where(learned, MAX_TX, tx).astype(np.int32),
            np.where(learned, TICK + first, ns).astype(np.int32))


@pytest.mark.parametrize("use_tier", [False, True])
@pytest.mark.parametrize("n_full,s,lo,width", WINDOWS)
def test_plain_on_a_window_equals_contiguous_copies(n_full, s, lo, width,
                                                    use_tier):
    inf, new, tier = _masks(n_full, s, lo, width, seed=n_full + lo + width)
    tier_t = torch.from_numpy(tier) if use_tier else None
    tx, ns = _state(s, width, seed=lo)
    full_inf, full_new = torch.from_numpy(inf), torch.from_numpy(new)
    w_inf, w_new = full_inf[:, lo:lo + width], full_new[:, lo:lo + width]
    assert s == 1 or w_inf.stride() == (n_full, 1)
    got = [torch.from_numpy(tx.copy()), torch.from_numpy(ns.copy())]
    before = es.exact_commit.launches
    es.exact_commit(w_inf, w_new, *got, TICK, MAX_TX, tier=tier_t)
    assert es.exact_commit.launches == before  # the CPU runs no kernel
    want = [torch.from_numpy(tx.copy()), torch.from_numpy(ns.copy())]
    es.exact_commit_plain(w_inf.contiguous(), w_new.contiguous(), *want,
                          TICK, MAX_TX, tier_t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref = _reference(inf[:, lo:lo + width], new[:, lo:lo + width], tx, ns,
                     tier if use_tier else None)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    # the learners at the window's edges took their fresh budget
    for c in (0, width - 1):
        assert (got[0][:, c] == MAX_TX).all()
    # the masks were read, not written
    assert torch.equal(full_inf, torch.from_numpy(inf))
    assert torch.equal(full_new, torch.from_numpy(new))


# -- a NumPy model of the kernel's index math --------------------------


def kernel_model(inf_buf, new_buf, a_inf: int, a_new: int, ld_inf: int,
                 ld_new: int, s: int, n: int, tx_buf, ns_buf, out0: int,
                 tier, broken: str = ""):
    """``exact_commit_kernel`` on flat byte buffers: row r of a mask
    starts at byte ``a + r * ld`` (its address mod 16 is what the kernel
    sees); tx / next_send are [s, n] int32 from word ``out0`` of their
    buffers.  Tiles run in any order (here reversed, each row's too).
    ``broken`` names a negative control: ``"store_unframed"`` stores at
    the tile's positions counted from the row's first byte, not from the
    16-byte boundary the loads start at; ``"own_lane"`` stores with the
    storing lane's own bits (no shuffle).  Returns how many lanes took
    the 16-byte loads and how many the byte loads."""
    tiles = (n + 15 + TILE - 1) // TILE
    vec = (a_inf - a_new) % 16 == 0 and (ld_inf - ld_new) % 16 == 0
    lanes = np.arange(32)
    loads = {"vec": 0, "bytes": 0}
    for t in reversed(range(s * tiles)):
        row, tile = divmod(t, tiles)
        r_new, r_inf = a_new + row * ld_new, a_inf + row * ld_inf
        off = r_new % 16
        base = tile * TILE - off
        p0 = base + lanes * LANE
        pos = p0[:, None] + np.arange(LANE)[None, :]
        whole = vec & (p0 >= 0) & (p0 + LANE <= n)
        # a 16-byte load starts on a 16-byte boundary of both masks
        assert ((r_new + p0[whole]) % 16 == 0).all()
        assert ((r_inf + p0[whole]) % 16 == 0).all()
        loads["vec"] += int(whole.sum())
        loads["bytes"] += int((~whole & (p0 + LANE > 0) & (p0 < n)).sum())
        inside = (pos >= 0) & (pos < n)
        at = np.clip(pos, 0, n - 1)
        learned = inside & (new_buf[r_new + at] != 0) & (inf_buf[r_inf + at]
                                                         == 0)
        bits = (learned.astype(np.int64) << np.arange(LANE)).sum(1)
        busy = bits != 0
        if not busy.any():
            continue
        for j in range(LANE):
            if not (busy[2 * j] or busy[2 * j + 1]):
                continue
            if broken == "own_lane":
                mine = bits
            else:
                mine = bits[2 * j + (lanes >> 4)]
            store = ((mine >> (lanes & 15)) & 1) == 1
            first = tile * TILE if broken == "store_unframed" else base
            p = (first + 32 * j + lanes)[store]
            if broken:  # a broken mapping may point past the row
                p = p[(p >= 0) & (p < n)]
            assert ((p >= 0) & (p < n)).all()
            tx_buf[out0 + row * n + p] = MAX_TX
            ns_buf[out0 + row * n + p] = TICK + (1 if tier is None
                                                 else tier[p])
    return loads


def _model_case(n_full, s, lo, width, use_tier, a0: int, apart: int,
                broken: str = ""):
    """The model on a window of ``_masks``' pair laid out in flat
    buffers (infected's first byte at address ``a0``, new_infected's at
    ``a0 + apart`` mod 16), against the plain version."""
    inf, new, tier = _masks(n_full, s, lo, width, seed=3 * n_full + lo)
    tier = tier if use_tier else None
    tx, ns = _state(s, width, seed=width)
    inf_buf = np.zeros(a0 + s * n_full + 64, np.uint8)
    new_buf = np.zeros(a0 + apart + s * n_full + 64, np.uint8)
    inf_buf[a0:a0 + s * n_full] = inf.reshape(-1)
    new_buf[a0 + apart:a0 + apart + s * n_full] = new.reshape(-1)
    tx_buf = np.full(2 * PAD + s * width, SENTINEL, np.int32)
    ns_buf = tx_buf.copy()
    tx_buf[PAD:PAD + s * width] = tx.reshape(-1)
    ns_buf[PAD:PAD + s * width] = ns.reshape(-1)
    loads = kernel_model(inf_buf, new_buf, a0 + lo, a0 + apart + lo, n_full,
                         n_full, s, width, tx_buf, ns_buf, PAD, tier, broken)
    want = [torch.from_numpy(tx.copy()), torch.from_numpy(ns.copy())]
    es.exact_commit_plain(torch.from_numpy(inf)[:, lo:lo + width],
                          torch.from_numpy(new)[:, lo:lo + width], *want,
                          TICK, MAX_TX,
                          None if tier is None else torch.from_numpy(tier))
    got = [b[PAD:PAD + s * width].reshape(s, width) for b in (tx_buf,
                                                              ns_buf)]
    same = all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    pads = all((b[:PAD] == SENTINEL).all() and (b[-PAD:] == SENTINEL).all()
               for b in (tx_buf, ns_buf))
    return same, pads, loads


@pytest.mark.parametrize("use_tier", [False, True])
@pytest.mark.parametrize("n_full,s,lo,width", WINDOWS)
def test_kernel_model_equals_plain(n_full, s, lo, width, use_tier):
    """Allocations 16-byte aligned (the caching allocator's) and 5 bytes
    past a boundary, the two masks aligned alike (16-byte loads) and 3
    bytes apart (byte loads only)."""
    for a0, apart in ((0, 0), (5, 0), (0, 3)):
        same, pads, loads = _model_case(n_full, s, lo, width, use_tier, a0,
                                        apart)
        assert same and pads
        if apart:
            assert loads["vec"] == 0
        elif width >= 2 * LANE + 15:
            assert loads["vec"] > 0


@pytest.mark.parametrize("a0", [0, 5])
def test_kernel_model_loads_bytes_only_at_a_rows_edges(a0):
    """Rows of 12,500 (not a multiple of 16) in a row of 25,000: a row's
    lanes take byte loads at its head and tail only."""
    s, n_full, lo, width = 3, 25_000, 3, 12_500
    same, pads, loads = _model_case(n_full, s, lo, width, False, a0, 0)
    assert same and pads
    assert 0 < loads["bytes"] <= 2 * s
    # every 16-byte group a row's bytes touch, once
    groups = sum(-(-((a0 + lo + r * n_full) % 16 + width) // 16)
                 for r in range(s))
    assert loads["vec"] + loads["bytes"] == groups


@pytest.mark.parametrize("broken", ["store_unframed", "own_lane"])
def test_kernel_model_negative_controls(broken):
    """A tile framed at the row's first byte, or stores with the storing
    lane's own bits, break the equality on an unaligned window."""
    same, pads, _ = _model_case(4096, 3, 3, 1000, True, 0, 0, broken)
    assert pads and not same


# -- the wrapper's argument checks -------------------------------------


def _args(s=2, n=40):
    inf = torch.zeros((s, n), dtype=torch.bool)
    new = torch.ones((s, n), dtype=torch.bool)
    return (inf, new, torch.zeros((s, n), dtype=torch.int32),
            torch.zeros((s, n), dtype=torch.int32))


@pytest.mark.parametrize("bad", [
    "column_stride", "transposed", "overlapping_rows", "mask_dtype",
    "new_dtype", "tx_dtype", "next_send_dtype", "tx_shape", "new_shape",
    "tier_shape", "tier_dtype"])
def test_wrapper_refuses_other_layouts(bad):
    inf, new, tx, ns = _args()
    wide = torch.zeros((2, 80), dtype=torch.bool)
    tier = None
    if bad == "column_stride":
        inf = wide[:, ::2]
    elif bad == "transposed":
        new = torch.ones((40, 2), dtype=torch.bool).t()
    elif bad == "overlapping_rows":
        inf = torch.as_strided(wide, (2, 40), (20, 1))
    elif bad == "mask_dtype":
        inf = inf.to(torch.uint8)
    elif bad == "new_dtype":
        new = new.to(torch.int32)
    elif bad == "tx_dtype":
        tx = tx.to(torch.int64)
    elif bad == "next_send_dtype":
        ns = ns.to(torch.int16)
    elif bad == "tx_shape":
        tx = torch.zeros((2, 41), dtype=torch.int32)
    elif bad == "new_shape":
        new = torch.ones((3, 40), dtype=torch.bool)
    elif bad == "tier_shape":
        tier = torch.ones(41, dtype=torch.int32)
    elif bad == "tier_dtype":
        tier = torch.ones(40, dtype=torch.int64)
    before = [t.clone() for t in (tx, ns)]
    launches = es.exact_commit.launches
    with pytest.raises(ValueError, match="exact_commit"):
        es.exact_commit(inf, new, tx, ns, TICK, MAX_TX, tier=tier)
    assert es.exact_commit.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(before, (tx, ns)))


def test_wrapper_takes_one_row_of_any_stride_and_a_window():
    """A [1, n] row of any row stride, and a window whose rows are as
    far apart as the width, go through; the CPU counts no launch."""
    wide = torch.zeros((3, 64), dtype=torch.bool)
    new = torch.ones((3, 64), dtype=torch.bool)
    launches = es.exact_commit.launches
    for w_inf, w_new in ((wide[1:2, 5:45], new[2:3, 7:47]),
                         (wide[:, 10:54], new[:, 10:54]), (wide, new)):
        s, n = w_inf.shape
        tx = torch.zeros((s, n), dtype=torch.int32)
        ns = torch.zeros((s, n), dtype=torch.int32)
        es.exact_commit(w_inf, w_new, tx, ns, TICK, MAX_TX)
        assert (tx == MAX_TX).all() and (ns == TICK + 1).all()
    assert es.exact_commit.launches == launches


def test_cuda_without_a_card_raises():
    """The host layout on the card without one raises, and so does
    loading the kernel where no ``nvcc`` builds it: nothing falls back to
    the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the calls would run")
    cfg = tc.HeadlineExactConfig(n_nodes=256, fanout=4, ring0_size=64,
                                 max_transmissions=8, loss=0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_exact_headline(cfg, n_seeds=2, kernel="sparse",
                              host_sharded=True,
                              mesh=Mesh("hosts", LocalFabric(2, "cuda")))
    if kernels.library_path("exact_send").exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.function("exact_send", "exact_commit_launch",
                         es._COMMIT_ARGTYPES)


# -- the host layout hands the kernel its windows -----------------------


def test_host_layout_commits_windows_in_place(monkeypatch):
    """``sharded_frontier_host_step``'s commit gets each host's [S,
    n_local] windows of the replicated [S, N] masks as views (stride (N,
    1), no copy), and the run equals one whose commit gets
    ``.contiguous()`` copies."""
    cfg = tc.HeadlineExactConfig(n_nodes=256, fanout=4, ring0_size=64,
                                 max_transmissions=8, loss=0.05,
                                 partition_blocks=2, heal_tick=3,
                                 sync_interval=2, backoff_ticks=0.5,
                                 max_ticks=48, chunk_ticks=8)
    seen = []

    def spy(copy):
        def commit(infected, new_infected, tx, next_send, tick, max_tx,
                   tier=None):
            seen.append((infected.stride(), new_infected.stride(),
                         infected.is_contiguous(), infected.shape))
            if copy:
                infected = infected.contiguous()
                new_infected = new_infected.contiguous()
            return es.exact_commit(infected, new_infected, tx, next_send,
                                   tick, max_tx, tier)
        return commit

    runs = []
    for copy in (False, True):
        seen.clear()
        monkeypatch.setattr(ts, "exact_commit", spy(copy))
        runs.append(tc.run_exact_headline(
            cfg, n_seeds=2, seed=0, kernel="sparse", host_sharded=True,
            mesh=Mesh("hosts", LocalFabric(2, "cpu")), device="cpu"))
        assert seen
        for st_inf, st_new, contiguous, shape in seen:
            assert shape == (2, 128)
            assert st_inf == st_new == (256, 1) and not contiguous
    keys = ("converged_frac", "ticks_p50", "ticks_p99", "seed_ticks",
            "seed_msgs_mean", "seed_msgs_p99", "msgs_per_node_mean")
    assert {k: runs[0][k] for k in keys} == {k: runs[1][k] for k in keys}
