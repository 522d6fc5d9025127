"""The host layout's validity wire (``kernels/fabric.py``: ``bits_pack``,
``bits_pack_above``, ``bits_pack_active``, ``bits_unpack``,
``bits_unpack_add``; ``csrc/fabric.cu``) against the reference's
``_pack_bits`` / ``_unpack_bits`` (``corrosion_tpu/models/sharded.py``
:57-72) and its exchange (:615-621, the rejection loop :669-683).

On the CPU the wrappers run their plain versions.  These tests hold:
the plain versions against the reference on seeded masks (the still-bad
rows ``rounds > t``, the active predicate on windows of the replicated
mask, a sequence of rounds unpacked into ``accepted``, nested and not);
a NumPy model of each kernel's index math (the two multiply tricks over
all 256 values, the 16-byte groups and the scalar head and tail at
every alignment, the ballot's lane-to-bit mapping, the warp's chunks
shuffled to the storing lane, the sector rewrites of a later round, the
count) against the plain versions, every byte around the outputs left
as it was, with negative controls; the wrappers' argument checks; and
the host layout's exchange, which packs from the sources, unpacks into
``accepted`` and never packs a bool mask, with the reference's bytes on
the fabric.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import sharded as js
from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels import fabric
from corrosion_tpu_torch.mesh import LocalFabric, Mesh
from corrosion_tpu_torch.sim import calibrate as tc

WIDTHS = (16, 1000, 4096)
SEEDS = (1, 3)
SHARDS = 2
TICK = 5
SENTINEL = 0xA5
FORMS = ("bits_pack", "bits_pack_above", "bits_pack_active", "bits_unpack",
         "bits_unpack_add")


def _launches():
    return {name: getattr(fabric, name).launches for name in FORMS}


def _ref_pack(mask):
    return np.array(js._pack_bits(jnp.asarray(mask)))


def _ref_unpack(wire, m):
    return np.array(js._unpack_bits(jnp.asarray(wire), m))


# -- the plain versions against the reference --------------------------


@pytest.mark.parametrize("t", [0, 1, 3])
@pytest.mark.parametrize("s", SEEDS)
@pytest.mark.parametrize("n", WIDTHS)
def test_pack_above_matches_reference(n, s, t):
    x = np.random.default_rng(7 * n + s + t).integers(
        -2, 6, (s, n)).astype(np.int32)
    want = _ref_pack(x > t)
    xt = torch.from_numpy(x)
    before = _launches()
    np.testing.assert_array_equal(fabric.bits_pack_above(xt, t).numpy(), want)
    np.testing.assert_array_equal(
        fabric.bits_pack_above_plain(xt, t).numpy(), want)
    assert _launches() == before  # the CPU runs no kernel


def _windows():
    """(N, S, lo, width): a shard's byte-aligned width of N over 2 hosts
    at lo 0, 8 and N / 2."""
    out = []
    for n in WIDTHS:
        width = n // SHARDS // 8 * 8
        for s in SEEDS:
            for lo in sorted({0, 8, n // 2}):
                if lo + width <= n:
                    out.append((n, s, lo, width))
    return out


@pytest.mark.parametrize("n,s,lo,width", _windows())
def test_pack_active_matches_reference(n, s, lo, width):
    rng = np.random.default_rng(n + s + lo)
    inf = rng.random((s, n)) < 0.5
    tx = rng.integers(0, 3, (s, width)).astype(np.int32)
    ns = rng.integers(0, 2 * TICK, (s, width)).astype(np.int32)
    ref = (jnp.asarray(inf)[:, lo:lo + width] & (jnp.asarray(tx) > 0)
           & (jnp.asarray(ns) <= TICK))
    full = torch.from_numpy(inf)
    window = full[:, lo:lo + width]
    assert s == 1 or window.stride() == (n, 1)
    before = _launches()
    for fn in (fabric.bits_pack_active, fabric.bits_pack_active_plain):
        active, wire = fn(window, torch.from_numpy(tx), torch.from_numpy(ns),
                          TICK)
        np.testing.assert_array_equal(active.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(wire.numpy(), _ref_pack(ref))
    assert _launches() == before
    assert torch.equal(full, torch.from_numpy(inf))  # read, not written


@pytest.mark.parametrize("nested", [True, False])
@pytest.mark.parametrize("s", SEEDS)
@pytest.mark.parametrize("n", WIDTHS)
def test_unpack_add_over_rounds_matches_reference(n, s, nested):
    """Round by round, ``bits_unpack_add`` (the first round writing over
    whatever ``accepted`` held) equals ``zeros`` and ``+=`` of the
    reference's unpack; its count is the round's set bits."""
    rng = np.random.default_rng(n * s + nested)
    if nested:  # the rejection loop's masks: rounds > r + 1
        rounds = rng.integers(0, 6, (s, n))
        masks = [rounds > r + 1 for r in range(5)]
    else:
        masks = [rng.random((s, n)) < 0.3 for _ in range(4)]
    want = np.zeros((s, n), np.int32)
    got = torch.full((s, n), 77, dtype=torch.int32)
    plain = got.clone()
    before = _launches()
    for r, mask in enumerate(masks):
        wire = _ref_pack(mask)
        want += _ref_unpack(wire, n)
        c = fabric.bits_unpack_add(torch.from_numpy(wire), n, got, r == 0)
        cp = fabric.bits_unpack_add_plain(torch.from_numpy(wire), n, plain,
                                          r == 0)
        assert int(c) == int(cp) == int(mask.sum())
        assert c.dtype == torch.int32 and tuple(c.shape) == (1,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(plain.numpy(), want)
    assert _launches() == before


@pytest.mark.parametrize("n", WIDTHS)
def test_unpack_counts_into_a_given_tensor(n):
    mask = np.random.default_rng(n).random((3, n)) < 0.4
    wire = torch.from_numpy(_ref_pack(mask))
    count = torch.full((1,), -1, dtype=torch.int32)
    got = fabric.bits_unpack(wire, n, count=count)
    np.testing.assert_array_equal(got.numpy(), _ref_unpack(wire.numpy(), n))
    assert int(count) == int(mask.sum())
    assert torch.equal(fabric.bits_unpack(wire, n), got)


# -- a NumPy model of the kernels' index math ---------------------------

U64 = (1 << 64) - 1


def pack8(w: int) -> int:
    """fabric.cu pack8: 8 bool bytes to a wire byte, byte q to bit q."""
    return (((w & 0x0101010101010101) * 0x0102040810204080) & U64) >> 56


def spread8(v: int) -> int:
    """fabric.cu spread8: a wire byte to 8 bool bytes, bit q to byte q."""
    return (((((v * 0x0101010101010101) & U64) & 0x8040201008040201)
             + 0x7F7F7F7F7F7F7F7F) >> 7) & 0x0101010101010101


def test_multiply_tricks_over_all_bytes():
    for v in range(256):
        bools = [(v >> q) & 1 for q in range(8)]
        assert spread8(v).to_bytes(8, "little") == bytes(bools)
        assert pack8(int.from_bytes(bytes(bools), "little")) == v
    # negative control: the multiplier reversed packs MSB first
    wrong = [(((int.from_bytes(bytes((v >> q) & 1 for q in range(8)),
                                "little") * 0x8040201008040201) & U64) >> 56)
             & 0xFF for v in range(256)]
    assert wrong != list(range(256))


class Heap:
    """Flat bytes from a 16-byte aligned base, SENTINEL wherever no
    buffer was put: the model's loads and stores go through it, each
    checked for its alignment and kept to what was put there."""

    def __init__(self, size: int):
        self.b = np.full(size, SENTINEL, np.uint8)
        self.owned = np.zeros(size, bool)

    def put(self, addr: int, data) -> int:
        raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        self.b[addr:addr + raw.size] = raw
        self.owned[addr:addr + raw.size] = True
        return addr

    def reserve(self, addr: int, nbytes: int) -> int:
        self.owned[addr:addr + nbytes] = True
        return addr

    def load(self, addr: int, nbytes: int, align: int = 1) -> bytes:
        assert addr % align == 0, (addr, align)
        assert self.owned[addr:addr + nbytes].all(), ("load", addr, nbytes)
        return self.b[addr:addr + nbytes].tobytes()

    def store(self, addr: int, data: bytes, align: int = 1) -> None:
        assert addr % align == 0, (addr, align)
        assert self.owned[addr:addr + len(data)].all(), ("store", addr)
        self.b[addr:addr + len(data)] = np.frombuffer(data, np.uint8)

    def get(self, addr: int, nbytes: int, dtype=np.uint8):
        return self.b[addr:addr + nbytes].copy().view(dtype)

    def untouched_outside(self, keep) -> bool:
        """Every byte outside the ranges ``keep`` ((addr, nbytes)) still
        holds SENTINEL."""
        mask = np.ones(self.b.size, bool)
        for addr, nbytes in keep:
            mask[addr:addr + nbytes] = False
        return bool((self.b[mask] == SENTINEL).all())


def split(wire: int, align: int, unit: int, side: int, per: int,
          nbytes: int):
    """fabric.cu split: (head, units, scalar)."""
    for h in range(min(16, nbytes + 1)):
        if (wire + h) % align == 0 and (side + h * per) % 16 == 0:
            units = (nbytes - h) // unit
            return h, units, nbytes - units * unit
    return nbytes, 0, nbytes


def scalar_byte(sp, unit: int, i: int) -> int:
    head, units, _ = sp
    return i if i < head else i + units * unit


def model_pack(heap, mask, wire, nbytes):
    """bits_pack_kernel: a unit 4 wire bytes from two 16-byte loads."""
    sp = split(wire, 4, 4, mask, 8, nbytes)
    head, units, scalar = sp
    for i in range(units + scalar):
        if i < units:
            b = head + 4 * i
            raw = heap.load(mask + 8 * b, 16, 16) + heap.load(
                mask + 8 * b + 16, 16, 16)
            out = bytes(pack8(int.from_bytes(raw[8 * q:8 * q + 8], "little"))
                        for q in range(4))
            heap.store(wire + b, out, 4)
        else:
            b = scalar_byte(sp, 4, i - units)
            w = int.from_bytes(b"".join(heap.load(mask + 8 * b + q, 1)
                                        for q in range(8)), "little")
            heap.store(wire + b, bytes([pack8(w)]))


def chunk_of(bits: int, chunk: int) -> bytes:
    if chunk == 16:
        return (spread8(bits & 0xFF).to_bytes(8, "little")
                + spread8(bits >> 8).to_bytes(8, "little"))
    return np.array([(bits >> q) & 1 for q in range(4)], np.int32).tobytes()


def model_unpack(heap, wire, out, nbytes, elem: int, shuffle=True) -> int:
    """bits_unpack_kernel<CHUNK, T>: a warp's tile of 32 words, store j
    of lane l the tile's chunk 32 j + l, its bits from the word's lane
    (``shuffle=False``: from the lane's own word, a negative control);
    then the scalar bytes.  Returns the count."""
    chunk = 16 if elem == 1 else 4
    per = 1024 // chunk // 32
    sp = split(wire, 4, 4, out, 8 * elem, nbytes)
    head, units, scalar = sp
    count = 0
    for w0 in range(0, units, 32):
        words = [int.from_bytes(heap.load(wire + head + 4 * (w0 + lane), 4,
                                          4), "little")
                 if w0 + lane < units else 0 for lane in range(32)]
        count += sum(bin(w).count("1") for w in words)
        base = out + (8 * head + 32 * w0) * elem
        for j in range(per):
            for lane in range(32):
                c = 32 * j + lane
                src = c * chunk // 32
                v = words[src if shuffle else lane]
                if w0 + src < units:
                    bits = (v >> (c * chunk % 32)) & ((1 << chunk) - 1)
                    heap.store(base + 16 * c, chunk_of(bits, chunk), 16)
    for i in range(scalar):
        b = scalar_byte(sp, 4, i)
        v = heap.load(wire + b, 1)[0]
        count += bin(v).count("1")
        for q in range(8):
            heap.store(out + (8 * b + q) * elem,
                       ((v >> q) & 1).to_bytes(elem, "little"), elem)
    return count


def model_unpack_add(heap, wire, acc, nbytes, touched) -> int:
    """bits_unpack_add_kernel (a later round): a unit 16 wire bytes; a
    set byte rewrites its 32-byte sector (``touched`` collects them)."""
    sp = split(wire, 16, 16, acc, 32, nbytes)
    head, units, scalar = sp
    count = 0

    def add_sector(b, v):
        addr = acc + 32 * b
        raw = heap.load(addr, 16, 16) + heap.load(addr + 16, 16, 16)
        vals = np.frombuffer(raw, np.int32).copy()
        vals += [(v >> q) & 1 for q in range(8)]
        heap.store(addr, vals[:4].tobytes(), 16)
        heap.store(addr + 16, vals[4:].tobytes(), 16)
        touched.add(b)

    for i in range(units + scalar):
        if i < units:
            b = head + 16 * i
            raw = heap.load(wire + b, 16, 16)
            for e, v in enumerate(raw):
                count += bin(v).count("1")
                if v:
                    add_sector(b + e, v)
        else:
            b = scalar_byte(sp, 16, i - units)
            v = heap.load(wire + b, 1)[0]
            count += bin(v).count("1")
            for q in range(8):
                if (v >> q) & 1:
                    a = acc + 4 * (8 * b + q)
                    x = int.from_bytes(heap.load(a, 4, 4), "little",
                                       signed=True)
                    heap.store(a, (x + 1).to_bytes(4, "little", signed=True),
                               4)
                    touched.add(b)
    return count


def store_word(heap, wire, nbytes, k, word):
    b = 4 * k
    if b + 4 <= nbytes:
        heap.store(wire + b, word.to_bytes(4, "little"), 4)
    else:
        for e in range(nbytes - b):
            heap.store(wire + b + e, bytes([(word >> (8 * e)) & 0xFF]))


def ballot_tiles(n: int, pred, wire_store, reverse=False):
    """The tiles of bits_pack_above_kernel / bits_pack_active_kernel:
    per 1024 positions, lane l evaluates position 32 j + l, the ballot
    of j (bit l lane l's predicate; ``reverse``, a negative control:
    bit 31 - l) is kept by lane j, which stores wire word p0 / 32 + j."""
    for p0 in range(0, n, 1024):
        ballots = []
        for j in range(32):
            bits = 0
            for lane in range(32):
                p = p0 + 32 * j + lane
                if p < n and pred(lane, j, p):
                    bits |= 1 << (31 - lane if reverse else lane)
            ballots.append(bits)
        for lane in range(32):
            if p0 + 32 * lane < n:
                wire_store(p0 // 32 + lane, ballots[lane])


def model_pack_above(heap, x, t, wire, n, reverse=False):
    def pred(lane, j, p):
        return int.from_bytes(heap.load(x + 4 * p, 4, 4), "little",
                              signed=True) > t

    ballot_tiles(n, pred, lambda k, w: store_word(heap, wire, n // 8, k, w),
                 reverse)


def model_pack_active(heap, inf, ld, tx, ns, tick, act, wire, s, m):
    """bits_pack_active_kernel, in the tiles of ``ballot_tiles``: lane
    l's row and column from its first position of the tile, then 32
    further a step, wrapping rows; the bool mask stored a byte a lane."""
    rows = {}

    def pred(lane, j, p):
        if j == 0:
            rows[lane] = divmod(p, m)
        row, col = rows[lane]
        a = (heap.load(inf + row * ld + col, 1)[0] != 0
             and int.from_bytes(heap.load(tx + 4 * p, 4, 4), "little",
                                signed=True) > 0
             and int.from_bytes(heap.load(ns + 4 * p, 4, 4), "little",
                                signed=True) <= tick)
        heap.store(act + p, bytes([a]))
        col += 32
        while col >= m:
            col -= m
            row += 1
        rows[lane] = (row, col)
        return a

    ballot_tiles(s * m, pred,
                 lambda k, w: store_word(heap, wire, s * m // 8, k, w))


MODEL_WIDTHS = (8, 24, 1000, 4096)
PAD = 48  # bytes of sentinel before and after every buffer


@pytest.mark.parametrize("mask_off,wire_off", [(0, 0), (3, 0), (8, 1),
                                               (16, 2), (5, 3)])
@pytest.mark.parametrize("s", SEEDS)
@pytest.mark.parametrize("m", MODEL_WIDTHS)
def test_pack_model_equals_plain(m, s, mask_off, wire_off):
    mask = np.random.default_rng(m + s + mask_off).random((s, m)) < 0.4
    nbytes = s * m // 8
    heap = Heap(2 * PAD + s * m + nbytes + 64)
    a_mask = heap.put(PAD + mask_off, mask.astype(np.uint8))
    a_wire = heap.reserve(((a_mask + s * m + PAD) // 16) * 16 + wire_off,
                          nbytes)
    model_pack(heap, a_mask, a_wire, nbytes)
    want = fabric.bits_pack_plain(torch.from_numpy(mask)).numpy().reshape(-1)
    np.testing.assert_array_equal(heap.get(a_wire, nbytes), want)
    assert heap.untouched_outside([(a_mask, s * m), (a_wire, nbytes)])


@pytest.mark.parametrize("elem", [1, 4])
@pytest.mark.parametrize("wire_off,out_off", [(0, 0), (1, 0), (2, 8),
                                              (4, 4), (3, 12)])
@pytest.mark.parametrize("s", SEEDS)
@pytest.mark.parametrize("m", MODEL_WIDTHS)
def test_unpack_model_equals_plain(m, s, wire_off, out_off, elem):
    """bits_unpack (elem 1, bool) and bits_unpack_add's first round (elem
    4, int32 0 / 1 over whatever the buffer held)."""
    mask = np.random.default_rng(m * s + wire_off).random((s, m)) < 0.3
    wire = fabric.bits_pack_plain(torch.from_numpy(mask)).numpy()
    nbytes = wire.size
    heap = Heap(2 * PAD + nbytes + s * m * elem + 64)
    a_wire = heap.put(PAD + wire_off, wire)
    a_out = heap.reserve(((a_wire + nbytes + PAD) // 16) * 16 + out_off,
                         s * m * elem)
    count = model_unpack(heap, a_wire, a_out, nbytes, elem)
    want = fabric.bits_unpack_plain(torch.from_numpy(wire), m).numpy()
    got = heap.get(a_out, s * m * elem, np.uint8 if elem == 1 else np.int32)
    np.testing.assert_array_equal(got, want.reshape(-1).astype(got.dtype))
    assert count == int(mask.sum())
    assert heap.untouched_outside([(a_wire, nbytes), (a_out, s * m * elem)])


@pytest.mark.parametrize("wire_off,acc_off", [(0, 0), (5, 0), (16, 4),
                                              (9, 8)])
@pytest.mark.parametrize("s", SEEDS)
@pytest.mark.parametrize("m", MODEL_WIDTHS)
def test_unpack_add_model_equals_plain(m, s, wire_off, acc_off):
    """A first round (elem 4) then two later rounds into one accepted
    buffer; a later round rewrites only the sectors holding a set bit."""
    rng = np.random.default_rng(m + s * 11 + acc_off)
    rounds = rng.integers(0, 4, (s, m))
    masks = [rounds > r + 1 for r in range(3)]
    nbytes = s * m // 8
    heap = Heap(4 * PAD + nbytes + 8 * s * m + 64)
    start = ((PAD + 4 * s * m) // 16 + 1) * 16
    a_acc = heap.reserve(start + acc_off, 4 * s * m)
    plain = torch.full((s, m), 77, dtype=torch.int32)
    heap.put(a_acc, plain.numpy())
    a_wire = a_acc + 4 * s * m + PAD + wire_off
    for r, mask in enumerate(masks):
        wire = fabric.bits_pack_plain(torch.from_numpy(mask)).numpy()
        heap.put(a_wire, wire)
        touched = set()
        if r == 0:
            count = model_unpack(heap, a_wire, a_acc, nbytes, 4)
        else:
            count = model_unpack_add(heap, a_wire, a_acc, nbytes, touched)
            assert touched == set(np.flatnonzero(wire.reshape(-1)))
        want = fabric.bits_unpack_add_plain(torch.from_numpy(wire), m, plain,
                                            r == 0)
        assert count == int(want)
        np.testing.assert_array_equal(heap.get(a_acc, 4 * s * m, np.int32),
                                      plain.numpy().reshape(-1))
    assert heap.untouched_outside([(a_acc, 4 * s * m), (a_wire, nbytes)])


@pytest.mark.parametrize("x_off", [0, 4, 12])
@pytest.mark.parametrize("s", SEEDS)
@pytest.mark.parametrize("m", MODEL_WIDTHS)
def test_pack_above_model_equals_plain(m, s, x_off):
    x = np.random.default_rng(m + s + x_off).integers(
        0, 5, (s, m)).astype(np.int32)
    nbytes = s * m // 8
    heap = Heap(2 * PAD + 4 * s * m + nbytes + 64)
    a_x = heap.put(PAD + x_off, x)
    a_wire = heap.reserve(((a_x + 4 * s * m + PAD) // 16) * 16, nbytes)
    model_pack_above(heap, a_x, 2, a_wire, s * m)
    want = fabric.bits_pack_above_plain(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(heap.get(a_wire, nbytes),
                                  want.reshape(-1))
    assert heap.untouched_outside([(a_x, 4 * s * m), (a_wire, nbytes)])


@pytest.mark.parametrize("lo", [0, 8, 3])
@pytest.mark.parametrize("s", SEEDS)
@pytest.mark.parametrize("m", MODEL_WIDTHS)
def test_pack_active_model_equals_plain(m, s, lo):
    """The window [S, m] at column lo of [S, m + 16] rows, read by its
    row stride."""
    rng = np.random.default_rng(m * 3 + s + lo)
    full = rng.random((s, m + 16)) < 0.5
    tx = rng.integers(0, 3, (s, m)).astype(np.int32)
    ns = rng.integers(0, 2 * TICK, (s, m)).astype(np.int32)
    nbytes = s * m // 8
    heap = Heap(5 * PAD + full.size + 9 * s * m + nbytes + 64)
    a_inf = heap.put(PAD, full.astype(np.uint8))
    a_tx = heap.put(((a_inf + full.size + PAD) // 16) * 16, tx)
    a_ns = heap.put(a_tx + 4 * s * m + PAD, ns)
    a_act = heap.reserve(a_ns + 4 * s * m + PAD, s * m)
    a_wire = heap.reserve(((a_act + s * m + PAD) // 16) * 16, nbytes)
    model_pack_active(heap, a_inf + lo, m + 16, a_tx, a_ns, TICK, a_act,
                      a_wire, s, m)
    active, wire = fabric.bits_pack_active_plain(
        torch.from_numpy(full)[:, lo:lo + m], torch.from_numpy(tx),
        torch.from_numpy(ns), TICK)
    np.testing.assert_array_equal(heap.get(a_act, s * m),
                                  active.numpy().reshape(-1))
    np.testing.assert_array_equal(heap.get(a_wire, nbytes),
                                  wire.numpy().reshape(-1))
    assert heap.untouched_outside([(a_inf, full.size), (a_tx, 4 * s * m),
                                   (a_ns, 4 * s * m), (a_act, s * m),
                                   (a_wire, nbytes)])


def test_model_negative_controls():
    """The models fail where the kernels would be wrong: a ballot read
    MSB first, chunks stored without the shuffle, and a body that
    ignores the head (its 16-byte loads off their alignment)."""
    m, s = 1000, 3
    x = np.random.default_rng(1).integers(0, 5, (s, m)).astype(np.int32)
    heap = Heap(2 * PAD + 4 * s * m + s * m // 8 + 64)
    a_x = heap.put(PAD, x)
    a_wire = heap.reserve(((a_x + 4 * s * m + PAD) // 16) * 16, s * m // 8)
    model_pack_above(heap, a_x, 2, a_wire, s * m, reverse=True)
    want = fabric.bits_pack_above_plain(torch.from_numpy(x), 2).numpy()
    assert not np.array_equal(heap.get(a_wire, s * m // 8), want.reshape(-1))

    mask = np.random.default_rng(2).random((s, m)) < 0.3
    wire = fabric.bits_pack_plain(torch.from_numpy(mask)).numpy()
    heap = Heap(2 * PAD + wire.size + s * m + 64)
    a_wire = heap.put(PAD, wire)
    a_out = heap.reserve(((a_wire + wire.size + PAD) // 16) * 16, s * m)
    model_unpack(heap, a_wire, a_out, wire.size, 1, shuffle=False)
    assert not np.array_equal(heap.get(a_out, s * m),
                              mask.reshape(-1).astype(np.uint8))

    heap = Heap(2 * PAD + s * m + wire.size + 64)
    a_mask = heap.put(PAD + 3, mask.astype(np.uint8))
    a_wire = heap.reserve(((a_mask + s * m + PAD) // 16) * 16, wire.size)
    with pytest.raises(AssertionError):
        for i in range(4):  # the body from byte 0, head ignored
            heap.load(a_mask + 32 * i, 16, 16)


# -- the wrappers' argument checks --------------------------------------


def _bad_calls():
    i32, b = torch.int32, torch.bool
    ok_inf = torch.zeros((2, 16), dtype=b)
    ok = torch.zeros((2, 16), dtype=i32)
    wire = torch.zeros((2, 2), dtype=torch.uint8)
    wide = torch.zeros((2, 32), dtype=b)
    return {
        "above float": lambda: fabric.bits_pack_above(
            torch.zeros((2, 16)), 0),
        "above int64": lambda: fabric.bits_pack_above(
            torch.zeros((2, 16), dtype=torch.int64), 0),
        "above ragged": lambda: fabric.bits_pack_above(
            torch.zeros((2, 12), dtype=i32), 0),
        "pack ragged": lambda: fabric.bits_pack(torch.zeros((2, 12),
                                                            dtype=b)),
        "active tx int64": lambda: fabric.bits_pack_active(
            ok_inf, ok.long(), ok, TICK),
        "active ragged": lambda: fabric.bits_pack_active(
            torch.zeros((2, 12), dtype=b), torch.zeros((2, 12), dtype=i32),
            torch.zeros((2, 12), dtype=i32), TICK),
        "active infected uint8": lambda: fabric.bits_pack_active(
            ok_inf.to(torch.uint8), ok, ok, TICK),
        "active column stride": lambda: fabric.bits_pack_active(
            wide[:, ::2], ok, ok, TICK),
        "active rows overlap": lambda: fabric.bits_pack_active(
            torch.zeros(40, dtype=b).as_strided((2, 16), (8, 1)), ok, ok,
            TICK),
        "active next_send shape": lambda: fabric.bits_pack_active(
            ok_inf, ok, ok[:, :8], TICK),
        "unpack ragged": lambda: fabric.bits_unpack(wire, 12),
        "unpack_add int64": lambda: fabric.bits_unpack_add(
            wire, 16, ok.long(), True),
        "unpack_add shape": lambda: fabric.bits_unpack_add(
            wire, 16, torch.zeros((2, 24), dtype=i32), True),
        "unpack_add wire dtype": lambda: fabric.bits_unpack_add(
            wire.to(i32), 16, ok, True),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_refuse_bad_arguments(case):
    before = _launches()
    with pytest.raises(ValueError):
        _bad_calls()[case]()
    assert _launches() == before


def test_cuda_without_a_card_raises():
    """The host layout on the card without one raises, and so does
    loading the kernels where no ``nvcc`` builds them: nothing falls
    back to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the calls would run")
    cfg = tc.HeadlineExactConfig(n_nodes=256, fanout=4, ring0_size=64,
                                 max_transmissions=8, loss=0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_exact_headline(cfg, n_seeds=2, kernel="sparse",
                              host_sharded=True,
                              mesh=Mesh("hosts", LocalFabric(2, "cuda")))
    if kernels.library_path("fabric").exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.function("fabric", "bits_pack_above_launch",
                         fabric._ABOVE_ARGTYPES)


# -- the host layout's exchange -----------------------------------------


def test_host_exchange_packs_from_the_sources(monkeypatch):
    """A host-sparse run on 2 hosts: every exchange's wire comes from
    ``bits_pack_active`` or ``bits_pack_above``, never from a bool mask
    through ``bits_pack``; each round unpacks into ``accepted`` (the
    first writing it whole); the fabric carries the reference's bytes,
    one bit a row a host and exchange."""
    calls = {"active": 0, "above": [], "add": []}
    real = (fabric.bits_pack_active, fabric.bits_pack_above,
            fabric.bits_unpack_add)

    def active(*a):
        calls["active"] += 1
        return real[0](*a)

    def above(x, t):
        calls["above"].append(t)
        return real[1](x, t)

    def add(wire, m, accepted, first):
        calls["add"].append(first)
        return real[2](wire, m, accepted, first)

    def no_bool_pack(mask):
        raise AssertionError("the host layout packed a bool mask")

    from corrosion_tpu_torch.models import sharded as ts

    monkeypatch.setattr(ts, "bits_pack_active", active)
    monkeypatch.setattr(fabric, "bits_pack_above", above)
    monkeypatch.setattr(fabric, "bits_unpack_add", add)
    monkeypatch.setattr(fabric, "bits_pack", no_bool_pack)
    cfg = tc.HeadlineExactConfig(n_nodes=512, fanout=4, ring0_size=64,
                                 max_transmissions=8, loss=0.05)
    mesh = Mesh("hosts", LocalFabric(SHARDS, "cpu"))
    res = tc.run_exact_headline(cfg, n_seeds=2, kernel="sparse",
                                host_sharded=True, mesh=mesh, device="cpu")
    assert res["converged_frac"] == 1.0
    assert calls["active"] > 0 and calls["above"]
    assert calls["add"] == [t == 1 for t in calls["above"]]
    exchanges = (calls["active"] + len(calls["above"])) // SHARDS
    row = 2 * cfg.n_nodes // 8 * (SHARDS - 1)
    assert mesh.fabric.bytes["delta"] == exchanges * row
