"""``exact_send`` and ``exact_commit``: the exact sampler's broadcast
phase (csrc/exact_send.cu).

Replaces the broadcast phase of corrosion_tpu/sim/calibrate.py
``packed_exact_tick`` (:593-661) and ``frontier_exact_tick``
(:1175-1236): the full-tuple rejection sampler against each sender's
own ``sent_to`` memory, the loss / partition / WAN / latency masks,
the scatter-set infection, the sender's marks, budget and backoff
(``exact_send``), then the learners' fresh budget (``exact_commit``).
The dtype of ``sent`` picks the representation: a ``[S, N, ceil(N/8)]``
uint8 bitmap (the dense kernel) or a ``[S, N, cap]`` int32 target ring
plus the writer's arithmetic ring0 tier (the frontier kernel).

Bound on the H100: bytes — the activity test of every row, and for an
active row its own leaves, K random bitmap sectors (or its ring row)
and K random sectors each for the infection stores and the marks.  The
kernel runs each row's rejection loop and its draws in registers.

Both functions update their state arguments in place (``tx``,
``next_send``, ``msgs``, ``pending``, ``sent``; the commit ``tx`` and
``next_send``): the dense bitmap is 20 GB at the headline's width, so
no copy of it is made.  ``exact_send`` returns ``new_infected``, a
fresh tensor.  The module also holds the per-row pieces of the
reference (``_sent_bit``, ``_ring0_tier_hit``, ``_frontier_invalid``,
``_wan_filter``, ``_latency_split``, ``_backoff_next_send``) that the
plain versions are made of.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.threefry import threefry_bits_plain
from corrosion_tpu_torch.random import fold_in, key_words, randint_span, split

MAX_FANOUT = 8  # the kernel keeps a tuple in registers
MAX_SEEDS = 32  # per-seed keys travel in the launch's argument block
MAX_ROUNDS = 4096  # rejection rounds before a row counts as capped
# the diagnostics vector both versions accumulate (int64 [4])
DIAG = ("active_rows", "rounds", "max_rounds", "capped_rows")


def raise_on_capped(diag) -> None:
    """Raise if a row found no valid tuple within ``MAX_ROUNDS`` (the
    kernel's row then sent nothing); ``diag`` is the host copy of the
    accumulator."""
    if diag[3]:
        raise RuntimeError(f"exact_send: {int(diag[3])} rows found no valid "
                           f"tuple in {MAX_ROUNDS} rejection rounds")


class SendParams(NamedTuple):
    """What the broadcast phase reads of a ``HeadlineExactConfig``
    (``sim/calibrate.py`` builds it); a count of 0 switches a mask
    off."""

    fanout: int
    max_tx: int
    backoff: float = 0.0
    loss: float = 0.0  # 0: no loss draw
    part_blocks: int = 0  # 0: no partition
    heal_tick: int = 0  # the partition holds while tick < heal_tick
    wan_blocks: int = 0  # 0: no extra cross-region drop
    wan_loss: float = 0.0
    lat_blocks: int = 0  # 0: no WAN latency queue
    lat_ticks: int = 0
    ring0_block: int = 0  # ring only: the writer's arithmetic tier
    writer: int = 0


class _Args(ctypes.Structure):
    """``ExactArgs`` of csrc/exact_send.cu, field for field."""

    _fields_ = [
        *((f, ctypes.c_void_p) for f in (
            "infected", "new_infected", "tx", "next_send", "msgs",
            "pending", "sent", "ring", "tier", "diag")),
        ("nb", ctypes.c_longlong),
        *((f, ctypes.c_int) for f in ("cap", "s", "n", "k", "tick",
                                      "max_tx")),
        ("backoff", ctypes.c_float),
        ("use_loss", ctypes.c_int),
        ("loss", ctypes.c_float),
        ("part_blocks", ctypes.c_int),
        ("part_active", ctypes.c_int),
        ("wan_blocks", ctypes.c_int),
        ("wan_loss", ctypes.c_float),
        *((f, ctypes.c_int) for f in ("lat_blocks", "lat_ticks",
                                      "ring0_block", "writer")),
        ("span", ctypes.c_uint),
        ("mult", ctypes.c_uint),
        ("keys", ctypes.c_uint * (MAX_SEEDS * 6)),
    ]


_COMMIT_ARGTYPES = (
    (ctypes.c_void_p,) * 5
    + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p)
)


def block_of(idx: torch.Tensor, blocks: int, n: int) -> torch.Tensor:
    """Block id ``idx * blocks // n`` (partition, WAN region)."""
    return idx * blocks // n


def _f32(x: float) -> torch.Tensor:
    # comparisons against a float32 draw in float32, as JAX's weak type
    return torch.tensor(x, dtype=torch.float32)


def _sent_bit(sent: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[S, N, K] bool: is ``cand``'s bit set in each row's own packed
    ``sent_to`` row (``sent`` [S, N, nb] uint8)?"""
    byte = sent.gather(2, (cand >> 3).to(torch.int64)).to(torch.int32)
    return ((byte >> (cand & 7)) & 1).bool()


def _ring0_tier_hit(p: SendParams, idx: torch.Tensor,
                    cand: torch.Tensor) -> torch.Tensor:
    """Arithmetic replacement for the writer's seeded tier bits: the
    ``cand`` targets that the dense init marks in the writer's row."""
    if not p.ring0_block:
        return torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
    b = p.ring0_block
    in_tier = (cand // b == p.writer // b) & (cand != p.writer)
    return (idx == p.writer)[:, None] & in_tier


def _frontier_invalid(p: SendParams, ring: torch.Tensor, idx: torch.Tensor,
                      cand: torch.Tensor) -> torch.Tensor:
    """[S, N] bool: rows whose tuple has a self, sent or duplicate hit,
    the sent test a compare across the row's own ring slots plus the
    ring0 tier (for a [S, N, nb] uint8 ``ring``, the bitmap's bit)."""
    if ring.dtype == torch.uint8:
        hit = _sent_bit(ring, cand)
    else:
        hit = (ring[:, :, None, :] == cand[..., None]).any(-1)
        hit |= _ring0_tier_hit(p, idx, cand)
    bad = (hit | (cand == idx[:, None])).any(-1)
    k = cand.shape[-1]
    for a in range(k):
        for b in range(a + 1, k):
            bad |= cand[..., a] == cand[..., b]
    return bad


def _wan_filter(delivered, cand, wan_u, p: SendParams):
    """The extra cross-region drop: ``wan_u`` [S, N, K] float32 draws of
    ``uniform(fold_in(k_loss, 1), (n, K))``."""
    n = cand.shape[1]
    region = block_of(torch.arange(n, dtype=torch.int32,
                                   device=cand.device), p.wan_blocks, n)
    cross = region[:, None] != region[cand.to(torch.int64)]
    return delivered & ~(cross & (wan_u < _f32(p.wan_loss)))


def _latency_split(delivered, cand, pending, tick: int, p: SendParams):
    """Split the delivered mask into immediate commits and cross-region
    arrivals, scatter-minning ``tick + lat_ticks`` into the targets'
    ``pending`` slots (in place); returns the immediate mask."""
    s, n, _ = cand.shape
    region = block_of(torch.arange(n, dtype=torch.int32,
                                   device=cand.device), p.lat_blocks, n)
    delayed = delivered & (region[:, None] != region[cand.to(torch.int64)])
    flat = _flat_targets(cand)[delayed]
    pending.view(-1).scatter_reduce_(
        0, flat, torch.full(flat.shape, tick + p.lat_ticks,
                            dtype=torch.int32, device=cand.device), "amin")
    return delivered & ~delayed


def _backoff_next_send(active, tx, next_send, tick: int, p: SendParams,
                       tier: Optional[torch.Tensor]):
    """A sender's next send (``tx`` after the decrement): the nth
    retransmission waits ``max(1, round(backoff * n))`` ticks, times the
    node's RTT tier on the tiered topologies."""
    sent = (p.max_tx - tx).to(torch.float32)
    gap = torch.clamp_min(torch.round(sent * _f32(p.backoff))
                          .to(torch.int32), 1)
    if tier is not None:
        gap = gap * tier
    return torch.where(active, tick + gap, next_send)


def _flat_targets(cand: torch.Tensor) -> torch.Tensor:
    """[S, N, K] int64 flat index ``s * N + cand`` into [S, N] leaves."""
    s, n, _ = cand.shape
    seed0 = torch.arange(s, dtype=torch.int64, device=cand.device) * n
    return seed0[:, None, None] + cand.to(torch.int64)


def _randint_plain(key, shape, span: int, mult: int, device):
    hi, lo = split(key)
    out = torch.empty(shape, dtype=torch.int32, device=device)
    return threefry_bits_plain(out, key_words(hi), key_words(lo), span=span,
                               mult=mult, minval=0)


def _uniform_plain(key, shape, device):
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return threefry_bits_plain(out, key_words(key))


def exact_send_plain(infected, tx, next_send, msgs, pending, sent, keys,
                     tick: int, p: SendParams, tier, diag):
    """Plain PyTorch version of the kernel (same arguments and results
    as :func:`exact_send`): the reference's vectorised rejection loop,
    redrawing every seed's [N, K] tuple array while a row is bad."""
    s, n = infected.shape
    k = p.fanout
    dev = infected.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    span, mult = randint_span(0, n)
    active = infected & (tx > 0) & (next_send <= tick)

    def draw(r: int) -> torch.Tensor:
        return torch.stack([_randint_plain(fold_in(kd, r), (n, k), span,
                                           mult, dev) for kd, _, _ in keys])

    cand = draw(0)
    bad = _frontier_invalid(p, sent, idx, cand) & active
    rounds = active.to(torch.int64)
    r = 1
    while bool(bad.any()):
        if r == MAX_ROUNDS:
            raise RuntimeError(f"exact_send: a row found no valid tuple in "
                               f"{MAX_ROUNDS} rejection rounds")
        cand = torch.where(bad[..., None], draw(r), cand)
        rounds += bad.to(torch.int64)
        bad = _frontier_invalid(p, sent, idx, cand) & bad
        r += 1

    delivered = active[..., None].expand(s, n, k)
    if p.loss > 0.0:
        loss_u = torch.stack([_uniform_plain(kl, (n, k), dev)
                              for _, kl, _ in keys])
        delivered = delivered & (loss_u >= _f32(p.loss))
    if p.part_blocks and tick < p.heal_tick:
        part = block_of(idx, p.part_blocks, n)
        delivered = delivered & (part[:, None] == part[cand.to(torch.int64)])
    if p.wan_blocks:
        wan_u = torch.stack([_uniform_plain(kw, (n, k), dev)
                             for _, _, kw in keys])
        delivered = _wan_filter(delivered, cand, wan_u, p)
    if p.lat_blocks:
        delivered = _latency_split(delivered, cand, pending, tick, p)
    new_infected = infected.clone()
    new_infected.view(-1)[_flat_targets(cand)[delivered]] = True

    # marks on the sender's own row: ring slot (max_tx - tx) * K + j, or
    # the bit, one column at a time (two targets may share a byte)
    rows = torch.arange(s * n, dtype=torch.int64, device=dev).reshape(s, n)
    if sent.dtype == torch.int32:
        cap = sent.shape[2]
        slot = ((p.max_tx - tx).to(torch.int64)[..., None] * k
                + torch.arange(k, device=dev))
        flat = rows[..., None] * cap + slot
        sent.view(-1)[flat[active]] = cand[active]
    else:
        nb = sent.shape[2]
        flat = rows[..., None] * nb + (cand >> 3).to(torch.int64)
        bits = (1 << (cand & 7)).to(torch.uint8)
        sv = sent.view(-1)
        for j in range(k):
            ix = flat[..., j][active]
            sv[ix] = sv[ix] | bits[..., j][active]

    msgs.add_(active.to(torch.int32) * k)
    tx.sub_(active.to(torch.int32))
    next_send.copy_(_backoff_next_send(active, tx, next_send, tick, p, tier))
    diag[0] += active.sum()
    diag[1] += rounds.sum()
    diag[2] = torch.maximum(diag[2], rounds.max())
    return new_infected


def _check_send(infected, tx, next_send, msgs, pending, sent, keys,
                p: SendParams, tier, diag):
    s, n = infected.shape
    if not 1 <= p.fanout <= MAX_FANOUT:
        raise ValueError(f"exact_send: fanout must be 1..{MAX_FANOUT}, "
                         f"got {p.fanout}")
    if len(keys) != s:
        raise ValueError(f"exact_send: {len(keys)} key triples for {s} "
                         "seeds")
    if infected.dtype != torch.bool:
        raise ValueError("exact_send: infected must be bool")
    for name, t in (("tx", tx), ("next_send", next_send), ("msgs", msgs),
                    ("pending", pending)):
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != (s, n)):
            raise ValueError(f"exact_send: {name} must be int32 [{s}, {n}]")
    if sent.dtype == torch.uint8:
        want = (s, n, -(-n // 8))
    elif sent.dtype == torch.int32:
        want = (s, n, p.max_tx * p.fanout)
    else:
        raise ValueError(f"exact_send: no representation for {sent.dtype}")
    if tuple(sent.shape) != want:
        raise ValueError(f"exact_send: sent must be {want}, got "
                         f"{tuple(sent.shape)}")
    if p.lat_blocks and pending is None:
        raise ValueError("exact_send: the latency queue needs pending")
    if tier is not None and tuple(tier.shape) != (n,):
        raise ValueError(f"exact_send: tier must be [{n}]")
    if diag.dtype != torch.int64 or tuple(diag.shape) != (len(DIAG),):
        raise ValueError(f"exact_send: diag must be int64 [{len(DIAG)}]")


def exact_send(infected, tx, next_send, msgs, pending, sent, keys,
               tick: int, p: SendParams, tier, diag):
    """One tick's broadcast phase for every (seed, node).

    infected [S, N] bool; tx, next_send, msgs, pending [S, N] int32
    (``pending`` may be None without the latency queue); sent the
    [S, N, ceil(N/8)] uint8 bitmap or the [S, N, max_tx * fanout] int32
    ring; keys S triples ``(k_draw, k_loss, k_wan)`` of host keys (the
    tick key's ``split(.., 3)`` and ``fold_in(k_loss, 1)``); tier [N]
    int32 or None; diag the int64 [4] accumulator (``DIAG``) whose
    capped rows the caller must check (``raise_on_capped``): the kernel
    cannot raise, and a capped row sends nothing.  Updates tx,
    next_send, msgs, pending and sent in place; returns
    new_infected."""
    _check_send(infected, tx, next_send, msgs, pending, sent, keys, p, tier,
                diag)
    if kernels.on_cpu(infected, tx, next_send, msgs, pending, sent, tier,
                      diag):
        return exact_send_plain(infected, tx, next_send, msgs, pending,
                                sent, keys, tick, p, tier, diag)
    s, n = infected.shape
    if s > MAX_SEEDS:
        raise ValueError(f"exact_send: the kernel takes at most {MAX_SEEDS} "
                         f"seeds a launch, got {s}")
    for name, t in (("infected", infected), ("tx", tx),
                    ("next_send", next_send), ("msgs", msgs),
                    ("pending", pending), ("sent", sent), ("tier", tier),
                    ("diag", diag)):
        if t is not None:
            kernels.check(f"exact_send {name}", t, t.dtype, align=1)
    ring = sent.dtype == torch.int32
    new_infected = infected.clone()
    span, mult = randint_span(0, n)
    words = [w for triple in keys for key in triple for w in key_words(key)]
    a = _Args(
        infected=infected.data_ptr(), new_infected=new_infected.data_ptr(),
        tx=tx.data_ptr(), next_send=next_send.data_ptr(),
        msgs=msgs.data_ptr(),
        pending=None if pending is None else pending.data_ptr(),
        sent=None if ring else sent.data_ptr(),
        ring=sent.data_ptr() if ring else None,
        tier=None if tier is None else tier.data_ptr(),
        diag=diag.data_ptr(),
        nb=0 if ring else sent.shape[2], cap=sent.shape[2] if ring else 0,
        s=s, n=n, k=p.fanout, tick=tick, max_tx=p.max_tx,
        backoff=p.backoff, use_loss=int(p.loss > 0.0), loss=p.loss,
        part_blocks=p.part_blocks, part_active=int(tick < p.heal_tick),
        wan_blocks=p.wan_blocks, wan_loss=p.wan_loss,
        lat_blocks=p.lat_blocks, lat_ticks=p.lat_ticks,
        ring0_block=p.ring0_block, writer=p.writer, span=span, mult=mult,
    )
    a.keys[:len(words)] = words
    _check_layout()
    fn = kernels.function("exact_send", "exact_send_launch",
                          (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
    code = fn(ctypes.addressof(a), int(ring), kernels.stream(infected))
    exact_send.launches += 1
    kernels.raise_on_error("exact_send", code)
    return new_infected


def _check_layout() -> None:
    size = kernels.function("exact_send", "exact_args_size", ())()
    if size != ctypes.sizeof(_Args):
        raise RuntimeError(f"exact_send: the argument block is {size} bytes "
                           f"in the kernel, {ctypes.sizeof(_Args)} here")


def exact_commit_plain(infected, new_infected, tx, next_send, tick: int,
                       max_tx: int, tier=None):
    """Plain PyTorch version of :func:`exact_commit`."""
    learned = new_infected & ~infected
    tx.masked_fill_(learned, max_tx)
    first = torch.ones_like(next_send) if tier is None else tier
    next_send.copy_(torch.where(learned, tick + first, next_send))


def exact_commit(infected, new_infected, tx, next_send, tick: int,
                 max_tx: int, tier=None):
    """The learners of a tick (``new_infected & ~infected``, [S, N]
    bool) get ``max_tx`` transmissions and forward at ``tick + 1`` (its
    RTT tier's worth with ``tier`` [N] int32); tx and next_send [S, N]
    int32 are updated in place."""
    s, n = infected.shape
    for name, t, dtype in (("new_infected", new_infected, torch.bool),
                           ("tx", tx, torch.int32),
                           ("next_send", next_send, torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (s, n):
            raise ValueError(f"exact_commit: {name} must be {dtype} "
                             f"[{s}, {n}]")
    if kernels.on_cpu(infected, new_infected, tx, next_send, tier):
        return exact_commit_plain(infected, new_infected, tx, next_send,
                                  tick, max_tx, tier)
    for name, t in (("infected", infected), ("new_infected", new_infected),
                    ("tx", tx), ("next_send", next_send), ("tier", tier)):
        if t is not None:
            kernels.check(f"exact_commit {name}", t, t.dtype, align=1)
    if tier is not None and tuple(tier.shape) != (n,):
        raise ValueError(f"exact_commit: tier must be [{n}]")
    pt = kernels.ptr
    fn = kernels.function("exact_send", "exact_commit_launch",
                          _COMMIT_ARGTYPES)
    code = fn(pt(infected), pt(new_infected), pt(tx), pt(next_send),
              pt(tier), s * n, n, tick, max_tx, kernels.stream(infected))
    exact_commit.launches += 1
    kernels.raise_on_error("exact_commit", code)


exact_send.launches = 0
exact_commit.launches = 0
