"""``shard_round`` and ``shard_commit``: one shard's rejection loop and
its delivery and commit in the exact sampler's multi-device layouts
(entry points of csrc/exact_send.cu, which they share with
``exact_send``: the in-thread draw, the sent test, the masks, the
marks and the budget).

``shard_round`` replaces the rejection round of
corrosion_tpu/sim/calibrate.py ``_sharded_tick_local`` (:817-846),
models/sharded.py ``_sharded_frontier_tick_local`` (:403-426) and
``_sharded_frontier_host_tick_local`` (:659-683); ``shard_commit``
their delivery and commit (:848-892; :428-470; :685-728).

The reference's shards redraw the replicated [S, N, K] tuples each
round and exchange a still-bad mask until none is bad.  Here a shard
runs each of its active rows' whole loop in registers (``shard_round``)
and returns how many rounds each drew; the mask after round r is then
``rounds > r + 1``, which the layouts exchange round by round exactly
as the reference does.  Every shard counts, per row, the exchanged
masks that held it: that is the row's accepted round, and
``shard_commit`` redraws every active row's tuple at it — no tuple
crosses the fabric and none is stored.  Bound on the H100: bytes, as
``exact_send`` (module docstring there).  Few rows are active in a
tick, so both kernels deal the active rows to a warp's lanes in a
persistent grid; the bitmap's commit, whose dense layout has few rows,
runs a thread a row (csrc/exact_send.cu says why).
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.exact_send import (
    DIAG,
    MAX_FANOUT,
    MAX_ROUNDS,
    MAX_SEEDS,
    SendParams,
    _add_diag,
    _Args,
    _commit_targets_plain,
    _deliver_plain,
    _draw_plain,
    _frontier_invalid,
    _mark_plain,
    _spend_plain,
)
from corrosion_tpu_torch.random import key_words, randint_span


class _ShardArgs(ctypes.Structure):
    """``ShardArgs`` of csrc/exact_send.cu, field for field."""

    _fields_ = [
        ("e", _Args),
        ("active", ctypes.c_void_p),
        ("rounds", ctypes.c_void_p),
        *((f, ctypes.c_int) for f in ("lo", "n_local", "t_lo", "t_n",
                                      "b_lo", "b_n")),
    ]


def _window(width: int, n: int, lo: int, n_local: int, name: str) -> int:
    """First row a [S, width] leaf holds: all N rows, or my n_local."""
    if width == n:
        return 0
    if width == n_local:
        return lo
    raise ValueError(f"shard_commit: {name} must hold {n} or {n_local} "
                     f"rows, got {width}")


def shard_round_plain(active_l, sent_l, keys, lo: int, n: int,
                      p: SendParams, diag):
    """Plain PyTorch version of :func:`shard_round`: the reference's
    loop over my rows' slices of the replicated draws."""
    s, n_local = active_l.shape
    k = p.fanout
    dev = active_l.device
    idx = torch.arange(lo, lo + n_local, dtype=torch.int32, device=dev)
    window = slice(lo, lo + n_local)
    cand = _draw_plain(keys, 0, n, k, dev)[:, window]
    bad = _frontier_invalid(p, sent_l, idx, cand) & active_l
    rounds = active_l.to(torch.int64)
    r = 1
    while bool(bad.any()) and r < MAX_ROUNDS:
        cand = torch.where(bad[..., None],
                           _draw_plain(keys, r, n, k, dev)[:, window], cand)
        rounds += bad.to(torch.int64)
        bad = _frontier_invalid(p, sent_l, idx, cand) & bad
        r += 1
    _add_diag(diag, active_l, rounds)
    diag[3] += bad.sum()
    out = torch.where(bad, MAX_ROUNDS + 1, rounds)
    return out.to(torch.int32)


def _check_common(keys, sent_l, s: int, n_local: int, p: SendParams):
    if not 1 <= p.fanout <= MAX_FANOUT:
        raise ValueError(f"shard kernels: fanout must be 1..{MAX_FANOUT}, "
                         f"got {p.fanout}")
    if len(keys) != s:
        raise ValueError(f"shard kernels: {len(keys)} key triples for {s} "
                         "seeds")
    if sent_l.dim() != 3 or tuple(sent_l.shape[:2]) != (s, n_local):
        raise ValueError(f"shard kernels: sent_l must be [{s}, {n_local}, "
                         f"...], got {tuple(sent_l.shape)}")
    if sent_l.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"shard kernels: no representation for "
                         f"{sent_l.dtype}")


def _args(sent_l, keys, n: int, tick: int, p: SendParams, **ptrs):
    """The argument block (every pointer not given is null)."""
    ring = sent_l.dtype == torch.int32
    s = sent_l.shape[0]
    span, mult = randint_span(0, n)
    words = [w for triple in keys for key in triple for w in key_words(key)]
    e = _Args(
        sent=None if ring else sent_l.data_ptr(),
        ring=sent_l.data_ptr() if ring else None,
        nb=0 if ring else sent_l.shape[2], cap=sent_l.shape[2] if ring else 0,
        s=s, n=n, k=p.fanout, tick=tick, max_tx=p.max_tx,
        backoff=p.backoff, use_loss=int(p.loss > 0.0), loss=p.loss,
        part_blocks=p.part_blocks, part_active=int(tick < p.heal_tick),
        wan_blocks=p.wan_blocks, wan_loss=p.wan_loss,
        lat_blocks=p.lat_blocks, lat_ticks=p.lat_ticks,
        ring0_block=p.ring0_block, writer=p.writer, span=span, mult=mult,
        **{f: (None if t is None else t.data_ptr()) for f, t in ptrs.items()},
    )
    e.keys[:len(words)] = words
    return e


def _launch(name: str, sa: _ShardArgs, ring: bool, commit: bool, t) -> None:
    size = kernels.function("exact_send", "shard_args_size", ())()
    if size != ctypes.sizeof(_ShardArgs):
        raise RuntimeError(f"{name}: the argument block is {size} bytes in "
                           f"the kernel, {ctypes.sizeof(_ShardArgs)} here")
    fn = kernels.function("exact_send", "shard_launch",
                          (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p))
    code = fn(ctypes.addressof(sa), int(ring), int(commit),
              kernels.stream(t))
    kernels.raise_on_error(name, code)


def shard_round(active_l, sent_l, keys, lo: int, n: int, p: SendParams,
                diag, tick: int = 0):
    """My rows' rejection loops.

    active_l [S, n_local] bool, my rows' activity (global ids lo ..
    lo + n_local - 1); sent_l my rows' [S, n_local, ceil(N/8)] uint8
    bitmap or [S, n_local, max_tx * fanout] int32 ring; keys S triples
    ``(k_draw, k_loss, k_wan)`` (only k_draw is drawn from); diag the
    int64 [4] accumulator (``kernels.exact_send.DIAG``).  Returns
    rounds [S, n_local] int32: 0 for an inactive row, else the rounds
    it drew (its accepted round + 1), ``MAX_ROUNDS + 1`` where none was
    accepted within ``MAX_ROUNDS`` (counted in diag[3])."""
    s, n_local = active_l.shape
    if active_l.dtype != torch.bool:
        raise ValueError("shard_round: active_l must be bool")
    if not 0 <= lo <= n - n_local:
        raise ValueError(f"shard_round: rows {lo}..{lo + n_local} outside "
                         f"{n}")
    _check_common(keys, sent_l, s, n_local, p)
    if diag.dtype != torch.int64 or tuple(diag.shape) != (len(DIAG),):
        raise ValueError(f"shard_round: diag must be int64 [{len(DIAG)}]")
    if kernels.on_cpu(active_l, sent_l, diag):
        return shard_round_plain(active_l, sent_l, keys, lo, n, p, diag)
    sa, rounds = round_args(active_l, sent_l, keys, lo, n, p, diag, tick)
    _launch("shard_round", sa, sent_l.dtype == torch.int32, False, active_l)
    shard_round.launches += 1
    return rounds


def round_args(active_l, sent_l, keys, lo: int, n: int, p: SendParams,
               diag, tick: int):
    """:func:`shard_round`'s argument block on CUDA tensors that passed
    its checks, and the rounds tensor the kernel writes."""
    s, n_local = active_l.shape
    if s > MAX_SEEDS:
        raise ValueError(f"shard_round: the kernel takes at most "
                         f"{MAX_SEEDS} seeds a launch, got {s}")
    for name, t in (("active_l", active_l), ("sent_l", sent_l),
                    ("diag", diag)):
        kernels.check(f"shard_round {name}", t, t.dtype, align=1)
    rounds = torch.empty((s, n_local), dtype=torch.int32,
                         device=active_l.device)
    sa = _ShardArgs(e=_args(sent_l, keys, n, tick, p, diag=diag),
                    active=active_l.data_ptr(), rounds=rounds.data_ptr(),
                    lo=lo, n_local=n_local, t_lo=0, t_n=0, b_lo=0, b_n=0)
    return sa, rounds


def shard_commit_plain(active, rounds, infected_t, pending_t, tx_b,
                       next_send_b, msgs_b, sent_l, keys, lo: int,
                       tick: int, p: SendParams, tier):
    """Plain PyTorch version of :func:`shard_commit`."""
    s, n = active.shape
    n_local = sent_l.shape[1]
    k = p.fanout
    dev = active.device
    cand = torch.zeros((s, n, k), dtype=torch.int32, device=dev)
    for r in sorted(set(rounds[active].tolist())):
        sel = active & (rounds == r)
        cand = torch.where(sel[..., None], _draw_plain(keys, r, n, k, dev),
                           cand)
    now, delayed = _deliver_plain(active, cand, keys, tick, p)
    new_infected = infected_t.clone()
    t_lo = _window(infected_t.shape[1], n, lo, n_local, "infected")
    _commit_targets_plain(new_infected, pending_t, now, delayed, cand, tick,
                          p, t_lo)
    b_lo = _window(tx_b.shape[1], n, lo, n_local, "tx")
    b_n = tx_b.shape[1]
    mine = slice(lo - b_lo, lo - b_lo + n_local)
    _mark_plain(sent_l, active[:, lo:lo + n_local],
                cand[:, lo:lo + n_local].contiguous(), tx_b[:, mine], p)
    _spend_plain(active[:, b_lo:b_lo + b_n], tx_b, next_send_b, msgs_b, tick,
                 p, None if tier is None else tier[b_lo:b_lo + b_n])
    return new_infected


def shard_commit(active, rounds, infected_t, pending_t, tx_b, next_send_b,
                 msgs_b, sent_l, keys, lo: int, tick: int, p: SendParams,
                 tier):
    """Every active row's delivery at its accepted round, my rows'
    marks, and the budget of the rows this layout owns.

    active [S, N] bool and rounds [S, N] int32 (every row's accepted
    round: the count of exchanged still-bad masks that held it);
    infected_t [S, W] bool and pending_t [S, W] int32 (or None without
    the latency queue) the target window, W = N (replicated) or my
    n_local rows; tx_b, next_send_b, msgs_b [S, B] int32 the budget
    window, B = N or n_local; sent_l my rows' bitmap or ring; tier [N]
    int32 or None.  Updates pending_t, tx_b, next_send_b, msgs_b and
    sent_l in place; returns the new infected window (a fresh tensor)."""
    s, n = active.shape
    n_local = sent_l.shape[1]
    if active.dtype != torch.bool or rounds.dtype != torch.int32 or tuple(
            rounds.shape) != (s, n):
        raise ValueError(f"shard_commit: active bool and rounds int32, both "
                         f"[{s}, {n}]")
    _check_common(keys, sent_l, s, n_local, p)
    _window(infected_t.shape[1], n, lo, n_local, "infected")
    _window(tx_b.shape[1], n, lo, n_local, "tx")
    t_n, b_n = infected_t.shape[1], tx_b.shape[1]
    for name, t, width in (("next_send", next_send_b, b_n),
                           ("msgs", msgs_b, b_n), ("pending", pending_t, t_n)):
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != (s, width)):
            raise ValueError(f"shard_commit: {name} must be int32 "
                             f"[{s}, {width}]")
    if p.lat_blocks and pending_t is None:
        raise ValueError("shard_commit: the latency queue needs pending")
    if tier is not None and tuple(tier.shape) != (n,):
        raise ValueError(f"shard_commit: tier must be [{n}]")
    if kernels.on_cpu(active, rounds, infected_t, pending_t, tx_b,
                      next_send_b, msgs_b, sent_l, tier):
        return shard_commit_plain(active, rounds, infected_t, pending_t,
                                  tx_b, next_send_b, msgs_b, sent_l, keys,
                                  lo, tick, p, tier)
    sa, new_infected = commit_args(active, rounds, infected_t, pending_t,
                                   tx_b, next_send_b, msgs_b, sent_l, keys,
                                   lo, tick, p, tier)
    _launch("shard_commit", sa, sent_l.dtype == torch.int32, True, active)
    shard_commit.launches += 1
    return new_infected


def commit_args(active, rounds, infected_t, pending_t, tx_b, next_send_b,
                msgs_b, sent_l, keys, lo: int, tick: int, p: SendParams,
                tier):
    """:func:`shard_commit`'s argument block on CUDA tensors that passed
    its checks, and the new infected window the kernel writes."""
    s, n = active.shape
    n_local = sent_l.shape[1]
    t_lo = _window(infected_t.shape[1], n, lo, n_local, "infected")
    b_lo = _window(tx_b.shape[1], n, lo, n_local, "tx")
    t_n, b_n = infected_t.shape[1], tx_b.shape[1]
    if s > MAX_SEEDS:
        raise ValueError(f"shard_commit: the kernel takes at most "
                         f"{MAX_SEEDS} seeds a launch, got {s}")
    for name, t in (("active", active), ("rounds", rounds),
                    ("infected", infected_t), ("pending", pending_t),
                    ("tx", tx_b), ("next_send", next_send_b),
                    ("msgs", msgs_b), ("sent_l", sent_l), ("tier", tier)):
        if t is not None:
            kernels.check(f"shard_commit {name}", t, t.dtype, align=1)
    new_infected = infected_t.clone()
    sa = _ShardArgs(
        e=_args(sent_l, keys, n, tick, p, new_infected=new_infected,
                tx=tx_b, next_send=next_send_b, msgs=msgs_b,
                pending=pending_t, tier=tier),
        active=active.data_ptr(), rounds=rounds.data_ptr(), lo=lo,
        n_local=n_local, t_lo=t_lo, t_n=t_n, b_lo=b_lo, b_n=b_n)
    return sa, new_infected


shard_round.launches = 0
shard_commit.launches = 0
