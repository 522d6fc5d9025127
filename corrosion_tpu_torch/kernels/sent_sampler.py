"""``sent_select`` / ``sent_commit``, and ``sent_tick``, both from one
host call: the exact ``sent_to``-excluding sampler
(csrc/sent_sampler.cu).

Replaces corrosion_tpu/sim/calibrate.py ``exact_tick`` (:71-121) and
the ``sent`` branch of corrosion_tpu/models/broadcast.py
``broadcast_step`` (:188-258, with the ``scatter_merge`` columns of
ops/merge.py:60).  Each active sender draws a uniform score per peer,
drops the peers it has already sent the payload to and itself, and
sends to the k lowest scores, ties to the lower index; the k slots are
then delivered, marked in ``sent`` and charged.  Two modes share the
selection:

* calibration (``infected`` given, ``exact_tick``): the scores of row r
  come from the key of its sender chunk, ``fold_in(key_t, start)``, at
  counter ``(r - start) * n + col``; a send sets the target's infection;
* broadcast (``rows`` given, ``track_sent``): one chunk of n rows under
  ``key_t``; loss, partition and WAN masks; a send max-merges the
  sender's packed keys (int32, or int64 for ``WIDE_CODEC``) into the
  target's row and min-merges its hop depth.

Every leaf carries a leading seed axis ``[S, ...]`` (one universe of N
nodes a seed), and ``keys`` is an ``[S, nchunks, 2]`` uint32 tensor on
the leaves' device.  ``sent`` ([S, N, N] bool) is marked in place; every
other output is a fresh tensor.  Bound on the H100: threefry operations
(68 integer operations a score over the two integer pipes), then the
sent rows' bytes.  The kernel hashes every column of an active row,
keeps the few under a mantissa bound (:func:`hit_bits`) and selects
among those, with an exact fallback when fewer than k remain; see the
source for the design.  The ticks (``exact_tick``, ``deliver_sent``)
call :func:`sent_tick`, which enqueues both kernels from one argument
block, the commit under programmatic dependent launch; the two
wrappers stay for their own callers.
"""

from __future__ import annotations

import ctypes
import math

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.deliver import HOP_UNSET
from corrosion_tpu_torch.kernels.threefry import threefry_bits_plain
from corrosion_tpu_torch.models.common import blocks_cross
from corrosion_tpu_torch.ops.merge import scatter_merge
from corrosion_tpu_torch.random import key_words

MAX_FANOUT = 8  # the kernel is built for k = 1 .. 8


class _Args(ctypes.Structure):
    """``SentArgs`` of csrc/sent_sampler.cu, field for field."""

    _fields_ = [
        *((f, ctypes.c_void_p) for f in (
            "sent", "keys", "loss_keys", "infected", "tx", "next_send",
            "msgs", "rows", "hops", "part", "sev", "region", "tier",
            "new_infected", "new_rows", "cand", "counts", "tx_out",
            "next_out", "msgs_out", "hops_out")),
        *((f, ctypes.c_int) for f in (
            "s", "n", "k", "chunk", "nchunks", "r", "wide", "sev_b", "tick",
            "part_active", "use_loss", "max_tx")),
        *((f, ctypes.c_float) for f in ("loss", "wan_loss", "backoff")),
        ("one", ctypes.c_uint32), ("hit_bits", ctypes.c_uint32),
    ]


# the filter lets through about HIT_SLACK + 2k of a row's columns
HIT_SLACK = 16
MANTISSA = 1 << 23  # levels of a uniform: bits >> 9


def hit_bits(n: int, k: int) -> int:
    """The kernel filter's bound on a column's 32-bit word for rows of
    ``n`` columns and fanout ``k``: a word passes when it is at most
    the bound.  It is a mantissa bound, ``m * 512 - 1`` (a word passes
    exactly when its mantissa ``bits >> 9`` is under ``m``), so that a
    tie never straddles it; ``m`` puts ``2k + HIT_SLACK`` of the other
    ``n - 1`` columns under it on average.  ``0xFFFFFFFF`` (every word)
    once that is all of them."""
    m = -(-(2 * k + HIT_SLACK) * MANTISSA // max(n - 1, 1))
    return 0xFFFFFFFF if m >= MANTISSA else m * 512 - 1


def _f32(x: float) -> torch.Tensor:
    # comparisons against a float32 draw in float32, as JAX's weak type
    return torch.tensor(x, dtype=torch.float32)


def active_rows(tx, next_send=None, tick: int = 0, infected=None):
    """[S, N] bool senders of the tick: budget left, schedule due (when
    there is one) and, in calibration mode, infected."""
    active = tx > 0
    if next_send is not None:
        active &= next_send <= tick
    if infected is not None:
        active &= infected
    return active


def chunk_scores(sent_rows, key, start: int) -> torch.Tensor:
    """[C, N] float32 scores of rows ``start .. start + C`` of one seed
    (``sent_rows`` their [C, N] bool sent rows) under ``key``: the
    uniforms of the chunk's [C, N] draw, +inf where a peer was sent to
    or is the row itself."""
    c, n = sent_rows.shape
    u = torch.empty((c, n), dtype=torch.float32, device=sent_rows.device)
    threefry_bits_plain(u, key)
    rows = torch.arange(start, start + c, device=u.device)[:, None]
    self_ = rows == torch.arange(n, device=u.device)[None, :]
    return torch.where(sent_rows | self_, math.inf, u)


def select_k(scores, k: int):
    """(targets [C, k] int64, available [C, k] bool): the k smallest of
    each row in stable order (equal scores lower index first, as
    ``lax.top_k(-scores)`` and the stable ``argsort``); a slot holding
    +inf is not available."""
    vals, order = torch.sort(scores, dim=1, stable=True)
    return order[:, :k], vals[:, :k] < math.inf


def _key_rows(keys) -> list:
    """[S][chunk] (k0, k1) host words of an [S, nchunks, 2] key tensor."""
    return [[tuple(kw) for kw in seed] for seed in keys.cpu().tolist()]


def _deliver_plain(si, targets, marks, rows, hops, new_rows, cand,
                   loss_keys, loss, wan_loss, region, partition_id, sev,
                   partition_active):
    """Broadcast mode's delivery for seed ``si`` (one chunk of N rows):
    the loss, partition and WAN masks on the marked sends, then the K
    scatter-max columns of the packed keys and the hop scatter-min."""
    n, k = targets.shape
    dev = targets.device
    ok = marks.clone()
    if loss > 0.0:
        u = torch.empty((n, k), dtype=torch.float32, device=dev)
        ok &= threefry_bits_plain(u, loss_keys[si][0]) >= _f32(loss)
    if partition_id is not None and partition_active:
        ok &= ~blocks_cross(partition_id[:, None], partition_id[targets],
                            sev)
    if region is not None:
        u = torch.empty((n, k), dtype=torch.float32, device=dev)
        drop = threefry_bits_plain(u, loss_keys[si][1]) < _f32(wan_loss)
        ok &= ~((region[:, None] != region[targets]) & drop)
    masked = torch.where(ok, targets, n)  # dead messages are dropped
    merged = rows[si]
    for j in range(k):
        merged = scatter_merge(merged, masked[:, j], rows[si])
    new_rows[si] = merged
    if hops is not None:
        sender = torch.clamp_max(hops[si], HOP_UNSET) + 1
        c = torch.full((n + 1,), HOP_UNSET, dtype=hops.dtype, device=dev)
        for j in range(k):
            c.scatter_reduce_(0, masked[:, j], sender, "amin")
        cand[si] = c[:n]


def sent_select_plain(sent, keys, fanout: int, chunk: int, *, tx,
                      next_send=None, tick: int = 0, infected=None,
                      rows=None, hops=None, loss_keys=None, loss=0.0,
                      wan_loss=0.0, region=None, partition_id=None, sev=None,
                      partition_active=False):
    """Plain PyTorch version of :func:`sent_select`: the reference's
    steps on whole chunks (``torch.sort(stable=True)``, not
    ``torch.topk``, whose tie order is unspecified)."""
    s, n = tx.shape
    dev = tx.device
    active = active_rows(tx, next_send, tick, infected)
    counts = torch.zeros((s, n), dtype=torch.int32, device=dev)
    key_rows = _key_rows(keys)
    calib = infected is not None
    if calib:
        new_infected = infected.clone()
    else:
        new_rows = torch.empty_like(rows)
        cand = None if hops is None else torch.empty_like(hops)
        deliver = dict(rows=rows, hops=hops, new_rows=new_rows, cand=cand,
                       loss_keys=_key_rows(loss_keys), loss=loss,
                       wan_loss=wan_loss, region=region,
                       partition_id=partition_id, sev=sev,
                       partition_active=partition_active)
    for si in range(s):
        for ck, start in enumerate(range(0, n, chunk)):
            ci = min(chunk, n - start)
            row_sent = sent[si, start:start + ci]
            targets, avail = select_k(
                chunk_scores(row_sent, key_rows[si][ck], start), fanout)
            # marks on send: before loss, the sender cannot know
            marks = avail & active[si, start:start + ci, None]
            if calib:
                new_infected[si, targets[marks]] = True
            else:
                _deliver_plain(si, targets, marks, **deliver)
            senders = torch.arange(ci, device=dev)[:, None].expand(ci,
                                                                   fanout)
            row_sent[senders[marks], targets[marks]] = True
            counts[si, start:start + ci] = marks.sum(dim=1).to(torch.int32)
    if calib:
        return new_infected, counts
    return new_rows, cand, counts


def _backoff_gap(tx, max_tx: int, backoff: float) -> torch.Tensor:
    sent = (max_tx - tx).to(torch.float32)
    return torch.clamp_min(torch.round(sent * _f32(backoff))
                           .to(torch.int32), 1)


def sent_commit_plain(counts, tx, msgs, *, tick: int, max_tx: int,
                      backoff: float = 0.0, next_send=None, infected=None,
                      new_infected=None, rows=None, new_rows=None,
                      hops=None, cand=None, tier=None):
    """Plain PyTorch version of :func:`sent_commit`."""
    active = active_rows(tx, next_send, tick, infected)
    new_msgs = msgs + counts
    if infected is not None:
        sent_now = active & (counts > 0)
        exhausted = active & (counts == 0)
        new_tx = torch.where(sent_now, tx - 1, tx)
        new_tx = torch.where(exhausted, 0, new_tx)
        nxt = torch.where(sent_now, tick + _backoff_gap(new_tx, max_tx,
                                                        backoff), next_send)
        learned = new_infected & ~infected
        new_tx = torch.where(learned, max_tx, new_tx).to(torch.int32)
        nxt = torch.where(learned, tick + 1, nxt).to(torch.int32)
        return new_tx, nxt, new_msgs
    learned = torch.any(new_rows != rows, dim=2)
    new_tx = torch.where(active, tx - 1, tx)
    new_tx = torch.where(learned, max_tx, new_tx).to(torch.int32)
    nxt = None
    if next_send is not None:
        gap = _backoff_gap(new_tx, max_tx, backoff)
        first = 1
        if tier is not None:
            gap = gap * tier
            first = tier
        nxt = torch.where(active, tick + gap, next_send)
        nxt = torch.where(learned, tick + first, nxt).to(torch.int32)
    new_hops = None
    if hops is not None:
        new_hops = torch.where(learned, torch.minimum(hops, cand), hops)
    return new_tx, new_msgs, new_hops, nxt


def key_tensor(rows, device) -> torch.Tensor:
    """[S, len(row), 2] uint32 tensor on ``device`` of S rows of host
    keys: the ``keys`` / ``loss_keys`` argument of :func:`sent_select`."""
    words = [[key_words(k) for k in row] for row in rows]
    return torch.tensor(words, dtype=torch.uint32).to(device)


def sent_tick_plain(sent, keys, fanout: int, chunk: int, *, tx, msgs,
                    tick: int, max_tx: int, backoff: float = 0.0,
                    next_send=None, infected=None, rows=None, hops=None,
                    tier=None, **select):
    """Plain PyTorch version of :func:`sent_tick`:
    :func:`sent_select_plain`, then :func:`sent_commit_plain` on its
    results."""
    out = sent_select_plain(sent, keys, fanout, chunk, tx=tx,
                            next_send=next_send, tick=tick,
                            infected=infected, rows=rows, hops=hops,
                            **select)
    calib = infected is not None
    return (*out, *sent_commit_plain(
        out[-1], tx, msgs, tick=tick, max_tx=max_tx, backoff=backoff,
        next_send=next_send, infected=infected,
        new_infected=out[0] if calib else None, rows=rows,
        new_rows=None if calib else out[0], hops=hops,
        cand=None if calib else out[1], tier=tier))


def _check_shapes(name, tensors) -> None:
    for label, t, shape in tensors:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be {shape}, got "
                             f"{tuple(t.shape)}")


def _args(**fields) -> _Args:
    """The kernel's argument block: tensors by pointer (None = null)."""
    a = _Args()
    for f, v in fields.items():
        if isinstance(v, torch.Tensor):
            v = v.data_ptr()
        setattr(a, f, v)
    return a


_SIZE_CHECKED: dict = {}  # the library whose SentArgs size was checked


def _launch(name: str, symbol: str, a: _Args, t) -> None:
    lib = kernels.load("sent_sampler")
    if _SIZE_CHECKED.get("lib") is not lib:
        size = kernels.function("sent_sampler", "sent_args_size", ())()
        if size != ctypes.sizeof(_Args):
            raise RuntimeError(f"{name}: the argument block is {size} bytes "
                               f"in the kernel, {ctypes.sizeof(_Args)} here")
        _SIZE_CHECKED["lib"] = lib
    fn = kernels.function("sent_sampler", symbol,
                          (ctypes.c_void_p, ctypes.c_void_p))
    code = fn(ctypes.addressof(a), kernels.stream(t))
    kernels.raise_on_error(name, code)


I32, U32, BOOL = torch.int32, torch.uint32, torch.bool


def _check_cuda(name, named) -> None:
    """Every given tensor contiguous on the card with the dtype the
    kernel reads it as."""
    for label, t, dtype in named:
        if t is not None:
            kernels.check(f"{name} {label}", t, dtype,
                          align=t.element_size())


def _check_select(name, sent, keys, fanout, chunk, tx, next_send, infected,
                  rows, hops, loss_keys, region, partition_id) -> None:
    """sent_select's argument rules, on either device."""
    s, n = tx.shape
    calib = infected is not None
    if calib == (rows is not None):
        raise ValueError(f"{name}: give infected (calibration) or rows "
                         "(broadcast), not both")
    if not calib and chunk != n:
        raise ValueError(f"{name}: broadcast mode draws one chunk of N")
    if not 1 <= chunk <= n or fanout < 1:
        raise ValueError(f"{name}: chunk must be in 1..{n} and fanout "
                         f">= 1, got {chunk} and {fanout}")
    _check_shapes(name, (
        ("keys", keys, (s, -(-n // chunk), 2)), ("sent", sent, (s, n, n)),
        ("next_send", next_send, (s, n)),
        ("infected", infected, (s, n)), ("hops", hops, (s, n)),
        ("loss_keys", loss_keys, (s, 2, 2)), ("region", region, (n,)),
        ("partition_id", partition_id, (n,)),
    ))
    if rows is not None and (rows.dim() != 3 or rows.shape[:2] != (s, n)):
        raise ValueError(f"{name}: rows must be [{s}, {n}, R]")


def _select_fields(name, sent, keys, fanout, chunk, *, tx, next_send=None,
                   tick=0, infected=None, rows=None, hops=None,
                   loss_keys=None, loss=0.0, wan_loss=0.0, region=None,
                   partition_id=None, sev=None, partition_active=False):
    """The card's checks of sent_select's leaves (arguments as
    :func:`sent_select`'s), its fresh outputs other than counts
    (new_infected, or new_rows and cand) and its fields of the argument
    block."""
    if fanout > MAX_FANOUT:
        raise ValueError(f"{name}: the kernel takes a fanout of at most "
                         f"{MAX_FANOUT}, got {fanout}")
    if sev is not None:
        sev = sev.to(torch.uint8).contiguous()
    if rows is not None and rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: rows must be int32 or int64, got "
                         f"{rows.dtype}")
    _check_cuda(name, (
        ("sent", sent, BOOL), ("keys", keys, U32), ("tx", tx, I32),
        ("next_send", next_send, I32), ("infected", infected, BOOL),
        ("rows", rows, None if rows is None else rows.dtype),
        ("hops", hops, I32), ("loss_keys", loss_keys, U32),
        ("region", region, I32), ("partition_id", partition_id, I32),
        ("sev", sev, torch.uint8)))
    s, n = tx.shape
    calib = infected is not None
    if calib:
        outs = (infected.clone(),)
    else:
        outs = (rows.clone(),
                None if hops is None else torch.full_like(hops, HOP_UNSET))
    return outs, dict(
        sent=sent, keys=keys, loss_keys=loss_keys, infected=infected, tx=tx,
        next_send=next_send, rows=rows, hops=hops, part=partition_id,
        sev=sev, region=region, new_infected=outs[0] if calib else None,
        new_rows=None if calib else outs[0],
        cand=None if calib else outs[1], s=s, n=n, k=fanout, chunk=chunk,
        nchunks=-(-n // chunk), r=0 if calib else rows.shape[2],
        wide=int(rows is not None and rows.dtype == torch.int64),
        sev_b=0 if sev is None else sev.shape[0], tick=tick,
        part_active=int(bool(partition_active)), use_loss=int(loss > 0.0),
        loss=loss, wan_loss=wan_loss, one=1, hit_bits=hit_bits(n, fanout))


def sent_select(sent, keys, fanout: int, chunk: int, *, tx, next_send=None,
                tick: int = 0, infected=None, rows=None, hops=None,
                loss_keys=None, loss=0.0, wan_loss=0.0, region=None,
                partition_id=None, sev=None, partition_active=False):
    """Selection, delivery and marks of one tick for every (seed, row).

    sent [S, N, N] bool (marked in place); keys [S, ceil(N/chunk), 2]
    uint32, the score key of each sender chunk; tx, next_send [S, N]
    int32 (next_send may be None in broadcast mode).

    Calibration mode (``infected`` [S, N] bool): returns
    (new_infected [S, N] bool, counts [S, N] int32).  Broadcast mode
    (``rows`` [S, N, R] int32 or int64, ``chunk`` = N): ``hops`` [S, N]
    int32 or None; ``loss_keys`` [S, 2, 2] uint32 (``key_l`` and
    ``fold_in(key_l, 1)``); ``loss`` > 0 draws the loss uniforms;
    ``region`` [N] int32 (the WAN drop of ``wan_loss``), ``partition_id``
    [N] int32 with ``sev`` [B, B] bool or None and a host
    ``partition_active``; returns (new_rows, cand [S, N] int32 or None,
    counts).  Inactive rows send nothing and count 0."""
    args = dict(tx=tx, next_send=next_send, tick=tick, infected=infected,
                rows=rows, hops=hops, loss_keys=loss_keys, loss=loss,
                wan_loss=wan_loss, region=region, partition_id=partition_id,
                sev=sev, partition_active=partition_active)
    _check_select("sent_select", sent, keys, fanout, chunk, tx, next_send,
                  infected, rows, hops, loss_keys, region, partition_id)
    if kernels.on_cpu(sent, keys, tx, next_send, infected, rows, hops,
                      loss_keys, region, partition_id, sev):
        return sent_select_plain(sent, keys, fanout, chunk, **args)
    outs, fields = _select_fields("sent_select", sent, keys, fanout, chunk,
                                  **args)
    counts = torch.zeros(tx.shape, dtype=I32, device=tx.device)
    _launch("sent_select", "sent_select_launch",
            _args(counts=counts, **fields), tx)
    sent_select.launches += 1
    return (*outs, counts)


def _commit_fields(msgs, tier, max_tx, backoff, outs):
    """sent_commit's own fields of the argument block; ``outs`` its
    int32 outputs (tx, msgs, next_send or None, hops or None)."""
    tx_out, msgs_out, next_out, hops_out = outs
    return dict(msgs=msgs, tier=tier, tx_out=tx_out, next_out=next_out,
                msgs_out=msgs_out, hops_out=hops_out, max_tx=max_tx,
                backoff=backoff)


def sent_commit(counts, tx, msgs, *, tick: int, max_tx: int,
                backoff: float = 0.0, next_send=None, infected=None,
                new_infected=None, rows=None, new_rows=None, hops=None,
                cand=None, tier=None):
    """The epilogue of one tick for every (seed, node), on
    :func:`sent_select`'s results; [S, N] leaves, tier [N] int32 or None.

    Calibration mode (``infected`` and ``new_infected`` given): returns
    (tx, next_send, msgs).  Broadcast mode (``rows`` and ``new_rows``):
    returns (tx, msgs, hops, next_send), hops and next_send None when
    not given.  Every output is a fresh tensor."""
    s, n = tx.shape
    calib = infected is not None
    if calib and (new_infected is None or next_send is None):
        raise ValueError("sent_commit: calibration mode needs new_infected "
                         "and next_send")
    if not calib and (rows is None or new_rows is None):
        raise ValueError("sent_commit: give infected (calibration) or rows "
                         "and new_rows (broadcast)")
    if (hops is None) != (cand is None):
        raise ValueError("sent_commit: hops and cand come together")
    _check_shapes("sent_commit", (
        ("counts", counts, (s, n)), ("msgs", msgs, (s, n)),
        ("next_send", next_send, (s, n)), ("infected", infected, (s, n)),
        ("new_infected", new_infected, (s, n)), ("hops", hops, (s, n)),
        ("cand", cand, (s, n)), ("tier", tier, (n,)),
    ))
    if rows is not None and new_rows.shape != rows.shape:
        raise ValueError("sent_commit: new_rows must be shaped as rows")
    args = dict(tick=tick, max_tx=max_tx, backoff=backoff,
                next_send=next_send, infected=infected,
                new_infected=new_infected, rows=rows, new_rows=new_rows,
                hops=hops, cand=cand, tier=tier)
    if kernels.on_cpu(counts, tx, msgs, next_send, infected, new_infected,
                      rows, new_rows, hops, cand, tier):
        return sent_commit_plain(counts, tx, msgs, **args)
    if rows is not None and rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"sent_commit: rows must be int32 or int64, got "
                         f"{rows.dtype}")
    row_dtype = None if rows is None else rows.dtype
    _check_cuda("sent_commit", (
        ("counts", counts, I32), ("tx", tx, I32), ("msgs", msgs, I32),
        ("next_send", next_send, I32), ("infected", infected, BOOL),
        ("new_infected", new_infected, BOOL), ("rows", rows, row_dtype),
        ("new_rows", new_rows, row_dtype), ("hops", hops, I32),
        ("cand", cand, I32), ("tier", tier, I32)))
    outs = (torch.empty_like(tx), torch.empty_like(msgs),
            None if next_send is None else torch.empty_like(next_send),
            None if hops is None else torch.empty_like(hops))
    a = _args(
        infected=infected, tx=tx, next_send=next_send, rows=rows, hops=hops,
        new_infected=new_infected, new_rows=new_rows, cand=cand,
        counts=counts, s=s, n=n, r=0 if calib else rows.shape[2],
        wide=int(row_dtype == torch.int64), tick=tick,
        **_commit_fields(msgs, tier, max_tx, backoff, outs))
    _launch("sent_commit", "sent_commit_launch", a, tx)
    sent_commit.launches += 1
    tx_out, msgs_out, next_out, hops_out = outs
    if calib:
        return tx_out, next_out, msgs_out
    return tx_out, msgs_out, hops_out, next_out


def sent_tick(sent, keys, fanout: int, chunk: int, *, tx, msgs, tick: int,
              max_tx: int, backoff: float = 0.0, next_send=None,
              infected=None, rows=None, hops=None, loss_keys=None, loss=0.0,
              wan_loss=0.0, region=None, partition_id=None, sev=None,
              partition_active=False, tier=None):
    """One tick of the sampler from one host call: :func:`sent_select`
    then :func:`sent_commit` on its results (arguments as theirs; the
    commit's ``max_tx``, ``backoff``, ``msgs`` and ``tier``).  The
    leaves are checked once, every output is allocated at once and one
    argument block enqueues both kernels, the commit under programmatic
    dependent launch.  ``sent`` is marked in place.

    Returns sent_select's results followed by sent_commit's:
    calibration (new_infected, counts, tx, next_send, msgs); broadcast
    (new_rows, cand, counts, tx, msgs, hops, next_send)."""
    select = dict(tx=tx, next_send=next_send, tick=tick, infected=infected,
                  rows=rows, hops=hops, loss_keys=loss_keys, loss=loss,
                  wan_loss=wan_loss, region=region,
                  partition_id=partition_id, sev=sev,
                  partition_active=partition_active)
    _check_select("sent_tick", sent, keys, fanout, chunk, tx, next_send,
                  infected, rows, hops, loss_keys, region, partition_id)
    s, n = tx.shape
    if infected is not None and next_send is None:
        raise ValueError("sent_tick: calibration mode needs next_send")
    _check_shapes("sent_tick", (("msgs", msgs, (s, n)),
                                ("tier", tier, (n,))))
    if kernels.on_cpu(sent, keys, tx, msgs, next_send, infected, rows, hops,
                      loss_keys, region, partition_id, sev, tier):
        return sent_tick_plain(sent, keys, fanout, chunk, msgs=msgs,
                               max_tx=max_tx, backoff=backoff, tier=tier,
                               **select)
    outs, fields = _select_fields("sent_tick", sent, keys, fanout, chunk,
                                  **select)
    _check_cuda("sent_tick", (("msgs", msgs, I32), ("tier", tier, I32)))
    # counts (its inactive rows' 0 the commit's), tx, msgs, then
    # next_send and hops where given: one buffer, nothing filled
    given = (next_send is not None, hops is not None)
    buf = torch.empty((3 + sum(given), s, n), dtype=I32, device=tx.device)
    counts, tx_out, msgs_out, *more = buf.unbind(0)
    next_out = more.pop(0) if given[0] else None
    hops_out = more.pop(0) if given[1] else None
    _launch("sent_tick", "sent_tick_launch", _args(
        counts=counts, **fields,
        **_commit_fields(msgs, tier, max_tx, backoff,
                         (tx_out, msgs_out, next_out, hops_out))), tx)
    sent_select.launches += 1
    sent_commit.launches += 1
    if infected is not None:
        return (*outs, counts, tx_out, next_out, msgs_out)
    return (*outs, counts, tx_out, msgs_out, hops_out, next_out)


sent_select.launches = 0
sent_commit.launches = 0
