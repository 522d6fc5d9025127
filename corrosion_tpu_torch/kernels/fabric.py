"""The validity wire (``bits_pack`` and its forms, ``bits_unpack`` and
``bits_unpack_add``), ``route_pack`` and ``ring_receive``: the compute
steps around the shard fabric's collectives (csrc/fabric.cu,
csrc/deliver_perm.cu).

``bits_pack`` / ``bits_unpack`` replace corrosion_tpu/models/sharded.py
``_pack_bits`` (:57) / ``_unpack_bits`` (:68), the multi-host layout's
wire encoding of a validity mask (LSB first, one bit a row).  Its
masks are packed straight from their sources (``bits_pack_above``: the
still-bad rows ``rounds > t``; ``bits_pack_active``: the active rows
and their bool mask in one pass) and unpacked straight into their
consumer (``bits_unpack_add``: ``accepted += unpack(wire)``); the
unpacks count the set bits for the host's test of the exchange, through
a scratch word a device and stream (``_count_scratch``) that the kernels
leave zero.
``route_pack`` replaces the demand marks and the capped per-destination
packing of ``sharded_broadcast_step_ring`` (:216-248), ``ring_receive``
its receive side, the received-id slot map and the delivery
(:253-279).  ``route_pack`` is three launches over the whole card
(mark, count, write; csrc/fabric.cu) that meet in a scratch buffer
(``_scratch``, one a device and stream) whose marks the kernels leave
zero.  ``ring_receive`` is one host call, two kernels of
csrc/deliver_perm.cu under programmatic dependent launch (the slot
map, then the delivery) over a slot map kept a device and stream
(``_slot_map``) whose entries carry the call's generation, so it is
never filled between calls.  Bound on the H100: bytes.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.deliver import MAX_ROWS, deliver_perm_plain

_PACK_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_void_p)
_UNPACK_ARGTYPES = ((ctypes.c_void_p,) * 2 + (ctypes.c_longlong,)
                    + (ctypes.c_void_p,) * 3)
_UNPACK_ADD_ARGTYPES = ((ctypes.c_void_p,) * 2
                        + (ctypes.c_longlong, ctypes.c_int)
                        + (ctypes.c_void_p,) * 3)
_ABOVE_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p)
_ACTIVE_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p)
_ROUTE_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7
                   + (ctypes.c_void_p,))
_RECEIVE_ARGTYPES = ((ctypes.c_void_p,) * 12
                     + (ctypes.c_int,) * 3 + (ctypes.c_float,)
                     + (ctypes.c_int,) * 5 + (ctypes.c_uint, ctypes.c_void_p))
_GENERATIONS = 2**32  # a tag holds a 32-bit generation
_SCRATCH: dict = {}
_SLOT_MAPS: dict = {}
_COUNTS: dict = {}


def _scratch(device, n_local: int, d: int) -> torch.Tensor:
    """``route_pack``'s scratch for ``d`` destinations of ``n_local``
    rows on ``device``'s current stream: its mark words first, zero when
    made and left zero by the kernels, then the tile counts, which the
    kernels write whole.  One a device and stream, of the last shape:
    another shape replaces it with a zeroed one (its marks would lie on
    the old counts)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    held = _SCRATCH.get(key)
    if held is None or held[0] != (n_local, d):
        words = kernels.function("fabric", "route_pack_scratch_words",
                                 (ctypes.c_int, ctypes.c_int))
        held = ((n_local, d), torch.zeros(words(n_local, d),
                                          dtype=torch.int32, device=device))
        _SCRATCH[key] = held
    return held[1]


def marks_clear(device, n_local: int, d: int) -> bool:
    """Whether ``route_pack``'s scratch for this shape on ``device``'s
    current stream has every mark word zero, as each call must leave it
    (true where no such scratch is held)."""
    held = _SCRATCH.get((device,
                         torch.cuda.current_stream(device).cuda_stream))
    if held is None or held[0] != (n_local, d):
        return True
    return not int(torch.count_nonzero(held[1][:d * (-(-n_local // 32))]))


def _count_scratch(device) -> torch.Tensor:
    """The unpacks' count scratch on ``device``'s current stream: one
    int64 word, the running sum in its low half and the blocks done in
    its high half, zero when made and left zero by every call (the last
    block moves the sum out)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    held = _COUNTS.get(key)
    if held is None:
        held = _COUNTS[key] = torch.zeros(1, dtype=torch.int64,
                                          device=device)
    return held


def _launch_unpack(name: str, symbol: str, argtypes, wire, out, count,
                   *args) -> None:
    """Launch the unpack ``symbol(wire, out, *args, scratch, count,
    stream)``; with ``count`` ([1] int32) it receives the wire's set
    bits through the count scratch, which a failed launch may leave set
    and so drops."""
    dev = wire.device
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    scratch = None if count is None else _count_scratch(dev)
    fn = kernels.function("fabric", symbol, argtypes)
    code = fn(kernels.ptr(wire), kernels.ptr(out), wire.numel(), *args,
              kernels.ptr(scratch), kernels.ptr(count), kernels.stream(wire))
    if code:
        _COUNTS.pop(key, None)
    kernels.raise_on_error(name, code)


def _check_rows(name: str, t, dtype) -> None:
    if t.dtype != dtype or t.dim() < 1 or t.shape[-1] % 8:
        raise ValueError(f"{name}: needs a {dtype} tensor whose last axis is "
                         f"a multiple of 8, got {t.dtype} {tuple(t.shape)}")


def _check_wire(name: str, wire, m: int) -> None:
    if wire.dtype != torch.uint8 or wire.dim() < 1 or m != 8 * wire.shape[-1]:
        raise ValueError(f"{name}: needs uint8 [..., {m // 8}], got "
                         f"{wire.dtype} {tuple(wire.shape)}")


def bits_pack_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bits_pack`."""
    m = mask.shape[-1]
    lanes = mask.reshape(*mask.shape[:-1], m // 8, 8).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=mask.device)
    return (lanes << shifts).sum(-1).to(torch.uint8)


def bits_unpack_plain(wire: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`bits_unpack`."""
    shifts = torch.arange(8, dtype=torch.int32, device=wire.device)
    bits = (wire.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*wire.shape[:-1], m).bool()


def bits_pack_above_plain(x: torch.Tensor, t: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`bits_pack_above`."""
    return bits_pack_plain(x > t)


def bits_pack_active_plain(infected, tx, next_send, tick: int):
    """Plain PyTorch version of :func:`bits_pack_active`."""
    active = infected & (tx > 0) & (next_send <= tick)
    return active, bits_pack_plain(active)


def bits_unpack_add_plain(wire: torch.Tensor, m: int, accepted: torch.Tensor,
                          first: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`bits_unpack_add`."""
    bad = bits_unpack_plain(wire, m)
    if first:
        accepted.copy_(bad)
    else:
        accepted += bad
    return bad.sum(dtype=torch.int32).reshape(1)


def bits_pack(mask: torch.Tensor) -> torch.Tensor:
    """[..., M] bool (M % 8 == 0) -> [..., M // 8] uint8, bit q of byte
    b the mask's entry 8b + q."""
    _check_rows("bits_pack", mask, torch.bool)
    if kernels.on_cpu(mask):
        return bits_pack_plain(mask)
    kernels.check("bits_pack mask", mask, torch.bool, align=1)
    wire = torch.empty((*mask.shape[:-1], mask.shape[-1] // 8),
                       dtype=torch.uint8, device=mask.device)
    fn = kernels.function("fabric", "bits_pack_launch", _PACK_ARGTYPES)
    code = fn(kernels.ptr(mask), kernels.ptr(wire), wire.numel(),
              kernels.stream(mask))
    bits_pack.launches += 1
    kernels.raise_on_error("bits_pack", code)
    return wire


def bits_pack_above(x: torch.Tensor, t: int) -> torch.Tensor:
    """``bits_pack(x > t)`` without the bool mask: [..., M] int32 (M % 8
    == 0) -> [..., M // 8] uint8."""
    _check_rows("bits_pack_above", x, torch.int32)
    if kernels.on_cpu(x):
        return bits_pack_above_plain(x, t)
    kernels.check("bits_pack_above x", x, torch.int32)
    wire = torch.empty((*x.shape[:-1], x.shape[-1] // 8), dtype=torch.uint8,
                       device=x.device)
    fn = kernels.function("fabric", "bits_pack_above_launch",
                          _ABOVE_ARGTYPES)
    code = fn(kernels.ptr(x), int(t), kernels.ptr(wire), x.numel(),
              kernels.stream(x))
    bits_pack_above.launches += 1
    kernels.raise_on_error("bits_pack_above", code)
    return wire


def bits_pack_active(infected, tx, next_send, tick: int):
    """The host layout's active rows and their wire in one pass:
    ``active = infected & (tx > 0) & (next_send <= tick)`` on [S, M]
    (M % 8 == 0); ``infected`` may be a window of wider rows
    (``x[:, lo:lo + M]``, read in place: stride (>= M, 1)), tx and
    next_send are contiguous int32.  Returns (active [S, M] bool,
    ``bits_pack(active)`` [S, M // 8] uint8)."""
    if tx.dim() != 2 or tx.dtype != torch.int32 or tx.shape[1] % 8:
        raise ValueError(f"bits_pack_active: tx must be int32 [S, M] with "
                         f"M % 8 == 0, got {tx.dtype} {tuple(tx.shape)}")
    s, m = tx.shape
    ld = kernels.row_stride("bits_pack_active: infected", infected, s, m)
    if next_send.dtype != torch.int32 or next_send.shape != tx.shape:
        raise ValueError(f"bits_pack_active: next_send must be int32 "
                         f"[{s}, {m}]")
    if kernels.on_cpu(infected, tx, next_send):
        return bits_pack_active_plain(infected, tx, next_send, tick)
    kernels.check("bits_pack_active tx", tx, torch.int32)
    kernels.check("bits_pack_active next_send", next_send, torch.int32)
    dev = tx.device
    active = torch.empty((s, m), dtype=torch.bool, device=dev)
    wire = torch.empty((s, m // 8), dtype=torch.uint8, device=dev)
    p = kernels.ptr
    fn = kernels.function("fabric", "bits_pack_active_launch",
                          _ACTIVE_ARGTYPES)
    code = fn(p(infected), ld, p(tx), p(next_send), int(tick), p(active),
              p(wire), s, m, kernels.stream(tx))
    bits_pack_active.launches += 1
    kernels.raise_on_error("bits_pack_active", code)
    return active, wire


def bits_unpack(wire: torch.Tensor, m: int, *, count=None) -> torch.Tensor:
    """Inverse of :func:`bits_pack`: [..., M // 8] uint8 -> [..., M]
    bool.  ``count``, a [1] int32 tensor on the wire's device, receives
    the number of set bits."""
    _check_wire("bits_unpack", wire, m)
    if kernels.on_cpu(wire, count):
        mask = bits_unpack_plain(wire, m)
        if count is not None:
            count.copy_(mask.sum(dtype=torch.int32).reshape(1))
        return mask
    kernels.check("bits_unpack wire", wire, torch.uint8, align=1)
    if count is not None:
        kernels.check("bits_unpack count", count, torch.int32, (1,))
    mask = torch.empty((*wire.shape[:-1], m), dtype=torch.bool,
                       device=wire.device)
    bits_unpack.launches += 1
    _launch_unpack("bits_unpack", "bits_unpack_launch", _UNPACK_ARGTYPES,
                   wire, mask, count)
    return mask


def bits_unpack_add(wire: torch.Tensor, m: int, accepted: torch.Tensor,
                    first: bool) -> torch.Tensor:
    """``accepted += bits_unpack(wire, m)`` in place, without the bool
    mask; with ``first``, ``accepted`` is written whole as the unpacked
    0 / 1 (its old values are not read).  wire [..., M // 8] uint8,
    accepted [..., M] int32 contiguous.  Returns the wire's set bits,
    [1] int32."""
    _check_wire("bits_unpack_add", wire, m)
    if (accepted.dtype != torch.int32
            or tuple(accepted.shape) != (*wire.shape[:-1], m)):
        raise ValueError(f"bits_unpack_add: accepted must be int32 "
                         f"{(*wire.shape[:-1], m)}, got {accepted.dtype} "
                         f"{tuple(accepted.shape)}")
    if kernels.on_cpu(wire, accepted):
        return bits_unpack_add_plain(wire, m, accepted, first)
    kernels.check("bits_unpack_add wire", wire, torch.uint8, align=1)
    kernels.check("bits_unpack_add accepted", accepted, torch.int32)
    count = torch.empty(1, dtype=torch.int32, device=wire.device)
    bits_unpack_add.launches += 1
    _launch_unpack("bits_unpack_add", "bits_unpack_add_launch",
                   _UNPACK_ADD_ARGTYPES, wire, accepted, count,
                   int(bool(first)))
    return count


def route_pack_plain(senders, active_l, rows_l, shard: int, cap: int):
    """Plain PyTorch version of :func:`route_pack`: the reference's
    demand scatter-max and its sort of (index or n_local) scores."""
    k, n = senders.shape
    n_local = rows_l.shape[0]
    d = n // n_local
    lo = shard * n_local
    dev = rows_l.device
    needed = torch.zeros((d, n_local), dtype=torch.bool, device=dev)
    dest = (torch.arange(n, device=dev) // n_local).expand(k, n)
    mine = (senders >= lo) & (senders < lo + n_local)
    needed[dest[mine], (senders[mine] - lo).to(torch.int64)] = True
    needed &= active_l[None, :]
    idx = torch.arange(n_local, dtype=torch.int32, device=dev)
    scores = torch.where(needed, idx[None, :], n_local)
    picked = torch.sort(scores, dim=1).values[:, :cap]
    valid = picked < n_local
    overflow = (needed.sum(1) - valid.sum(1)).sum().to(torch.int32)
    safe = torch.where(valid, picked, 0).to(torch.int64)
    send_ids = torch.where(valid, lo + picked, -1).to(torch.int32)
    send_rows = torch.where(valid[..., None], rows_l[safe], 0)
    return send_ids, send_rows, overflow.reshape(1)


def route_pack(senders, active_l, rows_l, shard: int, cap: int):
    """One source shard's destination-sorted send buffers.

    senders [K, N] int32 receiver->sender maps (global ids); active_l
    [n_local] bool, my senders' activity; rows_l [n_local, R] int32, my
    rows (global ids shard * n_local ...); cap <= n_local slots a
    destination.  Destination d gets, in ascending local index, the
    first ``cap`` of my active rows that some receiver of d drew:
    returns (send_ids [D, cap] int32 global ids with -1 pads,
    send_rows [D, cap, R] int32 with zero pads, overflow [1] int32, the
    needed rows that did not fit)."""
    k, n = senders.shape
    n_local, r = rows_l.shape
    if n_local < 1 or n % n_local or not 1 <= cap <= n_local:
        raise ValueError(f"route_pack: {n} nodes in shards of {n_local} "
                         f"with cap {cap}")
    if active_l.dtype != torch.bool or tuple(active_l.shape) != (n_local,):
        raise ValueError(f"route_pack: active_l must be bool [{n_local}]")
    if kernels.on_cpu(senders, active_l, rows_l):
        return route_pack_plain(senders, active_l, rows_l, shard, cap)
    d = n // n_local
    dev = rows_l.device
    i32 = torch.int32
    return _pack_into(senders, active_l, rows_l, shard,
                      torch.empty((d, cap), dtype=i32, device=dev),
                      torch.empty((d, cap, r), dtype=i32, device=dev),
                      torch.empty((1,), dtype=i32, device=dev))


def _pack_into(senders, active_l, rows_l, shard: int, send_ids, send_rows,
               overflow):
    """:func:`route_pack`'s kernels on CUDA tensors, into the given
    outputs (send_ids [D, cap], send_rows [D, cap, R] and overflow [1]
    int32, contiguous, 4-byte aligned); returns them."""
    k, n = senders.shape
    n_local, r = rows_l.shape
    d, cap = send_ids.shape
    kernels.check("route_pack senders", senders, torch.int32, (k, n))
    kernels.check("route_pack active_l", active_l, torch.bool, (n_local,),
                  align=1)
    kernels.check("route_pack rows_l", rows_l, torch.int32, (n_local, r))
    kernels.check("route_pack send_ids", send_ids, torch.int32, (d, cap))
    kernels.check("route_pack send_rows", send_rows, torch.int32,
                  (d, cap, r))
    kernels.check("route_pack overflow", overflow, torch.int32, (1,))
    dev = rows_l.device
    scratch = _scratch(dev, n_local, d)
    p = kernels.ptr
    fn = kernels.function("fabric", "route_pack_launch", _ROUTE_ARGTYPES)
    code = fn(p(senders), p(active_l), p(rows_l), p(scratch), p(send_ids),
              p(send_rows), p(overflow), k, n, shard * n_local, n_local, d,
              cap, r, kernels.stream(rows_l))
    route_pack.launches += 1
    if code:  # the marks may be left set: the next call starts afresh
        _SCRATCH.pop((dev, torch.cuda.current_stream(dev).cuda_stream),
                      None)
    kernels.raise_on_error("route_pack", code)
    return send_ids, send_rows, overflow


def route_slots_plain(recv_ids, n: int):
    """recv_ids [Q] int32 (unique global ids, -1 pads) -> slot_of [n]
    int32: the position of each received id, -1 where it is absent (the
    reference's slot map, ``sharded.py`` :253-259)."""
    slot_of = torch.full((n,), -1, dtype=torch.int32, device=recv_ids.device)
    ok = recv_ids >= 0
    q = torch.arange(recv_ids.numel(), dtype=torch.int32,
                     device=recv_ids.device)
    slot_of[recv_ids[ok].to(torch.int64)] = q[ok]
    return slot_of


def route_order_bad(recv_ids, n: int) -> torch.Tensor:
    """[1] int32, 1 where ``recv_ids`` [D, cap] breaks ``route_pack``'s
    contract (section e ascends within source shard e's rows
    ``[e * n // D, (e + 1) * n // D)``, then -1 pads), else 0."""
    d, cap = recv_ids.shape
    n_local = n // d
    lo = torch.arange(d, device=recv_ids.device)[:, None] * n_local
    valid = recv_ids >= 0
    ok = torch.where(valid, (recv_ids >= lo) & (recv_ids < lo + n_local),
                     recv_ids == -1)
    ok[:, 1:] &= ~valid[:, 1:] | (valid[:, :-1]
                                  & (recv_ids[:, :-1] < recv_ids[:, 1:]))
    return (~ok.all()).to(torch.int32).reshape(1)


def ring_receive_plain(rows, tx, msgs, senders, recv_ids, recv_rows, *,
                       loss_u=None, loss=0.0, max_tx=8, lo=0):
    """Plain PyTorch version of :func:`ring_receive`: the slot map of
    ``route_slots_plain``, ``deliver_perm_plain`` through it, and the
    contract flag of ``route_order_bad``."""
    n = senders.shape[1]
    slot_of = route_slots_plain(recv_ids.reshape(-1), n)
    out = deliver_perm_plain(
        rows, tx, msgs, senders, loss_u=loss_u, loss=loss, max_tx=max_tx,
        src_rows=recv_rows.reshape(-1, rows.shape[1]), slot_of=slot_of,
        lo=lo)
    return (*out[:3], route_order_bad(recv_ids, n))


def _slot_map(device, n: int) -> list:
    """``ring_receive``'s slot map on ``device``'s current stream and the
    generation of the call about to use it: [map, generation], the map
    [n + 1] int64 tags, ``(generation << 32) | slot`` for each id a call
    received and then the flag word, zero (no generation) when made.
    Each call takes the next generation, so the entries earlier calls
    left are never taken for its own; when the 32-bit count wraps, the
    map is zeroed again."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    held = _SLOT_MAPS.get(key)
    if held is None or held[0].numel() != n + 1:
        held = [torch.zeros(n + 1, dtype=torch.int64, device=device), 0]
        _SLOT_MAPS[key] = held
    held[1] += 1
    if held[1] == _GENERATIONS:
        held[0].zero_()
        held[1] = 1
    return held


def ring_receive(rows, tx, msgs, senders, recv_ids, recv_rows, *,
                 loss_u=None, loss=0.0, max_tx=8, lo=0):
    """The ring fabric's receive side for the receivers ``[lo, lo + n)``:
    the received ids' slot map and the delivery from the received rows
    (``deliver_perm`` with that source), in one call.

    rows [n, R], tx, msgs [n] int32, my receivers' leaves; senders [K, N]
    int32 maps; recv_ids [D, cap] int32 and recv_rows [D, cap, R] int32
    as the all_to_all delivered ``route_pack``'s buffers, block e from
    source shard e; loss_u [N, K] float32 draws or None.  The ids must
    keep ``route_pack``'s contract: block e holds ids of shard e's rows
    ``[e * N // D, (e + 1) * N // D)`` in ascending order, then -1 pads
    (so no id comes twice).  Returns (rows, tx, msgs, bad) as new
    tensors, ``bad`` [1] int32 nonzero where the ids break that
    contract: the other outputs are then not the delivery's."""
    k, n_global = senders.shape
    n, r = rows.shape
    if recv_ids.dim() != 2 or recv_rows.shape != (*recv_ids.shape, r):
        raise ValueError(f"ring_receive: recv_ids [D, cap] and recv_rows "
                         f"[D, cap, {r}], got {tuple(recv_ids.shape)} and "
                         f"{tuple(recv_rows.shape)}")
    d, cap = recv_ids.shape
    if n_global % d or cap > n_global // d or not 0 <= lo <= n_global - n:
        raise ValueError(f"ring_receive: {n} receivers from {lo} and "
                         f"{d} x {cap} slots over {n_global} nodes")
    args = dict(loss_u=loss_u, loss=loss, max_tx=max_tx, lo=lo)
    if kernels.on_cpu(rows, tx, msgs, senders, recv_ids, recv_rows, loss_u):
        return ring_receive_plain(rows, tx, msgs, senders, recv_ids,
                                  recv_rows, **args)
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"ring_receive: the kernel takes 1..{MAX_ROWS} "
                         f"cells per row, got {r}")
    i32 = torch.int32
    kernels.check("ring_receive rows", rows, i32, (n, r), align=16)
    kernels.check("ring_receive tx", tx, i32, (n,))
    kernels.check("ring_receive msgs", msgs, i32, (n,))
    kernels.check("ring_receive senders", senders, i32, (k, n_global))
    kernels.check("ring_receive recv_ids", recv_ids, i32, (d, cap))
    kernels.check("ring_receive recv_rows", recv_rows, i32, (d, cap, r),
                  align=16)
    if loss_u is not None:
        kernels.check("ring_receive loss_u", loss_u, torch.float32,
                      (n_global, k))
    dev = rows.device
    tags, gen = _slot_map(dev, n_global)
    # one allocation: rows, then tx, msgs and the flag
    out = torch.empty(n * r + 2 * n + 1, dtype=i32, device=dev)
    rows_out = out[:n * r].view(n, r)
    tx_out, msgs_out, bad = out[n * r:].split((n, n, 1))
    p = kernels.ptr
    fn = kernels.function("deliver_perm", "ring_receive_launch",
                          _RECEIVE_ARGTYPES)
    code = fn(p(rows), p(tx), p(msgs), p(senders), p(loss_u), p(recv_ids),
              p(recv_rows), p(tags), p(rows_out), p(tx_out), p(msgs_out),
              p(bad), n, r, k, float(loss), int(max_tx), lo, n_global, d,
              cap, gen, kernels.stream(rows))
    ring_receive.launches += 1
    kernels.raise_on_error("ring_receive", code)
    return rows_out, tx_out, msgs_out, bad


bits_pack.launches = 0
bits_pack_above.launches = 0
bits_pack_active.launches = 0
bits_unpack.launches = 0
bits_unpack_add.launches = 0
route_pack.launches = 0
ring_receive.launches = 0
