"""``bits_pack`` / ``bits_unpack`` and ``route_pack`` / ``route_slots``:
the compute steps around the shard fabric's collectives
(csrc/fabric.cu).

``bits_pack`` / ``bits_unpack`` replace corrosion_tpu/models/sharded.py
``_pack_bits`` (:57) / ``_unpack_bits`` (:68), the multi-host layout's
wire encoding of a validity mask (LSB first, one bit a row).
``route_pack`` / ``route_slots`` replace the demand marks, the capped
per-destination packing and the received-id slot map of
``sharded_broadcast_step_ring`` (:216-259).  ``route_pack`` is three
launches over the whole card (mark, count, write; csrc/fabric.cu) that
meet in a scratch buffer (``_scratch``, one a device and stream) whose
marks the kernels leave zero.  Bound on the H100: bytes.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels

_PACK_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_void_p)
_ROUTE_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7
                   + (ctypes.c_void_p,))
_SLOTS_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p)
_SCRATCH: dict = {}


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


def bits_pack(mask: torch.Tensor) -> torch.Tensor:
    """[..., M] bool (M % 8 == 0) -> [..., M // 8] uint8, bit q of byte
    b the mask's entry 8b + q."""
    if mask.dtype != torch.bool or mask.dim() < 1 or mask.shape[-1] % 8:
        raise ValueError("bits_pack: needs a bool mask whose last axis is "
                         f"a multiple of 8, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if kernels.on_cpu(mask):
        return bits_pack_plain(mask)
    kernels.check("bits_pack mask", mask, torch.bool, align=8)
    wire = torch.empty((*mask.shape[:-1], mask.shape[-1] // 8),
                       dtype=torch.uint8, device=mask.device)
    fn = kernels.function("fabric", "bits_pack_launch", _PACK_ARGTYPES)
    code = fn(kernels.ptr(mask), kernels.ptr(wire), wire.numel(),
              kernels.stream(mask))
    bits_pack.launches += 1
    kernels.raise_on_error("bits_pack", code)
    return wire


def bits_unpack(wire: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`bits_pack`: [..., M // 8] uint8 -> [..., M]
    bool."""
    if wire.dtype != torch.uint8 or wire.dim() < 1 or m != 8 * wire.shape[-1]:
        raise ValueError(f"bits_unpack: needs uint8 [..., {m // 8}], got "
                         f"{wire.dtype} {tuple(wire.shape)}")
    if kernels.on_cpu(wire):
        return bits_unpack_plain(wire, m)
    kernels.check("bits_unpack wire", wire, torch.uint8, align=1)
    mask = torch.empty((*wire.shape[:-1], m), dtype=torch.bool,
                       device=wire.device)
    fn = kernels.function("fabric", "bits_unpack_launch", _PACK_ARGTYPES)
    code = fn(kernels.ptr(wire), kernels.ptr(mask), wire.numel(),
              kernels.stream(wire))
    bits_unpack.launches += 1
    kernels.raise_on_error("bits_unpack", code)
    return mask


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
    """Plain PyTorch version of :func:`route_slots`."""
    slot_of = torch.full((n,), -1, dtype=torch.int32, device=recv_ids.device)
    ok = recv_ids >= 0
    q = torch.arange(recv_ids.numel(), dtype=torch.int32,
                     device=recv_ids.device)
    slot_of[recv_ids[ok].to(torch.int64)] = q[ok]
    return slot_of


def route_slots(recv_ids, n: int):
    """recv_ids [Q] int32 (unique global ids, -1 pads) -> slot_of [n]
    int32: the position of each received id, -1 where it is absent."""
    if recv_ids.dtype != torch.int32 or recv_ids.dim() != 1:
        raise ValueError("route_slots: recv_ids must be int32 [Q]")
    if kernels.on_cpu(recv_ids):
        return route_slots_plain(recv_ids, n)
    kernels.check("route_slots recv_ids", recv_ids, torch.int32)
    slot_of = torch.empty((n,), dtype=torch.int32, device=recv_ids.device)
    fn = kernels.function("fabric", "route_slots_launch", _SLOTS_ARGTYPES)
    code = fn(kernels.ptr(recv_ids), kernels.ptr(slot_of), recv_ids.numel(),
              n, kernels.stream(recv_ids))
    route_slots.launches += 1
    kernels.raise_on_error("route_slots", code)
    return slot_of


bits_pack.launches = 0
bits_unpack.launches = 0
route_pack.launches = 0
route_slots.launches = 0
