"""``deliver_perm``: permutation-fanout delivery and the broadcast
epilogue in one pass (csrc/deliver_perm.cu).

Replaces corrosion_tpu/models/broadcast.py ``_deliver_perm`` (:327)
and the epilogue of ``broadcast_step`` (:243-280), and with a separate
source and a receiver window the local delivery of
corrosion_tpu/models/sharded.py ``sharded_broadcast_step`` (:121-147)
and ``sharded_broadcast_step_ring`` (:253-279; the ring fabric calls
it through ``kernels.fabric.ring_receive``), and with the senders' hops
``shops`` gathered beside the rows one shard's window of the epidemic
tick's delivery on a ``("seeds", "nodes")`` mesh (``__graft_entry__.py``
:183-215, ``models/sharded.py`` ``sharded_epidemic_tick``).  Bound on the H100:
bytes — the receiver's row, K randomly placed sender rows, the K
sender ids and loss draws, and the [N] state words, each moved once.
The kernel fuses the K column gathers, the validity masks, the
max-merge, the hop-min and the tx / msgs / next_send / hops update
into registers, so nothing [N, K, R]-shaped reaches memory.  The
delivery from a source is its own kernel (csrc/deliver_perm.cu
``deliver_source_kernel``: small blocks, the K columns' loads in
flight together): through a slot map it takes loss draws only (the
fabrics), through ``shops`` also the receivers' hops and next_send and
the partition (the epidemic's window; the topologies' WAN draws and RTT
tiers stay single-device).
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.models.common import blocks_cross
from corrosion_tpu_torch.ops.merge import merge_keys

HOP_UNSET = 2**30
MAX_ROWS = 16  # the kernel keeps a row in registers: R is a template

_ARGTYPES = (
    (ctypes.c_void_p,) * 11 + (ctypes.c_int, ctypes.c_void_p)
    + (ctypes.c_void_p,) * 5
    + (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float)
    + (ctypes.c_void_p,) * 2 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
)
_WINDOW_ARGTYPES = (
    (ctypes.c_void_p,) * 9 + (ctypes.c_int,) + (ctypes.c_void_p,) * 8
    + (ctypes.c_int,) * 3 + (ctypes.c_float,) + (ctypes.c_int,) * 3
    + (ctypes.c_float,) + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)
)


def _active(tx, next_send, tick):
    active = tx > 0
    if next_send is not None:
        active &= next_send <= tick
    return active


def sender_hops(tx, next_send, tick, hops=None) -> torch.Tensor:
    """Each sender's hop candidate, as the delivery reads it: hop + 1
    (0 where hops are not tracked) where the sender is active this
    tick (``tx > 0``, ``next_send <= tick``), ``HOP_UNSET`` where not.
    A shard's window of it travels beside its rows (``shops``)."""
    active = _active(tx, next_send, tick)
    unset = torch.full_like(tx, HOP_UNSET)
    if hops is not None:
        return torch.where(active, torch.clamp_max(hops, HOP_UNSET - 2) + 1,
                           unset)
    return torch.where(active, torch.zeros_like(tx), unset)


def deliver_perm_plain(rows, tx, msgs, senders, *, hops=None, next_send=None,
                       tick=0, loss_u=None, wan_u=None, region=None,
                       partition_id=None, sev=None, partition_active=False,
                       tier=None, loss=0.0, wan_loss=0.0, max_tx=8,
                       backoff=0.0, src_rows=None, slot_of=None, shops=None,
                       lo=0):
    """Plain PyTorch version of the kernel (same arguments and results
    as :func:`deliver_perm`)."""
    k, n_global = senders.shape
    n = rows.shape[0]
    my = torch.arange(lo, lo + n, device=rows.device)
    active = _active(tx, next_send, tick)
    unset = torch.full_like(tx, HOP_UNSET)
    if src_rows is None:
        src_rows = rows
        shops = sender_hops(tx, next_send, tick, hops)
    new_rows = rows
    cand = unset
    for j in range(k):
        s = senders[j][my].to(torch.int64)
        if slot_of is not None:
            slot = slot_of[s].to(torch.int64)
            valid = slot >= 0
            sh = torch.where(valid, 0, HOP_UNSET).to(torch.int32)
            s_rows = src_rows[torch.clamp_min(slot, 0)]
        else:
            sh = shops[s]
            valid = sh < HOP_UNSET
            s_rows = src_rows[s]
        if loss_u is not None:
            valid &= ~(loss_u[my, j] < loss)
        if wan_u is not None:
            valid &= ~((region[s] != region[my]) & (wan_u[my, j] < wan_loss))
        if partition_id is not None and partition_active:
            # flow is sender -> receiver
            valid &= ~blocks_cross(partition_id[s], partition_id[my], sev)
        new_rows = merge_keys(
            new_rows, torch.where(valid[:, None], s_rows, rows)
        )
        cand = torch.minimum(cand, torch.where(valid, sh, unset))
    learned = torch.any(new_rows != rows, dim=1)

    new_tx = torch.where(active, tx - 1, tx)
    new_tx = torch.where(learned, torch.full_like(tx, max_tx), new_tx)
    new_msgs = msgs + torch.where(active, k, 0).to(msgs.dtype)
    new_next = None
    if next_send is not None:
        sent = (max_tx - new_tx).to(torch.float32)
        gap = torch.clamp_min(
            torch.round(sent * torch.tensor(backoff, dtype=torch.float32))
            .to(torch.int32), 1,
        )
        first = 1
        if tier is not None:
            gap = gap * tier[my]
            first = tier[my]
        new_next = torch.where(active, tick + gap, next_send)
        new_next = torch.where(learned, tick + first, new_next).to(torch.int32)
    new_hops = None
    if hops is not None:
        new_hops = torch.where(learned, torch.minimum(hops, cand), hops)
    return new_rows, new_tx, new_msgs, new_hops, new_next


def deliver_perm(rows, tx, msgs, senders, *, hops=None, next_send=None,
                 tick=0, loss_u=None, wan_u=None, region=None,
                 partition_id=None, sev=None, partition_active=False,
                 tier=None, loss=0.0, wan_loss=0.0, max_tx=8, backoff=0.0,
                 src_rows=None, slot_of=None, shops=None, lo=0):
    """One gossip delivery for every receiver, then the epilogue.

    rows [n, R] int32 packed keys; tx, msgs [n] int32; senders [K, N]
    int32 receiver->sender maps; hops / next_send [n] int32 or None;
    region / partition_id / tier [N] int32 or None; loss_u / wan_u
    [N, K] float32 draws or None (no loss / not the WAN topology); sev
    [B, B] bool one-way severance or None (symmetric).  ``wan_u`` needs
    ``region``.

    The receivers are the window ``[lo, lo + n)`` of the N nodes (all of
    them by default, n = N).  A sender's row comes from ``rows`` (then
    n = N); or, with ``slot_of`` [N] int32, from row ``slot_of[s]`` of
    ``src_rows`` [Q, R], absent (an inactive sender) where it is -1
    (the sharded fabrics' delivery; a present sender's hop candidate is
    0); or, with ``shops`` [N] int32 (``sender_hops`` of every sender),
    from row s of the gathered ``src_rows`` [N, R], absent where
    ``shops`` is ``HOP_UNSET`` (the epidemic's window).  A source takes
    the receivers' hops and next_send, the loss draws and the
    partition, not the topologies' ``wan_u`` / ``tier``.

    Returns (rows, tx, msgs, hops, next_send) as new tensors; hops and
    next_send are None when not given."""
    if wan_u is not None and region is None:
        raise ValueError("deliver_perm: wan_u needs region")
    k, n_global = senders.shape
    n, r = rows.shape
    if (src_rows is None) != (slot_of is None and shops is None):
        raise ValueError("deliver_perm: src_rows comes with slot_of or "
                         "shops")
    if slot_of is not None and shops is not None:
        raise ValueError("deliver_perm: a source takes slot_of or shops, "
                         "not both")
    if src_rows is None and (lo or n != n_global):
        raise ValueError("deliver_perm: a receiver window needs src_rows")
    if src_rows is not None and (wan_u is not None or tier is not None):
        raise ValueError("deliver_perm: a source takes no topology "
                         "(wan_u, tier)")
    if not 0 <= lo <= n_global - n:
        raise ValueError(f"deliver_perm: receivers {lo}..{lo + n} outside "
                         f"{n_global}")
    args = dict(hops=hops, next_send=next_send, tick=tick, loss_u=loss_u,
                wan_u=wan_u, region=region, partition_id=partition_id,
                sev=sev, partition_active=partition_active, tier=tier,
                loss=loss, wan_loss=wan_loss, max_tx=max_tx, backoff=backoff,
                src_rows=src_rows, slot_of=slot_of, lo=lo)
    if kernels.on_cpu(rows, tx, msgs, senders, hops, next_send, loss_u,
                      wan_u, region, partition_id, sev, tier, src_rows,
                      slot_of, shops):
        return deliver_perm_plain(rows, tx, msgs, senders, shops=shops,
                                  **args)

    if shops is not None or (slot_of is not None and any(
            t is not None for t in (hops, next_send, partition_id))):
        fn = kernels.function("deliver_perm", "deliver_window_launch",
                              _WINDOW_ARGTYPES)
        args = {f: args[f] for f in (
            "hops", "next_send", "tick", "loss_u", "partition_id", "sev",
            "partition_active", "loss", "max_tx", "backoff", "src_rows",
            "slot_of", "lo")}
        out = launch_window(fn, rows, tx, msgs, senders, shops=shops, **args)
    else:
        fn = kernels.function("deliver_perm", "deliver_perm_launch",
                              _ARGTYPES)
        out = launch(fn, rows, tx, msgs, senders, **args)
    deliver_perm.launches += 1
    return out


def launch(fn, rows, tx, msgs, senders, *, hops, next_send, tick, loss_u,
           wan_u, region, partition_id, sev, partition_active, tier, loss,
           wan_loss, max_tx, backoff, src_rows, slot_of, lo):
    """``deliver_perm`` on CUDA tensors: checks them, makes the outputs
    and calls ``fn`` (the C ``deliver_perm_launch``, typed as
    ``_ARGTYPES``) on them; returns the outputs."""
    k, n_global = senders.shape
    n, r = rows.shape
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"deliver_perm: the kernel takes 1..{MAX_ROWS} "
                         f"cells per row, got {r}")
    if src_rows is not None and any(t is not None for t in (
            next_send, wan_u, partition_id, tier)):
        raise ValueError("deliver_perm: the kernel takes a source with "
                         "loss draws only")
    i32 = torch.int32
    kernels.check("deliver_perm rows", rows, i32, (n, r), align=16)
    for name, t in (("tx", tx), ("msgs", msgs), ("hops", hops),
                    ("next_send", next_send)):
        if t is not None:
            kernels.check(f"deliver_perm {name}", t, i32, (n,))
    for name, t in (("region", region), ("partition_id", partition_id),
                    ("tier", tier), ("slot_of", slot_of)):
        if t is not None:
            kernels.check(f"deliver_perm {name}", t, i32, (n_global,))
    kernels.check("deliver_perm senders", senders, i32, (k, n_global))
    for name, t in (("loss_u", loss_u), ("wan_u", wan_u)):
        if t is not None:
            kernels.check(f"deliver_perm {name}", t, torch.float32,
                          (n_global, k))
    if src_rows is not None:
        kernels.check("deliver_perm src_rows", src_rows, i32,
                      (src_rows.shape[0], r), align=16)
    sev_b = 0
    if sev is not None:
        sev_b = sev.shape[0]
        sev = sev.to(torch.uint8)
        kernels.check("deliver_perm sev", sev, torch.uint8, (sev_b, sev_b), 1)

    rows_out = torch.empty_like(rows)
    tx_out = torch.empty_like(tx)
    msgs_out = torch.empty_like(msgs)
    hops_out = None if hops is None else torch.empty_like(hops)
    next_out = None if next_send is None else torch.empty_like(next_send)
    p = kernels.ptr
    code = fn(
        p(rows), p(tx), p(msgs), p(hops), p(next_send), p(senders),
        p(loss_u), p(wan_u), p(region), p(partition_id), p(sev), sev_b,
        p(tier), p(rows_out), p(tx_out), p(msgs_out), p(hops_out),
        p(next_out), n, r, k, float(loss), float(wan_loss),
        int(bool(partition_active)), int(tick), int(max_tx), float(backoff),
        p(rows if src_rows is None else src_rows), p(slot_of), lo,
        n_global, kernels.stream(rows),
    )
    kernels.raise_on_error("deliver_perm", code)
    return rows_out, tx_out, msgs_out, hops_out, next_out


def launch_window(fn, rows, tx, msgs, senders, *, shops, hops, next_send,
                  tick, loss_u, partition_id, sev, partition_active, loss,
                  max_tx, backoff, src_rows, slot_of, lo):
    """``deliver_perm``'s window on CUDA tensors (``fn`` the C
    ``deliver_window_launch``, typed as ``_WINDOW_ARGTYPES``): checks
    them, makes the outputs and launches; returns the outputs."""
    k, n_global = senders.shape
    n, r = rows.shape
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"deliver_perm: the kernel takes 1..{MAX_ROWS} "
                         f"cells per row, got {r}")
    i32 = torch.int32
    kernels.check("deliver_perm rows", rows, i32, (n, r), align=16)
    kernels.check("deliver_perm src_rows", src_rows, i32,
                  (n_global if shops is not None else src_rows.shape[0], r),
                  align=16)
    for name, t in (("tx", tx), ("msgs", msgs), ("hops", hops),
                    ("next_send", next_send)):
        if t is not None:
            kernels.check(f"deliver_perm {name}", t, i32, (n,))
    for name, t in (("shops", shops), ("slot_of", slot_of),
                    ("partition_id", partition_id)):
        if t is not None:
            kernels.check(f"deliver_perm {name}", t, i32, (n_global,))
    kernels.check("deliver_perm senders", senders, i32, (k, n_global))
    if loss_u is not None:
        kernels.check("deliver_perm loss_u", loss_u, torch.float32,
                      (n_global, k))
    sev_b = 0
    if sev is not None:
        sev_b = sev.shape[0]
        sev = sev.to(torch.uint8)
        kernels.check("deliver_perm sev", sev, torch.uint8, (sev_b, sev_b), 1)
    rows_out = torch.empty_like(rows)
    tx_out = torch.empty_like(tx)
    msgs_out = torch.empty_like(msgs)
    hops_out = None if hops is None else torch.empty_like(hops)
    next_out = None if next_send is None else torch.empty_like(next_send)
    p = kernels.ptr
    code = fn(
        p(rows), p(tx), p(msgs), p(hops), p(next_send), p(senders),
        p(loss_u), p(partition_id), p(sev), sev_b, p(src_rows), p(shops),
        p(slot_of), p(rows_out), p(tx_out), p(msgs_out), p(hops_out), p(next_out), n, r,
        k, float(loss), int(bool(partition_active)), int(tick), int(max_tx),
        float(backoff), lo, n_global, kernels.stream(rows),
    )
    kernels.raise_on_error("deliver_perm", code)
    return rows_out, tx_out, msgs_out, hops_out, next_out


deliver_perm.launches = 0
