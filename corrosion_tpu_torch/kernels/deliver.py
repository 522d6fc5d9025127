"""``deliver_perm``: permutation-fanout delivery and the broadcast
epilogue in one pass (csrc/deliver_perm.cu).

Replaces corrosion_tpu/models/broadcast.py ``_deliver_perm`` (:327)
and the epilogue of ``broadcast_step`` (:243-280).  Bound on the H100:
bytes — the receiver's row, K randomly placed sender rows, the K
sender ids and loss draws, and the [N] state words, each moved once.
The kernel fuses the K column gathers, the validity masks, the
max-merge, the hop-min and the tx / msgs / next_send / hops update
into registers, so nothing [N, K, R]-shaped reaches memory.
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
       ctypes.c_float, ctypes.c_void_p)
)


def _active(tx, next_send, tick):
    active = tx > 0
    if next_send is not None:
        active &= next_send <= tick
    return active


def deliver_perm_plain(rows, tx, msgs, senders, *, hops=None, next_send=None,
                       tick=0, loss_u=None, wan_u=None, region=None,
                       partition_id=None, sev=None, partition_active=False,
                       tier=None, loss=0.0, wan_loss=0.0, max_tx=8,
                       backoff=0.0):
    """Plain PyTorch version of the kernel (same arguments and results
    as :func:`deliver_perm`)."""
    k = senders.shape[0]
    active = _active(tx, next_send, tick)
    unset = torch.full_like(tx, HOP_UNSET)
    if hops is not None:
        shops = torch.where(active, torch.clamp_max(hops, HOP_UNSET - 2) + 1,
                            unset)
    else:
        shops = torch.where(active, torch.zeros_like(tx), unset)
    new_rows = rows
    cand = unset
    for j in range(k):
        s = senders[j].to(torch.int64)
        sh = shops[s]
        valid = sh < HOP_UNSET
        if loss_u is not None:
            valid &= ~(loss_u[:, j] < loss)
        if wan_u is not None:
            valid &= ~((region[s] != region) & (wan_u[:, j] < wan_loss))
        if partition_id is not None and partition_active:
            # flow is sender -> receiver
            valid &= ~blocks_cross(partition_id[s], partition_id, sev)
        new_rows = merge_keys(
            new_rows, torch.where(valid[:, None], rows[s], rows)
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
            gap = gap * tier
            first = tier
        new_next = torch.where(active, tick + gap, next_send)
        new_next = torch.where(learned, tick + first, new_next).to(torch.int32)
    new_hops = None
    if hops is not None:
        new_hops = torch.where(learned, torch.minimum(hops, cand), hops)
    return new_rows, new_tx, new_msgs, new_hops, new_next


def deliver_perm(rows, tx, msgs, senders, *, hops=None, next_send=None,
                 tick=0, loss_u=None, wan_u=None, region=None,
                 partition_id=None, sev=None, partition_active=False,
                 tier=None, loss=0.0, wan_loss=0.0, max_tx=8, backoff=0.0):
    """One gossip delivery for every receiver, then the epilogue.

    rows [N, R] int32 packed keys; tx, msgs [N] int32; senders [K, N]
    int32 receiver->sender maps; hops / next_send / region /
    partition_id / tier [N] int32 or None; loss_u / wan_u [N, K] float32
    draws or None (no loss / not the WAN topology); sev [B, B] bool
    one-way severance or None (symmetric).  ``wan_u`` needs ``region``.

    Returns (rows, tx, msgs, hops, next_send) as new tensors; hops and
    next_send are None when not given."""
    if wan_u is not None and region is None:
        raise ValueError("deliver_perm: wan_u needs region")
    args = dict(hops=hops, next_send=next_send, tick=tick, loss_u=loss_u,
                wan_u=wan_u, region=region, partition_id=partition_id,
                sev=sev, partition_active=partition_active, tier=tier,
                loss=loss, wan_loss=wan_loss, max_tx=max_tx, backoff=backoff)
    if kernels.on_cpu(rows, tx, msgs, senders, hops, next_send, loss_u,
                      wan_u, region, partition_id, sev, tier):
        return deliver_perm_plain(rows, tx, msgs, senders, **args)

    n, r = rows.shape
    k = senders.shape[0]
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"deliver_perm: the kernel takes 1..{MAX_ROWS} "
                         f"cells per row, got {r}")
    i32 = torch.int32
    kernels.check("deliver_perm rows", rows, i32, (n, r), align=16)
    for name, t in (("tx", tx), ("msgs", msgs), ("hops", hops),
                    ("next_send", next_send), ("region", region),
                    ("partition_id", partition_id), ("tier", tier)):
        if t is not None:
            kernels.check(f"deliver_perm {name}", t, i32, (n,))
    kernels.check("deliver_perm senders", senders, i32, (k, n))
    for name, t in (("loss_u", loss_u), ("wan_u", wan_u)):
        if t is not None:
            kernels.check(f"deliver_perm {name}", t, torch.float32, (n, k))
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
    fn = kernels.function("deliver_perm", "deliver_perm_launch", _ARGTYPES)
    code = fn(
        p(rows), p(tx), p(msgs), p(hops), p(next_send), p(senders),
        p(loss_u), p(wan_u), p(region), p(partition_id), p(sev), sev_b,
        p(tier), p(rows_out), p(tx_out), p(msgs_out), p(hops_out),
        p(next_out), n, r, k, float(loss), float(wan_loss),
        int(bool(partition_active)), int(tick), int(max_tx), float(backoff),
        kernels.stream(rows),
    )
    deliver_perm.launches += 1
    kernels.raise_on_error("deliver_perm", code)
    return rows_out, tx_out, msgs_out, hops_out, next_out


deliver_perm.launches = 0
