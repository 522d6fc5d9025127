"""The columnar CRDT winner selection's kernels (csrc/winners.cu):
``seg_cummax``, ``winners_a`` and ``winners_b``.

Replace corrosion_tpu/ops/merge.py ``_winners_jax_core`` (:609) and
``_seg_cummax_jnp`` (:599) after the two stable sorts (``seg_argsort``)
have ordered one encoded batch by pk (domain A) and by (pk, cid)
(domain B).  ``ops.merge._winners_torch_core`` launches them in the
order sort A, sort B, ``seg_cummax`` (A), ``winners_a``, ``seg_cummax``
(B), ``winners_b``.  Bound on the H100: bytes.  ``winners_b`` folds the
reference's epilogue mask (a winner survives only at its row's final
causal length) into the accept; csrc/winners.cu says why that is
exact.

``winners_a`` and ``winners_b`` write into the caller's int64 result
views (one buffer, so a batch needs one device-to-host fetch): the
caller fills ``final_cl`` with ``seed_cl``, ``clrow`` with ``BIG``,
``sent_flag`` / ``ensure`` / ``counts`` with 0 and ``winner`` with -1.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels

#: "no value" for packed LWW keys and segment seeds (ops/merge.py)
NEG_KEY = -(1 << 62)
BIG = 1 << 62
CM_TILE = 2048  # positions a seg_cummax block scans (csrc CM_TILE)

_P = ctypes.c_void_p
_CUMMAX_ARGTYPES = (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P,
                    _P, _P)
_A_ARGTYPES = (_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P, _P,
               _P)
_B_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
               ctypes.c_longlong, _P, _P, _P, _P)


def seg_cummax_plain(order, seg, values, mask=None, exclusive=True):
    """Plain PyTorch version of :func:`seg_cummax`: the gathers, the
    start flags and the reference's Hillis–Steele doubling."""
    o = order.to(torch.int64)
    s, v = seg[o], values[o]
    if mask is not None:
        v = torch.where(mask[o], v, NEG_KEY)
    n = v.shape[0]
    starts = torch.ones(n, dtype=torch.bool, device=v.device)
    starts[1:] = s[1:] != s[:-1]
    segid = torch.cumsum(starts, 0)
    out = v.clone()
    shift = 1
    while shift < n:
        same = segid[shift:] == segid[:-shift]
        out[shift:] = torch.maximum(
            out[shift:], torch.where(same, out[:-shift], NEG_KEY))
        shift <<= 1
    if not exclusive:
        return out
    prev = torch.full_like(out, NEG_KEY)
    prev[1:] = out[:-1]
    return torch.where(starts, NEG_KEY, prev)


def seg_cummax(order, seg, values, mask=None, exclusive=True):
    """[n] int64 segmented prefix max through a permutation: position
    i holds the max of ``v`` over the earlier positions of its segment
    (``exclusive``; ``NEG_KEY`` at a segment start) or up to i, where
    ``v[i] = values[order[i]]`` (``NEG_KEY`` where ``mask[order[i]]`` is
    False) and a segment starts where ``seg[order[i]]`` changes.

    order [n] int32; seg, values [m] int64; mask [m] bool or None."""
    if kernels.on_cpu(order, seg, values, mask):
        return seg_cummax_plain(order, seg, values, mask, exclusive)
    n = order.shape[0]
    kernels.check("seg_cummax order", order, torch.int32, (n,))
    kernels.check("seg_cummax seg", seg, torch.int64, align=8)
    kernels.check("seg_cummax values", values, torch.int64, align=8)
    if mask is not None:
        kernels.check("seg_cummax mask", mask, torch.bool, align=1)
    out = torch.empty(n, dtype=torch.int64, device=order.device)
    blocks = -(-n // CM_TILE)
    agg = torch.empty(blocks, dtype=torch.int64, device=order.device)
    first = torch.empty(blocks, dtype=torch.int32, device=order.device)
    pt = kernels.ptr
    fn = kernels.function("winners", "seg_cummax_launch", _CUMMAX_ARGTYPES)
    code = fn(pt(order), pt(seg), pt(values), pt(mask), n, int(exclusive),
              pt(out), pt(agg), pt(first), kernels.stream(order))
    seg_cummax.launches += 1
    kernels.raise_on_error("seg_cummax", code)
    return out


seg_cummax.launches = 0


def winners_a_plain(oA, prev, pk, cl, sent, seed_cl, final_cl, sent_flag,
                    ensure, part, counts) -> None:
    """Plain PyTorch version of :func:`winners_a` (same arguments)."""
    o = oA.to(torch.int64)
    p, c, s = pk[o], cl[o], sent[o]
    before = torch.maximum(seed_cl[p], prev)
    rise = c > before
    odd = (c & 1) == 1
    cell = ~s
    final_cl.scatter_reduce_(0, p, c, "amax")
    sent_flag.scatter_reduce_(0, p, (rise & s).to(torch.int64), "amax")
    ensure.scatter_reduce_(0, p, (cell & odd & (c == before)).to(torch.int64),
                           "amax")
    part[o] = cell & odd & (c >= before)
    counts[0] += (rise & s).sum()
    counts[1] += (rise & cell & ~odd).sum()


def winners_a(oA, prev, pk, cl, sent, seed_cl, final_cl, sent_flag, ensure,
              part, counts) -> None:
    """Domain A of the winner selection, written into the result views:
    per change (position i of the pk order ``oA``), its row-generation
    class against ``before = max(seed_cl[pk], prev[i])`` (``prev`` the
    exclusive prefix max of cl within its pk); scatter-max of cl into
    ``final_cl``, sentinel raises into ``sent_flag``, equal-generation
    live cell changes into ``ensure`` (both 0/1 int64), the LWW
    participation mask ``part`` ([n] bool, stream order, every entry
    written), sentinel raises into ``counts[0]`` and even (deleting)
    cell raises into ``counts[1]``."""
    leaves = (oA, prev, pk, cl, sent, seed_cl, final_cl, sent_flag, ensure,
              part, counts)
    if kernels.on_cpu(*leaves):
        winners_a_plain(*leaves)
        return
    n, n_pk = oA.shape[0], seed_cl.shape[0]
    i64 = torch.int64
    kernels.check("winners_a oA", oA, torch.int32, (n,))
    for name, t, shape in (("prev", prev, (n,)), ("pk", pk, (n,)),
                           ("cl", cl, (n,)), ("seed_cl", seed_cl, None),
                           ("final_cl", final_cl, (n_pk,)),
                           ("sent_flag", sent_flag, (n_pk,)),
                           ("ensure", ensure, (n_pk,)),
                           ("counts", counts, (3,))):
        kernels.check(f"winners_a {name}", t, i64, shape, align=8)
    kernels.check("winners_a sent", sent, torch.bool, (n,), align=1)
    kernels.check("winners_a part", part, torch.bool, (n,), align=1)
    pt = kernels.ptr
    fn = kernels.function("winners", "winners_a_launch", _A_ARGTYPES)
    code = fn(pt(oA), pt(prev), pt(pk), pt(cl), pt(sent), pt(seed_cl), n,
              pt(final_cl), pt(sent_flag), pt(ensure), pt(part), pt(counts),
              kernels.stream(oA))
    winners_a.launches += 1
    kernels.raise_on_error("winners_a", code)


winners_a.launches = 0


def winners_b_plain(oB, prev, pk, cid, cl, key, part, seed_key, final_cl,
                    n_cid, winner, clrow, counts) -> None:
    """Plain PyTorch version of :func:`winners_b` (same arguments)."""
    o = oB.to(torch.int64)
    p, ci, c, pt = pk[o], cid[o], cl[o], part[o]
    at_final = c == final_cl[p]
    clrow.scatter_reduce_(0, p, torch.where(at_final, o, BIG), "amin")
    cell = p * n_cid + ci.clamp(min=0)
    seed = torch.where(ci >= 0, seed_key[cell], NEG_KEY)
    accept = pt & (key[o] > torch.maximum(seed, prev))
    winner.scatter_reduce_(0, cell, torch.where(accept & at_final, o, -1),
                           "amax")
    counts[2] += accept.sum()


def winners_b(oB, prev, pk, cid, cl, key, part, seed_key, final_cl, n_cid,
              winner, clrow, counts) -> None:
    """Domain B of the winner selection, written into the result views:
    per change (position i of the (pk, cid) order ``oB``) that takes
    part, an LWW accept where its key beats ``max(seed_key[cell],
    prev[i])`` (``prev`` the exclusive prefix max of the participating
    keys within the cell), counted into ``counts[2]``; the scatter-max
    of the accepts at the row's final causal length into ``winner``
    ([n_pk * n_cid]); and the scatter-min into ``clrow`` of the stream
    index of every change at its row's final causal length."""
    leaves = (oB, prev, pk, cid, cl, key, part, seed_key, final_cl, winner,
              clrow, counts)
    if kernels.on_cpu(*leaves):
        winners_b_plain(oB, prev, pk, cid, cl, key, part, seed_key, final_cl,
                        n_cid, winner, clrow, counts)
        return
    n, n_pk = oB.shape[0], final_cl.shape[0]
    i64 = torch.int64
    kernels.check("winners_b oB", oB, torch.int32, (n,))
    for name, t, shape in (("prev", prev, (n,)), ("pk", pk, (n,)),
                           ("cid", cid, (n,)), ("cl", cl, (n,)),
                           ("key", key, (n,)),
                           ("seed_key", seed_key, (n_pk * n_cid,)),
                           ("final_cl", final_cl, (n_pk,)),
                           ("winner", winner, (n_pk * n_cid,)),
                           ("clrow", clrow, (n_pk,)),
                           ("counts", counts, (3,))):
        kernels.check(f"winners_b {name}", t, i64, shape, align=8)
    kernels.check("winners_b part", part, torch.bool, (n,), align=1)
    pt = kernels.ptr
    fn = kernels.function("winners", "winners_b_launch", _B_ARGTYPES)
    code = fn(pt(oB), pt(prev), pt(pk), pt(cid), pt(cl), pt(key), pt(part),
              pt(seed_key), pt(final_cl), n, n_cid, pt(winner), pt(clrow),
              pt(counts), kernels.stream(oB))
    winners_b.launches += 1
    kernels.raise_on_error("winners_b", code)


winners_b.launches = 0
