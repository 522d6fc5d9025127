"""``swim_tick``: one SWIM protocol period for every node
(csrc/swim.cu: ``swim_probe_select``, ``swim_spread``, ``swim_gather``,
``swim_settle``, seven launches a tick, six without gossip targets).

Replaces corrosion_tpu/models/swim.py ``swim_step`` (:107-316) and the
per-tick detection flags of corrosion_tpu/sim/churn.py ``_scan_chunk``
(:86-90).  Bound on the H100: bytes — the three [N, N] int32 inputs
(view, suspect_since, update_tx) read once and the three outputs
written once; the N^2 tie hashes of the gossip selection come second.
The kernels order the reference's whole-matrix phases by launch
boundaries, select the freshest entries in registers in ``top_k``'s
(score, lower index) order (``MAX_ENTRIES`` a pass, as many passes as
the gossip width needs), and rebuild ``update_tx`` from the
selection without a scatter.  See the source for the design.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.threefry import threefry_bits_plain
from corrosion_tpu_torch.models.common import peers_from_offsets
from corrosion_tpu_torch.random import key_words, randint_span, split

ALIVE, SUSPECT, DOWN = 0, 1, 2
NEVER = 2**31 - 1
MAX_ENTRIES = 8  # entries one selection pass of the kernel takes

# jax.random.split(key, 11) in the reference's order (swim.py:118-119)
SPLIT_ORDER = ("probe", "loss1", "loss2", "help", "hloss", "gt", "ge",
               "gloss", "tu", "ann", "aloss")
# rand_peers draws (randint under split(k): two keys each), then the
# uniforms, as the kernel's key table lays them out (csrc/swim.cu)
PEER_KEYS = ("probe", "help", "gt", "ann")
UNIFORM_KEYS = ("loss1", "loss2", "hloss", "ge", "gloss", "tu", "aloss")
GOSSIP, PING, ACK = range(3)  # swim_spread's passes

_ARGTYPES = (
    (ctypes.c_void_p,) * 19
    + (ctypes.c_int,) * 8
    + (ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
       ctypes.POINTER(ctypes.c_uint), ctypes.c_int, ctypes.c_void_p)
)


def tick_keys(key) -> dict:
    """{name: key words} of one tick key: each uniform's key, and for
    each peer draw the words of its ``split`` pair."""
    keys = dict(zip(SPLIT_ORDER, split(key, len(SPLIT_ORDER))))
    out = {name: key_words(keys[name]) for name in UNIFORM_KEYS}
    for name in PEER_KEYS:
        out[name] = tuple(key_words(k) for k in split(keys[name]))
    return out


def _key_table(keys: dict):
    words = []
    for name in PEER_KEYS:
        (h0, h1), (l0, l1) = keys[name]
        words += [h0, h1, l0, l1]
    for name in UNIFORM_KEYS:
        words += list(keys[name])
    return (ctypes.c_uint * len(words))(*words)


def swim_tick_plain(view, suspect_since, incarnation, msgs, update_tx, keys,
                    tick: int, params, alive, revived=None, victim=None,
                    flags=None):
    """Plain PyTorch version of :func:`swim_tick`: the reference's
    phases on whole tensors (``top_k`` as a stable ascending sort)."""
    n = view.shape[0]
    dev = view.device
    p = params
    span, mult = randint_span(1, max(n, 2))
    rows = torch.arange(n, device=dev)
    i32 = torch.int32

    def peers(name, shape):
        offs = torch.empty(shape, dtype=i32, device=dev)
        hi, lo = keys[name]
        threefry_bits_plain(offs, hi, lo, span=span, mult=mult, minval=1)
        return peers_from_offsets(offs, n).to(torch.int64)

    def lossy(name, shape):
        if p.loss > 0.0:
            u = torch.empty(shape, dtype=torch.float32, device=dev)
            return threefry_bits_plain(u, keys[name]) >= p.loss
        return torch.ones(shape, dtype=torch.bool, device=dev)

    def scatter_max(v, idx, src):
        out = v.reshape(-1).clone()
        out.scatter_reduce_(0, idx, src, "amax")
        return out.reshape(n, n)

    view_in = view
    inc = incarnation
    view = view.clone()

    # rejoin announce (:128-155)
    if revived is not None:
        seed = peers("ann", (n,))
        diag = view[rows, rows]
        inc = torch.where(revived, torch.maximum(inc, diag // 4) + 1, inc)
        rec = inc * 4 + ALIVE
        view[rows, rows] = torch.where(revived, rec, diag)
        ann_ok = (revived & alive & alive[seed]
                  & lossy("aloss", (n, 2)).all(dim=1))
        view = scatter_max(view, seed * n + rows,
                           torch.where(ann_ok, rec, 0))
        msgs = msgs + revived.to(i32)
        msgs = msgs.index_add(0, seed, ann_ok.to(i32))

    # direct probe (:157-164)
    target = peers("probe", (n,))
    ping_ok = alive & lossy("loss1", (n,)) & alive[target]
    ack_ok = ping_ok & lossy("loss2", (n,))
    msgs = msgs + alive.to(i32)
    msgs = msgs.index_add(0, target, ping_ok.to(i32))

    # indirect probes (:166-185)
    h = p.num_indirect_probes
    helpers = peers("help", (n, h))
    legs = lossy("hloss", (n, h, 4))
    # [N, 1], as in the reference: the client pays ONE message for its
    # ping-reqs, each live helper one for its ping
    tried = ((~ack_ok) & alive)[:, None]
    indirect_ok = (tried & alive[helpers] & alive[target][:, None]
                   & legs.all(dim=2))
    msgs = msgs + tried.sum(dim=1, dtype=i32)
    msgs = msgs.index_add(0, helpers.reshape(-1),
                          (tried & alive[helpers]).reshape(-1).to(i32))
    msgs = msgs.index_add(0, target, indirect_ok.sum(dim=1, dtype=i32))
    probe_ok = ack_ok | indirect_ok.any(dim=1)

    # the probe outcome (:187-197)
    alive_key_t = inc[target] * 4 + ALIVE
    cur = view[rows, target]
    upd = torch.where(probe_ok & alive, torch.maximum(cur, alive_key_t), cur)
    fail = (~probe_ok) & alive
    suspected = (cur // 4) * 4 + SUSPECT
    upd = torch.where(fail & (cur % 4 == ALIVE),
                      torch.maximum(cur, suspected), upd)
    view[rows, target] = upd

    # suspicion timeout (:199-202)
    expired = (view % 4 == SUSPECT) & (tick - suspect_since
                                       >= p.suspect_timeout)
    view = torch.where(expired, (view // 4) * 4 + DOWN, view)

    # gossip (:204-240)
    g = p.gossip_targets
    m = min(p.gossip_entries, n)
    gt = peers("gt", (n, g))
    tie = torch.empty((n, n), dtype=torch.float32, device=dev)
    threefry_bits_plain(tie, keys["ge"])
    scores = update_tx.to(torch.float32) + tie
    scores = torch.where(update_tx >= p.update_tx_limit, torch.inf, scores)
    ge = torch.sort(scores, dim=1, stable=True).indices[:, :m]  # [N, M]
    sendable = update_tx.gather(1, ge) < p.update_tx_limit
    ok = (alive[:, None, None] & lossy("gloss", (n, g, m))
          & alive[gt][:, :, None] & sendable[:, None, :])
    payload = view.gather(1, ge)[:, None, :].expand(n, g, m)
    dest = gt[:, :, None] * n + ge[:, None, :]
    view = scatter_max(view, dest[ok], payload[ok])
    msgs = msgs + alive.to(i32) * g
    charged = (sendable & alive[:, None]).to(i32)
    update_tx = update_tx.scatter_add(1, ge, charged)

    # probe / ack piggyback (:242-275)
    mask = ping_ok[:, None] & sendable
    view = scatter_max(view, (target[:, None] * n + ge)[mask],
                       view.gather(1, ge)[mask])
    update_tx = update_tx.scatter_add(1, ge, charged)
    ge_t, sendable_t = ge[target], sendable[target]
    mask = ack_ok[:, None] & sendable_t
    ack_payload = view[target[:, None], ge_t]
    view = scatter_max(view, (rows[:, None] * n + ge_t)[mask],
                       ack_payload[mask])
    update_tx = update_tx.reshape(-1).index_add(
        0, (target[:, None] * n + ge_t).reshape(-1),
        (ping_ok[:, None] & sendable_t).reshape(-1).to(i32),
    ).reshape(n, n)

    # refutation / renewal (:277-304)
    self_key = view[rows, rows]
    peer_rec = view[target, rows]
    told_undead = (alive & alive[target] & (peer_rec % 4 == DOWN)
                   & lossy("tu", (n, 2)).all(dim=1))
    offending = torch.maximum(self_key,
                              torch.where(told_undead, peer_rec, 0))
    offended = alive & ((self_key % 4 != ALIVE) | told_undead)
    new_inc = torch.where(offended, offending // 4 + 1,
                          torch.maximum(inc, self_key // 4))
    inc = torch.maximum(inc, new_inc)
    view[rows, rows] = torch.where(alive, inc * 4 + ALIVE, self_key)

    # suspect_since, backlog reset (:306-314)
    now_suspect = view % 4 == SUSPECT
    ss = torch.where(now_suspect & (suspect_since == NEVER), tick,
                     suspect_since)
    ss = torch.where(now_suspect, ss, NEVER)
    update_tx = torch.where(view != view_in, 0, update_tx)

    if flags is not None:
        col = view[:, victim] % 4
        others = rows != victim
        flags[0] += ((col == DOWN) & others).sum().to(i32)
        flags[1] += ((col == ALIVE) & others).sum().to(i32)
    return view, ss.to(i32), inc, msgs, update_tx


class Launch(NamedTuple):
    """One tick's launch: ``swim_launch``'s arguments up to the phase,
    the stream, the outputs (view, suspect_since, incarnation, msgs,
    update_tx) and the kernels' work buffers by name."""

    args: list
    stream: ctypes.c_void_p
    out: list
    work: dict


def prepare(view, suspect_since, incarnation, msgs, update_tx, keys,
            tick: int, params, alive, revived=None, victim=None,
            flags=None) -> Launch:
    """Check a tick's CUDA inputs (as :func:`swim_tick` takes them, with
    the ``tick_keys`` of its key) and allocate its outputs and work
    buffers."""
    n = view.shape[0]
    p = params
    m = min(p.gossip_entries, n)
    if n < 2 or m < 1 or tick < 0:
        raise ValueError("swim_tick: the kernels take N >= 2, at least "
                         "one gossip entry and tick >= 0")
    i32, u8 = torch.int32, torch.uint8
    for name, t in (("view", view), ("suspect_since", suspect_since),
                    ("update_tx", update_tx)):
        kernels.check(f"swim_tick {name}", t, i32, (n, n))
    for name, t in (("incarnation", incarnation), ("msgs", msgs)):
        kernels.check(f"swim_tick {name}", t, i32, (n,))
    kernels.check("swim_tick alive", alive, torch.bool, (n,), align=1)
    if revived is not None:
        kernels.check("swim_tick revived", revived, torch.bool, (n,), 1)
    if flags is not None:
        kernels.check("swim_tick flags", flags, i32, (2,))
    dev = view.device
    out = [torch.empty_like(view), torch.empty_like(suspect_since),
           torch.empty_like(incarnation), msgs.clone(),
           torch.empty_like(update_tx)]
    work = {"target": torch.empty((n,), dtype=i32, device=dev),
            "inc1": torch.empty((n,), dtype=i32, device=dev),
            "probe": torch.empty((n,), dtype=u8, device=dev),
            "pinged": torch.zeros((n,), dtype=i32, device=dev),
            "ge": torch.empty((n, m), dtype=i32, device=dev),
            "sendable": torch.empty((n, m), dtype=u8, device=dev),
            "pay": torch.empty((n, m), dtype=i32, device=dev)}
    span, mult = randint_span(1, max(n, 2))
    pt = kernels.ptr
    args = ([pt(t) for t in (view, suspect_since, incarnation, update_tx,
                             alive, revived)]
            + [pt(t) for t in out] + [pt(t) for t in work.values()]
            + [pt(flags)]
            + [n, p.num_indirect_probes, p.gossip_targets, m,
               p.suspect_timeout, p.update_tx_limit, int(tick),
               -1 if victim is None else int(victim), p.loss, span, mult,
               _key_table(keys)])
    return Launch(args, kernels.stream(view), out, work)


def _call(launch: Launch, phase: int) -> int:
    fn = kernels.function("swim", "swim_launch", _ARGTYPES)
    return fn(*launch.args, phase, launch.stream)


def swim_probe_select(launch: Launch) -> None:
    """Announces, probes, msgs, row patch, suspicion timeout and the
    freshness selection with its payload."""
    code = _call(launch, 0)
    swim_probe_select.launches += 1
    kernels.raise_on_error("swim_probe_select", code)


def swim_spread(launch: Launch, mode: int) -> None:
    """One scatter-max pass of the payload: ``GOSSIP`` to the gossip
    targets (needs gossip targets), ``PING`` to the probe target,
    ``ACK`` back to the prober."""
    code = _call(launch, (1, 3, 4)[mode])
    swim_spread.launches += 1
    kernels.raise_on_error("swim_spread", code)


def swim_gather(launch: Launch) -> None:
    """Re-read every row's selected entries into the payload."""
    code = _call(launch, 2)
    swim_gather.launches += 1
    kernels.raise_on_error("swim_gather", code)


def swim_settle(launch: Launch) -> None:
    """Refutation, suspect_since, the backlog and the churn flags."""
    code = _call(launch, 5)
    swim_settle.launches += 1
    kernels.raise_on_error("swim_settle", code)


def launch_order(gossip_targets: int) -> tuple:
    """A tick's launches in order, as (wrapper, extra arguments); the
    gossip pass only with gossip targets."""
    gossip = ((swim_spread, (GOSSIP,)),) if gossip_targets > 0 else ()
    return ((swim_probe_select, ()), *gossip, (swim_gather, ()),
            (swim_spread, (PING,)), (swim_gather, ()), (swim_spread, (ACK,)),
            (swim_settle, ()))


def swim_tick(view, suspect_since, incarnation, msgs, update_tx, key,
              tick: int, params, alive, revived=None, victim=None,
              flags=None):
    """One protocol period under tick key ``key`` (uint32[2]).

    view / suspect_since / update_tx [N, N] int32, incarnation / msgs
    [N] int32, alive / revived [N] bool (revived None: nobody comes
    back).  ``params`` carries ``SwimParams``' fields; the card takes
    any gossip width, ``MAX_ENTRIES`` entries a selection pass.  When
    ``flags`` ([2] int32) is given, adds the count of nodes other than
    ``victim`` whose record of it is DOWN, then ALIVE.  Returns (view,
    suspect_since, incarnation, msgs, update_tx) as new tensors."""
    n = view.shape[0]
    if flags is not None and not 0 <= victim < n:
        raise ValueError("swim_tick: flags need a victim in 0..N-1")
    keys = tick_keys(key)
    if kernels.on_cpu(view, suspect_since, incarnation, msgs, update_tx,
                      alive, revived, flags):
        return swim_tick_plain(view, suspect_since, incarnation, msgs,
                               update_tx, keys, tick, params, alive, revived,
                               victim, flags)
    launch = prepare(view, suspect_since, incarnation, msgs, update_tx, keys,
                     tick, params, alive, revived, victim, flags)
    for wrapper, extra in launch_order(params.gossip_targets):
        wrapper(launch, *extra)
    return tuple(launch.out)


swim_probe_select.launches = 0
swim_spread.launches = 0
swim_gather.launches = 0
swim_settle.launches = 0
