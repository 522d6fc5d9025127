"""``swim_tick``: one SWIM protocol period for every node
(csrc/swim.cu: ``swim_probe_select``, ``swim_disseminate``,
``swim_settle``, three host calls a tick).

Replaces corrosion_tpu/models/swim.py ``swim_step`` (:107-316) and the
per-tick detection flags of corrosion_tpu/sim/churn.py ``_scan_chunk``
(:86-90).  Bound on the H100: bytes — the three [N, N] int32 inputs
(view, suspect_since, update_tx) read once and the three outputs
written once; the N^2 tie hashes of the gossip selection come second.
The kernels order the reference's whole-matrix phases by kernel
boundaries, select the freshest entries in registers in ``top_k``'s
(score, lower index) order (``MAX_ENTRIES`` a pass, as many passes as
the gossip width needs), run the dissemination's passes as kernels
chained by programmatic dependent launch from one host call, and
rebuild ``update_tx`` from the selection without a scatter.  See the
source for the design.

``swim_tick_window`` is the same tick on one shard's window of viewer
rows ``[lo, lo + n)`` of the [N, N] leaves (``models/sharded.py``
``sharded_swim_step``, the twin of the reference's ``swim_step`` under
``swim_shardings``): a generator that yields its exchanges between the
shards (``mesh.py``).  The draws and the [N]- and [N, M]-sized work
(targets, legs, messages, each row's selection) are replicated or
gathered; the view's four cross-row steps (the rejoin announce, the
gossip, the ping and the ack piggyback) each follow an exchange, and
the refutation reads each prober's record at its target through one
more.  Five host calls a tick (``swim_window_launch``'s phases).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.threefry import threefry_bits_plain
from corrosion_tpu_torch.mesh import all_gather, all_reduce
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
# swim_launch's phases
SELECT, DISSEMINATE, DISSEMINATE_NO_GOSSIP, SETTLE = range(4)
# swim_window_launch's phases (the window form, one host call each)
(W_SELECT, W_GOSSIP, W_COLLECT, W_PING, W_ACK, W_SETTLE) = range(6)
PING_OK, ACK_OK = 1, 2  # the probe flags' bits

_ARGTYPES = (
    (ctypes.c_void_p,) * 20
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


def rand_peers(keys, name: str, shape, n: int, dev) -> torch.Tensor:
    """The reference's rand_peers draw under ``keys[name]`` (int64 peer
    ids)."""
    span, mult = randint_span(1, max(n, 2))
    offs = torch.empty(shape, dtype=torch.int32, device=dev)
    hi, lo = keys[name]
    threefry_bits_plain(offs, hi, lo, span=span, mult=mult, minval=1)
    return peers_from_offsets(offs, n).to(torch.int64)


def surviving_legs(keys, name: str, shape, loss: float,
                   dev) -> torch.Tensor:
    """lossy(): the legs that survive (all when ``loss`` is 0, with no
    draw, as in the reference)."""
    if loss > 0.0:
        u = torch.empty(shape, dtype=torch.float32, device=dev)
        return threefry_bits_plain(u, keys[name]) >= loss
    return torch.ones(shape, dtype=torch.bool, device=dev)


def _scatter_max(view, idx, src):
    out = view.reshape(-1).clone()
    out.scatter_reduce_(0, idx, src, "amax")
    return out.reshape(view.shape)


def swim_disseminate_plain(view, ge, sendable, target, ping_ok, ack_ok,
                           alive, keys, params):
    """Plain PyTorch version of :func:`swim_disseminate` (:204-275, the
    view's part): the gossip pass into each gossip target's row (with
    gossip targets), the ping piggyback into the probe target's row and
    the ack piggyback back into the prober's, each pass sending what the
    view held when it began.  ``ge`` / ``sendable`` [N, M] are the
    selection, ``target`` the probe targets, ``ping_ok`` / ``ack_ok``
    [N] the legs that came through; returns the new view."""
    n, m = ge.shape
    dev = view.device
    g = params.gossip_targets
    if g > 0:
        gt = rand_peers(keys, "gt", (n, g), n, dev)
        ok = (alive[:, None, None]
              & surviving_legs(keys, "gloss", (n, g, m), params.loss, dev)
              & alive[gt][:, :, None] & sendable[:, None, :])
        payload = view.gather(1, ge)[:, None, :].expand(n, g, m)
        dest = gt[:, :, None] * n + ge[:, None, :]
        view = _scatter_max(view, dest[ok], payload[ok])
    mask = ping_ok[:, None] & sendable
    view = _scatter_max(view, (target[:, None] * n + ge)[mask],
                        view.gather(1, ge)[mask])
    rows = torch.arange(n, device=dev)
    ge_t = ge[target]
    mask = ack_ok[:, None] & sendable[target]
    return _scatter_max(view, (rows[:, None] * n + ge_t)[mask],
                        view[target[:, None], ge_t][mask])


def swim_tick_plain(view, suspect_since, incarnation, msgs, update_tx, keys,
                    tick: int, params, alive, revived=None, victim=None,
                    flags=None):
    """Plain PyTorch version of :func:`swim_tick`: the reference's
    phases on whole tensors (``top_k`` as a stable ascending sort)."""
    n = view.shape[0]
    dev = view.device
    p = params
    rows = torch.arange(n, device=dev)
    i32 = torch.int32

    def peers(name, shape):
        return rand_peers(keys, name, shape, n, dev)

    def lossy(name, shape):
        return surviving_legs(keys, name, shape, p.loss, dev)

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
        view = _scatter_max(view, seed * n + rows,
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

    # the freshness selection (:204-225), then the three passes and
    # their backlog charges (:226-275)
    g = p.gossip_targets
    m = min(p.gossip_entries, n)
    tie = torch.empty((n, n), dtype=torch.float32, device=dev)
    threefry_bits_plain(tie, keys["ge"])
    scores = update_tx.to(torch.float32) + tie
    scores = torch.where(update_tx >= p.update_tx_limit, torch.inf, scores)
    ge = torch.sort(scores, dim=1, stable=True).indices[:, :m]  # [N, M]
    sendable = update_tx.gather(1, ge) < p.update_tx_limit
    view = swim_disseminate_plain(view, ge, sendable, target, ping_ok, ack_ok,
                                  alive, keys, p)
    msgs = msgs + alive.to(i32) * g
    # a gossip and a ping round for each sendable entry of a live node,
    # an ack round for each prober whose ping reached it
    charged = (sendable & alive[:, None]).to(i32)
    update_tx = update_tx.scatter_add(1, ge, 2 * charged)
    ge_t, sendable_t = ge[target], sendable[target]
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
    # pinged and the dissemination's shadow, zeroed by one fill
    zeroed = torch.zeros((n + n * m,), dtype=i32, device=dev)
    out = [torch.empty_like(view), torch.empty_like(suspect_since),
           torch.empty_like(incarnation), msgs.clone(),
           torch.empty_like(update_tx)]
    work = {"target": torch.empty((n,), dtype=i32, device=dev),
            "inc1": torch.empty((n,), dtype=i32, device=dev),
            "probe": torch.empty((n,), dtype=u8, device=dev),
            "pinged": zeroed[:n],
            "ge": torch.empty((n, m), dtype=i32, device=dev),
            "sendable": torch.empty((n, m), dtype=u8, device=dev),
            "pay": torch.empty((n, m), dtype=i32, device=dev),
            "ack_pay": zeroed[n:].view(n, m)}
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
    code = _call(launch, SELECT)
    swim_probe_select.launches += 1
    kernels.raise_on_error("swim_probe_select", code)


def swim_disseminate(launch: Launch, gossip: bool) -> None:
    """The gossip pass to the gossip targets (``gossip``: needs gossip
    targets), then the ping piggyback to the probe target and the ack
    piggyback back to the prober, each pass sending what the view held
    when it began: two kernels from one host call, counted as one
    launch."""
    code = _call(launch, DISSEMINATE if gossip else DISSEMINATE_NO_GOSSIP)
    swim_disseminate.launches += 1
    kernels.raise_on_error("swim_disseminate", code)


def swim_settle(launch: Launch) -> None:
    """Refutation, suspect_since, the backlog and the churn flags."""
    code = _call(launch, SETTLE)
    swim_settle.launches += 1
    kernels.raise_on_error("swim_settle", code)


def launch_order(gossip_targets: int) -> tuple:
    """A tick's host calls in order, as (wrapper, extra arguments); the
    gossip pass only with gossip targets."""
    return ((swim_probe_select, ()), (swim_disseminate, (gossip_targets > 0,)),
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
swim_disseminate.launches = 0
swim_settle.launches = 0


# -- the window form: one shard's viewer rows [lo, lo + n) of the tick


def swim_select_window_plain(view, suspect_since, update_tx, incd, keys,
                             tick: int, params, alive, revived, lo: int):
    """Plain PyTorch version of ``swim_probe_select``'s window (the
    reference's :128-225 for my rows; the draws, legs and message
    charges of all N nodes).  ``incd`` [2, N]: every node's incarnation
    and own record (the gathered diagonal) at the tick's start.
    Returns {view, target, inc1, probe, ge, sendable, pay} of my rows
    and ``counts`` [2, N] int32: the messages my nodes sent and caused
    this tick by the node charged, then my probers whose ping reached
    each node (summed over the shards: every node's)."""
    nl, n = view.shape
    dev = view.device
    p = params
    i32 = torch.int32
    g_rows = torch.arange(lo, lo + nl, device=dev)
    l_rows = torch.arange(nl, device=dev)
    inc_all, diag_all = incd[0], incd[1]

    def peers(name, shape):
        return rand_peers(keys, name, shape, n, dev)

    def lossy(name, shape):
        return surviving_legs(keys, name, shape, p.loss, dev)

    view = view.clone()
    # the messages my rows' nodes send and cause, wherever they land
    # (the exchange sums every shard's)
    mine = torch.zeros(n, dtype=torch.bool, device=dev)
    mine[g_rows] = True
    msgs = torch.zeros(n, dtype=i32, device=dev)
    inc1 = inc_all
    # rejoin announce (:128-155): each announce a function of the
    # gathered incarnations and records, landing where its seed is mine
    if revived is not None:
        seed = peers("ann", (n,))
        inc1 = torch.where(revived, torch.maximum(inc_all, diag_all // 4) + 1,
                           inc_all)
        rec = inc1 * 4 + ALIVE
        view[l_rows, g_rows] = torch.where(revived, rec, diag_all)[g_rows]
        ann_ok = (revived & alive & alive[seed]
                  & lossy("aloss", (n, 2)).all(dim=1))
        land = (seed >= lo) & (seed < lo + nl)
        cols = torch.arange(n, device=dev)
        view = _scatter_max(view, ((seed - lo) * n + cols)[land],
                            torch.where(ann_ok, rec, 0)[land])
        msgs = msgs + (revived & mine).to(i32)
        msgs = msgs.index_add(0, seed, (ann_ok & mine).to(i32))

    # direct and indirect probes (:157-185), every node's
    target = peers("probe", (n,))
    ping_ok = alive & lossy("loss1", (n,)) & alive[target]
    ack_ok = ping_ok & lossy("loss2", (n,))
    msgs = msgs + (alive & mine).to(i32)
    msgs = msgs.index_add(0, target, (ping_ok & mine).to(i32))
    h = p.num_indirect_probes
    helpers = peers("help", (n, h))
    legs = lossy("hloss", (n, h, 4))
    tried = ((~ack_ok) & alive)[:, None]
    indirect_ok = (tried & alive[helpers] & alive[target][:, None]
                   & legs.all(dim=2))
    msgs = msgs + (tried & mine[:, None]).sum(dim=1, dtype=i32)
    msgs = msgs.index_add(0, helpers.reshape(-1),
                          (tried & alive[helpers] & mine[:, None]).reshape(-1)
                          .to(i32))
    msgs = msgs.index_add(0, target, (indirect_ok & mine[:, None]).sum(
        dim=1, dtype=i32))
    msgs = msgs + (alive & mine).to(i32) * p.gossip_targets  # gossip (:235)
    pinged = torch.zeros(n, dtype=i32, device=dev).index_add(
        0, target, (ping_ok & mine).to(i32))
    probe_ok = ack_ok | indirect_ok.any(dim=1)

    # the probe outcome on my rows (:187-197), suspicion timeout
    t_l = target[g_rows]
    cur = view[l_rows, t_l]
    mine_ok, mine_alive = probe_ok[g_rows], alive[g_rows]
    upd = torch.where(mine_ok & mine_alive,
                      torch.maximum(cur, inc1[t_l] * 4 + ALIVE), cur)
    upd = torch.where((~mine_ok) & mine_alive & (cur % 4 == ALIVE),
                      torch.maximum(cur, (cur // 4) * 4 + SUSPECT), upd)
    view[l_rows, t_l] = upd
    expired = (view % 4 == SUSPECT) & (tick - suspect_since
                                       >= p.suspect_timeout)
    view = torch.where(expired, (view // 4) * 4 + DOWN, view)

    # the freshness selection (:204-225) of my rows
    m = min(p.gossip_entries, n)
    tie = torch.empty((n, n), dtype=torch.float32, device=dev)
    tie = threefry_bits_plain(tie, keys["ge"])[lo:lo + nl]
    scores = update_tx.to(torch.float32) + tie
    scores = torch.where(update_tx >= p.update_tx_limit, torch.inf, scores)
    ge = torch.sort(scores, dim=1, stable=True).indices[:, :m]
    probe = (ping_ok.to(torch.uint8) * PING_OK
             | ack_ok.to(torch.uint8) * ACK_OK)
    return dict(
        view=view, target=t_l.to(i32), inc1=inc1[g_rows].to(i32),
        probe=probe[g_rows], ge=ge.to(i32),
        sendable=(update_tx.gather(1, ge) < p.update_tx_limit).to(
            torch.uint8),
        pay=view.gather(1, ge), counts=torch.stack([msgs, pinged]))


def swim_gossip_window_plain(view, ge, sendable, pay, keys, params, alive,
                             lo: int, gossip: bool):
    """Plain PyTorch version of the gossip pass's window (:226-235):
    every node's selected entries (``ge`` / ``sendable`` / ``pay`` [N,
    M], gathered) scattered into the gossip targets' rows that are mine.
    Returns (view, my rows' selected cells after the pass, [n, M])."""
    nl, n = view.shape
    m = ge.shape[1]
    dev = view.device
    ge64 = ge.to(torch.int64)
    if gossip:
        g = params.gossip_targets
        gt = rand_peers(keys, "gt", (n, g), n, dev)
        dest = gt[:, :, None].expand(n, g, m)
        ok = (alive[:, None, None]
              & surviving_legs(keys, "gloss", (n, g, m), params.loss, dev)
              & alive[gt][:, :, None] & sendable.bool()[:, None, :]
              & (dest >= lo) & (dest < lo + nl))
        idx = (dest - lo) * n + ge64[:, None, :]
        view = _scatter_max(view, idx[ok],
                            pay[:, None, :].expand(n, g, m)[ok])
    return view, view.gather(1, ge64[lo:lo + nl])


def swim_ping_window_plain(view, ge, sendable, target, probe, sent, lo: int):
    """Plain PyTorch version of the ping piggyback's window (:245-259):
    each prober whose ping got through sends its sendable entries as the
    gossip pass left them (``sent`` [N, M], gathered) into its target's
    row where that row is mine.  Returns (view, my rows' selected cells
    after the pass)."""
    nl, n = view.shape
    t = target.to(torch.int64)
    ge64 = ge.to(torch.int64)
    mask = (((probe & PING_OK) != 0) & (t >= lo) & (t < lo + nl))[:, None] \
        & sendable.bool()
    view = _scatter_max(view, ((t[:, None] - lo) * n + ge64)[mask],
                        sent[mask])
    return view, view.gather(1, ge64[lo:lo + nl])


def swim_ack_window_plain(view, ge, sendable, target, probe, sent, lo: int):
    """Plain PyTorch version of the ack piggyback's window (:260-275): my
    probers whose ack came back take their target's sendable entries as
    the ping pass left them (``sent`` [N, M], gathered).  Returns (view,
    ``peer_rec`` [N] int32: each prober's record at its target where the
    target is mine, 0 elsewhere, for the refutation's exchange)."""
    nl, n = view.shape
    dev = view.device
    g_rows = torch.arange(lo, lo + nl, device=dev)
    tt = target.to(torch.int64)
    t = tt[g_rows]
    ge64 = ge.to(torch.int64)
    mask = ((probe[g_rows] & ACK_OK) != 0)[:, None] & sendable.bool()[t]
    idx = torch.arange(nl, device=dev)[:, None] * n + ge64[t]
    view = _scatter_max(view, idx[mask], sent[t][mask])
    mine = (tt >= lo) & (tt < lo + nl)
    peer_rec = torch.zeros(n, dtype=torch.int32, device=dev)
    peer_rec[mine] = view[(tt - lo)[mine],
                          torch.arange(n, device=dev)[mine]]
    return view, peer_rec


def swim_settle_window_plain(view, view_in, suspect_since, update_tx, ge,
                             sendable, target, inc1, counts, peer_rec, keys,
                             tick: int, params, alive, lo: int, victim=None,
                             flagged: bool = False):
    """Plain PyTorch version of ``swim_settle``'s window (:277-314; the
    churn flags of ``sim/churn.py`` :86-90): ``peer_rec`` [N] the summed
    exchange, ``counts`` [2, N] the summed messages and pings.  Returns
    (view, suspect_since, incarnation, update_tx) of my rows and, when
    ``flagged``, my rows' [2] counts of the victim DOWN / ALIVE."""
    nl, n = view.shape
    dev = view.device
    i32 = torch.int32
    g_rows = torch.arange(lo, lo + nl, device=dev)
    l_rows = torch.arange(nl, device=dev)
    t = target.to(torch.int64)[g_rows]
    al = alive[g_rows]
    self_key = view[l_rows, g_rows]
    rec = peer_rec[g_rows]
    told = (al & alive[t] & (rec % 4 == DOWN)
            & surviving_legs(keys, "tu", (n, 2), params.loss,
                             dev).all(dim=1)[g_rows])
    offending = torch.maximum(self_key, torch.where(told, rec, 0))
    offended = al & ((self_key % 4 != ALIVE) | told)
    new_inc = torch.where(offended, offending // 4 + 1,
                          torch.maximum(inc1, self_key // 4))
    inc = torch.maximum(inc1, new_inc)
    view = view.clone()
    view[l_rows, g_rows] = torch.where(al, inc * 4 + ALIVE, self_key)
    now_suspect = view % 4 == SUSPECT
    ss = torch.where(now_suspect & (suspect_since == NEVER), tick,
                     suspect_since)
    ss = torch.where(now_suspect, ss, NEVER).to(i32)
    # a gossip and a ping round for each sendable entry of a live node,
    # an ack round for each prober whose ping reached it
    charge = ((2 * al.to(i32) + counts[1][g_rows])[:, None]
              * sendable[g_rows].to(i32))
    tx = update_tx.scatter_add(1, ge[g_rows].to(torch.int64), charge)
    tx = torch.where(view != view_in, 0, tx)
    flags = None
    if flagged:
        col = view[:, victim] % 4
        others = g_rows != victim
        flags = torch.stack([((col == DOWN) & others).sum(),
                             ((col == ALIVE) & others).sum()]).to(i32)
    return view, ss, inc.to(i32), tx, flags


_WINDOW_ARGTYPES = (
    (ctypes.c_void_p,) * 23
    + (ctypes.c_int,) * 10
    + (ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
       ctypes.POINTER(ctypes.c_uint), ctypes.c_int, ctypes.c_void_p)
)
# swim_window_launch's pointer arguments, in order
_WINDOW_POINTERS = (
    "view_in", "ss_in", "inc_in", "diag_in", "tx_in", "alive", "revived",
    "view", "ss", "inc", "msgs", "pinged", "tx", "target", "inc1", "probe",
    "ge", "sendable", "pay", "sent", "sent_out", "peer_rec", "flags")


class WindowCall:
    """One window tick's launches on CUDA tensors: the scalar arguments
    (checked once), and each phase's pointers by name."""

    def __init__(self, view, suspect_since, update_tx, keys, tick: int,
                 params, alive, revived, lo: int, victim):
        nl, n = view.shape
        p = params
        m = min(p.gossip_entries, n)
        if n < 2 or m < 1 or tick < 0 or not 0 <= lo <= n - nl:
            raise ValueError("swim_tick_window: the kernels take N >= 2, "
                             "at least one gossip entry, tick >= 0 and "
                             "rows inside N")
        i32 = torch.int32
        for name, t in (("view", view), ("suspect_since", suspect_since),
                        ("update_tx", update_tx)):
            kernels.check(f"swim_tick_window {name}", t, i32, (nl, n))
        kernels.check("swim_tick_window alive", alive, torch.bool, (n,), 1)
        if revived is not None:
            kernels.check("swim_tick_window revived", revived, torch.bool,
                          (n,), 1)
        self.n, self.nl, self.m, self.lo = n, nl, m, lo
        self.alive, self.revived = alive, revived
        span, mult = randint_span(1, max(n, 2))
        self.scalars = [n, nl, lo, p.num_indirect_probes, p.gossip_targets,
                        m, p.suspect_timeout, p.update_tx_limit, int(tick),
                        -1 if victim is None else int(victim), p.loss,
                        span, mult, _key_table(keys)]
        self.stream = kernels.stream(view)

    def __call__(self, phase: int, name: str, **ptrs) -> None:
        ptrs.setdefault("alive", self.alive)
        ptrs.setdefault("revived", self.revived)
        for k in ptrs:
            if k not in _WINDOW_POINTERS:
                raise ValueError(f"swim_window_launch has no {k!r}")
        fn = kernels.function("swim", "swim_window_launch", _WINDOW_ARGTYPES)
        code = fn(*[kernels.ptr(ptrs.get(k)) for k in _WINDOW_POINTERS],
                  *self.scalars, phase, self.stream)
        kernels.raise_on_error(name, code)


def _select_window(call, view, suspect_since, update_tx, incd):
    nl, n, m = call.nl, call.n, call.m
    dev = view.device
    i32 = torch.int32
    counts = torch.zeros((2, n), dtype=i32, device=dev)
    out = dict(view=torch.empty_like(view),
               target=torch.empty(nl, dtype=i32, device=dev),
               inc1=torch.empty(nl, dtype=i32, device=dev),
               probe=torch.empty(nl, dtype=torch.uint8, device=dev),
               ge=torch.empty((nl, m), dtype=i32, device=dev),
               sendable=torch.empty((nl, m), dtype=torch.uint8, device=dev),
               pay=torch.empty((nl, m), dtype=i32, device=dev),
               counts=counts)
    call(W_SELECT, "swim_probe_select", view_in=view, ss_in=suspect_since,
         tx_in=update_tx, inc_in=incd[0], diag_in=incd[1], view=out["view"],
         msgs=counts[0], pinged=counts[1], target=out["target"],
         inc1=out["inc1"], probe=out["probe"], ge=out["ge"],
         sendable=out["sendable"], pay=out["pay"])
    swim_probe_select.launches += 1
    return out


def _pass_window(call, phase: int, view, **ptrs):
    """One dissemination pass of the window (in place on ``view``) and
    the read-back of my rows' selected cells after it."""
    sent_out = torch.empty((call.nl, call.m), dtype=torch.int32,
                           device=view.device)
    call(phase, "swim_disseminate", view=view, sent_out=sent_out, **ptrs)
    swim_disseminate.launches += 1
    return view, sent_out


def swim_tick_window(view, suspect_since, incarnation, msgs, update_tx, key,
                     tick: int, params, alive, revived=None, *, lo: int,
                     victim=None, flags: bool = False):
    """One protocol period on the viewer rows ``[lo, lo + n)`` of the N
    nodes: a generator (``mesh.py``) that yields its exchanges over the
    mesh's ``nodes`` axis and returns ((view, suspect_since,
    incarnation, msgs, update_tx) of my rows, the [2] churn counts of
    the whole axis or None).

    view / suspect_since / update_tx [n, N] int32 and incarnation / msgs
    [n] int32 are my rows; alive / revived [N] bool and the key are
    every shard's.  The exchanges, in the reference's order of reads
    (``models/swim.py``): every node's incarnation and own record
    (``swim_inc``: the announces replay from them); each row's
    selection, target and probe flags, and the summed message and ping
    counts (``swim_select``, ``swim_msgs``); the selected cells after
    the gossip pass and after the ping pass (``swim_ping``,
    ``swim_ack``: each pass sends what the view held when it began);
    each prober's record at its target (``swim_settle``); the churn
    counts (``swim_flags``, with ``flags``).  Bitwise ``swim_tick``."""
    nl, n = view.shape
    if flags and not 0 <= victim < n:
        raise ValueError("swim_tick_window: flags need a victim in 0..N-1")
    keys = tick_keys(key)
    gossip = params.gossip_targets > 0
    incd = yield all_gather(torch.stack([incarnation,
                                         view.diagonal(offset=lo)]),
                            "swim_inc", dim=1)
    cpu = kernels.on_cpu(view, suspect_since, incarnation, msgs, update_tx,
                         alive, revived)
    call = None
    if cpu:
        sel = swim_select_window_plain(view, suspect_since, update_tx, incd,
                                       keys, tick, params, alive, revived, lo)
    else:
        kernels.check("swim_tick_window incarnation", incarnation,
                      torch.int32, (nl,))
        kernels.check("swim_tick_window msgs", msgs, torch.int32, (nl,))
        call = WindowCall(view, suspect_since, update_tx, keys, tick, params,
                          alive, revived, lo, victim)
        sel = _select_window(call, view, suspect_since, update_tx,
                             incd.contiguous())
    got = {}
    for name in ("ge", "sendable", "pay", "target", "probe"):
        got[name] = yield all_gather(sel[name], "swim_select")
    counts = yield all_reduce(sel["counts"], "swim_msgs")
    ge, sendable, target, probe = (got[k] for k in ("ge", "sendable",
                                                    "target", "probe"))
    if cpu:
        v, sent = swim_gossip_window_plain(sel["view"], ge, sendable,
                                           got["pay"], keys, params, alive,
                                           lo, gossip)
    else:
        v, sent = _pass_window(call, W_GOSSIP if gossip else W_COLLECT,
                               sel["view"], ge=ge, sendable=sendable,
                               pay=got["pay"])
    sent = yield all_gather(sent, "swim_ping")
    if cpu:
        v, sent = swim_ping_window_plain(v, ge, sendable, target, probe,
                                         sent, lo)
    else:
        v, sent = _pass_window(call, W_PING, v, ge=ge, sendable=sendable,
                               target=target, probe=probe, sent=sent)
    sent = yield all_gather(sent, "swim_ack")
    if cpu:
        v, peer_rec = swim_ack_window_plain(v, ge, sendable, target, probe,
                                            sent, lo)
    else:
        peer_rec = torch.empty(n, dtype=torch.int32, device=v.device)
        call(W_ACK, "swim_disseminate", view=v, ge=ge, sendable=sendable,
             target=target, probe=probe, sent=sent, peer_rec=peer_rec)
        swim_disseminate.launches += 1
    peer_rec = yield all_reduce(peer_rec, "swim_settle")
    if cpu:
        v, ss, inc, tx, fl = swim_settle_window_plain(
            v, view, suspect_since, update_tx, ge, sendable, target,
            sel["inc1"], counts, peer_rec, keys, tick, params, alive, lo,
            victim, flags)
    else:
        ss, inc, tx = (torch.empty_like(suspect_since),
                       torch.empty_like(incarnation),
                       torch.empty_like(update_tx))
        fl = (torch.zeros(2, dtype=torch.int32, device=v.device) if flags
              else None)
        call(W_SETTLE, "swim_settle", view_in=view, ss_in=suspect_since,
             tx_in=update_tx, view=v, ss=ss, inc=inc, tx=tx, target=target,
             inc1=sel["inc1"], pinged=counts[1], ge=ge, sendable=sendable,
             peer_rec=peer_rec, flags=fl)
        swim_settle.launches += 1
    if flags:
        fl = yield all_reduce(fl, "swim_flags")
    return (v, ss, inc, msgs + counts[0, lo:lo + nl], tx), fl
