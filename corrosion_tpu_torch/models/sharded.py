"""The explicit-collective gossip fabrics and the exact sampler's mesh
layouts (port of ``corrosion_tpu/models/sharded.py``).

Node state lives row-sharded over a :class:`corrosion_tpu_torch.mesh.Mesh`
and each shard runs a local function (a generator that yields its
collectives, see ``mesh.py``).  Draws are counter-based, so every shard
draws the same replicated sender maps and candidates from the shared
tick key without moving them.

* :func:`sharded_broadcast_step` — one all_gather of the sender rows
  and activity a tick, then each shard's receivers deliver from the
  gathered rows (the ``deliver_perm`` kernel with a source and a
  receiver window);
* :func:`sharded_broadcast_step_ring` — the destination-sorted fabric:
  each shard ships each destination only its active sender rows that
  destination's receivers drew (``route_pack``), over one all_to_all,
  and the receivers deliver through the received ids' slot map
  (``ring_receive``); at the default cap bitwise
  :func:`sharded_broadcast_step`;
* :func:`sharded_seq_sync_step` — the seq bitmaps all_gathered, the
  ``seq_sync`` kernel on the gathered state, each shard keeping its rows;
* :func:`sharded_epidemic_tick` — the vmapped ``epidemic_tick`` over a
  ``("seeds", "nodes")`` mesh (the twin of ``__graft_entry__.py``
  :183-215): each seeds row runs its seeds, each node shard its window
  of receivers, from one all_gather of the rows and one of the senders'
  hops (``deliver_perm``'s window), and on sync ticks the rows again and
  one all_reduce of the serving peers' charges (``sync_pull``'s window);
* :func:`sharded_swim_step` — ``swim_step`` with the [N, N] leaves'
  viewer rows over the mesh's ``nodes`` axis (the SWIM kernels' window
  forms, ``kernels/swim.py`` ``swim_tick_window``);
* the frontier layout (:func:`sharded_frontier_exact_step`, the ring
  row-sharded, every [S, N] leaf replicated, only the still-bad masks
  crossing) and the multi-host layout (:func:`sharded_frontier_host_step`,
  tx / next_send / msgs sharded too, only the bitpacked active and
  still-bad masks crossing) of the exact sampler; the dense layout is
  ``sim/calibrate.py``'s ``sharded_packed_exact_step``.

Each is bitwise its single-device counterpart for the same keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corrosion_tpu_torch.kernels.deliver import deliver_perm, sender_hops
from corrosion_tpu_torch.kernels.exact_send import exact_commit
from corrosion_tpu_torch.kernels.fabric import (
    bits_pack_active,
    bits_unpack,
    ring_receive,
    route_pack,
)
from corrosion_tpu_torch.mesh import all_gather, all_reduce, all_to_all
from corrosion_tpu_torch.kernels.swim import swim_tick_window
from corrosion_tpu_torch.kernels.sync_pull import sync_pull
from corrosion_tpu_torch.models.broadcast import BroadcastParams, _perm_senders
from corrosion_tpu_torch.models.common import severance_matrix
from corrosion_tpu_torch.models.swim import SwimState
from corrosion_tpu_torch.models.sync import SeqSyncParams, seq_sync_step
from corrosion_tpu_torch.random import randint, split, uniform
from corrosion_tpu_torch.sim import epidemic as ep
from corrosion_tpu_torch.sim.calibrate import (
    FrontierExactState,
    HeadlineExactConfig,
    _latency_promote,
    _layout,
    _mesh_chunk,
    _mesh_step,
    _partition_of,
    _rtt_tier_of,
    _send_params,
    _shard_send,
    _sync_due,
    _sync_peers,
    _sync_pull,
    _tick_keys,
    _wan_latency_on,
)


class BroadcastShard(NamedTuple):
    """One shard's broadcast leaves: rows [n_local, R] int32, tx and
    msgs [n_local] int32."""

    rows: torch.Tensor
    tx: torch.Tensor
    msgs: torch.Tensor


class SeqShard(NamedTuple):
    """One shard's reassembly leaves: bits [n_local, seqs] bool, msgs
    [n_local] int32."""

    bits: torch.Tensor
    msgs: torch.Tensor


def _n_local(mesh, n: int) -> int:
    if n % mesh.size != 0:
        raise ValueError(f"n_nodes {n} must divide over {mesh.size} shards")
    return n // mesh.size


def _senders(key_t, params: BroadcastParams, device) -> torch.Tensor:
    """[K, N] receiver->sender maps, replicated on every shard."""
    n = params.n_nodes
    u = params.universe or n
    return torch.stack([
        _perm_senders(key_t, j, n, u, j < params.fanout_ring0,
                      params.ring0_size, device=device)
        for j in range(params.fanout)
    ])


def _loss_u(key_l, params: BroadcastParams, device):
    if params.loss <= 0.0:
        return None
    return uniform(key_l, (params.n_nodes, params.fanout), device)


def _broadcast_local(sh, st: BroadcastShard, key, params, n_local):
    key_t, key_l = split(key)
    dev = st.rows.device
    rows_all = yield all_gather(st.rows, "rows")
    active_all = yield all_gather(st.tx > 0, "active")
    # the gathered rows are their own slots; an inactive sender has none
    slot_of = torch.where(
        active_all, torch.arange(params.n_nodes, dtype=torch.int32,
                                 device=dev), -1).to(torch.int32)
    rows, tx, msgs, _, _ = deliver_perm(
        st.rows, st.tx, st.msgs, _senders(key_t, params, dev),
        loss_u=_loss_u(key_l, params, dev), loss=params.loss,
        max_tx=params.max_transmissions, src_rows=rows_all,
        slot_of=slot_of, lo=sh * n_local)
    return BroadcastShard(rows, tx, msgs)


def sharded_broadcast_step(mesh, params: BroadcastParams):
    """``step(state, key) -> state`` over ``mesh``'s ``nodes`` axis:
    ``state`` a ``mesh.Sharded`` of :class:`BroadcastShard` leaves (rows
    row-sharded).  Per shard: one all_gather of every shard's rows and
    activity (``tx > 0``), then my receivers deliver from their column
    senders (loss only, as the reference's), decay my senders and
    refresh my learners.  Bitwise ``broadcast_step``."""
    n_local = _n_local(mesh, params.n_nodes)

    def step(state, key):
        out = mesh.run(_broadcast_local, {
            sh: (state[sh], key, params, n_local)
            for sh in mesh.local_shards})
        return state.replace(out, state.tick + 1)

    return step


def _ring_local(sh, st: BroadcastShard, key, params, n_local, cap):
    key_t, key_l = split(key)
    dev = st.rows.device
    senders = _senders(key_t, params, dev)
    send_ids, send_rows, overflow_l = route_pack(senders, st.tx > 0, st.rows,
                                                 sh, cap)
    recv_ids = yield all_to_all(send_ids, "ids")
    recv_rows = yield all_to_all(send_rows, "rows")
    rows, tx, msgs, bad = ring_receive(
        st.rows, st.tx, st.msgs, senders, recv_ids, recv_rows,
        loss_u=_loss_u(key_l, params, dev), loss=params.loss,
        max_tx=params.max_transmissions, lo=sh * n_local)
    overflow = yield all_reduce(overflow_l, "overflow")
    return BroadcastShard(rows, tx, msgs), overflow, bad


def sharded_broadcast_step_ring(mesh, params: BroadcastParams,
                                slot_cap=None):
    """``step(state, key) -> (state, overflow)``: the destination-sorted
    fabric.  Each shard sends each destination the first ``slot_cap``
    (default ``n_local``: lossless, bitwise
    :func:`sharded_broadcast_step`) of its active rows that
    destination's receivers drew, ids and rows over one all_to_all; the
    overflow — needed rows that did not fit, summed over the shards —
    is exact.  The step raises where a shard received ids out of
    ``route_pack``'s order (``ring_receive``'s flag)."""
    n_local = _n_local(mesh, params.n_nodes)
    cap = n_local if slot_cap is None else min(slot_cap, n_local)

    def step(state, key):
        out = mesh.run(_ring_local, {
            sh: (state[sh], key, params, n_local, cap)
            for sh in mesh.local_shards})
        # the overflow (every shard's copy is the sum) and each shard's
        # flag, in one read
        overflow, *bad = torch.cat(
            [next(iter(out.values()))[1]] + [o[2] for o in out.values()]
        ).tolist()
        if any(bad):
            raise RuntimeError("the ring fabric received ids out of "
                               "route_pack's order")
        return (state.replace({sh: o[0] for sh, o in out.items()},
                              state.tick + 1), overflow)

    return step


def _seq_local(sh, st: SeqShard, key, params, n_local):
    bits_all = yield all_gather(st.bits, "seq")
    msgs_all = yield all_gather(st.msgs, "msgs")
    bits, msgs = seq_sync_step(bits_all, msgs_all, key, params)
    lo = sh * n_local
    return SeqShard(bits[lo:lo + n_local].clone(),
                    msgs[lo:lo + n_local].clone())


def sharded_seq_sync_step(mesh, params: SeqSyncParams):
    """``step(state, key) -> state``: sequence reassembly over the mesh
    (``state`` a ``mesh.Sharded`` of :class:`SeqShard` leaves).  One
    all_gather of the seq bitmaps and msgs, the ``seq_sync`` kernel on
    the gathered state (the same draws on every shard), each shard
    keeping its receivers' rows.  Bitwise ``seq_sync_step``."""
    n_local = _n_local(mesh, params.n_nodes)

    def step(state, key):
        out = mesh.run(_seq_local, {
            sh: (state[sh], key, params, n_local)
            for sh in mesh.local_shards})
        return state.replace(out, state.tick + 1)

    return step


# -- the exact sampler's frontier layouts ------------------------------


def _sharded_frontier_tick_local(sh: int, st: FrontierExactState, keys,
                                 cfg: HeadlineExactConfig, diag,
                                 writer: int = 0):
    """One frontier tick on shard ``sh`` (generator; the port of the
    reference's :347): every [S, N] leaf replicated, my [S, n_local,
    cap] ring rows.  A tick with an empty frontier exchanges nothing."""
    infected, tx, next_send, ring_l, msgs, tick, pending = st
    n = cfg.n_nodes
    n_local = ring_l.shape[1]
    lo = sh * n_local
    dev = infected.device
    tier = _rtt_tier_of(cfg, dev)
    latency = _wan_latency_on(cfg)
    if latency:
        infected, tx, next_send, pending = _latency_promote(
            infected, tx, next_send, pending, tick, cfg, tier)
    active = infected & (tx > 0) & (next_send <= tick)
    triples, k_sync = _tick_keys(keys)
    if bool(active.any()):
        new_infected = yield from _shard_send(
            sh, n, active[:, lo:lo + n_local].contiguous(), active, ring_l,
            triples, tick, _send_params(cfg, True, writer), diag, False,
            infected, pending if latency else None, tx, next_send, msgs,
            tier)
        exact_commit(infected, new_infected, tx, next_send, tick,
                     cfg.max_transmissions, tier=tier)
        infected = new_infected
    if _sync_due(cfg, tick):
        infected, msgs = _sync_pull(
            infected, msgs, _sync_peers(k_sync, cfg, dev), cfg,
            part=_partition_of(cfg, dev), part_active=tick < cfg.heal_tick)
    return FrontierExactState(infected, tx, next_send, ring_l, msgs,
                              tick + 1, pending)


def _frontier_stats(sh: int, st: FrontierExactState):
    return st.infected, st.msgs
    yield  # a generator: the replicated leaves need no collective


def sharded_frontier_exact_step(mesh, cfg: HeadlineExactConfig):
    """The frontier layout's tick: ``step(state, keys) -> state`` on a
    ``mesh.Sharded`` laid out by ``FRONTIER_LAYOUT`` over ``nodes``.
    Bitwise ``frontier_exact_tick`` per seed."""
    return _mesh_step(mesh, cfg, _layout(mesh, cfg, True, False))


def make_sharded_frontier_chunk(mesh, cfg: HeadlineExactConfig):
    """The frontier layout's chunk (statistics off the replicated
    leaves, no gather)."""
    return _mesh_chunk(mesh, cfg, _layout(mesh, cfg, True, False))


def _check_host_mesh(mesh, cfg: HeadlineExactConfig) -> int:
    h = mesh.size
    if cfg.n_nodes % (8 * h) != 0:
        raise ValueError(
            f"n_nodes {cfg.n_nodes} must divide over {h} hosts into "
            "byte-aligned rows (n_nodes % (8 * n_hosts) == 0) for the "
            "bitpacked delta exchange"
        )
    return h


def _sharded_frontier_host_tick_local(sh: int, st: FrontierExactState, keys,
                                      cfg: HeadlineExactConfig, diag,
                                      writer: int = 0):
    """One frontier tick on host ``sh`` of the multi-host layout
    (generator; the port of the reference's :564): my [S, n_local]
    tx / next_send / msgs and ring rows, infected and pending [S, N]
    replicated by construction.  The only exchanges: my active bits,
    then my still-bad bits each round, bitpacked; nothing on sync
    ticks (each host keeps its rows of the session pay)."""
    infected, tx_l, next_send_l, ring_l, msgs_l, tick, pending = st
    n = cfg.n_nodes
    s, n_local = tx_l.shape
    lo = sh * n_local
    dev = infected.device
    tier = _rtt_tier_of(cfg, dev)
    tier_l = None if tier is None else tier[lo:lo + n_local]
    latency = _wan_latency_on(cfg)
    if latency:
        # due / arrived derive from the replicated leaves; each host
        # applies them to its own rows
        infected, tx_l, next_send_l, pending = _latency_promote(
            infected, tx_l, next_send_l, pending, tick, cfg, tier_l, lo=lo)
    # my active rows and their wire in one pass over my window of the
    # replicated mask; the unpack counts the set bits for the test
    active_l, wire_l = bits_pack_active(infected[:, lo:lo + n_local], tx_l,
                                        next_send_l, tick)
    wire = yield all_gather(wire_l, "delta", dim=1)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    active = bits_unpack(wire, n, count=count)
    triples, k_sync = _tick_keys(keys)
    if int(count):
        new_infected = yield from _shard_send(
            sh, n, active_l, active, ring_l, triples, tick,
            _send_params(cfg, True, writer), diag, True, infected,
            pending if latency else None, tx_l, next_send_l, msgs_l, tier)
        # my windows of the replicated masks, read in place
        exact_commit(infected[:, lo:lo + n_local],
                     new_infected[:, lo:lo + n_local], tx_l, next_send_l,
                     tick, cfg.max_transmissions, tier=tier_l)
        infected = new_infected
    if _sync_due(cfg, tick):
        infected, pay = _sync_pull(
            infected, torch.zeros((s, n), dtype=torch.int32, device=dev),
            _sync_peers(k_sync, cfg, dev), cfg,
            part=_partition_of(cfg, dev), part_active=tick < cfg.heal_tick)
        msgs_l += pay[:, lo:lo + n_local]
    return FrontierExactState(infected, tx_l, next_send_l, ring_l, msgs_l,
                              tick + 1, pending)


def _host_stats(sh: int, st: FrontierExactState):
    # measurement: the sharded msgs leaf gathered for the statistics
    msgs = yield all_gather(st.msgs, "stats", dim=1)
    return st.infected, msgs


def sharded_frontier_host_step(mesh, cfg: HeadlineExactConfig):
    """The multi-host layout's tick: ``step(state, keys) -> state`` on a
    ``mesh.Sharded`` laid out by ``HOST_LAYOUT`` over ``hosts``.
    Bitwise ``frontier_exact_tick`` per seed."""
    return _mesh_step(mesh, cfg, _layout(mesh, cfg, True, True))


def make_sharded_frontier_host_chunk(mesh, cfg: HeadlineExactConfig):
    """The multi-host layout's chunk (the msgs leaf gathered for the
    statistics, measurement traffic charged as ``"stats"``)."""
    return _mesh_chunk(mesh, cfg, _layout(mesh, cfg, True, True))



# -- the epidemic tick and the SWIM step on a ("seeds", "nodes") mesh ----


def _nodes_window(mesh, sh: int, n: int) -> tuple:
    """(first node, nodes) of shard ``sh``'s window of ``n`` nodes over
    the mesh's ``nodes`` axis."""
    d = mesh.axis_size("nodes")
    if n % d:
        raise ValueError(f"n_nodes {n} must divide over {d} node shards")
    n_local = n // d
    return mesh.coords(sh)[-1] * n_local, n_local


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy where a kernel's 16-byte row loads need one."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_epidemic_mesh(cfg) -> None:
    if cfg.track_sent:
        raise NotImplementedError("track_sent ([N, N] sent_to memory) is "
                                  "not sharded on the mesh")
    if cfg.n_universes is not None:
        raise NotImplementedError("seed-flattened universes (n_universes) "
                                  "are not sharded on the mesh: its seeds "
                                  "axis holds the universes")
    if cfg.topology != "uniform":
        raise NotImplementedError(f"the {cfg.topology!r} topology is not "
                                  "sharded on the mesh")


def _epidemic_local(sh, st, keys, cfg, mesh):
    """One vmapped epidemic tick on shard ``sh`` (generator): my seeds
    ``keys`` (one tick key each) and my window of every leaf, [S_l,
    n_local, ...]."""
    lo, n_local = _nodes_window(mesh, sh, cfg.n_nodes)
    n, tick = cfg.n_nodes, st.tick
    dev = st.rows.device
    params = cfg.broadcast_params
    part = ep._partition_ids(cfg, dev)
    part_active = tick < cfg.heal_tick
    sev = None
    if cfg.oneway_blocks:
        sev = severance_matrix(cfg.oneway_blocks, device=dev)
    hops = st.hops
    shops = torch.stack([
        sender_hops(st.tx_remaining[s], st.next_send[s], tick,
                    None if hops is None else hops[s])
        for s in range(len(keys))])
    rows_all = yield all_gather(st.rows, "rows", dim=1)
    shops_all = yield all_gather(shops, "hops", dim=1)
    out, k_sync = [], []
    for s, key in enumerate(keys):
        k_b, k_s = split(key)
        key_t, key_l = split(k_b)
        k_sync.append(k_s)
        out.append(deliver_perm(
            st.rows[s], st.tx_remaining[s], st.msgs[s],
            _senders(key_t, params, dev), hops=None if hops is None
            else hops[s], next_send=st.next_send[s], tick=tick,
            loss_u=_loss_u(key_l, params, dev), partition_id=part, sev=sev,
            partition_active=part_active, loss=params.loss,
            max_tx=params.max_transmissions, backoff=params.backoff_ticks,
            src_rows=_aligned(rows_all[s]), shops=shops_all[s], lo=lo))
    rows, tx, msgs, new_hops, next_send = (
        None if x[0] is None else torch.stack(x) for x in zip(*out))
    if ep._sync_due(cfg, tick):
        rows_all = yield all_gather(rows, "rows", dim=1)
        synced, deltas = [], []
        for s, k_s in enumerate(k_sync):
            offs = randint(k_s, (n, cfg.sync_peers), 1, max(n, 2),
                           device=dev)
            r_s, m_s, delta = sync_pull(
                rows[s], msgs[s], offs, n, src_rows=_aligned(rows_all[s]),
                lo=lo, partition_id=part, sev=sev,
                partition_active=part_active,
                cells_per_chunk=cfg.cells_per_chunk,
                handshake_msgs=cfg.sync_params.handshake_msgs)
            synced.append((r_s, m_s))
            deltas.append(delta)
        served = yield all_reduce(torch.stack(deltas), "sync")
        rows = torch.stack([r for r, _ in synced])
        msgs = (torch.stack([m for _, m in synced])
                + served[:, lo:lo + n_local])
    return ep.EpidemicState(rows, tx, msgs, tick + 1, new_hops, next_send,
                            None)


def sharded_epidemic_tick(mesh, cfg):
    """``step(state, keys) -> state``: the vmapped ``epidemic_tick``
    (``sim/epidemic.py``; ``jax.vmap`` over seeds under
    ``epidemic_shardings`` in the reference) on a ``("seeds", "nodes")``
    mesh.  ``state`` is a ``mesh.Sharded`` of ``EpidemicState`` windows
    (``entry.shard_state``: leaves [S / seeds_ax, N / nodes_ax, ...],
    the host tick shared), ``keys`` the S seeds' tick keys in seed
    order; seeds row r runs seeds ``r * S_l .. (r + 1) * S_l - 1``, each
    with its own key.  Per seed: the broadcast from one all_gather of
    the rows and one of the senders' hops (``rows`` / ``hops``), each
    shard delivering to its receivers; on the sync cadence the rows
    again and the serving peers' charges summed (``sync``).  Bitwise
    each seed's ``epidemic_tick``.  ``track_sent``, ``n_universes`` and
    the non-uniform topologies raise ``NotImplementedError``."""
    _check_epidemic_mesh(cfg)
    seeds_ax = mesh.axis_size("seeds") if "seeds" in mesh.axes else 1

    def step(state, keys):
        keys = list(keys)
        if len(keys) % seeds_ax:
            raise ValueError(f"{len(keys)} seeds do not split over "
                             f"{seeds_ax} seeds rows")
        s_l = len(keys) // seeds_ax

        def mine(sh):
            row = mesh.coords(sh)[0] if seeds_ax > 1 else 0
            return keys[row * s_l:(row + 1) * s_l]

        out = mesh.run(_epidemic_local, {
            sh: (state[sh], mine(sh), cfg, mesh)
            for sh in mesh.local_shards})
        return state.replace(out, state.tick + 1)

    return step


def _swim_local(sh, st: SwimState, key, tick, params, alive, revived,
                victim, flagged, mesh):
    lo, n_local = _nodes_window(mesh, sh, params.n_nodes)
    out = yield from swim_tick_window(
        st.view, st.suspect_since, st.incarnation, st.msgs, st.update_tx,
        key, tick, params, alive, revived, lo=lo, victim=victim,
        flags=flagged)
    return out


def sharded_swim_step(mesh, params):
    """``step(state, key, tick, alive, revived=None, victim=None,
    flags=None) -> state``: ``swim_step`` (``models/swim.py``) with every
    leaf's viewer rows over the mesh's ``nodes`` axis
    (``swim_shardings``); on a two-axis mesh each seeds row holds its
    own replica.  ``state`` is a ``mesh.Sharded`` of ``SwimState``
    windows (view, suspect_since, update_tx [N / nodes_ax, N],
    incarnation and msgs [N / nodes_ax]); ``alive`` / ``revived`` [N]
    bool and the key are replicated.  The draws and the [N]- and [N,
    M]-sized work are replicated or gathered, the view's cross-row
    steps each an exchange (``kernels/swim.py`` ``swim_tick_window``).
    ``flags`` ([2] int32), when given, gains the churn counts of the
    nodes other than ``victim`` (summed over one seeds row).  Bitwise
    ``swim_step``."""

    def step(state, key, tick, alive, revived=None, victim=None,
             flags=None):
        if flags is not None and not 0 <= victim < params.n_nodes:
            raise ValueError("sharded_swim_step: flags need a victim in "
                             "0..N-1")
        out = mesh.run(_swim_local, {
            sh: (state[sh], key, int(tick), params, alive, revived, victim,
                 flags is not None, mesh)
            for sh in mesh.local_shards})
        parts = {sh: SwimState(*o[0]) for sh, o in out.items()}
        if flags is not None:
            flags += next(iter(out.values()))[1]
        return state.replace(parts, state.tick + 1)

    return step
