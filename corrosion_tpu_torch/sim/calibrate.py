"""The exact sampler (port of ``corrosion_tpu/sim/calibrate.py``): the
calibration-scale scores sampler and ``run_msgs_calibration``, and at
headline scale the bitpacked and frontier-sparse kernels, their
seed-batched runners and ``run_exact_headline``.

Calibration scale (``ExactConfig``, N = 1k-16k, one seed at a time):
``sent`` is one [N, N] bool; each tick every active sender scores its
peers with a uniform draw (one [C, N] draw per sender chunk), drops the
ones it has sent to and itself, and sends to the ``fanout`` lowest —
the ``sent_select`` / ``sent_commit`` kernels, from one ``sent_tick``
call.  ``run_msgs_calibration`` sets msgs/node at convergence of this
sampler against the matched perm-fanout config (``CALIB_MSGS.json``'s
exact/perm ratio).

Headline scale, the exact column of every sweep row: each sender
draws its k targets uniformly WITHOUT replacement from the nodes it has
not sent the payload to yet (the agents' ``sent_to``-excluding
sampler), by full-tuple rejection — redraw the whole tuple while it
holds self, a duplicate or an already-sent target.  Two representations
of ``sent_to``, bitwise equal in every trajectory:

* dense: a ``[S, N, ceil(N/8)]`` uint8 bitmap (``PackedExactState``);
* sparse: a ``[S, N, max_tx * fanout]`` int32 ring of the targets each
  node sent to, plus the writer's ring0 tier as arithmetic
  (``FrontierExactState``) — the only one that reaches N = 1M.

At headline scale every leaf carries a leading seed axis ``[S, ...]``,
as the reference's vmapped runners hold it; a single seed is the ``S = 1`` case.  The
tick counter is a host int shared by the batch, so the partition and
the sync cadence are plain ``if``s.  One tick is: the WAN latency
queue's promote pass (latency family only), the ``exact_send`` kernel
(rejection loop, masks, infection, marks, budget), the
``exact_commit`` kernel (the learners' fresh budget), and on the sync
cadence the ``sync_pull`` kernel at R = 1.  Per-tick statistics come
from the ``tick_stats`` kernel and reach the host once per chunk.

Tensors are updated in place tick by tick (the dense bitmap is 20 GB
at the headline's width); a tick returns the next state, whose leaves
may be the same tensors as its argument's.

Over a mesh (``corrosion_tpu_torch.mesh``) the same ticks run in three
layouts, dense, frontier and multi-host (see "the multi-device
layouts" below and ``models/sharded.py``), through the ``shard_round``
/ ``shard_commit`` kernels.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.kernels.exact_send import (
    DIAG,
    MAX_ROUNDS,
    SendParams,
    block_of,
    exact_commit,
    exact_send,
    raise_on_capped,
)
from corrosion_tpu_torch.kernels.sent_sampler import key_tensor, sent_tick
from corrosion_tpu_torch.kernels.sync_pull import sync_pull
from corrosion_tpu_torch.kernels.tick_stats import (
    CONVERGED,
    MSGS_MEAN,
    MSGS_P99,
    STATS,
    raise_on_overflow,
    tick_stats,
)
from corrosion_tpu_torch.models.broadcast import measured_tier_map
from corrosion_tpu_torch.random import (
    PRNGKey,
    fold_in,
    key_words,
    randint,
    split,
    uniform,
)
from corrosion_tpu_torch.sim.epidemic import (
    EpidemicConfig,
    run_epidemic_seeds,
    stats_at_convergence,
)

# -- calibration scale: the scores sampler ------------------------------


@dataclass(frozen=True)
class ExactConfig:
    n_nodes: int
    fanout: int = 4
    max_transmissions: int = 8
    backoff_ticks: float = 0.0
    max_ticks: int = 192
    sender_chunk: int = 2048


class ExactState(NamedTuple):
    infected: torch.Tensor  # [N] bool
    tx: torch.Tensor  # [N] int32 remaining transmissions
    next_send: torch.Tensor  # [N] int32
    sent: torch.Tensor  # [N, N] bool per-payload sent_to
    msgs: torch.Tensor  # [N] int32
    tick: int  # host counter


def exact_init(cfg: ExactConfig, writer: int = 0,
               device="cuda") -> ExactState:
    device = resolve_device(device)
    n = cfg.n_nodes
    i32 = dict(dtype=torch.int32, device=device)
    infected = torch.zeros((n,), dtype=torch.bool, device=device)
    infected[writer] = True
    tx = torch.zeros((n,), **i32)
    tx[writer] = cfg.max_transmissions
    return ExactState(
        infected=infected, tx=tx, next_send=torch.zeros((n,), **i32),
        sent=torch.zeros((n, n), dtype=torch.bool, device=device),
        msgs=torch.zeros((n,), **i32), tick=0,
    )


def chunk_keys(key, cfg: ExactConfig) -> list:
    """The score key of each sender chunk of a tick: ``fold_in(key,
    start)``, start the chunk's first row."""
    c = min(cfg.sender_chunk, cfg.n_nodes)
    return [fold_in(key, start) for start in range(0, cfg.n_nodes, c)]


def exact_inputs(state: ExactState, key, cfg: ExactConfig):
    """(select, commit): the keyword arguments of a tick's
    ``sent_select`` call and of its ``sent_commit`` call (less the
    selection's outputs), with the seed axis of one seed; together,
    ``{**select, **commit}``, those of its ``sent_tick`` call."""
    infected, tx, next_send = (state.infected[None], state.tx[None],
                               state.next_send[None])
    select = dict(
        sent=state.sent[None],
        keys=key_tensor([chunk_keys(key, cfg)], state.infected.device),
        fanout=cfg.fanout, chunk=min(cfg.sender_chunk, cfg.n_nodes), tx=tx,
        next_send=next_send, tick=state.tick, infected=infected)
    commit = dict(
        tx=tx, msgs=state.msgs[None], tick=state.tick,
        max_tx=cfg.max_transmissions, backoff=cfg.backoff_ticks,
        next_send=next_send, infected=infected)
    return select, commit


def exact_tick(state: ExactState, key, cfg: ExactConfig) -> ExactState:
    """One tick: every active sender (infected, budget left, schedule
    due) sends to its ``fanout`` lowest-scored peers not yet sent to
    (``sent_select``), then the budget / backoff epilogue
    (``sent_commit``), both from one ``sent_tick`` call: a send
    decrements, exhausted coverage retires, learners get a fresh budget
    and forward next tick.  ``sent`` is marked in place; the other
    leaves are fresh tensors."""
    select, commit = exact_inputs(state, key, cfg)
    new_infected, _, tx, next_send, msgs = sent_tick(**{**select,
                                                        **commit})
    return ExactState(new_infected[0], tx[0], next_send[0], state.sent,
                      msgs[0], state.tick + 1)


def run_exact(cfg: ExactConfig, seed: int = 0, device="cuda") -> Dict:
    """One exact-sampler epidemic; msgs/node measured at convergence
    (one bool host fetch a tick)."""
    state = exact_init(cfg, device=device)
    key = PRNGKey(seed)
    t0 = time.perf_counter()
    converged_tick: Optional[int] = None
    for t in range(cfg.max_ticks):
        state = exact_tick(state, fold_in(key, t), cfg)
        if converged_tick is None and bool(state.infected.all()):
            converged_tick = t + 1
            break
    msgs = state.msgs.cpu().numpy()
    return {
        "n_nodes": cfg.n_nodes,
        "converged_tick": converged_tick,
        "msgs_per_node_mean": float(msgs.mean()),
        "wall_s": time.perf_counter() - t0,
    }


def run_msgs_calibration(
    ns: List[int] = (1000, 4000, 16000),
    seeds: int = 3,
    fanout: int = 4,
    max_transmissions: int = 8,
    out_path: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Exact vs perm-fanout msgs/node under matched conditions (uniform
    sampling, no loss, no sync, no partitions) — the measured correction
    factor for the sweep's perm-fanout lower bound."""
    device = resolve_device(device)
    points = []
    for n in ns:
        ecfg = ExactConfig(
            n_nodes=n, fanout=fanout, max_transmissions=max_transmissions
        )
        exact_msgs = []
        conv = []
        for s in range(seeds):
            r = run_exact(ecfg, seed=s, device=device)
            exact_msgs.append(r["msgs_per_node_mean"])
            conv.append(r["converged_tick"])
        pcfg = EpidemicConfig(
            n_nodes=n, n_rows=4,
            fanout_ring0=0, fanout_global=fanout, ring0_size=1,
            max_transmissions=max_transmissions, loss=0.0,
            sync_interval=0, track_hops=False,
            max_ticks=ecfg.max_ticks, chunk_ticks=8,
        )
        # warm run, as the reference's compile warm-up
        run_epidemic_seeds(pcfg, n_seeds=seeds, seed=1, device=device)
        perm = run_epidemic_seeds(pcfg, n_seeds=seeds, seed=0, device=device)
        exact_mean = float(np.mean(exact_msgs))
        points.append({
            "n": n,
            "msgs_exact": round(exact_mean, 2),
            "msgs_perm": round(perm["msgs_per_node_mean"], 2),
            "exact_over_perm": round(
                exact_mean / max(perm["msgs_per_node_mean"], 1e-9), 3
            ),
            "exact_converged_ticks": conv,
            "perm_ticks_p50": perm["ticks_p50"],
            "seeds": seeds,
        })
    out = {
        "metric": "exact_vs_perm_msgs_calibration",
        "fanout": fanout,
        "max_transmissions": max_transmissions,
        "conditions": "uniform sampling, no loss/sync/partition",
        "points": points,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def ratio_for(calib: Dict, n: int) -> Optional[float]:
    """exact/perm correction factor at the calibrated N nearest to n."""
    pts = calib.get("points") or []
    if not pts:
        return None
    best = min(pts, key=lambda p: abs(p["n"] - n))
    return best["exact_over_perm"]


# -- headline scale ------------------------------------------------------

@dataclass(frozen=True)
class HeadlineExactConfig:
    n_nodes: int
    fanout: int = 4
    ring0_size: int = 256  # origin first-transmission tier (0 = off)
    max_transmissions: int = 8
    backoff_ticks: float = 0.0
    loss: float = 0.0
    partition_blocks: int = 1
    heal_tick: int = 0
    sync_interval: int = 0
    sync_peers: int = 1
    handshake_msgs: int = 2  # sync session accounting (models/sync.py)
    max_ticks: int = 192
    chunk_ticks: int = 16
    # scenario families: "uniform", "het_ring" (node i on RTT tier
    # 1 + i*rtt_tiers//n scales its retransmit gap and first forward),
    # "wan_two_region" (an extra wan_cross_loss drop on gossip crossing
    # regions; with wan_latency_ticks > 0 cross-region deliveries land
    # that many ticks late), "measured_ring" (het_ring with tiers from
    # measured per-tier node-count weights)
    topology: str = "uniform"
    rtt_tiers: int = 4
    wan_blocks: int = 2
    wan_cross_loss: float = 0.25
    rtt_tier_weights: Optional[tuple] = None
    wan_latency_ticks: int = 0

    def __post_init__(self):
        if self.topology not in (
            "uniform", "het_ring", "wan_two_region", "measured_ring"
        ):
            raise ValueError(f"unknown topology {self.topology!r}")
        if self.topology == "het_ring" and self.rtt_tiers < 1:
            raise ValueError("het_ring needs rtt_tiers >= 1")
        if self.topology == "wan_two_region" and self.wan_blocks < 2:
            raise ValueError("wan_two_region needs wan_blocks >= 2")
        if self.topology == "measured_ring":
            w = self.rtt_tier_weights
            if not w or any(x < 0 for x in w) or sum(w) <= 0:
                raise ValueError(
                    "measured_ring needs rtt_tier_weights: a non-empty "
                    "tuple of non-negative per-tier node weights with a "
                    "positive sum (corro admin rtt dump emits one)"
                )
        if self.wan_latency_ticks < 0:
            raise ValueError("wan_latency_ticks must be >= 0")
        if self.wan_latency_ticks > 0 and self.topology != "wan_two_region":
            raise ValueError(
                "wan_latency_ticks needs the wan_two_region topology "
                "(latency is a property of the cross-region links)"
            )
        # rejection sampling needs the excluded set (at worst the
        # origin's budget * k sends and its ring0 tier) far below N
        excl = self.max_transmissions * self.fanout + self.ring0_size + 1
        if self.n_nodes < 2 * excl:
            raise ValueError(
                f"n_nodes={self.n_nodes} too small for rejection "
                f"sampling (excluded set can reach {excl}); use the "
                "scores-based ExactConfig kernel below N≈1k"
            )


def headline_exact_cfg(n: int, partitioned: bool) -> HeadlineExactConfig:
    """The exact column's protocol at ``n`` nodes as bench.py
    ``_frontier_exact_cfg`` (bench.py:2538-2553) builds it for both N
    sweeps: fanout 4, ring0 256, 8 transmissions, 5% loss, sync every 8
    ticks with one peer; two partition blocks healing at tick 12 when
    ``partitioned``; 8-tick chunks above 256k nodes."""
    return HeadlineExactConfig(
        n_nodes=n, fanout=4, ring0_size=256, max_transmissions=8,
        loss=0.05, partition_blocks=2 if partitioned else 1,
        heal_tick=12 if partitioned else 0, sync_interval=8, sync_peers=1,
        max_ticks=192, chunk_ticks=16 if n <= 256_000 else 8,
    )


# The full-width runs of the exact column, with bench.py
# ``_exact_seed_policy``'s seed counts (bench.py:3576-3584): the
# partitioned sweep's headline row (dense bitmap) and the loss-only
# sweep's 1M point (the rings: the bitmap would be 125 GB a seed)
EXACT_DENSE, EXACT_DENSE_SEEDS = headline_exact_cfg(100_000, True), 16
EXACT_SPARSE, EXACT_SPARSE_SEEDS = headline_exact_cfg(1_000_000, False), 4

# int32 sentinel of the WAN latency queue: "no delivery in flight"
LATENCY_NONE = (1 << 30) - 1


def frontier_ring_cap(cfg: HeadlineExactConfig) -> int:
    """Ring slots per node: the protocol's own bound on distinct
    targets a non-origin node can ever send this payload to."""
    return cfg.max_transmissions * cfg.fanout


class PackedExactState(NamedTuple):
    infected: torch.Tensor  # [S, N] bool
    tx: torch.Tensor  # [S, N] int32 remaining transmissions
    next_send: torch.Tensor  # [S, N] int32
    sent: torch.Tensor  # [S, N, ceil(N/8)] uint8 bitpacked sent_to
    msgs: torch.Tensor  # [S, N] int32 (broadcast + sync session msgs)
    tick: int  # host counter, shared by the seeds
    pending: torch.Tensor  # [S, N] int32 WAN latency queue


class FrontierExactState(NamedTuple):
    infected: torch.Tensor  # [S, N] bool
    tx: torch.Tensor  # [S, N] int32
    next_send: torch.Tensor  # [S, N] int32
    ring: torch.Tensor  # [S, N, cap] int32 sent targets (N = empty)
    msgs: torch.Tensor  # [S, N] int32
    tick: int
    pending: torch.Tensor  # [S, N] int32


# -- topology maps ([N] int32 on a device, or None when off) ------------


def _blocks(cfg: HeadlineExactConfig, blocks: int, device) -> torch.Tensor:
    idx = torch.arange(cfg.n_nodes, dtype=torch.int32, device=device)
    return block_of(idx, blocks, cfg.n_nodes)


def _wan_loss_on(cfg: HeadlineExactConfig) -> bool:
    return cfg.topology == "wan_two_region" and cfg.wan_cross_loss > 0.0


def _wan_latency_on(cfg: HeadlineExactConfig) -> bool:
    return cfg.topology == "wan_two_region" and cfg.wan_latency_ticks > 0


def _partition_of(cfg: HeadlineExactConfig, device):
    if cfg.partition_blocks <= 1:
        return None
    return _blocks(cfg, cfg.partition_blocks, device)


def _rtt_tier_of(cfg: HeadlineExactConfig, device):
    """RTT tier of the het_ring (linear ramp, 1..rtt_tiers) or
    measured_ring (measured node-count weights) topology."""
    if cfg.topology == "measured_ring":
        tiers = measured_tier_map(cfg.n_nodes, cfg.rtt_tier_weights)
        return torch.from_numpy(tiers).to(device)
    if cfg.topology != "het_ring":
        return None
    return 1 + _blocks(cfg, cfg.rtt_tiers, device)


def _region_of(cfg: HeadlineExactConfig, device):
    """WAN region of the extra cross-region loss filter."""
    return _blocks(cfg, cfg.wan_blocks, device) if _wan_loss_on(cfg) else None


def _latency_region_of(cfg: HeadlineExactConfig, device):
    """WAN region of the latency queue (separate from ``_region_of``,
    which is gated on the loss)."""
    if not _wan_latency_on(cfg):
        return None
    return _blocks(cfg, cfg.wan_blocks, device)


def _send_params(cfg: HeadlineExactConfig, ring: bool,
                 writer: int = 0) -> SendParams:
    return SendParams(
        fanout=cfg.fanout, max_tx=cfg.max_transmissions,
        backoff=cfg.backoff_ticks, loss=cfg.loss,
        part_blocks=cfg.partition_blocks if cfg.partition_blocks > 1 else 0,
        heal_tick=cfg.heal_tick,
        wan_blocks=cfg.wan_blocks if _wan_loss_on(cfg) else 0,
        wan_loss=cfg.wan_cross_loss,
        lat_blocks=cfg.wan_blocks if _wan_latency_on(cfg) else 0,
        lat_ticks=cfg.wan_latency_ticks,
        ring0_block=(min(cfg.ring0_size, cfg.n_nodes)
                     if ring and cfg.ring0_size > 1 else 0),
        writer=writer,
    )


# -- init -------------------------------------------------------------


def _key_rows(keys) -> list:
    """S host keys as word pairs, from a sequence of keys or a [S, 2]
    (or one [2]) uint32 tensor or array."""
    if (isinstance(keys, (list, tuple)) and keys
            and not isinstance(keys[0], (int, np.integer))):
        return [key_words(k) for k in keys]
    if isinstance(keys, torch.Tensor):
        keys = keys.tolist()
    return [key_words(r) for r in np.asarray(keys, np.int64).reshape(-1, 2)]


def _init_leaves(cfg: HeadlineExactConfig, keys, writer: int, device):
    """The dense leaves of both inits: the writer and, with a ring0
    tier, the tier it reaches on its first flush (per-peer loss drawn
    from each seed's key).  Returns (leaves, in_tier)."""
    n = cfg.n_nodes
    rows = _key_rows(keys)
    s = len(rows)
    i32 = dict(dtype=torch.int32, device=device)
    infected = torch.zeros((s, n), dtype=torch.bool, device=device)
    infected[:, writer] = True
    tx = torch.zeros((s, n), **i32)
    tx[:, writer] = cfg.max_transmissions
    next_send = torch.zeros((s, n), **i32)
    msgs = torch.zeros((s, n), **i32)
    in_tier = None
    if cfg.ring0_size > 1:
        # the origin's first flush reaches its whole ring0 tier plus k
        # global picks; the tier is seeded here, tick 0 draws the picks
        idx = torch.arange(n, dtype=torch.int32, device=device)
        block = min(cfg.ring0_size, n)
        in_tier = (idx // block == writer // block) & (idx != writer)
        delivered = in_tier.expand(s, n)
        if cfg.loss > 0.0:
            keep = torch.stack([uniform(k, (n,), device) for k in rows])
            delivered = delivered & (keep >= torch.tensor(
                cfg.loss, dtype=torch.float32))
        infected |= delivered
        tx = torch.where(delivered, cfg.max_transmissions, tx)
        next_send = torch.where(delivered, 1, next_send)
        msgs[:, writer] += int(in_tier.sum())
    pending = torch.full((s, n), LATENCY_NONE, **i32)
    return (infected, tx, next_send, msgs, pending), in_tier


def packed_exact_init(cfg: HeadlineExactConfig, keys, writer: int = 0,
                      device="cuda") -> PackedExactState:
    """S seed universes (keys [S, 2], or one key) at tick 0: the
    writer holds the payload, its ring0 tier has been flushed and
    marked in its ``sent_to`` row."""
    device = resolve_device(device)
    (infected, tx, next_send, msgs, pending), in_tier = _init_leaves(
        cfg, keys, writer, device)
    s, n = infected.shape
    nb = -(-n // 8)
    sent = torch.zeros((s, n, nb), dtype=torch.uint8, device=device)
    if in_tier is not None:
        t = torch.nonzero(in_tier)[:, 0]
        row = torch.zeros((nb,), dtype=torch.int32, device=device)
        row.index_add_(0, t // 8, (1 << (t % 8)).to(torch.int32))
        sent[:, writer] = row.to(torch.uint8)
    return PackedExactState(infected, tx, next_send, sent, msgs, 0, pending)


def frontier_exact_init(cfg: HeadlineExactConfig, keys, writer: int = 0,
                        device="cuda") -> FrontierExactState:
    """``packed_exact_init`` on every dense leaf (the same tier loss
    draw); the writer's tier is not stored but tested as arithmetic."""
    device = resolve_device(device)
    (infected, tx, next_send, msgs, pending), _ = _init_leaves(
        cfg, keys, writer, device)
    s, n = infected.shape
    ring = torch.full((s, n, frontier_ring_cap(cfg)), n, dtype=torch.int32,
                      device=device)
    return FrontierExactState(infected, tx, next_send, ring, msgs, 0,
                              pending)


# -- one tick ---------------------------------------------------------


def _latency_promote(infected, tx, next_send, pending, tick: int,
                     cfg: HeadlineExactConfig, tier, lo: int = 0):
    """Commit the queue's due arrivals at the start of a tick, before the
    active set: an arrival is a learner (fresh budget, first forward a
    tier's worth of ticks later); one at an infected node only clears
    its slot.  ``tx``, ``next_send`` and ``tier`` may cover the window
    ``[lo, lo + n)`` of the columns of ``infected`` and ``pending`` (the
    multi-host layout replicates those two and owns its rows of the
    rest).  Returns (infected, tx, next_send, pending)."""
    due = pending <= tick
    arrived = due & ~infected
    arrived_w = arrived[..., lo:lo + tx.shape[-1]]
    first = 1 if tier is None else tier
    infected = infected | arrived
    tx = torch.where(arrived_w, cfg.max_transmissions, tx)
    next_send = torch.where(arrived_w, tick + first, next_send)
    pending = torch.where(due, LATENCY_NONE, pending)
    return infected, tx, next_send, pending


def _sync_peers(k_sync: list, cfg: HeadlineExactConfig, device):
    """[S, N, P] int32 peers ``randint(k_sync, (n, p), 0, n)`` per seed
    (a node may draw itself: a self-session)."""
    n, p = cfg.n_nodes, cfg.sync_peers
    return torch.stack([randint(k, (n, p), 0, n, device=device)
                        for k in k_sync])


def _sync_pull(infected, msgs, peers, cfg: HeadlineExactConfig, part=None,
               part_active: bool = False):
    """The exact kernels' anti-entropy pull through the ``sync_pull``
    kernel at R = 1: ``rows`` the infection bit as int32 ``[S*N, 1]``,
    one universe per seed (u = N), peer offsets ``(peer - local) mod N``
    (0 is a self-session), a chunk per served cell.  infected [S, N]
    bool, msgs [S, N] int32, peers [S, N, P] int32, part [N] int32 or
    None.  Returns (infected | healed, msgs + session pay)."""
    s, n = infected.shape
    p = peers.shape[-1]
    local = torch.arange(n, dtype=torch.int32, device=infected.device)
    offs = torch.remainder(peers - local[:, None], n).reshape(s * n, p)
    rows = infected.to(torch.int32).reshape(s * n, 1)
    rows, msgs = sync_pull(
        rows, msgs.reshape(s * n), offs, n,
        partition_id=None if part is None else part.repeat(s),
        partition_active=part_active, cells_per_chunk=1,
        handshake_msgs=cfg.handshake_msgs,
    )
    return rows.reshape(s, n) != 0, msgs.reshape(s, n)


def _tick_keys(keys):
    """(triples, k_sync) of S tick keys: each seed's ``(k_draw, k_loss,
    fold_in(k_loss, 1))`` (the draws, the loss and the WAN drop) and
    its sync key, ``split(key, 3)`` as the reference splits it."""
    triples, k_sync = [], []
    for key in _key_rows(keys):
        k_draw, k_loss, k_s = split(key, 3)
        triples.append((k_draw, k_loss, fold_in(k_loss, 1)))
        k_sync.append(k_s)
    return triples, k_sync


def _sync_due(cfg: HeadlineExactConfig, tick: int) -> bool:
    return (cfg.sync_interval > 0
            and tick % cfg.sync_interval == cfg.sync_interval - 1)


def _send_inputs(state, keys, cfg: HeadlineExactConfig, writer: int = 0):
    """This tick's ``exact_send`` arguments (after the latency queue's
    promote pass, which must not overlap the kernel's scatter-min), the
    seeds' sync keys and the queue."""
    infected, tx, next_send, sent, msgs, tick, pending = state
    tier = _rtt_tier_of(cfg, infected.device)
    latency = _wan_latency_on(cfg)
    if latency:
        infected, tx, next_send, pending = _latency_promote(
            infected, tx, next_send, pending, tick, cfg, tier)
    triples, k_sync = _tick_keys(keys)
    args = dict(infected=infected, tx=tx, next_send=next_send, msgs=msgs,
                pending=pending if latency else None, sent=sent,
                keys=triples, tick=tick,
                p=_send_params(cfg, isinstance(state, FrontierExactState),
                               writer),
                tier=tier)
    return args, k_sync, pending


def _exact_tick(state, keys, cfg: HeadlineExactConfig, writer: int, diag):
    args, k_sync, pending = _send_inputs(state, keys, cfg, writer)
    tick, tx, next_send = state.tick, args["tx"], args["next_send"]
    own = diag is None  # then the tick reads the counters itself
    if own:
        diag = torch.zeros(len(DIAG), dtype=torch.int64,
                           device=tx.device)
    new_infected = exact_send(**args, diag=diag)
    if own:
        raise_on_capped(diag.cpu().numpy())
    exact_commit(args["infected"], new_infected, tx, next_send, tick,
                 cfg.max_transmissions, tier=args["tier"])
    msgs = args["msgs"]
    if _sync_due(cfg, tick):
        device = new_infected.device
        new_infected, msgs = _sync_pull(
            new_infected, msgs, _sync_peers(k_sync, cfg, device), cfg,
            part=_partition_of(cfg, device),
            part_active=tick < cfg.heal_tick)
    return type(state)(new_infected, tx, next_send, args["sent"], msgs,
                       tick + 1, pending)


def packed_exact_tick(state: PackedExactState, keys,
                      cfg: HeadlineExactConfig,
                      diag=None) -> PackedExactState:
    """One exact-sampler tick over the bitmap for every seed; ``keys``
    are the seeds' tick keys ([S, 2], or one key for S = 1).  ``diag``
    (int64 [4], ``kernels.exact_send.DIAG``) accumulates the active rows
    and their rejection rounds, and the caller raises on its capped
    rows (``raise_on_capped``); without one the tick reads its own
    counters on the host and raises."""
    return _exact_tick(state, keys, cfg, 0, diag)


def frontier_exact_tick(state: FrontierExactState, keys,
                        cfg: HeadlineExactConfig, writer: int = 0,
                        diag=None) -> FrontierExactState:
    """``packed_exact_tick`` over the rings; ``writer`` must be the
    init's (the arithmetic ring0 tier).  An empty frontier needs no
    host check: the kernel finds no active row and writes nothing."""
    return _exact_tick(state, keys, cfg, writer, diag)


def frontier_sent_bitmap(state: FrontierExactState,
                         cfg: HeadlineExactConfig,
                         writer: int = 0) -> np.ndarray:
    """Decode the rings (+ the arithmetic ring0 tier) back to the dense
    ``[S, N, ceil(N/8)]`` bitmap: the parity operand against the dense
    kernel's ``sent``."""
    n = cfg.n_nodes
    nb = -(-n // 8)
    ring = state.ring.cpu().numpy()
    s, _, cap = ring.shape
    bitmap = np.zeros((s, n, nb), np.uint8)
    seeds = np.repeat(np.arange(s), n * cap)
    rows = np.tile(np.repeat(np.arange(n), cap), s)
    tgt = ring.reshape(-1)
    live = tgt < n
    np.bitwise_or.at(
        bitmap, (seeds[live], rows[live], tgt[live] // 8),
        np.uint8(1) << (tgt[live] % 8).astype(np.uint8),
    )
    if cfg.ring0_size > 1:
        idx = np.arange(n)
        block = min(cfg.ring0_size, n)
        t = idx[(idx // block == writer // block) & (idx != writer)]
        np.bitwise_or.at(
            bitmap, (slice(None), writer, t // 8),
            np.uint8(1) << (t % 8).astype(np.uint8),
        )
    return bitmap


# -- seed-batched chunks and the runner --------------------------------


def _stats_into(infected, msgs, out) -> None:
    """One tick's per-seed statistics (``STATS`` columns) of [S, N]
    ``infected`` (read as it is: one byte a node, held where set) and
    ``msgs`` into ``out`` [S, len(STATS)]."""
    tick_stats(infected, None, msgs.reshape(-1), None, infected.shape[0],
               out=out)


def _scan_chunk_batch(state, seed_keys, cfg: HeadlineExactConfig, tick_fn,
                      diag=None):
    """``cfg.chunk_ticks`` ticks of S seeds, tick keys ``fold_in(seed
    key, tick)``; every tick's per-seed statistics (``STATS`` columns:
    all infected, mean and p99 msgs) from the ``tick_stats`` kernel.
    Returns (state, [C, S, len(STATS)] float32 on the state's device)."""
    seeds = _key_rows(seed_keys)
    s = len(seeds)
    device = state.infected.device
    stats = torch.empty((cfg.chunk_ticks, s, len(STATS)),
                        dtype=torch.float32, device=device)
    for c in range(cfg.chunk_ticks):
        keys_t = [fold_in(k, state.tick) for k in seeds]
        state = tick_fn(state, keys_t, cfg, diag=diag)
        _stats_into(state.infected, state.msgs, stats[c])
    return state, stats


def _packed_scan_chunk_batch(state: PackedExactState, seed_keys,
                             cfg: HeadlineExactConfig, diag=None):
    return _scan_chunk_batch(state, seed_keys, cfg, packed_exact_tick, diag)


def _frontier_scan_chunk_batch(state: FrontierExactState, seed_keys,
                               cfg: HeadlineExactConfig, diag=None):
    return _scan_chunk_batch(state, seed_keys, cfg, frontier_exact_tick,
                             diag)


# -- the multi-device layouts -------------------------------------------
#
# Three layouts of the seed-batched state over a mesh (``mesh.Mesh``),
# each leaf row-sharded on its node axis (1) or replicated (None), as
# the reference's ``_exact_state_specs`` (:922), ``_frontier_state_specs``
# (:1322) and ``_frontier_host_specs`` (:1352) lay them out:
#
# * dense (``nodes``): every leaf, the [S, n_local, nb] bitmap
#   included, sharded; the active mask, the still-bad masks and, on
#   sync ticks, the infected mask cross as all_gathers of bool bytes;
# * frontier (``nodes``): only the ring sharded, every [S, N] leaf
#   replicated; only the still-bad masks cross;
# * host (``hosts``): tx / next_send / msgs sharded with the ring,
#   infected and pending replicated by construction; only the active
#   and still-bad masks cross, bitpacked.
#
# Draws are counter-based and replicated.  A shard runs its rows'
# rejection loops (``shard_round``), the layouts exchange the still-bad
# masks round by round as the reference's loop does, and every shard
# rebuilds every accepted tuple from the masks (``shard_commit``).  The
# layouts also gather for the per-tick statistics: dense the infected
# and msgs leaves, host the msgs leaf (measurement, charged as
# ``"stats"``).

DENSE_LAYOUT = PackedExactState(infected=1, tx=1, next_send=1, sent=1,
                                msgs=1, tick=None, pending=1)
FRONTIER_LAYOUT = FrontierExactState(infected=None, tx=None, next_send=None,
                                     ring=1, msgs=None, tick=None,
                                     pending=None)
HOST_LAYOUT = FrontierExactState(infected=None, tx=1, next_send=1, ring=1,
                                 msgs=1, tick=None, pending=None)


def _shard_send(sh: int, n: int, active_l, active, sent_l, triples,
                tick: int, p, diag, packed: bool, infected_t, pending_t,
                tx_b, next_send_b, msgs_b, tier):
    """A shard's broadcast phase (generator): its rows' rejection loops,
    the still-bad masks exchanged round by round (bool bytes, or
    bitpacked when ``packed``) until none is bad anywhere, each row's
    accepted round counted from them, then ``shard_commit``.  Returns
    the new infected window."""
    from corrosion_tpu_torch.kernels.fabric import bits_pack, bits_unpack
    from corrosion_tpu_torch.kernels.shard_exact import (
        shard_commit,
        shard_round,
    )
    from corrosion_tpu_torch.mesh import all_gather

    lo = sh * active_l.shape[1]
    rounds_l = shard_round(active_l, sent_l, triples, lo, n, p, diag, tick)
    accepted = torch.zeros(active.shape, dtype=torch.int32,
                           device=active.device)
    for r in range(MAX_ROUNDS):
        bad_l = rounds_l > r + 1
        if packed:
            wire = yield all_gather(bits_pack(bad_l), "delta", dim=1)
            bad = bits_unpack(wire, n)
        else:
            bad = yield all_gather(bad_l, "delta", dim=1)
        if not bool(bad.any()):
            break
        accepted += bad
    else:
        raise RuntimeError(f"shard_round: a row found no valid tuple in "
                           f"{MAX_ROUNDS} rejection rounds")
    return shard_commit(active, accepted, infected_t, pending_t, tx_b,
                        next_send_b, msgs_b, sent_l, triples, lo, tick, p,
                        tier)


def _dense_tick_local(sh: int, st: PackedExactState, keys, cfg, diag,
                      writer: int = 0):
    """One dense tick on shard ``sh``'s rows (generator): the port of
    ``_sharded_tick_local`` (reference :766)."""
    from corrosion_tpu_torch.mesh import all_gather

    infected_l, tx_l, next_send_l, sent_l, msgs_l, tick, pending_l = st
    n = cfg.n_nodes
    s, n_local = infected_l.shape
    lo = sh * n_local
    dev = infected_l.device
    tier = _rtt_tier_of(cfg, dev)
    tier_l = None if tier is None else tier[lo:lo + n_local]
    latency = _wan_latency_on(cfg)
    if latency:
        infected_l, tx_l, next_send_l, pending_l = _latency_promote(
            infected_l, tx_l, next_send_l, pending_l, tick, cfg, tier_l)
    active_l = infected_l & (tx_l > 0) & (next_send_l <= tick)
    active = yield all_gather(active_l, "active", dim=1)
    triples, k_sync = _tick_keys(keys)
    new_infected_l = infected_l
    if bool(active.any()):
        new_infected_l = yield from _shard_send(
            sh, n, active_l, active, sent_l, triples, tick,
            _send_params(cfg, False, writer), diag, False, infected_l,
            pending_l if latency else None, tx_l, next_send_l, msgs_l, tier)
        exact_commit(infected_l, new_infected_l, tx_l, next_send_l, tick,
                     cfg.max_transmissions, tier=tier_l)
    if _sync_due(cfg, tick):
        infected_all = yield all_gather(new_infected_l, "infected", dim=1)
        healed, pay = _sync_pull(
            infected_all, torch.zeros((s, n), dtype=torch.int32, device=dev),
            _sync_peers(k_sync, cfg, dev), cfg,
            part=_partition_of(cfg, dev), part_active=tick < cfg.heal_tick)
        new_infected_l = healed[:, lo:lo + n_local].contiguous()
        msgs_l += pay[:, lo:lo + n_local]
    return PackedExactState(new_infected_l, tx_l, next_send_l, sent_l,
                            msgs_l, tick + 1, pending_l)


def _dense_stats(sh: int, st: PackedExactState):
    from corrosion_tpu_torch.mesh import all_gather

    infected = yield all_gather(st.infected, "stats", dim=1)
    msgs = yield all_gather(st.msgs, "stats", dim=1)
    return infected, msgs


class _Layout(NamedTuple):
    kernel: str  # the result's kernel tag
    axis: str  # the mesh axis the layout shards over
    leaves: NamedTuple  # each leaf's shard axis, None where replicated
    tick_local: object  # generator (sh, leaves, keys, cfg, diag)
    stats: object  # generator (sh, leaves) -> ([S, N] infected, msgs)


def _layout(mesh, cfg: HeadlineExactConfig, sparse: bool,
            host_sharded: bool) -> _Layout:
    """The layout of a mesh run, after the reference's checks."""
    from corrosion_tpu_torch.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a corrosion_tpu_torch.mesh.Mesh, "
                         f"got {type(mesh).__name__}")
    axis = "hosts" if host_sharded else "nodes"
    if mesh.axis != axis:
        raise ValueError(f"this layout shards over a {axis!r} axis; the "
                         f"mesh has {mesh.axis!r}")
    if host_sharded:
        from corrosion_tpu_torch.models import sharded

        sharded._check_host_mesh(mesh, cfg)
        return _Layout("host-sparse", axis, HOST_LAYOUT,
                       sharded._sharded_frontier_host_tick_local,
                       sharded._host_stats)
    if cfg.n_nodes % mesh.size != 0:
        raise ValueError(f"n_nodes {cfg.n_nodes} must divide over "
                         f"{mesh.size} node shards")
    if sparse:
        from corrosion_tpu_torch.models import sharded

        return _Layout("sharded-sparse", axis, FRONTIER_LAYOUT,
                       sharded._sharded_frontier_tick_local,
                       sharded._frontier_stats)
    return _Layout("sharded-dense", axis, DENSE_LAYOUT, _dense_tick_local,
                   _dense_stats)


def _zero_diag(device) -> torch.Tensor:
    return torch.zeros(len(DIAG), dtype=torch.int64, device=device)


def _mesh_step(mesh, cfg: HeadlineExactConfig, layout: _Layout):
    def step(state, keys):
        """One tick of every shard: ``state`` a ``mesh.Sharded`` of this
        layout, ``keys`` the seeds' tick keys."""
        dev = mesh.device
        out = mesh.run(layout.tick_local, {
            sh: (state[sh], keys, cfg, _zero_diag(dev))
            for sh in mesh.local_shards})
        return state.replace(out, state.tick + 1)

    return step


def _mesh_chunk_local(sh: int, st, seed_keys, cfg, diag, layout: _Layout):
    s = len(seed_keys)
    stats = torch.empty((cfg.chunk_ticks, s, len(STATS)),
                        dtype=torch.float32, device=st.infected.device)
    for c in range(cfg.chunk_ticks):
        keys_t = [fold_in(k, st.tick) for k in seed_keys]
        st = yield from layout.tick_local(sh, st, keys_t, cfg, diag)
        infected, msgs = yield from layout.stats(sh, st)
        _stats_into(infected, msgs, stats[c])
    return st, stats


def _mesh_chunk(mesh, cfg: HeadlineExactConfig, layout: _Layout):
    def chunk(state, seed_keys, diags):
        """``cfg.chunk_ticks`` ticks of every shard; ``diags`` {shard:
        int64 [4]} accumulate each shard's rejection counters.  Returns
        (state, [C, S, len(STATS)] statistics, replicated: this
        process's first shard's)."""
        seeds = _key_rows(seed_keys)
        out = mesh.run(_mesh_chunk_local, {
            sh: (state[sh], seeds, cfg, diags[sh], layout)
            for sh in mesh.local_shards})
        first = out[mesh.local_shards[0]][1]
        return state.replace({sh: o[0] for sh, o in out.items()},
                             state.tick + cfg.chunk_ticks), first

    return chunk


def sharded_packed_exact_step(mesh, cfg: HeadlineExactConfig):
    """The dense layout's tick: ``step(state, keys) -> state`` on a
    ``mesh.Sharded`` laid out by ``DENSE_LAYOUT`` (``convert.shard_state``)
    over ``mesh``'s ``nodes`` axis; ``keys`` the seeds' tick keys.
    Bitwise ``packed_exact_tick`` per seed."""
    return _mesh_step(mesh, cfg, _layout(mesh, cfg, False, False))


def make_sharded_exact_chunk(mesh, cfg: HeadlineExactConfig):
    """The dense layout's chunk: ``chunk(state, seed_keys, diags) ->
    (state, stats)`` (the infected and msgs leaves gathered for the
    statistics)."""
    return _mesh_chunk(mesh, cfg, _layout(mesh, cfg, False, False))


def _combined_diag(mesh, diags: dict) -> np.ndarray:
    """The run's rejection counters over every shard (one small gather
    across processes, charged as ``"stats"``)."""
    from corrosion_tpu_torch.mesh import all_gather

    def local(sh, diag):
        got = yield all_gather(diag[None], "stats")
        return got

    per = next(iter(mesh.run(local, {sh: (diags[sh],)
                                     for sh in mesh.local_shards}).values()))
    per = per.cpu().numpy()
    return np.array([per[:, 0].sum(), per[:, 1].sum(), per[:, 2].max(),
                     per[:, 3].sum()], np.int64)


# the budget the batch policies assume where none is given and the
# device has nothing to ask (the CPU): the reference's default
CPU_BUDGET_BYTES = 8 << 30


def exact_seed_batch(cfg: HeadlineExactConfig, n_seeds: int,
                     n_shards: int = 1,
                     hbm_budget_bytes: Optional[int] = None) -> int:
    """How many seed universes of ``[N, ceil(N/8)]`` bitmaps, row-sharded
    over ``n_shards`` devices, fit a device's budget side by side; the
    2x covers an out-of-place bitmap update, as in the reference."""
    nb = -(-cfg.n_nodes // 8)
    per_seed = (cfg.n_nodes // max(1, n_shards)) * nb
    budget = (CPU_BUDGET_BYTES if hbm_budget_bytes is None
              else hbm_budget_bytes)
    fit = max(1, int(budget // max(1, 2 * per_seed)))
    return max(1, min(n_seeds, fit, 32))


def frontier_seed_batch(cfg: HeadlineExactConfig, n_seeds: int,
                        n_shards: int = 1,
                        hbm_budget_bytes: Optional[int] = None,
                        host_sharded: bool = False) -> int:
    """The frontier kernel's policy a device: the ring at N * cap * 4
    bytes over the shards plus 20 B/node of replicated dense leaves a
    seed; with ``host_sharded`` 12 B/node of them shard with the ring
    and only infected and pending (5 B/node) replicate.  Without a
    budget: ``CPU_BUDGET_BYTES`` (the reference reads a host's free
    memory for the host layout)."""
    cap = frontier_ring_cap(cfg)
    shards = max(1, n_shards)
    if host_sharded:
        per_seed = (cfg.n_nodes // shards) * (cap * 4 + 12) + cfg.n_nodes * 5
    else:
        per_seed = (cfg.n_nodes // shards) * cap * 4 + cfg.n_nodes * 20
    budget = (CPU_BUDGET_BYTES if hbm_budget_bytes is None
              else hbm_budget_bytes)
    fit = max(1, int(budget // max(1, 2 * per_seed)))
    return max(1, min(n_seeds, fit, 32))


def _budget(device: torch.device, hbm_budget_bytes: Optional[int]):
    """(bytes, source) of the seed-batch budget: the caller's; on a card
    half of its free memory, counting the bytes PyTorch's allocator
    holds cached (free to it, not to ``mem_get_info``), so a second run
    in one process batches as the first did; or the CPU default."""
    if hbm_budget_bytes is not None:
        return int(hbm_budget_bytes), "explicit"
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return (free + cached) // 2, "cuda_mem_get_info_free+cached/2"
    return CPU_BUDGET_BYTES, "cpu_default_8GiB"


def run_exact_headline(
    cfg: HeadlineExactConfig, n_seeds: int = 4, seed: int = 0,
    mesh=None, seed_batch: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    kernel: str = "dense",
    host_sharded: bool = False,
    device=None,
) -> Dict:
    """Seed-parallel exact-sampler epidemics at headline scale.

    Seeds run in batches sized by ``exact_seed_batch`` /
    ``frontier_seed_batch`` from ``hbm_budget_bytes`` (by default half
    of the card's free memory, the allocator's cache counted); seed s
    of the run has the key ``PRNGKey(seed * 10007 + s)`` and its init
    ``fold_in(key, 2**20)``.
    ``kernel`` selects the representation, ``"dense"`` (the bitmap) or
    ``"sparse"`` (the rings); per-seed trajectories are bitwise equal
    either way.

    ``mesh`` (a ``corrosion_tpu_torch.mesh.Mesh``) runs the state
    row-sharded over its ``nodes`` axis (``sharded-dense`` /
    ``sharded-sparse``), or with ``host_sharded`` (sparse only) over its
    ``hosts`` axis in the multi-host layout (``host-sparse``; N must
    split into byte-aligned rows, N % (8 * hosts) == 0).  The mesh's
    fabric holds the leaves on its own device; a ``device`` given beside
    a mesh must be that device.  Without a mesh ``device`` defaults to
    the card.
    Per-seed trajectories equal the single-device run's.  The budget is
    a device's: under a ``LocalFabric`` every shard's bytes, replicated
    leaves included, land on the one card, so the batch policy gets the
    card's budget divided by the shard count — a replicated leaf counts
    D times.

    Returns the reference's keys (msgs and ticks at each seed's own
    convergence tick, ``delivery_model: exact``, ``kernel``,
    ``n_shards``, ``n_hosts``) plus the per-seed values
    (``seed_ticks``, ``seed_msgs_mean``, ``seed_msgs_p99``), the budget
    and its source, the rejection rounds of the run (``rejection``:
    active rows, mean and max rounds per active row) and, with a mesh,
    the bytes and calls the fabric moved in the run (``fabric``)."""
    if kernel not in ("dense", "sparse"):
        raise ValueError(f"unknown kernel {kernel!r}")
    sparse = kernel == "sparse"
    if host_sharded and (not sparse or mesh is None):
        raise ValueError(
            "host_sharded needs kernel='sparse' and a mesh with a "
            "'hosts' axis"
        )
    layout = None
    if mesh is not None:
        layout = _layout(mesh, cfg, sparse, host_sharded)
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(
                f"device {device!r} differs from the mesh's device "
                f"{mesh.device}")
        device = mesh.device
    else:
        device = resolve_device("cuda" if device is None else device)
    n_shards = 1 if mesh is None else mesh.size
    t0 = time.perf_counter()
    budget, source = _budget(device, hbm_budget_bytes)
    shard_budget = budget // (1 if mesh is None else mesh.fabric.colocated)
    if sparse:
        sb = seed_batch or frontier_seed_batch(
            cfg, n_seeds, n_shards, shard_budget, host_sharded=host_sharded)
    else:
        sb = seed_batch or exact_seed_batch(cfg, n_seeds, n_shards,
                                            shard_budget)
    init_fn = frontier_exact_init if sparse else packed_exact_init
    if mesh is None:
        chunk_fn = _frontier_scan_chunk_batch if sparse else (
            _packed_scan_chunk_batch)
    else:
        from corrosion_tpu_torch.convert import shard_state

        chunk_fn = _mesh_chunk(mesh, cfg, layout)
        moved0 = dict(mesh.fabric.bytes), dict(mesh.fabric.calls)
    firsts: List[float] = []
    means: List[float] = []
    p99s: List[float] = []
    converged = 0
    diag_total = np.zeros(len(DIAG), np.int64)
    for lo in range(0, n_seeds, sb):
        s = min(sb, n_seeds - lo)
        base_keys = [PRNGKey(seed * 10_007 + i) for i in range(lo, lo + s)]
        state = None  # the last batch's buffers go before the next's
        state = init_fn(cfg, [fold_in(k, 2**20) for k in base_keys],
                        device=device)
        if mesh is not None:
            state = shard_state(state, layout.leaves, mesh)
            diag = {sh: _zero_diag(device) for sh in mesh.local_shards}
        else:
            diag = _zero_diag(device)
        chunks: List[np.ndarray] = []
        ticks_done = 0
        while ticks_done < cfg.max_ticks:
            if mesh is None:
                state, stats = chunk_fn(state, base_keys, cfg, diag=diag)
                d = diag.cpu().numpy()
            else:
                state, stats = chunk_fn(state, base_keys, diag)
                d = sum(v.cpu().numpy() for v in diag.values())
            stats = stats.cpu().numpy().transpose(1, 0, 2)  # [S, C, ...]
            raise_on_overflow(stats)
            raise_on_capped(d)
            chunks.append(stats)
            ticks_done += cfg.chunk_ticks
            if (stats[:, -1, CONVERGED] == 1.0).all():
                break
        if mesh is not None:
            d = _combined_diag(mesh, diag)
        diag_total[:3] += d[:3]
        diag_total[2] = max(diag_total[2], d[2])
        allstats = np.concatenate(chunks, axis=1)
        conv_mask, first, (m_at, p_at) = stats_at_convergence(
            allstats[:, :, CONVERGED] == 1.0, allstats[:, :, MSGS_MEAN],
            allstats[:, :, MSGS_P99])
        converged += int(conv_mask.sum())
        firsts.extend(float(x) for x in first)
        means.extend(float(x) for x in m_at)
        p99s.extend(float(x) for x in p_at)
    out = {
        "n_nodes": cfg.n_nodes,
        "n_seeds": n_seeds,
        "delivery_model": "exact",
        "kernel": kernel if layout is None else layout.kernel,
        "n_hosts": n_shards if host_sharded else 1,
        "converged_frac": converged / n_seeds,
        "ticks_p50": float(np.percentile(firsts, 50)),
        "ticks_p99": float(np.percentile(firsts, 99)),
        "msgs_per_node_mean": float(np.mean(means)),
        "msgs_per_node_p99": float(np.mean(p99s)),
        "seed_batch": sb,
        "n_shards": n_shards,
        "wall_s": time.perf_counter() - t0,
        "seed_ticks": firsts,
        "seed_msgs_mean": means,
        "seed_msgs_p99": p99s,
        "budget_bytes": budget,
        "budget_source": source,
        "rejection": {
            "active_rows": int(diag_total[0]),
            "rounds_mean": (float(diag_total[1] / diag_total[0])
                            if diag_total[0] else 0.0),
            "rounds_max": int(diag_total[2]),
        },
    }
    if mesh is not None:
        out["fabric"] = {
            kind: {"bytes": mesh.fabric.bytes[kind] - moved0[0].get(kind, 0),
                   "calls": mesh.fabric.calls[kind] - moved0[1].get(kind, 0)}
            for kind in mesh.fabric.bytes}
    return out
