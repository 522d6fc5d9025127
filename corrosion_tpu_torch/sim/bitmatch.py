"""Bit-match of the simulator against the real agents (the exactness
half of the north star).

``agent/det.py`` runs N real agents — real CRR storage, real speedy
bytes, real ingest, real sync-need allocation and serving — under a
discrete-event tick scheduler with seeded PRNG streams.  This module is
the **simulator side**: a deterministic replay of the same protocol
model the JAX epidemic kernel implements (per-payload ``sent_to``
exclusion, retransmit-decay budget, backoff-scheduled retransmissions,
rebroadcast-on-learn, ring0-first fanout, per-message loss, periodic
anti-entropy — the headline shape of ``sim/epidemic.py``), drawing
every random decision from the *same* per-node PRNG streams.

The two sides share exactly two pure functions — ``det_seed_for`` (the
per-node stream seed) and ``det_backoff_gap`` (tick backoff) — plus the
sampling *conventions* (``Members.sample``: population in ascending node
index, exclusion filtered before the split, ring0 tier uncapped first;
``_choose_sync_peers``: 2x candidate sample, stable sort by (need,
last-sync, rtt)).  Everything else — who is infected, who may send,
what each ``sent_to`` contains, when budgets exhaust, which server a
sync need is allocated to, every broadcast and sync message count — is
computed independently: the agents through their
storage/bookkeeping/wire/sync pipeline, the sim through this array
state machine.  One diverging decision desynchronizes the PRNG streams
and every later tick, so per-tick equality of infected sets and
per-node message counts is a sharp equivalence test of the protocol
semantics, not a replay of recorded outputs.

``run_bitmatch`` produces the ``BITMATCH_N{64,256}.json`` artifacts
(wired into ``bench.py``), now in the HEADLINE protocol shape: ring0
on, loss on, anti-entropy sync every 8 ticks — the same parameter
family as the benchmarked 100k-node epidemic, not a simplified
fanout-only protocol.

Reference anchors: sent_to sampling + ring0 tier
``broadcast/mod.rs:586-702``, retransmit requeue ``:745-765``,
rebroadcast-on-learn ``handlers.rs:939-949``, sync client round + need
allocation ``peer.rs:1039-1466``.

A copy of ``corrosion_tpu/sim/bitmatch.py`` re-rooted on this package.
The replay is pure Python; only the agents' side touches ``device``.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Set, Tuple

from corrosion_tpu_torch.agent.det import (
    FAR_RTT_MS,
    RING0_RTT_MS,
    DetCluster,
    DetParams,
    det_backoff_gap,
    det_seed_for,
    run_det_epidemic,
)


def det_sim_epidemic(params: DetParams, origin: int) -> Dict:
    """Deterministic replay: the simulator's protocol state machine on
    the shared PRNG streams.  Same trace shape as ``run_det_epidemic``.
    """
    n = params.n_nodes
    rngs = [random.Random(det_seed_for(params.seed, i)) for i in range(n)]
    return _det_sim_epidemic_with_rngs(params, origin, rngs, {}, 0)


def diff_det_traces(sim: Dict, agents: Dict) -> Dict:
    """Tick-for-tick equality of infected sets and per-node broadcast
    AND sync message counts."""
    s_ticks, a_ticks = sim["ticks"], agents["ticks"]
    first_mismatch: Optional[int] = None
    detail: Optional[str] = None
    for t in range(max(len(s_ticks), len(a_ticks))):
        if t >= len(s_ticks) or t >= len(a_ticks):
            first_mismatch = t
            detail = (
                f"trace lengths differ: sim {len(s_ticks)} vs "
                f"agents {len(a_ticks)}"
            )
            break
        if s_ticks[t]["infected"] != a_ticks[t]["infected"]:
            first_mismatch, detail = t, "infected sets differ"
            break
        if s_ticks[t]["msgs"] != a_ticks[t]["msgs"]:
            first_mismatch, detail = t, "per-node msg counts differ"
            break
        if s_ticks[t].get("sync_msgs") != a_ticks[t].get("sync_msgs"):
            first_mismatch, detail = t, "per-node sync msg counts differ"
            break
    return {
        "match": first_mismatch is None,
        "ticks_compared": len(s_ticks),
        "converged_tick_sim": sim["converged_tick"],
        "converged_tick_agents": agents["converged_tick"],
        "first_mismatch_tick": first_mismatch,
        "mismatch_detail": detail,
    }


def run_bitmatch(
    n: int,
    writes: int = 2,
    seed: int = 0,
    fanout: int = 3,
    max_transmissions: int = 5,
    backoff_ticks: float = 2.5,
    loss: float = 0.0,
    ring0_size: int = 0,
    sync_interval: int = 0,
    sync_peers: int = 3,
    out_path: Optional[str] = None,
    base_dir: Optional[str] = None,
    device: str = "cuda",
    device_cache: Optional[bool] = None,
) -> Dict:
    """Run ``writes`` sequential epidemics on both sides and diff them.

    Each write starts from a different origin on the SAME deterministic
    cluster (state carries over, as it does in a real cluster); the sim
    side replays each epidemic with fresh single-payload state but the
    continuing PRNG streams, last-sync ordering, and tick offset —
    exactly what the agents' scheduler does, since a quiesced payload
    leaves no queue state behind but the members' sync bookkeeping and
    the absolute tick (which gates the sync cadence) persist.

    The agents run on ``device`` with ``device_cache`` (``DetCluster``).
    """
    params = DetParams(
        n_nodes=n, fanout=fanout, max_transmissions=max_transmissions,
        backoff_ticks=backoff_ticks, seed=seed, loss=loss,
        ring0_size=ring0_size, sync_interval=sync_interval,
        sync_peers=sync_peers,
    )
    cluster = DetCluster(params, base_dir=base_dir, device=device,
                         device_cache=device_cache)
    rngs = [random.Random(det_seed_for(seed, i)) for i in range(n)]
    last_sync: Dict[Tuple[int, int], float] = {}
    per_write = []
    try:
        for w in range(writes):
            origin = (w * (n // max(writes, 1))) % n
            tick0 = cluster.tick_no
            agents_trace = run_det_epidemic(cluster, origin, write_id=w)
            assert cluster.quiescent(), "epidemic did not quiesce"
            if sync_interval > 0:
                # the sim's cross-write sync model assumes previous
                # epidemics fully converged (everyone holds every prior
                # actor's head, so prior actors generate no needs)
                assert agents_trace["converged_tick"] is not None, (
                    "epidemic did not converge within max_ticks"
                )
            sim_trace = _det_sim_epidemic_with_rngs(
                params, origin, rngs, last_sync, tick0
            )
            d = diff_det_traces(sim_trace, agents_trace)
            per_write.append({
                "origin": origin,
                **d,
                "msgs_total": (
                    sum(agents_trace["ticks"][-1]["msgs"])
                    if agents_trace["ticks"] else 0
                ),
                "sync_msgs_total": (
                    sum(agents_trace["ticks"][-1].get("sync_msgs", []))
                    if agents_trace["ticks"] else 0
                ),
            })
    finally:
        cluster.close()

    result = {
        "metric": "bitmatch_sim_vs_agents",
        "n_nodes": n,
        "writes": writes,
        "seed": seed,
        "fanout": fanout,
        "max_transmissions": max_transmissions,
        "backoff_ticks": backoff_ticks,
        "loss": loss,
        "ring0_size": ring0_size,
        "sync_interval": sync_interval,
        "sync_peers": sync_peers,
        "bitmatch": all(p["match"] for p in per_write),
        "per_write": per_write,
        "conditions": {
            "agents": (
                "real Agent objects (CRR storage, speedy wire bytes, "
                "seen-cache ingest, real sync-need allocation/serving) "
                "under the discrete-event scheduler"
            ),
            "sim": (
                "deterministic replay of the headline protocol model "
                "(ring0-first fanout, per-message loss, track_sent "
                "exclusion, periodic anti-entropy)"
            ),
            "shared": "per-node PRNG streams + tick-backoff mapping",
        },
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _det_sim_epidemic_with_rngs(
    params: DetParams,
    origin: int,
    rngs: List[random.Random],
    last_sync: Dict[Tuple[int, int], float],
    tick0: int,
) -> Dict:
    """Core replay loop parameterized by live PRNG objects, the
    carried-over last-sync ordering state, and the cluster's absolute
    tick offset (the sync cadence runs on absolute ticks)."""
    n, k, max_tx = params.n_nodes, params.fanout, params.max_transmissions
    r0 = params.ring0_size
    infected = [False] * n
    infected[origin] = True
    remaining = [0] * n
    remaining[origin] = max_tx
    next_due = [tick0] * n
    sent_to: List[Set[int]] = [set() for _ in range(n)]
    active = [False] * n
    active[origin] = True
    msgs = [0] * n
    sync_msgs = [0] * n

    def same_block(i: int, j: int) -> bool:
        return r0 > 0 and i // r0 == j // r0

    def rtt(i: int, j: int) -> float:
        if r0 <= 0:
            return float("inf")  # no samples recorded -> rtt None
        return RING0_RTT_MS if same_block(i, j) else FAR_RTT_MS

    trace: List[Dict] = []
    converged_tick: Optional[int] = None
    for lt in range(params.max_ticks):
        t = tick0 + lt  # absolute cluster tick
        # -- send phase (ascending index, one PRNG stream per node) ---
        deliveries: List[int] = []
        for i in range(n):
            if not active[i] or next_due[i] > t or remaining[i] < 1:
                continue
            pop = [j for j in range(n) if j != i and j not in sent_to[i]]
            # ring0-first exactly when the agent does: a LOCAL payload's
            # first transmission (Members.sample ring0_first branch:
            # ALL ring0 peers uncapped + k sampled from the rest; the
            # rest-sample consumes the stream even when it fits)
            if r0 > 0 and i == origin and not sent_to[i]:
                ring0 = [j for j in pop if same_block(i, j)]
                rest = [j for j in pop if not same_block(i, j)]
                targets = ring0 + rngs[i].sample(rest, min(len(rest), k))
            elif len(pop) <= k:
                targets = pop
            else:
                targets = rngs[i].sample(pop, k)
            if not targets:
                active[i] = False
                continue
            for j in targets:
                sent_to[i].add(j)
                # one loss draw per target, in sample order, from the
                # sender's stream — mirrors DetCluster.tick exactly
                if params.loss > 0.0 and rngs[i].random() < params.loss:
                    continue
                deliveries.append(j)
            msgs[i] += len(targets)
            remaining[i] -= 1
            if remaining[i] < 1:
                active[i] = False
            else:
                send_count = max_tx - remaining[i]
                next_due[i] = t + det_backoff_gap(
                    params.backoff_ticks, send_count
                )
        # -- delivery phase (end of tick; learners first send next tick)
        for j in deliveries:
            if not infected[j]:
                infected[j] = True
                active[j] = True
                remaining[j] = max_tx
                next_due[j] = t + 1
        # -- anti-entropy phase (kernel cadence, absolute ticks) -------
        if (
            params.sync_interval > 0
            and t % params.sync_interval == params.sync_interval - 1
        ):
            for i in range(n):
                _sim_sync_round(
                    params, i, t, rngs, infected, sync_msgs, last_sync,
                    rtt, origin,
                )
        trace.append({
            "infected": [i for i in range(n) if infected[i]],
            "msgs": list(msgs),
            "sync_msgs": list(sync_msgs),
        })
        if converged_tick is None and all(infected):
            converged_tick = lt
        if not any(active) and (
            params.sync_interval <= 0 or converged_tick is not None
        ):
            break
    return {
        "origin": origin,
        "ticks": trace,
        "converged_tick": converged_tick,
    }


def _sim_sync_round(
    params: DetParams,
    i: int,
    t: int,
    rngs: List[random.Random],
    infected: List[bool],
    sync_msgs: List[int],
    last_sync: Dict[Tuple[int, int], float],
    rtt,
    origin: int,
) -> None:
    """The replay of one client sync round — mirrors
    ``DetCluster._det_sync_round`` decision for decision.

    Knowledge model: the current epidemic's payload is all a sync can
    move (prior writes fully converged — asserted by ``run_bitmatch`` —
    so prior actors' heads are equal everywhere and generate no needs;
    ``need_len_for_actor`` is 0 for every peer because single-version
    histories have no recorded gaps)."""
    n = params.n_nodes
    peers = [j for j in range(n) if j != i]
    desired = max(min(len(peers) // 100, 10), min(3, len(peers)))
    desired = min(desired, params.sync_peers)
    cands = rngs[i].sample(peers, min(desired * 2, len(peers)))
    cands.sort(key=lambda j: (0, last_sync.get((i, j), 0.0), rtt(i, j)))
    chosen = cands[:desired]
    if not chosen:
        return
    for j in chosen:
        sync_msgs[i] += 2  # BiPayload + Clock
        sync_msgs[j] += 2  # State + Clock
    if not infected[i]:
        # the single need (current actor, full head range) is allocated
        # to the FIRST session whose server advertises it; one Request
        # frame from the client, one served changeset frame back
        for j in chosen:
            if infected[j]:
                sync_msgs[i] += 1
                sync_msgs[j] += 1
                infected[i] = True
                break
    for j in chosen:
        last_sync[(i, j)] = float(t)
