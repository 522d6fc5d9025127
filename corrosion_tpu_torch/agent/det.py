"""Deterministic discrete-event mode for the agent runtime.

The north star (BASELINE.json) has two halves: the 100k-node epidemic
under 60 s (performance — ``bench.py``) and **bit-matching** the real
agent cluster at N≤256.  The distributional calibration
(``sim/simdiff.py``) compares percentiles; this module makes the
comparison *exact*: the real agents run under a seeded PRNG and a
discrete-event **tick scheduler** instead of wall-clock timers, so the
epidemic's delivery schedule is a pure function of (seed, parameters) —
and the simulator's deterministic replay (``sim/bitmatch.py``) must
reproduce the per-tick infected sets and per-node message counts
**exactly**, tick for tick.

What is real here (the whole point): agents are full ``Agent`` objects —
real SQLite storage with CRR triggers, real bookkeeping, real speedy
wire bytes (``encode_broadcast_frame``/``decode_uni_frame``, the same
methods the live socket loops use), real ``handle_change`` ingest with
seen-cache dedup and rebroadcast-on-learn, real ``Members.sample`` peer
selection.  What the scheduler replaces is exactly the *timing layer*:
sockets become synchronous frame hand-offs, and the broadcast loop's
wall-clock arithmetic (``rebroadcast_delay * send_count`` requeues,
``broadcast/mod.rs:745-765``) becomes tick arithmetic
(``det_backoff_gap``), the same mapping the simulator's
``backoff_ticks`` models.

Tick semantics (matching ``models/broadcast.py`` with ``track_sent``):

* a tick has a **send phase** — every agent, in index order, flushes
  its due payloads, sampling fanout targets from its own seeded PRNG
  with per-payload ``sent_to`` exclusion — and a **delivery phase** —
  all frames sent this tick are decoded and applied; deliveries never
  influence sends of the same tick (synchronous rounds);
* a payload learned during tick t's delivery phase is first eligible to
  forward at tick t+1;
* the nth retransmission of a payload waits ``det_backoff_gap(n)``
  ticks; a payload whose eligible-peer set is exhausted retires.

Cited reference behavior: fanout sampling and sent_to exclusion
``crates/corro-agent/src/broadcast/mod.rs:586-702``, retransmit requeue
``:745-765``, rebroadcast-on-learn ``handlers.rs:939-949``.

A copy of ``corrosion_tpu/agent/det.py`` re-rooted on this package: the
cluster's agents run on ``device`` (default ``"cuda"``, each agent's
clock cache on the card) with the reference's config.
"""

from __future__ import annotations

import asyncio
import random
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from corrosion_tpu_torch.agent.runtime import Agent, AgentConfig, ChangeSource
from corrosion_tpu_torch.agent.testing import TEST_SCHEMA
from corrosion_tpu_torch.bridge import speedy


def det_seed_for(seed: int, index: int) -> int:
    """Per-node PRNG stream seed — shared with the sim replay so both
    sides draw identical sample sequences."""
    return seed * 1_000_003 + index


def det_backoff_gap(backoff_ticks: float, send_count: int) -> int:
    """Ticks until a payload's next retransmission after its nth send —
    the tick-grid form of the reference's ``100ms * send_count`` requeue
    (and our live loop's ``rebroadcast_delay * send_count``); shared
    with the sim replay."""
    return max(1, round(backoff_ticks * send_count))


class _SyncLoop:
    """Stand-in event loop for un-started agents: callbacks run inline,
    synchronously — the discrete-event scheduler owns all ordering."""

    def call_soon_threadsafe(self, fn, *args):
        fn(*args)

    def time(self) -> float:
        return 0.0


@dataclass
class _Entry:
    """One pending broadcast payload on one agent (the det-mode form of
    the live loop's ``pending`` tuples)."""

    cv: object
    frame: bytes
    remaining: int
    next_due: int
    sent_to: Set[bytes] = field(default_factory=set)


@dataclass(frozen=True)
class DetParams:
    n_nodes: int
    fanout: int = 3
    max_transmissions: int = 5
    backoff_ticks: float = 2.5
    seed: int = 0
    max_ticks: int = 512
    # headline-protocol extensions (all off by default so the base
    # fanout+backoff bit-match keeps its original shape):
    # per-message delivery drop probability; drawn from the SENDER's
    # PRNG stream, one uniform per target in sample order — the sender
    # still records sent_to and counts the message (it cannot know the
    # frame died downstream), so loss is healed by retransmissions and
    # anti-entropy, exactly the live semantics
    loss: float = 0.0
    # >0 enables ring0-first fanout: peers in the same aligned block of
    # this width are the <6ms RTT tier (rtt 1ms vs 50ms elsewhere) —
    # the deterministic form of the sim kernel's contiguous-block ring0
    ring0_size: int = 0
    # >0 runs one anti-entropy round (every agent, index order) at the
    # end of each tick t where t % sync_interval == sync_interval - 1,
    # matching the JAX kernel's cadence (sim/epidemic.py epidemic_tick)
    sync_interval: int = 0
    sync_peers: int = 3


RING0_RTT_MS = 1.0
FAR_RTT_MS = 50.0


class _CollectWriter:
    """Fake StreamWriter: collects the frames _serve_need writes."""

    def __init__(self):
        self.chunks: List[bytes] = []

    def write(self, b: bytes) -> None:
        self.chunks.append(b)

    async def drain(self) -> None:
        pass

    def close(self) -> None:
        pass


class DetCluster:
    """N real agents under the discrete-event tick scheduler."""

    def __init__(self, params: DetParams, base_dir: Optional[str] = None,
                 device: str = "cuda",
                 device_cache: Optional[bool] = None):
        self.params = params
        self._own_dir = base_dir is None
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="corro-det-")
        self.agents: List[Agent] = []
        for i in range(params.n_nodes):
            cfg = AgentConfig(
                db_path=f"{self.base_dir}/n{i}.db",
                schema_sql=TEST_SCHEMA,
                fanout=params.fanout,
                max_transmissions=params.max_transmissions,
                sync_peers=params.sync_peers,
                subs_enabled=False,
                ring0_enabled=params.ring0_size > 0,
                debug_hops=False,
                device=device,
                device_cache=device_cache,
            )
            a = Agent(cfg)
            # the deterministic PRNG stream replaces the actor-id seed;
            # _SyncLoop makes queue-or-defer paths run inline
            a._rng = random.Random(det_seed_for(params.seed, i))
            a._loop = _SyncLoop()
            self.agents.append(a)
        # full static membership in index order: every agent's members
        # dict — and therefore Members.sample's population ordering —
        # lists peers in ascending node index (the sim replay mirrors
        # this exact ordering)
        for a in self.agents:
            for b in self.agents:
                if a is not b:
                    a.members.upsert(b.actor_id, ("det", 0))
        if params.ring0_size > 0:
            # deterministic RTT tiers: same aligned block → ring0
            for i, a in enumerate(self.agents):
                for j, b in enumerate(self.agents):
                    if a is b:
                        continue
                    same = i // params.ring0_size == j // params.ring0_size
                    a.members.record_rtt(
                        b.actor_id, RING0_RTT_MS if same else FAR_RTT_MS
                    )
        self._index_of: Dict[bytes, int] = {
            a.actor_id: i for i, a in enumerate(self.agents)
        }
        self._entries: List[Dict[tuple, _Entry]] = [
            {} for _ in range(params.n_nodes)
        ]
        self.msgs = [0] * params.n_nodes
        self.sync_msgs = [0] * params.n_nodes
        self.tick_no = 0

    # -- workload ------------------------------------------------------

    def write(self, origin: int, sql: str, args: tuple = ()) -> int:
        """One local write on ``origin``; returns its version.  The
        broadcast enters origin's queue and first flushes on the next
        ``tick()`` (same next-flush latency the live loop gives a fresh
        payload)."""
        res = self.agents[origin].execute_transaction([(sql, args)])
        return res["version"]

    # -- the scheduler -------------------------------------------------

    def _drain_queues(self) -> None:
        """Queued broadcasts (local writes + rebroadcasts-on-learn from
        the previous delivery phase) become due entries this tick."""
        for i, a in enumerate(self.agents):
            while not a._bcast_queue.empty():
                cv, remaining, hop, tp, sig = a._bcast_queue.get_nowait()
                key = a._seen_key(cv)
                if key in self._entries[i]:
                    continue
                self._entries[i][key] = _Entry(
                    cv=cv,
                    frame=a.encode_broadcast_frame(cv, hop, tp, sig),
                    remaining=remaining,
                    next_due=self.tick_no,
                )

    def tick(self) -> int:
        """One protocol round; returns the number of messages sent."""
        p = self.params
        t = self.tick_no
        self._drain_queues()
        deliveries: List[Tuple[int, bytes]] = []
        for i, a in enumerate(self.agents):
            entries = self._entries[i]
            for key in list(entries):
                e = entries[key]
                if e.next_due > t or e.remaining < 1:
                    continue
                # ring0-first exactly when the live loop does: a LOCAL
                # payload's first transmission (runtime.py flush():
                # ring0_enabled and local and not sent_to)
                local = e.cv.actor_id.bytes == a.actor_id
                targets = a.members.sample(
                    p.fanout, a._rng,
                    ring0_first=(
                        p.ring0_size > 0 and local and not e.sent_to
                    ),
                    exclude=e.sent_to,
                )
                if not targets:
                    # coverage exhausted: every alive peer already got it
                    del entries[key]
                    continue
                for m in targets:
                    e.sent_to.add(m.actor_id)
                    # one loss draw per target, in sample order, from
                    # the sender's stream (the shared-stream invariant)
                    if p.loss > 0.0 and a._rng.random() < p.loss:
                        continue
                    deliveries.append((self._index_of[m.actor_id], e.frame))
                self.msgs[i] += len(targets)
                e.remaining -= 1
                if e.remaining < 1:
                    del entries[key]
                else:
                    send_count = p.max_transmissions - e.remaining
                    e.next_due = t + det_backoff_gap(
                        p.backoff_ticks, send_count
                    )
        # delivery phase: the real wire + ingest path, applied after all
        # sends so same-tick deliveries can't influence same-tick sends
        sent = len(deliveries)
        for dest, frame in deliveries:
            a = self.agents[dest]
            for payload in speedy.FrameReader().feed(frame):
                decoded = a.decode_uni_frame_meta(payload)
                if decoded is not None:
                    cv, tp, hop, sig = decoded
                    a.handle_change(cv, ChangeSource.BROADCAST,
                                    meta=(tp, hop, sig, None))
        # anti-entropy phase on the kernel's cadence
        # (sim/epidemic.py: tick % sync_interval == sync_interval - 1),
        # after deliveries so sync sees this tick's learned state
        if p.sync_interval > 0 and t % p.sync_interval == p.sync_interval - 1:
            for i in range(p.n_nodes):
                self._det_sync_round(i, t)
        self.tick_no += 1
        return sent

    # -- deterministic anti-entropy ------------------------------------

    def _det_sync_round(self, i: int, tick: int) -> None:
        """One client sync round for agent ``i`` — the synchronous form
        of ``parallel_sync`` (runtime.py:1681): REAL ``generate_sync``
        states, REAL ``_choose_sync_peers`` (consuming the agent's det
        PRNG stream), REAL cross-peer ``_allocate_needs``, REAL
        ``_serve_need`` on the server (down to the speedy frame bytes)
        and REAL ``handle_change(…, SYNC)`` ingest on the client.  What
        the scheduler replaces is the socket/timing layer: handshakes
        are direct state reads, ``last_sync_ts`` advances in ticks, and
        clients run sequentially in index order (each fully ingesting
        before the next starts, so one sync tick can chain heals —
        matching the replay's sequential model).

        Message accounting (``sync_msgs``): 2 handshake frames per side
        per session (BiPayload+Clock / State+Clock), plus the client's
        Request frames and the server's served changeset frames — all
        counted from the real frames where frames exist.
        """
        a = self.agents[i]
        ours = a.generate_sync()
        chosen = a._choose_sync_peers(ours)
        if not chosen:
            return
        sessions = []
        for m in chosen:
            j = self._index_of[m.actor_id]
            sessions.append({
                "member": m,
                "theirs": self.agents[j].generate_sync(),
                "j": j,
            })
            self.sync_msgs[i] += 2  # BiPayload + Clock
            self.sync_msgs[j] += 2  # State + Clock
        a._allocate_needs(sessions, ours)
        for s in sessions:
            server = self.agents[s["j"]]
            batches = list(a._request_batches(s["needs"]))
            served: List = []
            if batches:
                w = _CollectWriter()
                sess = {"chunk": server.SYNC_CHUNK_MAX}

                async def serve_all():
                    for batch in batches:
                        for actor, needs in batch:
                            for need in needs:
                                await server._serve_need(
                                    w, actor.bytes, need, sess
                                )

                # one private event loop per session (not per need)
                asyncio.run(serve_all())
                reader = speedy.FrameReader()
                for payload in reader.feed(b"".join(w.chunks)):
                    served.append(speedy.decode_sync_message(payload))
            self.sync_msgs[i] += len(batches)
            self.sync_msgs[s["j"]] += len(served)
            for msg in served:
                if hasattr(msg, "actor_id"):  # ChangeV1
                    a.handle_change(msg, ChangeSource.SYNC)
            a.members.update_sync_ts(s["member"].actor_id, float(tick))

    def quiescent(self) -> bool:
        return all(not e for e in self._entries) and all(
            a._bcast_queue.empty() for a in self.agents
        )

    def infected(self, origin: int, version: int) -> List[int]:
        """Nodes holding ``version`` from ``origin`` (origin included)."""
        origin_actor = self.agents[origin].actor_id
        out = []
        for i, a in enumerate(self.agents):
            if i == origin or a.bookie.for_actor(origin_actor).contains_version(
                version
            ):
                out.append(i)
        return out

    def close(self) -> None:
        for a in self.agents:
            try:
                a.storage.close()  # main conn + RO pool
            except Exception:
                pass
        if self._own_dir:
            shutil.rmtree(self.base_dir, ignore_errors=True)


def run_det_epidemic(
    cluster: DetCluster, origin: int, write_id: int
) -> Dict:
    """One full epidemic on the deterministic cluster: write at
    ``origin``, tick until quiescent, record the per-tick trace.

    Returns {"origin", "version", "ticks": [{"infected": [...],
    "msgs": [...]} per tick], "converged_tick"} — cumulative msgs are
    snapshotted per tick so the trace is diffable tick-for-tick against
    the sim replay."""
    p = cluster.params
    version = cluster.write(
        origin, "INSERT INTO tests (id, text) VALUES (?, ?)",
        (write_id, f"det-{write_id}"),
    )
    base_msgs = list(cluster.msgs)
    base_sync = list(cluster.sync_msgs)
    trace = []
    converged_tick = None
    for _ in range(p.max_ticks):
        cluster.tick()
        infected = cluster.infected(origin, version)
        trace.append({
            "infected": infected,
            "msgs": [m - b for m, b in zip(cluster.msgs, base_msgs)],
            "sync_msgs": [
                m - b for m, b in zip(cluster.sync_msgs, base_sync)
            ],
        })
        if converged_tick is None and len(infected) == p.n_nodes:
            converged_tick = len(trace) - 1  # relative to epidemic start
        # with anti-entropy on, quiescence of the broadcast layer can
        # precede convergence (loss-orphaned nodes heal at the next
        # sync tick) — run until BOTH
        if cluster.quiescent() and (
            p.sync_interval <= 0 or converged_tick is not None
        ):
            break
    return {
        "origin": origin,
        "version": version,
        "ticks": trace,
        "converged_tick": converged_tick,
    }
