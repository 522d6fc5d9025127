"""Cluster member registry with RTT tiers.

Parity: ``crates/corro-types/src/members.rs`` — member states keyed by
actor, per-member RTT ring buffers (20 samples), latency buckets and the
**ring0** tier (peers under 6 ms) that broadcast fanout prefers; persisted
to ``__corro_members`` (``broadcast/mod.rs:803-935``).
"""

from __future__ import annotations

import enum
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

RING0_MAX_RTT_MS = 6.0
RTT_SAMPLES = 20

# quarantine evidence ranking (docs/faults.md): transport-class
# evidence ("breaker", "sig_failure") is recoverable and equal-rank;
# an unsigned equivocation verdict outranks it; a PROVEN signed
# equivocation outranks everything and is never relabeled or cleared
# by weaker evidence
_REASON_RANK = {
    "": 0,
    "breaker": 1,
    "sig_failure": 1,
    "equivocation": 2,
    "signed_equivocation": 3,
}
# reasons that survive an address move (evidence about the ACTOR)
_ACTOR_REASONS = ("equivocation", "signed_equivocation")
# transport-class restores clear each other (a half-open success is
# evidence about the same channel either way); verdict-class reasons
# only clear on their own exact restore call
_TRANSPORT_REASONS = ("breaker", "sig_failure")


def _restores(current: str, reason: str) -> bool:
    if current == reason:
        return True
    return current in _TRANSPORT_REASONS and reason in _TRANSPORT_REASONS


class MemberState(enum.Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"
    DOWN = "down"


@dataclass
class Member:
    actor_id: bytes
    addr: Tuple[str, int]
    state: MemberState = MemberState.ALIVE
    incarnation: int = 0
    cluster_id: int = 0
    # RTT ring, allocated on the FIRST sample (None until then): most
    # members of a large cluster are never probed between samples, and
    # the per-record deque allocation is ~1 s of a 512-node boot
    rtts: Optional[deque] = None
    last_sync_ts: float = 0.0
    last_seen: float = field(default_factory=time.monotonic)
    # quarantine: a peer is deprioritized in fanout sampling the way
    # high-RTT peers are.  `quarantine_reason` records the evidence
    # class — "breaker" / "sig_failure" (transport-level: persistent
    # send failures / a delivery whose origin signature failed to
    # verify; restored on half-open success), "equivocation"
    # (protocol-level: conflicting changesets for one (actor,
    # version); never restored by transport success — cleared only by
    # the runtime's bounded verdict expiry or an identity renewal), or
    # "signed_equivocation" (a VERIFIED signed conflicting pair:
    # permanent, survives address moves and restarts, outranks all
    # other evidence)
    quarantined: bool = False
    quarantine_reason: str = ""

    def note_rtt(self, rtt_ms: float) -> None:
        if self.rtts is None:
            self.rtts = deque(maxlen=RTT_SAMPLES)
        self.rtts.append(rtt_ms)

    @property
    def rtt_ms(self) -> Optional[float]:
        if not self.rtts:
            return None
        return sum(self.rtts) / len(self.rtts)

    @property
    def is_ring0(self) -> bool:
        if self.quarantined:
            return False
        rtt = self.rtt_ms
        return rtt is not None and rtt < RING0_MAX_RTT_MS


class Members:
    """Thread-safe membership view (written by the SWIM loop, read by
    broadcast fanout and sync peer selection).

    ``clock`` sources every ``last_seen`` stamp (the injectable-clock
    seam, ``corrosion_tpu_torch/clock.py``): under a virtual-time campaign
    member freshness ages on the event heap, not the wall."""

    def __init__(self, self_actor: bytes, clock=None):
        from corrosion_tpu_torch.clock import SYSTEM_CLOCK

        self.self_actor = self_actor
        self._clock = clock or SYSTEM_CLOCK
        self._members: Dict[bytes, Member] = {}
        self._lock = threading.RLock()
        # alive() result cache, invalidated by membership/state
        # mutations: broadcast fanout samples call alive() per flush
        # and the O(N) rebuild dominates big-cluster flush rounds.
        # Callers receive the SHARED list and must not mutate it.
        self._alive_cache: Optional[List[Member]] = None

    def upsert(
        self,
        actor_id: bytes,
        addr: Tuple[str, int],
        state: MemberState = MemberState.ALIVE,
        incarnation: int = 0,
        cluster_id: int = 0,
    ) -> bool:
        """Merge a member record; SWIM override rules (higher incarnation
        wins; equal incarnation: down > suspect > alive).  Returns True if
        the record changed."""
        if actor_id == self.self_actor:
            return False
        rank = {MemberState.ALIVE: 0, MemberState.SUSPECT: 1, MemberState.DOWN: 2}
        with self._lock:
            m = self._members.get(actor_id)
            if m is None:
                self._members[actor_id] = Member(
                    actor_id=actor_id, addr=tuple(addr), state=state,
                    incarnation=incarnation, cluster_id=cluster_id,
                    last_seen=self._clock.monotonic(),
                )
                self._alive_cache = None
                return True
            if (incarnation, rank[state]) <= (m.incarnation, rank[m.state]):
                return False
            self._alive_cache = None
            if tuple(addr) != tuple(m.addr) \
                    and m.quarantine_reason not in _ACTOR_REASONS:
                # the peer moved (e.g. restarted on a fresh ephemeral
                # port): transport-level quarantine was evidence about
                # the OLD address, and the old breaker can never
                # half-open-succeed to clear it — start the new address
                # with a clean slate.  Equivocation evidence (signed or
                # not) is about the ACTOR, not the address: it
                # survives a move
                m.quarantined = False
                m.quarantine_reason = ""
            m.state = state
            m.incarnation = incarnation
            m.addr = tuple(addr)
            m.last_seen = self._clock.monotonic()
            return True

    def revive(self, actor_id: bytes) -> None:
        """Direct evidence (a probe ack) clears OUR suspicion locally.

        SWIM's incarnation rules only let a higher incarnation demote
        suspect→alive cluster-wide, but first-hand contact is stronger
        than hearsay for the local view — without this, one dropped ack
        excludes a healthy peer from sync forever."""
        with self._lock:
            m = self._members.get(actor_id)
            if m and m.state is MemberState.SUSPECT:
                m.state = MemberState.ALIVE
                m.last_seen = self._clock.monotonic()
                self._alive_cache = None

    def remove(self, actor_id: bytes) -> None:
        with self._lock:
            self._members.pop(actor_id, None)
            self._alive_cache = None

    def get(self, actor_id: bytes) -> Optional[Member]:
        with self._lock:
            return self._members.get(actor_id)

    def record_rtt(self, actor_id: bytes, rtt_ms: float) -> None:
        with self._lock:
            m = self._members.get(actor_id)
            if m:
                m.note_rtt(rtt_ms)
                m.last_seen = self._clock.monotonic()

    def update_sync_ts(self, actor_id: bytes, ts: float) -> None:
        with self._lock:
            m = self._members.get(actor_id)
            if m:
                m.last_sync_ts = ts

    def set_quarantined(self, actor_id: bytes, flag: bool,
                        reason: str = "breaker") -> None:
        """Quarantine verdict for one evidence class: ``True`` opens
        (deprioritize the peer and record the reason), ``False``
        restores — but only when the SAME evidence class quarantined
        it: a transport half-open success must not clear an
        equivocation verdict."""
        with self._lock:
            m = self._members.get(actor_id)
            if m:
                self._apply_quarantine(m, flag, reason)

    @staticmethod
    def _apply_quarantine(m: Member, flag: bool, reason: str) -> None:
        if flag:
            # stronger evidence sticks: a hostile actor whose transport
            # also flaps must stay marked hostile, and a PROVEN
            # (signed) equivocator must never be relabeled by anything
            if _REASON_RANK.get(reason, 0) \
                    >= _REASON_RANK.get(m.quarantine_reason, 0):
                m.quarantine_reason = reason
            m.quarantined = True
        elif m.quarantined and _restores(m.quarantine_reason, reason):
            m.quarantined = False
            m.quarantine_reason = ""

    def quarantine_by_addr(self, addr, flag: bool,
                           reason: str = "breaker") -> bool:
        """Same, keyed by gossip address (what the transport knows)."""
        addr = tuple(addr)
        with self._lock:
            for m in self._members.values():
                if tuple(m.addr) == addr:
                    self._apply_quarantine(m, flag, reason)
                    return True
        return False

    def alive(self) -> List[Member]:
        """Non-DOWN members.  The returned list is CACHED and shared
        between calls until the next membership/state mutation —
        read-only by contract (every in-tree caller filters or samples
        from it)."""
        with self._lock:
            cached = self._alive_cache
            if cached is None:
                cached = self._alive_cache = [
                    m for m in self._members.values()
                    if m.state is not MemberState.DOWN
                ]
            return cached

    def all(self) -> List[Member]:
        with self._lock:
            return list(self._members.values())

    def ring0(self) -> List[Member]:
        return [m for m in self.alive() if m.is_ring0]

    def sample(self, k: int, rng: Optional[random.Random] = None,
               ring0_first: bool = True,
               exclude: Optional[set] = None) -> List[Member]:
        """Broadcast fanout choice.

        Parity (``broadcast/mod.rs:586-702``): a *local* broadcast
        (``ring0_first=True``) goes to ALL ring0 members (<6 ms RTT tier,
        uncapped) plus a random sample of k non-ring0 peers; a rebroadcast
        is a uniform sample of k peers.  ``exclude`` mirrors the
        reference's per-payload ``sent_to`` set — a payload is never sent
        to the same peer twice across retransmission rounds."""
        rng = rng or random
        exclude = exclude or set()
        alive = [m for m in self.alive() if m.actor_id not in exclude]
        # breaker-quarantined peers are deprioritized like high-RTT
        # peers: never in ring0 (is_ring0 is False while quarantined),
        # and sampled only when the healthy pool can't fill k — they
        # stay reachable (half-open trials need traffic) but a flush
        # round prefers peers that are actually answering
        healthy = [m for m in alive if not m.quarantined]
        shunned = [m for m in alive if m.quarantined]

        def pick(pool, fallback, n):
            out = rng.sample(pool, min(len(pool), n))
            short = n - len(out)
            if short > 0 and fallback:
                out += rng.sample(fallback, min(len(fallback), short))
            return out

        if not ring0_first:
            if len(alive) <= k:
                return alive
            return pick(healthy, shunned, k)
        ring0 = [m for m in healthy if m.is_ring0]
        rest = [m for m in healthy if not m.is_ring0]
        picked = list(ring0)
        picked += pick(rest, shunned, k)
        return picked


# measured-topology export: RTT tier edges in ms.  Tier 1 is exactly
# the reference's ring0 (<6 ms); the rest double per tier (geo-RTT
# bands: metro, regional, continental, intercontinental); anything
# past the last edge lands in one final open tier.
DEFAULT_RTT_TIER_EDGES_MS: Tuple[float, ...] = (
    RING0_MAX_RTT_MS, 12.0, 24.0, 48.0, 96.0
)


def rtt_tier_of(rtt_ms: float,
                edges: Tuple[float, ...] = DEFAULT_RTT_TIER_EDGES_MS
                ) -> int:
    """1-based RTT tier of one mean RTT sample: the first edge the RTT
    falls under; ``len(edges) + 1`` beyond the last edge."""
    for t, edge in enumerate(edges, start=1):
        if rtt_ms < edge:
            return t
    return len(edges) + 1


def rtt_topology(members: "Members",
                 edges: Tuple[float, ...] = DEFAULT_RTT_TIER_EDGES_MS
                 ) -> Dict:
    """Export this node's ``Members`` RTT-ring tier distribution as
    measured-topology JSON — the capture path behind ``corro admin rtt
    dump`` and the vcluster capture helper.

    ``weights`` are per-tier MEMBER counts (each member placed by its
    ring mean ``rtt_ms``), trailing empty tiers trimmed — exactly the
    ``rtt_tier_weights`` the sim's ``measured_ring`` topology consumes
    (``bench.py --frontier --topology measured_ring``).  Members with
    no RTT samples yet are reported separately, not binned."""
    nodes = []
    counts = [0] * (len(edges) + 1)
    unsampled = 0
    for m in members.all():
        rtt = m.rtt_ms
        if rtt is None:
            unsampled += 1
            continue
        tier = rtt_tier_of(rtt, edges)
        counts[tier - 1] += 1
        nodes.append({
            "actor": m.actor_id.hex(),
            "rtt_ms": round(rtt, 3),
            "samples": len(m.rtts or ()),
            "tier": tier,
            "ring0": m.is_ring0,
        })
    last = 0
    for t, c in enumerate(counts, start=1):
        if c:
            last = t
    weights = counts[:last] if last else []
    return {
        "topology": "measured_ring",
        "tier_edges_ms": list(edges),
        "rtt_tiers": len(weights),
        "weights": weights,
        "members_sampled": len(nodes),
        "members_unsampled": unsampled,
        "nodes": nodes,
    }
