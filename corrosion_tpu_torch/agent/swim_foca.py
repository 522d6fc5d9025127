"""SWIM over the foca binary wire: the agent-side protocol driver.

With ``AgentConfig.swim_wire == "foca"`` the agent's SWIM datagrams are
binary foca messages (``bridge/foca.py``) instead of the JSON envelope —
the wire the reference relays verbatim
(``crates/corro-agent/src/broadcast/mod.rs:185-324``).  The message
flows map onto the existing host state machine (probe futures, suspicion
reaper, ``Members``):

* ``Announce`` → ``Feed`` (receiver replies with its active members);
* ``Ping(n)`` → ``Ack(n)`` — resolves the prober's ack future;
* indirect probe chain (``handlers.rs`` / foca probe semantics):
  origin → helper ``PingReq{target, n}``; helper → target
  ``IndirectPing{origin, n}``; target → helper ``IndirectAck{target:
  origin, n}``; helper → origin ``ForwardedAck{origin: target, n}``;
* ``Gossip`` — pure update carrier (graceful leave rides this with a
  self=Down update, foca ``leave_cluster``);
* ``TurnUndead`` — "you are down here": the receiver renews its
  identity (fresh ts + bumped incarnation) and re-announces, foca
  ``Identity::renew`` auto-rejoin (``actor.rs:199-210``).

Identity semantics: a member's ``Actor.ts`` names its *identity
generation* — an update carrying a newer ts than we know replaces the
member wholesale (fresh incarnation space), which is how a renewed
(rejoined) node overrides its own stale DOWN record.

Every non-Broadcast datagram piggybacks cluster updates
(freshness-prioritized: least-retransmitted entries first, foca's
update backlog policy) up to the 1178-byte packet cap.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

from corrosion_tpu_torch.agent.members import MemberState
from corrosion_tpu_torch.bridge import foca

if TYPE_CHECKING:  # pragma: no cover
    from corrosion_tpu_torch.agent.runtime import Agent

_STATE_TO_WIRE = {
    MemberState.ALIVE: foca.STATE_ALIVE,
    MemberState.SUSPECT: foca.STATE_SUSPECT,
    MemberState.DOWN: foca.STATE_DOWN,
}
_WIRE_TO_STATE = {v: k for k, v in _STATE_TO_WIRE.items()}


def self_actor(agent: "Agent") -> foca.FocaActor:
    return foca.FocaActor(
        id=agent.actor_id,
        addr=tuple(agent.gossip_addr),
        ts=agent._identity_ts,
        cluster_id=agent.config.cluster_id,
    )


def _member_actor(agent: "Agent", actor_id: bytes,
                  addr: Tuple[str, int]) -> foca.FocaActor:
    return foca.FocaActor(
        id=actor_id,
        addr=tuple(addr),
        ts=agent._swim_ts.get(actor_id, 0),
        cluster_id=agent.config.cluster_id,
    )


def _nil_actor(agent: "Agent", addr: Tuple[str, int]) -> foca.FocaActor:
    """Announce target: only the gossip addr is known (Actor::from
    <SocketAddr>, actor.rs:172-180 — nil id, zero ts)."""
    return foca.FocaActor(
        id=b"\x00" * 16, addr=tuple(addr), ts=0,
        cluster_id=agent.config.cluster_id,
    )


def _backlog_limit(agent: "Agent", n_members: int) -> int:
    """The shared decay budget: one update rides at most this many
    sends after it last changed (both the piggyback selection and the
    gossip-round skip-check key on it)."""
    from corrosion_tpu_torch.utils.swimscale import scaled_update_retransmissions

    return scaled_update_retransmissions(n_members + 1)


def backlog_has_fresh(agent: "Agent") -> bool:
    """True while any member update still has retransmission budget."""
    members = agent.members.all()
    limit = _backlog_limit(agent, len(members))
    return any(
        agent._swim_update_tx.get(m.actor_id, 0) < limit for m in members
    )


def piggyback(agent: "Agent", k: int = 5) -> List[foca.FocaMember]:
    """Self entry + up to k freshest (least-transmitted) member
    updates.  Transmission counts persist on the agent and an entry
    decays out of the backlog after the cluster-size-scaled
    retransmission limit — foca's update queue policy (reset to fresh
    whenever the record changes)."""
    out = [foca.FocaMember(
        actor=self_actor(agent),
        incarnation=agent.incarnation,
        state=foca.STATE_ALIVE,
    )]
    members = agent.members.all()
    limit = _backlog_limit(agent, len(members))
    members.sort(
        key=lambda m: agent._swim_update_tx.get(m.actor_id, 0)
    )
    for m in members[:k]:
        tx = agent._swim_update_tx.get(m.actor_id, 0)
        if tx >= limit:
            break  # sorted ascending: everything after is decayed too
        agent._swim_update_tx[m.actor_id] = tx + 1
        out.append(foca.FocaMember(
            actor=_member_actor(agent, m.actor_id, m.addr),
            incarnation=m.incarnation,
            state=_STATE_TO_WIRE[m.state],
        ))
    return out


def send(agent: "Agent", addr: Tuple[str, int], dst: foca.FocaActor,
         message: foca.FocaMessage,
         updates: Optional[List[foca.FocaMember]] = None) -> None:
    if agent._udp is None:
        return
    if agent.fault_filter is not None:
        # same injection seam as Agent._send_udp: SWIM datagrams are
        # unreliable by design, so an injected drop is indistinguishable
        # from the network eating the packet
        act = agent.fault_filter("udp", tuple(addr))
        if act is not None and act.drop:
            agent.metrics.counter(
                "corro_transport_faults_injected_total", kind="udp"
            )
            return
        if act is not None and act.delay and agent._loop is not None:
            agent._loop.call_later(
                act.delay, _send_now, agent, addr, dst, message, updates
            )
            return
    _send_now(agent, addr, dst, message, updates)


def _send_now(agent: "Agent", addr: Tuple[str, int], dst: foca.FocaActor,
              message: foca.FocaMessage,
              updates: Optional[List[foca.FocaMember]] = None) -> None:
    if agent._udp is None:
        return
    d = foca.FocaDatagram(
        src=self_actor(agent),
        src_incarnation=agent.incarnation,
        dst=dst,
        message=message,
        updates=piggyback(agent) if updates is None else updates,
    )
    data = foca.encode_datagram(d)
    agent.metrics.counter(
        "corro_gossip_datagrams_sent_total",
        kind=foca_kind_label(message.tag),
    )
    agent._udp.sendto(data, tuple(addr))


_RESOLVE_TTL = 30.0
_resolve_cache: dict = {}  # host -> (ip, expires_at)


def _resolve_host(host: str) -> str:
    """Hostname → numeric IP with a short success-only TTL cache:
    getaddrinfo blocks, and the announce loop re-announces the same
    bootstrap hosts every cycle — a slow DNS server must not stall the
    event loop (and with it every in-flight probe) on each pass.
    Failures are NOT cached (a bootstrap peer whose record appears
    later must still resolve) and entries expire so re-scheduled hosts
    pick up their new address."""
    import socket
    import time

    hit = _resolve_cache.get(host)
    now = time.monotonic()
    if hit is not None and hit[1] > now:
        return hit[0]
    try:
        infos = socket.getaddrinfo(host, None, type=socket.SOCK_DGRAM)
    except OSError:
        return host  # send() will fail; retried next cycle
    ip = infos[0][4][0]
    _resolve_cache[host] = (ip, now + _RESOLVE_TTL)
    if len(_resolve_cache) > 512:
        _resolve_cache.clear()  # crude bound; bootstrap sets are tiny
    return ip


def _resolve(addr: Tuple[str, int]) -> Tuple[str, int]:
    """Bootstrap entries may be hostnames; the wire's SocketAddr form
    is numeric (the reference resolves bootstrap names before
    announcing)."""
    import ipaddress

    host, port = addr
    try:
        ipaddress.ip_address(host)
        return (host, port)
    except ValueError:
        return (_resolve_host(host), port)


def announce(agent: "Agent", addr: Tuple[str, int]) -> None:
    addr = _resolve(addr)
    send(agent, addr, _nil_actor(agent, addr),
         foca.FocaMessage(tag=foca.ANNOUNCE), updates=[])


def probe(agent: "Agent", m, nonce: int) -> None:
    send(agent, m.addr, _member_actor(agent, m.actor_id, m.addr),
         foca.FocaMessage(tag=foca.PING, probe_number=nonce))


def ping_req(agent: "Agent", helper, target, nonce: int) -> None:
    send(
        agent, helper.addr,
        _member_actor(agent, helper.actor_id, helper.addr),
        foca.FocaMessage(
            tag=foca.PING_REQ, probe_number=nonce,
            peer=_member_actor(agent, target.actor_id, target.addr),
        ),
    )


def gossip_round(agent: "Agent", k_targets: int = 3) -> int:
    """One periodic-gossip round (foca ``Config.periodic_gossip``, on
    in the WAN preset the reference uses): send a pure update-carrier
    ``Gossip`` datagram to a few random alive members — dissemination
    must not ride only on probe/ack piggyback, whose volume shrinks
    exactly when the cluster is quiet.  Skips the round entirely when
    the update backlog has fully decayed (nothing fresh to carry).
    Returns the number of datagrams sent."""
    if not backlog_has_fresh(agent):
        return 0
    alive = agent.members.alive()
    if not alive:
        return 0
    targets = agent._rng.sample(alive, min(k_targets, len(alive)))
    for m in targets:
        send(agent, m.addr, _member_actor(agent, m.actor_id, m.addr),
             foca.FocaMessage(tag=foca.GOSSIP))
    return len(targets)


def leave(agent: "Agent") -> None:
    """Graceful leave: Gossip datagrams carrying our own Down update
    (foca leave_cluster, broadcast/mod.rs:327-366)."""
    down_self = foca.FocaMember(
        actor=self_actor(agent),
        incarnation=agent.incarnation,
        state=foca.STATE_DOWN,
    )
    for m in agent.members.alive():
        send(agent, m.addr,
             _member_actor(agent, m.actor_id, m.addr),
             foca.FocaMessage(tag=foca.GOSSIP), updates=[down_self])


def _ingest_update(agent: "Agent", fm: foca.FocaMember) -> None:
    if fm.actor.cluster_id != agent.config.cluster_id:
        return
    if fm.actor.id == agent.actor_id:
        # refutation: someone says we are suspect/down at an incarnation
        # that supersedes ours — bump past it; our next piggybacked self
        # entry (on every outgoing datagram) carries the refutation
        if (fm.state != foca.STATE_ALIVE
                and fm.incarnation >= agent.incarnation):
            agent.incarnation = fm.incarnation + 1
            agent._persist_incarnation()
        return
    known_ts = agent._swim_ts.get(fm.actor.id)
    # ts == 0 means the SENDER never learned this identity's generation
    # (e.g. pre-seeded membership): apply by plain incarnation rules —
    # dropping those would starve dissemination of exactly the
    # suspicion/down records failure detection rides on.  Only a REAL
    # but older ts is a stale generation.
    if 0 < fm.actor.ts < (known_ts or 0):
        return
    if fm.actor.ts > 0 and (known_ts is None or fm.actor.ts > known_ts):
        # new member or renewed identity: fresh incarnation space
        # replaces whatever record (possibly DOWN) we held — and any
        # suspicion timer the OLD generation had armed
        agent._swim_ts[fm.actor.id] = fm.actor.ts
        if known_ts is not None:
            agent.members.remove(fm.actor.id)
            agent._suspects.pop(fm.actor.id, None)
    if agent.members.upsert(
        fm.actor.id, fm.actor.addr, _WIRE_TO_STATE[fm.state],
        fm.incarnation,
    ):
        # a changed record is fresh news: back into the gossip backlog,
        # and the shared per-node suspicion-timer bookkeeping runs
        # (foca: every member that LEARNS a suspicion starts its own
        # deadline — detection must not serialize behind the
        # first-hand suspecter's gossip)
        agent._swim_update_tx[fm.actor.id] = 0
        agent.note_member_state(fm.actor.id, _WIRE_TO_STATE[fm.state])


def handle_datagram(agent: "Agent", data: bytes, addr) -> None:
    try:
        d = foca.decode_datagram(data)
    except (foca.FocaError, ValueError):
        return
    if d.src.cluster_id != agent.config.cluster_id:
        agent.metrics.counter("corro_swim_cluster_rejected_total")
        return
    # dst validation: id-addressed datagrams must name us; nil-id dst
    # (an addr-addressed join/announce) is accepted as-is — it reached
    # our socket, and requiring literal addr equality would drop joins
    # whose bootstrap entry spells our address differently (hostname,
    # 0.0.0.0 bind) — the reference resolves bootstrap names to socket
    # addrs before announcing, which our config layer does not
    if d.dst.id != b"\x00" * 16 and d.dst.id != agent.actor_id:
        return  # addressed to some other identity
    tag = d.message.tag
    agent.metrics.counter(
        "corro_gossip_datagrams_received_total",
        kind=foca_kind_label(tag),
    )
    # a member we hold DOWN is talking: tell it (foca notify_down_members
    # → TurnUndead) so it renews its identity and rejoins
    held = agent.members.get(d.src.id)
    if (held is not None and held.state is MemberState.DOWN
            and tag != foca.TURN_UNDEAD
            and d.src.ts <= agent._swim_ts.get(d.src.id, 0)):
        send(agent, d.src.addr, d.src,
             foca.FocaMessage(tag=foca.TURN_UNDEAD), updates=[])
    # the sender itself is live first-hand evidence
    if d.src.id != agent.actor_id and d.src.id != b"\x00" * 16:
        _ingest_update(agent, foca.FocaMember(
            actor=d.src, incarnation=d.src_incarnation,
            state=foca.STATE_ALIVE,
        ))
    for fm in d.updates:
        _ingest_update(agent, fm)

    if tag == foca.ANNOUNCE:
        # feed the joiner our view (foca Feed reply)
        send(agent, d.src.addr, d.src,
             foca.FocaMessage(tag=foca.FEED),
             updates=piggyback(agent, k=10))
    elif tag == foca.PING:
        send(agent, d.src.addr, d.src,
             foca.FocaMessage(tag=foca.ACK,
                              probe_number=d.message.probe_number))
    elif tag == foca.ACK:
        fut = agent._acks.get(d.message.probe_number)
        if fut and not fut.done():
            fut.set_result(True)
    elif tag == foca.PING_REQ:
        target = d.message.peer
        if target is not None:
            send(agent, target.addr, target,
                 foca.FocaMessage(
                     tag=foca.INDIRECT_PING, peer=d.src,
                     probe_number=d.message.probe_number,
                 ))
    elif tag == foca.INDIRECT_PING:
        origin = d.message.peer
        if origin is not None:
            # reply to the HELPER (the datagram's sender) naming the
            # origin; the helper forwards
            send(agent, d.src.addr, d.src,
                 foca.FocaMessage(
                     tag=foca.INDIRECT_ACK, peer=origin,
                     probe_number=d.message.probe_number,
                 ))
    elif tag == foca.INDIRECT_ACK:
        origin = d.message.peer
        if origin is not None:
            send(agent, origin.addr, origin,
                 foca.FocaMessage(
                     tag=foca.FORWARDED_ACK, peer=d.src,
                     probe_number=d.message.probe_number,
                 ))
    elif tag == foca.FORWARDED_ACK:
        fut = agent._acks.get(d.message.probe_number)
        if fut and not fut.done():
            fut.set_result(True)
    elif tag == foca.TURN_UNDEAD:
        # we are down in the sender's view: renew identity and rejoin
        agent.rejoin()
    # FEED / GOSSIP / BROADCAST carry no extra handling beyond updates


_KIND_LABELS = {
    foca.PING: "probe", foca.ACK: "ack", foca.PING_REQ: "ping_req",
    foca.INDIRECT_PING: "indirect_ping",
    foca.INDIRECT_ACK: "indirect_ack",
    foca.FORWARDED_ACK: "forwarded_ack",
    foca.ANNOUNCE: "announce", foca.FEED: "feed", foca.GOSSIP: "gossip",
    foca.BROADCAST: "broadcast", foca.TURN_UNDEAD: "turn_undead",
}


def foca_kind_label(tag: int) -> str:
    return _KIND_LABELS.get(tag, "other")
