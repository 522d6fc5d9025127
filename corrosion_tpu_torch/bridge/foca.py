"""foca SWIM wire codec: binary datagrams replacing the JSON envelope.

The reference relays foca's own messages verbatim as QUIC datagrams —
``Foca::with_custom_broadcast(actor, config, rng,
BincodeCodec(bincode::DefaultOptions::new()), NoCustomBroadcast)``
(``crates/corro-agent/src/broadcast/mod.rs:137-142``) — with the
``Actor`` identity of ``crates/corro-types/src/actor.rs:132-210``.
This module implements that datagram format so our SWIM layer speaks
binary foca messages instead of JSON.

Layout (bincode 1.3 DefaultOptions primitives, see ``bridge/bincode.py``):

``Actor`` (serde-derived field order, ``actor.rs:132-139``)::

    id          ActorId(#[serde(transparent)] Uuid)
                → uuid 1.x binary serde: serialize_bytes(16)
                → varint len 0x10 + 16 raw bytes
    addr        SocketAddr → serde binary impl: newtype variant
                (varint 0 = V4 / 1 = V6), then (ip_octets, port):
                4 (or 16) raw octet bytes + u16 varint port
    ts          Timestamp(#[serde(transparent)] NTP64) → u64 varint
    cluster_id  ClusterId(#[serde(transparent)] u16) → u16 varint

``Header``/``Message``/``Member`` follow foca 0.16's protocol types
(foca src/payload.rs, src/member.rs; ``Incarnation``/``ProbeNumber``
are u16)::

    Header  { src: Actor, src_incarnation: u16, dst: Actor,
              message: Message }
    Message enum (variant tag = u32 varint):
      0 Ping(ProbeNumber)              1 Ack(ProbeNumber)
      2 PingReq      { target, probe_number }
      3 IndirectPing { origin, probe_number }
      4 IndirectAck  { target, probe_number }
      5 ForwardedAck { origin, probe_number }
      6 Announce     7 Feed    8 Gossip    9 Broadcast   10 TurnUndead
    Member  { id: Actor, incarnation: u16, state: State }
    State enum: 0 Alive, 1 Suspect, 2 Down

A datagram is one encoded ``Header`` followed by zero or more ``Member``
records (cluster updates / Feed contents) back-to-back until the end of
the packet — foca's ``handle_data`` reads members while bytes remain.
Packets are capped at 1178 bytes (``broadcast/mod.rs:943``).

RECONSTRUCTION NOTE: foca's crate source is not present in this
offline tree, so the ``Header``/``Message``/``Member`` shapes above are
reconstructed from foca 0.16's public API/docs and the reference's
usage; the serde/bincode/uuid primitive rules are implemented from
their published specs.  ``tests/test_foca_wire.py`` pins this layout
with golden byte vectors and drives a live agent as a foreign peer
speaking only these bytes (join → probe → refutation).
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from corrosion_tpu_torch.bridge.bincode import BincodeError, BReader, BWriter

MAX_PACKET = 1178  # broadcast/mod.rs:943

# Message variant tags
PING, ACK, PING_REQ, INDIRECT_PING, INDIRECT_ACK, FORWARDED_ACK = range(6)
ANNOUNCE, FEED, GOSSIP, BROADCAST, TURN_UNDEAD = range(6, 11)

# Member states
STATE_ALIVE, STATE_SUSPECT, STATE_DOWN = range(3)

_NO_FIELD_TAGS = frozenset((ANNOUNCE, FEED, GOSSIP, BROADCAST, TURN_UNDEAD))
_PROBE_ONLY_TAGS = frozenset((PING, ACK))


class FocaError(ValueError):
    pass


@dataclass(frozen=True)
class FocaActor:
    """The foca identity: corro's Actor (actor.rs:132-139)."""

    id: bytes  # 16-byte uuid / crsql site_id
    addr: Tuple[str, int]
    ts: int = 0  # NTP64 (uhlc HLC)
    cluster_id: int = 0

    def same_prefix(self, other: "FocaActor") -> bool:
        """Identity::has_same_prefix (actor.rs:183-197): nil ids compare
        by gossip addr (a joining client doesn't know our id yet)."""
        nil = b"\x00" * 16
        if self.id == nil or other.id == nil:
            return self.addr == other.addr
        return self.id == other.id


@dataclass(frozen=True)
class FocaMessage:
    tag: int
    probe_number: int = 0
    peer: Optional[FocaActor] = None  # target/origin for tags 2-5


@dataclass(frozen=True)
class FocaMember:
    actor: FocaActor
    incarnation: int
    state: int  # STATE_*


@dataclass(frozen=True)
class FocaDatagram:
    src: FocaActor
    src_incarnation: int
    dst: FocaActor
    message: FocaMessage
    updates: List[FocaMember] = field(default_factory=list)


# -- Actor ------------------------------------------------------------


def _w_actor(w: BWriter, a: FocaActor) -> None:
    if len(a.id) != 16:
        raise FocaError(f"actor id must be 16 bytes, got {len(a.id)}")
    w.lp_bytes(a.id)
    ip = ipaddress.ip_address(a.addr[0])
    if ip.version == 4:
        w.varint(0).raw(ip.packed)
    else:
        w.varint(1).raw(ip.packed)
    w.varint(a.addr[1])
    w.varint(a.ts)
    w.varint(a.cluster_id)


def _r_actor(r: BReader) -> FocaActor:
    ident = r.lp_bytes()
    if len(ident) != 16:
        raise FocaError(f"actor id must be 16 bytes, got {len(ident)}")
    fam = r.varint()
    if fam == 0:
        host = str(ipaddress.IPv4Address(r.raw(4)))
    elif fam == 1:
        host = str(ipaddress.IPv6Address(r.raw(16)))
    else:
        raise FocaError(f"unknown address family {fam}")
    port = r.varint()
    ts = r.varint()
    cluster_id = r.varint()
    return FocaActor(id=bytes(ident), addr=(host, port), ts=ts,
                     cluster_id=cluster_id)


# -- Message ----------------------------------------------------------


def _w_message(w: BWriter, m: FocaMessage) -> None:
    w.varint(m.tag)
    if m.tag in _PROBE_ONLY_TAGS:
        w.varint(m.probe_number)
    elif m.tag in _NO_FIELD_TAGS:
        pass
    elif m.peer is not None:
        _w_actor(w, m.peer)
        w.varint(m.probe_number)
    else:
        raise FocaError(f"message tag {m.tag} requires a peer actor")


def _r_message(r: BReader) -> FocaMessage:
    tag = r.varint()
    if tag in _PROBE_ONLY_TAGS:
        return FocaMessage(tag=tag, probe_number=r.varint())
    if tag in _NO_FIELD_TAGS:
        return FocaMessage(tag=tag)
    if tag in (PING_REQ, INDIRECT_PING, INDIRECT_ACK, FORWARDED_ACK):
        peer = _r_actor(r)
        return FocaMessage(tag=tag, peer=peer, probe_number=r.varint())
    raise FocaError(f"unknown message tag {tag}")


# -- Member -----------------------------------------------------------


def _w_member(w: BWriter, m: FocaMember) -> None:
    _w_actor(w, m.actor)
    w.varint(m.incarnation)
    w.varint(m.state)


def _r_member(r: BReader) -> FocaMember:
    actor = _r_actor(r)
    incarnation = r.varint()
    state = r.varint()
    if state not in (STATE_ALIVE, STATE_SUSPECT, STATE_DOWN):
        raise FocaError(f"unknown member state {state}")
    return FocaMember(actor=actor, incarnation=incarnation, state=state)


# -- datagram ---------------------------------------------------------


def encode_datagram(d: FocaDatagram) -> bytes:
    """Header + as many updates as fit in MAX_PACKET (foca fills the
    remaining packet space with piggybacked cluster updates)."""
    w = BWriter()
    _w_actor(w, d.src)
    w.varint(d.src_incarnation)
    _w_actor(w, d.dst)
    _w_message(w, d.message)
    out = w.getvalue()
    if len(out) > MAX_PACKET:
        raise FocaError(f"header alone exceeds {MAX_PACKET} bytes")
    for m in d.updates:
        mw = BWriter()
        _w_member(mw, m)
        mb = mw.getvalue()
        if len(out) + len(mb) > MAX_PACKET:
            break
        out += mb
    return out


def decode_datagram(data: bytes) -> FocaDatagram:
    r = BReader(data)
    try:
        src = _r_actor(r)
        src_incarnation = r.varint()
        dst = _r_actor(r)
        message = _r_message(r)
        updates = []
        while r.remaining() > 0:
            updates.append(_r_member(r))
    except BincodeError as e:
        raise FocaError(str(e)) from e
    return FocaDatagram(
        src=src, src_incarnation=src_incarnation, dst=dst,
        message=message, updates=updates,
    )
