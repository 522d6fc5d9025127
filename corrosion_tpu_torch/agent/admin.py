"""Admin server over a unix domain socket.

Parity: ``crates/corro-admin`` — JSON-framed request/response protocol on
a UDS: ``ping``, ``sync generate`` (dump the sync handshake state),
``sync reconcile-gaps``, ``cluster members`` / ``membership-states``,
``actor version``, ``subs list`` / ``subs info``, ``locks``
(``corro-admin/src/lib.rs:95-619``).
"""

from __future__ import annotations

import asyncio
import os
from typing import TYPE_CHECKING

from corrosion_tpu_torch.agent import wire

if TYPE_CHECKING:
    from corrosion_tpu_torch.agent.runtime import Agent


async def start_admin(agent: "Agent", path: str) -> asyncio.AbstractServer:
    if os.path.exists(path):
        os.unlink(path)
    server = await asyncio.start_unix_server(
        lambda r, w: _serve(agent, r, w), path=path
    )
    return server


async def _serve(agent: "Agent", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
    frames = wire.FrameReader()
    try:
        while True:
            data = await reader.read(65536)
            if not data:
                return
            for msg in frames.feed(data):
                try:
                    resp = _handle(agent, msg)
                except Exception as e:  # bad input -> error frame, not EOF
                    resp = {"error": f"{type(e).__name__}: {e}"}
                writer.write(wire.encode_msg(resp))
                await writer.drain()
    except (ConnectionError, asyncio.IncompleteReadError):
        return
    finally:
        writer.close()


def _handle(agent: "Agent", msg: dict) -> dict:
    cmd = msg.get("cmd")
    if cmd == "ping":
        return {"ok": "pong"}

    if cmd == "sync_generate":
        st = agent.generate_sync()
        from corrosion_tpu_torch.agent.runtime import _sync_state_to_dict

        return {"ok": _sync_state_to_dict(st)}

    if cmd == "sync_reconcile_gaps":
        # collapse gaps that are actually satisfied by cleared ranges
        fixed = 0
        with agent.storage._lock:
            for actor, bv in agent.bookie.actors().items():
                for s, e in list(bv.needed):
                    if bv.cleared.contains_span(s, e):
                        bv.needed.remove(s, e)
                        fixed += 1
                agent.bookie._persist_gaps(actor)
            agent.storage.conn.commit()
            if fixed:
                # direct RangeSet surgery bypasses the BookedVersions
                # mutation hooks: invalidate the cached generate_sync
                # snapshot or handshakes keep advertising the old gaps
                agent.bookie._bump_gen()
        return {"ok": {"reconciled": fixed}}

    if cmd == "cluster_members":
        # per-member transport view (ConnStats + breaker state): the
        # debuggability surface for chaos runs — injected drops,
        # redials, and breaker opens are visible per peer address
        tstats = agent.transport.stats if agent.transport else {}
        breakers = (
            agent.transport.breaker_states() if agent.transport else {}
        )
        out = []
        for m in agent.members.all():
            addr = tuple(m.addr)
            st = tstats.get(addr)
            out.append({
                "actor": m.actor_id.hex(),
                "addr": list(m.addr),
                "state": m.state.value,
                "incarnation": m.incarnation,
                "rtt_ms": m.rtt_ms,
                "ring0": m.is_ring0,
                "quarantined": m.quarantined,
                # evidence class behind the quarantine: "breaker"
                # (transport failures) or "equivocation" (hostile
                # changesets — never cleared by transport success)
                "quarantine_reason": m.quarantine_reason,
                "breaker": breakers.get(addr, "closed"),
                "transport": st.as_dict() if st is not None else None,
            })
        return {"ok": out}

    if cmd == "rtt_dump":
        # measured-topology export: the Members RTT-ring tier
        # distribution as topology JSON consumable by
        # ``bench.py --frontier --topology measured_ring``
        from corrosion_tpu_torch.agent.members import (
            DEFAULT_RTT_TIER_EDGES_MS,
            rtt_topology,
        )

        edges = msg.get("tier_edges_ms")
        if edges is not None:
            try:
                edges = tuple(float(e) for e in edges)
                if not edges or any(
                    b <= a for a, b in zip(edges, edges[1:])
                ):
                    raise ValueError("edges must strictly increase")
            except (TypeError, ValueError) as e:
                return {"error": f"bad tier_edges_ms: {e}"}
        else:
            edges = DEFAULT_RTT_TIER_EDGES_MS
        return {"ok": rtt_topology(agent.members, edges)}

    if cmd == "transport_stats":
        if agent.transport is None:
            return {"ok": {}}
        breakers = agent.transport.breaker_states()
        return {
            "ok": {
                f"{a[0]}:{a[1]}": dict(
                    s.as_dict(), breaker=breakers.get(a, "closed")
                )
                for a, s in agent.transport.stats.items()
            }
        }

    if cmd == "faults":
        if agent.faults is None:
            return {"ok": None}
        return {"ok": agent.faults.as_dict()}

    if cmd == "cluster_rejoin":
        return {"ok": {"announced": agent.rejoin()}}

    if cmd == "cluster_set_id":
        try:
            announced = agent.set_cluster_id(int(msg["cluster_id"]))
        except (KeyError, ValueError) as e:
            return {"error": f"bad cluster_id: {e}"}
        return {
            "ok": {
                "cluster_id": agent.config.cluster_id,
                "announced": announced,
            }
        }

    if cmd == "trace_spans":
        from corrosion_tpu_torch.agent import tracing

        # --trace <id>: assemble one cross-node trace from this node's
        # ring without shipping (and grepping) the whole dump
        trace_id = msg.get("trace")
        if trace_id is not None:
            trace_id = str(trace_id).lower()
        return {
            "ok": [
                {
                    "name": s.name,
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "start": s.start,
                    "dur_ms": s.dur_ms,
                    "attrs": {k: str(v) for k, v in s.attrs.items()},
                }
                for s in tracing.recent_spans(
                    int(msg.get("limit", 100)), trace_id=trace_id
                )
            ]
        }

    if cmd == "health":
        # runtime health: loop stall probe, queue depths, the agent's
        # own convergence-lag measurement (docs/telemetry.md)
        return {"ok": agent.health_snapshot()}

    if cmd == "flight_dump":
        # the flight ring: recorder state + every held record
        # (snapshots and events), oldest first
        if agent.flight is None:
            return {"ok": None}
        return {
            "ok": {
                "recorder": agent.flight.snapshot(),
                "entries": agent.flight.entries(
                    limit=int(msg.get("limit", 0))
                ),
            }
        }

    if cmd == "flight_events":
        # the typed event journal alone (the ring minus snapshots)
        if agent.flight is None:
            return {"ok": None}
        return {
            "ok": agent.flight.entries(
                limit=int(msg.get("limit", 0)), kind="event"
            )
        }

    if cmd == "sync_sessions":
        # live sync sessions, both roles: peer, age, needs-remaining,
        # session byte volume (docs/telemetry.md per-session sync
        # observability)
        return {"ok": agent.sync_sessions()}

    if cmd == "actor_version":
        actor = bytes.fromhex(msg.get("actor", agent.actor_id.hex()))
        bv = agent.bookie.for_actor(actor)
        return {
            "ok": {
                "actor": actor.hex(),
                "last": bv.last(),
                "needed": bv.needed_spans(),
                "partials": {
                    str(v): p.gaps() for v, p in bv.partials.items()
                },
                "cleared": bv.cleared.spans(),
            }
        }

    if cmd == "subs_list":
        if agent.subs is None:
            return {"ok": []}
        return {"ok": agent.subs.list()}

    if cmd == "subs_info":
        if agent.subs is None:
            return {"error": "subscriptions disabled"}
        h = agent.subs.get(msg.get("id", ""))
        if h is None:
            return {"error": "no such subscription"}
        return {
            "ok": {
                "id": h.id,
                "sql": h.sql,
                "tables": sorted(h.tables),
                "rows": len(h.rows),
                "last_change_id": h.last_change_id,
                "streams": len(h._streams),
            }
        }

    if cmd == "locks":
        # lock observability (LockRegistry parity): report holders of the
        # storage write lock if instrumented
        return {"ok": agent.lock_registry.snapshot()}

    if cmd == "db_info":
        with agent.storage._lock:
            (page_count,) = agent.storage.conn.execute(
                "PRAGMA page_count"
            ).fetchone()
            (freelist,) = agent.storage.conn.execute(
                "PRAGMA freelist_count"
            ).fetchone()
        return {
            "ok": {
                "db_version": agent.storage.db_version(),
                "page_count": page_count,
                "freelist_count": freelist,
            }
        }

    return {"error": f"unknown command {cmd!r}"}


class AdminClient:
    """Synchronous UDS client for the admin protocol (CLI-side)."""

    def __init__(self, path: str, timeout: float = 5.0):
        import socket

        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(path)
        self._frames = wire.FrameReader()

    def call(self, cmd: str, **kwargs) -> dict:
        self.sock.sendall(wire.encode_msg({"cmd": cmd, **kwargs}))
        while True:
            data = self.sock.recv(65536)
            if not data:
                raise ConnectionError("admin socket closed")
            msgs = self._frames.feed(data)
            if msgs:
                resp = msgs[0]
                if "error" in resp:
                    raise RuntimeError(resp["error"])
                return resp["ok"]

    def close(self) -> None:
        self.sock.close()
