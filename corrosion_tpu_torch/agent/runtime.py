"""Agent runtime: the full node assembly.

Parity map (SURVEY.md §1):

* layer 5 (SWIM membership): asyncio UDP datagrams — announce, probe/ack
  with nonce matching, ping-req indirect probes, piggybacked member
  gossip, suspicion timeout → down, incarnation refutation
  (reference: foca runtime loop, ``broadcast/mod.rs:122-381``).
* layer 6 (dissemination): changesets gossiped over UDP to a ring0-first
  member sample with retransmit decay and rebroadcast-on-learn
  (``broadcast/mod.rs:405-1028``).
* layer 7 (anti-entropy): TCP sync sessions — handshake states, needs
  algebra, chunked changeset streaming, inbound session semaphore
  (``api/peer.rs:344-1719``).
* layer 8 (ingestion): dedupe cache, complete-version apply, partial
  buffering + promotion, emptyset clearing — all committed atomically
  with bookkeeping (``agent/util.rs:761-1380``).

The transport is length-prefixed JSON (see ``wire.py``) over plain
UDP/TCP — the codec/transport are deliberately isolated behind small
functions so QUIC/mTLS or a native codec can replace them.

A copy of ``corrosion_tpu/agent/runtime.py`` re-rooted on this package.
SQL, wire bytes, timers and protocol are the reference's.  The agent
runs on ``AgentConfig.device`` (default ``"cuda"``): its clock cache's
store and its batched apply's winner selection live there.  Every
surface of the reference's config runs: the HTTP API, subscriptions,
foca SWIM, the multiplexed transport, the PostgreSQL wire
(``pg_port``), the admin socket (``admin_path``) and signed
attribution (``sig_*``).  One deliberate
difference: a version that arrives in chunks reaches ``on_change`` (the
subscriptions) once, whole, when its last chunk applies it; the
reference's hands over each chunk on arrival, before the buffered
chunks are in the tables, and its subscriptions miss their rows.
"""

from __future__ import annotations

import logging

import asyncio
import hashlib
import os
import random
import sqlite3
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.agent import tracing, wire
from corrosion_tpu_torch.agent.metrics import percentile_sorted
from corrosion_tpu_torch.agent.locks import PRIO_HIGH, PRIO_LOW
from corrosion_tpu_torch.agent.bookkeeping import Bookie
from corrosion_tpu_torch.agent.members import Member, Members, MemberState
from corrosion_tpu_torch.agent.schema import apply_schema
from corrosion_tpu_torch.agent.storage import CrConn, unpack_stmt
from corrosion_tpu_torch.types import (
    ActorId,
    ChangeV1,
    Changeset,
    ChangeSource,
    HLClock,
    SyncNeedV1,
    SyncStateV1,
    Timestamp,
    Version,
)
from corrosion_tpu_torch.types.change import ChunkedChanges, MAX_CHANGES_BYTE_SIZE
from corrosion_tpu_torch.types.actor import ClusterId
from corrosion_tpu_torch.types.payload import BiPayload, BroadcastV1, UniPayload
from corrosion_tpu_torch.agent.transport import MAX_UDP_PAYLOAD
from corrosion_tpu_torch.bridge import speedy
from corrosion_tpu_torch.utils.ranges import RangeSet

# TCP stream preludes: one byte standing in for QUIC's uni/bi stream
# types; every byte after it is exactly the reference's stream content
# (u32-BE LengthDelimited speedy frames).
logger = logging.getLogger("corrosion_tpu_torch.agent")

STREAM_UNI = b"U"
STREAM_BI = b"B"
STREAM_MUX = b"M"  # multiplexed uni+bi channels (agent/mux.py)

# precomputed corro_change_lag_seconds label keys (provenance runs per
# ingested changeset — kwargs packing + sort per call is measurable)
_PROV_KEY_BROADCAST = (("path", "broadcast"),)
_PROV_KEY_REBROADCAST = (("path", "rebroadcast"),)
_PROV_KEY_SYNC = (("path", "sync"),)

# widest seq span a full changeset may legally claim: one local
# transaction's change count is bounded by what sqlite can hold in one
# tx; anything wider is a structurally-impossible (hostile) claim that
# would wedge partial buffering (see _screen_changeset)
_MAX_SEQ_SPAN = 1 << 32


def _changes_digest(changes) -> bytes:
    """Canonical content digest of a changeset's changes — the
    equivocation detector's identity for 'what this (actor, version)
    actually said'.  Sorted by (db_version, seq, table, pk, cid) so
    chunk-reassembly order cannot alias two identical contents apart."""
    h = hashlib.blake2b(digest_size=16)
    for ch in sorted(
        changes,
        key=lambda c: (int(c.db_version), int(c.seq), c.table, c.pk,
                       c.cid),
    ):
        h.update(repr((
            ch.table, ch.pk, ch.cid, ch.val, int(ch.col_version),
            int(ch.db_version), int(ch.seq), ch.site_id, int(ch.cl),
        )).encode())
    return h.digest()


def _sig_message_raw(actor: bytes, version: int, seq0: int, seq1: int,
                     last_seq: int, ts, digest: bytes) -> bytes:
    """The one place the signing-message wire layout lives: every
    signer and every verifier — including the evidence-time rebuild of
    a STORED half (``_stored_sig_message``) — must produce the same
    bytes, or provable signed equivocations silently downgrade to
    bounded-window verdicts."""
    return (
        b"corro-sig-v1"
        + actor
        + struct.pack(
            "<QQQQQ",
            int(version), int(seq0), int(seq1), int(last_seq),
            int(ts) if ts is not None else 0,
        )
        + digest
    )


def sig_message(actor: bytes, cs, digest: bytes = None) -> bytes:
    """The canonical byte string a changeset signature covers: the
    content digest BOUND to (actor, version, seq span, ts).  Binding
    the metadata matters — a signature over the digest alone could be
    replayed under re-written seq claims to wedge partial buffering
    with origin-attributed garbage.  Only FULL changesets are ever
    signed (equivocation is a full-changeset attack; empty/empty-set
    variants carry no content to conflict over).  ``digest`` lets hot
    callers that already computed ``_changes_digest`` skip the
    recompute (the sort+hash is the expensive part of this message)."""
    return _sig_message_raw(
        actor, cs.version, cs.seqs[0], cs.seqs[1], cs.last_seq, cs.ts,
        digest if digest is not None else _changes_digest(cs.changes),
    )


class _SlowPeer(Exception):
    """Sync serving aborted: the peer cannot keep up (peer.rs:796-811)."""


@dataclass
class AgentConfig:
    db_path: str
    gossip_host: str = "127.0.0.1"
    gossip_port: int = 0
    api_host: str = "127.0.0.1"
    api_port: int = 0
    bootstrap: List[str] = field(default_factory=list)
    schema_sql: Optional[str] = None
    cluster_id: int = 0
    # perf knobs (reference defaults in config.rs / broadcast mod)
    probe_interval: float = 0.4
    probe_timeout: float = 0.35
    # periodic membership gossip cadence (foca periodic_gossip; the
    # WAN preset gossips faster than it probes). 0 disables.
    gossip_interval: float = 0.2
    gossip_fanout: int = 3  # targets per gossip round (foca num_members)
    suspect_timeout: float = 2.0  # floor; scaled up with cluster size
    suspicion_mult: int = 4  # suspicion deadline growth multiplier
    num_indirect_probes: int = 3
    fanout: int = 3
    max_transmissions: int = 5
    rebroadcast_delay: float = 0.15
    sync_interval_min: float = 0.5
    sync_interval_max: float = 2.0
    sync_peers: int = 3
    max_sync_sessions: int = 3
    # batched serve pipeline (docs/sync.md): full-range needs resolve
    # versions -> db_versions in one bookkeeping pass, collect whole
    # spans off the event loop on RO-pool connections, and coalesce
    # changeset frames into buffered writes with one drain per budget.
    # False = the per-version parity oracle (bench baseline / tests)
    sync_batched_serve: bool = True
    # group-commit write combining (docs/writes.md): concurrent
    # execute_transaction callers coalesce into one storage-lock hold /
    # one outer transaction (per-client SAVEPOINTs), with ONE change
    # collection per group on a read-only pool connection off the event
    # loop.  False = the per-transaction parity oracle.
    write_group_commit: bool = True
    write_group_max: int = 64  # client batches per combined group
    seen_cache_size: int = 65536
    # ingest pipeline (handlers.rs:742-956 / config.rs:10-45 defaults)
    processing_queue_len: int = 20_000  # bounded, drop-oldest
    apply_queue_len: int = 50           # cost-based batch target
    apply_queue_timeout: float = 0.01   # batching tick
    max_concurrent_applies: int = 5     # apply worker threads
    # columnar CRDT merge kernel (docs/crdts.md "Columnar merge
    # kernel"): batched applies encode to flat arrays and resolve
    # causal/LWW winners via ops/merge.py segment reductions, sharing
    # ONE winner-selection core with the simulator's representation-
    # independence check.  Below the threshold (changes per table
    # batch), or when a hostile batch cannot encode, the per-change
    # dict replay — the parity oracle — runs instead.
    columnar_merge: bool = True
    columnar_merge_min: int = 256
    # device-resident apply (docs/crdts.md "Device-resident apply"):
    # keep hot (pk, cid) clock state in cross-batch device arrays and
    # flush SQLite through the write-behind journal.  None = auto —
    # on when ``device`` is the card, off when it is the CPU; True
    # forces it on (a torch store on ``device``), False forces the
    # classic prefetch path.
    device_cache: Optional[bool] = None
    device_cache_slots: int = 262144
    # broadcast buffering + governor (broadcast/mod.rs:399-458,745-801)
    bcast_buffer_cutoff: int = 64 * 1024
    bcast_flush_interval: float = 0.5
    bcast_rate_limit: float = 10 * 1024 * 1024  # bytes/s
    bcast_max_pending: int = 500        # drop-oldest-most-sent beyond this
    api_authz: Optional[str] = None
    subs_enabled: bool = True
    subs_path: Optional[str] = None
    subs_shards: int = 4                # matcher worker shards (by sub_id)
    subs_columnar: bool = True          # columnar wave matching fast path
    subs_shard_max_pending: int = 50_000  # per-shard depth before overflow
    admin_path: Optional[str] = None
    # append finished spans as OTLP-flavored JSON lines ([telemetry.traces]);
    # bounded: one rotation at max_bytes, drops counted after that
    trace_export_path: Optional[str] = None
    trace_export_max_bytes: int = 64 * 1024 * 1024
    # -- convergence observability plane (docs/telemetry.md) -----------
    # change provenance: on a version's FIRST arrival, record
    # origin-commit -> apply lag (corro_change_lag_seconds{path=
    # broadcast|rebroadcast|sync}) and per-origin-actor staleness —
    # the agent measures its own convergence
    provenance: bool = True
    # evict an origin actor's staleness entry once nothing has been
    # applied from it for this long AND it is no longer an alive
    # member: a departed (or identity-renewed, e.g. `cluster rejoin`)
    # actor must not leave a permanently rising
    # corro_change_staleness_seconds{actor_id=} series — and unbounded
    # label cardinality — on every node that ever applied its writes,
    # while a live-but-unconverged actor keeps alerting.  0 disables.
    staleness_evict_s: float = 600.0
    # carry hop + traceparent on uni broadcasts via the versioned
    # envelope (bridge/speedy.py encode_traced_uni): the write-group /
    # collect / remote-apply spans share one trace id, and receivers
    # can label lag broadcast vs rebroadcast.  Old-format payloads
    # always decode; turn this OFF for reference-byte-exact wire output
    bcast_trace_propagation: bool = True
    # always-on event-loop stall probe (agent/health.py, the bench
    # stall gates made continuous): corro_loop_stall_ms histogram +
    # max gauge + slow-callback attribution.  0 disables.
    stall_probe_interval: float = 0.05
    stall_probe_slow_ms: float = 50.0
    # flight recorder (agent/recorder.py, docs/telemetry.md): periodic
    # HLC-stamped metric snapshots + the typed event journal in a
    # bounded in-memory ring, merged cluster-wide by
    # ClusterObserver.flight_timeline.  0 disables the whole recorder
    # (snapshots AND journal).  The optional jsonl export reuses the
    # spans-export rotation/drop discipline ([telemetry.flight] path).
    flight_interval_s: float = 1.0
    flight_ring_max: int = 512
    flight_export_path: Optional[str] = None
    flight_export_max_bytes: int = 64 * 1024 * 1024
    # HLC clock skew (the scenario matrix's clock-skew fault family,
    # types/hlc.py skewed_now_ns): constant offset + linear drift
    # applied to THIS node's HLClock physical source.  Zero in
    # production — set per node by devcluster from the FaultPlan.
    clock_skew_ns: int = 0
    clock_drift: float = 0.0
    # equivocation defense (docs/faults.md): screen structurally-
    # impossible seq spans, detect conflicting contents re-claiming an
    # accepted (actor, version) via bounded content digests, and
    # quarantine the hostile actor (Members path) — dropping its
    # further changesets so it cannot poison CRDT state
    equivocation_detection: bool = True
    # how long an UNSIGNED equivocation quarantine holds before the
    # actor's traffic is admitted again (re-offense re-quarantines:
    # the digests survive).  The bounded window applies ONLY to
    # conflicts whose attribution could not be cryptographically
    # proven — a hostile relay can forge an unsigned actor id, so an
    # unbounded drop-all would let one forged message inflict
    # permanent divergence.  A VERIFIED signed conflicting pair (both
    # contents signed by the origin's key, types/crypto.py) is an
    # unframeable proof: that verdict is PERMANENT
    # (quarantine_reason="signed_equivocation", persisted across
    # restarts) and ignores this window.  0 = forever even unsigned
    # (only for harnesses that control every message source).
    equiv_quarantine_s: float = 300.0
    # -- signed changeset attribution (docs/faults.md) ------------------
    # 32-byte Ed25519 seed (types/crypto.py) signing this node's OWN
    # full changesets on the broadcast path; None (and no key file) =
    # unsigned, wire byte-exact vs the pre-signing envelope
    sig_secret: Optional[bytes] = None
    # production path: hex-encoded 32-byte seed on disk (chmod 600)
    sig_key_file: Optional[str] = None
    # trust directory: origin actor id -> 32-byte Ed25519 public key.
    # Verification only ever runs for actors present here; the agent
    # keeps a live REFERENCE (not a copy) so a harness can extend the
    # shared directory after boot
    sig_pubkeys: Optional[Dict[bytes, bytes]] = None
    # verify-on-evidence posture: signatures are verified when the
    # digest screen fires, when the span screen trips, and on a
    # bounded random spot check — hash-sampled per (node, actor,
    # version) at this rate (deterministic, no rng stream), and
    # additionally spaced at least sig_spot_check_min_interval_s apart
    # so pure-Python verification (~ms each) stays a tripwire, never
    # an ingest tax (the APPLY_BENCH sig A/B holds the ≥0.95 gate at
    # these defaults).  0 disables spot checks (evidence-driven
    # verification stays on)
    sig_spot_check_rate: float = 0.0
    sig_spot_check_min_interval_s: float = 0.5
    # evidence-triggered verification budget: conflicting duplicates
    # and span-screen trips admit at most this many verifications per
    # second (token bucket, burst 2x) — without it an attacker who
    # mutates one byte per replayed copy manufactures a ~ms verify per
    # message inside the apply workers.  Over budget the conflicting
    # duplicate is DROPPED with no verdict (it was never going to
    # apply; counted result=skipped) rather than falling back to the
    # unsigned bounded-window path, which would let the flood frame
    # the origin.  0 disables the budget (every evidence fires a
    # verify)
    sig_evidence_verify_rate: float = 64.0
    # -- Byzantine sync-serve client hardening (docs/faults.md) ---------
    # total wall/virtual budget for one outbound sync session: a
    # hostile server trickling one byte per read-timeout window would
    # otherwise hold a session (and its needs) hostage forever.
    # 0 disables the deadline
    sync_session_deadline_s: float = 60.0
    # -- snapshot bootstrap (docs/sync.md, agent/snapshot.py) -----------
    # serve side: answer snap_request sessions with a consistent
    # VACUUM-INTO copy (scrubbed via the shared snapshot registry) and
    # advertise per-actor snapshot floors in the sync handshake
    snapshot_serve: bool = True
    # client side: dispatch to snapshot install when a server's floors
    # cover needs it can no longer serve change-by-change; off = this
    # node only ever bootstraps change-by-change
    snapshot_install: bool = True
    # snap_chunk payload size on the serve stream
    snapshot_chunk_bytes: int = 256 * 1024
    # client-side offer screen: an advertised snapshot larger than this
    # is rejected before a byte is staged (reason=snap_offer)
    snapshot_max_bytes: int = 1 << 30
    # serve-side build cache: a restart storm re-serves ONE snapshot
    # file for this long instead of re-vacuuming per reborn client
    snapshot_cache_s: float = 5.0
    # history compaction: the snapshot floor advances to the contained
    # prefix minus this retain window — the newest `retain` versions
    # stay servable change-by-change (cheap incremental catch-up);
    # everything below the floor compacts its per-version bookkeeping
    # and is only obtainable via snapshot.  Negative disables floor
    # advancement entirely
    snapshot_retain_versions: int = 2000
    # maintenance-driven compaction cadence (docs/sync.md): the sweep
    # that finds overwritten versions AND advances snapshot floors runs
    # on its own loop at this interval, so an idle-but-serving node's
    # cleared spans and floor keep moving without a local write to
    # trigger the post-commit sweep.  0 disables the dedicated loop
    # (the slower maintenance_interval pass still runs it)
    compaction_interval: float = 30.0
    pg_port: Optional[int] = None  # PostgreSQL wire protocol (None = off)
    pg_host: Optional[str] = None  # PG bind host (None = api_host)
    # PG TLS client-cert verification is its OWN knob (corro-pg
    # verify_client): gossip mTLS must not lock psql-style clients out
    # of the SQL port
    pg_tls_verify_client: bool = False
    maintenance_interval: float = 60.0
    wal_truncate_pages: int = 250_000  # ~1 GB at 4 KiB pages
    vacuum_free_pages: int = 10_000
    # test-only instrumentation: prefix every uni frame with a 1-byte
    # hop count so a harness can measure real dissemination depth.
    # MUST stay off for reference-byte-exact wire compatibility.
    debug_hops: bool = False
    # ring0-first fanout for local changes (broadcast/mod.rs:586-643).
    # Calibration harnesses disable it so agents match the simulator's
    # uniform-sampling model (on loopback EVERY peer is ring0).
    ring0_enabled: bool = True
    # one multiplexed TCP connection per peer for uni + bi channels
    # (transport.rs single-QUIC-connection parity); off = one
    # connection per channel class
    transport_mux: bool = True
    # LRU cap on cached outbound uni connections (fd budget)
    uni_cache_size: int = 512
    # degraded-mode hardening knobs: bounded redials of dead cached
    # connections (utils.backoff decorrelated jitter), and the per-peer
    # circuit breaker that quarantines persistently-failing addresses
    # so one dead node cannot stall a broadcast flush round
    connect_timeout: float = 2.0
    redial_retries: int = 2
    redial_base: float = 0.05
    redial_cap: float = 0.5
    breaker_threshold: int = 5
    breaker_cooldown: float = 3.0
    # SWIM datagram format: "foca" = binary foca messages, the wire the
    # reference relays verbatim (broadcast/mod.rs:185-324, via
    # bridge/foca.py); "json" = the legacy debuggable envelope.
    # Receivers accept both (sniffed by first byte) regardless.
    swim_wire: str = "foca"
    # TLS over the gossip/sync TCP streams (main.rs:707-760 tooling,
    # peer.rs:128-318 rustls config). Off unless tls_cert_file is set;
    # SWIM datagrams stay plaintext UDP (see agent/tls.py).
    tls_cert_file: Optional[str] = None
    tls_key_file: Optional[str] = None
    tls_ca_file: Optional[str] = None
    tls_insecure: bool = False  # skip server-cert verification
    tls_client_required: bool = False  # mTLS: peers must present certs
    tls_client_cert_file: Optional[str] = None
    tls_client_key_file: Optional[str] = None
    # the one injectable time source (corrosion_tpu_torch/clock.py) behind
    # every agent timer: sleeps, monotonic state stamps, wall clocks
    # and the HLC physical source.  None = SYSTEM_CLOCK — real time,
    # behavior- and wire-byte-identical to the pre-clock agent
    clock: Optional[object] = None
    # fixed site (actor) id for a FRESH database; None = random uuid4
    # as before.  The virtual-time cluster derives ids from its seed so
    # two runs of one campaign are byte-identical; a restart from an
    # existing directory keeps the persisted id either way
    site_id: Optional[bytes] = None
    # where the clock cache's arrays live and the batched apply's
    # winner selection runs: "cuda" (raises without a card) or "cpu"
    # (the kernels' plain versions)
    device: str = "cuda"


async def _cancel_tasks(tasks, rounds: int = 5, timeout: float = 2.0):
    """Cancel ``tasks`` and wait until every one actually exits.

    A single cancel + gather is not enough on Python < 3.11:
    ``asyncio.wait_for`` can swallow a cancellation that races the
    inner future's completion (bpo-37658) — e.g. a probe ack landing
    in the same loop cycle as ``stop()``'s cancel — leaving a periodic
    loop task alive and the gather pending FOREVER.  Re-cancel each
    round until the set drains (bounded, so a truly stuck task can't
    hold shutdown hostage either)."""
    pending = list(tasks)
    for t in pending:
        t.cancel()
    for _ in range(rounds):
        if not pending:
            break
        done, pend = await asyncio.wait(pending, timeout=timeout)
        for t in done:
            if not t.cancelled():
                t.exception()  # retrieve, never raise at shutdown
        pending = list(pend)
        for t in pending:
            t.cancel()
    return pending


class Agent:
    """A full node: storage + bookkeeping + gossip + sync (+ HTTP API)."""

    def __init__(self, config: AgentConfig):
        from corrosion_tpu_torch import resolve_device

        # the device first: an agent asked for the card on a host
        # without one raises before it opens anything
        self.device = resolve_device(config.device)
        self.config = config
        from corrosion_tpu_torch.agent.locks import LockRegistry
        from corrosion_tpu_torch.clock import SYSTEM_CLOCK

        # the injectable time source (docs/sim.md, virtual time): every
        # timer/stamp below reads THIS, so a virtual-time campaign can
        # drive hundreds of agents off one event heap
        self._clock = config.clock or SYSTEM_CLOCK
        # lock tracking costs a few ops per acquisition on the hottest
        # lock; only pay for it when the admin surface can read it
        self.lock_registry = LockRegistry()
        # crash-safe snapshot install (agent/snapshot.py): a node
        # killed at ANY install point classifies here BEFORE storage
        # opens — either the swap completed (boot into the installed
        # snapshot + tail sync) or the sidecar/journal are discarded
        # (boot into the untouched previous database + clean retry)
        from corrosion_tpu_torch.agent import snapshot as snaplib

        self._snap_recovered = snaplib.recover_pending_install(
            config.db_path
        )
        self.storage = CrConn(
            config.db_path,
            site_id=config.site_id,
            lock_registry=self.lock_registry if config.admin_path else None,
        )
        self.bookie = Bookie(self.storage.conn, lock=self.storage._lock)
        # restart = resume: an older DB may predate __corro_sync_state
        self.bookie.backfill_own_sync_state(self.storage.site_id)
        if config.clock_skew_ns or config.clock_drift:
            from corrosion_tpu_torch.types.hlc import skewed_now_ns

            self.clock = HLClock(now_ns=skewed_now_ns(
                config.clock_skew_ns, config.clock_drift,
                base=self._clock.wall_ns,
            ))
        else:
            self.clock = HLClock(now_ns=self._clock.wall_ns)
        self.actor_id = self.storage.site_id
        self.members = Members(self.actor_id, clock=self._clock)
        from corrosion_tpu_torch.agent.metrics import Metrics

        self.metrics = Metrics()
        # columnar merge dispatch + merge-phase timing sink
        # (corro_apply_merge_seconds{kernel=}) for the storage layer
        self.storage.metrics = self.metrics
        self.storage.columnar_merge = config.columnar_merge
        self.storage.columnar_merge_min = config.columnar_merge_min
        # the batched apply's winner selection runs on the agent's
        # device, cache or not: an agent asked for the CPU never
        # reaches the card
        self.storage.device = self.device
        dev_on = config.device_cache
        if dev_on is None:
            dev_on = self.device.type == "cuda"
        if dev_on:
            self.storage.enable_device_cache(
                slots=config.device_cache_slots, backend="torch",
                device=self.device,
            )
        if self.storage.flush_journal_recovered:
            # boot classified the crash window between a committed
            # device-merge and its async flush (storage replayed the
            # journal before we got here)
            self.metrics.counter(
                "corro_apply_flush_recoveries_total",
                float(self.storage.flush_journal_recovered),
            )
        if self._snap_recovered is not None:
            self.metrics.counter(
                "corro_snapshot_recoveries_total",
                stage=self._snap_recovered,
            )
        # snapshot serve cache + build serialization (one VACUUM at a
        # time; a restart storm's clients share the cached file)
        self._snap_cache: Optional[tuple] = None
        self._snap_build_lock = threading.Lock()
        self._members_table()
        # incarnation survives restarts one-higher: a gracefully-left
        # node re-announces ALIVE above the DOWN record peers hold for
        # its previous life, so rejoin is immediate (foca renew())
        self.incarnation = self._load_incarnation() + 1
        self._persist_incarnation()
        # foca identity generation: our Actor.ts; a renewed (rejoined)
        # identity carries a fresh ts (actor.rs renew())
        self._identity_ts = int(self.clock.new_timestamp())
        # per-peer identity ts + per-update transmission counts (foca's
        # freshness-prioritized update backlog)
        self._swim_ts: Dict[bytes, int] = {}
        self._swim_update_tx: Dict[bytes, int] = {}
        self._probe_seq = 0  # wrapping u16 ProbeNumber counter
        self._seen: Dict[tuple, None] = {}
        # apply workers call handle_change concurrently; the seen cache's
        # check/insert/evict must be atomic across them
        self._seen_lock = threading.Lock()
        # debug_hops: seen-key -> hop depth at first receipt (harness
        # reads this to measure real dissemination depth)
        self._recv_hops: Dict[tuple, int] = {}
        # change provenance (first-seen dedupe): (actor, version) pairs
        # whose first-arrival lag was already recorded, FIFO-bounded
        # like the broadcast dedup cache; plus the freshest origin
        # wall-clock ts seen per actor (the staleness gauge's base)
        self._prov_seen: Dict[tuple, None] = {}
        self._prov_lock = threading.Lock()
        self._origin_ts_wall: Dict[bytes, float] = {}
        # LOCAL wall time of the most recent applied write per origin
        # actor — the eviction clock (idle time), deliberately separate
        # from the origin HLC ts above: evicting on origin-ts age would
        # delete a rising staleness series at exactly the moment its
        # "stopped converging" alert should fire
        self._origin_seen_wall: Dict[bytes, float] = {}
        # equivocation defense state: accepted-content digest per
        # (actor, version) — bounded FIFO like the dedup caches — and
        # the actors quarantined for hostile traffic (their further
        # changesets drop at _pre_change until the verdict's deadline;
        # actor -> monotonic expiry, inf when equiv_quarantine_s=0)
        self._equiv_digests: Dict[tuple, bytes] = {}
        self._equiv_lock = threading.Lock()
        self._equiv_quarantined: Dict[bytes, float] = {}
        # actors under a SIGNED (proof-backed) verdict: drives the
        # one-time escalation relabel in _note_equivocation
        self._equiv_proofed: set = set()
        # signed changeset attribution (docs/faults.md): this node's
        # Ed25519 identity (None = unsigned, wire byte-exact), the
        # trust directory (a live REFERENCE — harnesses extend it
        # after boot and respawns see the additions), accepted-content
        # signatures remembered next to the digests (the raw material
        # of a signed-equivocation proof), an own-signature cache (one
        # sign per local version, not per retransmission), and the
        # spot-check interval bound
        self._sig_secret: Optional[bytes] = None
        self._sig_pub: Optional[bytes] = None
        secret = config.sig_secret
        if secret is None and config.sig_key_file:
            with open(config.sig_key_file) as f:
                secret = bytes.fromhex(f.read().strip())
        if secret is not None:
            from corrosion_tpu_torch.types import crypto

            self._sig_secret = bytes(secret)
            self._sig_pub = crypto.public_key(self._sig_secret)
        self._sig_pubkeys: Dict[bytes, bytes] = (
            config.sig_pubkeys if config.sig_pubkeys is not None else {}
        )
        self._equiv_sigs: Dict[tuple, bytes] = {}  # (actor,v) -> 64-byte sig
        self._sig_own_cache: Dict[int, bytes] = {}
        self._sig_last_spot = float("-inf")
        # evidence-verification token bucket (sig_evidence_verify_rate)
        self._sig_ev_tokens = 2.0 * config.sig_evidence_verify_rate
        self._sig_ev_stamp = self._clock.monotonic()
        # guards the bucket and the spot-check stamp: apply workers
        # race their read-modify-writes, and an unsynchronized bucket
        # admits more ~ms verifies than the rate it exists to enforce
        self._sig_lock = threading.Lock()
        # digests survive restarts (__corro_equiv_digests): an
        # equivocator must not be able to wait out a reboot of its
        # victim — the conflicting re-send after a restart compares
        # against the RELOADED digest and re-quarantines immediately.
        # Gated: with detection off nothing ever reads or writes them
        if config.equivocation_detection:
            self._load_equiv_digests()
        # loop health probe (agent/health.py), created on start()
        self.health = None
        # flight recorder (agent/recorder.py): created NOW — event
        # seams fire before start() (e.g. a bootstrap breaker open) and
        # the journal must hold them; the snapshot loop starts with the
        # other tasks.  flight_interval_s = 0 disables the plane.
        if config.flight_interval_s > 0:
            from corrosion_tpu_torch.agent.recorder import FlightRecorder

            self.flight = FlightRecorder(
                self.metrics, self.clock,
                timebase=self._clock,
                interval=config.flight_interval_s,
                ring_max=config.flight_ring_max,
                export_path=config.flight_export_path,
                export_max_bytes=config.flight_export_max_bytes,
                crash_path=os.path.join(
                    os.path.dirname(config.db_path) or ".",
                    "flight_crash.jsonl",
                ),
            )
        else:
            self.flight = None
        # live sync sessions (client + server), admin `sync_sessions`:
        # id -> {role, peer, started (monotonic), needs_total,
        # needs_done, bytes}
        self._sync_live: Dict[int, dict] = {}
        self._sync_sess_seq = 0
        self._trace_token = None  # export ownership (set in start())
        self._trace_dropped_seen = 0  # last synced export-drop total
        self._acks: Dict[int, asyncio.Future] = {}
        self._suspects: Dict[bytes, float] = {}
        self._bcast_queue: asyncio.Queue = asyncio.Queue()
        # guards the _loop-is-set check vs start()'s flush of deferred
        # broadcasts (writes can come from any HTTP thread)
        self._bcast_gate = threading.Lock()
        self._pre_start_broadcasts: List[tuple] = []
        self._pre_start_cvs: List[ChangeV1] = []
        # bounded ingest queue (processing_queue_len, drop-oldest) drained
        # by the change loop in cost-based batches off the event loop
        from collections import deque

        self._ingest: "deque" = deque()
        self._ingest_event: Optional[asyncio.Event] = None
        self._apply_pool = None  # ThreadPoolExecutor, created on start
        self._apply_inflight: set = set()  # up to max_concurrent_applies
        self._apply_gauge_lock = threading.Lock()
        self._apply_active = 0  # batches currently executing (threads)
        self._apply_max_overlap = 0  # high-water mark, for tests/metrics
        self._bcast_wakeups = 0  # broadcast-loop iterations (idle = 0/s)
        self.transport = None  # Transport, created on start
        self._conn_tasks: set = set()  # live inbound connection handlers
        self._tasks: List[asyncio.Task] = []
        self._udp: Optional[asyncio.DatagramTransport] = None
        self._tcp: Optional[asyncio.AbstractServer] = None
        self._sync_sem: Optional[asyncio.Semaphore] = None
        # generate_sync snapshot cache keyed on the bookie generation
        # (dirty flag): (gen, SyncStateV1) — see generate_sync()
        self._sync_gen_cache: Optional[tuple] = None
        # serve-side collection workers (lazy: tests drive _serve_need
        # without start()); distinct from the apply pool so a long
        # backfill serve can't starve change application
        self._serve_pool = None
        # group-commit write combiner (agent/writes.py): callers of
        # execute_transaction coalesce into shared commits; the leader
        # is always a caller thread, so this works without the loop
        from corrosion_tpu_torch.agent.writes import WriteCombiner

        self._write_combiner = WriteCombiner(
            self, max_group=config.write_group_max
        )
        # single-thread local-broadcast collection worker (lazy): keeps
        # collect_changes + chunk encoding for local commits OFF the
        # event loop while preserving version order of on_change fanout
        self._wbcast_pool = None
        self._wbcast_lock = threading.Lock()
        self._wbcast_closed = False  # stop(): no lazy pool rebirth
        self._sync_server_sessions = 0  # in-flight inbound sessions
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        if config.schema_sql:
            apply_schema(self.storage, config.schema_sql)
        # register any pending backfill versions — from this boot's schema
        # apply OR left over from a crash before registration completed
        self._register_backfills()
        self._rng = random.Random(int.from_bytes(self.actor_id[:4], "big"))
        self._http = None
        self.gossip_addr: Tuple[str, int] = (config.gossip_host, config.gossip_port)
        self.api_addr: Tuple[str, int] = (config.api_host, config.api_port)
        self.on_change = None  # hook(ChangeV1) for subscriptions layer
        # (actor, version) -> the changes of a partial version its last
        # chunk just promoted, for that chunk's on_change
        self._promoted: Dict[Tuple[bytes, int], list] = {}
        # fault injection (corrosion_tpu_torch.faults): the controller and the
        # per-agent hook, installed by devcluster/chaos harnesses before
        # start(); None in production
        self.faults = None  # FaultController (introspection/admin)
        self.fault_filter = None  # hook(channel, addr) -> FaultAction
        self.subs = None  # SubsManager, attached by setup when enabled
        self._admin = None
        self._pg = None
        self.pg_addr: Optional[Tuple[str, int]] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _flight_event(self, kind: str, /, **attrs) -> None:
        """Journal one typed event into the flight ring (no-op when the
        recorder is disabled).  Emission sites are the protocol seams —
        see recorder.EVENT_KINDS for the registry.  ``kind`` is
        positional-only: several events legitimately carry a ``kind``
        ATTRIBUTE (e.g. an equivocation verdict's detection kind)."""
        f = self.flight
        if f is None:
            return
        try:
            f.event(kind, **attrs)
        except Exception:
            # telemetry must never break the seam it observes: the
            # emission sites sit inside quarantine/fallback/serve paths
            # whose correctness outranks the journal.  Counted loudly —
            # a silent journaling bug would hollow out the flight ring
            self.metrics.counter("corro_flight_journal_errors_total")
            logger.exception("flight event %r failed", kind)

    def _spawn_task(self, coro, name: str) -> asyncio.Task:
        """Create one long-lived agent task under the crash-dump
        supervisor: an UNHANDLED exception (not cancellation — the
        agent owns those) flushes the flight ring to disk before the
        task dies, so the history leading up to a dead loop survives
        it instead of evaporating with the process state."""
        async def supervised():
            try:
                await coro
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                logger.exception("agent task %r died", name)
                if self.flight is not None:
                    self.flight.crash_dump(
                        f"task {name}: {type(e).__name__}: {e}"
                    )
                raise

        return asyncio.create_task(supervised())

    async def start(self) -> None:
        if self.config.trace_export_path:
            self._trace_token = tracing.configure_export(
                self.config.trace_export_path,
                max_bytes=self.config.trace_export_max_bytes,
            )
            # baseline against the process-lifetime drop total: drops
            # from a PREVIOUS owner's sink are not this agent's to claim
            self._trace_dropped_seen = tracing.export_dropped_total()
        # publish the loop and drain deferred broadcasts atomically, so a
        # concurrent writer either defers (and is flushed below) or sees
        # the live loop — never a stranded append
        with self._bcast_gate:
            self._loop = asyncio.get_running_loop()
            pending = self._pre_start_broadcasts
            self._pre_start_broadcasts = []
            pending_cvs = self._pre_start_cvs
            self._pre_start_cvs = []
        if pending:
            # deferred pre-start commits: collection runs on the
            # write-bcast worker, never on the event loop starting up
            # (start() precedes stop(), so the pool can't be closed)
            self._wbcast_executor().submit(
                self._broadcast_local_commits, pending
            )
        for cv, tp in pending_cvs:
            self.metrics.counter(
                "corro_channel_sends_total", channel="bcast")
            self._bcast_queue.put_nowait(
                (cv, self.config.max_transmissions, 0, tp, None)
            )
        self._sync_sem = asyncio.Semaphore(self.config.max_sync_sessions)
        self._ingest_event = asyncio.Event()
        from concurrent.futures import ThreadPoolExecutor

        from corrosion_tpu_torch.agent.transport import Transport

        self._apply_pool = ThreadPoolExecutor(
            max_workers=self.config.max_concurrent_applies,
            thread_name_prefix="corro-apply",
        )
        from corrosion_tpu_torch.agent.tls import contexts_from_config

        tls_server_ctx, tls_client_ctx = contexts_from_config(self.config)
        self.transport = Transport(
            metrics=self.metrics, on_rtt=self._record_rtt,
            max_cached=self.config.uni_cache_size,
            ssl_context=tls_client_ctx,
            mux=self.config.transport_mux,
            connect_timeout=self.config.connect_timeout,
            redial_retries=self.config.redial_retries,
            redial_base=self.config.redial_base,
            redial_cap=self.config.redial_cap,
            breaker_threshold=self.config.breaker_threshold,
            breaker_cooldown=self.config.breaker_cooldown,
            on_breaker=self._on_breaker,
            # seeded off the actor id: det-mode replays draw the same
            # redial backoff schedule (utils/backoff.retry)
            rng=random.Random(
                int.from_bytes(self.actor_id[4:8], "big") ^ 0x5EED
            ),
            clock=self._clock,
        )
        if self.fault_filter is not None:
            self.transport.fault_filter = self.fault_filter
        # one gossip port for both datagrams (SWIM) and streams, like the
        # reference's single QUIC/UDP endpoint; with an ephemeral port the
        # TCP side of the pair may be taken by someone else — rebind
        for attempt in range(16):
            self._udp, _ = await self._loop.create_datagram_endpoint(
                lambda: _UdpProtocol(self),
                local_addr=(self.config.gossip_host, self.config.gossip_port),
            )
            self.gossip_addr = self._udp.get_extra_info("sockname")[:2]
            try:
                self._tcp = await asyncio.start_server(
                    self._serve_tcp, self.config.gossip_host,
                    self.gossip_addr[1],
                    ssl=tls_server_ctx,
                )
                break
            except OSError:
                self._udp.close()
                self._udp = None
                if self.config.gossip_port != 0 or attempt == 15:
                    raise
        self._load_members()
        # persisted members loaded AFTER the proof reload in __init__:
        # re-assert the permanent signed verdicts on the records that
        # just appeared (the boot-time set_quarantined no-op'd on them).
        # Keyed on the explicit proof set, NOT deadline == inf: with
        # equiv_quarantine_s=0 UNSIGNED verdicts park at inf too, and
        # a pre-run() unsigned verdict must never boot-relabel a
        # possibly-framed actor as a proven signed equivocator
        with self._equiv_lock:
            proven = [
                actor for actor in self._equiv_quarantined
                if actor in self._equiv_proofed
            ]
        for actor in proven:
            self.members.set_quarantined(
                actor, True, reason="signed_equivocation"
            )
        if self.config.subs_enabled:
            from corrosion_tpu_torch.agent.pubsub import SubsManager

            self.subs = SubsManager(self, self.config.subs_path)
        self._tasks = [
            self._spawn_task(self._announce_loop(), "announce"),
            self._spawn_task(self._probe_loop(), "probe"),
            self._spawn_task(self._suspect_reaper(), "suspect"),
            self._spawn_task(self._gossip_loop(), "gossip"),
            self._spawn_task(self._broadcast_loop(), "broadcast"),
            self._spawn_task(self._change_loop(), "change"),
            self._spawn_task(self._sync_loop(), "sync"),
            self._spawn_task(self._maintenance_loop(), "maintenance"),
        ]
        if self.config.compaction_interval > 0:
            self._tasks.append(
                self._spawn_task(self._compaction_loop(), "compaction")
            )
        if self.config.stall_probe_interval > 0:
            from corrosion_tpu_torch.agent.health import LoopHealthProbe

            self.health = LoopHealthProbe(
                self.metrics,
                interval=self.config.stall_probe_interval,
                slow_ms=self.config.stall_probe_slow_ms,
                clock=self._clock,
            )
            self._tasks.append(
                self._spawn_task(self.health.run(), "health")
            )
        if self.flight is not None:
            self._tasks.append(
                self._spawn_task(self.flight.run(), "flight")
            )
        if self.config.api_port is not None:
            from corrosion_tpu_torch.agent.http import start_http_api

            self._http = start_http_api(self)
            self.api_addr = self._http.server_address[:2]
        if self.config.admin_path:
            from corrosion_tpu_torch.agent.admin import start_admin

            self._admin = await start_admin(self, self.config.admin_path)
        if self.config.pg_port is not None:
            from corrosion_tpu_torch.agent.pg import serve_pg

            self._pg = await serve_pg(
                self,
                self.config.pg_host or self.config.api_host,
                self.config.pg_port,
            )
            self.pg_addr = self._pg.sockets[0].getsockname()[:2]

    async def stop(self, graceful: bool = True) -> None:
        # graceful leave (broadcast/mod.rs:327-366 leave_cluster): tell
        # alive peers we are going down so they drop us immediately
        # instead of burning a probe->suspect->down cycle on us.
        # graceful=False simulates a crash (tests of the suspicion path)
        if graceful and self._udp is not None:
            self._swim_leave()
        await _cancel_tasks(self._tasks)
        self._tasks = []
        # drain in-flight apply batches before tearing down connections /
        # storage — a worker must never touch a closed resource
        if self._apply_inflight:
            await asyncio.gather(
                *self._apply_inflight, return_exceptions=True
            )
            self._apply_inflight.clear()
        if self._apply_pool is not None:
            self._apply_pool.shutdown(wait=True)
        if self.transport is not None:
            await self.transport.aclose()
        await _cancel_tasks(list(self._conn_tasks))
        # after the connection handlers: a live sync session must not
        # race a shut-down collection pool
        if self._serve_pool is not None:
            self._serve_pool.shutdown(wait=True)
            self._serve_pool = None
        # drain queued local-broadcast collections before storage goes
        # away (their RO reads must not race close).  The closed flag
        # flips under the lock BEFORE shutdown so a write completing
        # concurrently with stop() can't lazily rebirth a pool that
        # would read closing storage and leak its thread — late
        # dispatches drop instead (the versions are durable;
        # anti-entropy serves them after restart)
        with self._wbcast_lock:
            self._wbcast_closed = True
            pool, self._wbcast_pool = self._wbcast_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self._udp:
            self._udp.close()
            self._udp = None  # liveness marker: stopped agents don't send
        if self._tcp:
            self._tcp.close()
            try:
                # wait_closed waits for every handler's transport to
                # flush; a peer that stopped reading would hold shutdown
                # hostage
                await asyncio.wait_for(self._tcp.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass
        if self._http:
            self._http.shutdown()
            self._http.server_close()
        if self._admin is not None:
            self._admin.close()
            await self._admin.wait_closed()
        if self._pg is not None:
            self._pg.close()
            # abort live sessions: wait_closed() waits for every
            # handler, so an idle client would hold stop() forever.
            # abort (not close): close() flushes first, and a peer
            # that stopped reading would outlive the grace period and
            # touch storage after it closes.  Two abort passes: a
            # connection accepted just before close() can register in
            # corro_conns after the first snapshot
            for timeout in (1.0, 1.0):
                for w in list(getattr(self._pg, "corro_conns", ())):
                    try:
                        w.transport.abort()
                    except Exception:
                        pass
                try:
                    await asyncio.wait_for(
                        self._pg.wait_closed(), timeout=timeout
                    )
                    break
                except asyncio.TimeoutError:
                    continue
        if self.subs is not None:
            self.subs.close()
        if self.config.trace_export_path:
            # symmetric with start(), but only if OUR sink is still the
            # active one — another agent in this process may own it now
            tracing.disable_export_if(getattr(self, "_trace_token", None))
        if self.flight is not None:
            self.flight.close()
        self._persist_members()
        self.storage.close()

    # ------------------------------------------------------------------
    # member persistence (__corro_members parity)
    # ------------------------------------------------------------------

    def metric_gauges(self) -> List[tuple]:
        """Scrape-time gauges matching the reference's metrics loop
        (``agent/metrics.rs:18-108`` collect_metrics + pool/transport
        emit_metrics): per-table row counts, per-actor buffered-change
        rows and bookkeeping-gap sums, db/WAL sizes and freelist, queue
        depths, and aggregate transport ConnStats."""
        extra: List[tuple] = []
        # committed-state reads ride the READ pool: a scrape must not
        # hold the write lock across full-table COUNT(*) scans and
        # stall PRIO_HIGH client writes (the reference's metrics loop
        # reads through its read pool too)
        for t in self.storage.tables:
            # identifier-quote the table name: a schema may legally
            # declare adversarial names (embedded quotes) and a scrape
            # must not turn them into SQL — exposition escaping keeps
            # the label value scrape-safe regardless
            q = t.replace('"', '""')
            _, rows = self.storage.read_query(
                f'SELECT COUNT(*) FROM "{q}"'
            )
            extra.append(
                ("corro_table_rows", float(rows[0][0]), {"table": t})
            )
        _, rows = self.storage.read_query(
            "SELECT actor_id, COUNT(*) FROM __corro_buffered_changes"
            " GROUP BY actor_id"
        )
        for actor, n in rows:
            extra.append((
                "corro_db_buffered_changes_rows", float(n),
                {"actor_id": bytes(actor).hex()},
            ))
        _, rows = self.storage.read_query("PRAGMA freelist_count")
        extra.append(
            ("corro_db_freelist_pages", float(rows[0][0]), {})
        )
        _, rows = self.storage.read_query(
            "SELECT value FROM __corro_state WHERE key='db_version'"
        )
        extra.append(("corro_db_version", float(rows[0][0]), {}))
        # version-gap sums per actor (corro.db.gaps.sum parity): the
        # bookie's RangeSets mutate under the storage lock.  Best
        # effort — a scrape must not queue behind a long write, so if
        # the lock isn't free quickly the gap series is simply omitted
        # this round (the next scrape catches up)
        if self.storage._lock.acquire(PRIO_LOW, timeout=0.25):
            try:
                for actor, booked in self.bookie.actors().items():
                    gap_sum = sum(
                        e - s + 1 for s, e in booked.needed.spans()
                    )
                    if gap_sum:
                        extra.append((
                            "corro_db_gaps_sum", float(gap_sum),
                            {"actor_id": actor.hex()},
                        ))
            finally:
                self.storage._lock.release()
        for name, path in (
            ("corro_db_size_bytes", self.config.db_path),
            ("corro_db_wal_size_bytes", self.config.db_path + "-wal"),
        ):
            try:
                extra.append((name, float(os.stat(path).st_size), {}))
            except OSError:
                pass
        extra.extend([
            ("corro_members_alive", float(len(self.members.alive())), {}),
            ("corro_members_suspect", float(sum(
                1 for m in self.members.all()
                if m.state is MemberState.SUSPECT)), {}),
            ("corro_members_down", float(sum(
                1 for m in self.members.all()
                if m.state is MemberState.DOWN)), {}),
            ("corro_members_ring0", float(len(self.members.ring0())), {}),
        ])
        # channel/queue depths (channel.rs metered-channel parity)
        extra.append(
            ("corro_change_queue_depth", float(len(self._ingest)), {})
        )
        extra.append((
            "corro_bcast_queue_depth",
            float(self._bcast_queue.qsize()), {},
        ))
        extra.append((
            "corro_sync_server_sessions",
            float(self._sync_server_sessions), {},
        ))
        extra.append((
            "corro_write_queue_depth",
            float(self._write_combiner.depth()), {},
        ))
        if self.subs is not None:
            # subscription-plane gauges (pubsub.py): pending/matcher
            # queue depths + per-subscription staleness
            extra.extend(self.subs.metric_gauges())
        # transport ConnStats aggregates (transport.rs:235-419 export)
        if self.transport is not None:
            stats = list(self.transport.stats.values())
            extra.append(
                ("corro_transport_peers", float(len(stats)), {})
            )
            for field in ("connects", "bytes_sent", "frames_sent",
                          "failures", "faults_dropped", "redials",
                          "breaker_opens"):
                extra.append((
                    f"corro_transport_{field}",
                    float(sum(getattr(s, field) for s in stats)), {},
                ))
            extra.append((
                "corro_transport_breakers_open",
                # list() snapshot: apply workers insert convictions
                # concurrently and a plain generator over .values()
                # races the resize
                float(sum(
                    1 for b in list(self.transport.breakers.values())
                    if b.is_open
                )), {},
            ))
            rtts = [s.rtt_min_ms for s in stats if s.rtt_min_ms is not None]
            if rtts:
                extra.append(
                    ("corro_transport_rtt_min_ms", float(min(rtts)), {})
                )
        # per-origin-actor staleness (provenance plane): wall-now minus
        # the freshest origin-commit ts applied from that actor — a
        # rising series means we stopped converging on its writes
        now_wall = self._clock.wall()
        for actor, ts_wall in self._staleness_entries(now_wall):
            extra.append((
                "corro_change_staleness_seconds",
                max(0.0, now_wall - ts_wall),
                {"actor_id": actor.hex()},
            ))
        # bounded trace export drops: the sink is process-wide, so ONLY
        # the agent whose token opened the CURRENTLY active sink syncs
        # the global total into its counter — if every past owner of an
        # in-process cluster claimed the delta, summing the family
        # across nodes would overcount drops n_owners-fold
        if tracing.export_token_active(self._trace_token):
            dropped = tracing.export_dropped_total()
            if dropped > self._trace_dropped_seen:
                self.metrics.counter(
                    "corro_trace_spans_dropped_total",
                    dropped - self._trace_dropped_seen,
                )
                self._trace_dropped_seen = dropped
        return extra

    def _staleness_entries(self, now_wall: float):
        """Snapshot ``(actor, freshest-origin-ts)`` pairs, evicting on
        the way out the entries of actors that are BOTH idle past
        ``staleness_evict_s`` (no write applied from them locally — the
        idle clock, not the origin-ts age, which a partition or a slow
        remote clock legitimately grows) AND not an alive cluster
        member — a departed or identity-renewed actor must not leave a
        permanently rising staleness series (and ever-growing label
        cardinality) behind, while a live-but-unconverged actor keeps
        alerting.  A later write from the actor re-creates its entry on
        first arrival."""
        evict = self.config.staleness_evict_s
        with self._prov_lock:
            if evict > 0:
                dead = []
                for a, seen in self._origin_seen_wall.items():
                    if now_wall - seen <= evict:
                        continue
                    m = self.members.get(a)
                    if m is not None and m.state is not MemberState.DOWN:
                        continue
                    dead.append(a)
                for a in dead:
                    self._origin_seen_wall.pop(a, None)
                    self._origin_ts_wall.pop(a, None)
            return list(self._origin_ts_wall.items())

    def health_snapshot(self) -> dict:
        """Runtime health for the admin ``health`` command: the loop
        stall probe's state, queue depths, apply concurrency, per-path
        convergence lag (windowed quantiles from the agent's own
        provenance measurement), and per-origin staleness — the
        always-on form of the gates the benches enforce."""
        now_wall = self._clock.wall()
        staleness = {
            actor.hex(): round(max(0.0, now_wall - ts), 3)
            for actor, ts in self._staleness_entries(now_wall)
        }
        lag: Dict[str, dict] = {}
        for key, samples in self.metrics.histogram_samples(
            "corro_change_lag_seconds"
        ).items():
            if not samples:
                continue
            path = dict(key).get("path", "?")
            s = sorted(samples)
            count, total = self.metrics.histogram_stats(
                "corro_change_lag_seconds", path=path
            )
            lag[path] = {
                "count": count,
                "p50_s": round(percentile_sorted(s, 0.5), 4),
                "p99_s": round(percentile_sorted(s, 0.99), 4),
                "max_s": round(s[-1], 4),
                "mean_s": round(total / max(count, 1), 4),
            }
        return {
            "actor": self.actor_id.hex(),
            "loop": self.health.snapshot() if self.health else None,
            "flight": self.flight.snapshot() if self.flight else None,
            "queues": {
                "changes": len(self._ingest),
                "bcast": self._bcast_queue.qsize() if self._loop else 0,
                "write": self._write_combiner.depth(),
            },
            "apply_in_flight": self._apply_active,
            "members_alive": len(self.members.alive()),
            "convergence_lag": lag,
            "origin_staleness_s": staleness,
        }

    def provenance_first_seen(self) -> Dict[tuple, tuple]:
        """Snapshot of the provenance first-seen stamps:
        ``(actor_bytes, version) -> (wall_seconds, hlc_int)`` for every
        remote version whose first arrival this node recorded (bounded
        by ``seen_cache_size``).  The timeline plane's per-node raw
        material (``ClusterObserver.coverage_curve``)."""
        with self._prov_lock:
            return {
                k: v for k, v in self._prov_seen.items()
                if v is not None
            }

    def _members_table(self) -> None:
        self.storage.conn.execute(
            "CREATE TABLE IF NOT EXISTS __corro_members ("
            " actor_id BLOB PRIMARY KEY, host TEXT, port INTEGER,"
            " state TEXT, incarnation INTEGER)"
        )

    def _persist_members(self) -> None:
        with self.storage._lock:
            self.storage.conn.execute("DELETE FROM __corro_members")
            self.storage.conn.executemany(
                "INSERT OR REPLACE INTO __corro_members VALUES (?, ?, ?, ?, ?)",
                [
                    (m.actor_id, m.addr[0], m.addr[1], m.state.value, m.incarnation)
                    for m in self.members.all()
                ],
            )

    def _load_members(self) -> None:
        for actor, host, port, state, inc in self.storage.conn.execute(
            "SELECT actor_id, host, port, state, incarnation FROM __corro_members"
        ):
            self.members.upsert(
                bytes(actor), (host, port), MemberState(state), inc
            )

    # ------------------------------------------------------------------
    # SWIM: announce / probe / suspicion
    # ------------------------------------------------------------------

    def _self_entry(self) -> list:
        return [
            wire._b64(self.actor_id),
            self.gossip_addr[0],
            self.gossip_addr[1],
            MemberState.ALIVE.value,
            self.incarnation,
            self._identity_ts,
        ]

    def _piggyback(self, k: int = 5) -> list:
        entries = [self._self_entry()]
        members = self.members.all()
        for m in self._rng.sample(members, min(k, len(members))):
            entries.append(
                [
                    wire._b64(m.actor_id),
                    m.addr[0],
                    m.addr[1],
                    m.state.value,
                    m.incarnation,
                    # identity ts rides the JSON wire too, so a member
                    # learned here is advertised with its real identity
                    # generation on the foca wire (mixed-wire clusters)
                    self._swim_ts.get(m.actor_id, 0),
                ]
            )
        return entries

    def _ingest_piggyback(self, entries: list) -> None:
        for entry in entries:
            actor_b64, host, port, state, inc = entry[:5]
            ts = entry[5] if len(entry) > 5 else 0
            actor = wire._unb64(actor_b64)
            if actor == self.actor_id:
                # refute anything non-alive said about us
                if state != MemberState.ALIVE.value and inc >= self.incarnation:
                    self.incarnation = inc + 1
                    self._persist_incarnation()
                continue
            known_ts = self._swim_ts.get(actor, 0)
            if 0 < ts < known_ts:
                # a real but STALE identity generation: discard, or an
                # old DOWN record would override the renewed member by
                # incarnation (swim_foca._ingest_update's guard).
                # ts == 0 means "generation unknown" (legacy peer) and
                # falls through to plain incarnation rules
                continue
            if ts > known_ts:
                # renewed identity generation: the fresh incarnation
                # space must override a stale DOWN record, so drop the
                # old member — and its suspicion timer: the new
                # generation must not inherit the old one's deadline
                self._swim_ts[actor] = ts
                if self.members.get(actor) is not None:
                    self.members.remove(actor)
                self._suspects.pop(actor, None)
            if self.members.upsert(
                actor, (host, port), MemberState(state), inc
            ):
                self._swim_update_tx[actor] = 0  # fresh news
                self.note_member_state(actor, MemberState(state))

    def _send_udp(self, addr: Tuple[str, int], msg: dict) -> None:
        if self._udp:
            if self.fault_filter is not None:
                act = self.fault_filter("udp", tuple(addr))
                if act is not None and act.drop:
                    # SWIM datagrams are unreliable by design: an
                    # injected drop is indistinguishable from the
                    # network eating the packet
                    self.metrics.counter(
                        "corro_transport_faults_injected_total",
                        kind="udp",
                    )
                    return
                if act is not None and act.delay and self._loop:
                    data_msg = dict(msg)
                    self._loop.call_later(
                        act.delay, self._send_udp_now, addr, data_msg
                    )
                    return
            self._send_udp_now(addr, msg)

    def _send_udp_now(self, addr: Tuple[str, int], msg: dict) -> None:
        if self._udp:
            if self.config.cluster_id:
                # SWIM is cluster-scoped like the foca identity's
                # cluster_id (actor.rs:222): receivers in other
                # clusters drop the datagram, so membership — not just
                # the data plane — partitions on cluster id
                msg.setdefault("c", self.config.cluster_id)
            data = wire.encode_datagram(msg)
            if len(data) > MAX_UDP_PAYLOAD:
                # foca caps SWIM packets at 1178 B (broadcast/mod.rs:943);
                # anything bigger belongs on a uni-stream
                self.metrics.counter("corro_udp_oversize_dropped_total")
                return
            self.metrics.counter(
                "corro_gossip_datagrams_sent_total",
                kind=(msg.get("k") if msg.get("k") in _SWIM_KINDS
                      else "other"),
            )
            self._udp.sendto(data, tuple(addr))

    def _next_probe_number(self) -> int:
        """Wrapping u16 probe counter (foca's ProbeNumber space): a
        sequential counter cannot collide across the ≤2 concurrent
        probes the loop runs, where random 16-bit draws eventually
        would — a collision overwrites one probe's ack future and the
        loser reads as a failed probe."""
        self._probe_seq = (self._probe_seq + 1) & 0xFFFF
        return self._probe_seq

    def _swim_announce(self, addr: Tuple[str, int]) -> None:
        if self.config.swim_wire == "foca":
            from corrosion_tpu_torch.agent import swim_foca

            swim_foca.announce(self, addr)
        else:
            self._send_udp(addr, {"k": "announce", "pb": self._piggyback()})

    def _swim_probe(self, m: Member, nonce: int) -> None:
        if self.config.swim_wire == "foca":
            from corrosion_tpu_torch.agent import swim_foca

            swim_foca.probe(self, m, nonce)
        else:
            self._send_udp(
                m.addr, {"k": "probe", "n": nonce, "pb": self._piggyback()}
            )

    def _swim_ping_req(self, helper: Member, target: Member,
                       nonce: int) -> None:
        if self.config.swim_wire == "foca":
            from corrosion_tpu_torch.agent import swim_foca

            swim_foca.ping_req(self, helper, target, nonce)
        else:
            self._send_udp(
                helper.addr,
                {
                    "k": "ping_req",
                    "n": nonce,
                    "target": [target.addr[0], target.addr[1]],
                    "reply_to": [self.gossip_addr[0], self.gossip_addr[1]],
                },
            )

    def _swim_leave(self) -> None:
        if self.config.swim_wire == "foca":
            from corrosion_tpu_torch.agent import swim_foca

            swim_foca.leave(self)
        else:
            for m in self.members.alive():
                self._send_udp(
                    m.addr,
                    {"k": "leave", "a": wire._b64(self.actor_id),
                     "i": self.incarnation},
                )

    async def _announce_loop(self) -> None:
        delay = 0.1
        while True:
            known = {m.addr for m in self.members.alive()}
            targets = [
                _parse_addr(b) for b in self.config.bootstrap
            ]
            for addr in targets:
                if addr != self.gossip_addr and addr not in known:
                    try:
                        self._swim_announce(addr)
                    except Exception:
                        # a bad bootstrap entry must not kill the loop
                        self.metrics.counter(
                            "corro_swim_announce_errors_total"
                        )
            if known or not targets:
                delay = min(delay * 2, 30.0)
            await self._clock.sleep(delay)

    def _load_incarnation(self) -> int:
        row = self.storage.conn.execute(
            "SELECT value FROM __corro_state WHERE key='incarnation'"
        ).fetchone()
        return int(row[0]) if row else 0

    def _persist_incarnation(self) -> None:
        with self.storage._lock:
            self.storage.conn.execute(
                "INSERT INTO __corro_state (key, value) "
                "VALUES ('incarnation', ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (self.incarnation,),
            )

    def rejoin(self) -> int:
        """Renew our identity and re-announce (foca ``Identity::renew``
        + the admin Rejoin command, ``actor.rs:199-210``): bump our
        incarnation (and, on the foca wire, our identity ts — a renewed
        identity is a fresh generation that replaces any stale DOWN
        record wholesale) so peers holding a stale/suspect view refresh
        it, then announce to every known member and configured
        bootstrap."""
        self.incarnation += 1
        self._persist_incarnation()
        self._identity_ts = max(
            self._identity_ts + 1, int(self.clock.new_timestamp())
        )
        targets = {tuple(m.addr) for m in self.members.alive()}
        targets.update(_parse_addr(b) for b in self.config.bootstrap)
        targets.discard(tuple(self.gossip_addr))
        for addr in targets:
            try:
                self._swim_announce(addr)
            except Exception:
                # one bad (e.g. unresolvable) target must not abort the
                # whole rejoin fan-out
                self.metrics.counter("corro_swim_announce_errors_total")
        return len(targets)

    def apply_schema_sql(self, sql: str) -> List[str]:
        """Apply schema additions (new tables/columns) to the live
        agent; returns touched table names.  The one shared entry point
        for /v1/migrations, SIGHUP reload, and tests — blocking, so
        call it off the event loop."""
        from corrosion_tpu_torch.agent.schema import apply_schema

        with self.storage._lock:
            touched = apply_schema(self.storage, sql)
            self._register_backfills()
        return touched

    def set_cluster_id(self, cluster_id: int) -> int:
        """Move this node to another cluster (admin ``cluster set-id``,
        ``corro-admin/src/lib.rs`` Cluster SetId → FocaCmd change
        identity): SWIM datagrams and data-plane payloads to/from peers
        with a different cluster_id are rejected, so switching ids
        detaches us from the old cluster on both planes; old members
        are forgotten here, and the old cluster's view of us decays to
        down once our refutations stop (its probes are dropped).  The
        renewed announce lets same-id peers adopt us."""
        ClusterId(cluster_id)  # range-check (u16)
        old_members = self.members.all()
        self.config.cluster_id = int(cluster_id)
        announced = self.rejoin()
        for m in old_members:
            self.members.remove(m.actor_id)
        # fresh cluster, fresh SWIM bookkeeping (and the only unbounded
        # growth path for these per-identity dicts)
        self._swim_ts.clear()
        self._swim_update_tx.clear()
        return announced

    async def _gossip_loop(self) -> None:
        """Periodic membership gossip (foca periodic_gossip, enabled by
        the reference's WAN preset): a pure update-carrier round on a
        cadence faster than probing, skipped entirely once the backlog
        has decayed — the quiet-cluster cost is zero datagrams."""
        interval = self.config.gossip_interval
        if interval <= 0 or self.config.swim_wire != "foca":
            return
        from corrosion_tpu_torch.agent import swim_foca

        while True:
            await self._clock.sleep(interval)
            try:
                sent = swim_foca.gossip_round(
                    self, self.config.gossip_fanout
                )
                if sent:
                    self.metrics.counter(
                        "corro_gossip_rounds_total"
                    )
            except Exception:
                self.metrics.counter("corro_gossip_round_errors_total")

    async def _probe_loop(self) -> None:
        while True:
            await self._clock.sleep(self.config.probe_interval)
            alive = self.members.alive()
            if not alive:
                continue
            target = self._rng.choice(alive)
            ok = await self._probe(target)
            if not ok:
                ok = await self._indirect_probe(target)
            if not ok:
                self._mark_suspect(target)

    async def _probe(self, m: Member, timeout: Optional[float] = None) -> bool:
        nonce = self._next_probe_number()
        fut = self._loop.create_future()
        self._acks[nonce] = fut
        t0 = self._clock.monotonic()
        self._swim_probe(m, nonce)
        try:
            await self._clock.wait_for(
                fut, timeout or self.config.probe_timeout
            )
            self.members.record_rtt(
                m.actor_id, (self._clock.monotonic() - t0) * 1e3
            )
            self._suspects.pop(m.actor_id, None)
            self.members.revive(m.actor_id)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            self._acks.pop(nonce, None)

    async def _indirect_probe(self, target: Member) -> bool:
        helpers = [
            m for m in self.members.alive() if m.actor_id != target.actor_id
        ]
        if not helpers:
            return False
        helpers = self._rng.sample(
            helpers, min(self.config.num_indirect_probes, len(helpers))
        )
        nonce = self._next_probe_number()
        fut = self._loop.create_future()
        self._acks[nonce] = fut
        for h in helpers:
            self._swim_ping_req(h, target, nonce)
        try:
            await self._clock.wait_for(fut, self.config.probe_timeout * 2)
            self._suspects.pop(target.actor_id, None)
            self.members.revive(target.actor_id)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            self._acks.pop(nonce, None)

    def _mark_suspect(self, m: Member) -> None:
        if self.members.upsert(
            m.actor_id, m.addr, MemberState.SUSPECT, m.incarnation
        ):
            self._suspects[m.actor_id] = self._clock.monotonic()
            self._swim_update_tx[m.actor_id] = 0  # fresh news

    def _suspect_deadline(self) -> float:
        """Cluster-size-scaled suspicion timeout (make_foca_config →
        Config::new_wan, broadcast/mod.rs:937-946): configured value as
        the floor, growing log10 with membership so big clusters don't
        declare slow-but-alive members down."""
        from corrosion_tpu_torch.utils.swimscale import scaled_suspect_timeout

        return scaled_suspect_timeout(
            self.config.suspect_timeout,
            self.config.probe_interval,
            len(self.members.alive()) + 1,
            self.config.suspicion_mult,
        )

    def note_member_state(self, actor: bytes, state: MemberState) -> None:
        """Arm/clear the local suspicion timer for a member-record
        change (SWIM deadlines are PER NODE — foca starts one on every
        member that hears a suspicion).  Shared by both wire ingest
        paths so they cannot diverge."""
        if state is MemberState.SUSPECT:
            self._suspects.setdefault(actor, self._clock.monotonic())
        else:
            self._suspects.pop(actor, None)

    def _reap_suspects(self) -> None:
        """One suspicion-deadline pass (extracted so tests can drive
        it without the loop's cadence)."""
        now = self._clock.monotonic()
        deadline = self._suspect_deadline()
        for actor, since in list(self._suspects.items()):
            if now - since >= deadline:
                m = self.members.get(actor)
                if m and m.state is MemberState.SUSPECT:
                    self.members.upsert(
                        actor, m.addr, MemberState.DOWN, m.incarnation
                    )
                    self._swim_update_tx[actor] = 0  # fresh news
                self._suspects.pop(actor, None)

    async def _suspect_reaper(self) -> None:
        while True:
            await self._clock.sleep(self.config.probe_interval)
            self._reap_suspects()

    # ------------------------------------------------------------------
    # local writes + broadcast
    # ------------------------------------------------------------------

    def _register_backfills(self) -> None:
        """Record as_crr-backfill versions in bookkeeping so pre-existing
        rows replicate (sync serves them; see CrConn._backfill).

        Transactional: bookkeeping rows persist atomically with deleting
        the durable __corro_backfills records, all under the storage lock
        — a crash at any point either leaves the records for the next
        boot or has them fully registered.
        """
        with self.storage._lock:
            pending = self.storage.peek_backfills()
            if not pending:
                return
            booked = self.bookie.for_actor(self.actor_id)
            regs = []
            self.storage.conn.execute("BEGIN IMMEDIATE")
            try:
                last = booked.last()
                for dbv, last_seq in pending:
                    last += 1
                    ts = self.clock.new_timestamp()
                    self.bookie.persist_version(
                        self.actor_id, last, dbv, last_seq, int(ts)
                    )
                    regs.append((last, dbv, last_seq, ts))
                self.storage.clear_backfills()
            except BaseException:
                self.storage.conn.execute("ROLLBACK")
                raise
            self.storage.conn.execute("COMMIT")
            for version, dbv, last_seq, ts in regs:
                booked.apply_version(version, dbv, last_seq, ts)
                self._queue_or_defer_broadcast(version, dbv, last_seq, ts)

    def execute_transaction(self, statements: Sequence,
                            on_conn=None) -> dict:
        """Run write statements in one client transaction; version +
        bookkeeping + queue the broadcast (``make_broadcastable_changes``
        parity).

        With ``AgentConfig.write_group_commit`` (default on) the call
        routes through the write combiner (``agent/writes.py``,
        docs/writes.md): concurrent callers share one storage-lock hold
        and one outer commit, each batch isolated under its own
        SAVEPOINT — same results, versions, broadcasts, and subscription
        events as the per-transaction path, which stays below as the
        parity oracle.  Batches opening with transaction-control SQL
        (BEGIN/COMMIT/PRAGMA/…) always take the oracle path.

        ``on_conn`` (called with the RW connection once the storage lock
        is held, then with None before release) lets a caller interrupt
        the in-flight write — the PG front-end's CancelRequest path,
        mirroring ``CrConn.read_query``'s contract."""
        if self.config.write_group_commit:
            from corrosion_tpu_torch.agent.writes import has_tx_control

            if not has_tx_control(statements):
                return self._write_combiner.submit(statements, on_conn)
            self.metrics.counter(
                "corro_write_group_fallbacks_total", reason="stmt"
            )
            self._flight_event("write_group_fallback", reason="stmt")
        return self._execute_transaction_single(statements, on_conn)

    def _execute_transaction_single(self, statements: Sequence,
                                    on_conn=None) -> dict:
        """The per-transaction write path: one storage-lock hold, one
        BEGIN..COMMIT, one broadcast collection — the parity oracle the
        write combiner is pinned against (tests/test_write_combiner.py)."""
        results = []
        booked = self.bookie.for_actor(self.actor_id)
        # hold the storage lock across COMMIT *and* the in-memory bookie
        # update: the version counter (booked.last()+1) must not be read
        # by a second writer between our COMMIT and apply_version, and
        # apply_version must not race generate_sync's locked snapshot.
        # HIGH tier: client writes ride write_priority() in the
        # reference (api/public/mod.rs:59)
        with self.metrics.timed("corro_write_tx_seconds"), \
                self.storage._lock.prio(PRIO_HIGH, "write", kind="write"):
            # tracked only while the lock is held, so a cancel cannot
            # interrupt another session's statement on the shared conn
            if on_conn is not None:
                on_conn(self.storage.conn)
            try:
                committed = self._execute_transaction_locked(
                    statements, results, booked
                )
            finally:
                if on_conn is not None:
                    on_conn(None)
        if committed is not None:
            version, db_version, n_changes, ts = committed
            self._queue_or_defer_broadcast(
                version, db_version, n_changes - 1, ts
            )
            self._compact_best_effort()
            return {"results": results, "version": version}
        return {"results": results, "version": None}

    def _execute_statements(self, conn, statements, results) -> None:
        """Run one client batch's statements on ``conn``, appending a
        result dict per statement.  Shared verbatim by the per-
        transaction oracle and the group-commit combiner so the two can
        never diverge on result shapes."""
        for stmt in statements:
            sql, params = unpack_stmt(stmt)
            cur = conn.execute(sql, params)
            head = sql.lstrip().split(None, 1)
            is_dml = bool(head) and head[0].upper() in (
                "INSERT", "UPDATE", "DELETE", "REPLACE", "WITH",
            )
            if cur.rowcount < 0 and cur.description is None \
                    and is_dml:
                # sqlite3 reports -1 for INSERT..SELECT and
                # friends; changes() has the statement's true
                # direct count (triggers excluded).  DML-gated:
                # for DDL, changes() still holds the PREVIOUS
                # statement's count
                cur = conn.execute("SELECT changes()")
                n = cur.fetchone()[0]
                results.append({"rows_affected": n})
                continue
            if cur.description is not None:
                # RETURNING clause (ORM-style writes): surface
                # the produced rows alongside the write result,
                # JSON-safe (a BLOB column must not 500 the
                # HTTP response after the write committed).
                # fetchall() FIRST — sqlite3 only counts
                # affected rows as RETURNING rows are stepped,
                # so rowcount is 0 until the fetch completes
                from corrosion_tpu_torch.agent.pack import jsonable_row

                fetched = cur.fetchall()
                res = {
                    "rows_affected": cur.rowcount,
                    "columns": [d[0] for d in cur.description],
                    "rows": [jsonable_row(r) for r in fetched],
                }
            else:
                res = {"rows_affected": cur.rowcount}
            results.append(res)

    def _execute_transaction_locked(self, statements, results,
                                    booked) -> Optional[tuple]:
        """Body of :meth:`_execute_transaction_single` under the storage
        lock; returns ``(version, db_version, n_changes, ts)`` for a
        committed versioned write, None for a changeless one."""
        with self.storage.write_tx() as conn:
            self._execute_statements(conn, statements, results)
            n_changes = self.storage._state("seq")
            if n_changes > 0:
                version = booked.last() + 1
                db_version = self.storage._state("pending_db_version")
                ts = self.clock.new_timestamp()
                # persist inside the tx (atomic with the data); the
                # in-memory bookie commits only after COMMIT succeeds,
                # so a failed commit can't leave memory advertising a
                # version the DB never stored
                self.bookie.persist_version(
                    self.actor_id, version, db_version,
                    n_changes - 1, int(ts),
                )
            else:
                version = None
        if version is None:
            return None
        booked.apply_version(version, db_version, n_changes - 1, ts)
        return (version, db_version, n_changes, ts)

    # -- group-commit write combining (docs/writes.md) ------------------
    #
    # Concurrent execute_transaction callers coalesce (agent/writes.py):
    # one storage-lock hold + one outer BEGIN..COMMIT per group, each
    # client batch under its own SAVEPOINT, versions/db_versions/seq
    # spans assigned gaplessly in submission order, bookkeeping flushed
    # via Bookie.persist_versions, then ONE change collection for the
    # group's whole db_version span on a read-only pool connection off
    # the event loop — with on_change fired per changeset and one
    # compaction sweep per group.  The per-transaction path above is
    # the parity oracle (tests/test_write_combiner.py).

    def _execute_write_group(self, reqs) -> None:
        """Drain one combined group: resolve every request's result or
        error and set its ``done`` event.  Never raises — a dead leader
        would strand every parked caller."""
        from corrosion_tpu_torch.agent.writes import GroupAborted

        booked = self.bookie.for_actor(self.actor_id)
        self.metrics.counter("corro_write_groups_total")
        self.metrics.histogram("corro_write_group_size", len(reqs))
        aborted: Optional[GroupAborted] = None
        entries = None
        # the group span roots the broadcast trace: its context flows
        # through the collect worker onto the wire (traced uni
        # envelope) so every remote's first-arrival apply span shares
        # this trace id — one write, one cross-cluster trace
        with tracing.span("write.group", batches=len(reqs)) as wsp:
            self.metrics.counter("corro_trace_spans_total")
            group_tp = wsp.traceparent
            try:
                with self.metrics.timed("corro_write_group_seconds"), \
                        self.storage._lock.prio(PRIO_HIGH, "write-group",
                                                kind="write"):
                    entries = self._run_write_group_locked(reqs, booked)
            except GroupAborted as ga:
                aborted = ga
            except BaseException as e:  # lock/commit-level failure
                aborted = GroupAborted(None, e)
            wsp.set(
                committed=len(entries or ()),
                aborted=aborted is not None,
            )
        if aborted is not None:
            # replay every batch that didn't fail in its own savepoint
            # and didn't commit durably (a hostile mid-group COMMIT
            # finishes its prefix in _recover_committed_group — those
            # requests carry a result and must NOT be replayed, that
            # would double-apply) through the per-transaction oracle
            # (the mirror of _handle_change_group's merged-tx
            # fallback); the batch that surfaced the abort keeps its
            # original error
            self.metrics.counter(
                "corro_write_group_fallbacks_total", reason="abort"
            )
            self._flight_event(
                "write_group_fallback", reason="abort", batches=len(reqs)
            )
            if aborted.recovered:
                try:
                    self._dispatch_local_broadcast(
                        list(aborted.recovered), traceparent=group_tp
                    )
                except Exception:
                    self.metrics.counter(
                        "corro_local_broadcast_errors_total")
            for i, req in enumerate(reqs):
                if i == aborted.index:
                    req.error = aborted.error
                elif req.error is None and req.result is None:
                    try:
                        req.result = self._execute_transaction_single(
                            req.statements, req.on_conn
                        )
                    except BaseException as e:
                        req.error = e
                req.done.set()
            return
        # committed: ONE coalesced broadcast collection for the span
        # (off the event loop), then unblock the callers — their write
        # is durable — and sweep compaction once for the whole group
        if entries:
            try:
                self._dispatch_local_broadcast(
                    entries, traceparent=group_tp
                )
            except Exception:
                self.metrics.counter("corro_local_broadcast_errors_total")
        for req in reqs:
            req.done.set()
        if entries:
            self._compact_best_effort()

    def _run_write_group_locked(self, reqs, booked) -> List[tuple]:
        """Group body under the storage lock: one outer transaction,
        per-batch savepoints.  Returns the committed ``(version,
        db_version, last_seq, ts)`` entries in submission order; sets
        ``result``/``error`` on every request (without firing ``done``).

        Raises ``GroupAborted`` when the OUTER transaction is lost
        (interrupt, disk error, a statement that terminated it):
        usually a rollback — nothing committed, no request state
        trusted — but a statement that COMMITTED the outer transaction
        mid-group is detected via the committed db_version cursor and
        its durable prefix finished in place
        (:meth:`_recover_committed_group`)."""
        import sqlite3

        from corrosion_tpu_torch.agent.writes import GroupAborted

        conn = self.storage.conn
        conn.execute("BEGIN IMMEDIATE")
        # committed db_version cursor at group start: if the outer tx
        # terminates and this has ADVANCED durably, a statement
        # committed mid-group rather than rolling back
        dbv0 = self.storage._state("db_version")
        entries: List[tuple] = []  # (version, db_version, last_seq, ts)
        req_state: List[Optional[tuple]] = []  # (results, version|None)
        rows: List[tuple] = []  # bookkeeping executemany rows
        version = booked.last()
        try:
            for i, req in enumerate(reqs):
                # per-batch version state, exactly like write_tx: the
                # CRR triggers stamp this batch's rows with its OWN
                # (pending db_version, seq 0..n-1) span
                pending = self.storage.begin_write_batch()
                conn.execute("SAVEPOINT corro_wg")
                if req.on_conn is not None:
                    req.on_conn(conn)
                results: List[dict] = []
                try:
                    self._execute_statements(conn, req.statements, results)
                    if not conn.in_transaction:
                        # a statement ended the outer tx underneath us
                        # (screened tx-control should prevent this, but
                        # a hostile/odd statement must fail loud, not
                        # half-commit a group)
                        raise sqlite3.OperationalError(
                            "statement terminated the group transaction"
                        )
                except BaseException as e:
                    if not conn.in_transaction:
                        raise GroupAborted(i, e)
                    # savepoint-scoped failure: only this caller fails
                    conn.execute("ROLLBACK TO corro_wg")
                    conn.execute("RELEASE corro_wg")
                    req.error = e
                    req_state.append(None)
                    continue
                finally:
                    if req.on_conn is not None:
                        req.on_conn(None)
                conn.execute("RELEASE corro_wg")
                n_changes = self.storage._state("seq")
                if n_changes > 0:
                    self.storage._set_state("db_version", pending)
                    version += 1
                    ts = self.clock.new_timestamp()
                    rows.append((version, pending, n_changes - 1, int(ts)))
                    entries.append((version, pending, n_changes - 1, ts))
                    req_state.append((results, version))
                else:
                    # changeless batch: no version/db_version consumed
                    req_state.append((results, None))
            if rows:
                # one executemany write-through for the whole group
                # (persist INSIDE the tx, atomic with the data —
                # persist_version contract)
                self.bookie.persist_versions(self.actor_id, rows)
            conn.execute("COMMIT")
        except GroupAborted as ga:
            if conn.in_transaction:
                conn.execute("ROLLBACK")
            else:
                self._recover_committed_group(
                    ga, dbv0, entries, rows, reqs, req_state, booked
                )
            raise
        except BaseException as e:
            ga = GroupAborted(None, e)
            if conn.in_transaction:
                conn.execute("ROLLBACK")
            else:
                self._recover_committed_group(
                    ga, dbv0, entries, rows, reqs, req_state, booked
                )
            raise ga
        # in-memory bookie only AFTER the commit succeeded (the oracle's
        # ordering): a failed commit must never leave memory advertising
        # versions the DB never stored.  Still under the storage lock,
        # so generate_sync's locked snapshot can't see a half-applied
        # group
        for v, dbv, last_seq, ts in entries:
            booked.apply_version(v, dbv, last_seq, ts)
        for req, st in zip(reqs, req_state):
            if st is None:
                continue
            results, v = st
            req.result = {"results": results, "version": v}
        return entries

    def _recover_committed_group(self, ga, dbv0, entries, rows, reqs,
                                 req_state, booked) -> None:
        """The group's outer transaction is GONE (still under the
        storage lock).  Usually that is a rollback and nothing
        committed — detected here by the committed db_version cursor
        still reading ``dbv0`` — and the abort fallback may safely
        replay every batch.  But a statement that slipped past
        tx-control screening and COMMITTED mid-group leaves every batch
        processed so far durable WITHOUT bookkeeping; replaying those
        would double-apply.  Finish the committed prefix in place
        instead: persist its bookkeeping rows in a recovery
        transaction, apply the in-memory versions, attach the callers'
        results (so the fallback skips them), and hand the entries to
        the abort path via ``ga.recovered`` for broadcast.  Best
        effort by design — the one invariant that must hold even when
        recovery itself fails is that durable batches are never
        replayed, so results attach regardless."""
        try:
            committed = self.storage._state("db_version")
        except Exception:
            return  # storage unreadable: nothing more we can do
        if committed == dbv0:
            return  # clean rollback: replay is safe
        self.metrics.counter("corro_write_group_hostile_commits_total")
        logger.warning(
            "a group write statement committed mid-group "
            "(db_version %d -> %d); recovering %d durable batches",
            dbv0, committed, len(req_state),
        )
        conn = self.storage.conn
        persisted = True
        if rows:
            try:
                conn.execute("BEGIN IMMEDIATE")
                self.bookie.persist_versions(self.actor_id, rows)
                conn.execute("COMMIT")
            except BaseException:
                persisted = False
                try:
                    if conn.in_transaction:
                        conn.execute("ROLLBACK")
                except Exception:
                    pass
        if persisted:
            for v, dbv, last_seq, ts in entries:
                booked.apply_version(v, dbv, last_seq, ts)
            ga.recovered = list(entries)
        for req, st in zip(reqs, req_state):
            if st is None:
                continue  # savepoint-failed batch keeps its error
            results, v = st
            req.result = {"results": results, "version": v}

    def _find_and_clear_overwritten(self) -> List[Tuple[int, int]]:
        """Local compaction: versions whose change rows were all
        overwritten become cleared ranges and gossip as empty changesets.

        Parity: ``find_overwritten_versions`` + ``store_empty_changeset``
        (agent.rs:1753-1812, change.rs:314-436) — runs after every local
        write and remote apply; only the originating node clears its own
        versions (impact triggers watch site_ordinal=1 rows only).
        Returns the cleared (start, end) ranges.
        """
        cleared: List[Tuple[int, int]] = []
        # LOW tier: compaction is maintenance — the reference clears
        # overwritten/empty ranges on write_low (handlers.rs:635-691)
        with self.storage._lock.prio(PRIO_LOW, "compaction"):
            any_impacted, gone = self.storage.overwritten_local_db_versions()
            if not any_impacted:
                return []
            booked = self.bookie.for_actor(self.actor_id)
            gone_set = set(gone)
            rs = RangeSet()
            for v, (dbv, _seq) in booked.versions.items():
                if dbv in gone_set:
                    rs.insert(v, v)
            ranges = rs.spans()
            ts = self.clock.new_timestamp()
            self.storage.conn.execute("BEGIN IMMEDIATE")
            try:
                self.storage.conn.execute(
                    "DELETE FROM __corro_versions_impacted"
                )
                for s, e in ranges:
                    self.bookie.persist_cleared(self.actor_id, s, e, int(ts))
                if ranges:
                    # our own compaction is complete information: advance
                    # our advertised cleared watermark
                    self.bookie.persist_sync_state(self.actor_id, int(ts))
            except BaseException:
                self.storage.conn.execute("ROLLBACK")
                raise
            self.storage.conn.execute("COMMIT")
            for s, e in ranges:
                booked.mark_cleared(s, e)
                cleared.append((s, e))
            if ranges:
                booked.update_cleared_ts(ts)
        for s, e in cleared:
            cv = ChangeV1(
                actor_id=ActorId(self.actor_id),
                changeset=Changeset.empty((Version(s), Version(e)), ts),
            )
            self._queue_or_defer_cv(cv)
        if cleared:
            self.metrics.counter(
                "corro_compaction_cleared_versions_total",
                sum(e - s + 1 for s, e in cleared),
            )
        return cleared

    def _compact_best_effort(self) -> None:
        """Post-commit compaction sweep on hot paths: the user's write is
        already durable, so a sweep failure (e.g. busy DB) must not turn
        a successful write into an error — maintenance retries it."""
        try:
            self._find_and_clear_overwritten()
        except Exception:
            self.metrics.counter("corro_compaction_sweep_errors_total")

    async def _compaction_loop(self) -> None:
        """Maintenance-driven compaction on its own cadence
        (``AgentConfig.compaction_interval``): an idle-but-serving node
        has no post-commit sweep to piggyback on, so without this loop
        its cleared spans and snapshot floor would only move on the
        (much slower) maintenance tick.  The SQL body runs on the apply
        pool like the maintenance pass."""
        while True:
            await self._clock.sleep(self.config.compaction_interval)
            try:
                await self._loop.run_in_executor(
                    self._apply_pool, self._compaction_pass
                )
            except Exception:
                pass

    def _compaction_pass(self) -> int:
        """One maintenance-driven compaction sweep (worker thread):
        clear overwritten versions, then advance snapshot floors over
        the freshly-extended contained prefixes.  Returns the versions
        cleared + ledger rows compacted, counted under
        ``corro_compaction_maintenance_clears_total``."""
        work = 0
        # device-resident apply: compaction reads + rewrites clock
        # bookkeeping, so unflushed winners must land first, and the
        # cache view is invalid once floors advance
        self.storage.flush_pending()
        try:
            cleared = self._find_and_clear_overwritten()
            work += sum(e - s + 1 for s, e in cleared)
        except Exception:
            self.metrics.counter("corro_compaction_sweep_errors_total")
        try:
            work += self._advance_snapshot_floors()
        except Exception:
            self.metrics.counter("corro_compaction_sweep_errors_total")
        if work:
            self.storage.device_cache_invalidate("compaction")
        if work:
            self.metrics.counter(
                "corro_compaction_maintenance_clears_total", work
            )
        return work

    def _advance_snapshot_floors(self) -> int:
        """Background history compaction (docs/sync.md): per actor,
        advance the snapshot floor to the contained prefix minus the
        retain window, deleting the per-version bookkeeping it subsumes
        — after which those versions are only obtainable from this
        node via snapshot install (the serve path's plan walk simply
        no longer resolves them, and the advertised floor tells
        clients why).  Returns ledger rows compacted."""
        if not self.config.snapshot_serve:
            return 0
        retain = self.config.snapshot_retain_versions
        if retain < 0:
            return 0
        compacted = 0
        advanced = False
        with self.storage._lock.prio(PRIO_LOW, "snap-floor"):
            for actor, bv in list(self.bookie.actors().items()):
                target = bv.contained_prefix() - retain
                if target <= bv.snap_floor or target <= 0:
                    continue
                ts = int(self.clock.new_timestamp())
                self.storage.conn.execute("BEGIN IMMEDIATE")
                try:
                    compacted += self.bookie.compact_below_floor(
                        actor, target
                    )
                    self.bookie.persist_floor(actor, target, ts)
                except BaseException:
                    self.storage.conn.execute("ROLLBACK")
                    raise
                self.storage.conn.execute("COMMIT")
                bv.set_snap_floor(target)
                advanced = True
        if advanced:
            self.metrics.counter("corro_snapshot_floor_advances_total")
            self.metrics.gauge(
                "corro_snapshot_floor",
                self.bookie.for_actor(self.actor_id).snap_floor,
            )
        return compacted

    def _queue_or_defer_cv(self, cv: ChangeV1,
                           traceparent: Optional[str] = None) -> None:
        with self._bcast_gate:
            if self._loop is None:
                self._pre_start_cvs.append((cv, traceparent))
                return
            loop = self._loop
        self.metrics.counter("corro_channel_sends_total", channel="bcast")
        loop.call_soon_threadsafe(
            self._bcast_queue.put_nowait,
            (cv, self.config.max_transmissions, 0, traceparent, None),
        )

    def _queue_or_defer_broadcast(
        self, version: int, db_version: int, last_seq: int, ts: Timestamp
    ) -> None:
        """Queue one committed local version's broadcast, or buffer it
        until start() when the event loop isn't up yet (writes before
        start() must still gossip)."""
        self._dispatch_local_broadcast(
            [(version, db_version, last_seq, ts)],
            traceparent=tracing.current_traceparent(),
        )

    def _wbcast_executor(self):
        """The single-thread local-broadcast collection worker (lazy),
        or None once stop() closed it (no pool rebirth after teardown).
        ONE thread on purpose: collection + on_change + enqueue stay in
        version order, exactly like the old loop-serialized path."""
        with self._wbcast_lock:
            if self._wbcast_closed:
                return None
            pool = self._wbcast_pool
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                pool = self._wbcast_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="corro-wbcast",
                )
            return pool

    def _dispatch_local_broadcast(self, entries: List[tuple],
                                  traceparent: Optional[str] = None) -> None:
        """Route committed-version entries ``(version, db_version,
        last_seq, ts)`` to collection + broadcast enqueue.
        ``traceparent`` carries the committing write's span context onto
        the collection worker (contextvars don't cross threads), so the
        collect span and the remote apply spans share its trace id.

        Collection (SQL) and chunk encoding NEVER run on the event loop
        (an earlier path scheduled them there with
        ``call_soon_threadsafe``, stalling SWIM acks under write
        bursts): on a live agent they run on the ordered write-bcast
        worker; the deterministic scheduler (``_SyncLoop`` stand-in
        loop) runs them inline so its synchronous queue contract holds;
        with no loop at all they defer to start()."""
        with self._bcast_gate:
            if self._loop is None:
                self._pre_start_broadcasts.extend(entries)
                return
            live_loop = isinstance(self._loop, asyncio.AbstractEventLoop)
        if live_loop:
            pool = self._wbcast_executor()
            if pool is not None:  # None: stop() already tore it down
                pool.submit(
                    self._broadcast_local_commits, entries, traceparent
                )
        else:
            self._broadcast_local_commits(entries, traceparent)

    def _broadcast_local_commits(self, entries: List[tuple],
                                 traceparent: Optional[str] = None) -> None:
        """Worker body: one coalesced collection for the entries' whole
        db_version span, then per-changeset on_change + broadcast
        enqueue in version order.  A failure here must not surface as an
        unretrieved executor exception — the versions are already
        durable and anti-entropy serves them regardless."""
        try:
            # the collect span re-parents on the committing write's
            # trace; its own context rides the queued broadcasts so a
            # remote's first-arrival apply span completes the chain
            with tracing.span(
                "bcast.collect", remote=traceparent, entries=len(entries)
            ) as sp:
                self.metrics.counter("corro_trace_spans_total")
                cvs = self._local_commit_changesets(entries)
                sp.set(changesets=len(cvs))
            tp_out = (
                sp.traceparent
                if self.config.bcast_trace_propagation else None
            )
        except Exception:
            self.metrics.counter("corro_local_broadcast_errors_total")
            logger.debug("local broadcast collection failed", exc_info=True)
            return
        for cv in cvs:
            # per-changeset isolation, like the old per-version
            # dispatch: a raising on_change subscriber drops THAT
            # version's broadcast, not the rest of the group's
            try:
                if self.on_change is not None:
                    self.on_change(cv)
                self._queue_or_defer_cv(cv, tp_out)
            except Exception:
                self.metrics.counter("corro_local_broadcast_errors_total")
                logger.debug(
                    "local broadcast dispatch failed", exc_info=True
                )

    def _local_commit_changesets(
        self, entries: List[tuple]
    ) -> List[ChangeV1]:
        """Committed local versions -> their broadcast changesets, via
        ONE range collection on a read-only pool connection (no storage
        lock — the rows are committed data) split by db_version in
        memory.  A combined group's db_versions are consecutive (the
        group held the storage lock across all its batches), so the
        span contains exactly the entries' changes; chunking per
        version is identical to the per-commit path."""
        if not entries:
            return []
        dbvs = [e[1] for e in entries]
        with self.storage.reader() as conn:
            changes = self.storage.collect_changes_ro(
                conn, (min(dbvs), max(dbvs))
            )
        by_dbv: Dict[int, List] = {}
        for ch in changes:
            by_dbv.setdefault(int(ch.db_version), []).append(ch)
        cvs: List[ChangeV1] = []
        for version, db_version, last_seq, ts in entries:
            for chunk, seqs in ChunkedChanges(
                by_dbv.get(db_version, []), 0, last_seq
            ):
                cs = Changeset.full(
                    Version(version), chunk, seqs, last_seq=last_seq, ts=ts
                )
                cvs.append(
                    ChangeV1(actor_id=ActorId(self.actor_id), changeset=cs)
                )
        return cvs

    def _record_rtt(self, addr, rtt_s: float) -> None:
        for m in self.members.alive():
            if tuple(m.addr) == tuple(addr):
                self.members.record_rtt(m.actor_id, rtt_s * 1000.0)
                break

    def _on_breaker(self, addr, opened: bool) -> None:
        """Transport circuit-breaker transition → member quarantine:
        an opened breaker deprioritizes the peer in fanout sampling
        (like a high-RTT peer); a half-open success restores it."""
        self.members.quarantine_by_addr(addr, opened)
        self.metrics.counter(
            "corro_members_quarantine_transitions_total",
            state="open" if opened else "restored",
        )
        addr_s = f"{addr[0]}:{addr[1]}"
        self._flight_event(
            "breaker_open" if opened else "breaker_close", addr=addr_s
        )
        self._flight_event(
            "quarantine", addr=addr_s, on=opened, reason="breaker"
        )

    async def _broadcast_loop(self) -> None:
        """Buffered, rate-limited dissemination over uni-streams.

        Parity (broadcast/mod.rs:399-801): payloads accumulate until the
        64 KiB cutoff or the flush tick; sends ride cached TCP
        uni-streams under the 10 MiB/s governor; retransmissions requeue
        with a send-count-scaled backoff; when the pending set overflows
        the most-transmitted payloads are dropped first.
        """
        from corrosion_tpu_torch.agent.transport import TokenBucket

        cfg = self.config
        bucket = TokenBucket(cfg.bcast_rate_limit, clock=self._clock)
        # (due_time, frame, cv, remaining, sent_to) — sent_to mirrors the
        # reference's per-payload sent_to set (broadcast/mod.rs:683-690):
        # a payload is never retransmitted to a peer that already got it
        pending: List[tuple] = []
        buffer: List[tuple] = []  # (frame, cv, remaining, sent_to)
        buf_bytes = 0
        last_flush = self._clock.monotonic()

        async def flush():
            nonlocal buffer, buf_bytes, last_flush
            batch, buffer, buf_bytes = buffer, [], 0
            last_flush = self._clock.monotonic()
            if not batch:
                return
            # per-destination frame groups: each payload picks its own
            # fanout targets (all-ring0 + global sample for our own
            # changes' first transmission; random sample after)
            by_dest: Dict[Tuple[str, int], List[tuple]] = {}
            for frame, cv, remaining, sent_to in batch:
                local = cv.actor_id.bytes == self.actor_id
                targets = self.members.sample(
                    cfg.fanout, self._rng,
                    ring0_first=cfg.ring0_enabled and local and not sent_to,
                    exclude=sent_to,
                )
                for m in targets:
                    by_dest.setdefault(tuple(m.addr), []).append(
                        (frame, sent_to, m.actor_id)
                    )
                # requeue while transmissions remain and coverage is not
                # exhausted; sent_to only records SUCCESSFUL deliveries,
                # so a peer that missed a transient send stays eligible
                # and keeps the entry alive (empty targets = every alive
                # member already got it)
                if remaining > 1 and targets:
                    due = self._clock.monotonic() + cfg.rebroadcast_delay * (
                        cfg.max_transmissions - remaining + 1
                    )
                    pending.append((due, frame, cv, remaining - 1, sent_to))
            self.metrics.counter("corro_broadcast_flushes_total")
            self.metrics.gauge(
                "corro_broadcast_pending_depth", float(len(pending)))
            # destinations flush CONCURRENTLY: under the shared mux
            # connection one peer's backpressured drain must not stall
            # gossip to every other peer (and even on dedicated
            # connections this overlaps the network round-trips)
            async def send_one(dest, entries):
                blob = b"".join(frame for frame, _, _ in entries)
                await bucket.consume(len(blob))
                ok = await self.transport.send_uni(
                    dest, blob, header=STREAM_UNI
                )
                if ok:
                    # mark delivered only on success so a failed send's
                    # peers stay eligible for retransmission
                    for _, sent_to, actor_id in entries:
                        sent_to.add(actor_id)
                    return len(entries)
                self.metrics.counter("corro_broadcast_send_failures_total")
                return 0

            results = await asyncio.gather(
                *(send_one(d, e) for d, e in by_dest.items()),
                return_exceptions=True,
            )
            sends = 0
            for r in results:
                if isinstance(r, int):
                    sends += r
                elif isinstance(r, BaseException):
                    # an unexpected send-path error must be VISIBLE,
                    # not filtered out by the gather
                    self.metrics.counter(
                        "corro_broadcast_send_failures_total")
                    logger.warning("broadcast send failed: %r", r)
            if sends:
                self.metrics.counter("corro_broadcast_sent_total", sends)
            dropped = _drop_most_transmitted(pending, cfg.bcast_max_pending)
            if dropped:
                self.metrics.counter(
                    "corro_broadcast_pending_dropped_total", dropped
                )

        while True:
            self._bcast_wakeups += 1
            now = self._clock.monotonic()
            # requeued retransmissions that are due
            due_now = [p for p in pending if p[0] <= now]
            if due_now:
                pending[:] = [p for p in pending if p[0] > now]
                for _, frame, cv, remaining, sent_to in due_now:
                    buffer.append((frame, cv, remaining, sent_to))
                    buf_bytes += len(frame)
            # idle agents block on the queue (or the next retransmission
            # due time) instead of polling — zero wakeups when nothing is
            # in flight
            if buffer:
                timeout = max(
                    0.001, cfg.bcast_flush_interval - (now - last_flush)
                )
            elif pending:
                timeout = max(0.001, min(p[0] for p in pending) - now)
            else:
                timeout = None
            try:
                cv, remaining, hop, tp, sig = await self._clock.wait_for(
                    self._bcast_queue.get(), timeout=timeout
                )
                frame = self.encode_broadcast_frame(cv, hop, tp, sig)
                buffer.append((frame, cv, remaining, set()))
                buf_bytes += len(frame)
            except asyncio.TimeoutError:
                pass
            if buf_bytes >= cfg.bcast_buffer_cutoff or (
                buffer
                and self._clock.monotonic() - last_flush
                >= cfg.bcast_flush_interval
            ):
                await flush()

    def encode_broadcast_frame(self, cv: ChangeV1, hop: int = 0,
                               traceparent: Optional[str] = None,
                               sig: Optional[bytes] = None) -> bytes:
        """One queued broadcast → the exact on-wire frame bytes
        (speedy UniPayload + u32-BE framing; optional debug-hop prefix).
        With ``bcast_trace_propagation`` the payload rides the versioned
        traced envelope (hop + traceparent ahead of the classic bytes —
        receivers accept both formats).  When signing is configured
        (``sig_secret``/``sig_key_file``) this node's OWN full
        changesets are signed here and ride the v2 SIGNED envelope;
        a relayed payload's origin signature (``sig``) passes through
        unchanged — a relay cannot re-sign what it did not author.
        Unsigned and trace-off configurations emit the pre-signing
        bytes exactly.  Shared by the live broadcast loop and the
        deterministic scheduler (``agent/det.py``) so both emit
        identical bytes."""
        payload = speedy.encode_uni_payload(
            UniPayload(
                broadcast=BroadcastV1(change=cv),
                cluster_id=ClusterId(self.config.cluster_id),
            )
        )
        if (sig is None and self._sig_secret is not None
                and cv.actor_id.bytes == self.actor_id):
            sig = self._sign_changeset(cv.changeset)
        if sig is not None:
            # the v2 envelope carries the trace slot structurally, but
            # the CONTENT still honors bcast_trace_propagation — signing
            # must not become a side channel that re-enables wire trace
            # context the operator turned off
            payload = speedy.encode_signed_uni(
                payload,
                traceparent if self.config.bcast_trace_propagation
                else None,
                hop, sig,
            )
        elif self.config.bcast_trace_propagation:
            payload = speedy.encode_traced_uni(payload, traceparent, hop)
        if self.config.debug_hops:
            payload = bytes([min(hop, 255)]) + payload
        return speedy.frame(payload)

    def decode_uni_frame_meta(
        self, payload: bytes
    ) -> Optional[Tuple[ChangeV1, Optional[str], int, Optional[bytes]]]:
        """One deframed uni-stream payload → ``(ChangeV1, traceparent,
        hop, sig)``, or None on a decode error / foreign cluster.
        Classic (untraced) payloads yield ``(cv, None, 0, None)``."""
        dbg_hop = 0
        if self.config.debug_hops and payload:
            dbg_hop, payload = payload[0], payload[1:]
        try:
            payload, tp, hop, sig = speedy.decode_uni_envelope(payload)
            up = speedy.decode_uni_payload(payload)
        except speedy.SpeedyError:
            self.metrics.counter("corro_wire_decode_errors_total")
            return None
        if int(up.cluster_id) != self.config.cluster_id:
            return None
        cv = up.broadcast.change
        if self.config.debug_hops:
            key = self._seen_key(cv)
            with self._seen_lock:
                self._recv_hops.setdefault(key, dbg_hop)
        return cv, tp, hop, sig

    def decode_uni_frame(self, payload: bytes) -> Optional[ChangeV1]:
        """One deframed uni-stream payload → its ChangeV1 (or None on a
        decode error / foreign cluster).  Shared by the live uni-stream
        server and the deterministic scheduler."""
        decoded = self.decode_uni_frame_meta(payload)
        return decoded[0] if decoded is not None else None

    # ------------------------------------------------------------------
    # ingest pipeline (handle_changes parity: bounded queue, batching,
    # apply workers off the event loop)
    # ------------------------------------------------------------------

    def _enqueue_ingest(self, item, source) -> None:
        """Shared bounded enqueue: drop-oldest on overflow
        (handlers.rs:904-923 policy) + channel accounting + wakeup."""
        if len(self._ingest) >= self.config.processing_queue_len:
            self._ingest.popleft()
            self.metrics.counter("corro_changes_dropped_total")
            self.metrics.counter(
                "corro_channel_drops_total", channel="changes")
        self.metrics.counter(
            "corro_channel_sends_total", channel="changes")
        self._ingest.append((item, source))
        if self._ingest_event is not None:
            self._ingest_event.set()

    def enqueue_change(self, cv: ChangeV1, source: ChangeSource) -> None:
        """Queue an incoming changeset; oldest entries drop on overflow."""
        self._enqueue_ingest(cv, source)
        if source is ChangeSource.SYNC:
            n = len(cv.changeset.changes) if cv.changeset.is_full else 0
            self.metrics.counter("corro_sync_changes_received_total", n)

    async def _change_loop(self) -> None:
        """Batch + dispatch loop: up to ``max_concurrent_applies`` batches
        in flight on the worker pool at once (handlers.rs:742-956 runs ≤5
        concurrent ``process_multiple_changes``).  Out-of-order completion
        is safe: version/seq bookkeeping is idempotent and every apply
        transaction serializes on the storage lock."""
        cfg = self.config
        inflight = self._apply_inflight
        while True:
            if not self._ingest:
                self._ingest_event.clear()
                if inflight:
                    # wake on new work OR a completed apply
                    ev = asyncio.ensure_future(self._ingest_event.wait())
                    try:
                        done, _ = await asyncio.wait(
                            inflight | {ev},
                            return_when=asyncio.FIRST_COMPLETED,
                        )
                    finally:
                        if not ev.done():
                            ev.cancel()
                    for fut in done - {ev}:
                        inflight.discard(fut)
                        self._finish_apply(fut)
                    if not self._ingest:
                        continue
                else:
                    await self._ingest_event.wait()
            # cost-based batch: drain until the summed change count hits
            # apply_queue_len or a short tick passes (handlers.rs:755)
            batch: List[tuple] = []
            cost = 0
            deadline = self._clock.monotonic() + cfg.apply_queue_timeout
            while cost < cfg.apply_queue_len:
                if not self._ingest:
                    remaining = deadline - self._clock.monotonic()
                    if remaining <= 0 or batch:
                        break
                    try:
                        await asyncio.wait_for(
                            self._ingest_event.wait(), timeout=remaining
                        )
                    except asyncio.TimeoutError:
                        break
                    continue
                item, source = self._ingest.popleft()
                batch.append((item, source))
                if source is None:
                    # raw uni payload, decoded in the worker: true change
                    # count is unknown pre-decode, so estimate from the
                    # payload size (speedy changes run ~100+ bytes) so
                    # apply_queue_len keeps bounding real batch work
                    cost += max(1, len(item[0]) >> 7)
                else:
                    cost += max(
                        1,
                        len(item.changeset.changes)
                        if item.changeset.is_full else 1,
                    )
            if not batch:
                continue
            while len(inflight) >= cfg.max_concurrent_applies:
                done, rest = await asyncio.wait(
                    inflight, return_when=asyncio.FIRST_COMPLETED
                )
                inflight.clear()
                inflight.update(rest)
                for fut in done:
                    self._finish_apply(fut)
            fut = asyncio.ensure_future(
                self._loop.run_in_executor(
                    self._apply_pool, self._apply_batch, batch
                )
            )
            inflight.add(fut)

    def _finish_apply(self, fut) -> None:
        try:
            results = fut.result()
        except asyncio.CancelledError:
            # shutdown-time cancellation is not an apply failure: let it
            # propagate instead of polluting the error metric
            raise
        except Exception:
            self.metrics.counter("corro_changes_apply_errors_total")
            return
        for cv, source, news, meta in results:
            if news and source is ChangeSource.BROADCAST:
                self.metrics.counter("corro_broadcast_rebroadcast_total")
                self.metrics.counter(
                    "corro_channel_sends_total", channel="bcast")
                self._bcast_queue.put_nowait(
                    (cv, self.config.max_transmissions,
                     self._rebroadcast_hop(cv, meta),
                     meta[0] if meta is not None else None,
                     self._meta_sig(meta))
                )

    def _apply_batch(self, batch: List[tuple]) -> List[tuple]:
        """Apply a batch on a worker thread; returns (cv, source, news).

        Raw uni-stream payloads (enqueued undecoded so the event loop
        never blocks on deserialization) are speedy-decoded here, and
        consecutive complete changesets from the same actor are merged
        into ONE apply transaction (one fsync instead of N)."""
        with self._apply_gauge_lock:
            self._apply_active += 1
            self._apply_max_overlap = max(
                self._apply_max_overlap, self._apply_active
            )
            self.metrics.gauge("corro_apply_in_flight", self._apply_active)
        self.metrics.histogram("corro_apply_batch_size", len(batch))
        out = []
        try:
            with self.metrics.timed("corro_apply_seconds"):
                items: List[tuple] = []
                for item, source in batch:
                    if source is None:
                        # raw uni payload, decode off-loop; the item
                        # carries (payload, delivering_peer) so a
                        # failed signature can blame the transport
                        payload, peer = item
                        try:
                            decoded = self.decode_uni_frame_meta(payload)
                        except Exception:
                            # decode catches SpeedyError, but a hostile
                            # frame can raise others (e.g. invalid
                            # UTF-8): one bad payload must not abort
                            # the whole batch's valid changesets
                            self.metrics.counter(
                                "corro_wire_decode_errors_total")
                            decoded = None
                        if decoded is not None:
                            cv, tp, hop, sig = decoded
                            items.append((
                                cv, ChangeSource.BROADCAST,
                                (tp, hop, sig, peer),
                            ))
                    else:
                        items.append((item, source, None))
                i, n = 0, len(items)
                while i < n:
                    cv, source, _meta = items[i]
                    j = i + 1
                    cs = cv.changeset
                    if cs.is_full and cs.is_complete():
                        actor = cv.actor_id.bytes
                        while j < n:
                            cv2, _s2, _m2 = items[j]
                            cs2 = cv2.changeset
                            if (cv2.actor_id.bytes != actor
                                    or not cs2.is_full
                                    or not cs2.is_complete()):
                                break
                            j += 1
                    if j - i > 1:
                        out.extend(self._handle_change_group(items[i:j]))
                    else:
                        t0 = time.perf_counter()
                        try:
                            news = self.handle_change(
                                cv, source, rebroadcast=False, meta=_meta,
                                record_prov=False,
                            )
                        except Exception:
                            self.metrics.counter(
                                "corro_changes_apply_errors_total")
                            news = False
                        self._record_apply_span(
                            cv, _meta, news,
                            (time.perf_counter() - t0) * 1e3,
                        )
                        out.append((cv, source, news, _meta))
                    i = j
                # one provenance flush for the whole batch (the
                # per-item calls above defer with record_prov=False)
                self._record_provenance_many(out)
                # device-resident apply: drain the write-behind queue
                # on this worker (the "ordered executemany on the apply
                # pool") once enough batches have accumulated; the
                # maintenance tick sweeps stragglers
                if self.storage.flush_should_drain():
                    self.storage.flush_pending()
        finally:
            with self._apply_gauge_lock:
                self._apply_active -= 1
                self.metrics.gauge(
                    "corro_apply_in_flight", self._apply_active
                )
        return out

    def _handle_change_group(self, group: List[tuple]) -> List[tuple]:
        """Process consecutive complete changesets from one actor in one
        merged apply transaction.  Dedup/clock/metrics/rebroadcast stay
        per changeset; if the merged transaction fails, each changeset is
        retried in its own transaction so one poisoned changeset only
        kills itself."""
        flags: List[Optional[bool]] = [None] * len(group)
        live_idx: List[int] = []
        dropped = [False] * len(group)
        for k, (cv, source, _meta) in enumerate(group):
            if self._pre_change(cv, source, _meta):
                live_idx.append(k)
            else:
                # dedup/self-origin drop: handle_change returns without
                # any accounting here, so the group path must too
                flags[k] = False
                dropped[k] = True
        t0 = time.perf_counter()
        if live_idx:
            live = [group[k][0] for k in live_idx]
            live_sources = [group[k][1] for k in live_idx]
            live_metas = [group[k][2] for k in live_idx]
            try:
                news_flags = self._apply_complete_group(
                    live[0].actor_id.bytes, live, live_sources,
                    live_metas,
                )
            except Exception:
                # not an apply error yet: the per-changeset retry below
                # may fully recover — only ITS failures count, the merge
                # abort itself gets its own series
                self.metrics.counter("corro_apply_group_fallbacks_total")
                self._flight_event(
                    "apply_group_fallback",
                    actor=live[0].actor_id.bytes.hex(), size=len(live),
                )
                news_flags = []
                for cv, src, mta in zip(live, live_sources, live_metas):
                    try:
                        news_flags.append(
                            self._process_changeset(cv, src, mta)
                        )
                    except Exception:
                        self.metrics.counter(
                            "corro_changes_apply_errors_total")
                        news_flags.append(False)
            for k, news in zip(live_idx, news_flags):
                flags[k] = news
        if any(flags):
            # one post-group sweep: compaction is idempotent maintenance,
            # so per-changeset sweeps inside one merged tx are redundant
            self._compact_best_effort()
        group_ms = (time.perf_counter() - t0) * 1e3
        out = []
        for k, (cv, source, meta) in enumerate(group):
            news = bool(flags[k])
            if not dropped[k]:
                try:
                    # per-item guard: a raising on_change subscriber
                    # must not abort accounting for the rest of a group
                    # whose transaction already committed
                    self._post_change(cv, source, news, rebroadcast=False,
                                      compact=False, meta=meta,
                                      record_prov=False)
                except Exception:
                    self.metrics.counter("corro_changes_apply_errors_total")
                self._record_apply_span(cv, meta, news, group_ms,
                                        group=len(group))
            out.append((cv, source, news, meta))
        return out

    def _apply_complete_group(
        self, actor: bytes, cvs: List[ChangeV1],
        sources: Optional[List[ChangeSource]] = None,
        metas: Optional[List] = None,
    ) -> List[bool]:
        """Merge several COMPLETE changesets from ``actor`` under one
        storage lock + one apply transaction.  The already-have gate is
        evaluated up front (before any mutation), and the in-memory
        bookie state is snapshotted and RESTORED if the transaction
        fails — otherwise the rolled-back versions would read as
        'contained' and the per-changeset retry in
        ``_handle_change_group`` would silently skip them.  Bookkeeping
        rows flush via the bookie's executemany batch variants.

        ``sources`` gates the equivocation bookkeeping per changeset
        (digests remembered / compared for BROADCAST only); omitted =
        sync-like, no digest bookkeeping (harness seeding paths)."""
        if sources is None:
            sources = [ChangeSource.SYNC] * len(cvs)
        if metas is None:
            metas = [None] * len(cvs)
        with self.storage._lock:
            booked = self.bookie.for_actor(actor)
            flags: List[bool] = []
            to_apply: List[ChangeV1] = []
            # version -> (cs, source, meta) accepted within THIS
            # batch: a back-to-back conflicting pair lands here before
            # any digest is remembered, so the in-batch dup must
            # compare against the batch member directly
            batch_cs: Dict[int, tuple] = {}
            for cv, src, mta in zip(cvs, sources, metas):
                v = int(cv.changeset.version)
                if v in batch_cs:
                    first_cs, first_src, first_meta = batch_cs[v]
                    if (self.config.equivocation_detection
                            and src is ChangeSource.BROADCAST
                            and first_src is ChangeSource.BROADCAST):
                        dup_dig = _changes_digest(cv.changeset.changes)
                        if dup_dig != _changes_digest(first_cs.changes):
                            # the in-batch conflicting pair runs the
                            # same signed-attribution decision as the
                            # dup paths — with the first member's
                            # signature verified directly (it is in
                            # hand, no store round-trip needed)
                            self._equiv_verdict(
                                actor, cv.changeset, "content", mta,
                                first=(first_cs,
                                       self._meta_sig(first_meta)),
                                digest=dup_dig,
                            )
                    flags.append(False)
                    continue
                if booked.contains_version(v) and v not in booked.partials:
                    # same duplicate gate as _process_changeset_locked:
                    # a conflicting re-send must not slip past the
                    # merged path's dedup either (broadcast scope —
                    # see _check_content_equivocation)
                    if src is ChangeSource.BROADCAST:
                        self._check_content_equivocation(
                            actor, cv.changeset, mta
                        )
                    flags.append(False)
                    continue
                batch_cs[v] = (cv.changeset, src, mta)
                to_apply.append(cv)
                flags.append(True)
            if not to_apply:
                return flags
            snapshot = self.bookie.snapshot_actor(actor)
            try:
                with self.storage.apply_tx():
                    for cv in to_apply:
                        self.storage.apply_changes_in_tx(
                            cv.changeset.changes
                        )
                    rows: List[tuple] = []
                    for cv in to_apply:
                        cs = cv.changeset
                        v = int(cs.version)
                        # in-memory BEFORE persist: the gap diff reads
                        # the post-apply needed set (persist_version
                        # contract)
                        booked.apply_version(
                            v, cs.max_db_version(), int(cs.last_seq),
                            cs.ts,
                        )
                        rows.append((
                            v, cs.max_db_version(), int(cs.last_seq),
                            int(cs.ts) if cs.ts is not None else None,
                        ))
                    self.bookie.persist_versions(actor, rows)
                    self.bookie.clear_partials(actor, [r[0] for r in rows])
            except BaseException:
                # the DB rolled back: memory must match, or every one
                # of these versions would be skipped as already-applied
                self.bookie.restore_actor(actor, snapshot)
                raise
            if self.config.equivocation_detection:
                for cv in to_apply:
                    cs = cv.changeset
                    _cs, src, mta = batch_cs[int(cs.version)]
                    if src is ChangeSource.BROADCAST:
                        self._remember_digest(
                            actor, int(cs.version),
                            _changes_digest(cs.changes),
                            sig=self._meta_sig(mta),
                        )
            return flags

    # ------------------------------------------------------------------
    # change ingestion (handle_changes parity)
    # ------------------------------------------------------------------

    def _seen_key(self, cv: ChangeV1):
        cs = cv.changeset
        if cs.is_full:
            return (cv.actor_id.bytes, int(cs.version), cs.seqs)
        if cs.is_empty_variant:
            return (cv.actor_id.bytes, "empty", cs.versions)
        return (cv.actor_id.bytes, "empty_set", cs.ranges)

    # -- equivocation defense (docs/faults.md) -------------------------

    def _screen_changeset(self, cs) -> Optional[str]:
        """Structural sanity screen for full changesets; returns the
        rejection kind or None.  A correct origin can never produce an
        inverted seq span, a ``last_seq`` below the span end, or a
        claimed width past ``_MAX_SEQ_SPAN`` — such metadata would
        wedge partial-version buffering (a version whose completion
        seq can never arrive) or lie about completeness."""
        if not cs.is_full or cs.seqs is None or cs.last_seq is None:
            return None
        s, e = int(cs.seqs[0]), int(cs.seqs[1])
        last = int(cs.last_seq)
        if s < 0 or e < s or last < e:
            return "span"
        if (e - s) >= _MAX_SEQ_SPAN or last >= _MAX_SEQ_SPAN:
            return "span"
        for ch in cs.changes:
            if not s <= int(ch.seq) <= e:
                return "span"
        return None

    def _load_equiv_digests(self) -> None:
        """Boot-time reload of the accepted-content digests (newest
        ``seen_cache_size``, re-inserted oldest-first so the in-memory
        FIFO keeps evicting in age order), their signatures, and the
        persisted SIGNED-equivocation proofs — a proven equivocator
        stays permanently quarantined across its victim's reboot."""
        conn = self.storage.conn
        conn.execute(
            "CREATE TABLE IF NOT EXISTS __corro_equiv_digests ("
            " actor_id BLOB NOT NULL, version INTEGER NOT NULL,"
            " digest BLOB NOT NULL, PRIMARY KEY (actor_id, version))"
        )
        # pre-signing databases hold the 3-column table: widen in place
        cols = {r[1] for r in conn.execute(
            "PRAGMA table_info(__corro_equiv_digests)"
        ).fetchall()}
        if "sig" not in cols:
            conn.execute(
                "ALTER TABLE __corro_equiv_digests ADD COLUMN sig BLOB"
            )
        conn.execute(
            "CREATE TABLE IF NOT EXISTS __corro_equiv_proofs ("
            " actor_id BLOB NOT NULL PRIMARY KEY,"
            " version INTEGER NOT NULL, kind TEXT NOT NULL,"
            " msg_a BLOB, sig_a BLOB, msg_b BLOB, sig_b BLOB)"
        )
        rows = conn.execute(
            "SELECT actor_id, version, digest, sig"
            " FROM __corro_equiv_digests ORDER BY rowid DESC LIMIT ?",
            (self.config.seen_cache_size,),
        ).fetchall()
        for actor, v, digest, sig in reversed(rows):
            key = (bytes(actor), int(v))
            self._equiv_digests[key] = bytes(digest)
            if sig is not None:
                self._equiv_sigs[key] = bytes(sig)
        for (actor,) in conn.execute(
            "SELECT actor_id FROM __corro_equiv_proofs"
        ).fetchall():
            actor = bytes(actor)
            self._equiv_quarantined[actor] = float("inf")
            self._equiv_proofed.add(actor)
            # the member record may not exist yet at boot; the
            # _pre_change drop path re-asserts the flag when the
            # proven actor's traffic next shows up
            self.members.set_quarantined(
                actor, True, reason="signed_equivocation"
            )

    def _remember_digest(self, actor: bytes, v: int, digest: bytes,
                         sig: Optional[bytes] = None) -> None:
        """Record the accepted content digest for ``(actor, v)`` —
        in-memory FIFO + durable write-through — plus the origin
        signature when the delivery carried one: a later conflicting
        SIGNED re-claim needs both halves of the pair to form a proof.
        Only the raw signature is stored; the message it covers is
        rebuilt at EVIDENCE time (``_stored_sig_message``) from the
        digest and bookkeeping — a complete changeset's seq span is
        always ``(0, last_seq)``, so the accept hot path pays no
        message construction.  Callers hold the storage lock (both
        sites sit inside apply paths), so the durable row commits on
        the shared write connection without a re-acquire; persistence
        failure never blocks the apply seam."""
        evicted = None
        with self._equiv_lock:
            dig = self._equiv_digests
            dig[(actor, v)] = digest
            if sig is not None:
                self._equiv_sigs[(actor, v)] = sig
            if len(dig) > self.config.seen_cache_size:
                evicted = next(iter(dig))
                dig.pop(evicted)
                self._equiv_sigs.pop(evicted, None)
        try:
            self.storage.conn.execute(
                "INSERT OR REPLACE INTO __corro_equiv_digests"
                " (actor_id, version, digest, sig)"
                " VALUES (?, ?, ?, ?)",
                (actor, v, digest, sig),
            )
            if evicted is not None:
                self.storage.conn.execute(
                    "DELETE FROM __corro_equiv_digests"
                    " WHERE actor_id = ? AND version = ?",
                    evicted,
                )
        except Exception:
            logger.debug("equiv digest persist failed", exc_info=True)

    def _stored_sig_message(self, actor: bytes, v: int,
                            digest: bytes) -> Optional[bytes]:
        """Rebuild the exact ``sig_message`` the ACCEPTED content was
        signed over, from bookkeeping + the stored digest: a complete
        changeset's seq span is ``(0, last_seq)`` by definition, and
        ``last_seq``/``ts`` were recorded at apply time.  Evidence-time
        only — the accept path stores just the 64-byte signature."""
        bv = self.bookie.for_actor(actor)
        entry = bv.versions.get(v)
        if entry is None:
            return None
        _dbv, last_seq = entry
        ts = self.bookie.version_ts(actor, v)
        return _sig_message_raw(
            actor, v, 0, last_seq, last_seq, ts, digest
        )

    # -- signed attribution (docs/faults.md) ---------------------------

    @staticmethod
    def _meta_sig(meta) -> Optional[bytes]:
        return meta[2] if meta is not None and len(meta) > 2 else None

    @staticmethod
    def _meta_peer(meta):
        return meta[3] if meta is not None and len(meta) > 3 else None

    def _sign_changeset(self, cs) -> Optional[bytes]:
        """Sign one of OUR full changesets (cached per version: the
        broadcast loop re-frames on retransmission, the statement
        signed never changes)."""
        if self._sig_secret is None or not cs.is_full:
            return None
        v = int(cs.version)
        sig = self._sig_own_cache.get(v)
        if sig is None:
            from corrosion_tpu_torch.types import crypto

            sig = crypto.sign(
                self._sig_secret, sig_message(self.actor_id, cs)
            )
            cache = self._sig_own_cache
            cache[v] = sig
            if len(cache) > 1024:
                cache.pop(next(iter(cache)))
        return sig

    def _verify_changeset_sig(self, actor: bytes, cs,
                              sig: Optional[bytes],
                              digest: Optional[bytes] = None,
                              ) -> Optional[bool]:
        """Evidence-time verification: True/False when it actually ran
        (counted under ``corro_sig_verifications_total{result=}``),
        None when unverifiable (no signature on the delivery, or the
        origin has no key in the trust directory).  ``digest`` skips
        the ``_changes_digest`` recompute when the caller already paid
        for it (every content-conflict caller has)."""
        if sig is None:
            return None
        pub = self._sig_pubkeys.get(actor)
        if pub is None:
            return None
        from corrosion_tpu_torch.types import crypto

        ok = crypto.verify_cached(pub, sig_message(actor, cs, digest), sig)
        self.metrics.counter(
            "corro_sig_verifications_total",
            result="ok" if ok else "fail",
        )
        return ok

    def _sig_evidence_budget(self) -> bool:
        """Token-bucket admission for evidence-triggered verification
        (``sig_evidence_verify_rate``/s refill, 2x burst).  The spot
        check has its own interval bound; this one keeps the paths an
        ATTACKER can fire at will — digest conflicts and span-screen
        trips are both manufacturable from any accepted changeset —
        from turning ~ms pure-Python verifies into an ingest tax."""
        rate = self.config.sig_evidence_verify_rate
        if rate <= 0.0:
            return True
        now = self._clock.monotonic()
        with self._sig_lock:
            self._sig_ev_tokens = min(
                2.0 * rate,
                self._sig_ev_tokens + (now - self._sig_ev_stamp) * rate,
            )
            self._sig_ev_stamp = now
            if self._sig_ev_tokens < 1.0:
                return False
            self._sig_ev_tokens -= 1.0
        return True

    def _spot_check_due(self, actor: bytes, v: int) -> bool:
        """Deterministic, bounded spot-check sampling: a pure hash of
        (this node, actor, version) against ``sig_spot_check_rate`` —
        no rng stream, so virtual campaigns replay identically — and a
        minimum spacing on the injected clock so pure-Python
        verification can never dominate ingest."""
        rate = self.config.sig_spot_check_rate
        # the ACTOR must be keyed before anything else: an admitted
        # candidate claims the interval slot, and verification of an
        # unkeyed actor returns None — in a partially-keyed cluster a
        # chatty unkeyed actor would otherwise eat every slot and the
        # keyed actors' tripwire would go dark
        if rate <= 0.0 or self._sig_pubkeys.get(actor) is None:
            return False
        # interval bound FIRST: it rejects almost every candidate
        # during bursts, and a float compare is ~10x cheaper than the
        # sampling hash — the hash only runs when a verify could
        # actually be admitted
        now = self._clock.monotonic()
        # check + claim under one lock hold: two apply workers racing
        # the stamp would both admit a verify inside one interval (the
        # hash between them costs ~µs, far under a saved ~ms verify)
        with self._sig_lock:
            if now - self._sig_last_spot \
                    < self.config.sig_spot_check_min_interval_s:
                return False
            h = hashlib.blake2b(
                b"sig-spot" + self.actor_id + actor + struct.pack("<Q", v),
                digest_size=8,
            ).digest()
            if int.from_bytes(h, "big") / 2.0**64 >= rate:
                return False
            self._sig_last_spot = now
        return True

    def _get_breaker(self, addr):
        """The per-peer transport breaker for ``addr``, created with a
        bounded insert when absent (this path is reachable with
        attacker-controlled ephemeral source addresses — tampered
        deliveries from unknown hosts).  None when the transport
        carries no breaker registry.

        Delegates to ``Transport._breaker`` (same thresholds — the
        transport is constructed from this config — same on_evict
        restore via ``on_breaker``, and its registry lock: this runs
        on apply-pool threads concurrently with the loop's dials).
        The fallback covers registry-only doubles like the virtual
        cluster's ``_TransportStub``, which are single-threaded."""
        transport = self.transport
        mk = getattr(transport, "_breaker", None)
        if mk is not None:
            return mk(addr)
        breakers = getattr(transport, "breakers", None)
        if breakers is None:
            return None
        b = breakers.get(addr)
        if b is None:
            from corrosion_tpu_torch.agent.transport import (
                CircuitBreaker, prune_breakers,
            )

            prune_breakers(
                breakers, 4 * getattr(transport, "max_cached", 256),
                on_evict=lambda a: self._on_breaker(a, False),
            )
            b = breakers[addr] = CircuitBreaker(
                self.config.breaker_threshold,
                self.config.breaker_cooldown,
                now=self._clock.monotonic,
            )
        return b

    def _trip_breaker(self, addr) -> None:
        """Force the per-peer transport breaker OPEN (verified-hostile
        evidence: tampered bytes or garbage serves are not ordinary
        flakiness worth `threshold` free strikes)."""
        addr = tuple(addr)
        b = self._get_breaker(addr)
        if b is not None and b.trip():
            self.metrics.counter("corro_transport_breaker_opens_total")
            self._on_breaker(addr, True)

    def _strike_breaker(self, addr) -> None:
        """One breaker failure strike (AMBIGUOUS evidence: a sync
        session deadline could be an honest slow peer, so it earns
        `threshold` free strikes before quarantine — unlike the hard
        `_trip_breaker` reserved for verified-hostile bytes).  Keeps a
        slow-trickle server from being re-selected round after round
        forever: enough deadline aborts open its breaker and
        `_choose_sync_peers` stops offering it sessions."""
        addr = tuple(addr)
        fail = getattr(self.transport, "_breaker_failure", None)
        if fail is not None:
            fail(addr)
            return
        b = self._get_breaker(addr)
        if b is not None and b.record_failure():
            self.metrics.counter("corro_transport_breaker_opens_total")
            self._on_breaker(addr, True)

    def _blame_relay(self, peer) -> None:
        """A signature FAILURE convicts the DELIVERY, never the named
        origin: the one thing an invalid signature proves is that the
        (claimed origin, content, signature) triple was not produced
        by the origin's key — the tamperer could be the delivering
        relay or a forger upstream, but the origin cannot be framed by
        it.  So the delivering transport eats breaker-class (bounded,
        half-open-recoverable) quarantine, and the origin's verdict
        state is never touched."""
        if peer is None:
            return
        addr = tuple(peer)
        if not any(tuple(m.addr) == addr for m in self.members.all()):
            # live inbound streams carry the peer's EPHEMERAL port,
            # not its gossip address; when exactly one member shares
            # the host the delivery is attributable anyway (distinct
            # hosts in real deployments — a loopback harness stays
            # unattributed rather than blaming the wrong node).
            # NAMED RESIDUAL (docs/faults.md): an UNREGISTERED process
            # co-located with that one member (container/NAT sharing
            # its host) can draw this transport-class blame onto it.
            # Bounded by construction — it is breaker-class (sampling
            # deprioritization, half-open-recoverable once the
            # tampered traffic stops), never the actor-class verdict
            # a signature proof mints — and the alternative, dropping
            # the fallback, would leave live tampering relays entirely
            # unattributable since exact addr matches never happen on
            # real inbound sockets.
            same_host = [
                m for m in self.members.all()
                if tuple(m.addr)[0] == addr[0]
            ]
            if len(same_host) == 1:
                addr = tuple(same_host[0].addr)
        # breaker FIRST: a newly-opened breaker's _on_breaker labels
        # the member reason="breaker", and the equal-rank relabel rule
        # means whichever transport-class reason lands LAST wins — the
        # specific evidence class must be the one that sticks
        self._trip_breaker(addr)
        hit = self.members.quarantine_by_addr(addr, True,
                                              reason="sig_failure")
        if hit:
            self.metrics.counter(
                "corro_members_quarantine_transitions_total",
                state="sig_failure",
            )
            self._flight_event(
                "quarantine", addr=f"{addr[0]}:{addr[1]}", on=True,
                reason="sig_failure",
            )

    def _equiv_verdict(self, actor: bytes, cs, kind: str, meta,
                       first: Optional[tuple] = None,
                       digest: Optional[bytes] = None) -> bool:
        """Attribution decision once hostile evidence fired (a content
        conflict or a span-screen trip).  Returns True when the ORIGIN
        was convicted (quarantined), False when blame landed on the
        delivering relay instead.

        * delivery signature INVALID → the bytes were tampered in
          transit; the relay's breaker is quarantined and the origin
          is untouched (unframeable);
        * delivery signature VALID → the origin really said this.  A
          signed span-garbage claim, or a signed conflict against an
          accepted content whose OWN stored signature also verifies,
          is a persistable PROOF: the quarantine is permanent;
        * unverifiable (unsigned delivery / unknown key) → the
          pre-signing bounded-window verdict, byte-for-byte;
        * signed but over the evidence-verification budget
          (``sig_evidence_verify_rate``) → the conflicting message is
          dropped with NO verdict (every caller is a drop path; the
          content never applies).  Falling back to the unsigned
          bounded-window verdict here would let a tampered-copy flood
          frame the origin — the one thing the signature exists to
          prevent.

        ``first`` = ``(accepted_cs, accepted_sig)`` for the in-batch
        conflicting-pair path, where the accepted half is in hand
        before any digest was stored.  ``digest`` = the incoming
        changeset's ``_changes_digest`` when the caller already
        computed it."""
        sig = self._meta_sig(meta)
        if sig is not None and self._sig_pubkeys.get(actor) is not None:
            if not self._sig_evidence_budget():
                self.metrics.counter(
                    "corro_sig_verifications_total", result="skipped"
                )
                return False
            if digest is None:
                digest = _changes_digest(cs.changes)
        ver = self._verify_changeset_sig(actor, cs, sig, digest)
        if ver is False:
            self._blame_relay(self._meta_peer(meta))
            return False
        proof = None
        if ver is True:
            from corrosion_tpu_torch.types import crypto

            msg = sig_message(actor, cs, digest)
            v = int(cs.version)
            pub = self._sig_pubkeys.get(actor)
            if kind == "span":
                # one signed, structurally-impossible claim is its own
                # proof: no relay could mint it without the origin key
                proof = (v, kind, msg, sig, None, None)
            elif first is not None:
                first_cs, first_sig = first
                if first_sig is not None and pub is not None:
                    smsg = sig_message(actor, first_cs)
                    if smsg != msg and crypto.verify_cached(
                            pub, smsg, first_sig):
                        proof = (v, kind, smsg, first_sig, msg, sig)
            else:
                with self._equiv_lock:
                    ssig = self._equiv_sigs.get((actor, v))
                    sdigest = self._equiv_digests.get((actor, v))
                if ssig is not None and sdigest is not None \
                        and pub is not None:
                    smsg = self._stored_sig_message(actor, v, sdigest)
                    if (smsg is not None and smsg != msg
                            and crypto.verify_cached(pub, smsg, ssig)):
                        proof = (v, kind, smsg, ssig, msg, sig)
        self._note_equivocation(actor, kind, proof=proof)
        return True

    def _check_content_equivocation(self, actor: bytes, cs,
                                    meta=None) -> bool:
        """Compare a duplicate complete changeset's content digest
        against the accepted one for its (actor, version); a mismatch
        is equivocation (returns True after counting + quarantining).
        Byte-identical replays compare equal and stay plain
        duplicates.

        BROADCAST scope only (callers gate, and digests are only
        remembered for broadcast-applied contents): the gossiped bytes
        of one version are immutable — the origin frames them once and
        rebroadcast relays them verbatim — so any difference is
        hostile.  Sync-served content is NOT: ``_collect_changes_on``
        reconstructs a version from the CURRENT clock/data tables, so
        a re-serve after later overwrites legitimately differs from
        the original broadcast, and comparing across the two paths
        would quarantine honest origins under ordinary overwrite
        workloads.

        Two windows the per-node detector deliberately leaves to the
        CROSS-NODE checker (``ClusterObserver.no_divergence``):
        conflicting contents split across nodes so each sees only one
        (nothing to compare locally), and a conflicting pair racing a
        node's first arrival before any digest is remembered — except
        the same-apply-batch case, which ``_apply_complete_group``
        compares directly.

        Cost note: this hashes the duplicate's contents (sort + repr +
        blake2b over its few changes) whenever an accepted digest
        exists — broadcast fanout duplicates of recent versions pay
        it.  That is the price of the defense: the dedup key
        deliberately excludes content, so any cheaper per-key shortcut
        would let a later conflicting re-send launder through the
        cache.  ``equivocation_detection = false`` restores the plain
        dict-hit duplicate path."""
        if not self.config.equivocation_detection:
            return False
        if not (cs.is_full and cs.is_complete()):
            return False
        with self._equiv_lock:
            prev = self._equiv_digests.get((actor, int(cs.version)))
        if prev is None:
            return False
        dig = _changes_digest(cs.changes)
        if prev == dig:
            return False
        return self._equiv_verdict(actor, cs, "content", meta, digest=dig)

    def _note_equivocation(self, actor: bytes, kind: str,
                           proof: Optional[tuple] = None) -> None:
        """Count one hostile observation and quarantine the origin
        actor through the Members path (the breaker-quarantine shape,
        protocol-level evidence): out of ring0, deprioritized in
        sampling, reason surfaced in ``cluster_members`` — and its
        further changesets drop at ``_pre_change``, so an equivocator
        cannot keep poisoning CRDT state.

        UNSIGNED evidence gets a bounded WINDOW
        (``equiv_quarantine_s``), not a permanent severance: without a
        verified signature, attribution rests on a forgeable actor id
        (mTLS authenticates the channel, not the claimed origin of
        relayed changesets), so a hostile relay could frame an honest
        actor — an unbounded drop-all would let one forged message
        inflict permanent divergence, worse than the attack it guards.

        A verified signed ``proof`` (``_equiv_verdict``) removes that
        caveat: only the origin's key could have produced the
        conflicting pair, so the verdict becomes PERMANENT
        (``quarantine_reason="signed_equivocation"``), persisted to
        ``__corro_equiv_proofs`` so it survives this victim's restart.

        The already-accepted first content stays either way: it is
        consistent cluster-wide as long as it won every node's first
        arrival, which the no-divergence checker verifies cross-node."""
        self.metrics.counter(
            "corro_sync_equivocations_total", kind=kind
        )
        hold = self.config.equiv_quarantine_s
        deadline = (self._clock.monotonic() + hold) if hold > 0 \
            else float("inf")
        if proof is not None:
            deadline = float("inf")
        with self._equiv_lock:
            prev_deadline = self._equiv_quarantined.get(actor)
            first = prev_deadline is None
            # a signed proof escalates; a later unsigned observation
            # must never SHORTEN a standing permanent verdict
            if prev_deadline is None or deadline > prev_deadline \
                    or proof is not None:
                self._equiv_quarantined[actor] = deadline
            # escalation = the FIRST proof over a standing unsigned
            # verdict.  Tracked as a set, not inferred from the
            # deadline: equiv_quarantine_s=0 gives unsigned verdicts
            # an inf deadline too, and a proof must still relabel
            # those to signed_equivocation
            escalate = (proof is not None and not first
                        and actor not in self._equiv_proofed)
            if proof is not None:
                self._equiv_proofed.add(actor)
        reason = "signed_equivocation" if proof is not None \
            else "equivocation"
        # per-verdict journal record (the drop-volume "quarantined"
        # kind stays counter-only: one line per dropped message would
        # flood the bounded ring during an attack)
        self._flight_event("equivocation", actor=actor.hex(), kind=kind)
        if proof is not None:
            self._persist_equiv_proof(actor, proof)
        if first or escalate:
            logger.warning(
                "equivocation detected (kind=%s, %s) from %s: "
                "quarantining", kind, reason, actor.hex(),
            )
            self.members.set_quarantined(actor, True, reason=reason)
            self.metrics.counter(
                "corro_members_quarantine_transitions_total",
                state=reason,
            )
            self._flight_event(
                "quarantine", actor=actor.hex(), on=True,
                reason=reason,
            )

    def _persist_equiv_proof(self, actor: bytes, proof: tuple) -> None:
        """Durably record a signed-equivocation proof (idempotent —
        the first proof for an actor wins; re-offenses don't rewrite
        it).  Best-effort like the digest write-through: persistence
        failure must never break the verdict seam (the in-memory
        deadline already went permanent)."""
        v, kind, msg_a, sig_a, msg_b, sig_b = proof
        try:
            with self.storage._lock:
                self.storage.conn.execute(
                    "INSERT OR IGNORE INTO __corro_equiv_proofs"
                    " (actor_id, version, kind, msg_a, sig_a,"
                    "  msg_b, sig_b) VALUES (?, ?, ?, ?, ?, ?, ?)",
                    (actor, v, kind, msg_a, sig_a, msg_b, sig_b),
                )
        except Exception:
            logger.debug("equiv proof persist failed", exc_info=True)

    def _rebroadcast_hop(self, cv: ChangeV1, meta=None) -> int:
        """Hop count for re-gossiping a received payload: received hop
        + 1 from the traced envelope when the payload carried one,
        falling back to the debug_hops receipt table (0 without
        either)."""
        if self.config.debug_hops:
            with self._seen_lock:
                return self._recv_hops.get(self._seen_key(cv), 0) + 1
        if meta is not None:
            return meta[1] + 1
        return 0

    def handle_change(self, cv: ChangeV1, source: ChangeSource,
                      rebroadcast: bool = True, meta=None,
                      record_prov: bool = True) -> bool:
        """Process one incoming changeset; returns True if it was news.

        ``rebroadcast=False`` when called from the change loop's worker
        thread — the loop requeues news itself on the event loop.
        ``meta`` is the envelope receipt context ``(traceparent, hop,
        sig, peer)``, when the payload carried one — ``sig`` is the
        origin's Ed25519 signature from the signed envelope and
        ``peer`` the delivering transport's address (the blame target
        when that signature fails to verify).  ``record_prov=False``
        when the caller flushes the whole batch's provenance in one
        pass (``_record_provenance_many``).
        """
        if not self._pre_change(cv, source, meta):
            return False
        news = self._process_changeset(cv, source, meta)
        self._post_change(cv, source, news, rebroadcast, meta=meta,
                          record_prov=record_prov)
        return news

    def _pre_change(self, cv: ChangeV1, source: ChangeSource,
                    meta=None) -> bool:
        """Hostile screen + dedup + clock ingestion ahead of applying;
        False = drop."""
        actor = cv.actor_id.bytes
        if actor == self.actor_id:
            return False
        deadline = self._equiv_quarantined.get(actor)
        if deadline is not None:
            if self._clock.monotonic() < deadline:
                # a detected equivocator's traffic is poison while the
                # verdict holds: drop everything, count the volume
                self.metrics.counter(
                    "corro_sync_equivocations_total", kind="quarantined"
                )
                if actor in self._equiv_proofed:
                    # permanent (signed-proof) verdicts re-assert the
                    # Members flag: the record can postdate the boot
                    # reload (e.g. a reborn node that re-learned the
                    # proven actor through gossip).  Keyed on proof
                    # state, not deadline==inf: equiv_quarantine_s=0
                    # parks UNSIGNED verdicts at inf too, and those
                    # must not masquerade as signed
                    m = self.members.get(actor)
                    if m is not None and not m.quarantined:
                        self.members.set_quarantined(
                            actor, True, reason="signed_equivocation"
                        )
                return False
            # verdict expired: re-admit (bounded blast radius for a
            # FRAMED honest actor — attribution is unsigned).  The
            # digests survive, so a real equivocator's next conflicting
            # dup re-quarantines immediately.
            with self._equiv_lock:
                self._equiv_quarantined.pop(actor, None)
            self.members.set_quarantined(actor, False,
                                         reason="equivocation")
            self.metrics.counter(
                "corro_members_quarantine_transitions_total",
                state="equivocation_expired",
            )
            self._flight_event(
                "quarantine", actor=actor.hex(), on=False,
                reason="expired",
            )
        key = self._seen_key(cv)
        if source is ChangeSource.BROADCAST:
            with self._seen_lock:
                dup = key in self._seen
                if not dup:
                    self._seen[key] = None
                    if len(self._seen) > self.config.seen_cache_size:
                        evicted = next(iter(self._seen))
                        self._seen.pop(evicted)
                        self._recv_hops.pop(evicted, None)
            if dup:
                # the dedup cache must not LAUNDER equivocation: a
                # conflicting re-send shares the (actor, version, seqs)
                # key with the accepted content, so the duplicate path
                # is exactly where conflicting contents hide
                self._check_content_equivocation(actor, cv.changeset,
                                                 meta)
                return False
        # structural screen AFTER dedup: fanout duplicates drop on the
        # dict hit without paying the O(changes) span walk — a garbage
        # duplicate is inert either way (dropped, never applied or
        # buffered); only first arrivals and sync deliveries pay
        if self.config.equivocation_detection:
            kind = self._screen_changeset(cv.changeset)
            if kind is not None:
                self._equiv_verdict(actor, cv.changeset, kind, meta)
                return False
            # bounded random spot check (broadcast first arrivals
            # only): the hot path stays verification-free unless the
            # deterministic sample + minimum interval both admit it
            sig = self._meta_sig(meta)
            cs = cv.changeset
            if (sig is not None and source is ChangeSource.BROADCAST
                    and cs.is_full and cs.is_complete()
                    and self._spot_check_due(actor, int(cs.version))
                    and self._verify_changeset_sig(actor, cs, sig)
                    is False):
                self._blame_relay(self._meta_peer(meta))
                return False
        # clock ingestion: a remote ts past max_delta_ns (the 300 ms
        # gossip clock-delta rule) is REJECTED — the merge raises and
        # the local clock stays unpolluted; the changeset itself still
        # applies (data-plane convergence must not hinge on a peer's
        # oscillator)
        if cv.changeset.ts is not None:
            try:
                self.clock.update_with_timestamp(cv.changeset.ts)
            except Exception:
                pass
        return True

    def _post_change(self, cv: ChangeV1, source: ChangeSource, news: bool,
                     rebroadcast: bool, compact: bool = True,
                     meta=None, record_prov: bool = True) -> None:
        """Accounting + rebroadcast + subscription fan-out after an
        apply (``compact=False`` when the caller sweeps once per merged
        transaction group instead of per changeset)."""
        if compact and news and cv.changeset.is_full:
            # a remote apply can overwrite our own rows' change entries
            self._compact_best_effort()
        self.metrics.counter(
            "corro_changes_received_total",
            source=source.value,
            news=str(news).lower(),
        )
        if news and record_prov:
            self._record_provenance(cv, source, meta)
        if (rebroadcast and news and source is ChangeSource.BROADCAST
                and self._loop):
            self.metrics.counter("corro_broadcast_rebroadcast_total")
            self.metrics.counter(
                "corro_channel_sends_total", channel="bcast")
            self._bcast_queue.put_nowait(
                (cv, self.config.max_transmissions,
                 self._rebroadcast_hop(cv, meta),
                 meta[0] if meta is not None else None,
                 self._meta_sig(meta))
            )
        if news and self.on_change is not None:
            cs = cv.changeset
            if cs.is_full and not cs.is_complete():
                # a chunk of a partial version: the subscriptions see
                # the version once, whole, when its last chunk applies
                # it (buffered chunks are not in the tables yet)
                done = self._promoted.pop(
                    (cv.actor_id.bytes, int(cs.version)), None)
                if done is None:
                    return
                cv = ChangeV1(actor_id=cv.actor_id, changeset=Changeset.full(
                    cs.version, done, (0, cs.last_seq), cs.last_seq, cs.ts))
            self.on_change(cv)

    def _record_provenance(self, cv: ChangeV1, source: ChangeSource,
                           meta) -> None:
        """Change provenance: on the FIRST arrival of each (actor,
        version), record origin-commit → apply lag per arrival path
        (``corro_change_lag_seconds{path=broadcast|rebroadcast|sync}``)
        and refresh the origin actor's staleness base — the node's own
        convergence measurement, no external harness required."""
        self._record_provenance_many(((cv, source, True, meta),))

    def _record_provenance_many(self, results) -> None:
        """Batched provenance for a whole apply batch (same semantics
        as :meth:`_record_provenance`, same ``results`` tuples
        ``_apply_batch`` returns): one dedupe-lock hold, one wall-clock
        read, and one metrics-lock hold for N changesets — per-item
        recording costs ~5% of ingest throughput, the bench overhead
        A/B's whole budget."""
        if not self.config.provenance:
            return
        now = self._clock.wall()
        # ONE arrival-HLC observation for the whole batch (mirroring the
        # single wall-clock read above): the items share one arrival
        # instant, and per-item observe_timestamp calls would take the
        # contended HLClock lock N times inside the _prov_lock hold
        hlc_now = int(self.clock.observe_timestamp())
        lags = []
        with self._prov_lock:
            seen = self._prov_seen
            origin_ts = self._origin_ts_wall
            for cv, source, news, meta in results:
                if not news:
                    continue
                cs = cv.changeset
                ts = cs.ts
                if ts is None or not cs.is_full:
                    continue
                actor = cv.actor_id.bytes
                key = (actor, int(cs.version))
                if key in seen:
                    continue
                # the first-seen STAMP (wall + the batch's arrival-HLC
                # observation): the timeline plane's raw material —
                # ClusterObserver derives the time-resolved coverage
                # curve of an (actor, version) wave from these across
                # nodes.  An observation, not `clock.last` (after
                # _pre_change merged the changeset ts, `last` can EQUAL
                # the origin commit ts and would stamp every arrival at
                # its own commit instant) and not new_timestamp
                # (telemetry must not advance the protocol clock)
                seen[key] = (now, hlc_now)
                if len(seen) > self.config.seen_cache_size:
                    seen.pop(next(iter(seen)))
                origin = ts.wall_seconds()
                if origin > origin_ts.get(actor, 0.0):
                    origin_ts[actor] = origin
                # idle clock for eviction: LOCAL receipt time, so an
                # actively-writing actor is never evicted no matter
                # how skewed its origin clock is
                self._origin_seen_wall[actor] = now
                if source is ChangeSource.SYNC:
                    lkey = _PROV_KEY_SYNC
                elif meta is not None and meta[1] > 0:
                    lkey = _PROV_KEY_REBROADCAST
                else:
                    lkey = _PROV_KEY_BROADCAST
                lags.append((lkey, now - origin if now > origin else 0.0))
        if lags:
            self.metrics.histogram_keyed_many(
                "corro_change_lag_seconds", lags
            )

    def _record_apply_span(self, cv: ChangeV1, meta, news: bool,
                           dur_ms: float, group: int = 0) -> None:
        """Complete the broadcast trace on the receiving node: one
        ``bcast.apply`` span per version FIRST ARRIVAL that carried a
        traceparent (non-news duplicates would drown the ring — the
        fanout delivers every payload several times per node)."""
        if not news or meta is None or meta[0] is None:
            return
        cs = cv.changeset
        attrs = {
            "actor": cv.actor_id.bytes.hex(),
            "hop": meta[1],
        }
        if cs.is_full:
            attrs["version"] = int(cs.version)
        if group:
            # merged-transaction apply: the duration is the group's
            attrs["group"] = group
        if tracing.record("bcast.apply", remote=meta[0],
                          duration_ms=dur_ms, **attrs) is not None:
            self.metrics.counter("corro_trace_spans_total")

    def _process_changeset(self, cv: ChangeV1,
                           source: ChangeSource = ChangeSource.SYNC,
                           meta=None) -> bool:
        # hold the storage lock across the have-it-already checks AND the
        # apply transaction: concurrent apply workers mutate the same
        # booked RangeSets, and those mutations are multi-step
        with self.storage._lock:
            return self._process_changeset_locked(cv, source, meta)

    def _process_changeset_locked(self, cv: ChangeV1,
                                  source: ChangeSource,
                                  meta=None) -> bool:
        actor = cv.actor_id.bytes
        cs = cv.changeset
        booked = self.bookie.for_actor(actor)
        ts = int(cs.ts) if cs.ts is not None else None

        if cs.is_empty_variant:
            s, e = int(cs.versions[0]), int(cs.versions[1])
            if booked.cleared.contains_span(s, e):
                return False
            with self.storage.apply_tx():
                booked.mark_cleared(s, e)
                self.bookie.persist_cleared(actor, s, e, ts)
            return True

        if cs.is_empty_set:
            # a sync EmptySet is one COMPLETE per-ts group of the
            # server's cleared ranges, so processing it justifies
            # advancing the watermark even when every range was already
            # held; marking is idempotent, so out-of-order groups are
            # safe (handlers.rs:539-734, peer.rs:715-762)
            new = False
            with self.storage.apply_tx():
                for s, e in cs.ranges:
                    if not booked.cleared.contains_span(int(s), int(e)):
                        booked.mark_cleared(int(s), int(e))
                        self.bookie.persist_cleared(actor, int(s), int(e), ts)
                        new = True
                if ts is not None:
                    booked.update_cleared_ts(cs.ts)
                    self.bookie.persist_sync_state(actor, ts)
            return new

        v = int(cs.version)
        if booked.contains_version(v) and v not in booked.partials:
            # duplicate of an accepted version: a cache-evicted
            # rebroadcast lands here — conflicting gossiped contents
            # must be caught, byte-identical replays absorbed.
            # Broadcast scope only: see _check_content_equivocation
            if source is ChangeSource.BROADCAST:
                self._check_content_equivocation(actor, cs, meta)
            return False

        if cs.is_complete():
            with self.storage.apply_tx():
                self.storage.apply_changes_in_tx(cs.changes)
                booked.apply_version(
                    v, cs.max_db_version(), int(cs.last_seq), cs.ts
                )
                self.bookie.persist_version(
                    actor, v, cs.max_db_version(), int(cs.last_seq), ts
                )
                self.bookie.clear_partial(actor, v)
            if (self.config.equivocation_detection
                    and source is ChangeSource.BROADCAST):
                self._remember_digest(
                    actor, v, _changes_digest(cs.changes),
                    sig=self._meta_sig(meta),
                )
            return True

        # partial: buffer + maybe promote.  Buffered blobs are the
        # speedy binary codec behind a one-byte format prefix (legacy
        # JSON blobs from older databases still decode on read)
        with self.storage.apply_tx():
            self.bookie.buffer_changes(
                actor, v,
                [(int(ch.seq), wire.encode_buffered_change(ch))
                 for ch in cs.changes],
            )
            partial = booked.insert_partial(
                v, (int(cs.seqs[0]), int(cs.seqs[1])), int(cs.last_seq), cs.ts
            )
            self.bookie.persist_partial(
                actor, v, (int(cs.seqs[0]), int(cs.seqs[1])),
                int(cs.last_seq), ts,
            )
            if partial.is_complete():
                buffered = [
                    wire.decode_buffered_change(blob)
                    for _, blob in self.bookie.buffered_changes(actor, v)
                ]
                self.storage.apply_changes_in_tx(buffered)
                booked.apply_version(
                    v, max((int(c.db_version) for c in buffered), default=0),
                    int(cs.last_seq), cs.ts,
                )
                self.bookie.persist_version(
                    actor, v,
                    max((int(c.db_version) for c in buffered), default=0),
                    int(cs.last_seq), ts,
                )
                self.bookie.clear_partial(actor, v)
                if self.on_change is not None:
                    self._promoted[(actor, v)] = buffered
                # promoted partials record NO digest: their chunks can
                # legitimately mix broadcast and sync deliveries, and
                # sync-served content reflects serve-time compaction —
                # an unreliable identity for 'what the actor gossiped'
        return True

    # ------------------------------------------------------------------
    # anti-entropy sync
    # ------------------------------------------------------------------

    def generate_sync(self) -> SyncStateV1:
        # snapshot under the storage/bookie lock: RangeSet mutations are
        # multi-step, so an unlocked reader could zip mismatched span
        # lists.  The snapshot is cached against the bookie generation
        # (dirty flag bumped by every bookkeeping mutation), so a burst
        # of inbound handshakes re-walks every actor's RangeSets only
        # when something actually changed.  The returned state is a
        # SHARED immutable snapshot — callers must not mutate it.
        with self.storage._lock:
            gen = self.bookie.gen
            cached = self._sync_gen_cache
            if cached is not None and cached[0] == gen:
                self.metrics.counter(
                    "corro_sync_state_cache_total", hit="true")
                return cached[1]
            state = self._generate_sync_locked()
            self._sync_gen_cache = (gen, state)
            self.metrics.counter(
                "corro_sync_state_cache_total", hit="false")
            return state

    def _generate_sync_locked(self) -> SyncStateV1:
        state = SyncStateV1(actor_id=ActorId(self.actor_id))
        for actor, bv in self.bookie.actors().items():
            last = bv.last()
            if last == 0:
                continue
            aid = ActorId(actor)
            state.heads[aid] = Version(last)
            spans = bv.needed_spans()
            if spans:
                state.need[aid] = spans
            partials = bv.partial_needs()
            if partials:
                state.partial_need[aid] = {
                    Version(v): gaps for v, gaps in partials.items()
                }
            if self.config.snapshot_serve and bv.snap_floor > 0:
                # advertised floors drive the client-side snapshot
                # dispatch: needs at-or-below a floor cannot be served
                # change-by-change from this node (docs/sync.md)
                state.snap_floors[aid] = bv.snap_floor
            if actor == self.actor_id:
                state.last_cleared_ts = bv.last_cleared_ts
        return state

    def _clear_buffered_meta(self, chunk: int = 1000) -> int:
        """Delete buffered-change/seq bookkeeping rows for versions that
        are now cleared, in bounded chunks (clear_buffered_meta_loop
        parity, util.rs:425-480).  Returns rows deleted.

        The storage lock is released and re-acquired between chunks at
        the LOW tier: the spans are snapshotted up front, so a 10k-row
        sweep becomes many short maintenance holds instead of one long
        one that starves applies and client writes."""
        deleted = 0
        with self.storage._lock:
            work = [
                (actor, s, e)
                for actor, bv in self.bookie.actors().items()
                for s, e in bv.cleared.spans()
            ]
        for actor, s, e in work:
            for table in ("__corro_seq_bookkeeping",
                          "__corro_buffered_changes"):
                while True:
                    with self.storage._lock.prio(
                        PRIO_LOW, "buffered-meta"
                    ):
                        cur = self.storage.conn.execute(
                            f"DELETE FROM {table} WHERE rowid IN ("
                            f"SELECT rowid FROM {table} WHERE actor_id=? "
                            "AND version BETWEEN ? AND ? LIMIT ?)",
                            (actor, s, e, chunk),
                        )
                    deleted += cur.rowcount
                    if cur.rowcount < chunk:
                        break
        if deleted:
            self.metrics.counter(
                "corro_buffered_meta_cleared_total", deleted
            )
        return deleted

    async def _maintenance_loop(self) -> None:
        """WAL checkpoint + incremental vacuum + compaction leftovers +
        buffered-meta clearing (handlers.rs:394-534, util.rs:425-480).
        The SQL body runs on the apply pool: a WAL checkpoint of a busy
        database takes 100ms+, and running it on the event loop stalled
        SWIM acks every maintenance tick."""
        while True:
            await self._clock.sleep(self.config.maintenance_interval)
            try:
                await self._loop.run_in_executor(
                    self._apply_pool, self._maintenance_pass
                )
            except Exception:
                pass
            self.metrics.gauge(
                "corro_members_ring0", len(self.members.ring0())
            )

    def _maintenance_pass(self) -> None:
        """One blocking maintenance sweep (worker thread)."""
        try:
            # crash-leftover impacted versions from before a restart +
            # snapshot-floor advancement (the dedicated compaction loop
            # normally runs this faster; this is the backstop cadence)
            self._compaction_pass()
            self._clear_buffered_meta()
        except Exception:
            pass
        try:
            from corrosion_tpu_torch.agent.locks import PRIO_LOW

            # maintenance yields the connection to applies and API
            # writes (LOW tier) and gets interrupted rather than
            # stalling them behind a long truncate/vacuum
            with self.storage._lock.prio(PRIO_LOW, "maintenance"), \
                    self.storage.interruptible(30.0):
                (wal_pages, _) = self.storage.conn.execute(
                    "PRAGMA wal_checkpoint(PASSIVE)"
                ).fetchone()[1:]
                if wal_pages is not None and \
                        wal_pages > self.config.wal_truncate_pages:
                    self.storage.conn.execute(
                        "PRAGMA wal_checkpoint(TRUNCATE)")
                    self.metrics.counter("corro_db_wal_truncations")
                (freelist,) = self.storage.conn.execute(
                    "PRAGMA freelist_count"
                ).fetchone()
                if freelist > self.config.vacuum_free_pages:
                    self.storage.conn.execute(
                        f"PRAGMA incremental_vacuum({freelist // 2})"
                    )
                    self.metrics.counter("corro_db_vacuums")
                # db/queue gauges moved to scrape time
                # (metric_gauges): one owner per series name, and
                # a scrape reads current values instead of stale
                # maintenance-tick snapshots
                if wal_pages is not None:
                    self.metrics.gauge(
                        "corro_db_wal_pages", wal_pages
                    )
        except Exception:
            pass

    async def _sync_loop(self) -> None:
        from corrosion_tpu_torch.utils.backoff import Backoff

        delays = iter(
            Backoff(
                base=self.config.sync_interval_min,
                cap=self.config.sync_interval_max,
                rng=self._rng,
            )
        )
        while True:
            await self._clock.sleep(next(delays))
            try:
                await self.sync_round()
            except Exception:
                self.metrics.counter("corro_sync_round_errors_total")

    def _breaker_open(self, m: Member) -> bool:
        """Is the transport circuit breaker for this member's address
        open right now?  (Quarantine normally mirrors this, but the
        breaker can open between the transition callback and the next
        membership update — check both.)"""
        if self.transport is None:
            return False
        b = self.transport.breakers.get(tuple(m.addr))
        return b is not None and b.is_open

    def _choose_sync_peers(self, ours: SyncStateV1) -> List[Member]:
        """Peer choice heuristic (handlers.rs:963-1074): sample 2x the
        desired count uniformly, then keep the best by (most needed
        from them, longest since last sync, lowest RTT).

        Quarantined / breaker-open members are excluded outright — a
        dead-but-undetected peer chosen here would absorb a whole sync
        round (the partial-retry path already filters them; this keeps
        the first pass from wasting its round the same way)."""
        peers = [
            m for m in self.members.alive()
            if m.state is MemberState.ALIVE and not m.quarantined
            and not self._breaker_open(m)
        ]
        if not peers:
            return []
        desired = max(min(len(peers) // 100, 10), min(3, len(peers)))
        desired = min(desired, self.config.sync_peers)
        cands = self._rng.sample(peers, min(desired * 2, len(peers)))
        cands.sort(
            key=lambda m: (
                -ours.need_len_for_actor(ActorId(m.actor_id)),
                m.last_sync_ts,
                m.rtt_ms if m.rtt_ms is not None else float("inf"),
            )
        )
        return cands[:desired]

    async def sync_round(self) -> int:
        """One full client round: choose peers, parallel_sync them."""
        ours = self.generate_sync()
        chosen = self._choose_sync_peers(ours)
        if not chosen:
            return 0
        return await self.parallel_sync(chosen, ours)

    async def parallel_sync(
        self, members: Sequence[Member], ours: Optional[SyncStateV1] = None,
        _retry: bool = True,
    ) -> int:
        """Sync with several peers at once, deduping needs across them
        (peer.rs:1039-1466): handshake everyone, then allocate each need
        to exactly one server — two peers serving disjoint halves of a
        node's gaps is the healthy case, not a coincidence.

        Degraded-mode hardening: a peer failing MID-STREAM is a
        retryable partial round, not an aborted one — everything it
        served before dying is already ingested, and the remaining needs
        are recomputed from bookkeeping and retried once against peers
        not used this round (``_retry=False`` bounds the recursion)."""
        if ours is None:
            ours = self.generate_sync()
        # the whole client round is one trace; each handshake's
        # BiPayload carries its traceparent so the servers' spans share
        # the trace id (sync.rs:32-67 propagation)
        # timed() records on every exit path — including handshake-
        # timeout rounds, which are exactly the slow ones
        with self.metrics.timed("corro_sync_client_round_seconds"), \
                tracing.span("sync.client_round", peers=len(members)) as sp:
            self.metrics.counter("corro_trace_spans_total")
            attempts = await asyncio.gather(
                *(self._sync_handshake(m) for m in members),
                return_exceptions=True,
            )
            sessions = [s for s in attempts if isinstance(s, dict)]
            self.metrics.counter(
                "corro_sync_handshakes_total", len(attempts))
            failed = len(attempts) - len(sessions)
            if failed:
                self.metrics.counter(
                    "corro_sync_handshake_failures_total", failed)
            if not sessions:
                self.metrics.counter("corro_sync_empty_rounds_total")
                return 0
            snap_sess = None
            try:
                # snapshot-or-changes dispatch (docs/sync.md): a server
                # whose advertised floors cover needs it can no longer
                # serve change-by-change gets a snap_request instead of
                # need allocation (its needs are satisfied wholesale by
                # the install + tail round)
                snap_sess, sessions = self._pick_snapshot_session(
                    sessions, ours
                )
                self._allocate_needs(sessions, ours)
                kind_counts: Dict[str, int] = {}
                for sess in sessions:
                    for _actor, needs in sess["needs"].items():
                        for nd in needs:
                            k = nd.kind if nd.kind in (
                                "full", "partial", "empty"
                            ) else "other"
                            kind_counts[k] = kind_counts.get(k, 0) + 1
                if snap_sess is not None:
                    kind_counts["snapshot"] = 1
                for k, c in kind_counts.items():
                    self.metrics.counter(
                        "corro_sync_needs_requested_total", c, kind=k
                    )
            except BaseException:
                # one malformed peer state must not leak the other sessions
                for s in sessions:
                    s["writer"].close()
                if snap_sess is not None:
                    snap_sess["writer"].close()
                raise
            session_tasks = [self._sync_session(s) for s in sessions]
            if snap_sess is not None:
                session_tasks.append(
                    self._snapshot_client_session(snap_sess)
                )
                sessions = sessions + [snap_sess]
            results = await asyncio.gather(
                *session_tasks,
                return_exceptions=True,
            )
            total = 0
            partial = 0
            for r in results:
                if isinstance(r, tuple):
                    count, complete = r
                    total += count
                    if not complete:
                        partial += 1
                else:
                    partial += 1
            sp.set(sessions=len(sessions), changes=total)
            if partial:
                self.metrics.counter(
                    "corro_sync_partial_sessions_total", partial)
            if partial and _retry:
                # retryable partial round: needs the dead peer(s) never
                # served are still in bookkeeping — recompute and push
                # them to peers untouched this round (bounded: one pass)
                used = {tuple(m.addr) for m in members}
                spare = [
                    m for m in self.members.alive()
                    if m.state is MemberState.ALIVE
                    and tuple(m.addr) not in used
                    and not m.quarantined
                ]
                if spare:
                    self.metrics.counter(
                        "corro_sync_partial_retries_total")
                    retry_peers = self._rng.sample(
                        spare, min(partial, len(spare))
                    )
                    total += await self.parallel_sync(
                        retry_peers, None, _retry=False
                    )
            return total

    def _allocate_needs(
        self, sessions: List[dict], ours: SyncStateV1
    ) -> None:
        # cross-peer dedup with round-robin allocation: servers take
        # turns draining ≤10 needs from their own advertised queue while
        # a shared requested-set skips what another server already got —
        # so N servers holding the same data end up serving disjoint
        # slices of it (peer.rs:1240-1371)
        from collections import deque

        req_full: set = set()  # (actor_bytes, version)
        req_partial: Dict[tuple, RangeSet] = {}  # (actor, version) -> seqs
        queues: List = []
        for s in sessions:
            theirs = s["theirs"]
            needs = ours.compute_available_needs(theirs)
            if theirs.last_cleared_ts is not None:
                known = self.bookie.for_actor(
                    theirs.actor_id.bytes
                ).last_cleared_ts
                if known is None or int(known) < int(theirs.last_cleared_ts):
                    needs.setdefault(theirs.actor_id, []).append(
                        SyncNeedV1.empty(known)
                    )
            q = deque()
            # per-session need cap (Byzantine serve-path hardening,
            # docs/faults.md): the 10-version chunking loop over a
            # hostile server's lying head would otherwise allocate an
            # unbounded queue BEFORE a single request goes out.
            # Bounded work per session; what got cut is still in
            # bookkeeping for future rounds against honest peers
            capped = False
            cap = self.SYNC_CLIENT_NEED_CAP
            for actor, actor_needs in needs.items():
                for n in actor_needs:
                    if n.kind == "full":
                        lo, hi = n.versions
                        while lo <= hi:  # 10-version chunks (peer.rs:1285)
                            if len(q) >= cap:
                                capped = True
                                break
                            q.append(
                                (actor, SyncNeedV1.full(lo, min(lo + 9, hi)))
                            )
                            lo += 10
                    elif len(q) >= cap:
                        capped = True
                    else:
                        q.append((actor, n))
                    if capped:
                        break
                if capped:
                    break
            if capped:
                self._sync_client_reject("need_cap")
            queues.append(q)
            s["needs"] = {}
        while any(queues):
            for s, q in zip(sessions, queues):
                taken = 0
                while q and taken < 10:
                    actor, n = q.popleft()
                    ab = actor.bytes
                    out: List[SyncNeedV1] = []
                    if n.kind == "full":
                        span = RangeSet()
                        for v in range(n.versions[0], n.versions[1] + 1):
                            if (ab, v) not in req_full:
                                req_full.add((ab, v))
                                span.insert(v, v)
                        out.extend(
                            SyncNeedV1.full(a, b) for a, b in span.spans()
                        )
                    elif n.kind == "partial":
                        key = (ab, int(n.version))
                        got = req_partial.setdefault(key, RangeSet())
                        fresh = []
                        for s0, e0 in n.seqs:
                            for a, b in got.gaps(s0, e0):
                                fresh.append((a, b))
                                got.insert(a, b)
                        if fresh:
                            out.append(SyncNeedV1.partial(n.version, fresh))
                    else:
                        out.append(n)  # empty-need is per-server
                    if out:
                        s["needs"].setdefault(actor, []).extend(out)
                        taken += 1

    # -- Byzantine sync-serve client defenses (docs/faults.md) ---------

    def _screen_sync_state(self, theirs: SyncStateV1) -> Optional[str]:
        """Structural sanity screen on a sync SERVER's advertised
        state — the serve-path mirror of ``_screen_changeset``.
        Returns the reject reason or None.  A lying head past
        ``SYNC_MAX_ADVERTISED_HEAD`` (no real history allocates a
        version per nanosecond for millennia) or inverted need/seq
        spans (the wire decoder rejects these; the in-process virtual
        path hands the object straight over, so the screen must check
        too) mark a hostile server whose serves cannot be trusted."""
        for head in theirs.heads.values():
            if int(head) >= self.SYNC_MAX_ADVERTISED_HEAD:
                return "advertised_range"
        for spans in theirs.need.values():
            for s, e in spans:
                if s < 0 or e < s:
                    return "advertised_range"
        for partials in theirs.partial_need.values():
            for seq_spans in partials.values():
                for s, e in seq_spans:
                    if s < 0 or e < s:
                        return "advertised_range"
        return None

    def _sync_client_reject(self, reason: str, addr=None,
                            trip: bool = False,
                            strike: bool = False) -> None:
        """Count one client-side serve-path rejection
        (``corro_sync_client_rejects_total{reason=}``); ``trip``
        opens the peer's breaker — verified-garbage serves are
        hostile, not flaky — while ``strike`` records one ordinary
        breaker failure (ambiguous evidence like a session deadline:
        `threshold` of them before quarantine)."""
        self.metrics.counter(
            "corro_sync_client_rejects_total", reason=reason
        )
        if addr is not None:
            if trip:
                self._trip_breaker(tuple(addr))
            elif strike:
                self._strike_breaker(tuple(addr))

    async def _sync_handshake(self, m: Member) -> Optional[dict]:
        """Open a bi-stream, send SyncStart + Clock, read the server's
        State (+Clock); returns a session dict or None on reject."""
        try:
            # through the transport so connects share the timeout and feed
            # RTT samples into the member rings (ring0 classification)
            reader, writer = await self.transport.open_bi(tuple(m.addr))
        except (OSError, asyncio.TimeoutError):
            return None
        try:
            tp = tracing.current_traceparent()
            writer.write(
                speedy.frame(
                    speedy.encode_bi_payload(
                        BiPayload(
                            actor_id=ActorId(self.actor_id),
                            trace_ctx={"traceparent": tp} if tp else None,
                        ),
                        ClusterId(self.config.cluster_id),
                    )
                )
            )
            writer.write(
                speedy.frame(
                    speedy.encode_sync_message(self.clock.new_timestamp())
                )
            )
            await writer.drain()
            frames = speedy.FrameReader()
            backlog: List = []
            while True:
                data = await asyncio.wait_for(reader.read(65536), timeout=10.0)
                if not data:
                    writer.close()
                    return None
                batch = frames.feed(data)
                for i, payload in enumerate(batch):
                    msg = speedy.decode_sync_message(payload)
                    if isinstance(msg, tuple) and msg[0] == "rejection":
                        self.metrics.counter("corro_sync_rejected_total")
                        writer.close()
                        return None
                    if isinstance(msg, Timestamp):
                        try:
                            self.clock.update_with_timestamp(msg)
                        except Exception:
                            pass
                    elif isinstance(msg, SyncStateV1):
                        reason = self._screen_sync_state(msg)
                        if reason is not None:
                            # a structurally-lying advertised state is
                            # hostile: refuse the whole session before
                            # a single need is computed from it
                            self._sync_client_reject(
                                reason, tuple(m.addr), trip=True
                            )
                            writer.close()
                            return None
                        # frames decoded after State in the same read
                        # (routinely the server's Clock) carry over to
                        # the session instead of being dropped
                        backlog.extend(
                            speedy.decode_sync_message(p)
                            for p in batch[i + 1 :]
                        )
                        return {
                            "member": m,
                            "reader": reader,
                            "writer": writer,
                            "frames": frames,
                            "theirs": msg,
                            "backlog": backlog,
                        }
                    else:
                        backlog.append(msg)
        except (asyncio.TimeoutError, OSError, ConnectionError,
                speedy.SpeedyError):
            writer.close()
            return None

    @staticmethod
    def _request_batches(
        needs: Dict[ActorId, List[SyncNeedV1]],
        per_request: int = 10,
        full_chunk: int = 10,
    ):
        """Split a needs map into Request frames the way the reference's
        client drains them (peer.rs:1240-1371): Full ranges chunked into
        ≤``full_chunk``-version sub-ranges, ≤``per_request`` needs per
        Request message."""
        flat: List[Tuple[ActorId, SyncNeedV1]] = []
        for actor, actor_needs in needs.items():
            for n in actor_needs:
                if n.kind == "full":
                    s, e = n.versions
                    while s <= e:
                        hi = min(s + full_chunk - 1, e)
                        flat.append((actor, SyncNeedV1.full(s, hi)))
                        s = hi + 1
                else:
                    flat.append((actor, n))
        for i in range(0, len(flat), per_request):
            batch = flat[i : i + per_request]
            grouped: List[Tuple[ActorId, List[SyncNeedV1]]] = []
            for actor, n in batch:
                if grouped and grouped[-1][0] == actor:
                    grouped[-1][1].append(n)
                else:
                    grouped.append((actor, [n]))
            yield grouped

    async def _ingest_sync_change(self, cv: ChangeV1) -> None:
        if cv.changeset.is_empty_set:
            # EmptySet groups advance the cleared watermark per group,
            # so they must apply in served order and must never be
            # dropped — bypass the drop-oldest ingest queue (the
            # reference likewise gives emptysets their own ordered
            # channel, handlers.rs:539-734)
            # route through _apply_batch so the in-flight gauge and
            # batch-size histogram see sync emptyset work too
            await self._loop.run_in_executor(
                self._apply_pool, self._apply_batch,
                [(cv, ChangeSource.SYNC)],
            )
        else:
            self.enqueue_change(cv, ChangeSource.SYNC)

    # -- per-session sync observability --------------------------------
    #
    # Round-level timers and session-count gauges existed before; these
    # add the per-SESSION layer: a live-session registry behind admin
    # `sync_sessions` (peer, age, needs-remaining), one
    # corro_sync_session_seconds{role=} sample per session, and the
    # session's byte volume counted by role/direction.

    def _sync_session_begin(self, role: str, peer: str,
                            needs_total: int) -> dict:
        self._sync_sess_seq += 1
        live = {
            "id": self._sync_sess_seq, "role": role, "peer": peer,
            "started": self._clock.monotonic(),
            "needs_total": needs_total,
            "needs_done": 0, "changes": 0, "bytes": 0,
        }
        self._sync_live[live["id"]] = live
        return live

    def _sync_session_end(self, live: dict, role: str,
                          direction: str) -> None:
        self._sync_live.pop(live["id"], None)
        self.metrics.histogram(
            "corro_sync_session_seconds",
            self._clock.monotonic() - live["started"], role=role,
        )
        if live["bytes"]:
            self.metrics.counter(
                "corro_sync_session_bytes_total", live["bytes"],
                role=role, dir=direction,
            )

    def sync_sessions(self) -> List[dict]:
        """Live sync sessions, both roles (admin ``sync_sessions``).

        Per-need completion is a SERVER-side notion (the server runs
        one job per need; the client just reads the stream until the
        server half-closes), so ``needs_done``/``needs_remaining`` are
        null for client sessions — their progress signal is
        ``changes`` (changesets ingested so far), which must keep
        moving for a healthy backfill."""
        now = self._clock.monotonic()
        out = []
        for e in list(self._sync_live.values()):
            client = e["role"] == "client"
            out.append({
                "id": e["id"], "role": e["role"], "peer": e["peer"],
                "age_s": round(now - e["started"], 3),
                "needs_total": e["needs_total"],
                "needs_done": None if client else e["needs_done"],
                "needs_remaining": None if client else max(
                    0, e["needs_total"] - e["needs_done"]
                ),
                "changes": e["changes"],
                "bytes": e["bytes"],
            })
        return out

    async def _sync_session(self, s: dict) -> Tuple[int, bool]:
        """Send this session's allocated requests, then ingest served
        changesets until the server closes its side.

        Returns ``(changes_ingested, complete)``: a mid-stream peer
        failure keeps everything already ingested (bookkeeping is
        idempotent and incremental) and reports ``complete=False`` so
        the round can retry the remainder elsewhere — a partial round,
        not an aborted one."""
        m, reader, writer = s["member"], s["reader"], s["writer"]
        frames = s["frames"]
        count = 0
        needs_total = sum(len(v) for v in s["needs"].values())
        live = self._sync_session_begin(
            "client", m.actor_id.hex(), needs_total
        )
        self._flight_event(
            "sync_client_start", peer=m.actor_id.hex(), needs=needs_total
        )
        complete = False
        try:
            for msg in s["backlog"]:
                if isinstance(msg, ChangeV1):
                    await self._ingest_sync_change(msg)
                    count += 1
                    live["changes"] = count
                elif isinstance(msg, Timestamp):
                    try:
                        self.clock.update_with_timestamp(msg)
                    except Exception:
                        pass
            for batch in self._request_batches(s["needs"]):
                writer.write(
                    speedy.frame(speedy.encode_sync_message(("request", batch)))
                )
            await writer.drain()
            # half-close: no more requests; the server serves then
            # closes (EOF-terminated like the reference)
            if writer.can_write_eof():
                writer.write_eof()
            # Byzantine serve-path hardening (docs/faults.md): a
            # whole-session deadline on the injected clock (each read
            # has a 10 s timeout, so a slow-trickle server feeding one
            # byte per window would otherwise hold the session — and
            # its allocated needs — hostage forever), plus a budget of
            # undecodable frames before the serve is judged hostile
            # and the peer's breaker trips
            deadline = None
            if self.config.sync_session_deadline_s > 0:
                deadline = (self._clock.monotonic()
                            + self.config.sync_session_deadline_s)
            frame_errs = 0
            aborted = False
            while True:
                read_timeout = 10.0
                if deadline is not None:
                    remaining = deadline - self._clock.monotonic()
                    if remaining <= 0:
                        # one STRIKE, not a hard trip: a blown session
                        # deadline could be honest slowness, but enough
                        # of them must stop the peer being re-selected
                        # every round (the slow-trickle containment the
                        # vcluster campaign seam already models)
                        self._sync_client_reject(
                            "deadline", tuple(m.addr), strike=True
                        )
                        aborted = True
                        break
                    read_timeout = min(read_timeout, remaining)
                data = await asyncio.wait_for(
                    reader.read(65536), timeout=read_timeout
                )
                if not data:
                    break  # server closed: session complete
                live["bytes"] += len(data)
                try:
                    payloads = frames.feed(data)
                except speedy.SpeedyError:
                    # oversized/corrupt framing: unrecoverable stream
                    self._sync_client_reject(
                        "frame_garbage", tuple(m.addr), trip=True
                    )
                    aborted = True
                    break
                for payload in payloads:
                    try:
                        msg = speedy.decode_sync_message(payload)
                    except speedy.SpeedyError:
                        frame_errs += 1
                        self._sync_client_reject("frame_garbage")
                        if frame_errs > self.SYNC_CLIENT_FRAME_BUDGET:
                            self._trip_breaker(tuple(m.addr))
                            aborted = True
                            break
                        continue
                    if isinstance(msg, Timestamp):
                        try:
                            self.clock.update_with_timestamp(msg)
                        except Exception:
                            pass
                    elif isinstance(msg, ChangeV1):
                        await self._ingest_sync_change(msg)
                        count += 1
                        live["changes"] = count
                if aborted:
                    break
            if aborted:
                return count, False
            self.members.update_sync_ts(m.actor_id, self._clock.wall())
            self.metrics.counter("corro_sync_client_rounds_total")
            complete = True
            # per-change accounting happens at enqueue_change
            return count, True
        except (asyncio.TimeoutError, OSError, ConnectionError,
                speedy.SpeedyError):
            return count, False
        finally:
            writer.close()
            self._sync_session_end(live, "client", "received")
            self._flight_event(
                "sync_client_end", peer=m.actor_id.hex(),
                changes=count, bytes=live["bytes"], complete=complete,
            )

    async def _serve_tcp(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        """Dispatch an inbound TCP connection by its one-byte stream
        prelude (the TCP analogue of QUIC accept_uni/accept_bi); all
        bytes after it are LengthDelimited speedy frames — the
        reference's exact stream content."""
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            try:
                prelude = await asyncio.wait_for(
                    reader.readexactly(1), timeout=10.0
                )
            except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                    OSError, ConnectionError):
                writer.close()
                return
            if prelude == STREAM_UNI:
                await self._serve_uni(reader, writer)
            elif prelude == STREAM_BI:
                await self._serve_sync(reader, writer)
            elif prelude == STREAM_MUX:
                from corrosion_tpu_torch.agent.mux import serve_mux

                await serve_mux(self, reader, writer)
            else:
                writer.close()
        except asyncio.CancelledError:
            writer.close()
            raise
        finally:
            self._conn_tasks.discard(task)

    # UniPayload::V1 / Broadcast / Change variant tags: three zero u32s.
    # decode_uni_payload accepts nothing else, so frames failing this
    # cheap prelude check can be rejected before consuming a bounded
    # ingest-queue slot (a junk burst must not evict real changesets).
    _UNI_PRELUDE = b"\x00" * 12

    def enqueue_uni_payload(self, payload: bytes, peer=None) -> None:
        """Queue one RAW uni-stream payload for off-loop decoding: the
        event loop only deframes (+ a 12-byte tag sanity check); speedy
        decode happens in the apply worker pool (``_apply_batch``), so a
        burst of inbound gossip never blocks the loop on
        deserialization.  Same bounded drop-oldest policy as
        ``enqueue_change``.  The traced/signed envelope, if present, is
        walked (fixed-offset arithmetic only — no string or change
        decode) so the prelude screen applies to every wire format.
        ``peer`` is the delivering transport's address, carried through
        to the worker so a failed origin signature can blame the
        delivery (docs/faults.md, signed attribution)."""
        off = 1 if self.config.debug_hops else 0
        try:
            start = speedy.traced_uni_payload_start(payload, off)
        except speedy.SpeedyError:
            self.metrics.counter("corro_wire_decode_errors_total")
            return
        if payload[start : start + 12] != self._UNI_PRELUDE:
            self.metrics.counter("corro_wire_decode_errors_total")
            return
        self._enqueue_ingest((payload, peer), None)

    def _ingest_uni_payloads(self, payloads, peer=None) -> None:
        """Deframed uni payloads → ingest queue (shared by the
        dedicated uni stream server and the mux demux)."""
        for payload in payloads:
            self.enqueue_uni_payload(payload, peer)

    async def _serve_uni(self, reader, writer) -> None:
        """Long-lived inbound broadcast stream: speedy UniPayload frames
        (broadcast.rs:37-55) → ingest queue."""
        frames = speedy.FrameReader()
        ingest = self._ingest_uni_payloads
        peer = writer.get_extra_info("peername")
        if peer is not None:
            peer = tuple(peer[:2])

        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    return
                ingest(frames.feed(data), peer)
        except (OSError, ConnectionError, speedy.SpeedyError):
            return
        finally:
            writer.close()

    async def _send_sync_msg(self, writer, msg) -> None:
        writer.write(speedy.frame(speedy.encode_sync_message(msg)))
        await writer.drain()

    # sync serving knobs (peer.rs:344-348)
    SYNC_CHUNK_MAX = 8 * 1024
    SYNC_CHUNK_MIN = 1024
    SYNC_ADAPT_THRESHOLD = 0.5  # halve the chunk beyond this send time
    SYNC_SLOW_ABORT = 5.0  # abort the session beyond this send time
    SYNC_NEED_JOBS = 6  # concurrent need jobs per session (peer.rs:843)
    SYNC_MAX_PARTIAL_SPANS = 1024  # clamp hostile partial seqs lists
    SYNC_MAX_SESSION_NEEDS = 10_000  # total needs one session may request
    # -- Byzantine sync-SERVE client hardening (docs/faults.md) --------
    # the server-side caps above bound what a hostile CLIENT can cost a
    # server; these bound what a hostile SERVER can cost a client:
    # a head no real history could reach (one version per committed
    # local transaction — a claim past 2^48 is a structural lie, and
    # naively chunking it into 10-version requests would allocate
    # ~10^13 needs)
    SYNC_MAX_ADVERTISED_HEAD = 1 << 48
    # max needs the client allocates toward ONE server session
    SYNC_CLIENT_NEED_CAP = 10_000
    # undecodable frames tolerated per session before the serve is
    # definitively garbage and the peer's breaker trips
    SYNC_CLIENT_FRAME_BUDGET = 3
    # batched serve pipeline (docs/sync.md): versions resolved/collected
    # per storage-lock window, and the byte budget one coalesced write
    # accumulates before draining when the session carries no adaptive
    # chunk budget (live sessions drain per sess["chunk"] so slow-reader
    # adaptation keeps seeing real backpressure)
    SYNC_RESOLVE_CHUNK = 256
    SYNC_DRAIN_BUDGET = 64 * 1024

    async def _serve_sync(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """Sync server (serve_sync, peer.rs:1469): read the SyncStart
        BiPayload, reject if over capacity or cross-cluster, send our
        State + Clock, then serve Request needs until the client
        half-closes; closing our side ends the session."""
        if self._sync_sem.locked():
            # rejections were silent: count them by reason so capacity
            # pressure is visible next to the accept/serve series
            self.metrics.counter(
                "corro_sync_rejections_sent_total", reason="capacity")
            await self._send_sync_msg(
                writer, ("rejection", speedy.REJECTION_MAX_CONCURRENCY)
            )
            writer.close()
            return
        async with self._sync_sem:
            self._sync_server_sessions += 1
            jobs: set = set()
            job_sem = asyncio.Semaphore(self.SYNC_NEED_JOBS)
            sess = {"chunk": self.SYNC_CHUNK_MAX}
            total_needs = 0
            srv_span = None  # opened once the SyncStart is decoded
            live = None  # session registry entry, once the peer is known

            async def run_need(actor_b: bytes, need: SyncNeedV1) -> None:
                async with job_sem:
                    await self._serve_need(writer, actor_b, need, sess)
                    if live is not None:
                        live["needs_done"] += 1

            async def run_snapshot() -> None:
                async with job_sem:
                    await self._serve_snapshot(writer, sess)
                    if live is not None:
                        live["needs_done"] += 1

            try:
                frames = speedy.FrameReader()
                payloads: List[bytes] = []
                while not payloads:
                    data = await asyncio.wait_for(
                        reader.read(65536), timeout=10.0
                    )
                    if not data:
                        return
                    payloads = frames.feed(data)
                _bi, cluster = speedy.decode_bi_payload(payloads[0])
                peer_hex = _bi.actor_id.bytes.hex()
                live = self._sync_session_begin("server", peer_hex, 0)
                sess["live"] = live
                self._flight_event("sync_server_start", peer=peer_hex)
                # re-parent on the client's traceparent so both ends of
                # the round log the same trace id (sync.rs:32-67)
                srv_span = tracing.span(
                    "sync.server",
                    remote=(_bi.trace_ctx or {}).get("traceparent"),
                )
                srv_span.__enter__()
                self.metrics.counter("corro_trace_spans_total")
                if int(cluster) != self.config.cluster_id:
                    self.metrics.counter(
                        "corro_sync_rejections_sent_total",
                        reason="cluster",
                    )
                    await self._send_sync_msg(
                        writer,
                        ("rejection", speedy.REJECTION_DIFFERENT_CLUSTER),
                    )
                    return
                await self._send_sync_msg(writer, self.generate_sync())
                await self._send_sync_msg(writer, self.clock.new_timestamp())
                queued = payloads[1:]
                eof = False
                while not eof:
                    if queued:
                        msgs, queued = queued, []
                    else:
                        try:
                            data = await asyncio.wait_for(
                                reader.read(65536), timeout=10.0
                            )
                        except asyncio.TimeoutError:
                            # a stalled client that never half-closes
                            # still gets its jobs reaped below (their
                            # drains hit the slow-peer abort budget)
                            break
                        if not data:
                            eof = True  # client half-closed: no more needs
                            msgs = []
                        else:
                            msgs = frames.feed(data)
                    for payload in msgs:
                        msg = speedy.decode_sync_message(payload)
                        if isinstance(msg, Timestamp):
                            try:
                                self.clock.update_with_timestamp(msg)
                            except Exception:
                                pass
                        elif isinstance(msg, tuple) \
                                and msg[0] == "snap_request":
                            # snapshot serve (docs/sync.md): one job
                            # through the same semaphore/abort budgets
                            # as changeset needs.  With serving off the
                            # request is ignored — the client times out
                            # of the session and falls back
                            if not self.config.snapshot_serve:
                                continue
                            total_needs += 1
                            t = asyncio.ensure_future(
                                run_snapshot()
                            )
                            jobs.add(t)
                            if live is not None:
                                live["needs_total"] = total_needs
                        elif isinstance(msg, tuple) and msg[0] == "request":
                            # needs run as concurrent jobs, up to
                            # SYNC_NEED_JOBS at once (peer.rs:836-844);
                            # frame writes are atomic per message, so
                            # interleaved jobs cannot corrupt the stream
                            for actor, needs in msg[1]:
                                for need in needs:
                                    total_needs += 1
                                    if (total_needs
                                            > self.SYNC_MAX_SESSION_NEEDS):
                                        # hostile request stream: stop
                                        # accepting, serve what's queued
                                        eof = True
                                        break
                                    t = asyncio.ensure_future(
                                        run_need(actor.bytes, need)
                                    )
                                    jobs.add(t)
                                if eof:
                                    break
                            if live is not None:
                                live["needs_total"] = total_needs
                # requests done (EOF or stall): wait for serving to end
                if jobs:
                    results = await asyncio.gather(
                        *jobs, return_exceptions=True
                    )
                    jobs.clear()
                    errors = [r for r in results if isinstance(r, Exception)]
                    if errors:
                        if any(isinstance(r, _SlowPeer) for r in errors):
                            self.metrics.counter(
                                "corro_sync_slow_peer_aborts_total"
                            )
                        else:
                            self.metrics.counter(
                                "corro_sync_serve_errors_total"
                            )
                        # a failed serve must NOT end as a clean EOF the
                        # client mistakes for a complete session — and
                        # close() would wait on a reader that may not be
                        # reading; reset the stream instead
                        writer.transport.abort()
            except (asyncio.TimeoutError, OSError, ConnectionError,
                    speedy.SpeedyError) as e:
                # swallowed for the protocol, but the span must not
                # read as a clean session
                if srv_span is not None:
                    srv_span.span.set(error=repr(e))
                return
            finally:
                self._sync_server_sessions -= 1
                if srv_span is not None:
                    srv_span.span.set(needs=total_needs)
                    srv_span.__exit__(None, None, None)
                if live is not None:
                    self._sync_session_end(live, "server", "served")
                    self._flight_event(
                        "sync_server_end", peer=live["peer"],
                        needs=total_needs, bytes=live["bytes"],
                    )
                for t in jobs:
                    t.cancel()
                writer.close()

    async def _serve_need(self, writer: asyncio.StreamWriter, actor: bytes,
                          need: SyncNeedV1,
                          sess: Optional[dict] = None) -> None:
        bv = self.bookie.for_actor(actor)
        kind = need.kind
        self.metrics.counter(
            "corro_sync_needs_served_total",
            kind=kind if kind in ("full", "partial", "empty") else "other",
        )
        if kind == "full":
            s, e = need.versions
            # clamp hostile/stale ranges to what we can possibly serve
            s, e = max(1, int(s)), min(int(e), bv.last())
            if self.config.sync_batched_serve:
                await self._serve_full_range_batched(
                    writer, actor, bv, s, e, sess
                )
                return
            # per-version parity oracle: newest first (peer.rs serve
            # order) — under a chunk budget or a slow-peer abort the
            # requester keeps the freshest data.  A version served as a
            # cleared span jumps the cursor BELOW the whole span — no
            # per-version spin over large ranges
            v, i = e, 0
            while v >= s:
                span = await self._serve_version(
                    writer, actor, bv, v, sess=sess
                )
                v = (span[0] - 1) if span is not None else (v - 1)
                i += 1
                if i % 64 == 63:
                    await asyncio.sleep(0)  # don't starve the event loop
        elif kind == "partial":
            v = int(need.version)
            await self._serve_version(
                writer, actor, bv, v,
                # span-count clamp: a hostile seqs list cannot force an
                # unbounded number of per-span re-scans
                seq_spans=[
                    tuple(sp)
                    for sp in need.seqs[: self.SYNC_MAX_PARTIAL_SPANS]
                ],
                sess=sess,
            )
        elif kind == "empty":
            # only cleared ranges strictly NEWER than the requester's
            # last-seen ts, one EmptySet per distinct stamping ts oldest
            # first (peer.rs:715-762): each message is a complete per-ts
            # group, so the requester can advance its watermark per
            # message without ever missing a sibling range
            if bv.last_cleared_ts is None:
                return
            since = int(need.ts) if need.ts is not None else None
            for group_ts, spans in self.bookie.cleared_since(actor, since):
                cs = Changeset.empty_set(spans, Timestamp(group_ts))
                await self._send_sync_change(writer, actor, cs)

    async def _serve_version(
        self, writer, actor: bytes, bv, v: int,
        seq_spans: Optional[List[Tuple[int, int]]] = None,
        sess: Optional[dict] = None,
    ) -> Optional[Tuple[int, int]]:
        """Serve one version; returns the enclosing (lo, hi) span when
        it went out as a cleared/empty changeset (so a full-range serve
        can skip the rest of the span), else None."""
        if bv.cleared.contains(v):
            lo, hi = v, v
            for s, e in bv.cleared:
                if s <= v <= e:
                    lo, hi = s, e
                    break
            cs = Changeset.empty((Version(lo), Version(hi)), bv.last_cleared_ts)
            await self._send_sync_change(writer, actor, cs, sess)
            return (lo, hi)
        entry = bv.versions.get(v)
        if entry is None:
            # we may still hold part of it: serve the buffered seqs we have
            # (two partial peers with complementary chunks can complete each
            # other even after the origin dies)
            partial = bv.partials.get(v)
            if partial is None:
                return
            have = partial.seqs.spans()
            if seq_spans is not None:
                have = [
                    clipped
                    for s, e in seq_spans
                    for clipped in partial.seqs.intersection_spans(s, e)
                ]
            buffered = {
                seq: wire.decode_buffered_change(blob)
                for seq, blob in self.bookie.buffered_changes(actor, v)
            }
            for s, e in have:
                chunk = [buffered[q] for q in range(s, e + 1) if q in buffered]
                cs = Changeset.full(
                    Version(v), chunk, (s, e), partial.last_seq,
                    partial.ts or Timestamp(0),
                )
                await self._send_sync_change(writer, actor, cs, sess)
            return
        db_version, last_seq = entry
        site = None if actor == self.actor_id else actor
        changes = self.storage.collect_changes((db_version, db_version), site)
        # Full changesets carry a non-optional ts on the wire
        # (broadcast.rs:118): re-serve with the ts recorded at apply time
        row_ts = self.bookie.version_ts(actor, v)
        ts = Timestamp(row_ts) if row_ts is not None else Timestamp(0)
        if not changes:
            # the version HAD rows (versions are only allocated for
            # non-empty transactions); all gone means newer versions
            # overwrote them — read-time cleared detection: serve an
            # EmptySet so the requester records a cleared range, not a
            # hollow full version (peer.rs:350-762 behavior, pinned by
            # its test_handle_need)
            cs = Changeset.empty((Version(v), Version(v)), ts)
            await self._send_sync_change(writer, actor, cs, sess)
            return (v, v)
        if seq_spans is not None:
            changes = [
                c
                for c in changes
                if any(s <= int(c.seq) <= e for s, e in seq_spans)
            ]
            for s, e in seq_spans:
                span_changes = [c for c in changes if s <= int(c.seq) <= e]
                cs = Changeset.full(
                    Version(v), span_changes, (s, e), last_seq,
                    (bv.partials[v].ts or ts) if v in bv.partials else ts,
                )
                await self._send_sync_change(writer, actor, cs, sess)
            return
        chunker = ChunkedChanges(
            changes, 0, last_seq,
            max_buf_size=sess["chunk"] if sess else MAX_CHANGES_BYTE_SIZE,
        )
        for chunk, seqs in chunker:
            cs = Changeset.full(Version(v), chunk, seqs, last_seq, ts)
            await self._send_sync_change(writer, actor, cs, sess)

    # -- batched serve pipeline (docs/sync.md) -------------------------
    #
    # The serve mirror of the batched apply pipeline: a full-range need
    # is resolved version->db_version in ONE in-memory bookkeeping pass
    # per SYNC_RESOLVE_CHUNK versions (a short storage-lock hold), the
    # whole span is collected with one sentinel + one cell query per
    # table on a read-only pool connection OFF the event loop, split by
    # db_version in memory, encoded to frames in the worker, and sent
    # as coalesced buffered writes with one drain per SYNC_DRAIN_BUDGET
    # bytes.  collect(chunk N+1) overlaps encode/send(chunk N).  Served
    # bytes are pinned identical to the per-version oracle
    # (_serve_version) by tests/test_serve_batched.py.

    def _serve_executor(self):
        pool = self._serve_pool
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = self._serve_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="corro-serve",
            )
        return pool

    async def _serve_full_range_batched(
        self, writer, actor: bytes, bv, s: int, e: int,
        sess: Optional[dict] = None,
    ) -> None:
        """Serve a full version range [s, e] newest-first through the
        batched pipeline; bytes identical to the per-version oracle."""
        if e < s:
            return
        loop = asyncio.get_running_loop()
        pool = self._serve_executor()
        fut = loop.run_in_executor(
            pool, self._collect_serve_chunk, actor, bv, s, e,
            sess["chunk"] if sess else MAX_CHANGES_BYTE_SIZE,
        )
        try:
            while fut is not None:
                frames, cursor = await fut
                if cursor >= s:
                    # prefetch: collect the next chunk while this sends
                    fut = loop.run_in_executor(
                        pool, self._collect_serve_chunk, actor, bv, s,
                        cursor,
                        sess["chunk"] if sess else MAX_CHANGES_BYTE_SIZE,
                    )
                else:
                    fut = None
                await self._send_sync_frames(writer, frames, sess)
        except BaseException:
            if fut is not None:
                # a send abort (e.g. _SlowPeer) abandons the in-flight
                # prefetch: consume its outcome so a collection error
                # can't surface as an unretrieved-exception log
                fut.add_done_callback(
                    lambda f: f.cancelled() or f.exception()
                )
            raise

    def _collect_serve_chunk(
        self, actor: bytes, bv, lo: int, hi: int, max_buf: int,
    ) -> Tuple[List[bytes], int]:
        """Worker-thread body: resolve + collect + encode one chunk of a
        full-range need, newest first from ``hi`` down to (at most)
        ``lo``.  Returns (encoded frames in serve order, next cursor —
        the version the per-version oracle would continue at)."""
        chunk_lo = max(lo, hi - self.SYNC_RESOLVE_CHUNK + 1)
        # phase A — bookkeeping resolution under the storage lock: pure
        # in-memory walk mirroring the oracle's per-version decisions
        plan: List[tuple] = []
        with self.storage._lock:
            last_cleared_ts = bv.last_cleared_ts
            v = hi
            while v >= chunk_lo:
                if bv.cleared.contains(v):
                    span_lo, span_hi = v, v
                    for cs_s, cs_e in bv.cleared.overlapping(v, v):
                        span_lo, span_hi = cs_s, cs_e
                    plan.append(("cleared", span_lo, span_hi))
                    v = span_lo - 1
                    continue
                entry = bv.versions.get(v)
                if entry is not None:
                    plan.append(("version", v, entry[0], entry[1]))
                else:
                    partial = bv.partials.get(v)
                    if partial is not None:
                        plan.append((
                            "partial", v, partial.seqs.spans(),
                            partial.last_seq, partial.ts,
                        ))
                v -= 1
            next_cursor = v
        # phase B — DB reads on a read-only pool connection, NO storage
        # lock: one range collection + one batched ts lookup + buffered
        # reads, all inside one read transaction (one WAL snapshot)
        version_items = [it for it in plan if it[0] == "version"]
        site = None if actor == self.actor_id else actor
        by_dbv: Dict[int, List] = {}
        ts_by_v: Dict[int, int] = {}
        buffered_by_v: Dict[int, dict] = {}
        with self.storage.reader() as conn:
            conn.execute("BEGIN")
            try:
                if version_items:
                    dbvs = [it[2] for it in version_items]
                    for ch in self.storage.collect_changes_ro(
                        conn, (min(dbvs), max(dbvs)), site
                    ):
                        by_dbv.setdefault(int(ch.db_version), []).append(ch)
                    ts_by_v = self.bookie.version_ts_many(
                        actor, [it[1] for it in version_items], conn=conn
                    )
                for it in plan:
                    if it[0] == "partial":
                        buffered_by_v[it[1]] = {
                            seq: wire.decode_buffered_change(blob)
                            for seq, blob in self.bookie.buffered_changes(
                                actor, it[1], conn=conn
                            )
                        }
            finally:
                if conn.in_transaction:
                    conn.execute("COMMIT")
        # phase C — encode frames in serve order (still in the worker,
        # so the event loop never pays for speedy encoding)
        frames: List[bytes] = []
        for it in plan:
            if it[0] == "cleared":
                cs = Changeset.empty(
                    (Version(it[1]), Version(it[2])), last_cleared_ts
                )
                frames.append(self.encode_sync_change_frame(actor, cs))
            elif it[0] == "version":
                v, dbv, last_seq = it[1], it[2], it[3]
                row_ts = ts_by_v.get(v)
                ts = Timestamp(row_ts) if row_ts is not None else Timestamp(0)
                changes = by_dbv.get(dbv)
                if not changes:
                    # read-time cleared detection (oracle parity): the
                    # version's rows were all overwritten since
                    cs = Changeset.empty((Version(v), Version(v)), ts)
                    frames.append(self.encode_sync_change_frame(actor, cs))
                    continue
                chunker = ChunkedChanges(
                    changes, 0, last_seq, max_buf_size=max_buf
                )
                for chunk, seqs in chunker:
                    cs = Changeset.full(
                        Version(v), chunk, seqs, last_seq, ts
                    )
                    frames.append(self.encode_sync_change_frame(actor, cs))
            else:
                v, have, last_seq, pts = it[1], it[2], it[3], it[4]
                buffered = buffered_by_v.get(v, {})
                for hs, he in have:
                    chunk = [
                        buffered[q]
                        for q in range(hs, he + 1)
                        if q in buffered
                    ]
                    cs = Changeset.full(
                        Version(v), chunk, (hs, he), last_seq,
                        pts or Timestamp(0),
                    )
                    frames.append(self.encode_sync_change_frame(actor, cs))
        return frames, next_cursor

    def encode_sync_change_frame(self, actor: bytes, cs: Changeset) -> bytes:
        """One served changeset → its exact on-wire frame bytes (speedy
        SyncMessage + u32-BE framing).  Shared by the per-version oracle
        and the batched pipeline so both emit identical bytes."""
        cv = ChangeV1(actor_id=ActorId(actor), changeset=cs)
        return speedy.frame(speedy.encode_sync_message(cv))

    async def _send_sync_frames(self, writer, frames: List[bytes],
                                sess: Optional[dict] = None) -> None:
        """Coalesced framing: buffer whole encoded changeset frames into
        one write with a single drain per chunk budget, instead of a
        write+drain round per changeset.  The budget is the session's
        ADAPTIVE chunk size (re-read after every drain): blocks stay
        small enough that a slow reader still backpressures individual
        drains past the adapt threshold — a block far above the
        transport's high-water mark would hide the stall from the
        timing-based halving/abort logic entirely."""
        buf: List[bytes] = []
        size = 0
        for f in frames:
            buf.append(f)
            size += len(f)
            self.metrics.counter("corro_sync_served_total")
            if size >= (sess["chunk"] if sess else self.SYNC_DRAIN_BUDGET):
                await self._drain_sync_block(writer, b"".join(buf), sess)
                buf, size = [], 0
        if buf:
            await self._drain_sync_block(writer, b"".join(buf), sess)

    async def _send_sync_change(self, writer, actor: bytes, cs: Changeset,
                                sess: Optional[dict] = None) -> None:
        """Send one changeset frame (the per-version oracle's framing:
        one write + one timed drain per changeset)."""
        self.metrics.counter("corro_sync_served_total")
        await self._drain_sync_block(
            writer, self.encode_sync_change_frame(actor, cs), sess
        )

    async def _drain_sync_block(self, writer, blob: bytes,
                                sess: Optional[dict] = None) -> None:
        """Write one buffered block and drain, timing the flush: a slow
        reader first halves the session's chunk budget (8 KiB floor
        1 KiB), then aborts the session outright
        (peer.rs:344-348,796-811)."""
        writer.write(blob)
        if sess is not None and "live" in sess:
            # per-session served-byte accounting: every serve path
            # (oracle and batched) funnels its writes through here
            sess["live"]["bytes"] += len(blob)
        t0 = self._clock.monotonic()
        try:
            await asyncio.wait_for(
                writer.drain(), timeout=self.SYNC_SLOW_ABORT
            )
        except asyncio.TimeoutError:
            raise _SlowPeer("peer too slow: send exceeded abort budget")
        if sess is not None:
            elapsed = self._clock.monotonic() - t0
            if elapsed > self.SYNC_ADAPT_THRESHOLD:
                if sess["chunk"] <= self.SYNC_CHUNK_MIN:
                    raise _SlowPeer(
                        "peer too slow even at the minimum chunk size"
                    )
                sess["chunk"] //= 2
                self.metrics.counter("corro_sync_chunk_halvings_total")

    # -- snapshot bootstrap (docs/sync.md, agent/snapshot.py) ----------
    #
    # The serve half answers a snap_request session with a consistent,
    # scrubbed VACUUM-INTO copy streamed as snap_chunk frames over the
    # coalesced sync framing (the adaptive drain/slow-peer budgets
    # apply to snapshot blocks exactly as to changeset blocks); the
    # client half stages the stream into a sidecar, verifies the
    # whole-snapshot digest, and atomically swaps it in under the
    # storage lock behind a journal marker so a crash at ANY point
    # boots into a clean retry (snapshot.recover_pending_install).
    # Dispatch is the pure function pair snapshot.covered_below_floor
    # / snapshot.client_behind over (client needs, server floors).

    def _snapshot_wanted(self, ours: SyncStateV1,
                         theirs: SyncStateV1) -> bool:
        """Should this client request a snapshot from this server
        instead of change-by-change needs?  True exactly when the
        server advertises snapshot floors covering at least one needed
        version (it compacted that history — changes can no longer
        deliver it) and the client is strictly behind the server on
        every actor it tracks (the install-safety gate)."""
        from corrosion_tpu_torch.agent import snapshot as snaplib

        if not self.config.snapshot_install:
            return False
        floors = theirs.snap_floors
        if not floors:
            return False
        if not snaplib.client_behind(ours.heads, theirs.heads):
            return False
        needs = ours.compute_available_needs(theirs)
        return snaplib.covered_below_floor(needs, floors) >= 1

    def _pick_snapshot_session(self, sessions: List[dict],
                               ours: SyncStateV1):
        """Snapshot-or-changes dispatch over one round's handshaken
        sessions: at most ONE session installs — the first whose
        server can no longer serve the client's below-floor needs as
        changes.  Returns ``(snap_session_or_None, remaining)``.
        Shared with the virtual cluster's sync round so the campaign
        exercises the REAL selection policy."""
        if self.config.snapshot_install:
            for s in sessions:
                if self._snapshot_wanted(ours, s["theirs"]):
                    return s, [x for x in sessions if x is not s]
        return None, sessions

    def _snapshot_build(self) -> Tuple[str, bytes, int]:
        """Build (or reuse) the serve-side snapshot file; returns
        ``(path, digest, size)``.  Worker-thread body — one VACUUM at
        a time, and a restart storm's reborn clients share the cached
        file for ``snapshot_cache_s`` instead of re-vacuuming per
        serve."""
        with self._snap_build_lock:
            return self._snapshot_build_locked()

    def _snapshot_build_locked(self) -> Tuple[str, bytes, int]:
        from corrosion_tpu_torch.agent import snapshot as snaplib

        now = self._clock.monotonic()
        cached = self._snap_cache
        if (
            cached is not None
            and now - cached[0] <= self.config.snapshot_cache_s
            and os.path.exists(cached[1])
        ):
            return cached[1], cached[2], cached[3]
        cache = self.config.db_path + ".snap-serve"
        tmp = cache + ".tmp"
        if os.path.exists(tmp):
            os.unlink(tmp)
        # write-behind barrier: the snapshot must carry every winner
        # whose apply was already announced, not just the flushed ones
        self.storage.flush_barrier()
        snaplib.build_snapshot(self.config.db_path, tmp)
        os.replace(tmp, cache)
        digest = snaplib.file_digest(cache)
        size = os.path.getsize(cache)
        self._snap_cache = (now, cache, digest, size)
        self.metrics.counter("corro_snapshot_builds_total")
        return cache, digest, size

    def _snapshot_build_open(self):
        """``(open file, digest, size)`` with the handle opened UNDER
        the build lock: a slow serve that out-lives ``snapshot_cache_s``
        must keep streaming the inode its offer advertised — a
        concurrent rebuild ``os.replace``s the cache path, and bytes
        from the NEW inode would fail the client's digest gate and
        breaker-trip an honest server."""
        with self._snap_build_lock:
            path, digest, size = self._snapshot_build_locked()
            return open(path, "rb"), digest, size

    def _snapshot_serve_record(self, peer, size: int) -> None:
        """Serve-side accounting, shared by the live stream path and
        the virtual cluster's in-memory seam."""
        self.metrics.counter("corro_snapshot_serves_total")
        self.metrics.counter(
            "corro_snapshot_bytes_total", size, dir="served"
        )
        self._flight_event("snap_serve", peer=peer, bytes=size)

    async def _serve_snapshot(self, writer, sess: dict) -> None:
        """Serve one snapshot session: offer (digest + size), chunked
        file stream, done — every block through ``_drain_sync_block``
        so the slow-reader halving/abort budgets bound a stalled
        client exactly as on a changeset serve."""
        loop = asyncio.get_running_loop()
        pool = self._serve_executor()
        # the handle opens under the build lock (POSIX: os.replace of
        # the cache path cannot retarget an open fd), so the streamed
        # bytes always hash to the digest this offer advertises
        f, digest, size = await loop.run_in_executor(
            pool, self._snapshot_build_open
        )
        try:
            await self._drain_sync_block(
                writer,
                speedy.frame(
                    speedy.encode_sync_message(
                        ("snap_offer", digest, size)
                    )
                ),
                sess,
            )
            chunk = max(1, self.config.snapshot_chunk_bytes)
            sent = 0
            while True:
                data = await loop.run_in_executor(pool, f.read, chunk)
                if not data:
                    break
                sent += len(data)
                await self._drain_sync_block(
                    writer,
                    speedy.frame(
                        speedy.encode_sync_message(("snap_chunk", data))
                    ),
                    sess,
                )
        finally:
            f.close()
        await self._drain_sync_block(
            writer,
            speedy.frame(speedy.encode_sync_message(("snap_done",))),
            sess,
        )
        live = sess.get("live") if sess else None
        self._snapshot_serve_record(
            live["peer"] if live else None, sent
        )

    # -- client-side staging + crash-safe install ----------------------

    def _snapshot_stage_begin(self, peer, digest: bytes, size: int,
                              their_heads,
                              crash_at: Optional[str] = None) -> dict:
        """Open the staging sidecar + journal marker for an offered
        snapshot.  ``their_heads`` is the server's advertised per-actor
        head map at dispatch time — the install-safety gate
        (``snapshot.client_behind``) re-runs over it under the storage
        lock before the swap, so ANY change applied mid-transfer beyond
        what the snapshot holds (a local write, or another actor's
        broadcast this client may be the only holder of) aborts the
        install instead of being rolled back.  ``crash_at`` is the
        fault harness's injected death stage (faults.SnapFault); never
        set on a production path."""
        from corrosion_tpu_torch.agent import snapshot as snaplib

        db = self.config.db_path
        sp = snaplib.staged_path(db)
        if os.path.exists(sp):
            os.unlink(sp)
        snaplib.write_marker(db, "staging", digest, size)
        f = open(sp, "wb")
        return {
            "f": f, "path": sp, "digest": bytes(digest),
            "size": int(size), "n": 0, "peer": peer,
            "their_heads": {
                (a.bytes if isinstance(a, ActorId) else bytes(a)): int(h)
                for a, h in dict(their_heads).items()
            },
            "t0": self._clock.monotonic(), "crash_at": crash_at,
        }

    def _snapshot_stage_feed(self, st: dict, data: bytes) -> None:
        from corrosion_tpu_torch.agent import snapshot as snaplib

        st["f"].write(data)
        st["n"] += len(data)
        if st["n"] > st["size"]:
            raise snaplib.SnapshotError(
                "snapshot stream exceeds the offered size"
            )
        self.metrics.counter(
            "corro_snapshot_bytes_total", len(data), dir="received"
        )

    def _snapshot_abort(self, st: dict, reason: str, addr=None,
                        trip: bool = False) -> None:
        """Discard a staged snapshot cleanly: sidecar + marker go, the
        previous database is untouched, the rejection is counted
        (``corro_sync_client_rejects_total{reason=}``) and — for
        verified-hostile serves like a digest mismatch — the peer's
        breaker trips so the retry round falls back to change-by-change
        via another peer."""
        from corrosion_tpu_torch.agent import snapshot as snaplib

        f = st.pop("f", None)
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        try:
            if os.path.exists(st["path"]):
                os.unlink(st["path"])
        except OSError:
            pass
        snaplib.clear_marker(self.config.db_path)
        self.metrics.counter(
            "corro_snapshot_installs_total",
            result=reason[5:] if reason.startswith("snap_") else reason,
        )
        self._sync_client_reject(reason, addr, trip=trip)
        self._flight_event(
            "snap_abort", peer=st.get("peer"), reason=reason
        )

    def _snapshot_install_staged(self, st: dict, addr=None) -> bool:
        """Verify, prepare, and atomically install a fully-staged
        snapshot (worker-thread body; the virtual cluster calls it
        inline).  Returns True on success; False after a clean abort —
        the caller's needs stay in bookkeeping, so the partial-round
        retry falls back to change-by-change via another peer."""
        from corrosion_tpu_torch.agent import snapshot as snaplib

        db = self.config.db_path
        f = st.pop("f")
        f.flush()
        os.fsync(f.fileno())
        f.close()
        if st["n"] != st["size"] \
                or snaplib.file_digest(st["path"]) != st["digest"]:
            # the containment gate: a truncated, corrupted, or
            # divergent-minted snapshot (a hostile server advertising
            # the honest digest over tampered bytes) dies here — trip
            # the breaker, never install
            self._snapshot_abort(st, "snap_digest", addr, trip=True)
            return False
        try:
            snaplib.prepare_staged(
                st["path"], self.actor_id, self.incarnation
            )
        except Exception:
            self._snapshot_abort(st, "snap_prepare", addr, trip=True)
            return False
        t_swap = self._clock.monotonic()
        with self.storage._lock:
            # the install-safety gate, re-run over EVERY tracked actor
            # at the last possible moment: a change applied
            # mid-transfer beyond the server's recorded heads — our
            # own write, or another actor's broadcast this client may
            # be the only remaining holder of — must abort the swap,
            # not be rolled back by it
            ours = {}
            for actor, bv in self.bookie.actors().items():
                head = bv.last()
                if head:
                    ours[bytes(actor)] = head
            if not snaplib.client_behind(ours, st["their_heads"]):
                self._snapshot_abort(st, "snap_stale", addr)
                return False
            snaplib.write_marker(db, "installing", st["digest"],
                                 st["size"])
            if st.get("crash_at") == "installing":
                raise snaplib.SnapshotCrash("installing")
            try:
                self.storage.install_snapshot(st["path"])
                if st.get("crash_at") == "swapped":
                    raise snaplib.SnapshotCrash("swapped")
                snaplib.clear_marker(db)
                self._post_install_reload()
            except snaplib.SnapshotCrash:
                # injected death: leave marker/sidecar exactly as the
                # crash found them (the boot recovery contract under
                # test); the harness closes the agent
                raise
            except BaseException:
                # a FAILED swap: storage came back up on whatever file
                # survived (install_snapshot's recovery), so every
                # in-memory view must follow its connection — without
                # this the Bookie would keep writing into the closed
                # pre-swap handle
                try:
                    self._post_install_reload()
                except Exception:
                    logger.exception(
                        "post-failure snapshot reload failed"
                    )
                raise
        self.metrics.counter(
            "corro_snapshot_installs_total", result="ok"
        )
        self.metrics.histogram(
            "corro_snapshot_install_seconds",
            self._clock.monotonic() - st["t0"],
        )
        self.metrics.gauge(
            "corro_snapshot_swap_seconds",
            round(self._clock.monotonic() - t_swap, 6),
        )
        self._flight_event(
            "snap_install", peer=st.get("peer"), bytes=st["n"]
        )
        return True

    def _post_install_reload(self) -> None:
        """Rebuild every in-memory view of storage after the swap
        (caller holds the storage lock).  Object identities survive —
        the Bookie and CrConn rebuild IN PLACE so every component
        holding a reference keeps working against the installed
        database."""
        self.bookie.reload(self.storage.conn)
        self.bookie.backfill_own_sync_state(self.actor_id)
        self._sync_gen_cache = None
        self._snap_cache = None
        # node-local planes the snapshot scrubbed: membership table and
        # incarnation re-persist from the live in-memory state
        self._members_table()
        self._persist_members()
        self._persist_incarnation()
        # the digest FIFO is node-local (scrubbed); signed proofs are
        # portable and rode the snapshot — reload re-creates the
        # tables and re-asserts the proof-backed permanent verdicts
        with self._equiv_lock:
            self._equiv_digests.clear()
            self._equiv_sigs.clear()
        if self.config.equivocation_detection:
            self._load_equiv_digests()
        self._register_backfills()

    async def _snapshot_client_session(self, s: dict) -> Tuple[int, bool]:
        """One outbound snapshot session (the dispatch chose install
        over change-by-change): request, stage the chunk stream,
        verify, install, then rely on the next anti-entropy round for
        the tail delta.  The serve-path client defenses apply
        symmetrically — whole-session deadline on the injected clock,
        frame-validation budget, offer screen — and every failure is a
        clean abort that keeps the needs in bookkeeping for the
        partial-round retry."""
        from corrosion_tpu_torch.agent import snapshot as snaplib

        m, reader, writer = s["member"], s["reader"], s["writer"]
        frames = s["frames"]
        addr = tuple(m.addr)
        peer_hex = m.actor_id.hex()
        live = self._sync_session_begin("client", peer_hex, 1)
        self._flight_event(
            "sync_client_start", peer=peer_hex, needs=1
        )
        their_heads = s["theirs"].heads
        st: Optional[dict] = None
        installed = False
        try:
            writer.write(
                speedy.frame(
                    speedy.encode_sync_message(("snap_request",))
                )
            )
            await writer.drain()
            if writer.can_write_eof():
                writer.write_eof()
            deadline = None
            if self.config.sync_session_deadline_s > 0:
                deadline = (self._clock.monotonic()
                            + self.config.sync_session_deadline_s)
            frame_errs = 0
            done = False
            eof = False
            while not (done or eof):
                read_timeout = 10.0
                if deadline is not None:
                    remaining = deadline - self._clock.monotonic()
                    if remaining <= 0:
                        self._sync_client_reject(
                            "deadline", addr, strike=True
                        )
                        break
                    read_timeout = min(read_timeout, remaining)
                data = await asyncio.wait_for(
                    reader.read(65536), timeout=read_timeout
                )
                if not data:
                    eof = True
                    break
                live["bytes"] += len(data)
                try:
                    payloads = frames.feed(data)
                except speedy.SpeedyError:
                    self._sync_client_reject(
                        "frame_garbage", addr, trip=True
                    )
                    break
                for payload in payloads:
                    try:
                        msg = speedy.decode_sync_message(payload)
                    except speedy.SpeedyError:
                        frame_errs += 1
                        self._sync_client_reject("frame_garbage")
                        if frame_errs > self.SYNC_CLIENT_FRAME_BUDGET:
                            self._trip_breaker(addr)
                            done = True
                        continue
                    if isinstance(msg, Timestamp):
                        try:
                            self.clock.update_with_timestamp(msg)
                        except Exception:
                            pass
                    elif isinstance(msg, tuple) and msg[0] == "snap_offer":
                        _tag, digest, size = msg
                        if st is not None or size <= 0 \
                                or size > self.config.snapshot_max_bytes:
                            self._sync_client_reject(
                                "snap_offer", addr, trip=True
                            )
                            done = True
                            continue
                        st = await asyncio.to_thread(
                            self._snapshot_stage_begin, peer_hex,
                            digest, size, their_heads,
                        )
                    elif isinstance(msg, tuple) and msg[0] == "snap_chunk":
                        if st is None:
                            # chunks with no prior offer: the same
                            # frame-validation budget as undecodable
                            # frames — an endless offer-less chunk
                            # stream must trip the breaker, not burn
                            # the whole session deadline every round
                            frame_errs += 1
                            self._sync_client_reject("snap_offer")
                            if frame_errs > self.SYNC_CLIENT_FRAME_BUDGET:
                                self._trip_breaker(addr)
                                done = True
                            continue
                        try:
                            await asyncio.to_thread(
                                self._snapshot_stage_feed, st, msg[1]
                            )
                        except snaplib.SnapshotError:
                            self._snapshot_abort(
                                st, "snap_stream", addr, trip=True
                            )
                            st = None
                            done = True
                    elif isinstance(msg, tuple) and msg[0] == "snap_done":
                        if st is None:
                            break
                        installed = await asyncio.to_thread(
                            self._snapshot_install_staged, st, addr
                        )
                        st = None
                        done = True
            if st is not None:
                # stream ended without snap_done — a truncated serve,
                # a blown session deadline (already a breaker STRIKE
                # above), or an honest server crash.  None of these is
                # VERIFIED hostility, so no breaker trip: tripping here
                # would let a slow link cycle a bootstrapping client
                # through honest peers' breakers forever.  Tampered
                # bytes still die on the digest gate (trip=True there)
                self._snapshot_abort(st, "snap_stream", addr)
                st = None
            if installed:
                self.members.update_sync_ts(
                    m.actor_id, self._clock.wall()
                )
            return (1 if installed else 0), installed
        except (asyncio.TimeoutError, OSError, ConnectionError,
                speedy.SpeedyError, snaplib.SnapshotError,
                sqlite3.Error) as e:
            # sqlite3.Error covers a storage-level install failure
            # (disk full mid-swap): install_snapshot restores a
            # working connection on whatever file survives, and the
            # abort here cleans the sidecar/marker + counts the
            # failure instead of gather() swallowing it silently
            if isinstance(e, sqlite3.Error):
                logger.error("snapshot install failed: %s", e)
            if st is not None:
                self._snapshot_abort(st, "snap_stream", addr)
                st = None
            return 0, False
        finally:
            writer.close()
            self._sync_session_end(live, "client", "received")
            self._flight_event(
                "sync_client_end", peer=peer_hex,
                changes=0, bytes=live["bytes"], complete=installed,
            )


# ---------------------------------------------------------------------------
# UDP protocol
# ---------------------------------------------------------------------------


_SWIM_KINDS = frozenset(
    ("announce", "announce_ack", "probe", "ack", "ping_req",
     "probe_relay", "leave", "change")
)


class _UdpProtocol(asyncio.DatagramProtocol):
    def __init__(self, agent: Agent):
        self.agent = agent

    def datagram_received(self, data: bytes, addr) -> None:
        a = self.agent
        # wire sniff: JSON envelopes start with '{'; foca datagrams
        # start with the uuid length prefix (0x10).  Receivers accept
        # both so mixed-wire clusters interoperate.
        if not data.startswith(b"{"):
            from corrosion_tpu_torch.agent import swim_foca

            swim_foca.handle_datagram(a, data, addr)
            return
        try:
            msg = wire.decode_datagram(data)
        except ValueError:
            return
        if msg.get("c", 0) != a.config.cluster_id:
            # cross-cluster SWIM traffic is dropped wholesale: the
            # sender is not a member here and must not refresh (or
            # create) a membership entry
            a.metrics.counter("corro_swim_cluster_rejected_total")
            return
        kind = msg.get("k")
        a.metrics.counter(
            "corro_gossip_datagrams_received_total",
            # remote-supplied: clamp to the known protocol kinds so a
            # hostile peer can't mint unbounded series
            kind=kind if kind in _SWIM_KINDS else "other",
        )
        if kind == "announce":
            a._ingest_piggyback(msg.get("pb", []))
            a._send_udp(addr, {"k": "announce_ack", "pb": a._piggyback(10)})
        elif kind == "announce_ack":
            a._ingest_piggyback(msg.get("pb", []))
        elif kind == "probe":
            a._ingest_piggyback(msg.get("pb", []))
            a._send_udp(addr, {"k": "ack", "n": msg["n"], "pb": a._piggyback()})
        elif kind == "ack":
            a._ingest_piggyback(msg.get("pb", []))
            fut = a._acks.get(msg.get("n"))
            if fut and not fut.done():
                fut.set_result(True)
        elif kind == "ping_req":
            target = tuple(msg["target"])
            a._send_udp(
                target,
                {
                    "k": "probe_relay",
                    "n": msg["n"],
                    "reply_to": msg["reply_to"],
                    "pb": a._piggyback(),
                },
            )
        elif kind == "leave":
            # graceful departure: mark down at the leaver's own
            # incarnation (its refutations have stopped, so the record
            # sticks and piggybacks onward)
            try:
                actor = wire._unb64(msg["a"])
                inc = int(msg.get("i", 0))
            except (KeyError, ValueError, TypeError):
                return
            m = a.members.get(actor) if actor else None
            if m is not None:
                a.members.upsert(
                    actor, m.addr, MemberState.DOWN,
                    max(m.incarnation, inc),
                )
        elif kind == "probe_relay":
            a._ingest_piggyback(msg.get("pb", []))
            a._send_udp(
                tuple(msg["reply_to"]),
                {"k": "ack", "n": msg["n"], "pb": a._piggyback()},
            )
        elif kind == "change":
            # legacy datagram path (changesets normally ride uni-streams
            # now); still accepted, routed through the bounded queue
            try:
                cv = wire.change_v1_from_dict(msg["cv"])
            except (KeyError, ValueError):
                return
            a.enqueue_change(cv, ChangeSource.BROADCAST)


# ---------------------------------------------------------------------------
# sync state <-> wire dicts
# ---------------------------------------------------------------------------


def _sync_state_to_dict(st: SyncStateV1) -> dict:
    return {
        "actor": wire._b64(st.actor_id.bytes),
        "heads": {wire._b64(a.bytes): int(v) for a, v in st.heads.items()},
        "need": {
            wire._b64(a.bytes): [list(sp) for sp in spans]
            for a, spans in st.need.items()
        },
        "partial_need": {
            wire._b64(a.bytes): {
                str(int(v)): [list(sp) for sp in spans]
                for v, spans in partials.items()
            }
            for a, partials in st.partial_need.items()
        },
        "last_cleared_ts": (
            int(st.last_cleared_ts) if st.last_cleared_ts is not None else None
        ),
    }


def _parse_addr(s: str) -> Tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _drop_most_transmitted(pending: List[tuple], cap: int) -> int:
    """Overflow policy for the retransmission set: drop the payloads with
    the MOST sends so far (smallest ``remaining``), keeping fresh changes'
    retransmissions alive.  Parity: ``drop_oldest_broadcast`` drops max
    send_count (``broadcast/mod.rs:782-801``).  Entries are
    ``(due, frame, cv, remaining, sent_to)``; returns the drop count."""
    if len(pending) <= cap:
        return 0
    pending.sort(key=lambda p: p[3])
    dropped = len(pending) - cap
    del pending[:dropped]
    return dropped
