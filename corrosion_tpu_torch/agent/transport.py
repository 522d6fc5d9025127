"""Outbound transport: datagrams for SWIM, cached uni-streams for
changesets, bi-streams for sync.

Parity: the reference multiplexes three channel classes over one QUIC
connection (``crates/corro-agent/src/transport.rs``, ``api/peer.rs:97-342``):
unreliable datagrams for SWIM packets (≤1178 B, foca's max packet),
uni-directional streams for broadcast changesets, bi-directional streams
for sync sessions — with a connection cache keyed by address, a liveness
test + single retry, and RTT samples pushed into the member rings.

Ours maps datagrams onto the agent's UDP endpoint (with the same 1178 B
hard cap — oversize SWIM payloads are a bug, not a fragmentation
exercise) and uni/bi streams onto TCP connections to the peer's gossip
port.  Uni connections are cached and reused; a dead cached connection
is dropped and reopened once (transport.rs:213-233 retry semantics).
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

Addr = Tuple[str, int]

# foca's max packet size (broadcast/mod.rs:943); SWIM messages must fit
MAX_UDP_PAYLOAD = 1178


class TokenBucket:
    """Byte-rate limiter (the 10 MiB/s broadcast governor,
    broadcast/mod.rs:455-458).  ``clock`` injects the time source
    (``corrosion_tpu_torch/clock.py``); default = real time."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=None):
        from corrosion_tpu_torch.clock import SYSTEM_CLOCK

        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._clock = clock or SYSTEM_CLOCK
        self._tokens = self.burst
        self._last = self._clock.monotonic()

    def _refill(self) -> None:
        now = self._clock.monotonic()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    async def consume(self, n: float) -> None:
        while True:
            self._refill()
            if self._tokens >= n:
                self._tokens -= n
                return
            need = (n - self._tokens) / self.rate
            await self._clock.sleep(min(need, 1.0))


class ConnStats:
    """Per-peer connection statistics (the TCP/TLS stand-in for the
    reference's full quinn ConnectionStats export,
    ``transport.rs:235-419``): cumulative across reconnects to the same
    address, surfaced through metrics and ``cluster members``."""

    __slots__ = ("connects", "bytes_sent", "frames_sent", "failures",
                 "faults_dropped", "redials", "breaker_opens",
                 "rtt_last_ms", "rtt_min_ms", "last_used")

    def __init__(self):
        self.connects = 0
        self.bytes_sent = 0
        self.frames_sent = 0
        self.failures = 0
        # degraded-mode accounting: injected in-flight drops (fault
        # injection), reconnect attempts after a dead cached conn, and
        # circuit-breaker open transitions — the chaos-run debug surface
        self.faults_dropped = 0
        self.redials = 0
        self.breaker_opens = 0
        self.rtt_last_ms: Optional[float] = None
        self.rtt_min_ms: Optional[float] = None
        self.last_used = 0.0

    def as_dict(self) -> dict:
        return {
            "connects": self.connects,
            "bytes_sent": self.bytes_sent,
            "frames_sent": self.frames_sent,
            "failures": self.failures,
            "faults_dropped": self.faults_dropped,
            "redials": self.redials,
            "breaker_opens": self.breaker_opens,
            "rtt_last_ms": self.rtt_last_ms,
            "rtt_min_ms": self.rtt_min_ms,
        }


class CircuitBreaker:
    """Per-peer failure quarantine: after ``threshold`` consecutive
    failures the breaker OPENS and sends fail fast (no connect attempt,
    no timeout) until ``cooldown`` elapses; then ONE half-open trial is
    allowed — success closes the breaker, failure re-opens it for
    another cooldown.  This is what keeps a broadcast flush round
    bounded when a peer is dead: every destination past the first
    timeout burns zero wall-clock on the corpse."""

    __slots__ = ("threshold", "cooldown", "failures", "opened_at",
                 "half_open_inflight", "_now")

    def __init__(self, threshold: int = 5, cooldown: float = 3.0,
                 now=None):
        self.threshold = threshold
        self.cooldown = cooldown
        # the cooldown's time source (injectable-clock seam): a
        # virtual-time campaign ages breaker cooldowns on the event
        # heap instead of the wall
        self._now = now or time.monotonic
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.half_open_inflight = False

    @property
    def is_open(self) -> bool:
        return self.opened_at is not None

    def allow(self, now: Optional[float] = None) -> bool:
        if self.opened_at is None:
            return True
        now = self._now() if now is None else now
        if now - self.opened_at < self.cooldown:
            return False
        # cooldown passed: admit one half-open trial at a time
        if self.half_open_inflight:
            return False
        self.half_open_inflight = True
        return True

    def record_success(self) -> bool:
        """Returns True when this success CLOSED an open breaker
        (the half-open restore path)."""
        self.failures = 0
        self.half_open_inflight = False
        if self.opened_at is not None:
            self.opened_at = None
            return True
        return False

    def record_failure(self, now: Optional[float] = None) -> bool:
        """Returns True when this failure OPENED the breaker."""
        self.half_open_inflight = False
        if self.opened_at is not None:
            # half-open trial failed: restart the cooldown
            self.opened_at = self._now() if now is None else now
            return False
        self.failures += 1
        if self.failures >= self.threshold:
            self.opened_at = self._now() if now is None else now
            return True
        return False

    def trip(self, now: Optional[float] = None) -> bool:
        """Force the breaker OPEN immediately (verified-hostile
        evidence — tampered signed bytes, garbage sync serves — is not
        ordinary flakiness worth ``threshold`` free strikes).  Returns
        True when this call newly opened it; an already-open breaker
        just restarts its cooldown."""
        self.half_open_inflight = False
        self.failures = self.threshold
        was_closed = self.opened_at is None
        self.opened_at = self._now() if now is None else now
        return was_closed

    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if self._now() - self.opened_at >= self.cooldown:
            return "half-open"
        return "open"


def prune_breakers(breakers: dict, cap: int, on_evict=None) -> None:
    """Bound a breaker registry at insert time, cheapest state first:
    healthy entries (closed, no strikes), then closed entries with
    partial strikes (member churn accrues these forever and losing a
    strike count is cheap), then — because the survivors can ALL be
    open: verified-hostile evidence (``runtime._trip_breaker``) mints
    immediately-open breakers keyed by attacker-controlled ephemeral
    source addresses, and ``is_open`` holds until a dial SUCCEEDS —
    the oldest-OPENED entries go too.  A memory bound beats a perfect
    memory of every hostile port; a live offender re-trips on its
    next evidence.  ``on_evict(addr)`` fires for each evicted OPEN
    entry: an open breaker carries live member-quarantine state, and
    a fresh breaker minted later for the same address closes silently
    (``record_success`` on a never-opened breaker reports no
    transition), so the owner must lift the quarantine NOW or the
    member strands deprioritized forever."""
    if len(breakers) <= cap:
        return
    for a in [a for a, br in breakers.items()
              if not br.is_open and br.failures == 0]:
        del breakers[a]
    if len(breakers) <= cap:
        return
    for a in [a for a, br in breakers.items() if not br.is_open]:
        del breakers[a]
        if len(breakers) <= cap:
            return
    by_age = sorted(
        (a for a, br in breakers.items() if br.is_open),
        key=lambda a: breakers[a].opened_at or 0.0,
    )
    for a in by_age[: len(breakers) - cap]:
        del breakers[a]
        if on_evict is not None:
            on_evict(a)


class UniConnection:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.lock = asyncio.Lock()

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


class Transport:
    """Connection-caching sender.  All methods are loop-affine.

    With ``mux=True`` (default) both reliable channel classes share
    ONE cached connection per peer (``agent/mux.py``: framed uni + bi
    channels — the reference's single-QUIC-connection shape), and
    peers spread over ``LANES`` hashed lanes, each with its own
    connect semaphore (the 8-client-endpoint spread,
    transport.rs:55-93).  ``mux=False`` keeps the per-channel wiring: a
    cached uni connection per peer + a fresh connection per sync
    session."""

    def __init__(self, metrics=None, connect_timeout: float = 2.0,
                 on_rtt=None, max_cached: int = 512, ssl_context=None,
                 mux: bool = True,
                 redial_retries: int = 2,
                 redial_base: float = 0.05,
                 redial_cap: float = 0.5,
                 breaker_threshold: int = 5,
                 breaker_cooldown: float = 3.0,
                 on_breaker: Optional[Callable[[Addr, bool], None]] = None,
                 rng: Optional[random.Random] = None,
                 clock=None):
        from corrosion_tpu_torch.clock import SYSTEM_CLOCK

        self._uni: Dict[Addr, UniConnection] = {}
        self.metrics = metrics
        # the injectable time source behind cooldowns, RTT stamps,
        # fault delays and redial backoff sleeps
        self._clock = clock or SYSTEM_CLOCK
        self.connect_timeout = connect_timeout
        self.on_rtt = on_rtt  # callback(addr, rtt_seconds)
        self.ssl_context = ssl_context  # TLS for uni/bi streams (or None)
        self.stats: Dict[Addr, ConnStats] = {}
        # fault-injection hook: callable(channel, addr) -> FaultAction
        # (corrosion_tpu_torch.faults) consulted on every send_uni/open_bi;
        # None = no faults (production default)
        self.fault_filter = None
        # bounded redial policy for dead cached connections: retries
        # ride utils.backoff (decorrelated jitter) off a seedable rng so
        # det-mode runs replay the same sleep schedule
        self.redial_retries = redial_retries
        self.redial_base = redial_base
        self.redial_cap = redial_cap
        self._rng = rng or random.Random()
        # per-peer circuit breakers: a persistently-failing address is
        # quarantined so one dead node cannot stall a flush round
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.breakers: Dict[Addr, CircuitBreaker] = {}
        # registry mutation is NOT loop-affine: the apply workers'
        # verified-hostile convictions (runtime._trip_breaker) insert
        # from their pool threads while the loop's own _breaker does —
        # prune's iteration must never race an insert
        self.breakers_lock = threading.Lock()
        self.on_breaker = on_breaker  # callback(addr, opened: bool)
        # LRU cap on cached uni connections (the reference's QUIC conns
        # close on idle timeout; an unbounded TCP cache leaks fds in
        # large in-process clusters)
        self.max_cached = max_cached
        self.mux = mux
        self._muxes: Dict[Addr, "MuxConnection"] = {}
        # per-lane connect semaphores: a connect storm to many peers
        # fans across lanes instead of one queue
        self._lane_sems: Optional[list] = None
        # per-peer open lock: concurrent first sends to one peer must
        # share ONE connection, not race N opens
        self._open_locks: Dict[Addr, asyncio.Lock] = {}

    def _stat(self, addr: Addr) -> ConnStats:
        s = self.stats.get(addr)
        if s is None:
            s = self.stats[addr] = ConnStats()
            # bound the map like the conn cache (dead peers age out)
            if len(self.stats) > 4 * self.max_cached:
                oldest = sorted(self.stats, key=lambda a: self.stats[a].last_used)
                for a in oldest[: len(self.stats) - 2 * self.max_cached]:
                    del self.stats[a]
        s.last_used = self._clock.monotonic()
        return s

    def _record_rtt_stat(self, addr: Addr, rtt_s: float) -> None:
        s = self._stat(addr)
        ms = rtt_s * 1000.0
        s.rtt_last_ms = ms
        s.rtt_min_ms = ms if s.rtt_min_ms is None else min(s.rtt_min_ms, ms)

    # -- degraded-mode plumbing -----------------------------------------

    def _breaker(self, addr: Addr) -> CircuitBreaker:
        with self.breakers_lock:
            b = self.breakers.get(addr)
            if b is None:
                prune_breakers(
                    self.breakers, 4 * self.max_cached,
                    on_evict=(
                        None if self.on_breaker is None
                        else lambda a: self.on_breaker(a, False)
                    ),
                )
                b = self.breakers[addr] = CircuitBreaker(
                    self.breaker_threshold, self.breaker_cooldown,
                    now=self._clock.monotonic,
                )
        return b

    def _breaker_success(self, addr: Addr) -> None:
        b = self.breakers.get(addr)
        if b is not None and b.record_success():
            if self.metrics is not None:
                self.metrics.counter("corro_transport_breaker_closes_total")
            if self.on_breaker is not None:
                self.on_breaker(addr, False)

    def _breaker_failure(self, addr: Addr) -> None:
        if self._breaker(addr).record_failure():
            self._stat(addr).breaker_opens += 1
            if self.metrics is not None:
                self.metrics.counter("corro_transport_breaker_opens_total")
            if self.on_breaker is not None:
                self.on_breaker(addr, True)

    def _fault(self, channel: str, addr: Addr):
        """Consult the fault-injection hook; returns the action or None.
        Injected drops are the SENDER-INVISIBLE kind (in-flight loss,
        matching the sim's ``loss``): callers treat them as successful
        sends that the receiver never sees."""
        if self.fault_filter is None:
            return None
        act = self.fault_filter(channel, addr)
        if act is None or (not act.drop and not act.delay):
            return None
        return act

    def breaker_states(self) -> Dict[Addr, str]:
        with self.breakers_lock:
            snapshot = list(self.breakers.items())
        return {a: b.state() for a, b in snapshot}

    async def _open(self, addr: Addr, header: bytes) -> UniConnection:
        t0 = self._clock.monotonic()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                addr[0], addr[1], ssl=self.ssl_context
            ),
            timeout=self.connect_timeout,
        )
        rtt = self._clock.monotonic() - t0
        self._stat(addr).connects += 1
        self._record_rtt_stat(addr, rtt)
        if self.on_rtt is not None:
            self.on_rtt(addr, rtt)
        if self.metrics is not None:
            self.metrics.histogram("corro_transport_connect_seconds", rtt)
        writer.write(header)
        await writer.drain()
        return UniConnection(reader, writer)

    # -- multiplexed path ------------------------------------------------

    def _lane_sem(self, addr: Addr):
        from corrosion_tpu_torch.agent.mux import LANES, lane_of

        if self._lane_sems is None:
            self._lane_sems = [asyncio.Semaphore(32) for _ in range(LANES)]
        return self._lane_sems[lane_of(addr)]

    async def _get_mux(self, addr: Addr) -> "MuxConnection":
        from corrosion_tpu_torch.agent.mux import STREAM_MUX, MuxConnection

        m = self._muxes.get(addr)
        if m is not None and not m.closed:
            # LRU touch
            self._muxes.pop(addr, None)
            self._muxes[addr] = m
            return m
        if len(self._open_locks) > 4 * self.max_cached:
            self._open_locks = {
                a: lk for a, lk in self._open_locks.items() if lk.locked()
            }
        open_lock = self._open_locks.setdefault(addr, asyncio.Lock())
        async with open_lock, self._lane_sem(addr):
            m = self._muxes.get(addr)
            if m is not None and not m.closed:
                return m
            t0 = self._clock.monotonic()
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(
                    addr[0], addr[1], ssl=self.ssl_context
                ),
                timeout=self.connect_timeout,
            )
            rtt = self._clock.monotonic() - t0
            self._stat(addr).connects += 1
            self._record_rtt_stat(addr, rtt)
            if self.on_rtt is not None:
                self.on_rtt(addr, rtt)
            if self.metrics is not None:
                self.metrics.histogram(
                    "corro_transport_connect_seconds", rtt)
            writer.write(STREAM_MUX)
            await writer.drain()
            m = MuxConnection(reader, writer, metrics=self.metrics,
                              clock=self._clock)
            self._muxes[addr] = m
            excess = len(self._muxes) - self.max_cached
            if excess > 0:
                for old_addr in list(self._muxes):
                    if excess <= 0:
                        break
                    old = self._muxes[old_addr]
                    if old is m or old._channels:
                        continue  # never evict one with live sessions
                    self._muxes.pop(old_addr)
                    old.close()
                    excess -= 1
            return m

    def _drop_mux(self, addr: Addr) -> None:
        m = self._muxes.pop(addr, None)
        if m is not None:
            m.close()

    async def send_uni(self, addr: Addr, frames: bytes,
                       header: bytes) -> bool:
        """Write pre-framed bytes on the cached uni channel to addr;
        a dead cached connection is dropped and redialed with bounded
        backoff.  An open circuit breaker fails fast (no connect, no
        timeout); injected faults drop in flight (sender sees success)."""
        act = self._fault("uni", addr)
        if act is not None:
            if act.delay:
                await self._clock.sleep(act.delay)
            if act.drop:
                self._stat(addr).faults_dropped += 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "corro_transport_faults_injected_total", kind="uni"
                    )
                return True  # in-flight loss: the sender believes it sent
        if not self._breaker(addr).allow():
            # a fast-fail skip is not a new failure — `failures` counts
            # real exhausted send attempts (open_bi accounts the same
            # way); the skip volume has its own counter
            if self.metrics is not None:
                self.metrics.counter(
                    "corro_transport_breaker_skips_total")
            return False
        if self.mux:
            from corrosion_tpu_torch.utils.backoff import Backoff, retry

            attempts = 0

            async def _attempt():
                nonlocal attempts
                attempts += 1
                try:
                    m = await self._get_mux(addr)
                    await m.send_uni(frames)
                except (OSError, ConnectionError, asyncio.TimeoutError):
                    # the cached mux is dead: drop it so the retry (and
                    # any concurrent sender) redials a fresh connection
                    self._drop_mux(addr)
                    if attempts > 1:
                        self._stat(addr).redials += 1
                    raise

            try:
                await retry(
                    _attempt,
                    Backoff(self.redial_base, self.redial_cap,
                            max_retries=self.redial_retries,
                            rng=self._rng),
                    sleep=self._clock.sleep,
                )
            except (OSError, ConnectionError, asyncio.TimeoutError):
                self._stat(addr).failures += 1
                self._breaker_failure(addr)
                if self.metrics is not None:
                    self.metrics.counter(
                        "corro_transport_uni_failures_total"
                    )
                return False
            st = self._stat(addr)
            st.bytes_sent += len(frames)
            st.frames_sent += 1
            self._breaker_success(addr)
            return True
        for attempt in (0, 1):
            conn = self._uni.get(addr)
            try:
                if conn is None:
                    conn = await self._open(addr, header)
                    self._uni[addr] = conn
                    excess = len(self._uni) - self.max_cached
                    for old_addr in list(self._uni):
                        if excess <= 0:
                            break
                        old = self._uni[old_addr]
                        # never close a connection a concurrent sender
                        # holds (its write would die mid-frame)
                        if old is conn or old.lock.locked():
                            continue
                        self._uni.pop(old_addr)
                        old.close()
                        excess -= 1
                else:
                    # LRU touch
                    self._uni.pop(addr, None)
                    self._uni[addr] = conn
                async with conn.lock:
                    conn.writer.write(frames)
                    await conn.writer.drain()
                st = self._stat(addr)
                st.bytes_sent += len(frames)
                st.frames_sent += 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "corro_transport_uni_bytes_total", len(frames)
                    )
                self._breaker_success(addr)
                return True
            except (OSError, ConnectionError, asyncio.TimeoutError):
                if addr in self._uni:
                    self._uni.pop(addr).close()
                if attempt == 0:
                    self._stat(addr).redials += 1
                if attempt == 1:
                    self._stat(addr).failures += 1
                    self._breaker_failure(addr)
                    if self.metrics is not None:
                        self.metrics.counter(
                            "corro_transport_uni_failures_total"
                        )
                    return False
        return False

    async def open_bi(self, addr: Addr):
        """(reader, writer) for a sync session.  Multiplexed: a fresh
        bi CHANNEL on the peer's shared mux connection (dead cache
        entries dropped and redialed with bounded backoff); legacy: a
        fresh connection per session like the reference's open_bi.
        An open breaker or an injected partition/drop raises OSError —
        the retryable shape the sync client already handles."""
        act = self._fault("bi", addr)
        if act is not None:
            if act.delay:
                await self._clock.sleep(act.delay)
            if act.drop:
                self._stat(addr).faults_dropped += 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "corro_transport_faults_injected_total", kind="bi"
                    )
                raise OSError("fault injected: bi stream dropped")
        if not self._breaker(addr).allow():
            if self.metrics is not None:
                self.metrics.counter("corro_transport_breaker_skips_total")
            raise OSError("circuit breaker open")
        if self.mux:
            from corrosion_tpu_torch.utils.backoff import Backoff, retry

            attempts = 0

            async def _attempt():
                nonlocal attempts
                attempts += 1
                try:
                    m = await self._get_mux(addr)
                    return m.open_channel()
                except (OSError, ConnectionError, asyncio.TimeoutError):
                    self._drop_mux(addr)
                    if attempts > 1:
                        self._stat(addr).redials += 1
                    raise

            try:
                chan = await retry(
                    _attempt,
                    Backoff(self.redial_base, self.redial_cap,
                            max_retries=self.redial_retries,
                            rng=self._rng),
                    sleep=self._clock.sleep,
                )
            except (OSError, ConnectionError, asyncio.TimeoutError):
                self._stat(addr).failures += 1
                self._breaker_failure(addr)
                raise
            # re-check the PARTITION after the connect awaits: a
            # partition arming while open_connection was suspended
            # (TOCTOU) must not hand back a live channel — the whole
            # session it gates would then legally stream across the
            # "partition".  The probe consumes no seeded loss draw.
            act = self._fault("partition_check", addr)
            if act is not None and act.drop:
                self._drop_mux(addr)
                self._stat(addr).faults_dropped += 1
                # the breaker must see an outcome: allow() may have
                # admitted this call as THE half-open trial, and bailing
                # without recording one would leave half_open_inflight
                # latched and the breaker wedged open forever.  A
                # partitioned connect IS a failure to reach the peer.
                self._breaker_failure(addr)
                raise OSError("fault injected: bi stream dropped")
            self._breaker_success(addr)
            return chan
        t0 = self._clock.monotonic()
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(
                    addr[0], addr[1], ssl=self.ssl_context
                ),
                timeout=self.connect_timeout,
            )
        except (OSError, ConnectionError, asyncio.TimeoutError):
            self._stat(addr).failures += 1
            self._breaker_failure(addr)
            raise
        rtt = self._clock.monotonic() - t0
        self._stat(addr).connects += 1
        self._record_rtt_stat(addr, rtt)
        if self.on_rtt is not None:
            self.on_rtt(addr, rtt)
        self._breaker_success(addr)
        writer.write(b"B")  # STREAM_BI prelude (runtime dispatch)
        return reader, writer

    async def aclose(self) -> None:
        """Graceful close: waits for cached connections to fully close so
        no worker touches a half-torn-down socket during agent stop."""
        for m in list(self._muxes.values()):
            m.close()
        self._muxes.clear()
        conns = list(self._uni.values())
        self._uni.clear()
        for conn in conns:
            conn.close()
        async def _wait(conn):
            try:
                # a dead peer's unflushed send buffer can defer teardown
                # until the kernel's TCP retransmission timeout; don't let
                # that hold up agent shutdown
                await asyncio.wait_for(conn.writer.wait_closed(), timeout=2.0)
            except (OSError, ConnectionError, asyncio.TimeoutError):
                pass

        if conns:
            await asyncio.gather(*(_wait(c) for c in conns))

    def drop(self, addr: Addr) -> None:
        conn = self._uni.pop(addr, None)
        if conn is not None:
            conn.close()
        self._drop_mux(addr)

    def close(self) -> None:
        for conn in self._uni.values():
            conn.close()
        self._uni.clear()
        for m in self._muxes.values():
            m.close()
        self._muxes.clear()
