"""Single-connection channel multiplexing over TCP.

Parity: the reference carries all three channel classes of a peer pair
over ONE QUIC connection — datagrams, N uni streams, N bi streams —
with per-stream framing and stream-level stats
(``crates/corro-agent/src/transport.rs:55-173``,
``api/peer.rs:97-342``).  Datagrams stay on UDP here (they are
unreliable by design), but the reliable classes now share one cached
TCP connection per peer instead of one-connection-per-class: a ``M``
prelude byte, then mux frames

    [1B class][4B channel id][4B length][payload]

where class 0 is the uni broadcast channel (channel id 0, a
fire-and-forget payload stream), class 1 is client→server bi data,
class 2 is server→client bi data, and class 3 aborts a bi channel.
A bi channel opens implicitly at its first class-1 frame (the client
allocates ids), carries one sync session, half-closes with an empty
data frame (the EOF the sync protocol already speaks), and an abort
surfaces as a ConnectionResetError on the other side — NOT a clean
EOF, exactly the distinction ``_serve_sync``'s slow-peer abort needs.

Virtual streams adapt the mux to the existing sync code unchanged:
the reader side is a real ``asyncio.StreamReader`` fed by the demux
pump; :class:`VirtualWriter` provides the ``StreamWriter`` surface the
sync client/server use (write/drain/write_eof/close/transport.abort),
framing each drain under the connection's write lock so concurrent
channels never interleave mid-frame.

The client side also reproduces the reference's hashed-endpoint
spread (``transport.rs:55-93``: 8 client endpoints, peers assigned by
address hash): :func:`lane_of` maps a peer address onto one of
``LANES`` lanes, which shard the CONNECT concurrency (one semaphore
per lane) so a connect storm to many peers fans across lanes instead
of one queue — the TCP analogue of spreading peers over client
sockets (TCP gives every connection its own socket either way; the
connection cache itself is shared).

Flow control: channel readers are fed by the demux pump, and a
consumer slower than the network would otherwise buffer unboundedly
(and let the remote's ``drain()`` return instantly, defeating the
sync server's slow-peer abort).  The pump therefore STOPS reading the
socket while any channel's buffered backlog exceeds
``CHANNEL_BUF_CAP`` — whole-connection head-of-line blocking, like
TCP itself and unlike QUIC's per-stream windows, but it restores
end-to-end backpressure: a stalled consumer fills the kernel buffers
and the remote's drain genuinely blocks.
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
from typing import Callable, Dict, Optional, Tuple

Addr = Tuple[str, int]

STREAM_MUX = b"M"

CLASS_UNI = 0
CLASS_BI_C2S = 1
CLASS_BI_S2C = 2
CLASS_ABORT = 3

_HDR = struct.Struct(">BII")

# the reference runs 8 client endpoints (transport.rs:55-93)
LANES = 8

# per-channel receive backlog cap: past it the demux pauses the socket
CHANNEL_BUF_CAP = 1 << 20


class TombstoneSet:
    """Closed-channel ids with bounded memory that can never resurrect
    a ghost session.

    Channel ids are CLIENT-MONOTONIC within a connection, so the
    oldest tombstones are the smallest ids.  Eviction is oldest-first
    (insertion-order deque + set), and everything ever evicted stays
    dead via a watermark: ``ch in ts`` is true for any id at or below
    the highest evicted id.  The old ``list(set)[:4096]`` eviction
    discarded an ARBITRARY half — including the most recently closed
    ids, whose late in-flight frames would then reopen ghost sessions.

    The watermark makes membership monotone: a dropped tombstone can
    only widen the dead range, never shrink it.  Callers must check
    LIVE channels first — a long-lived channel whose id falls under
    the advancing watermark is still open and must keep working.
    """

    def __init__(self, cap: int = 8192):
        from collections import deque

        self.cap = cap
        self._set: set = set()
        self._order = deque()
        self._watermark = -1

    def add(self, ch: int) -> None:
        if ch in self:
            return
        self._set.add(ch)
        self._order.append(ch)
        while len(self._order) > self.cap:
            old = self._order.popleft()
            self._set.discard(old)
            if old > self._watermark:
                self._watermark = old

    def __contains__(self, ch: int) -> bool:
        return ch <= self._watermark or ch in self._set

    def __len__(self) -> int:
        return len(self._set)


def _backlog(reader: asyncio.StreamReader) -> int:
    """Buffered-but-unread bytes of a pump-fed reader.  StreamReader
    has no public backlog accessor when fed without a transport; the
    internal buffer attribute is stable across CPython versions."""
    buf = getattr(reader, "_buffer", b"")
    return len(buf)


# same invariant as the legacy speedy path (speedy.py MAX_FRAME_LEN):
# a hostile length prefix must not become an unbounded allocation
MAX_MUX_FRAME = 8 * 1024 * 1024


async def read_frames(reader: asyncio.StreamReader):
    """The one frame grammar for both sides: yields
    (class, channel, payload) until EOF/connection loss.  A frame
    claiming more than MAX_MUX_FRAME tears the connection down."""
    while True:
        hdr = await reader.readexactly(_HDR.size)
        cls, ch, ln = _HDR.unpack(hdr)
        if ln > MAX_MUX_FRAME:
            raise ConnectionResetError(
                f"mux frame length {ln} exceeds cap"
            )
        payload = await reader.readexactly(ln) if ln else b""
        yield cls, ch, payload


async def _pause_while_backlogged(channels, clock=None) -> None:
    if clock is None:
        from corrosion_tpu_torch.clock import SYSTEM_CLOCK as clock
    while any(
        _backlog(r) > CHANNEL_BUF_CAP for r in channels.values()
    ):
        await clock.sleep(0.01)


def lane_of(addr: Addr, lanes: int = LANES) -> int:
    """Peer-address → lane index (the endpoint-choice hash).  Stable
    across processes (no PYTHONHASHSEED dependence)."""
    h = hashlib.blake2s(
        f"{addr[0]}:{addr[1]}".encode(), digest_size=4
    ).digest()
    return int.from_bytes(h, "big") % lanes


def frame(cls: int, channel: int, payload: bytes) -> bytes:
    return _HDR.pack(cls, channel, len(payload)) + payload


class _AbortShim:
    """The ``writer.transport.abort()`` surface _serve_sync uses."""

    def __init__(self, vw: "VirtualWriter"):
        self._vw = vw

    def abort(self) -> None:
        self._vw.abort()


class VirtualWriter:
    """StreamWriter-shaped sender for one bi channel over a mux.

    Semantics map: ``write`` buffers; ``drain`` flushes one data frame;
    ``write_eof``/``close`` flush the tail + half-close frame WITHOUT a
    drain call (a real socket transmits those immediately too — the
    sync session loop relies on it); ``transport.abort()`` tears the
    channel down with an ABORT frame instead of a clean EOF."""

    def __init__(self, send_locked: Callable, channel: int, cls: int,
                 on_close: Optional[Callable] = None):
        self._send = send_locked  # async (bytes) -> None, lock-holding
        self.channel = channel
        self.cls = cls
        self._buf: list = []
        self._eof_sent = False
        self._aborted = False
        self._closed = False
        self._on_close = on_close
        self.transport = _AbortShim(self)

    def write(self, data: bytes) -> None:
        if data:
            self._buf.append(bytes(data))

    async def drain(self) -> None:
        if self._aborted:
            raise ConnectionResetError("channel aborted")
        if self._buf:
            payload = b"".join(self._buf)
            self._buf.clear()
            await self._send(frame(self.cls, self.channel, payload))

    def _flush_tail(self) -> None:
        """Schedule the remaining data + the half-close frame."""
        if self._eof_sent or self._aborted:
            return
        self._eof_sent = True
        data = b"".join(self._buf)
        self._buf = []

        async def _tail():
            try:
                if data:
                    await self._send(frame(self.cls, self.channel, data))
                await self._send(frame(self.cls, self.channel, b""))
            except (OSError, ConnectionError, RuntimeError):
                pass

        try:
            asyncio.ensure_future(_tail())
        except RuntimeError:  # no running loop (teardown)
            pass

    def can_write_eof(self) -> bool:
        return True

    def write_eof(self) -> None:
        self._flush_tail()

    def abort(self) -> None:
        if self._aborted:
            return
        self._aborted = True
        self._closed = True
        if self._on_close is not None:
            self._on_close(self.channel, abort=True)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._flush_tail()
        if self._on_close is not None:
            self._on_close(self.channel, abort=False)

    def is_closing(self) -> bool:
        return self._closed

    async def wait_closed(self) -> None:
        return


class MuxConnection:
    """Client side: one TCP connection carrying the uni channel plus
    any number of concurrent bi channels."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, metrics=None, clock=None):
        self.reader = reader
        self.writer = writer
        self.metrics = metrics
        self._clock = clock  # backpressure-poll time source (None = real)
        self.wlock = asyncio.Lock()
        self._channels: Dict[int, asyncio.StreamReader] = {}
        self._next_id = 1
        self.closed = False
        self._pump_task = asyncio.ensure_future(self._pump())

    # -- sending ---------------------------------------------------------

    async def _send_locked(self, data: bytes) -> None:
        if self.closed:
            raise ConnectionResetError("mux connection closed")
        async with self.wlock:
            self.writer.write(data)
            await self.writer.drain()

    async def send_uni(self, frames_blob: bytes) -> None:
        await self._send_locked(frame(CLASS_UNI, 0, frames_blob))
        if self.metrics is not None:
            self.metrics.counter(
                "corro_transport_bytes_total", len(frames_blob),
                channel="uni",
            )
            self.metrics.counter(
                "corro_transport_frames_total", channel="uni")

    def open_channel(self):
        """(reader, writer) for a fresh bi channel."""
        ch = self._next_id
        self._next_id += 1
        r = asyncio.StreamReader()
        self._channels[ch] = r

        def on_close(channel: int, abort: bool) -> None:
            self._channels.pop(channel, None)
            if abort and not self.closed:
                try:
                    coro = self._send_locked(
                        frame(CLASS_ABORT, channel, b"")
                    )
                    asyncio.ensure_future(coro)
                except RuntimeError:  # no loop (teardown)
                    pass

        async def send(data: bytes) -> None:
            await self._send_locked(data)
            if self.metrics is not None:
                self.metrics.counter(
                    "corro_transport_bytes_total", len(data) - _HDR.size,
                    channel="bi",
                )
                self.metrics.counter(
                    "corro_transport_frames_total", channel="bi")

        w = VirtualWriter(send, ch, CLASS_BI_C2S, on_close)
        if self.metrics is not None:
            self.metrics.counter("corro_transport_bi_channels_total")
        return r, w

    # -- receiving -------------------------------------------------------

    async def _pump(self) -> None:
        try:
            async for cls, ch, payload in read_frames(self.reader):
                await _pause_while_backlogged(self._channels,
                                              clock=self._clock)
                if cls == CLASS_BI_S2C:
                    r = self._channels.get(ch)
                    if r is None:
                        continue
                    if not payload:
                        r.feed_eof()
                    else:
                        r.feed_data(payload)
                elif cls == CLASS_ABORT:
                    r = self._channels.pop(ch, None)
                    if r is not None:
                        r.set_exception(
                            ConnectionResetError("peer aborted channel")
                        )
                # CLASS_UNI toward a client is not part of the protocol
        except (asyncio.IncompleteReadError, OSError, ConnectionError,
                asyncio.CancelledError):
            pass
        finally:
            self.closed = True
            for r in self._channels.values():
                if not r.at_eof():
                    r.set_exception(
                        ConnectionResetError("mux connection lost")
                    )
            self._channels.clear()
            try:
                self.writer.close()
            except Exception:
                pass

    def close(self) -> None:
        self.closed = True
        self._pump_task.cancel()
        try:
            self.writer.close()
        except Exception:
            pass


async def serve_mux(agent, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
    """Server side: demux one inbound mux connection.

    Class-0 frames feed the broadcast ingest exactly like a dedicated
    uni stream; each new class-1 channel id becomes one sync session
    served by the UNCHANGED ``_serve_sync`` over virtual streams."""
    from corrosion_tpu_torch.bridge import speedy

    uni_frames = speedy.FrameReader()
    # the delivering transport's address, carried with each uni
    # payload so a failed origin signature can blame the delivery
    # (runtime._blame_relay, docs/faults.md signed attribution)
    mux_peer = writer.get_extra_info("peername")
    if mux_peer is not None:
        mux_peer = tuple(mux_peer[:2])
    wlock = asyncio.Lock()
    channels: Dict[int, asyncio.StreamReader] = {}
    tasks: Dict[int, asyncio.Task] = {}
    closed = False

    async def send_locked(data: bytes) -> None:
        if closed:
            raise ConnectionResetError("mux connection closed")
        async with wlock:
            writer.write(data)
            await writer.drain()

    def open_server_channel(ch: int) -> asyncio.StreamReader:
        r = asyncio.StreamReader()
        channels[ch] = r

        def on_close(channel: int, abort: bool) -> None:
            channels.pop(channel, None)
            tombstones.add(channel)
            if abort and not closed:
                try:
                    asyncio.ensure_future(
                        send_locked(frame(CLASS_ABORT, channel, b""))
                    )
                except RuntimeError:
                    pass

        async def send(data: bytes) -> None:
            await send_locked(data)
            if agent.metrics is not None:
                agent.metrics.counter(
                    "corro_transport_bytes_total",
                    len(data) - _HDR.size, channel="bi",
                )

        vw = VirtualWriter(send, ch, CLASS_BI_S2C, on_close)

        async def run_session():
            try:
                await agent._serve_sync(r, vw)
            finally:
                # _serve_sync close()s (or aborts) the writer, which
                # flushes the tail + half-close the client's session
                # loop is waiting on; this is only the belt-and-braces
                # for exits that skipped close()
                vw.close()
                tasks.pop(ch, None)

        tasks[ch] = asyncio.ensure_future(run_session())
        return r

    # ids whose server side already closed/aborted: late in-flight
    # client frames for them are DROPPED, not resurrected as ghost
    # sessions (oldest-first eviction + a dead-range watermark on the
    # client-monotonic ids — see TombstoneSet)
    tombstones = TombstoneSet()
    try:
        async for cls, ch, payload in read_frames(reader):
            await _pause_while_backlogged(
                channels, clock=getattr(agent, "_clock", None)
            )
            if cls == CLASS_UNI:
                agent._ingest_uni_payloads(
                    uni_frames.feed(payload), mux_peer
                )
                if agent.metrics is not None:
                    agent.metrics.counter(
                        "corro_transport_frames_total", channel="uni")
            elif cls == CLASS_BI_C2S:
                # LIVE channels first: an old id still open must keep
                # working even under the advancing watermark
                r = channels.get(ch)
                if r is None:
                    if ch in tombstones:
                        continue
                    r = open_server_channel(ch)
                if not payload:
                    r.feed_eof()
                else:
                    r.feed_data(payload)
            elif cls == CLASS_ABORT:
                tombstones.add(ch)
                r = channels.pop(ch, None)
                if r is not None:
                    r.set_exception(
                        ConnectionResetError("client aborted channel")
                    )
    except (asyncio.IncompleteReadError, OSError, ConnectionError):
        pass
    finally:
        closed = True
        for r in channels.values():
            if not r.at_eof():
                r.set_exception(ConnectionResetError("mux lost"))
        for t in list(tasks.values()):
            t.cancel()
        writer.close()
