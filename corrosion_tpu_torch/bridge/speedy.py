"""speedy-compatible binary codec for the reference agent's wire types.

The reference serializes every gossip/sync message with the Rust `speedy`
crate (corro-speedy 0.8.7 fork) and frames streams with tokio's
``LengthDelimitedCodec``.  This module re-implements that byte format in
Python so our agent/simulator can exchange and diff traces with real
corrosion agents.

Layout rules (speedy 0.8, little-endian context — the default used by the
reference's ``read_from_buffer``/``write_to_buffer`` call sites):

* fixed-width integers/floats: little-endian;
* ``Vec<T>`` / ``String`` / ``&str`` / ``SmallVec<u8>``: ``u32`` length
  prefix + elements;
* ``Option<T>``: ``u8`` 1/0 then the value;
* ``HashMap<K, V>``: ``u32`` length + key/value pairs;
* ``RangeInclusive<T>``: start value then end value;
* ``[u8; 16]`` / ``Uuid``: 16 raw bytes, no length;
* derived enums: ``u32`` variant index in declaration order;
* ``#[speedy(default_on_eof)]`` fields: omitted-at-EOF ⇒ default on read;
* newtypes (``Version``/``CrsqlDbVersion``/``CrsqlSeq`` = u64,
  ``ClusterId`` = u16, ``Timestamp`` = NTP64 u64): the inner value.

Type definitions mirrored (field order is the wire order):
``ChangeV1``/``Changeset`` (broadcast.rs:104-137), ``UniPayload``/
``BiPayload`` (broadcast.rs:37-67), ``Change`` (change.rs:19-29),
``SqliteValue`` (corro-api-types/src/lib.rs:421-428,614-679 — manual
impl: u8 tag), ``SyncMessage``/``SyncStateV1``/``SyncNeedV1``/
``SyncRejectionV1`` (sync.rs:18-263), ``SyncTraceContextV1``
(sync.rs:32-36), ``ActorId`` (actor.rs:91-119, raw uuid bytes),
``Timestamp`` (broadcast.rs:363-391, u64), ``TableName``/``ColumnName``
(corro-api-types:780-856, string).

Stream framing: ``LengthDelimitedCodec`` defaults — ``u32`` BIG-endian
length prefix (tokio_util), used for uni-stream broadcasts and sync
bi-streams.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.types.actor import ActorId, ClusterId
from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq, Version
from corrosion_tpu_torch.types.change import Change
from corrosion_tpu_torch.types.changeset import Changeset, ChangesetKind, ChangeV1
from corrosion_tpu_torch.types.hlc import Timestamp
from corrosion_tpu_torch.types.payload import (
    BiPayload,
    BroadcastV1,
    SyncNeedV1,
    SyncStateV1,
    UniPayload,
)


class SpeedyError(ValueError):
    pass


def _load_native():
    from corrosion_tpu_torch.native import load_or_none

    return load_or_none()


# the C extension, gated per feature so a stale build missing newer
# entry points falls back to the Python twin for just those paths
_native_mod = _load_native()
_native = (
    _native_mod
    if _native_mod is not None
    and hasattr(_native_mod, "speedy_encode_changes")
    and hasattr(_native_mod, "speedy_decode_changes")
    else None
)


# ---------------------------------------------------------------------------
# primitive writer/reader
# ---------------------------------------------------------------------------


class Writer:
    def __init__(self):
        self._parts: List[bytes] = []

    def _pack(self, fmt: str, v) -> "Writer":
        # error-type parity with the native path: out-of-range or
        # wrong-typed values raise SpeedyError on both encoders
        try:
            self._parts.append(struct.pack(fmt, v))
        except (struct.error, TypeError, OverflowError, ValueError) as e:
            raise SpeedyError(f"cannot encode {v!r} as {fmt}: {e}") from e
        return self

    def u8(self, v: int) -> "Writer":
        return self._pack("<B", v)

    def u16(self, v: int) -> "Writer":
        return self._pack("<H", v)

    def u32(self, v: int) -> "Writer":
        return self._pack("<I", v)

    def u64(self, v: int) -> "Writer":
        try:
            v = int(v)
        except (TypeError, ValueError) as e:
            raise SpeedyError(f"cannot encode {v!r} as u64: {e}") from e
        return self._pack("<Q", v)

    def i64(self, v: int) -> "Writer":
        try:
            v = int(v)
        except (TypeError, ValueError) as e:
            raise SpeedyError(f"cannot encode {v!r} as i64: {e}") from e
        return self._pack("<q", v)

    def f64(self, v: float) -> "Writer":
        return self._pack("<d", v)

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(bytes(b))
        return self

    def lp_bytes(self, b: bytes) -> "Writer":
        """u32-length-prefixed bytes (Vec<u8>/String/str)."""
        self.u32(len(b))
        return self.raw(b)

    def s(self, text: str) -> "Writer":
        return self.lp_bytes(text.encode("utf-8"))

    def tag(self, index: int) -> "Writer":
        """Derived-enum variant tag."""
        return self.u32(index)

    def opt(self, v, write_fn) -> "Writer":
        if v is None:
            return self.u8(0)
        self.u8(1)
        write_fn(v)
        return self

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = bytes(data)
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SpeedyError(
                f"unexpected EOF at {self.pos}+{n} of {len(self.data)}"
            )
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def lp_bytes(self) -> bytes:
        return self._take(self.u32())

    def s(self) -> str:
        return self.lp_bytes().decode("utf-8")

    def tag(self) -> int:
        return self.u32()

    def opt(self, read_fn):
        return read_fn() if self.u8() else None

    def expect_end(self) -> None:
        if not self.eof:
            raise SpeedyError(f"{len(self.data) - self.pos} trailing bytes")


# ---------------------------------------------------------------------------
# leaf types
# ---------------------------------------------------------------------------


def _w_actor(w: Writer, a: ActorId) -> None:
    w.raw(a.bytes)


def _r_actor(r: Reader) -> ActorId:
    return ActorId(r.raw(16))


def _w_ts(w: Writer, ts: Timestamp) -> None:
    w.u64(int(ts))


def _r_ts(r: Reader) -> Timestamp:
    return Timestamp(r.u64())


def _w_value(w: Writer, v) -> None:
    """SqliteValue: u8 tag 0..4 (Null/Integer/Real/Text/Blob)."""
    if v is None:
        w.u8(0)
    elif isinstance(v, bool):
        w.u8(1).i64(int(v))
    elif isinstance(v, int):
        w.u8(1).i64(v)
    elif isinstance(v, float):
        w.u8(2).f64(v)
    elif isinstance(v, str):
        w.u8(3).s(v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        w.u8(4).lp_bytes(bytes(v))
    else:
        raise SpeedyError(f"unsupported SqliteValue: {type(v)!r}")


def _r_value(r: Reader):
    t = r.u8()
    if t == 0:
        return None
    if t == 1:
        return r.i64()
    if t == 2:
        return r.f64()
    if t == 3:
        return r.s()
    if t == 4:
        return r.lp_bytes()
    raise SpeedyError(f"unknown SqliteValue variant {t}")


def _w_change(w: Writer, c: Change) -> None:
    w.s(c.table)
    w.lp_bytes(c.pk)
    w.s(c.cid)
    _w_value(w, c.val)
    w.i64(c.col_version)
    w.u64(int(c.db_version))
    w.u64(int(c.seq))
    w.raw(c.site_id)
    w.i64(c.cl)


def _r_change(r: Reader) -> Change:
    return Change(
        table=r.s(),
        pk=r.lp_bytes(),
        cid=r.s(),
        val=_r_value(r),
        col_version=r.i64(),
        db_version=CrsqlDbVersion(r.u64()),
        seq=CrsqlSeq(r.u64()),
        site_id=r.raw(16),
        cl=r.i64(),
    )


def encode_change(c: Change) -> bytes:
    """One Change in the speedy layout (the partial-buffer blob body)."""
    w = Writer()
    _w_change(w, c)
    return w.getvalue()


def decode_change(data: bytes) -> Change:
    """Inverse of :func:`encode_change`; raises SpeedyError on junk or
    trailing bytes."""
    r = Reader(data)
    c = _r_change(r)
    r.expect_end()
    return c


# ---------------------------------------------------------------------------
# Changeset / ChangeV1 / UniPayload / BiPayload
# ---------------------------------------------------------------------------

_CS_EMPTY, _CS_FULL, _CS_EMPTY_SET = 0, 1, 2


def _w_changes(w: Writer, changes) -> None:
    """The change-array hot loop: native when available (the C
    extension packs the speedy layout directly), Python twin otherwise."""
    if _native is not None:
        try:
            w.raw(_native.speedy_encode_changes(changes))
        except (TypeError, OverflowError) as e:
            # error-type parity with the Python twin's SpeedyError
            raise SpeedyError(str(e)) from None
        return
    for c in changes:
        _w_change(w, c)


def _r_changes(r: Reader, count: int) -> List[Change]:
    if _native is not None:
        try:
            tups, end = _native.speedy_decode_changes(r.data, r.pos, count)
        except ValueError as e:
            raise SpeedyError(str(e)) from None
        r.pos = end
        return [
            Change(
                table=t, pk=pk, cid=cid, val=val, col_version=cv,
                db_version=CrsqlDbVersion(dv), seq=CrsqlSeq(sq),
                site_id=site, cl=cl,
            )
            for t, pk, cid, val, cv, dv, sq, site, cl in tups
        ]
    return [_r_change(r) for _ in range(count)]


def _w_changeset(w: Writer, cs: Changeset) -> None:
    if cs.kind is ChangesetKind.EMPTY:
        w.tag(_CS_EMPTY)
        w.u64(int(cs.versions[0])).u64(int(cs.versions[1]))
        w.opt(cs.ts, lambda ts: _w_ts(w, ts))
    elif cs.kind is ChangesetKind.FULL:
        w.tag(_CS_FULL)
        w.u64(int(cs.version))
        w.u32(len(cs.changes))
        _w_changes(w, cs.changes)
        w.u64(int(cs.seqs[0])).u64(int(cs.seqs[1]))
        w.u64(int(cs.last_seq))
        _w_ts(w, cs.ts)
    else:
        w.tag(_CS_EMPTY_SET)
        w.u32(len(cs.ranges))
        for s, e in cs.ranges:
            w.u64(int(s)).u64(int(e))
        _w_ts(w, cs.ts)


def _r_changeset(r: Reader) -> Changeset:
    t = r.tag()
    if t == _CS_EMPTY:
        versions = (Version(r.u64()), Version(r.u64()))
        # `ts` is #[speedy(default_on_eof)]
        ts = None if r.eof else r.opt(lambda: _r_ts(r))
        return Changeset.empty(versions, ts)
    if t == _CS_FULL:
        version = Version(r.u64())
        changes = _r_changes(r, r.u32())
        seqs = (CrsqlSeq(r.u64()), CrsqlSeq(r.u64()))
        last_seq = CrsqlSeq(r.u64())
        ts = _r_ts(r)
        return Changeset.full(version, changes, seqs, last_seq, ts)
    if t == _CS_EMPTY_SET:
        ranges = [
            (Version(r.u64()), Version(r.u64())) for _ in range(r.u32())
        ]
        ts = _r_ts(r)
        return Changeset.empty_set(ranges, ts)
    raise SpeedyError(f"unknown Changeset variant {t}")


def _w_change_v1(w: Writer, cv: ChangeV1) -> None:
    _w_actor(w, cv.actor_id)
    _w_changeset(w, cv.changeset)


def _r_change_v1(r: Reader) -> ChangeV1:
    return ChangeV1(actor_id=_r_actor(r), changeset=_r_changeset(r))


def encode_uni_payload(p: UniPayload) -> bytes:
    """UniPayload::V1 { data: UniPayloadV1::Broadcast(BroadcastV1::Change),
    cluster_id (default_on_eof) }."""
    w = Writer()
    w.tag(0)  # UniPayload::V1
    w.tag(0)  # UniPayloadV1::Broadcast
    w.tag(0)  # BroadcastV1::Change
    _w_change_v1(w, p.broadcast.change)
    w.u16(int(p.cluster_id))
    return w.getvalue()


def decode_uni_payload(data: bytes) -> UniPayload:
    r = Reader(data)
    if r.tag() != 0:
        raise SpeedyError("unknown UniPayload variant")
    if r.tag() != 0:
        raise SpeedyError("unknown UniPayloadV1 variant")
    if r.tag() != 0:
        raise SpeedyError("unknown BroadcastV1 variant")
    change = _r_change_v1(r)
    cluster_id = ClusterId(0) if r.eof else ClusterId(r.u16())
    r.expect_end()
    return UniPayload(broadcast=BroadcastV1(change=change), cluster_id=cluster_id)


# -- traced uni envelope (versioned extension) -------------------------
#
# Broadcast-path trace propagation (docs/telemetry.md): a 1-byte
# version prefix ahead of the classic UniPayload bytes, mirroring the
# partial-buffer blob versioning — the classic payload's first byte is
# 0x00 (the u32-LE UniPayload::V1 tag), so 0x01 unambiguously marks the
# extended format and OLD-FORMAT PAYLOADS DECODE UNCHANGED.  Body:
#
#   u8 version (=1) | u8 hop | Option<String> traceparent | UniPayload
#
# ``hop`` counts rebroadcast generations (0 = the origin's own
# transmission), letting receivers label provenance lag broadcast vs
# rebroadcast; ``traceparent`` re-parents the remote apply span on the
# origin's write-group trace.  Emission is gated by
# ``AgentConfig.bcast_trace_propagation`` — turn it off for
# reference-byte-exact wire output (receivers accept both regardless).

TRACED_UNI_VERSION = 1
# signed attribution envelope (docs/faults.md): the traced layout plus
# one more Option field — a raw 64-byte Ed25519 signature over the
# changeset's canonical identity (types/crypto.py; the signing message
# is built by agent/runtime.py sig_message).  Emitted only when the
# origin is configured with a signing key, so an unsigned deployment's
# wire stays byte-exact vs the v0/v1 formats.
SIGNED_UNI_VERSION = 2
SIG_BYTES = 64
# traceparent is 55 chars; anything longer is junk, reject before it
# can bloat frames or the span ring
MAX_TRACEPARENT_LEN = 64


def encode_traced_uni(payload: bytes, traceparent: Optional[str] = None,
                      hop: int = 0) -> bytes:
    """Wrap classic UniPayload bytes in the traced envelope."""
    w = Writer()
    w.u8(TRACED_UNI_VERSION)
    w.u8(min(max(int(hop), 0), 255))
    w.opt(traceparent, w.s)
    w.raw(payload)
    return w.getvalue()


def encode_signed_uni(payload: bytes, traceparent: Optional[str] = None,
                      hop: int = 0, sig: Optional[bytes] = None) -> bytes:
    """Wrap classic UniPayload bytes in the SIGNED envelope (v2):
    ``u8 2 | u8 hop | Option<traceparent> | Option<[u8;64] sig> |
    UniPayload``.  ``sig`` rides as 64 raw bytes (speedy ``[u8; N]``
    layout, no length prefix)."""
    if sig is not None and len(sig) != SIG_BYTES:
        raise SpeedyError(
            f"signature must be {SIG_BYTES} bytes, got {len(sig)}"
        )
    w = Writer()
    w.u8(SIGNED_UNI_VERSION)
    w.u8(min(max(int(hop), 0), 255))
    w.opt(traceparent, w.s)
    w.opt(sig, w.raw)
    w.raw(payload)
    return w.getvalue()


def _read_traceparent(r: Reader) -> Optional[str]:
    # strict Option tag, matching traced_uni_payload_start: the walker
    # and the decoder must accept the SAME byte set or the live path's
    # prelude screen and the det scheduler diverge on hostile frames
    flag = r.u8()
    if flag == 0:
        return None
    if flag != 1:
        raise SpeedyError(f"bad Option tag {flag}")
    # bound in BYTES (the u32 length prefix), exactly like
    # traced_uni_payload_start — bounding the decoded char count
    # instead would let a multi-byte-UTF-8 traceparent pass here
    # while the walker rejects the same frame, and live ingest
    # (which screens via the walker) would diverge from the det
    # scheduler on identical bytes
    raw = r.lp_bytes()
    if len(raw) > MAX_TRACEPARENT_LEN:
        raise SpeedyError("oversized traceparent")
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        # keep the SpeedyError contract: a raw UnicodeDecodeError
        # would escape callers' `except SpeedyError` handling
        raise SpeedyError(f"invalid traceparent utf-8: {e}") from None


def decode_uni_envelope(
    data: bytes,
) -> Tuple[bytes, Optional[str], int, Optional[bytes]]:
    """``(classic_payload, traceparent, hop, sig)`` from any wire
    format: classic (0x00), traced (0x01) or signed (0x02).  Unknown
    envelope versions raise SpeedyError."""
    if not data:
        raise SpeedyError("empty uni payload")
    if data[0] == 0:
        return data, None, 0, None
    if data[0] not in (TRACED_UNI_VERSION, SIGNED_UNI_VERSION):
        raise SpeedyError(f"unknown traced-uni version {data[0]}")
    r = Reader(data, pos=1)
    hop = r.u8()
    tp = _read_traceparent(r)
    sig = None
    if data[0] == SIGNED_UNI_VERSION:
        flag = r.u8()
        if flag == 1:
            sig = r.raw(SIG_BYTES)
        elif flag != 0:
            raise SpeedyError(f"bad Option tag {flag}")
    return data[r.pos:], tp, hop, sig


def decode_traced_uni(data: bytes) -> Tuple[bytes, Optional[str], int]:
    """``(classic_payload, traceparent, hop)`` from any wire format —
    the pre-signing surface, kept for callers that don't carry the
    signature (the signature, if any, is dropped)."""
    payload, tp, hop, _sig = decode_uni_envelope(data)
    return payload, tp, hop


def traced_uni_payload_start(data: bytes, off: int = 0) -> int:
    """Offset of the classic UniPayload bytes inside ``data`` — the
    cheap event-loop-side check (no string decode, no change decode)
    that lets the ingest queue's 12-byte tag prelude screen work on
    every wire format (classic/traced/signed).  Raises SpeedyError on
    a malformed envelope."""
    if off >= len(data):
        raise SpeedyError("empty uni payload")
    version = data[off]
    if version == 0:
        return off
    if version not in (TRACED_UNI_VERSION, SIGNED_UNI_VERSION):
        raise SpeedyError(f"unknown traced-uni version {version}")
    pos = off + 2  # version + hop
    if pos >= len(data):
        raise SpeedyError("truncated traced-uni envelope")
    flag = data[pos]
    pos += 1
    if flag == 1:
        if pos + 4 > len(data):
            raise SpeedyError("truncated traceparent length")
        (n,) = struct.unpack_from("<I", data, pos)
        if n > MAX_TRACEPARENT_LEN:
            raise SpeedyError("oversized traceparent")
        pos += 4 + n
    elif flag != 0:
        raise SpeedyError(f"bad Option tag {flag}")
    if version == SIGNED_UNI_VERSION:
        if pos >= len(data):
            raise SpeedyError("truncated signed-uni envelope")
        flag = data[pos]
        pos += 1
        if flag == 1:
            if pos + SIG_BYTES > len(data):
                raise SpeedyError("truncated signature")
            pos += SIG_BYTES
        elif flag != 0:
            raise SpeedyError(f"bad Option tag {flag}")
    return pos


def encode_bi_payload(p: BiPayload, cluster_id: ClusterId = ClusterId(0)) -> bytes:
    """BiPayload::V1 { data: BiPayloadV1::SyncStart { actor_id, trace_ctx },
    cluster_id }."""
    w = Writer()
    w.tag(0)  # BiPayload::V1
    w.tag(0)  # BiPayloadV1::SyncStart
    _w_actor(w, p.actor_id)
    trace = p.trace_ctx or {}
    w.opt(trace.get("traceparent"), w.s)
    w.opt(trace.get("tracestate"), w.s)
    w.u16(int(cluster_id))
    return w.getvalue()


def decode_bi_payload(data: bytes) -> Tuple[BiPayload, ClusterId]:
    r = Reader(data)
    if r.tag() != 0:
        raise SpeedyError("unknown BiPayload variant")
    if r.tag() != 0:
        raise SpeedyError("unknown BiPayloadV1 variant")
    actor = _r_actor(r)
    # trace_ctx is default_on_eof as a whole struct
    trace: Optional[dict] = None
    if not r.eof:
        tp = r.opt(r.s)
        ts_ = r.opt(r.s)
        if tp or ts_:
            trace = {}
            if tp:
                trace["traceparent"] = tp
            if ts_:
                trace["tracestate"] = ts_
    cluster_id = ClusterId(0) if r.eof else ClusterId(r.u16())
    r.expect_end()
    return BiPayload(actor_id=actor, trace_ctx=trace), cluster_id


# ---------------------------------------------------------------------------
# Sync messages
# ---------------------------------------------------------------------------

_SN_FULL, _SN_PARTIAL, _SN_EMPTY = 0, 1, 2


def _w_need(w: Writer, n: SyncNeedV1) -> None:
    if n.kind == "full":
        w.tag(_SN_FULL)
        w.u64(n.versions[0]).u64(n.versions[1])
    elif n.kind == "partial":
        w.tag(_SN_PARTIAL)
        w.u64(int(n.version))
        w.u32(len(n.seqs))
        for s, e in n.seqs:
            w.u64(s).u64(e)
    else:
        w.tag(_SN_EMPTY)
        w.opt(n.ts, lambda ts: _w_ts(w, ts))


def _span(r: Reader) -> Tuple[int, int]:
    s, e = r.u64(), r.u64()
    if e < s:
        raise SpeedyError(f"inverted range {s}..={e}")
    return s, e


def _r_need(r: Reader) -> SyncNeedV1:
    t = r.tag()
    if t == _SN_FULL:
        return SyncNeedV1.full(*_span(r))
    if t == _SN_PARTIAL:
        version = r.u64()
        seqs = [_span(r) for _ in range(r.u32())]
        return SyncNeedV1.partial(version, seqs)
    if t == _SN_EMPTY:
        return SyncNeedV1.empty(r.opt(lambda: _r_ts(r)))
    raise SpeedyError(f"unknown SyncNeedV1 variant {t}")


def _w_sync_state(w: Writer, st: SyncStateV1) -> None:
    _w_actor(w, st.actor_id)
    w.u32(len(st.heads))
    for actor, head in st.heads.items():
        _w_actor(w, actor)
        w.u64(int(head))
    w.u32(len(st.need))
    for actor, spans in st.need.items():
        _w_actor(w, actor)
        w.u32(len(spans))
        for s, e in spans:
            w.u64(s).u64(e)
    w.u32(len(st.partial_need))
    for actor, partials in st.partial_need.items():
        _w_actor(w, actor)
        w.u32(len(partials))
        for version, spans in partials.items():
            w.u64(int(version))
            w.u32(len(spans))
            for s, e in spans:
                w.u64(s).u64(e)
    w.opt(st.last_cleared_ts, lambda ts: _w_ts(w, ts))
    # snapshot-serve extension (docs/sync.md): trailing floors map,
    # written ONLY when non-empty — a floor-less state emits the
    # pre-snapshot bytes exactly (same default_on_eof discipline as
    # last_cleared_ts before it)
    if st.snap_floors:
        w.u32(len(st.snap_floors))
        for actor, floor in st.snap_floors.items():
            _w_actor(w, actor)
            w.u64(int(floor))


def _r_sync_state(r: Reader) -> SyncStateV1:
    actor = _r_actor(r)
    heads = {}
    for _ in range(r.u32()):
        a = _r_actor(r)
        heads[a] = Version(r.u64())
    need: Dict[ActorId, List[Tuple[int, int]]] = {}
    for _ in range(r.u32()):
        a = _r_actor(r)
        need[a] = [_span(r) for _ in range(r.u32())]
    partial_need: Dict[ActorId, Dict[Version, List[Tuple[int, int]]]] = {}
    for _ in range(r.u32()):
        a = _r_actor(r)
        partials = {}
        for _ in range(r.u32()):
            v = Version(r.u64())
            partials[v] = [_span(r) for _ in range(r.u32())]
        partial_need[a] = partials
    last_cleared_ts = None if r.eof else r.opt(lambda: _r_ts(r))
    snap_floors: Dict[ActorId, int] = {}
    if not r.eof:
        for _ in range(r.u32()):
            a = _r_actor(r)
            snap_floors[a] = r.u64()
    return SyncStateV1(
        actor_id=actor,
        heads=heads,
        need=need,
        partial_need=partial_need,
        last_cleared_ts=last_cleared_ts,
        snap_floors=snap_floors,
    )


# SyncMessageV1 variant indices (sync.rs:23-30)
_SM_STATE, _SM_CHANGESET, _SM_CLOCK, _SM_REJECTION, _SM_REQUEST = range(5)

# snapshot-serve extension variants (docs/sync.md): a client whose
# needs fall below the server's advertised snapshot floors requests a
# whole-database snapshot instead of change-by-change serving.  The
# variants extend the enum PAST the reference's tags, so a session
# that never dispatches snapshot emits the reference's exact bytes.
_SM_SNAP_REQUEST, _SM_SNAP_OFFER, _SM_SNAP_CHUNK, _SM_SNAP_DONE = range(5, 9)

#: whole-snapshot content digest length (blake2b-32) carried by offers
SNAP_DIGEST_LEN = 32

# SyncRejectionV1 variant indices (sync.rs:251-257)
REJECTION_MAX_CONCURRENCY = 0
REJECTION_DIFFERENT_CLUSTER = 1

SyncRequest = List[Tuple[ActorId, List[SyncNeedV1]]]


def encode_sync_message(msg) -> bytes:
    """msg is one of: SyncStateV1 | ChangeV1 | Timestamp |
    ("rejection", int) | ("request", SyncRequest) |
    ("snap_request",) | ("snap_offer", digest32, size) |
    ("snap_chunk", bytes) | ("snap_done",)."""
    w = Writer()
    w.tag(0)  # SyncMessage::V1
    if isinstance(msg, SyncStateV1):
        w.tag(_SM_STATE)
        _w_sync_state(w, msg)
    elif isinstance(msg, ChangeV1):
        w.tag(_SM_CHANGESET)
        _w_change_v1(w, msg)
    elif isinstance(msg, Timestamp):
        w.tag(_SM_CLOCK)
        _w_ts(w, msg)
    elif isinstance(msg, tuple) and msg[0] == "rejection":
        w.tag(_SM_REJECTION)
        w.tag(msg[1])
    elif isinstance(msg, tuple) and msg[0] == "request":
        w.tag(_SM_REQUEST)
        w.u32(len(msg[1]))
        for actor, needs in msg[1]:
            _w_actor(w, actor)
            w.u32(len(needs))
            for n in needs:
                _w_need(w, n)
    elif isinstance(msg, tuple) and msg[0] == "snap_request":
        w.tag(_SM_SNAP_REQUEST)
    elif isinstance(msg, tuple) and msg[0] == "snap_offer":
        digest, size = msg[1], msg[2]
        if len(digest) != SNAP_DIGEST_LEN:
            raise SpeedyError(
                f"snapshot digest must be {SNAP_DIGEST_LEN} bytes"
            )
        w.tag(_SM_SNAP_OFFER)
        w.raw(bytes(digest))
        w.u64(int(size))
    elif isinstance(msg, tuple) and msg[0] == "snap_chunk":
        w.tag(_SM_SNAP_CHUNK)
        w.lp_bytes(bytes(msg[1]))
    elif isinstance(msg, tuple) and msg[0] == "snap_done":
        w.tag(_SM_SNAP_DONE)
    else:
        raise SpeedyError(f"cannot encode sync message {type(msg)!r}")
    return w.getvalue()


def decode_sync_message(data: bytes):
    r = Reader(data)
    if r.tag() != 0:
        raise SpeedyError("unknown SyncMessage variant")
    t = r.tag()
    if t == _SM_STATE:
        out = _r_sync_state(r)
    elif t == _SM_CHANGESET:
        out = _r_change_v1(r)
    elif t == _SM_CLOCK:
        out = _r_ts(r)
    elif t == _SM_REJECTION:
        out = ("rejection", r.tag())
    elif t == _SM_REQUEST:
        req: SyncRequest = []
        for _ in range(r.u32()):
            actor = _r_actor(r)
            req.append((actor, [_r_need(r) for _ in range(r.u32())]))
        out = ("request", req)
    elif t == _SM_SNAP_REQUEST:
        out = ("snap_request",)
    elif t == _SM_SNAP_OFFER:
        out = ("snap_offer", r.raw(SNAP_DIGEST_LEN), r.u64())
    elif t == _SM_SNAP_CHUNK:
        out = ("snap_chunk", r.lp_bytes())
    elif t == _SM_SNAP_DONE:
        out = ("snap_done",)
    else:
        raise SpeedyError(f"unknown SyncMessageV1 variant {t}")
    r.expect_end()
    return out


# ---------------------------------------------------------------------------
# LengthDelimitedCodec framing (u32 big-endian, tokio_util default)
# ---------------------------------------------------------------------------

MAX_FRAME_LEN = 8 * 1024 * 1024


def frame(payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + payload


def _py_deframe(buf: bytes) -> Tuple[List[bytes], bytes]:
    """Split complete frames off the front; return (frames, remainder)."""
    frames = []
    pos = 0
    while pos + 4 <= len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        if n > MAX_FRAME_LEN:
            raise SpeedyError(f"frame length {n} exceeds max {MAX_FRAME_LEN}")
        if pos + 4 + n > len(buf):
            break
        frames.append(buf[pos + 4 : pos + 4 + n])
        pos += 4 + n
    return frames, buf[pos:]


if _native_mod is not None and hasattr(_native_mod, "deframe"):
    def deframe(buf: bytes) -> Tuple[List[bytes], bytes]:
        """Native frame splitter (semantics pinned to :func:`_py_deframe`)."""
        try:
            return _native_mod.deframe(buf, MAX_FRAME_LEN)
        except ValueError as e:
            raise SpeedyError(str(e)) from None
else:
    deframe = _py_deframe


class FrameReader:
    """Incremental LengthDelimited deframer for stream transports:
    feed() raw bytes, get back complete frame payloads."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        frames, rest = deframe(bytes(self._buf))
        self._buf = bytearray(rest)
        return frames
