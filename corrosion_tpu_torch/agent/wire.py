"""Wire codec: framed messages for gossip, SWIM and sync traffic.

What actually travels on each channel class (keep this current —
``tests/test_live_wire.py`` pins it at the byte level):

* **uni/bi streams (broadcasts + sync)** — speedy-encoded
  ``UniPayload``/``BiPayload`` frames with u32-BE length framing,
  byte-compatible with the reference
  (``crates/corro-types/src/broadcast.rs:37-67``); see
  ``bridge/speedy.py`` and ``runtime.py`` for the encode/decode call
  sites.  The JSON envelope in this module is NOT used on those
  streams.
* **SWIM datagrams (membership)** — binary foca messages
  (``bridge/foca.py`` + ``agent/swim_foca.py``), the wire the
  reference relays verbatim
  (``crates/corro-agent/src/broadcast/mod.rs:185-324``); this is the
  default (``AgentConfig.swim_wire == "foca"``).  The JSON envelope
  defined in this module remains the ``swim_wire="json"`` fallback,
  and receivers accept both formats (sniffed by first byte).

Message kinds:
  swim:     {kind, probe|ack|ping_req|gossip..., member entries}
  change:   one Changeset (full/empty/empty_set) from an actor
  sync_*:   sync session handshake/needs/changesets
"""

from __future__ import annotations

import base64
import json
import struct
from typing import List, Optional

from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq, Version
from corrosion_tpu_torch.types.change import Change
from corrosion_tpu_torch.types.changeset import Changeset, ChangesetKind, ChangeV1
from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.hlc import Timestamp

MAX_FRAME = 16 * 1024 * 1024


def _b64(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else base64.b64encode(b).decode("ascii")


def _unb64(s: Optional[str]) -> Optional[bytes]:
    return None if s is None else base64.b64decode(s)


def _enc_val(v):
    if isinstance(v, (bytes, bytearray, memoryview)):
        return {"__b": _b64(bytes(v))}
    return v


def _dec_val(v):
    if isinstance(v, dict) and "__b" in v:
        return _unb64(v["__b"])
    return v


def change_to_dict(ch: Change) -> dict:
    return {
        "t": ch.table,
        "pk": _b64(ch.pk),
        "c": ch.cid,
        "v": _enc_val(ch.val),
        "cv": ch.col_version,
        "dv": int(ch.db_version),
        "s": int(ch.seq),
        "si": _b64(ch.site_id),
        "cl": ch.cl,
    }


def change_from_dict(d: dict) -> Change:
    return Change(
        table=d["t"],
        pk=_unb64(d["pk"]),
        cid=d["c"],
        val=_dec_val(d["v"]),
        col_version=d["cv"],
        db_version=CrsqlDbVersion(d["dv"]),
        seq=CrsqlSeq(d["s"]),
        site_id=_unb64(d["si"]),
        cl=d["cl"],
    )


def changeset_to_dict(cs: Changeset) -> dict:
    d: dict = {"kind": cs.kind.value}
    if cs.ts is not None:
        d["ts"] = int(cs.ts)
    if cs.kind is ChangesetKind.FULL:
        d["version"] = int(cs.version)
        d["changes"] = [change_to_dict(c) for c in cs.changes]
        d["seqs"] = [int(cs.seqs[0]), int(cs.seqs[1])]
        d["last_seq"] = int(cs.last_seq)
    elif cs.kind is ChangesetKind.EMPTY:
        d["versions"] = [int(cs.versions[0]), int(cs.versions[1])]
    else:
        d["ranges"] = [[int(a), int(b)] for a, b in cs.ranges]
    return d


def changeset_from_dict(d: dict) -> Changeset:
    ts = Timestamp(d["ts"]) if "ts" in d else None
    kind = ChangesetKind(d["kind"])
    if kind is ChangesetKind.FULL:
        return Changeset.full(
            version=Version(d["version"]),
            changes=[change_from_dict(c) for c in d["changes"]],
            seqs=(CrsqlSeq(d["seqs"][0]), CrsqlSeq(d["seqs"][1])),
            last_seq=CrsqlSeq(d["last_seq"]),
            ts=ts,
        )
    if kind is ChangesetKind.EMPTY:
        return Changeset.empty(
            (Version(d["versions"][0]), Version(d["versions"][1])), ts
        )
    return Changeset.empty_set([tuple(r) for r in d.get("ranges", [])], ts)


def change_v1_to_dict(cv: ChangeV1) -> dict:
    return {"actor": _b64(cv.actor_id.bytes), "cs": changeset_to_dict(cv.changeset)}


def change_v1_from_dict(d: dict) -> ChangeV1:
    return ChangeV1(
        actor_id=ActorId(_unb64(d["actor"])),
        changeset=changeset_from_dict(d["cs"]),
    )


# ---------------------------------------------------------------------------
# partial-changeset buffer blobs (__corro_buffered_changes.change)
# ---------------------------------------------------------------------------

# Versioned binary format: one prefix byte, then the speedy Change
# layout (bridge/speedy.py encode_change).  Old databases hold JSON
# blobs from the legacy encoding (change_to_dict + encode_datagram);
# those start with '{' (0x7b, which can never be a known format prefix)
# and still decode on read — no migration pass required.
BUFFERED_BLOB_SPEEDY = 0x01


def encode_buffered_change(ch: Change) -> bytes:
    from corrosion_tpu_torch.bridge import speedy

    return bytes((BUFFERED_BLOB_SPEEDY,)) + speedy.encode_change(ch)


def decode_buffered_change(blob: bytes) -> Change:
    blob = bytes(blob)
    if blob[:1] == b"{":
        # legacy JSON blob written before the binary format
        return change_from_dict(decode_datagram(blob))
    if blob[:1] == bytes((BUFFERED_BLOB_SPEEDY,)):
        from corrosion_tpu_torch.bridge import speedy

        return speedy.decode_change(blob[1:])
    raise ValueError(
        f"unknown buffered-change blob format {blob[:1]!r}"
    )


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def encode_msg(msg: dict) -> bytes:
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(body)}")
    return struct.pack(">I", len(body)) + body


def decode_msg(body: bytes) -> dict:
    return json.loads(body.decode("utf-8"))


def encode_datagram(msg: dict) -> bytes:
    """Unframed (datagram) encoding for SWIM packets."""
    return json.dumps(msg, separators=(",", ":")).encode("utf-8")


def decode_datagram(data: bytes) -> dict:
    return json.loads(data.decode("utf-8"))


class FrameReader:
    """Incremental length-prefixed frame decoder for stream transports."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[dict]:
        self._buf += data
        out = []
        while True:
            if len(self._buf) < 4:
                return out
            (ln,) = struct.unpack_from(">I", self._buf, 0)
            if ln > MAX_FRAME:
                raise ValueError(f"frame too large: {ln}")
            if len(self._buf) < 4 + ln:
                return out
            body = bytes(self._buf[4 : 4 + ln])
            del self._buf[: 4 + ln]
            out.append(decode_msg(body))
