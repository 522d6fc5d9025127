"""Minimal distributed tracing with cross-node propagation.

Parity: the reference attaches a W3C ``traceparent`` to the sync
handshake (``crates/corro-types/src/sync.rs:32-67`` SyncTraceContextV1)
and re-parents the server's span on it (``api/peer.rs`` serve_sync /
parallel_sync).  This is the same propagation with a deliberately small
surface: spans log one structured line on end (tagged ``trace_id`` /
``span_id`` / duration) and land in a bounded in-memory ring for
introspection — no OTLP exporter exists in this image, so the log line
IS the export.
"""

from __future__ import annotations

import contextvars
import logging
import os
import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

log = logging.getLogger("corrosion_tpu_torch.trace")

_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "corro_current_span", default=None
)

# bounded export ring (admin/debug surface)
RECENT_MAX = 1024
_recent: deque = deque(maxlen=RECENT_MAX)


@dataclass
class Span:
    name: str
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    parent_id: Optional[str] = None
    start: float = field(default_factory=time.time)  # wall, for display
    start_mono: float = field(default_factory=time.monotonic)
    end: Optional[float] = None
    dur_ms: Optional[float] = None  # from the monotonic clock
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def traceparent(self) -> str:
        """W3C trace-context header value (version 00, sampled)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self


_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def parse_traceparent(value: Optional[str]):
    """(trace_id, parent_span_id) from a W3C traceparent, or None.

    Strict hex validation: the string comes off the wire from a peer
    and ends up in log lines and the admin span ring — length checks
    alone would let an attacker inject arbitrary bytes there."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value)
    if m is None:
        return None
    return m.group(1), m.group(2)


class span:
    """Context manager: opens a Span, parents it on ``remote`` (a
    traceparent string) or on the task's current span, logs one line on
    exit.  Works in both sync and async code (no awaits inside)."""

    def __init__(self, name: str, remote: Optional[str] = None, **attrs):
        self.name = name
        self.remote = remote
        self.attrs = attrs
        self.span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Span:
        parent = _current.get()
        remote = parse_traceparent(self.remote)
        if remote is not None:
            trace_id, parent_id = remote
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = os.urandom(16).hex(), None
        self.span = Span(
            name=self.name,
            trace_id=trace_id,
            span_id=os.urandom(8).hex(),
            parent_id=parent_id,
            attrs=dict(self.attrs),
        )
        self._token = _current.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        s = self.span
        s.end = time.time()
        s.dur_ms = (time.monotonic() - s.start_mono) * 1000.0
        if exc is not None:
            s.attrs["error"] = repr(exc)
        _current.reset(self._token)
        _finish(s)


def _finish(s: Span) -> None:
    """The one span-finish sequence — ring append, export, log line —
    shared by live spans (``span().__exit__``) and post-hoc ones
    (:func:`record`), so the two can't drift."""
    _recent.append(s)
    _export(s)
    extras = " ".join(f"{k}={v}" for k, v in sorted(s.attrs.items()))
    log.info(
        "span %s trace_id=%s span_id=%s parent_id=%s dur_ms=%.1f %s",
        s.name, s.trace_id, s.span_id, s.parent_id or "-",
        s.dur_ms, extras,
    )


def current_traceparent() -> Optional[str]:
    s = _current.get()
    return s.traceparent if s is not None else None


def record(name: str, remote: Optional[str] = None,
           duration_ms: float = 0.0, **attrs) -> Optional[Span]:
    """Record an already-finished span after the fact.

    Hot paths that only decide to trace once the outcome is known (e.g.
    a broadcast apply that turns out to be a version's FIRST arrival)
    use this instead of wrapping every candidate in a live ``span()`` —
    the non-news duplicates would otherwise dominate the ring.  The
    span parents on ``remote`` (a traceparent) or the task's current
    span; ``duration_ms`` is caller-measured.  Returns the Span, or
    None when ``remote`` was given but unparseable (junk off the wire
    must not mint orphan traces)."""
    parsed = parse_traceparent(remote) if remote is not None else None
    if remote is not None and parsed is None:
        return None
    if parsed is not None:
        trace_id, parent_id = parsed
    else:
        cur = _current.get()
        if cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
        else:
            trace_id, parent_id = os.urandom(16).hex(), None
    now = time.time()
    s = Span(
        name=name,
        trace_id=trace_id,
        span_id=os.urandom(8).hex(),
        parent_id=parent_id,
        start=now - duration_ms / 1000.0,
        attrs=dict(attrs),
    )
    s.end = now
    s.dur_ms = duration_ms
    _finish(s)
    return s


# -- file export (the OTLP stand-in) ----------------------------------
#
# The reference ships spans to an OTLP endpoint (CLI main.rs tracing
# init); no OTel SDK exists in this image, so the configurable export
# is OTLP-flavored span records, one JSON object per line, consumable
# by a collector's file receiver or plain jq.

import json as _json
import threading as _threading

_sink_lock = _threading.Lock()
_sink = None  # open file object
_sink_gen = 0  # bumps on every (re)configure: the ownership token
_sink_path: Optional[str] = None
_sink_max_bytes = 0  # 0 = unbounded (legacy behavior)
_sink_bytes = 0  # bytes in the active file
_sink_rotated = False  # one rotation per configure generation
_sink_dead = False  # post-rotation reopen failed: sink gone, keep counting
_dropped_total = 0  # spans dropped post-rotation (process lifetime)

# default export bound: two ~64 MiB files (active + one rotation)
DEFAULT_EXPORT_MAX_BYTES = 64 * 1024 * 1024


def configure_export(path: Optional[str],
                     max_bytes: int = DEFAULT_EXPORT_MAX_BYTES
                     ) -> Optional[int]:
    """Append finished spans to ``path`` (None disables).  Process-wide,
    like the tracing runtime itself.  Returns an ownership token for
    :func:`disable_export_if` (None when disabling).

    The export is BOUNDED: once the active file exceeds ``max_bytes``
    it rotates ONCE to ``path + ".1"`` (overwriting a previous
    rotation); if the fresh file fills again, further spans are dropped
    and counted (:func:`export_dropped_total`, surfaced as
    ``corro_trace_spans_dropped_total``) — an append-forever spans file
    must not eat the disk out from under the database.  ``max_bytes=0``
    disables the bound."""
    global _sink, _sink_gen, _sink_path, _sink_max_bytes
    global _sink_bytes, _sink_rotated, _sink_dead
    with _sink_lock:
        _sink_gen += 1
        if _sink is not None:
            try:
                _sink.close()
            except OSError:
                pass
            _sink = None
        _sink_path = None
        _sink_rotated = False
        _sink_dead = False
        _sink_bytes = 0
        if path:
            _sink = open(path, "a", buffering=1)
            _sink_path = path
            _sink_max_bytes = max(0, int(max_bytes))
            try:
                _sink_bytes = os.path.getsize(path)
            except OSError:
                _sink_bytes = 0
            return _sink_gen
        return None


def export_dropped_total() -> int:
    """Spans dropped by the bounded export since process start (the
    sink — and therefore this counter — is process-wide)."""
    with _sink_lock:
        return _dropped_total


def export_token_active(token: Optional[int]) -> bool:
    """Whether ``token`` is the generation that opened the CURRENTLY
    active sink.  A superseded owner (another agent reconfigured the
    process-wide export after it) must stop claiming the drop total,
    or every past owner syncs the same delta into its own counter and
    the family sums to an n-owners-fold overcount."""
    if token is None:
        return False
    with _sink_lock:
        return _sink_gen == token


def _rotate_or_drop_locked(line_len: int) -> bool:
    """Under ``_sink_lock``: make room for one more line.  Returns True
    when the write may proceed (possibly into a freshly-rotated file),
    False when the span must drop."""
    global _sink, _sink_bytes, _sink_rotated, _dropped_total, _sink_dead
    if _sink_max_bytes <= 0 or _sink_bytes + line_len <= _sink_max_bytes:
        return True
    if _sink_rotated:
        _dropped_total += 1
        return False
    # single rotation: active file -> path.1 (replacing any previous
    # rotation), then a fresh active file.  Total on-disk footprint
    # stays <= 2 * max_bytes for the life of this sink.
    _sink_rotated = True
    try:
        _sink.close()
    except OSError:
        pass
    try:
        os.replace(_sink_path, _sink_path + ".1")
    except OSError:
        pass
    try:
        _sink = open(_sink_path, "w", buffering=1)
    except OSError:
        # the sink is DEAD, not disabled: every later span is a drop
        # and must keep counting (_export checks _sink_dead), or the
        # drop counter freezes while spans silently vanish
        _sink = None
        _sink_dead = True
        _dropped_total += 1
        return False
    _sink_bytes = 0
    return True


def disable_export_if(token: Optional[int]) -> None:
    """Disable the sink only if ``token`` is the one that opened the
    currently-active sink — in a multi-agent process, an agent must not
    kill a sink another still-running agent has since (re)opened.
    Check and close happen under one lock acquisition."""
    global _sink, _sink_gen, _sink_dead
    if token is None:
        return
    with _sink_lock:
        if _sink_gen != token:
            return
        if _sink is None and not _sink_dead:
            return
        _sink_gen += 1
        if _sink is not None:
            try:
                _sink.close()
            except OSError:
                pass
        _sink = None
        _sink_dead = False


def _export(s: Span) -> None:
    global _sink_bytes, _dropped_total
    with _sink_lock:
        if _sink is None:
            if _sink_dead:
                # configured sink whose post-rotation reopen failed:
                # these are DROPS and must keep counting — a frozen
                # counter reads as a healthy export while spans vanish
                _dropped_total += 1
            return
        rec = {
            "traceId": s.trace_id,
            "spanId": s.span_id,
            "parentSpanId": s.parent_id or "",
            "name": s.name,
            "startTimeUnixNano": int(s.start * 1e9),
            "endTimeUnixNano": int((s.end or s.start) * 1e9),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in sorted(s.attrs.items())
            ],
        }
        line = _json.dumps(rec) + "\n"
        if not _rotate_or_drop_locked(len(line)):
            return
        try:
            _sink.write(line)
            _sink_bytes += len(line)
        except OSError:
            pass


def recent_spans(limit: int = 100, trace_id: Optional[str] = None):
    """Most recent finished spans, newest last (admin surface).  A
    non-positive limit returns none — ``[-0:]`` would invert the bound
    and dump the whole ring.  ``trace_id`` filters to one trace BEFORE
    the limit applies, so a whole cross-node trace can be assembled
    from each node's ring without grepping the full dump."""
    if limit <= 0:
        return []
    spans = list(_recent)
    if trace_id is not None:
        spans = [s for s in spans if s.trace_id == trace_id]
    return spans[-limit:]
