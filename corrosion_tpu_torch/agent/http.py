"""HTTP client API.

Parity: ``crates/corro-agent/src/api/public/`` + routes assembled at
``agent/util.rs:181-293``:

* ``POST /v1/transactions`` — execute write statements in one version
  (broadcast on commit); concurrent requests coalesce through the
  group-commit write combiner (docs/writes.md) — each handler thread's
  batch keeps its own version and failure isolation;
* ``POST /v1/queries`` — streaming NDJSON query results
  (columns / row / eoq events, like ``TypedQueryEvent``);
* ``POST /v1/migrations`` — merge schema SQL;
* ``GET  /v1/table_stats`` — per-table row counts;
* ``POST /v1/subscriptions`` / ``GET /v1/subscriptions/:id`` — streaming
  incremental query subscriptions (see :mod:`corrosion_tpu_torch.agent.pubsub`);
* ``GET  /v1/updates/:table`` — raw per-table change notifications;
* optional bearer authz.

Implementation: stdlib ``ThreadingHTTPServer`` — each agent runs it on a
thread next to the asyncio gossip loop; handlers call the agent's
thread-safe storage/bookkeeping paths directly.
"""

from __future__ import annotations

import json
import threading

from corrosion_tpu_torch.agent.pack import jsonable_row
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from corrosion_tpu_torch.agent.runtime import Agent


class _ApiServer(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: under a request burst
    # the kernel RSTs the overflow and clients see connection resets.
    # The reference serves on hyper/tokio with an effectively deep
    # accept queue; match that.
    request_queue_size = 128


def start_http_api(agent: "Agent") -> ThreadingHTTPServer:
    handler = _make_handler(agent)
    server = _ApiServer(
        (agent.config.api_host, agent.config.api_port or 0), handler
    )
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def _make_handler(agent: "Agent"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        # -- helpers ---------------------------------------------------

        def _authorized(self) -> bool:
            token = agent.config.api_authz
            if not token:
                return True
            got = self.headers.get("Authorization", "")
            return got == f"Bearer {token}"

        def _body(self):
            ln = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(ln) if ln else b""
            return json.loads(raw) if raw else None

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream_start(self, code: int = 200) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _stream_line(self, obj) -> None:
            line = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
            self.wfile.flush()

        def _stream_end(self) -> None:
            self.wfile.write(b"0\r\n\r\n")

        # -- routes ----------------------------------------------------

        _ENDPOINTS = (
            "/v1/transactions", "/v1/queries", "/v1/migrations",
            "/v1/subscriptions", "/v1/updates", "/v1/table_stats",
            "/v1/members", "/metrics",
        )

        def _count_request(self) -> None:
            # label values must stay bounded AND server-chosen: raw
            # request paths would let an unauthenticated client mint
            # unlimited series (and inject into the exposition)
            path = self.path.split("?")[0]
            for ep in self._ENDPOINTS:
                if path == ep or path.startswith(ep + "/"):
                    agent.metrics.counter(
                        "corro_http_requests_total", endpoint=ep
                    )
                    return
            agent.metrics.counter(
                "corro_http_requests_total", endpoint="other"
            )

        def do_POST(self):
            self._count_request()
            if not self._authorized():
                return self._json(401, {"error": "unauthorized"})
            try:
                if self.path == "/v1/transactions":
                    return self._transactions()
                if self.path == "/v1/queries":
                    return self._queries()
                if self.path == "/v1/migrations":
                    return self._migrations()
                if self.path == "/v1/subscriptions":
                    return self._subscribe()
                return self._json(404, {"error": "not found"})
            except BrokenPipeError:
                pass
            except Exception as e:  # surface agent errors to the client
                try:
                    self._json(500, {"error": str(e)})
                except Exception:
                    pass

        def do_GET(self):
            self._count_request()
            if not self._authorized():
                return self._json(401, {"error": "unauthorized"})
            try:
                if self.path == "/metrics":
                    return self._metrics()
                if self.path == "/v1/table_stats":
                    return self._table_stats()
                if self.path == "/v1/members":
                    return self._members()
                if self.path.startswith("/v1/subscriptions/"):
                    return self._subscribe_by_id(self.path.rsplit("/", 1)[1])
                if self.path.startswith("/v1/updates/"):
                    return self._updates(self.path.rsplit("/", 1)[1])
                return self._json(404, {"error": "not found"})
            except BrokenPipeError:
                pass
            except Exception as e:
                try:
                    self._json(500, {"error": str(e)})
                except Exception:
                    pass

        def _transactions(self):
            stmts = self._body()
            if not isinstance(stmts, list):
                return self._json(400, {"error": "expected a JSON array"})
            out = agent.execute_transaction(stmts)
            self._json(200, out)

        def _queries(self):
            stmt = self._body()
            if isinstance(stmt, str):
                sql, params = stmt, ()
            elif isinstance(stmt, list):
                sql, params = stmt[0], stmt[1] if len(stmt) > 1 else ()
            else:
                return self._json(400, {"error": "expected statement"})
            cols, rows = agent.storage.read_query(sql, params)
            self._stream_start()
            self._stream_line({"columns": cols})
            for i, row in enumerate(rows):
                self._stream_line({"row": [i + 1, jsonable_row(row)]})
            self._stream_line({"eoq": {"time": 0.0}})
            self._stream_end()

        def _migrations(self):
            body = self._body()
            sql = "\n".join(body) if isinstance(body, list) else str(body)
            self._json(200, {"tables": agent.apply_schema_sql(sql)})

        def _metrics(self):
            body = agent.metrics.render(agent.metric_gauges()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _table_stats(self):
            stats = {}
            with agent.storage._lock:
                for t in agent.storage.tables:
                    (n,) = agent.storage.conn.execute(
                        f'SELECT COUNT(*) FROM "{t}"'
                    ).fetchone()
                    stats[t] = {"row_count": n}
            self._json(200, {"tables": stats})

        def _members(self):
            transport = getattr(agent, "transport", None)
            conn_stats = transport.stats if transport is not None else {}
            members = []
            for m in agent.members.all():
                # .get is the atomic read: the event loop may evict the
                # entry concurrently with this handler thread
                stats = conn_stats.get(tuple(m.addr))
                members.append({
                    "actor": m.actor_id.hex(),
                    "addr": list(m.addr),
                    "state": m.state.value,
                    "incarnation": m.incarnation,
                    "rtt_ms": m.rtt_ms,
                    # per-peer transport stats (transport.rs
                    # ConnectionStats parity)
                    "conn": stats.as_dict() if stats is not None else None,
                })
            self._json(200, {"members": members})

        def _subscribe(self):
            if agent.subs is None:
                return self._json(501, {"error": "subscriptions disabled"})
            stmt = self._body()
            sql = stmt if isinstance(stmt, str) else stmt[0]
            handle = agent.subs.subscribe(sql)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("x-corro-query-id", handle.id)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._pump_subscription(handle, from_change_id=None)

        def _subscribe_by_id(self, sub_id: str):
            if agent.subs is None:
                return self._json(501, {"error": "subscriptions disabled"})
            query = ""
            from_id = None
            if "?" in sub_id:
                sub_id, query = sub_id.split("?", 1)
                for part in query.split("&"):
                    if part.startswith("from="):
                        from_id = int(part[5:])
            handle = agent.subs.get(sub_id)
            if handle is None:
                return self._json(404, {"error": "no such subscription"})
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("x-corro-query-id", handle.id)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._pump_subscription(handle, from_change_id=from_id)

        def _pump_subscription(self, handle, from_change_id):
            try:
                for event in handle.stream(from_change_id=from_change_id):
                    self._stream_line(event)
            except (BrokenPipeError, ConnectionResetError):
                handle.unsubscribe_stream()

        def _updates(self, table: str):
            if agent.subs is None:
                return self._json(501, {"error": "subscriptions disabled"})
            if table not in agent.storage.tables:
                return self._json(404, {"error": f"no such table {table}"})
            self._stream_start()
            try:
                for event in agent.subs.table_updates(table):
                    self._stream_line(event)
            except (BrokenPipeError, ConnectionResetError):
                pass

    return Handler


def jsonable_row(row):
    out = []
    for v in row:
        if isinstance(v, bytes):
            out.append(v.hex())
        else:
            out.append(v)
    return out
