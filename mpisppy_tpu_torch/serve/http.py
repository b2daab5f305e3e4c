"""The service plane: stdlib HTTP front of the serving layer.

Same construction discipline as the live plane (obs/live.py):
``ThreadingHTTPServer`` + daemon serve thread, loopback bind by
default (the endpoints accept work and serve full state with no auth —
``0.0.0.0`` is the explicit opt-in), stdlib only on this path.

Endpoints:

- ``POST /solve`` — JSON instance (the request schema of serve/batch) ->
  ``{"request_id": ...}`` (202). 400 on a malformed payload, 429 when
  the bounded admission queue is full, 503 while preempting.
- ``GET /result/<id>`` — the durable request record (status,
  result, error, chain steps). Results outlive the connection AND the
  process (the store replays from disk).
- ``GET /queue`` — queued + known requests, light rows.
- ``GET /metrics`` — the Prometheus text exposition of the
  process-wide Recorder registry, mounted unchanged
  (obs/live.render_prometheus) plus ``serve.*`` state gauges.
- ``GET /status`` — the service snapshot: queue depth, request
  counts, per-wheel hub snapshots (each wheel's
  ``Hub.status_snapshot`` with its ``request_tag``), warm-cache
  anatomy.
- ``POST /shutdown`` — graceful drain (finish active wheels, keep
  queued requests durable); ``/healthz`` — liveness (+ ``draining``).
- ``POST /drain`` — drain-for-deploy: migrate everything out to a live
  peer, then refuse admissions with ``Retry-After`` + a peer hint.
- ``POST /migrate/offer`` / ``PUT /migrate/bundle/<id>?file=<name>`` /
  ``POST /migrate/commit`` — the receiver half of a live wheel handoff
  (serve/migrate): offer opens a staging dir, PUTs stream bundle
  members with sha256 verification, commit gates the bundle through
  ``load_bundle`` and admits the request via force-push recovery.
  Refusals are reasoned 4xx bodies the donor books as
  ``serve.migrate.aborted.<reason>``. ``POST /migrate/abort`` releases
  a staged offer when the donor gives up mid-protocol (best-effort;
  the receiver's TTL sweep is the backstop for donors that die
  without saying so).

``429`` and ``503`` responses carry ``Retry-After`` so clients back
off instead of hammering; a draining 503 adds ``"peer"`` — the live
host that will take the work.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import obs
from ..obs.live import render_prometheus
from .batch import BadRequest
from .migrate import MigrationError
from .queue import QueueFull

_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"
_PROM = "text/plain; version=0.0.4; charset=utf-8"
_MAX_BODY = 64 * 1024 * 1024


def _json_body(code: int, obj) -> tuple:
    return code, _JSON, (json.dumps(obj, indent=1) + "\n").encode()


class _ServeHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):     # the screen trace is the wheel's
        pass

    def _reply(self, code, ctype, body, headers=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _unpack(out):
        # routes return (code, ctype, body) or + an extra-headers dict
        if len(out) == 4:
            return out
        code, ctype, body = out
        return code, ctype, body, None

    def do_GET(self):
        try:
            out = self._unpack(self.server._get(
                self.path.split("?", 1)[0]))
        except Exception as e:      # introspection must never crash
            out = (500, _TEXT, f"serve error: {e!r}\n".encode(), None)
        self._reply(*out)

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length") or 0)
            if n > _MAX_BODY:
                raise BadRequest(f"body over {_MAX_BODY} bytes")
            raw = self.rfile.read(n) if n else b""
            out = self._unpack(self.server._post(
                self.path.split("?", 1)[0], raw))
        except BadRequest as e:
            out = _json_body(400, {"error": str(e)}) + (None,)
        except Exception as e:
            out = (500, _TEXT, f"serve error: {e!r}\n".encode(), None)
        self._reply(*out)

    def do_PUT(self):
        """Streaming member upload for a live migration — the body is
        NOT buffered (bundle members can be arbitrarily large within
        ``_MAX_BODY``); the receiver hashes it as it lands."""
        try:
            n = int(self.headers.get("Content-Length") or 0)
            if n > _MAX_BODY:
                raise BadRequest(f"body over {_MAX_BODY} bytes")
            out = self._unpack(self.server._put(
                self.path, self.rfile, n))
        except BadRequest as e:
            out = _json_body(400, {"error": str(e)}) + (None,)
        except Exception as e:
            out = (500, _TEXT, f"serve error: {e!r}\n".encode(), None)
        # a refused streaming PUT may leave unread body bytes on the
        # socket; close the connection rather than resynchronize
        self.close_connection = True
        self._reply(*out)


class _ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, service, on_shutdown=None):
        super().__init__(addr, _ServeHandler)
        self._service = service
        self._on_shutdown = on_shutdown

    def _get(self, path):
        obs.counter_add("serve.http_requests")
        svc = self._service
        if path.startswith("/result/"):
            rec = svc.result(path[len("/result/"):])
            if rec is None:
                return _json_body(404, {"error": "unknown request id"})
            return _json_body(200, rec)
        if path == "/queue":
            return _json_body(200, svc.queue_snapshot())
        if path == "/status":
            return _json_body(200, svc.status_snapshot())
        if path == "/metrics":
            rec = obs.active()
            snap = rec.metrics.snapshot() if rec is not None else None
            extra = {"serve.queue_depth_now": len(svc.queue),
                     "serve.wheels_active": len(svc._active_hubs),
                     "serve.cache_buckets": len(svc.cache)}
            return (200, _PROM,
                    render_prometheus(snap, extra_gauges=extra).encode())
        if path in ("/", "/healthz"):
            return _json_body(200, {"ok": True,
                                    "preempting": svc._preempting,
                                    "draining": getattr(
                                        svc, "_draining", False)})
        return (404, _TEXT, b"unknown path; try /solve /result/<id> "
                            b"/queue /status /metrics /healthz\n")

    def _post(self, path, raw):
        obs.counter_add("serve.http_requests")
        svc = self._service

        def _parse():
            try:
                return json.loads(raw.decode("utf-8") or "{}")
            except ValueError as e:
                raise BadRequest(f"invalid JSON body: {e}") from None

        if path == "/solve":
            draining = getattr(svc, "_draining", False)
            if svc._preempting or svc._stop or draining:
                body = {"error": "service draining" if draining
                                 else "service stopping"}
                peer = svc.peer_hint() if draining else None
                if peer:
                    body["peer"] = peer
                return _json_body(503, body) + ({"Retry-After": "2"},)
            payload = _parse()
            try:
                req = svc.submit(payload)
            except QueueFull as e:
                return _json_body(429, {"error": str(e)}) \
                    + ({"Retry-After": "1"},)
            return _json_body(202, {"request_id": req.id,
                                    "bucket": req.bucket,
                                    "batchable": req.batchable})
        if path == "/shutdown":
            if self._on_shutdown is not None:
                self._on_shutdown()
            return _json_body(200, {"ok": True, "stopping": True})
        if path == "/drain":
            return _json_body(200, svc.drain("http"))
        if path == "/migrate/offer":
            try:
                return _json_body(200, svc.migrate_offer(_parse()))
            except MigrationError as e:
                return _json_body(409 if e.reason != "refused" else 400,
                                  {"error": str(e), "reason": e.reason})
        if path == "/migrate/commit":
            try:
                return _json_body(200, svc.migrate_commit(_parse()))
            except MigrationError as e:
                return _json_body(409 if e.reason != "refused" else 400,
                                  {"error": str(e), "reason": e.reason})
        if path == "/migrate/abort":
            try:
                return _json_body(200, svc.migrate_abort(_parse()))
            except MigrationError as e:
                return _json_body(400, {"error": str(e),
                                        "reason": e.reason})
        return (404, _TEXT, b"unknown POST path; try /solve /shutdown "
                            b"/drain /migrate/offer /migrate/commit "
                            b"/migrate/abort\n")

    def _put(self, path_q, stream, length):
        """``PUT /migrate/bundle/<id>?file=<name>`` — one streamed
        bundle member into the migration staging dir."""
        obs.counter_add("serve.http_requests")
        svc = self._service
        path, _, query = path_q.partition("?")
        if not path.startswith("/migrate/bundle/"):
            return (404, _TEXT, b"unknown PUT path; try "
                                b"/migrate/bundle/<id>?file=<name>\n")
        mid = urllib.parse.unquote(path[len("/migrate/bundle/"):])
        name = (urllib.parse.parse_qs(query).get("file") or [""])[0]
        if not mid or not name:
            raise BadRequest("PUT needs /migrate/bundle/<id>?file=<name>")
        try:
            return _json_body(200, svc.migrate_put(mid, name, stream,
                                                   length))
        except MigrationError as e:
            return _json_body(400, {"error": str(e),
                                    "reason": e.reason})


class ServeHTTPServer:
    """Bind + serve on a daemon thread (port 0 = ephemeral; read
    ``.port`` after start). Same idempotent start/stop shape as
    obs/live.LiveStatusServer."""

    def __init__(self, service, port: int, host: str = "127.0.0.1",
                 on_shutdown=None):
        self._service = service
        self._requested = (host, int(port))
        self._on_shutdown = on_shutdown
        self._httpd = None
        self._thread = None
        self.port = None

    def start(self):
        if self._httpd is not None:
            return self
        self._httpd = _ServeHTTPServer(self._requested, self._service,
                                       on_shutdown=self._on_shutdown)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mpisppy-tpu-serve", daemon=True)
        self._thread.start()
        obs.event("serve.http_server", {"port": self.port})
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
