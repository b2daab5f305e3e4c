"""The live plane: in-run status/metrics endpoint + live.json.
(A copy of the JAX package's obs/live.py; the port keeps its own.)

Everything the rest of the telemetry stack records is post-mortem —
events.jsonl / trace.json / ``analyze`` are consumed after the run
ends. This module is the *in-run* consumer surface (ROADMAP item 3's
"the obs stack becomes the service's metrics endpoint", and the live
half of ROADMAP item 1's starved/slow/rejected diagnosis):

- :class:`LiveStatusServer` — an opt-in stdlib ``http.server`` on a
  daemon thread, owned by the HUB process
  (``RunConfig.status_port`` / ``--status-port``; port 0 binds an
  ephemeral port), serving

  * ``/metrics`` — Prometheus text exposition rendered from the
    process-wide Recorder registry: counters, gauges, and histograms
    with the fixed log-spaced edges re-expressed as cumulative
    ``le`` buckets (the registry keeps per-bucket upper-inclusive
    counts; Prometheus wants cumulative upper-inclusive — same
    intervals, so the conversion is a running sum). Metric names are
    the registry's dotted names, sanitized and prefixed
    (``ph.gate_syncs`` → ``mpisppy_tpu_ph_gate_syncs``). A handful of
    hub-state gauges (iteration, bounds, gap, per-spoke liveness) are
    appended from :meth:`Hub.status_snapshot` so a scraper sees the
    wheel even before the registry fills.
  * ``/status`` — the hub's status snapshot as JSON: run id,
    iteration, current outer/inner bounds + gap, per-spoke supervisor
    state (alive / generation / quarantined / respawns) and bound
    flow, phase occupancy.
  * ``/`` and ``/healthz`` — liveness ping.

- :func:`write_live_snapshot` — the SAME snapshot persisted as
  ``live.json`` beside the telemetry artifacts on every hub
  termination check (atomically renamed, so a SIGKILL mid-write never
  leaves a torn file): multi-host and jax-free consumers — and
  ``analyze --watch`` — tail it without the port.

Pure host-side stdlib: no jax import anywhere on this path.
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import BUCKET_EDGES

PROM_PREFIX = "mpisppy_tpu"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return f"{PROM_PREFIX}_{_NAME_RE.sub('_', name)}"


def _prom_num(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict | None, extra_gauges=None) -> str:
    """Prometheus text exposition (format version 0.0.4) from a
    MetricsRegistry snapshot ({"counters", "gauges", "histograms"}).

    Histograms: the registry keeps PER-BUCKET counts over the fixed
    upper-inclusive edges (metrics.BUCKET_EDGES); Prometheus buckets
    are CUMULATIVE over the same upper-inclusive intervals, so the
    running sum below is exact — ``_bucket{le="+Inf"}`` equals
    ``_count`` by construction. ``extra_gauges`` ({name: value}) lets
    the status server append live hub state not kept in the registry.
    """
    L = []
    snapshot = snapshot or {}
    for name, v in sorted((snapshot.get("counters") or {}).items()):
        p = _prom_name(name)
        L.append(f"# TYPE {p} counter")
        L.append(f"{p} {_prom_num(v)}")
    gauges = dict(snapshot.get("gauges") or {})
    gauges.update(extra_gauges or {})
    for name, v in sorted(gauges.items()):
        p = _prom_name(name)
        L.append(f"# TYPE {p} gauge")
        L.append(f"{p} {_prom_num(v)}")
    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        p = _prom_name(name)
        per_bucket = h.get("buckets_upper_edge") or {}
        L.append(f"# TYPE {p} histogram")
        cum = 0
        for edge in BUCKET_EDGES:
            cum += per_bucket.get(f"{edge:g}", 0)
            L.append(f'{p}_bucket{{le="{edge:g}"}} {cum}')
        cum += per_bucket.get("+inf", 0)
        L.append(f'{p}_bucket{{le="+Inf"}} {cum}')
        L.append(f"{p}_sum {_prom_num(h.get('sum', 0.0))}")
        L.append(f"{p}_count {int(h.get('count', 0))}")
    return "\n".join(L) + "\n"


def _status_gauges(status: dict) -> dict:
    """Live hub state worth scraping that the registry does not carry
    (bounds move through events, not gauges). Names join the registry
    namespace under ``live.*`` so they can never collide with it."""
    out = {}
    for key in ("iter", "outer", "inner", "abs_gap", "rel_gap",
                "elapsed_seconds"):
        v = status.get(key)
        if isinstance(v, (int, float)):
            out[f"live.{key}"] = v
    out["live.watchdog_fired"] = 1 if status.get("watchdog_fired") else 0
    for ent in status.get("spokes", ()):
        i = ent.get("index")
        up = 1
        if ent.get("state") not in (None, "running") \
                or ent.get("alive") is False:
            up = 0
        out[f"live.spoke.up.spoke{i}"] = up
        out[f"live.spoke.generation.spoke{i}"] = ent.get("gen", 0)
    return out


def write_live_snapshot(out_dir: str, status: dict) -> str:
    """Atomically persist ``live.json`` under ``out_dir``. The rename
    is the crash-safety contract: consumers either see the previous
    complete snapshot or the new complete snapshot, never a torn
    write — required by the SIGKILL'd-run acceptance criterion."""
    path = os.path.join(out_dir, "live.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(status, f, indent=1)
    os.replace(tmp, path)
    return path


class _StatusHandler(BaseHTTPRequestHandler):
    # the wheel's stdout is the screen trace — never log HTTP chatter
    def log_message(self, *args):
        pass

    def do_GET(self):
        try:
            code, ctype, body = self.server._respond(self.path)
        except Exception as e:      # introspection must never crash
            code, ctype = 500, "text/plain; charset=utf-8"
            body = f"status server error: {e!r}\n".encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _StatusHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, hub):
        super().__init__(addr, _StatusHandler)
        self._hub = hub

    def _respond(self, path):
        from .. import obs

        path = path.split("?", 1)[0]
        obs.counter_add("hub.status_requests")
        if path == "/metrics":
            rec = obs.active()
            snap = rec.metrics.snapshot() if rec is not None else None
            status = self._hub.status_snapshot()
            body = render_prometheus(snap,
                                     extra_gauges=_status_gauges(status))
            # the de-facto standard exposition content type
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    body.encode())
        if path == "/status":
            return (200, "application/json; charset=utf-8",
                    (json.dumps(self._hub.status_snapshot(), indent=1)
                     + "\n").encode())
        if path in ("/", "/healthz"):
            return (200, "application/json; charset=utf-8",
                    b'{"ok": true}\n')
        return (404, "text/plain; charset=utf-8",
                b"unknown path; try /metrics /status /healthz\n")


class LiveStatusServer:
    """The hub-owned in-run status server. ``start()`` binds and spins
    a daemon serve thread (port 0 = ephemeral; read ``.port`` after
    start); ``stop()`` releases the socket. Idempotent both ways.

    Binds LOOPBACK by default: /status and /metrics expose the whole
    run state with no auth, so reaching them from another host is an
    explicit opt-in (``RunConfig.status_host`` / ``--status-host
    0.0.0.0`` for a Prometheus scraper; live.json covers the passive
    multi-host tail case without opening a port at all)."""

    def __init__(self, hub, port: int, host: str = "127.0.0.1"):
        self._hub = hub
        self._requested = (host, int(port))
        self._httpd = None
        self._thread = None
        self.port = None

    def start(self):
        if self._httpd is not None:
            return self
        self._httpd = _StatusHTTPServer(self._requested, self._hub)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mpisppy-tpu-status", daemon=True)
        self._thread.start()
        from .. import global_toc, obs
        global_toc(f"live status server on port {self.port} "
                   "(/metrics /status)")
        obs.event("hub.status_server", {"port": self.port})
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
