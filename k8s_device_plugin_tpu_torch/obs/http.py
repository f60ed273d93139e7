"""Shared HTTP surface for metrics exposition (+ /healthz).

One composable endpoint shape for every daemon (The Kubernetes Network
Driver Model's argument: device state belongs on standard endpoints,
not bespoke sockets): ``GET /metrics`` serves the installed registry in
Prometheus text format — optionally concatenated with extra
daemon-specific text the caller renders per scrape (the chip gauges in
cmd/metrics_exporter.py) — and ``GET /healthz`` serves a small JSON
liveness document the caller can extend.

``/healthz`` has real readiness semantics (ISSUE 5): the watchdog
registry (utils/watchdog.py) is consulted per request, and any stalled
registered loop flips the answer to **503** with a JSON detail naming
the loop and its silence age — so a kubelet liveness probe restarts a
daemon whose heartbeat thread wedged instead of probing a zombie to
200 forever. ``/metrics`` stays up regardless: the stall itself must be
scrapeable.

``GET /debug/traces`` (ISSUE 10) lists the in-memory trace ring
(obs/trace.py TraceStore) and ``GET /debug/traces/<trace_id>`` serves
one trace as an OTLP-shaped document. ``GET /debug/requests`` (ISSUE
16) lists the finished request-ledger ring (obs/ledger.py) the same
way, with ``GET /debug/requests/<trace_id>`` serving one request's
lifecycle decomposition. Off by default; enabled per server
(``trace_debug=True``) or process-wide via ``TPU_TRACE_DEBUG=1`` (what
the Helm chart's ``observability.traceDebug`` sets). Every ``/debug/*``
listing accepts ``?limit=N`` and caps at DEBUG_DEFAULT_LIMIT entries by
default, so a large ring can't turn a debug poke into a multi-MB
response on the scrape path.

Every response carries an explicit ``Content-Length`` and a charset in
``Content-Type`` — some scrapers refuse chunked or charset-less bodies
(the ISSUE 10 header-normalization fix; regression-tested).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from k8s_device_plugin_tpu_torch.obs import ledger as obs_ledger
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_CONTENT_TYPE = "application/json; charset=utf-8"
TEXT_CONTENT_TYPE = "text/plain; charset=utf-8"

# Process-wide default for serving /debug/traces on obs endpoints
# (callers may force it per server with start_metrics_server's
# trace_debug argument).
TRACE_DEBUG_ENV = "TPU_TRACE_DEBUG"


def trace_debug_default() -> bool:
    return os.environ.get(TRACE_DEBUG_ENV) == "1"


# Default cap on /debug/* listing sizes: a full TPU_TRACE_RING or
# TPU_LEDGER_RING listing can run to multiple MB, and these endpoints
# sit on the scrape path (ISSUE 16 satellite). ``?limit=`` overrides
# per request.
DEBUG_DEFAULT_LIMIT = 128


def split_debug_path(path: str) -> Tuple[str, int]:
    """``/debug/traces?limit=5`` -> (``/debug/traces``, 5). The limit
    falls back to DEBUG_DEFAULT_LIMIT when absent/unparseable and is
    clamped to at least 1 (``?limit=0`` would render an empty, useless
    listing while still walking the ring)."""
    parts = urlsplit(path)
    limit = DEBUG_DEFAULT_LIMIT
    raw = parse_qs(parts.query).get("limit", [None])[-1]
    if raw is not None:
        try:
            limit = max(1, int(raw))
        except ValueError:
            pass
    return parts.path, limit


def _truncate_lists(doc, limit: int):
    """Bound every list in a debug document to ``limit`` entries,
    leaving a ``"..._truncated": n`` marker beside anything cut."""
    if isinstance(doc, list):
        return [_truncate_lists(v, limit) for v in doc[:limit]]
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if isinstance(v, list) and len(v) > limit:
                out[k] = [_truncate_lists(e, limit) for e in v[:limit]]
                out[f"{k}_truncated"] = len(v) - limit
            else:
                out[k] = _truncate_lists(v, limit)
        return out
    return doc


def handle_debug_traces(path: str):
    """Shared /debug/traces route logic: returns (status, json_doc)
    for a ``/debug/traces[/<trace_id>][?limit=N]`` path (both this
    module's metrics server and the llm-serve handler route through
    here). The listing keeps the NEWEST ``limit`` traces."""
    route, limit = split_debug_path(path)
    store = obs_trace.get_store()
    if route in ("/debug/traces", "/debug/traces/"):
        summaries = store.summaries()
        kept = summaries[-limit:]
        return 200, {"traces": kept,
                     "ring": store.max_traces,
                     "dropped": store.dropped_traces,
                     "total": len(summaries),
                     "limit": limit}
    trace_id = route[len("/debug/traces/"):]
    doc = store.get(trace_id)
    if doc is None:
        return 404, {"error": f"unknown trace id {trace_id!r}"}
    return 200, doc


def handle_debug_requests(path: str):
    """Shared /debug/requests route logic: the finished-ledger ring
    (obs/ledger.py), newest first, for a
    ``/debug/requests[/<trace_id>][?limit=N]`` path."""
    route, limit = split_debug_path(path)
    store = obs_ledger.get_store()
    if route in ("/debug/requests", "/debug/requests/"):
        return 200, store.debug_doc(limit)
    trace_id = route[len("/debug/requests/"):]
    row = store.get(trace_id)
    if row is None:
        return 404, {"error": f"no ledger for trace id {trace_id!r}"}
    return 200, row


def render_metrics(extra_text_fn: Optional[Callable[[], str]] = None) -> str:
    """Registry exposition + caller-rendered extra families."""
    registry = obs_metrics.get_registry()
    parts = []
    if registry is not None:
        parts.append(registry.expose().rstrip("\n"))
    if extra_text_fn is not None:
        parts.append(extra_text_fn().rstrip("\n"))
    return "\n".join(p for p in parts if p) + "\n"


def start_metrics_server(
    port: int,
    bind_addr: str = "0.0.0.0",
    extra_text_fn: Optional[Callable[[], str]] = None,
    health_fn: Optional[Callable[[], dict]] = None,
    watchdog: Optional[object] = None,
    trace_debug: Optional[bool] = None,
    debug_fleet_fn: Optional[Callable[[], dict]] = None,
) -> ThreadingHTTPServer:
    """Serve /metrics and /healthz on a daemon thread; returns the
    server (``.server_address[1]`` carries the bound port for port=0).

    ``watchdog`` is a utils.watchdog.WatchdogRegistry (default: the
    process-wide registry) whose stalled loops turn /healthz into 503.
    ``trace_debug`` enables /debug/traces (None = the TPU_TRACE_DEBUG
    env knob; absent/0 = the routes 404).
    ``debug_fleet_fn`` serves its JSON document at ``GET /debug/fleet``
    (the fleet aggregator's per-peer scrape/merge state, ISSUE 13);
    absent = the route 404s. The callable must return promptly from
    cached state — it runs inside the request handler.
    """
    from k8s_device_plugin_tpu_torch.utils import watchdog as watchdog_mod

    wd = watchdog if watchdog is not None else watchdog_mod.default_registry()
    debug = trace_debug if trace_debug is not None else trace_debug_default()
    def scrapes():
        # Resolved per request, so a registry installed after server
        # start still sees scrape counts.
        return obs_metrics.counter(
            "tpu_obs_scrapes_total",
            "HTTP scrapes served, by endpoint path",
            labels=("path",),
        )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # Route on the query-less path so ``?limit=`` (and future
            # params) reach every /debug endpoint uniformly.
            route, limit = split_debug_path(self.path)
            if route == "/metrics":
                scrapes().inc(path="/metrics")
                try:
                    body = render_metrics(extra_text_fn).encode()
                except Exception:
                    log.exception("metrics render failed")
                    self._send(500, b"metrics render failed\n",
                               TEXT_CONTENT_TYPE)
                    return
                self._send(200, body, CONTENT_TYPE)
            elif debug and (route == "/debug/traces"
                            or route.startswith("/debug/traces/")):
                scrapes().inc(path="/debug/traces")
                code, doc = handle_debug_traces(self.path)
                self._send(code, json.dumps(doc).encode(),
                           JSON_CONTENT_TYPE)
            elif debug and (route == "/debug/requests"
                            or route.startswith("/debug/requests/")):
                scrapes().inc(path="/debug/requests")
                code, doc = handle_debug_requests(self.path)
                self._send(code, json.dumps(doc).encode(),
                           JSON_CONTENT_TYPE)
            elif debug_fleet_fn is not None and route == "/debug/fleet":
                scrapes().inc(path="/debug/fleet")
                try:
                    doc = _truncate_lists(debug_fleet_fn() or {}, limit)
                    code = 200
                except Exception as e:
                    log.exception("fleet debug doc failed")
                    code, doc = 500, {"error": str(e)}
                self._send(code, json.dumps(doc).encode(),
                           JSON_CONTENT_TYPE)
            elif route == "/healthz":
                scrapes().inc(path="/healthz")
                # Readiness, not reachability: a stalled registered
                # heartbeat answers 503 (with the loop named) even
                # though this handler thread is obviously alive.
                try:
                    doc = wd.healthz_doc()
                except Exception as e:
                    log.exception("watchdog check failed")
                    doc = {"status": "degraded", "error": str(e)}
                if health_fn is not None:
                    try:
                        extra = health_fn() or {}
                        # The caller's doc extends but never upgrades a
                        # stalled/degraded status back to ok.
                        status = doc.get("status")
                        doc.update(extra)
                        if status != "ok":
                            doc["status"] = status
                    except Exception as e:
                        doc["status"] = "degraded"
                        doc["error"] = str(e)
                code = 200 if doc.get("status") == "ok" else 503
                self._send(code, json.dumps(doc).encode(),
                           JSON_CONTENT_TYPE)
            else:
                self._send(404, b"not found\n", TEXT_CONTENT_TYPE)

    httpd = ThreadingHTTPServer((bind_addr, port), Handler)
    threading.Thread(target=httpd.serve_forever, name="obs-http",
                     daemon=True).start()
    log.info("metrics on :%d/metrics (+/healthz)", httpd.server_address[1])
    return httpd
