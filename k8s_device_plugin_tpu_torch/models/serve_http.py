"""HTTP protocol surface + CLI wiring for the port's llm-serve daemon.

The counterpart of ``k8s_device_plugin_tpu/models/serve_http.py``: the
vLLM-compatible ``POST /v1/completions`` handler (validation, SSE
streaming, logprobs/echo/n), ``GET /healthz``, ``GET /metrics``, the
debug listings, and graceful-shutdown main(), over the PyTorch engine
(serve_engine.py) and either batcher (serve_batch.py): the continuous
one (the default) in either KV layout, ``--kv-cache paged`` (the
default, as in the reference) or ``rows``; or ``--batching static``,
window-coalesced batches decoded to completion after
``LMServer.warmup``.

Disaggregated serving, as in the reference: ``--role prefill`` serves
``POST /v1/handoff/prefill`` and ``/v1/handoff/ack`` (chunked prefill ->
page-block bundles, no client completions), ``--role decode
--handoff-peer URL`` fetches bundles from that peer and decodes
(models/handoff.py).

The flag surface is the reference's plus ``--device``.
``--compile-cache-dir`` keeps the port's kernel libraries (the nvcc
builds of csrc/) in a persistent cache (models/compile_cache.py), so a
restart or a sibling replica on the same volume runs no nvcc.
``--experts N`` serves switch-MoE layers (models/moe.py).
``--checkpoint`` reads the port's checkpoint directory
(models/params.py), which tools/orbax_to_torch.py writes from the
reference's. ``--device`` is new: the card by default, ``cpu`` on
request (the counterpart of the reference's ``JAX_PLATFORMS``).

Tensor-parallel serving: started by a launcher (``python -m
torch.distributed.run --standalone --nproc-per-node N -m
k8s_device_plugin_tpu_torch.models.serve ...``), the daemon serves the
model over the ``dp x tp`` mesh of its N ranks (models/serve_engine.py).
Rank 0 binds the port and owns every host-side part (HTTP, the batchers,
the page tables, tokenization, metrics); the other ranks bind nothing
and follow rank 0's engine calls (parallel/serve_ranks.py). SIGTERM to
rank 0 drains as on one rank, then stops the followers; they ignore
SIGTERM themselves (a launcher that forwards it to every rank would
otherwise cut the drain short), and every rank exits 0. A rank that
raises or dies stops the daemon with a non-zero exit. ``--role
prefill|decode`` runs on any mesh: the handoff machinery (leases, the
client, the ``/v1/handoff/*`` routes, the handoff metrics) stays on rank
0, and a bundle carries whole pages, gathered over tp on export and
sliced to each rank's kv heads on import (serve_engine.py
``export_pages`` / ``import_pages``), so a replica of any world size
pairs with one of any other. Without ``WORLD_SIZE > 1`` it is the
one-rank daemon.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff
from k8s_device_plugin_tpu_torch.models.kv_cache import SLO_CLASSES
from k8s_device_plugin_tpu_torch.models.serve_batch import (
    Batcher,
    ContinuousBatcher,
)
from k8s_device_plugin_tpu_torch.models.serve_engine import (
    TOP_K_CAP,
    DeadlineError,
    LMServer,
    ServerClosingError,
    ShedError,
)
from k8s_device_plugin_tpu_torch.obs import ledger as obs_ledger
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace
from k8s_device_plugin_tpu_torch.parallel.mesh import leave_process_group

log = logging.getLogger("llm-serve")

# Request header carrying the SLO class (interactive/standard/batch);
# absent -> standard.
SLO_CLASS_HEADER = os.environ.get("TPU_SLO_CLASS_HEADER",
                                  "x-tpu-slo-class")


def _c_http_errors():
    return obs_metrics.counter(
        "tpu_serve_http_errors_total",
        "completions-API errors by class (shed=429, closing=503, "
        "deadline=504, bad_request=400, internal=500, role=503 — "
        "completions sent to a prefill-role replica)",
        labels=("cls",),
    )


def classify_error(e: Exception):
    """(http_status, class_label) for a completions-handler failure:
    overload, shutdown and deadline expiry are client-actionable and get
    their own codes."""
    if isinstance(e, ShedError):
        return 429, "shed"
    if isinstance(e, ServerClosingError):
        return 503, "closing"
    if isinstance(e, DeadlineError):
        return 504, "deadline"
    return 500, "internal"


def _logprobs_block(tokenizer, token_ids, token_logprobs) -> dict:
    """Completions-API ``logprobs`` block for the chosen tokens."""
    return {
        "tokens": [
            tokenizer.token_bytes(t).decode("utf-8", errors="replace")
            for t in token_ids
        ],
        "token_logprobs": [round(float(v), 5) for v in token_logprobs],
    }


def build_arg_parser() -> argparse.ArgumentParser:
    """The port's llm-serve CLI parser."""
    p = argparse.ArgumentParser(prog="llm-serve")
    p.add_argument("--port", type=int, default=8888)
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint directory (lm_config.json "
                        "+ torch_params.pt + tokenizer files; "
                        "tools/orbax_to_torch.py writes it from a "
                        "reference checkpoint); default: random weights "
                        "from seed 0")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config for smoke tests")
    p.add_argument("--experts", type=int, default=0,
                   help="match a checkpoint trained with --experts N")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: the CUDA "
                        "card, an error when there is none; 'cpu' runs "
                        "on the CPU)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every prefill/decode bucket once "
                        "at startup (first requests then pay it)")
    p.add_argument("--batching", choices=("continuous", "static"),
                   default="continuous",
                   help="continuous: fixed row pool, requests join/leave "
                        "at segment boundaries; static: window-coalesced "
                        "batches decoded to completion")
    p.add_argument("--max-batch", type=int, default=4,
                   help="decode row pool width (continuous) / request "
                        "coalescing cap (static)")
    p.add_argument("--segment-tokens", type=int, default=16,
                   help="continuous mode: tokens decoded between "
                        "admission points; 0 = auto-tune at warmup from "
                        "this device's measured dispatch overhead")
    p.add_argument("--batch-window-ms", type=float, default=8.0,
                   help="static mode: how long the first queued request "
                        "waits for company before decoding")
    p.add_argument("--warmup-tokens", type=int, default=16,
                   help="static mode: decode-loop length run at startup; "
                        "match your clients' typical max_tokens")
    p.add_argument("--seed", type=int, default=0,
                   help="server-level sampling generator seed")
    p.add_argument("--draft-layers", type=int, default=0,
                   help="enable self-draft speculative decoding with "
                        "this many target layers as the draft (0 = "
                        "off; both batching modes); greedy-exact, "
                        "sampled/logprob requests keep the plain scan")
    p.add_argument("--speculative-k", type=int, default=4,
                   help="draft tokens proposed per target verify "
                        "forward (with --draft-layers)")
    p.add_argument("--kv-cache", choices=("paged", "rows"),
                   default="paged",
                   help="continuous-mode KV layout: paged = block-table "
                        "page pool with prefix reuse, chunked prefill "
                        "and SLO-class eviction (docs/serving.md); "
                        "rows = legacy contiguous per-row caches")
    p.add_argument("--kv-page-tokens", type=int, default=0,
                   help="token slots per KV page (paged mode; 0 = "
                        "TPU_KV_PAGE_TOKENS env or 16)")
    p.add_argument("--kv-pool-pages", type=int, default=0,
                   help="physical pages in the KV pool (paged mode; 0 "
                        "= TPU_KV_POOL_PAGES env or sized to max-batch "
                        "full-length rows); shrink to overcommit on "
                        "prefix sharing")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="paged mode: prompt tokens prefilled per engine "
                        "iteration; long prompts interleave with decode "
                        "segments in chunks this size (0 = default 64)")
    p.add_argument("--role", choices=("prefill", "decode", "both"),
                   default="both",
                   help="disaggregated serving role (paged continuous "
                        "mode only): prefill = serve /v1/handoff/* "
                        "(chunked prefill -> page-block bundles, no "
                        "client completions); decode = fetch bundles "
                        "from --handoff-peer, import pages, stream "
                        "tokens; both = single-process default "
                        "(docs/serving.md)")
    p.add_argument("--handoff-peer", default=None,
                   help="prefill peer base URL for --role decode, e.g. "
                        "http://prefill-svc:8888; transfers run under "
                        "TPU_HANDOFF_DEADLINE_S with retries and a "
                        "circuit breaker, and fall back to local "
                        "prefill on failure")
    p.add_argument("--max-pending", type=int, default=128,
                   help="admission bound: requests admitted but not "
                        "yet finished; past it submits shed with 429 "
                        "(0 = unbounded); when full, a higher-SLO-class "
                        "arrival sheds the newest lowest-class queued "
                        "request instead of itself")
    p.add_argument("--request-timeout", type=float, default=0.0,
                   help="default per-request deadline in seconds, "
                        "queue wait included (0 = none); requests may "
                        "override with a 'timeout' field; expiry "
                        "returns 504")
    p.add_argument("--compile-cache-dir", default=None,
                   help="persistent kernel cache directory (default: "
                        "TPU_COMPILE_CACHE_DIR env, unset = disabled): "
                        "the kernel libraries nvcc builds here are "
                        "written to disk and opened — not rebuilt — by "
                        "restarts and sibling replicas sharing the "
                        "volume; size-capped via "
                        "TPU_COMPILE_CACHE_MAX_BYTES")
    p.add_argument("--trace-debug", action="store_true",
                   help="serve GET /debug/traces and /debug/requests "
                        "(+ /<id>) from the in-memory rings on the main "
                        "port; off by default")
    return p


def make_handler(server, batcher, default_timeout_s: float = 0.0,
                 trace_debug: bool = False, role: str = "both"):
    """Build the completions-API handler class over ``server``/
    ``batcher`` (module-level so tests can serve any engine through
    the real protocol surface).

    ``role`` is the disaggregated-serving role: prefill replicas serve
    ``POST /v1/handoff/prefill`` (prompt in, serialized page-block
    bundle out) and ``POST /v1/handoff/ack`` (lease release) and refuse
    client completions with a 503 so a misrouted gateway fails loud;
    decode/both replicas serve completions only — the decode side of a
    handoff is an outbound client, not a route."""
    from k8s_device_plugin_tpu_torch.obs import http as obs_http

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", obs_http.JSON_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _bad(self, msg):
            _c_http_errors().inc(cls="bad_request")
            self._send(400, {"error": msg})

        def _fail(self, e: Exception, what: str):
            """Classified failure: distinct status per error class,
            counted per class."""
            code, cls = classify_error(e)
            _c_http_errors().inc(cls=cls)
            headers = [("Retry-After", "1")] if code in (429, 503) else []
            self._send(code, {"error": f"{what}: {e}", "class": cls},
                       headers=headers)

        def do_GET(self):
            route, _ = obs_http.split_debug_path(self.path)
            if route == "/metrics":
                # Decay the bottleneck classification (-> idle) even
                # when no requests are finishing to drive it.
                obs_ledger.step_installed()
                body = obs_http.render_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type", obs_http.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif trace_debug and (
                route == "/debug/traces"
                or route.startswith("/debug/traces/")
            ):
                code, doc = obs_http.handle_debug_traces(self.path)
                self._send(code, doc)
            elif trace_debug and (
                route == "/debug/requests"
                or route.startswith("/debug/requests/")
            ):
                code, doc = obs_http.handle_debug_requests(self.path)
                self._send(code, doc)
            elif route == "/healthz":
                body = {"status": "ok"}
                if batcher.allocation_id:
                    body["allocation_id"] = batcher.allocation_id
                if server.spec_k is not None:
                    s = server.spec_stats_snapshot()
                    s["tokens_per_verify_round"] = round(
                        s["tokens"] / s["verify_rounds"], 2
                    ) if s["verify_rounds"] else None
                    body["speculative"] = s
                self._send(200, body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if role == "prefill" and self.path in (
                "/v1/handoff/prefill", "/v1/handoff/ack"
            ):
                self._handle_handoff()
                return
            if self.path != "/v1/completions":
                self._send(404, {"error": "not found"})
                return
            if role == "prefill":
                # Prefill replicas own no decode loop — a completions
                # request landing here is a routing bug upstream, shed
                # as retryable so the gateway re-resolves the decode
                # Service instead of wedging on a token stream that
                # will never start.
                _c_http_errors().inc(cls="role")
                self._send(503, {"error": "prefill-role replica: use "
                                          "/v1/handoff/prefill",
                                 "class": "role"},
                           headers=[("Retry-After", "1")])
                return
            # Root span of the request trace; adopts an inbound W3C
            # traceparent header when the caller sent one.
            parent = obs_trace.parse_traceparent(
                self.headers.get("traceparent")
            )
            with obs_trace.span("serve.request", parent=parent,
                                journal=False, path="/v1/completions"):
                self._handle_completion()

        def _handle_handoff(self):
            """Prefill-role wire surface.

            ``/v1/handoff/prefill``: JSON payload in, raw
            ``PageBlockBundle`` bytes out (octet-stream — the bundle
            carries its own framed header). ``/v1/handoff/ack``: decode
            confirms the import; the lease's page refs drop on the next
            engine tick. Rejections (malformed payload, wrong engine
            mode) are 400s the client must NOT retry; overload/closing
            flow through ``_fail`` so the decode side sees the same
            429/503 + Retry-After contract as completions clients.
            """
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._bad("bad json")
                return
            if not isinstance(payload, dict):
                self._bad("handoff payload must be an object")
                return
            if self.path == "/v1/handoff/ack":
                ok = batcher.handle_ack(payload.get("lease_id"))
                self._send(200, {"ok": bool(ok)})
                return
            try:
                data = batcher.handle_prefill(
                    payload, timeout_s=default_timeout_s or None
                )
            except (kv_handoff.HandoffRejected, ValueError,
                    TypeError) as e:
                self._bad(f"handoff rejected: {e}")
                return
            except Exception as e:  # tpulint: disable=TPU001 — wire boundary: every engine-side failure class must map to a status code here, not a dropped connection
                self._fail(e, "handoff failed")
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _handle_completion(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._bad("bad json")
                return
            prompt = req.get("prompt", "")
            if not isinstance(prompt, str):
                self._bad("prompt must be a string")
                return
            try:
                max_tokens = int(req.get("max_tokens") or 16)
                temperature = float(req.get("temperature") or 0.0)
                top_k = int(req.get("top_k") or 0)
            except (TypeError, ValueError):
                self._bad("max_tokens/temperature/top_k must be numbers")
                return
            if temperature < 0 or not (0 <= top_k <= TOP_K_CAP):
                self._bad(f"temperature must be >= 0 and "
                          f"top_k in [0, {TOP_K_CAP}]")
                return
            try:
                timeout_raw = req.get("timeout")
                timeout_s = (float(default_timeout_s) if timeout_raw is None
                             else float(timeout_raw))
            except (TypeError, ValueError):
                self._bad("timeout must be a number of seconds")
                return
            if not 0 <= timeout_s <= 3600:
                self._bad("timeout must be in [0, 3600] seconds "
                          "(0 disables the deadline)")
                return
            stop = req.get("stop")
            if stop is None:
                stops = []
            elif isinstance(stop, str):
                stops = [stop]
            elif isinstance(stop, list) and all(
                isinstance(s, str) for s in stop
            ):
                stops = list(stop)
            else:
                self._bad("stop must be a string or a list of strings")
                return
            if len(stops) > 8 or any(
                not s or len(s.encode("utf-8")) > 128 for s in stops
            ):
                self._bad("at most 8 stop sequences, each 1..128 bytes")
                return
            stream = req.get("stream", False)
            if not isinstance(stream, bool):
                self._bad("stream must be a boolean")
                return
            try:
                n_raw = req.get("n")
                n = 1 if n_raw is None else int(n_raw)
            except (TypeError, ValueError):
                self._bad("n must be an integer")
                return
            if not 1 <= n <= 8:
                self._bad("n must be in [1, 8]")
                return
            if n > 1 and stream:
                self._bad("stream supports n=1 only")
                return
            logprobs = req.get("logprobs") or 0
            if logprobs is True:
                logprobs = 1
            if not isinstance(logprobs, int) or not 0 <= logprobs <= 1:
                self._bad("logprobs must be 0/1 (only chosen-token "
                          "logprobs are returned)")
                return
            echo = req.get("echo", False)
            if not isinstance(echo, bool):
                self._bad("echo must be a boolean")
                return
            slo = (self.headers.get(SLO_CLASS_HEADER) or "standard")
            slo = slo.strip().lower()
            if slo not in SLO_CLASSES:
                self._bad(f"{SLO_CLASS_HEADER} must be one of "
                          f"{'/'.join(SLO_CLASSES)}")
                return
            max_tokens = max(1, min(max_tokens, server.config.max_seq_len))
            try:
                toks = server.encode_prompt(prompt)
            except Exception as e:  # tpulint: disable=TPU001 — wire boundary: a tokenizer failure must reach the client as a JSON error, not a dropped connection
                self._fail(e, "tokenization failed")
                return
            try:
                # n > 1: n independent pool rows, each with its own noise
                rqs = [
                    batcher.submit_async(
                        toks, max_tokens, temperature=temperature,
                        top_k=top_k, stop=stops, stream=stream,
                        logprobs=bool(logprobs),
                        deadline_s=timeout_s, slo=slo,
                    )
                    for _ in range(n)
                ]
            except RuntimeError as e:
                # ShedError -> 429, ServerClosingError -> 503
                self._fail(e, "request refused")
                return
            if stream:
                self._stream_response(rqs[0], len(toks),
                                      logprobs=bool(logprobs),
                                      echo_text=prompt if echo else None,
                                      timeout=timeout_s or 600.0)
                return
            choices, completion_tokens, ttft = [], 0, None
            for idx, rq in enumerate(rqs):
                try:
                    out, rq_ttft = batcher.wait(rq)
                except RuntimeError as e:
                    # DeadlineError -> 504; engine failures -> 500.
                    self._fail(e, "decode failed")
                    return
                ttft = rq_ttft if ttft is None else ttft
                completion_tokens += len(out) - len(toks)
                choice = {
                    "text": (prompt if echo else "") + rq.slot["text"],
                    "index": idx,
                    "finish_reason": rq.slot.get("finish_reason",
                                                 "length"),
                }
                if logprobs:
                    choice["logprobs"] = _logprobs_block(
                        server.tokenizer, out[len(toks):],
                        rq.slot.get("logprobs", []),
                    )
                choices.append(choice)
            self._send(200, {
                "object": "text_completion",
                "id": rqs[0].slot.get("trace_id", ""),
                "choices": choices,
                "usage": {
                    "prompt_tokens": len(toks),
                    "completion_tokens": completion_tokens,
                },
                "ttft_seconds": round(ttft, 4),
            })

        def _stream_response(self, rq, prompt_tokens: int,
                             logprobs: bool = False,
                             echo_text: str | None = None,
                             timeout: float = 600.0):
            """Server-sent events: one data frame per segment-boundary
            text delta, a final frame with finish_reason + usage, then
            [DONE]."""
            from k8s_device_plugin_tpu_torch.models.serve_text import (
                SSE_DONE,
                sse_event,
            )

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            err = None
            deadline = time.monotonic() + timeout
            try:
                if echo_text:
                    self.wfile.write(sse_event({
                        "object": "text_completion",
                        "choices": [{"text": echo_text}],
                    }))
                    self.wfile.flush()
                while True:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        err = f"decode timed out after {timeout:.0f}s"
                        break
                    try:
                        chunk = rq.stream_q.get(timeout=min(remain, 5.0))
                    except queue.Empty:
                        continue
                    if chunk is None:
                        break
                    self.wfile.write(sse_event({
                        "object": "text_completion",
                        "choices": [{"text": chunk}],
                    }))
                    self.wfile.flush()
                if err is None and "error" in rq.slot:
                    err = rq.slot["error"]
                if err is not None:
                    _c_http_errors().inc(
                        cls=rq.slot.get("error_kind", "internal")
                        if "error" in rq.slot else "deadline"
                    )
                    self.wfile.write(sse_event(
                        {"error": f"decode failed: {err}"}
                    ))
                else:
                    out = rq.slot["tokens"]
                    final_choice = {
                        "text": "",
                        "finish_reason": rq.slot.get(
                            "finish_reason", "length"
                        ),
                    }
                    if logprobs:
                        final_choice["logprobs"] = _logprobs_block(
                            server.tokenizer, out[prompt_tokens:],
                            rq.slot.get("logprobs", []),
                        )
                    self.wfile.write(sse_event({
                        "object": "text_completion",
                        "choices": [final_choice],
                        "usage": {
                            "prompt_tokens": prompt_tokens,
                            "completion_tokens": len(out) - prompt_tokens,
                        },
                        "ttft_seconds": round(rq.slot["ttft"], 4),
                    }))
                self.wfile.write(SSE_DONE)
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                # Client went away mid-stream; the engine finishes the
                # row on its own (budget-bounded).
                log.info("stream client disconnected")

    return Handler


def main(argv=None, on_ready=None) -> int:
    """Run the daemon until SIGTERM/SIGINT (or ``httpd.shutdown()``),
    then drain. ``on_ready(httpd, batcher)``, when given, is called once
    the server is bound and warmed — how in-process callers (tests, the
    chip smoke test) learn the port of ``--port 0`` and stop the
    daemon. Returns 0 after a clean drain, 1 when work was abandoned."""
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.role != "both":
        # Fail at the flag layer, not deep in batcher construction: a
        # Helm values typo should print the contract, not a traceback.
        if args.batching != "continuous" or args.kv_cache != "paged":
            parser.error("--role prefill/decode requires --batching "
                         "continuous and --kv-cache paged (page blocks "
                         "are the handoff unit)")
        if args.role == "decode" and not args.handoff_peer:
            parser.error("--role decode requires --handoff-peer "
                         "(prefill base URL)")

    if world > 1 and int(os.environ.get("RANK", "0")) != 0:
        return _follow(args)

    from k8s_device_plugin_tpu_torch.obs import slo as obs_slo
    from k8s_device_plugin_tpu_torch.utils.chiplog import log_event

    obs_metrics.install()
    # Live SLO burn-rate monitor with TPU_SLO_MONITOR=1.
    slo_monitor = obs_slo.start_from_env()
    log_event("llm-serve", "open")

    with obs_trace.span("serve.startup",
                        parent=obs_trace.context_from_env(),
                        allocation_id=obs_trace.current_allocation_id(),
                        batching=args.batching):
        server = _server(args)
        if server.mesh.world > 1:
            from k8s_device_plugin_tpu_torch.parallel import serve_ranks

            server = serve_ranks.Leader(server,
                                        serve_ranks.Ranks(server.mesh))
            log.info("rank 0 of %d serves (pid %d); the others follow",
                     server.mesh.world, os.getpid())
        if args.draft_layers:
            server.enable_draft(args.draft_layers, k=args.speculative_k)
        if args.batching == "continuous":
            handoff_client = None
            if args.role == "decode":
                # Outbound page-fetch client: per-transfer deadline,
                # retry budget, and a circuit breaker per peer — the
                # wire hop must degrade to local re-prefill, never hang
                # the submit path.
                handoff_client = kv_handoff.HandoffClient(
                    kv_handoff.HTTPTransport(args.handoff_peer),
                    peer=args.handoff_peer,
                )
            batcher = ContinuousBatcher(
                server, max_batch=args.max_batch,
                segment_tokens=args.segment_tokens, seed=args.seed,
                max_pending=args.max_pending, kv_mode=args.kv_cache,
                page_tokens=args.kv_page_tokens,
                pool_pages=args.kv_pool_pages,
                prefill_chunk=args.prefill_chunk,
                role=args.role,
                handoff_client=handoff_client,
            )
            if not args.no_warmup:
                batcher.warmup()
            elif args.segment_tokens <= 0:
                log.warning("--segment-tokens 0 (auto) needs warmup to "
                            "measure dispatch cost; serving with "
                            "segment=16")
        else:
            if not args.no_warmup:
                server.warmup(decode_tokens=args.warmup_tokens,
                              max_batch=args.max_batch)
            batcher = Batcher(server, max_batch=args.max_batch,
                              window_ms=args.batch_window_ms,
                              seed=args.seed,
                              max_pending=args.max_pending)

    Handler = make_handler(server, batcher,
                           default_timeout_s=args.request_timeout,
                           trace_debug=args.trace_debug,
                           role=args.role)
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)

    def _stop():
        # Quiesce, not close: new submits fail fast from here, the
        # flight recorder stays installed through the drain below.
        batcher.quiesce()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    def _graceful(signum, frame):
        del frame
        log.info("signal %d: shutting down", signum)
        _stop()

    ranked = getattr(server, "on_broken", None)
    if ranked is not None:
        # the ranks fell out of step: nothing can be served any more
        ranked.append(_stop)

    # Only the main thread may install handlers (in-process callers run
    # main() in a worker thread and own shutdown).
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)

    log_event("llm-serve", "serving", note=str(server.device))
    log.info("llm-serve listening on :%d (%s batching, %s KV, role %s, "
             "%s)", httpd.server_address[1], args.batching,
             args.kv_cache if args.batching == "continuous" else "rows",
             args.role, server.device)
    if on_ready is not None:
        on_ready(httpd, batcher)
    httpd.serve_forever()
    # serve_forever returned: drain in-flight decodes before teardown.
    drained = batcher.drain()
    if not drained:
        log.warning("shutdown: drain timed out with work in flight")
    if slo_monitor is not None:
        slo_monitor.stop()
    httpd.server_close()
    in_step = True
    if ranked is not None:
        in_step = server.stop()
        leave_process_group()
    rc = 0 if drained and in_step else 1
    log_event("llm-serve", "close", rc=rc,
              note=None if rc == 0 else
              "drain timed out" if not drained else "ranks out of step")
    log.info("llm-serve stopped")
    return rc


def _server(args) -> LMServer:
    """The engine of ``args`` on this rank (the mesh of every rank)."""
    from k8s_device_plugin_tpu_torch.models import transformer

    if args.tiny:
        config = transformer.LMConfig.tiny(num_experts=args.experts)
    elif args.experts:
        config = transformer.LMConfig(num_experts=args.experts)
    else:
        config = None
    return LMServer(config=config, checkpoint=args.checkpoint,
                    device=args.device,
                    compile_cache_dir=args.compile_cache_dir)


def _follow(args) -> int:
    """A follower rank: its part of the model and its KV, running rank
    0's engine calls until rank 0 stops it (parallel/serve_ranks.py).
    SIGTERM and SIGINT are rank 0's to act on: a launcher that forwards
    them to every rank must not cut rank 0's drain short. Returns 0
    after rank 0's stop, 1 when the ranks broke."""
    from k8s_device_plugin_tpu_torch.parallel import serve_ranks

    def _wait(signum, frame):
        del frame
        log.info("signal %d: rank 0 drains and stops this rank", signum)

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _wait)
        signal.signal(signal.SIGINT, _wait)
    server = _server(args)
    try:
        serve_ranks.follow(server, serve_ranks.Ranks(server.mesh))
    except Exception:
        log.exception("rank %d: the serving ranks broke",
                      server.mesh.rank)
        return 1
    leave_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
