"""KV-page handoff for disaggregated prefill/decode serving.

A prefill replica runs chunked prefill, samples the first token, and
exports the request's filled KV pages as a :class:`PageBlockBundle`; a
decode replica imports the bundle into its own ``PagePool`` and streams
the remaining tokens. The page contents cross the wire on the same
aliasing seam ``speculative.draft_pages_from_target`` proved in-process:
a page block is just the ``[n_pages, page_tokens, kv_heads, head_dim]``
K/V slabs for each layer, so a gather on one pool plus a scatter on
another reproduces the single-process cache bit-for-bit.

A page block in flight is state owned by two processes, so ownership is
**lease-based** (crash-safe by construction):

1. the prefill engine exports the block, takes its own page refs, and
   registers them in a :class:`LeaseTable` under ``TPU_HANDOFF_LEASE_S``;
2. the decode engine imports the pages and acks the lease — the prefill
   copy is released on the next engine tick;
3. if either side dies mid-transfer, the ack never arrives: the lease
   expires, the prefill engine reclaims the pages (counted in
   ``tpu_serve_handoff_orphans_total``), and the decode side — which
   still holds the original prompt — re-prefills locally or sheds via
   the PR-3 admission machinery. Never a hang, never a leaked page.

Transports are pluggable per the composable-network-driver model:
:class:`InProcTransport` (tests/bench — still round-trips the wire
encoding) and :class:`HTTPTransport` (the ``/v1/handoff/*`` routes in
serve_http). Every transfer carries a deadline
(``TPU_HANDOFF_DEADLINE_S``), runs under ``utils.retry`` backoff + a
retry budget, and sits behind a per-peer ``CircuitBreaker`` so a dead
prefill tier degrades decode replicas to local prefill at once instead
of timing out per request. Fault points ``handoff.send`` /
``handoff.recv`` / ``handoff.import`` let chaos tests kill the hop at
each stage.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace
from k8s_device_plugin_tpu_torch.utils import faults
from k8s_device_plugin_tpu_torch.utils.retry import (
    Backoff,
    CircuitBreaker,
    RetryBudget,
    retry_call,
)

log = logging.getLogger("llm-serve")

# Seconds an exported page block stays referenced on the prefill side
# waiting for the decode ack. Expiry reclaims the pages (orphan).
ENV_LEASE_S = "TPU_HANDOFF_LEASE_S"
DEFAULT_LEASE_S = 30.0

# Per-transfer wall-clock budget for the prefill RPC (connect + chunked
# prefill + bundle download), shared across retry attempts.
ENV_DEADLINE_S = "TPU_HANDOFF_DEADLINE_S"
DEFAULT_DEADLINE_S = 10.0

_MAGIC = b"TPUH"
_WIRE_VERSION = 1


def lease_s_from_env() -> float:
    raw = os.environ.get(ENV_LEASE_S, "").strip()
    try:
        val = float(raw) if raw else DEFAULT_LEASE_S
    except ValueError:
        val = DEFAULT_LEASE_S
    return val if val > 0 else DEFAULT_LEASE_S


def deadline_s_from_env() -> float:
    raw = os.environ.get(ENV_DEADLINE_S, "").strip()
    try:
        val = float(raw) if raw else DEFAULT_DEADLINE_S
    except ValueError:
        val = DEFAULT_DEADLINE_S
    return val if val > 0 else DEFAULT_DEADLINE_S


def _c_handoffs():
    return obs_metrics.counter(
        "tpu_serve_handoff_total",
        "KV-page handoffs by role and outcome (prefill: export; decode: "
        "ok/imported on success, fallback/stale/incompatible/import_error "
        "on local re-prefill, breaker/error on transport failure)",
        labels=("role", "outcome"),
    )


def _c_orphans():
    return obs_metrics.counter(
        "tpu_serve_handoff_orphans_total",
        "exported page blocks whose lease expired or was force-released "
        "without a decode ack, by side",
        labels=("side",),
    )


def _c_pages():
    return obs_metrics.counter(
        "tpu_serve_handoff_pages_total",
        "KV pages transferred across the prefill->decode hop",
    )


def _h_latency():
    return obs_metrics.histogram(
        "tpu_serve_handoff_seconds",
        "decode-observed handoff latency: prefill RPC sent -> bundle "
        "parsed (includes the remote chunked prefill)",
        buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
    )


def _g_breaker():
    return obs_metrics.gauge(
        "tpu_serve_handoff_breaker_state",
        "handoff circuit breaker per peer (0=closed 1=open 2=half-open)",
        labels=("peer",),
    )


class HandoffError(RuntimeError):
    """Retryable transport/protocol failure on the handoff hop."""


class HandoffRejected(HandoffError):
    """Permanent refusal (incompatible page geometry, bad payload,
    wrong role) — retrying the same peer cannot help."""


# bfloat16 on the host: numpy has no bf16 type, so a bf16 leaf is held
# as its raw 16-bit words in an array of this tagged uint16 dtype. The
# wire carries the same bytes under ``"dtype": "bfloat16"``, so bundles
# cross to and from the reference package unchanged.
BF16_WORDS = np.dtype(np.uint16, metadata={"wire": "bfloat16"})


def _np_dtype(name: str) -> np.dtype:
    """Resolve a serialized dtype name; ``bfloat16`` is held as
    :data:`BF16_WORDS`."""
    if name == "bfloat16":
        return BF16_WORDS
    return np.dtype(name)


def _dtype_name(dt: np.dtype) -> str:
    """The wire name of a host leaf's dtype (the inverse of
    :func:`_np_dtype`)."""
    return (dt.metadata or {}).get("wire", str(dt))


def host_array(t: torch.Tensor) -> np.ndarray:
    """A page tensor on the host as a numpy array; bf16 as its words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WORDS)
    return t.numpy()


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`host_array`: a host leaf as a CPU tensor (a
    copy — wire arrays are read-only views of the bundle's bytes)."""
    if _dtype_name(a.dtype) == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


class PageBlockBundle:
    """One request's filled KV pages plus everything the decode side
    needs to continue the request bit-identically.

    ``budget`` is the *post-admission-clamp, pre-first-token* budget:
    the decode engine replays the exact first-token consumption the
    single-process finish arm would have done. ``arrays`` maps
    ``layer{i}`` to ``{"k": ndarray, "v": ndarray}`` slabs of shape
    ``[n_pages, page_tokens, kv_heads, head_dim]`` in table order.

    Wire format: ``TPUH`` magic, ``!I`` big-endian JSON header length,
    JSON header (scalars + per-layer dtype/shape metadata), then the
    raw K/V bytes concatenated in layer order — no pickle, no copies
    beyond the ``tobytes`` flatten.
    """

    __slots__ = (
        "lease_id", "lease_s", "window", "first_token", "first_lp",
        "budget", "temp", "topk", "want_lp", "slo", "page_tokens",
        "arrays", "traceparent", "born",
    )

    def __init__(self, *, lease_id: str, lease_s: float, window: List[int],
                 first_token: int, first_lp: float, budget: int,
                 temp: float, topk: int, want_lp: bool, slo: str,
                 page_tokens: int,
                 arrays: Dict[str, Dict[str, np.ndarray]],
                 traceparent: Optional[str] = None,
                 born: Optional[float] = None):
        self.lease_id = lease_id
        self.lease_s = float(lease_s)
        self.window = list(window)
        self.first_token = int(first_token)
        self.first_lp = float(first_lp)
        self.budget = int(budget)
        self.temp = float(temp)
        self.topk = int(topk)
        self.want_lp = bool(want_lp)
        self.slo = slo
        self.page_tokens = int(page_tokens)
        self.arrays = arrays
        self.traceparent = traceparent
        self.born = born

    @property
    def num_pages(self) -> int:
        for kv in self.arrays.values():
            return int(kv["k"].shape[0])
        return 0

    @property
    def num_layers(self) -> int:
        return len(self.arrays)

    def expired(self, clock: Callable[[], float] = time.monotonic) -> bool:
        """True once the lease has lapsed on the *receiver's* clock
        (stamped at parse time — wall clocks never cross the wire)."""
        return self.born is not None and clock() - self.born >= self.lease_s

    @classmethod
    def from_pool_payload(cls, payload, **kwargs) -> "PageBlockBundle":
        """Build from the host tree ``export_pages`` returns
        (``{layer{i}: {attn: {k_pages, v_pages}}}``)."""
        arrays = {
            name: {"k": np.asarray(kv["attn"]["k_pages"]),
                   "v": np.asarray(kv["attn"]["v_pages"])}
            for name, kv in payload.items()
        }
        return cls(arrays=arrays, **kwargs)

    def to_pool_payload(self) -> Dict[str, dict]:
        """The pool-shaped tree ``import_pages`` scatters from."""
        return {
            name: {"attn": {"k_pages": kv["k"], "v_pages": kv["v"]}}
            for name, kv in self.arrays.items()
        }

    def to_bytes(self) -> bytes:
        layers = []
        blobs = []
        for name in sorted(self.arrays, key=lambda n: int(n[5:])):
            kv = self.arrays[name]
            k, v = np.ascontiguousarray(kv["k"]), np.ascontiguousarray(kv["v"])
            layers.append({"name": name, "dtype": _dtype_name(k.dtype),
                           "shape": list(k.shape)})
            blobs.append(k.tobytes())
            blobs.append(v.tobytes())
        header = json.dumps({
            "v": _WIRE_VERSION,
            "lease_id": self.lease_id,
            "lease_s": self.lease_s,
            "window": self.window,
            "first_token": self.first_token,
            "first_lp": self.first_lp,
            "budget": self.budget,
            "temp": self.temp,
            "topk": self.topk,
            "want_lp": self.want_lp,
            "slo": self.slo,
            "page_tokens": self.page_tokens,
            "traceparent": self.traceparent,
            "layers": layers,
        }).encode("utf-8")
        return b"".join(
            [_MAGIC, struct.pack("!I", len(header)), header] + blobs
        )

    @classmethod
    def from_bytes(cls, data: bytes,
                   clock: Callable[[], float] = time.monotonic,
                   ) -> "PageBlockBundle":
        if len(data) < 8 or data[:4] != _MAGIC:
            raise HandoffRejected("not a page-block bundle (bad magic)")
        (hlen,) = struct.unpack("!I", data[4:8])
        if 8 + hlen > len(data):
            raise HandoffRejected("truncated bundle header")
        try:
            header = json.loads(data[8:8 + hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HandoffRejected(f"bad bundle header: {e}") from e
        if header.get("v") != _WIRE_VERSION:
            raise HandoffRejected(
                f"bundle wire version {header.get('v')} != {_WIRE_VERSION}"
            )
        arrays: Dict[str, Dict[str, np.ndarray]] = {}
        off = 8 + hlen
        for meta in header["layers"]:
            dt = _np_dtype(meta["dtype"])
            shape = tuple(meta["shape"])
            nbytes = dt.itemsize * int(np.prod(shape))
            if off + 2 * nbytes > len(data):
                raise HandoffRejected("truncated bundle body")
            k = np.frombuffer(data, dt, count=int(np.prod(shape)),
                              offset=off).reshape(shape)
            off += nbytes
            v = np.frombuffer(data, dt, count=int(np.prod(shape)),
                              offset=off).reshape(shape)
            off += nbytes
            arrays[meta["name"]] = {"k": k, "v": v}
        return cls(
            lease_id=header["lease_id"], lease_s=header["lease_s"],
            window=header["window"], first_token=header["first_token"],
            first_lp=header["first_lp"], budget=header["budget"],
            temp=header["temp"], topk=header["topk"],
            want_lp=header["want_lp"], slo=header["slo"],
            page_tokens=header["page_tokens"],
            arrays=arrays, traceparent=header.get("traceparent"),
            born=clock(),
        )


class LeaseTable:
    """Prefill-side registry of exported page blocks awaiting acks.

    Thread-safe: acks arrive on handler threads while the engine thread
    exports and reaps. The engine owns the actual page refs — the table
    only does the accounting, and :meth:`take_resolved` hands resolved
    (acked or expired) page lists back to the engine thread for release,
    so ``PagePool`` itself never crosses a thread.
    """

    def __init__(self, lease_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.lease_s = float(lease_s) if lease_s else lease_s_from_env()
        self._clock = clock
        self._lock = threading.Lock()
        # lease_id -> {"pages": [ids], "expires": t, "acked": bool}
        self._leases: Dict[str, dict] = {}

    def export(self, pages: List[int]) -> str:
        lease_id = obs_trace.new_correlation_id("lease")
        with self._lock:
            self._leases[lease_id] = {
                "pages": list(pages),
                "expires": self._clock() + self.lease_s,
                "acked": False,
            }
        return lease_id

    def ack(self, lease_id: str) -> bool:
        """Mark a lease released by the decode side. Idempotent; an ack
        for an already-expired (reclaimed) lease is a no-op."""
        with self._lock:
            entry = self._leases.get(lease_id)
            if entry is None:
                return False
            entry["acked"] = True
            return True

    def pending(self) -> int:
        with self._lock:
            return len(self._leases)

    def take_resolved(self) -> List[List[int]]:
        """Pop every acked or expired lease, returning their page lists
        for the caller (the engine thread) to release. Expired-unacked
        leases are orphans — the decode peer died or never imported."""
        now = self._clock()
        out: List[List[int]] = []
        orphans = 0
        with self._lock:
            for lease_id in list(self._leases):
                entry = self._leases[lease_id]
                if entry["acked"]:
                    out.append(self._leases.pop(lease_id)["pages"])
                elif now >= entry["expires"]:
                    out.append(self._leases.pop(lease_id)["pages"])
                    orphans += 1
        if orphans:
            _c_orphans().inc(orphans, side="prefill")
            log.warning("handoff: reclaimed %d orphaned page lease(s)",
                        orphans)
        return out

    def release_all(self) -> int:
        """Forced shutdown path: count every still-pending lease as an
        orphan and clear the table. The caller is exiting — the page
        refs die with the process; this keeps the accounting honest."""
        with self._lock:
            n = len(self._leases)
            self._leases.clear()
        if n:
            _c_orphans().inc(n, side="prefill")
        return n


class PageTransport:
    """Pluggable transfer driver for the prefill->decode hop.

    ``prefill`` posts a prompt payload to the prefill peer and returns
    the serialized :class:`PageBlockBundle` bytes; ``ack`` releases the
    peer's lease. Implementations raise :class:`HandoffError` for
    retryable failures and :class:`HandoffRejected` for permanent ones.
    """

    def prefill(self, payload: dict, timeout_s: float) -> bytes:
        raise NotImplementedError

    def ack(self, lease_id: str, timeout_s: float) -> None:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class InProcTransport(PageTransport):
    """Reference transport: calls the prefill batcher directly, but
    still round-trips the wire encoding so tests and bench prove the
    exact bytes the HTTP transport would carry."""

    def __init__(self, ingest):
        # Any object with handle_prefill(payload, timeout_s)->bytes and
        # handle_ack(lease_id)->bool; in practice a ContinuousBatcher
        # in the prefill role.
        self.ingest = ingest

    def prefill(self, payload: dict, timeout_s: float) -> bytes:
        try:
            return self.ingest.handle_prefill(
                json.loads(json.dumps(payload)), timeout_s=timeout_s
            )
        except HandoffRejected:
            raise
        except Exception as e:  # tpulint: disable=TPU001 — transport boundary: any peer-side failure (shed, closing, fault) maps to a retryable HandoffError exactly as an HTTP 5xx would
            raise HandoffError(f"in-proc prefill failed: {e}") from e

    def ack(self, lease_id: str, timeout_s: float) -> None:
        self.ingest.handle_ack(lease_id)


class HTTPTransport(PageTransport):
    """Wire transport over the serve_http ``/v1/handoff/*`` routes."""

    def __init__(self, peer: str, ack_timeout_s: float = 2.0):
        self.peer = peer.rstrip("/")
        self.ack_timeout_s = float(ack_timeout_s)

    def _post(self, path: str, body: dict, timeout_s: float) -> bytes:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.peer + path,
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace")[:200]
            except OSError:
                pass
            if e.code in (400, 404, 409):
                raise HandoffRejected(
                    f"peer rejected {path}: HTTP {e.code} {detail}"
                ) from e
            raise HandoffError(
                f"peer failed {path}: HTTP {e.code} {detail}"
            ) from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise HandoffError(f"peer unreachable for {path}: {e}") from e

    def prefill(self, payload: dict, timeout_s: float) -> bytes:
        return self._post("/v1/handoff/prefill", payload, timeout_s)

    def ack(self, lease_id: str, timeout_s: float) -> None:
        self._post("/v1/handoff/ack", {"lease_id": lease_id},
                   min(timeout_s, self.ack_timeout_s))


class HandoffClient:
    """Decode-side client: one prefill peer, one circuit breaker.

    ``fetch`` runs the prefill RPC under the per-transfer deadline with
    ``utils.retry`` backoff and a retry budget; the breaker short-
    circuits a dead peer so every decode request degrades to local
    prefill immediately instead of burning the deadline each time.
    ``ack`` is best-effort: a lost ack costs the peer one lease expiry,
    never correctness. Thread-safe (called from HTTP handler threads
    and, for acks, the engine thread).
    """

    def __init__(self, transport: PageTransport, peer: str = "peer",
                 deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 budget: Optional[RetryBudget] = None,
                 backoff: Optional[Backoff] = None):
        self.transport = transport
        self.peer = peer
        self.deadline_s = (
            float(deadline_s) if deadline_s else deadline_s_from_env()
        )
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout_s=5.0,
            on_state_change=self._on_breaker,
        )
        # A caller-supplied breaker still drives the per-peer state
        # gauge unless the caller claimed the callback for itself.
        if self.breaker._on_state_change is None:
            self.breaker._on_state_change = self._on_breaker
        self.budget = budget or RetryBudget(capacity=20.0, refill_per_s=2.0)
        self.backoff = backoff or Backoff(base_s=0.05, cap_s=0.5)
        self._lock = threading.Lock()
        # Raw per-transfer latencies for the bench percentile lines.
        self.latencies_s = collections.deque(maxlen=1024)

    def _on_breaker(self, state: str) -> None:
        _g_breaker().set(CircuitBreaker.STATE_VALUES[state], peer=self.peer)
        if state == "open":
            log.warning("handoff breaker OPEN to peer %s", self.peer)

    def fetch(self, payload: dict,
              deadline_s: Optional[float] = None) -> PageBlockBundle:
        """Run the prefill RPC; return the parsed bundle.

        Raises :class:`HandoffError` when the hop fails — the caller
        falls back to local prefill (or sheds) per the role contract.
        """
        limit = self.deadline_s
        if deadline_s is not None:
            limit = max(0.05, min(limit, deadline_s))
        if not self.breaker.allow():
            _c_handoffs().inc(role="decode", outcome="breaker")
            raise HandoffError(f"circuit open to peer {self.peer}")
        start = time.perf_counter()

        def attempt() -> bytes:
            faults.inject("handoff.send", peer=self.peer)
            return self.transport.prefill(payload, timeout_s=limit)

        try:
            raw = retry_call(
                attempt,
                component="handoff",
                backoff=self.backoff,
                max_attempts=3,
                deadline_s=limit,
                retry_on=(HandoffError, faults.FaultError, OSError),
                giveup=lambda e: isinstance(e, HandoffRejected),
                budget=self.budget,
            )
            bundle = PageBlockBundle.from_bytes(raw)
        except Exception:
            self.breaker.record_failure()
            _c_handoffs().inc(role="decode", outcome="error")
            raise
        self.breaker.record_success()
        elapsed = time.perf_counter() - start
        _h_latency().observe(elapsed)
        with self._lock:
            self.latencies_s.append(elapsed)
        _c_handoffs().inc(role="decode", outcome="ok")
        _c_pages().inc(bundle.num_pages)
        return bundle

    def ack(self, lease_id: str) -> None:
        try:
            self.transport.ack(lease_id, timeout_s=self.deadline_s)
        except Exception as e:  # tpulint: disable=TPU001 — best-effort by design: a lost ack costs the peer one lease expiry, never correctness, so no ack failure may take down the engine thread
            _c_handoffs().inc(role="decode", outcome="ack_error")
            log.warning("handoff ack for %s failed: %s", lease_id, e)

    def close(self) -> None:
        self.transport.close()
