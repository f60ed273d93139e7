"""The port's serving slice as a whole, against the JAX reference's.

A JAX ``LMServer`` + rows-mode ``ContinuousBatcher`` at the tiny float32
config of tests/test_serve_continuous.py, and the port's pair on the CPU
with the same parameters (models/params.py), take the same jobs —
those of ``test_continuous_matches_complete_exactly`` plus a late join
— and must decode identical greedy tokens with logprobs within 1e-4.
The port's daemon (``serve_http.main``) then answers the completions
API, ``/healthz`` and ``/metrics`` with the reference's JSON keys and
``tpu_serve_*`` metric families.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import serve_http
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import params_from_jax
from k8s_device_plugin_tpu_torch.models.serve import (
    ContinuousBatcher,
    DeadlineError,
    LMServer,
    ShedError,
)

JOBS = [([5, 17, 99], 7), ([7, 3, 42, 11], 23), ([1], 4), ([88, 2], 12)]
LATE_JOB = ([9, 4, 61], 10)
_KW = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
           mlp_dim=64, max_seq_len=64)
REF_PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "k8s_device_plugin_tpu")


@pytest.fixture(scope="module")
def servers():
    jsrv = jserve.LMServer(config=jt.LMConfig(**_KW, dtype=jnp.float32))
    ct = tt.LMConfig(**_KW, dtype=torch.float32)
    tsrv = LMServer(config=ct, device="cpu", params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsrv.params), ct))
    return jsrv, tsrv


def _run_jobs(batcher):
    """The jobs at once, then a late join while they decode; returns
    [(tokens, logprobs)] in job order."""
    reqs = [batcher.submit_async(p, n, logprobs=True) for p, n in JOBS]
    time.sleep(0.05)
    reqs.append(batcher.submit_async(*LATE_JOB, logprobs=True))
    out = []
    for r in reqs:
        toks, _ = batcher.wait(r, timeout=120)
        out.append((toks, r.slot["logprobs"]))
    return out


def test_continuous_engine_matches_reference(servers):
    jsrv, tsrv = servers
    want = _run_jobs(jserve.ContinuousBatcher(jsrv, max_batch=4,
                                              segment_tokens=4))
    got = _run_jobs(ContinuousBatcher(tsrv, max_batch=4, segment_tokens=4))
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g), (_, w) in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, atol=1e-4)
    # ... and the port's continuous engine equals its own oracle.
    assert [g[0] for g in got] == [tsrv.complete(p, n)[0]
                                   for p, n in JOBS + [LATE_JOB]]


def test_complete_batch_matches_reference(servers):
    jsrv, tsrv = servers
    prompts, budgets = [p for p, _ in JOBS], [n for _, n in JOBS]
    jo, jl, _ = jsrv.complete_batch(prompts, budgets, return_logprobs=True)
    to, tl, _ = tsrv.complete_batch(prompts, budgets, return_logprobs=True)
    assert to == jo
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_topk1_sampling_equals_greedy(servers):
    """torch.Generator draws differ from jax.random's, so sampling
    parity is pinned at top_k=1, which must equal greedy."""
    _, tsrv = servers
    greedy = tsrv.complete([5, 17, 99], 10)[0]
    sampled = tsrv.complete([5, 17, 99], 10, temperature=1.7, top_k=1,
                            key=tsrv.generator(123))[0]
    assert sampled == greedy


def test_no_device_means_the_card_and_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMServer(config=tt.LMConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--tiny", "--port", "0"])


def test_checkpoint_is_refused_with_roadmap_pointer():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LMServer(config=tt.LMConfig.tiny(), checkpoint="/nonexistent",
                 device="cpu")


def test_full_queue_sheds_and_deadline_expires(servers):
    """Admission bound (429 class) and a deadline expiring mid-decode
    (504 class), as the reference's batcher raises them."""
    _, tsrv = servers
    eng = ContinuousBatcher(tsrv, max_batch=2, segment_tokens=4,
                            max_pending=1)
    first = eng.submit_async([5, 17, 99], 40)
    with pytest.raises(ShedError):
        eng.submit_async([1, 2], 4)
    eng.wait(first, timeout=120)
    late = eng.submit_async([5, 17, 99], 60, deadline_s=0.02)
    with pytest.raises(DeadlineError):
        eng.wait(late, timeout=120)
    assert eng.drain(timeout=30)


@pytest.fixture(scope="module")
def port_http(servers):
    """The port's handler over the CPU engine, on a free port."""
    _, tsrv = servers
    batcher = ContinuousBatcher(tsrv, max_batch=2, segment_tokens=4)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve_http.make_handler(tsrv, batcher))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    batcher.drain(timeout=30)


def _post_raw(port, data: bytes, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("data,headers", [
    (b"{not json", None),
    (b'{"prompt": 5}', None),
    (b'{"prompt": "a", "temperature": -1}', None),
    (b'{"prompt": "a", "top_k": 65}', None),
    (b'{"prompt": "a", "stop": 3}', None),
    (b'{"prompt": "a", "n": 9}', None),
    (b'{"prompt": "a", "n": 2, "stream": true}', None),
    (b'{"prompt": "a", "logprobs": 2}', None),
    (b'{"prompt": "a", "timeout": -1}', None),
    (b'{"prompt": "a"}', {"x-tpu-slo-class": "urgent"}),
])
def test_bad_requests_are_400(port_http, data, headers):
    code, doc = _post_raw(port_http, data, headers)
    assert code == 400 and "error" in doc


def test_n_and_echo(port_http):
    code, doc = _post_raw(port_http, json.dumps(
        {"prompt": "ab", "max_tokens": 3, "n": 2, "echo": True}).encode(),
        {"x-tpu-slo-class": "interactive"})
    assert code == 200
    assert [c["index"] for c in doc["choices"]] == [0, 1]
    assert all(c["text"].startswith("ab") for c in doc["choices"])
    assert doc["usage"] == {"prompt_tokens": 2, "completion_tokens": 6}


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read().decode()


def _reference_families():
    """tpu_serve_* families the reference's serving and observability
    modules define."""
    names = set()
    for f in ("models/serve_engine.py", "models/serve_batch.py",
              "models/serve_http.py", "obs/ledger.py"):
        with open(os.path.join(REF_PKG, f)) as fh:
            names |= set(re.findall(r'"(tpu_serve_[a-z_]+)"', fh.read()))
    return names


def _families(text):
    fams = set()
    for ln in text.splitlines():
        m = re.match(r"# TYPE (tpu_serve_[a-z_]+) ", ln)
        if m:
            fams.add(m.group(1))
    return fams


def _reference_response_keys(jsrv):
    """Keys of a completions response from the reference's own handler."""
    from k8s_device_plugin_tpu.models.serve_http import make_handler

    batcher = jserve.ContinuousBatcher(jsrv, max_batch=2, segment_tokens=4)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(jsrv, batcher))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        _, raw = _post(httpd.server_address[1],
                       {"prompt": "hi", "max_tokens": 3, "logprobs": 1})
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.drain(timeout=30)
    doc = json.loads(raw)
    return set(doc), set(doc["choices"][0]), set(doc["usage"])


def test_daemon_main_serves_the_reference_surface(servers):
    jsrv, _ = servers
    ready = threading.Event()
    handle = {}

    def on_ready(httpd, batcher):
        handle["httpd"] = httpd
        ready.set()

    rc = {}
    daemon = threading.Thread(target=lambda: rc.setdefault(
        "rc", serve_http.main(
            ["--tiny", "--device", "cpu", "--port", "0", "--max-batch",
             "2", "--segment-tokens", "4"], on_ready=on_ready)),
        daemon=True)
    daemon.start()
    assert ready.wait(120), "daemon did not come up"
    port = handle["httpd"].server_address[1]
    try:
        code, raw = _post(port, {"prompt": "hello", "max_tokens": 5,
                                 "logprobs": 1})
        assert code == 200
        doc = json.loads(raw)
        top, choice, usage = _reference_response_keys(jsrv)
        assert set(doc) == top
        assert set(doc["choices"][0]) == choice
        assert set(doc["usage"]) == usage
        assert doc["usage"]["completion_tokens"] == 5
        lps = doc["choices"][0]["logprobs"]["token_logprobs"]
        assert len(lps) == 5 and all(v <= 0 for v in lps)
        code, raw = _post(port, {"prompt": "hello", "max_tokens": 4,
                                 "stream": True})
        frames = [ln[6:] for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        assert code == 200 and frames[-1] == "[DONE]"
        assert json.loads(frames[-2])["usage"]["completion_tokens"] == 4
        code, body = _get(port, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, text = _get(port, "/metrics")
        fams = _families(text)
        assert code == 200
        assert {"tpu_serve_ttft_seconds", "tpu_serve_requests_total",
                "tpu_serve_decode_step_seconds",
                "tpu_serve_prefill_bucket_total",
                "tpu_serve_jit_compiles_total",
                "tpu_serve_phase_seconds"} <= fams
        assert fams <= _reference_families()
    finally:
        handle["httpd"].shutdown()
        daemon.join(timeout=60)
    assert not daemon.is_alive() and rc["rc"] == 0
