"""The prefill/decode roles under tensor parallelism against one device
and the reference.

A bundle carries whole pages, so replicas of any world size pair. The
port's pairs run in process over gloo ranks (parallel/workers.py
``handoff``: rank 0 leads each replica it is in and drives a prefill
and a decode ContinuousBatcher over the in-process transport; the other
ranks follow; one spawn of 4 ranks, a pair on fewer leaving the rest
idle): tp2 -> tp2, tp2 -> one rank and one rank -> dp2 x tp2
at the float32 config of tests/test_torch_serve_tp.py (4 q heads over 2
kv heads: the *split* layout), 4 q heads over 1 kv head at tp2 (the
*shared* layout) and 12 q heads over 2 kv heads at tp3 (the *expand*
layout, one copy per q head). In each the decode side's greedy tokens
equal the one-device single engine's and a one-device pair's, every
request is handed off once with no lease left, every rank stayed in
step, and a seeded page block crosses each replica's import and export
bit for bit (the bundle is byte for byte what one device exports from
the same pages); the pair's bundles carry as many page bytes as a
one-device pair's, their pages within float32 noise of its.

Then the daemons: a ``--role prefill`` daemon under
``torch.distributed.run`` at 2 ranks serving a float32 checkpoint, a
``--role decode`` daemon at 4 ranks (dp2 x tp2) fetching from it, and a
reference replica (the JAX package's decode-role batcher over HTTP) on
the other side of the same tp2 hop: the decode daemon answers as the
one-device daemon does, the reference replica's tokens equal the port's
one-device engine's, and both launches exit 0 after SIGTERM to rank 0.
"""

import concurrent.futures
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import handoff as jhandoff
from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import serve_http
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import (
    params_from_jax,
    save_checkpoint,
)
from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer
from k8s_device_plugin_tpu_torch.parallel import launch, workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64,
             mlp_dim=128, max_seq_len=128, num_kv_heads=2, position="rope",
             mlp_act="swiglu")
CONFIGS = {"split": LLAMA,
           "shared": dict(LLAMA, num_kv_heads=1),
           "expand": dict(LLAMA, num_heads=12, embed_dim=96)}
_PREFIX = list(range(1, 21))
# a 20-token prompt spans two full 8-token pages and a partial tail; the
# third shares its first two pages
JOBS = [(_PREFIX, 6), ([7, 3, 42, 11], 5), (_PREFIX[:16] + [99, 98, 97], 6)]
DRIVE = dict(jobs=JOBS, max_batch=2, segment_tokens=4, page_tokens=8,
             prefill_chunk=16)
# name: (world, config, prefill mesh, decode mesh)
CASES = {
    "tp2_to_tp2": (2, "split", (1, 2), (1, 2)),
    "tp2_to_one": (2, "split", (1, 2), (1, 1)),
    "shared_tp2_to_tp2": (2, "shared", (1, 2), (1, 2)),
    "one_to_dp2_tp2": (4, "split", (1, 1), (2, 2)),
    "expand_tp3_to_tp3": (3, "expand", (1, 3), (1, 3)),
}
# (first, heads, expand) of each tp rank's KV (transformer.cache_kv_layout)
LAYOUTS = {"split": [(0, 1, False), (1, 1, False)],
           "shared": [(0, 1, False), (0, 1, False)],
           "expand": [(0, 4, True), (4, 4, True), (8, 4, True)]}


def _config(name) -> dict:
    return dict(CONFIGS[name], dtype="float32")


@pytest.fixture(scope="module")
def ranks():
    """[each rank's results] of one spawn of 4 ranks for every case (a
    case on fewer ranks leaves the rest idle), in the background."""
    cases = [dict(name=n, config=_config(cfg), prefill=p, decode=d,
                  drive=DRIVE) for n, (_, cfg, p, d) in CASES.items()]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.spawn, workers.handoff,
                         max(c[0] for c in CASES.values()), cases,
                         timeout=300)
    yield future
    pool.shutdown(wait=True)


def _got(ranks, name) -> list:
    return [r[name] for r in ranks.result()[:CASES[name][0]]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tokens_equal_the_one_device_engine(name, ranks):
    r0 = _got(ranks, name)[0]
    one = r0["one_device"]
    assert r0["tokens"] == one["tokens"] == one["pair_tokens"]
    assert [len(t) for t in r0["tokens"]] == [len(p) + n for p, n in JOBS]
    assert r0["hops"] == len(JOBS) and r0["leases_left"] == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_bundles_hold_whole_pages(name, ranks):
    """A seeded whole page block imported into each replica's pool and
    exported back is the same block, bit for bit, on every mesh (the
    export gathers over tp what the import sliced to each rank's kv
    heads). The pair's bundles hold as many page bytes as a one-device
    pair's, and their pages equal the one-device pair's within
    workers.BUNDLE_TOL (allclose): past the first layer K/V read
    all-reduced sums, whose float32 order differs from one device's."""
    r0 = _got(ranks, name)[0]
    assert r0["round_trip"] == {"prefill": True, "decode": True}
    assert r0["bundle_ratio"] <= 1.0, r0["bundle_max_err"]
    assert r0["page_bytes"] == r0["one_device"]["page_bytes"]
    assert len(r0["page_bytes"]) == len(JOBS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_stays_in_step(name, ranks):
    got = _got(ranks, name)
    assert all(r["agreed"] for r in got)
    calls = got[0]["calls"]
    for r in got[1:]:
        assert r["calls"] == {role: n for role, n in calls.items()
                              if role in r["calls"]}


@pytest.mark.parametrize("name,layout", [("tp2_to_tp2", "split"),
                                         ("shared_tp2_to_tp2", "shared"),
                                         ("expand_tp3_to_tp3", "expand")])
def test_kv_layouts(name, layout, ranks):
    """The three layouts of cache_kv_layout on the decode replica's
    ranks, each one export gathers whole pages from and import slices."""
    got = [tuple(r["kv_layout"]["decode"]) for r in _got(ranks, name)]
    assert got == LAYOUTS[layout]


# ---------------------------------------------------------------------------
# the daemons, and a reference replica across a tp2 hop
# ---------------------------------------------------------------------------

DAEMON = ["--device", "cpu", "--max-batch", "2", "--segment-tokens", "4",
          "--kv-page-tokens", "8", "--prefill-chunk", "16"]
PROMPTS = ["the port serves", "handoff over tensor parallel ranks"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _complete(port, prompt):
    body = json.dumps({"prompt": prompt, "max_tokens": 8,
                       "logprobs": 1}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        doc = json.loads(r.read())
    choice = doc["choices"][0]
    assert doc["usage"]["completion_tokens"] == 8
    return choice["text"], choice["logprobs"]["tokens"]


class _Launch:
    """``python -m torch.distributed.run`` of the daemon, its log in a
    file; ``stop()`` sends SIGTERM to rank 0 and returns the exit code."""

    def __init__(self, nproc, argv, tmp_path, name):
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
               "TPU_CHIP_LOG": str(tmp_path / f"{name}.jsonl")}
        self.log = tmp_path / f"{name}.log"
        self.port = _free_port()
        with open(self.log, "w") as logf:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(nproc), "-m",
                 "k8s_device_plugin_tpu_torch.models.serve", "--port",
                 str(self.port), *argv],
                env=env, stdout=logf, stderr=subprocess.STDOUT,
                cwd=tmp_path)

    def ready(self, timeout=120.0):
        deadline = time.monotonic() + timeout
        while "listening on" not in self.log.read_text():
            assert self.proc.poll() is None and \
                time.monotonic() < deadline, self.log.read_text()
            time.sleep(0.2)
        return self

    def stop(self) -> int:
        text = self.log.read_text()
        pid = int(re.search(r"serves \(pid (\d+)\)", text).group(1))
        os.kill(pid, signal.SIGTERM)
        return self.proc.wait(timeout=60)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _one_device_daemon(ckpt):
    out = {}

    def ask(httpd):
        try:
            out["answers"] = [_complete(httpd.server_address[1], p)
                              for p in PROMPTS]
        finally:
            httpd.shutdown()

    def on_ready(httpd, batcher):
        threading.Thread(target=ask, args=(httpd,), daemon=True).start()

    assert serve_http.main(["--port", "0", "--checkpoint", ckpt, *DAEMON],
                           on_ready=on_ready) == 0
    return out["answers"]


def _reference_decode(jsrv, peer):
    """The JAX package's decode replica fetching from ``peer``: its
    tokens for JOBS, one request at a time."""
    client = jhandoff.HandoffClient(jhandoff.HTTPTransport(peer), peer=peer)
    b = jserve.ContinuousBatcher(jsrv, max_batch=2, segment_tokens=4,
                                 kv_mode="paged", page_tokens=8,
                                 prefill_chunk=16, role="decode",
                                 handoff_client=client)
    try:
        b.warmup()
        out = []
        for prompt, budget in JOBS:
            req = b.submit_async(list(prompt), budget)
            b.wait(req, timeout=120)
            out.append(list(req.slot["tokens"]))
        return out, len(client.latencies_s)
    finally:
        b.close()


def test_daemons_over_ranks_and_a_reference_replica(tmp_path, monkeypatch):
    # the in-process daemon's forensics go to the test's directory
    monkeypatch.setenv("TPU_CHIP_LOG", str(tmp_path / "one.jsonl"))
    jcfg = jt.LMConfig(**LLAMA, dtype=jnp.float32)
    ct = tt.LMConfig(**_config("split"))
    jsrv = jserve.LMServer(config=jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jsrv.params),
                            ct)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, ct, state)
    prefill = _Launch(2, ["--checkpoint", ckpt, "--role", "prefill",
                          *DAEMON], tmp_path, "prefill")
    decode = None
    try:
        prefill.ready()
        peer = f"http://127.0.0.1:{prefill.port}"
        decode = _Launch(4, ["--checkpoint", ckpt, "--role", "decode",
                             "--handoff-peer", peer, *DAEMON], tmp_path,
                         "decode").ready()
        answers = [_complete(decode.port, p) for p in PROMPTS]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{decode.port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        ref_tokens, ref_hops = _reference_decode(jsrv, peer)
        assert decode.stop() == 0, decode.log.read_text()
        assert prefill.stop() == 0, prefill.log.read_text()
    finally:
        prefill.kill()
        if decode is not None:
            decode.kill()
    assert answers == _one_device_daemon(ckpt)
    one = LMServer(ct, device="cpu", params=state)
    want, _ = workers.drive(one, dict(DRIVE, kind="batcher",
                                      kv_mode="paged"))
    assert ref_tokens == want and ref_hops == len(JOBS)
    for launched, world in ((prefill, 2), (decode, 4)):
        text = launched.log.read_text()
        assert f"rank 0 of {world} serves" in text
        assert "every one in step" in text
    imported = re.search(r'tpu_serve_handoff_total\{[^}]*outcome="imported"'
                         r'[^}]*\} (\S+)', metrics)
    assert imported and float(imported.group(1)) == len(PROMPTS)
