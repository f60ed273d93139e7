"""Tensor-parallel serving of the port against one device and the reference.

The ports of tests/test_serve_tp.py's three cases, at its config (vocab
256, 2 layers, 4 heads over 2 kv heads, embed 64, mlp 128, max_seq 128,
RoPE, SwiGLU, float32) with the reference's ``init_params(PRNGKey(0))``
carried over by ``params_from_jax``: the port's ``LMServer`` on the
mesh of 2 gloo ranks (``{dp: 1, tp: 2}``) and of 4 (``{dp: 2, tp:
2}``) gives the greedy tokens of its one-device engine and of the
reference's one-device ``LMServer``, and at tp2 the sampled tokens of
its one-device engine with the same seed. Rank 0 leads and the others
follow (parallel/serve_ranks.py); the ranks' functions are
parallel/workers.py ``serve``, one spawn per world size, in the
background while the reference computes.

Further cases: the continuous batcher in both KV layouts at tp2 and
dp2 x tp2 (paged, with a repeated prompt and a shared prefix, so the
engine copies pages; rows), each with its jobs submitted one after
another and all at once (``together``: several rows decode in one
segment), GQA with fewer kv heads than tp (one kv
head at tp2, so each rank keeps the one its q heads read; and 6 q heads
over 3 kv heads, where a rank's q heads straddle kv heads unevenly and
its cache holds one copy per q head), greedy speculative decoding in
both layouts (equal to plain decoding), and switch-MoE layers. In every
case every rank ran rank 0's calls with the same integer results, and
rank 0's recorded calls replayed on a one-device engine give the same
results. A follower whose call raises fails rank 0 within seconds. The
daemon under ``torch.distributed.run`` at world 2 answers as the
one-device daemon does and exits 0 on every rank after SIGTERM to rank
0; ``--role prefill`` at world 2 is refused.

Exactness is asked of float32 only (every case here): tp sums a
projection's partial products in another order than one device, which
moves float32 logits by ~1e-6, far below the gaps between the top two
logits at these sizes. The MoE case is ``LMConfig.tiny(num_experts=4)``
in float32 for that reason.
"""

import concurrent.futures
import functools
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import serve as jserve
from k8s_device_plugin_tpu.models import transformer as jt
from k8s_device_plugin_tpu_torch.models import serve_http
from k8s_device_plugin_tpu_torch.models import transformer as tt
from k8s_device_plugin_tpu_torch.models.params import (
    params_from_jax,
    save_checkpoint,
)
from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer
from k8s_device_plugin_tpu_torch.parallel import launch, serve_ranks, workers
from k8s_device_plugin_tpu_torch.parallel.mesh import Mesh, build_mesh
from k8s_device_plugin_tpu_torch.parallel.sharding import (
    shard_params_for_tp,
    splits,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LLAMA = dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64,
             mlp_dim=128, max_seq_len=128, num_kv_heads=2, position="rope",
             mlp_act="swiglu")
CONFIGS = {
    "llama": LLAMA,
    "kv1": dict(LLAMA, num_kv_heads=1),
    "kv3": dict(LLAMA, num_heads=6, num_kv_heads=3, embed_dim=48),
    "moe": dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64,
                mlp_dim=128, max_seq_len=128, num_experts=4),
}

GREEDY = dict(kind="complete", prompt=[3, 14, 15, 92, 65, 35],
              max_new_tokens=12)
_RNG = np.random.default_rng(7)
BATCHED = dict(kind="complete_batch",
               prompts=[[int(t) for t in _RNG.integers(1, 200, n)]
                        for n in (3, 9, 6)],
               budgets=[8, 8, 8])
SAMPLED = dict(kind="complete", prompt=[5, 6, 7, 8], max_new_tokens=10,
               temperature=0.8, top_k=8, seed=42)
# A 20-token prompt spans two full 8-token pages and a partial tail: the
# same prompt again hits the prefix index, and the third shares its
# first two pages; extending a shared tail copies its page.
_PREFIX = list(range(1, 21))
PAGED_JOBS = [(_PREFIX, 6), (_PREFIX, 6), (_PREFIX[:16] + [99, 98, 97], 6),
              ([7, 3, 42, 11], 5)]
ROWS_JOBS = [([5, 17, 99], 7), ([7, 3, 42, 11], 9), ([1], 4)]
PAGED = dict(kind="batcher", kv_mode="paged", page_tokens=8,
             prefill_chunk=16, jobs=PAGED_JOBS)
ROWS = dict(kind="batcher", kv_mode="rows", jobs=ROWS_JOBS)

# name: (config, drive)
CASES_2 = {
    "greedy": ("llama", GREEDY),
    "batched": ("llama", BATCHED),
    "sampled": ("llama", SAMPLED),
    "paged": ("llama", PAGED),
    "rows": ("llama", ROWS),
    "kv1_paged": ("kv1", PAGED),
    "kv1_rows": ("kv1", ROWS),
    "kv3_paged": ("kv3", PAGED),
    "spec_paged": ("llama", dict(PAGED, draft=(1, 3))),
    "spec_rows": ("llama", dict(ROWS, draft=(1, 3))),
    "moe_paged": ("moe", PAGED),
    "paged_together": ("llama", dict(PAGED, together=True)),
    "rows_together": ("llama", dict(ROWS, together=True)),
}
CASES_4 = {
    "greedy": ("llama", GREEDY),
    "batched": ("llama", BATCHED),
    "paged": ("llama", PAGED),
    "rows": ("llama", ROWS),
    "kv1_paged": ("kv1", PAGED),
    "paged_together": ("llama", dict(PAGED, together=True)),
    "rows_together": ("llama", dict(ROWS, together=True)),
}
RUNS = [(2, n) for n in CASES_2] + [(4, n) for n in CASES_4]
REFERENCE = [(2, "greedy"), (2, "batched"), (4, "greedy"), (4, "batched")]


def _config(name) -> dict:
    return dict(CONFIGS[name], dtype="float32")


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's init of config ``name`` as the port's whole state
    dict (numpy)."""
    cj = jt.LMConfig(**dict(CONFIGS[name], dtype=jnp.float32))
    ct = tt.LMConfig(**_config(name))
    tree = jax.jit(lambda rng: jt.init_params(rng, cj))(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return {n: t.numpy() for n, t in params_from_jax(tree, ct).items()}


def _case(name, cases):
    cfg, d = cases[name]
    return dict(name=name, config=_config(cfg), params=_weights(cfg),
                drive=d)


@pytest.fixture(scope="module")
def ranks():
    """{world: [each rank's results]}: one spawn of 2 ranks for CASES_2
    and a follower that raises, then one of 4 for CASES_4, in the
    background."""
    cases2 = [_case(n, CASES_2) for n in CASES_2]
    cases2.append(dict(name="fail", config=_config("llama"), fail=True,
                       ack_timeout_s=3.0, drive=BATCHED))
    cases4 = [_case(n, CASES_4) for n in CASES_4]

    def run():
        return {2: launch.spawn(workers.serve, 2, cases2, timeout=300),
                4: launch.spawn(workers.serve, 4, cases4, timeout=300)}

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    yield future
    pool.shutdown(wait=True)


def _one_device(cfg):
    return LMServer(tt.LMConfig(**_config(cfg)), device="cpu",
                    params={n: torch.from_numpy(a)
                            for n, a in _weights(cfg).items()})


def _cases(world):
    return CASES_2 if world == 2 else CASES_4


@pytest.mark.parametrize("world,name", RUNS)
def test_tokens_equal_the_one_device_engine(world, name, ranks):
    cfg, d = _cases(world)[name]
    got = ranks.result()[world][0][name]
    assert got["mesh"] == ({"dp": 1, "tp": 2} if world == 2
                           else {"dp": 2, "tp": 2})
    want, _ = workers.drive(_one_device(cfg), d)
    assert got["tokens"] == want


@pytest.mark.parametrize("world,name", RUNS)
def test_every_rank_runs_rank0s_calls(world, name, ranks):
    """Every rank ran the same calls with the same integer results (the
    tokens) as rank 0, and the stop found them in step."""
    res = [r[name] for r in ranks.result()[world]]
    assert res[0]["agreed"] is True
    assert res[0]["calls"] >= 1
    for r in res[1:]:
        assert r["calls"] == res[0]["calls"]
        assert r["results"] == res[0]["results"]


@pytest.mark.parametrize("world,name", RUNS)
def test_replay_on_one_device_gives_rank0s_results(world, name, ranks):
    """The one-device engine, given rank 0's calls with their host
    arguments (block tables, lengths, tokens, generator states), returns
    every call's tokens as the ranks did."""
    cfg, _ = _cases(world)[name]
    got = ranks.result()[world][0][name]
    assert serve_ranks.replay(_one_device(cfg), got["log"]) \
        == got["results"]


@pytest.fixture(scope="module")
def reference():
    """The reference's one-device LMServer at the llama config (its own
    init is the weights every port engine here takes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_VISIBLE_CHIPS", "0")
        srv = jserve.LMServer(config=jt.LMConfig(
            **dict(LLAMA, dtype=jnp.float32)))
    assert dict(srv.mesh.shape) == {"dp": 1, "tp": 1}
    return srv


@pytest.mark.parametrize("world,name", REFERENCE)
def test_greedy_tokens_equal_the_references(world, name, ranks, reference):
    d = _cases(world)[name][1]
    if d["kind"] == "complete":
        want, _ = reference.complete(d["prompt"], d["max_new_tokens"])
    else:
        want, _ = reference.complete_batch(d["prompts"], d["budgets"])
    got = ranks.result()[world][0][name]["tokens"]
    if d["kind"] == "complete":
        got, want = [got], [want]
    assert [[int(t) for t in g] for g in got] == \
        [[int(t) for t in w] for w in want]


def test_world_one_is_the_one_device_engine():
    srv = LMServer(tt.LMConfig(**_config("llama")), device="cpu")
    assert srv.mesh.shape == {"dp": 1, "tp": 1}
    assert srv.plan is None


@pytest.mark.parametrize("world,name", [(w, n) for w, n in RUNS
                                        if "paged" in n])
def test_paged_cases_copy_pages(world, name, ranks):
    """The repeated prompt and the shared prefix reach ``copy_pages``,
    a call outside ``_dispatch``'s seam that must be mirrored too."""
    names = [m["name"] for m in ranks.result()[world][0][name]["log"]]
    assert "copy_pages" in names
    assert "make_paged_pool" in names


@pytest.mark.parametrize("world,name", [(w, n) for w, n in RUNS
                                        if n.endswith("_together")])
def test_together_cases_decode_several_rows_at_once(world, name, ranks):
    """Jobs queued together reach the engine together: a paged decode
    segment returns the tokens of two rows or more that hold pages, or
    one insert places two prefilled rows or more in the rows pool
    (``workers.rows_at_once``); queued one after another, one."""
    got = ranks.result()[world][0][name]
    assert got["rows_at_once"] >= 2
    one = ranks.result()[world][0][name.replace("_together", "")]
    assert one["rows_at_once"] == 1


@pytest.mark.parametrize("layout", ["paged", "rows"])
def test_speculative_equals_plain(layout, ranks):
    got = ranks.result()[2][0][f"spec_{layout}"]
    names = {m["name"] for m in got["log"]}
    assert "enable_draft" in names
    assert ("paged_spec_segment" if layout == "paged"
            else "spec_segment") in names
    assert got["tokens"] == ranks.result()[2][0][layout]["tokens"]


def test_a_follower_that_raises_fails_rank0_soon(ranks):
    """The follower's ``complete_batch`` raises before any collective;
    rank 0, waiting in the model's first all-reduce, fails once the
    follower leaves (the ack exchange's 3 s timeout here)."""
    r0, r1 = (r["fail"] for r in ranks.result()[2])
    assert "error" in r0 and r0["agreed"] is False
    assert r0["seconds"] < 60
    assert "raised" in r1


class _ChannelDown:
    """A Ranks stand-in whose channel fails once ``go`` is set: the
    first engine call blocks in its send until then."""

    rank, world = 0, 2

    def __init__(self):
        self.go = threading.Event()

    def send(self, msg):
        self.go.wait(30)
        raise RuntimeError("Connection closed by peer")


def test_broken_ranks_fail_queued_requests_and_refuse_calls():
    """The paged engine's first call (its pool) meets a channel that is
    down: the leader breaks, the request queued meanwhile fails, the
    engine thread ends instead of rebuilding its pool forever, and every
    later call raises RanksBroken without touching the channel."""
    from k8s_device_plugin_tpu_torch.models.serve_batch import (
        ContinuousBatcher,
    )

    channel = _ChannelDown()
    leader = serve_ranks.Leader(_one_device("llama"), channel)
    before = set(threading.enumerate())
    b = ContinuousBatcher(leader, max_batch=2, segment_tokens=4,
                          kv_mode="paged", page_tokens=8, prefill_chunk=16)
    engine, = (t for t in set(threading.enumerate()) - before
               if t.name == "llm-serve-engine")
    req = b.submit_async([1, 2, 3], 4)
    channel.go.set()
    with pytest.raises(RuntimeError, match="Connection closed"):
        b.wait(req, timeout=30)
    assert leader.closed and "Connection closed" in str(leader.broken)
    engine.join(timeout=10)
    assert not engine.is_alive(), "the engine thread lives on"
    with pytest.raises(serve_ranks.RanksBroken):
        leader.make_paged_pool(4, 8)
    assert leader.stop() is False


@pytest.mark.parametrize("h,kv,tp,want", [
    (4, 2, 2, [(0, 1, False), (1, 1, False)]),    # kv heads split
    (4, 1, 2, [(0, 1, False), (0, 1, False)]),    # one kv head, shared
    (8, 2, 4, [(0, 1, False), (0, 1, False), (1, 1, False), (1, 1, False)]),
    (6, 3, 2, [(0, 3, True), (3, 3, True)]),      # q heads straddle
    (4, 4, 1, [(0, 4, False)]),
])
def test_cache_kv_layout(h, kv, tp, want):
    cfg = tt.LMConfig(vocab_size=16, num_layers=1, num_heads=h,
                      num_kv_heads=kv, embed_dim=8 * h, mlp_dim=16,
                      max_seq_len=16)
    for r in range(tp):
        mesh = Mesh(("dp", "tp"), (1, tp), rank=r)
        plan = types.SimpleNamespace(mesh=mesh, split=splits(mesh, cfg))
        plan.width = functools.partial(tt.ShardPlan.width, plan)
        assert tt.cache_kv_layout(cfg, plan) == want[r]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_serving_layout_has_the_training_specs(shape):
    """The serving layout (``param_dtype=None``, weights in the config's
    dtype) splits every parameter as the training layout does."""
    mesh = build_mesh(("dp", "tp"), shape, world=int(np.prod(shape)))
    for name in ("llama", "kv1", "moe"):
        cfg = tt.LMConfig(**CONFIGS[name])
        with torch.device("meta"):
            serving = tt.DecoderLM(cfg)
            training = tt.DecoderLM(cfg, param_dtype=torch.float32)
        assert shard_params_for_tp(mesh, serving) == \
            shard_params_for_tp(mesh, training)


# ---------------------------------------------------------------------------
# the daemon as processes
# ---------------------------------------------------------------------------

PROMPTS = ["hello there general", "the quick brown fox"]
DAEMON = ["--device", "cpu", "--max-batch", "2", "--segment-tokens", "4",
          "--kv-page-tokens", "8", "--prefill-chunk", "16"]


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


def test_daemon_over_two_ranks_answers_as_one_device(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, tt.LMConfig(**_config("llama")),
                    {n: torch.from_numpy(a)
                     for n, a in _weights("llama").items()})
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "TPU_CHIP_LOG": str(tmp_path / "chip.jsonl")}
    log_path = tmp_path / "daemon.log"
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m",
             "k8s_device_plugin_tpu_torch.models.serve", "--port",
             str(_free_port()), "--checkpoint", ckpt, *DAEMON],
            env=env, stdout=logf, stderr=subprocess.STDOUT, cwd=tmp_path)
        try:
            deadline = time.monotonic() + 120
            text = ""
            while "listening on" not in text:
                assert proc.poll() is None and time.monotonic() < deadline, \
                    log_path.read_text()
                time.sleep(0.2)
                text = log_path.read_text()
            port = int(re.search(r"listening on :(\d+)", text).group(1))
            pid = int(re.search(r"serves \(pid (\d+)\)", text).group(1))
            got = [_complete(port, p) for p in PROMPTS]
            os.kill(pid, signal.SIGTERM)
            assert proc.wait(timeout=60) == 0, log_path.read_text()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_path.read_text()
    assert "every one in step" in text
    assert re.search(r"rank 1 stopped after \d+ calls", text)
    assert got == _one_device_daemon(ckpt)


def test_handoff_role_refused_over_ranks(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        serve_http.main(["--role", "prefill", "--tiny", "--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP A8" in capsys.readouterr().err
