"""LMServer — the serving model engine, in PyTorch on one device.

The counterpart of ``k8s_device_plugin_tpu/models/serve_engine.py``:
the model on one card (no mesh, no tensor-parallel sharding), prefill
through the flash kernel, decode loops, sampling, and the batch entry
points the continuous batcher (serve_batch.py) drives. No HTTP here —
the protocol surface lives in serve_http.py.

PyTorch runs eagerly, so the reference's jitted programs become plain
methods. The ``_dispatch`` seam stays: every shape-keyed serving
program still routes through it, and "compile" now means the first
call for a shape key (the counter and the phase histogram keep their
names, so dashboards read the same families).
"""

from __future__ import annotations

import logging
import time

import torch

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace
from k8s_device_plugin_tpu_torch.utils.device import resolve_device

log = logging.getLogger("llm-serve")


# ---------------------------------------------------------------------------
# Serving instrumentation: create-or-get against the installed registry,
# a shared no-op when none is installed. Observed per prefill / segment,
# never per token.
# ---------------------------------------------------------------------------

def _h_ttft():
    return obs_metrics.histogram(
        "tpu_serve_ttft_seconds",
        "time to first token: shared prefill + first-token sample "
        "(continuous path: request arrival to first token, queue "
        "wait included)",
        labels=("path",),
    )


def _h_decode_step():
    return obs_metrics.histogram(
        "tpu_serve_decode_step_seconds",
        "per-token decode latency: scan/segment wall time divided by "
        "its step count",
        labels=("path",),
        buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25),
    )


def _h_occupancy():
    return obs_metrics.histogram(
        "tpu_serve_batch_occupancy_ratio",
        "live request rows / batch capacity at each decode dispatch",
        labels=("mode",),
        buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
    )


def _c_prefill_bucket():
    return obs_metrics.counter(
        "tpu_serve_prefill_bucket_total",
        "prefills dispatched per prompt-length bucket (hit-rate over "
        "the compiled bucket set)",
        labels=("bucket",),
    )


def _c_decode_bucket():
    return obs_metrics.counter(
        "tpu_serve_decode_bucket_total",
        "decode scans dispatched per length bucket",
        labels=("bucket",),
    )


def _c_compiles():
    # First calls of serving programs per shape key. Eager PyTorch has no
    # trace+compile, but a new shape still pays first-call costs (kernel
    # build and load, allocator growth); steady-state serving over mixed
    # prompt lengths must hold this flat.
    return obs_metrics.counter(
        "tpu_serve_jit_compiles_total",
        "XLA trace+compiles of serving device programs, by program "
        "family (a steady-state serving process must hold this flat)",
        labels=("fn",),
    )


def _h_phase():
    return obs_metrics.histogram(
        "tpu_serve_phase_seconds",
        "serving dispatch wall time by phase: compile = first call on "
        "a shape-keyed cache miss (XLA trace+compile included), "
        "load = miss served from the persistent compilation cache, "
        "execute = steady-state dispatch; by program family",
        labels=("phase", "fn"),
    )


# Per-row top-k sampling cap: requests may ask for any top_k in
# [1, TOP_K_CAP] (0 disables); the sampler always extracts TOP_K_CAP
# candidates.
TOP_K_CAP = 64


class ShedError(RuntimeError):
    """Admission refused: the pending queue is at capacity (HTTP 429)."""


class ServerClosingError(RuntimeError):
    """Admission refused: shutdown has started (HTTP 503)."""


class DeadlineError(RuntimeError):
    """The request's deadline expired while queued or decoding (504)."""


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.long, device=device)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def default_config():
    """The daemon's model without --tiny: 8 layers, embed 1024, 16 heads,
    mlp 4096, max_seq 1024, vocab 32000, bf16 (the reference's default)."""
    from k8s_device_plugin_tpu_torch.models.transformer import LMConfig

    return LMConfig(num_layers=8, embed_dim=1024, mlp_dim=4096,
                    num_heads=16, max_seq_len=1024)


class LMServer:
    def __init__(self, config=None, checkpoint: str | None = None,
                 device=None, params: dict | None = None):
        """The serving engine on ``device`` (default: the card; raises
        when there is none — pass ``device="cpu"`` to run on the CPU).

        Weights: ``params`` (a DecoderLM state_dict, e.g. from
        models/params.py) or, without, random ones from a generator
        seeded with 0 (the reference's PRNGKey(0)). ``checkpoint``
        loading is not ported yet."""
        from k8s_device_plugin_tpu_torch.models import transformer
        from k8s_device_plugin_tpu_torch.models.tokenizer import (
            load_tokenizer,
        )

        if checkpoint:
            raise NotImplementedError(
                "checkpoint loading (orbax restore) is not ported to the "
                "PyTorch package yet: ROADMAP.md queue A, 'checkpoint "
                "loading'; serve random weights or pass params="
            )
        self.device = resolve_device(device)
        self.config = config or default_config()
        # No checkpoint, so no tokenizer files: the byte tokenizer.
        self.tokenizer = load_tokenizer(None)
        if self.tokenizer.vocab_size > self.config.vocab_size:
            # Byte fallback on a sub-256-vocab demo config: high bytes
            # clamp in the embedding gather; fine for smoke use.
            log.warning(
                "byte tokenizer (256 ids) exceeds model vocab %d; "
                "high bytes will clamp", self.config.vocab_size,
            )
        if self.config.eos_token_id >= 0:
            self.eos_id = self.config.eos_token_id
        else:
            self.eos_id = getattr(
                self.tokenizer, "vocab", {}
            ).get("<|endoftext|>")
        log.info("serving on %s", self.device)
        model = transformer.DecoderLM(self.config)
        if params is not None:
            model.load_state_dict(params)
            model = model.to(self.device)
        else:
            model = transformer.init_params(model.to(self.device), seed=0)
        self.model = model.eval()
        # Set by the batcher's warmup: complete_batch then refuses
        # batches wider than what was warmed.
        self.max_rows: int | None = None
        # Shape-keyed program caches (see _dispatch).
        self._scan_cache: dict[tuple, object] = {}
        self._segment_cache: dict[tuple, object] = {}

    def generator(self, seed: int = 0) -> torch.Generator:
        """A sampling generator on the serving device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _dispatch(self, fn: str, cache: dict, key, build, *args):
        """Run one shape-keyed serving program with phase timing.

        The single dispatch seam for the program caches: a miss builds
        the callable, bumps ``tpu_serve_jit_compiles_total{fn}`` and
        times as ``phase="compile"`` (the first call of that shape);
        a hit times as ``phase="execute"``. Each call emits a child
        trace span."""
        miss = key not in cache
        phase = "compile" if miss else "execute"
        start = time.perf_counter()
        with obs_trace.span(f"serve.dispatch.{fn}", journal=False,
                            fn=fn) as sp:
            if miss:
                _c_compiles().inc(fn=fn)
                cache[key] = build()
            sp.fields["phase"] = phase
            out = cache[key](*args)
        _h_phase().observe(time.perf_counter() - start,
                           phase=phase, fn=fn)
        return out

    def encode_prompt(self, prompt: str) -> list:
        """Tokenize a text prompt: prepend the recorded bos id when the
        config carries one. Keeps the most recent 4096 ids and never
        returns an empty prompt."""
        toks = self.tokenizer.encode(prompt)
        bos = self.config.bos_token_id
        if bos >= 0:
            # Truncate BEFORE prepending, or an over-long prompt would
            # slice the bos right back off.
            if toks and toks[0] == bos:
                toks = toks[1:]
            return [bos] + toks[-4095:]
        return toks[-4096:] or [0]

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def _sample_logits(self, logits, gen: torch.Generator, temp, topk):
        """Per-row sample from [rows, vocab] logits.

        temp[r] == 0 -> greedy argmax (first index on ties, as jnp);
        topk[r] in [1, TOP_K_CAP] masks to the row's k best logits (0 =
        no mask). The draw is Gumbel-max, the method of
        jax.random.categorical; torch.Generator's bits differ from
        jax.random's, so only greedy and top_k=1 match the reference."""
        rows = logits.shape[0]
        greedy = logits.argmax(-1)
        vals, _ = torch.topk(logits, min(TOP_K_CAP, logits.shape[-1]), -1)
        kth = vals[torch.arange(rows, device=logits.device),
                   torch.clamp(topk - 1, 0, vals.shape[-1] - 1)]
        keep = (topk <= 0)[:, None] | (logits >= kth[:, None])
        masked = logits.masked_fill(~keep, float("-inf")).float()
        scaled = masked / torch.clamp(temp, min=1e-6)[:, None]
        u = torch.rand(scaled.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        sampled = (scaled + gumbel).argmax(-1)
        return torch.where(temp > 0, sampled, greedy)

    def _sample_with_logp(self, logits, gen, temp, topk):
        """(token, logprob) per row — the logprob is the chosen token's
        log-probability under the model's raw distribution."""
        tok = self._sample_logits(logits, gen, temp, topk)
        logp = torch.log_softmax(logits.float(), dim=-1)
        rows = logits.shape[0]
        return tok, logp[torch.arange(rows, device=logits.device), tok]

    def _first_fn(self, logits, lens, gen, temp, topk):
        """First token out of a prefill: each row's last-prompt logits."""
        rows = logits.shape[0]
        last = logits[torch.arange(rows, device=logits.device), lens - 1]
        return self._sample_with_logp(last, gen, temp, topk)

    # ------------------------------------------------------------------
    # prefill + static batch path (the oracle the continuous engine is
    # held to)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor):
        """Prefill ``tokens [rows, bucket]`` into a fresh rows cache
        (index 0); returns (logits [rows, bucket, vocab], cache). Every
        layer's attention runs through the flash kernel."""
        from k8s_device_plugin_tpu_torch.models.transformer import new_cache

        cache = new_cache(self.config, tokens.shape[0], self.device)
        logits = self.model(tokens, cache, prefill=True)
        return logits, cache

    def complete(self, prompt_tokens, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0, key=None):
        """Decode one prompt; returns (tokens, TTFT seconds). ``key`` is
        a torch.Generator."""
        if max_new_tokens <= 0:
            return list(prompt_tokens), 0.0
        outs, ttft = self.complete_batch(
            [prompt_tokens], [max_new_tokens],
            temps=[temperature], topks=[top_k], key=key,
        )
        return outs[0], ttft

    @torch.inference_mode()
    def complete_batch(self, prompts, max_new_tokens,
                       temps=None, topks=None, key=None,
                       return_logprobs: bool = False):
        """Decode a batch of prompts together; returns (token lists,
        shared TTFT seconds) — or, with ``return_logprobs``, (token
        lists, per-continuation-token logprob lists, TTFT).

        Every prompt right-pads into ONE prefill at the widest prompt's
        bucket, the cache index rewinds to a per-row length vector, and
        one decode loop at the widest budget decodes all rows; each
        request's continuation is sliced out on the host. ``key`` (a
        torch.Generator) is required when any row samples."""
        from k8s_device_plugin_tpu_torch.models.transformer import (
            set_cache_index,
        )

        dev = self.device
        B = len(prompts)
        if B < 1:
            return ([], [], 0.0) if return_logprobs else ([], 0.0)
        temps = [0.0] * B if temps is None else list(temps)
        topks = [0] * B if topks is None else list(topks)
        sampled = any(t > 0 for t in temps) or any(k > 0 for k in topks)
        if sampled and key is None:
            raise ValueError("sampling requires a generator (key=)")
        seq = self.config.max_seq_len
        budgets, p_lens, rows, padded = self._batch_setup(
            prompts, max_new_tokens
        )
        temps += [0.0] * (rows - len(temps))
        topks += [0] * (rows - len(topks))
        temp_v, topk_v = _f32(temps, dev), _long(topks, dev)
        if key is None:
            key = self.generator(0)

        start = time.perf_counter()
        logits, cache = self._prefill(_long(padded, dev))
        lens = _long(p_lens, dev)
        cache = set_cache_index(cache, lens)
        first, first_lp = self._first_fn(logits, lens, key, temp_v, topk_v)
        first_host = first.cpu()
        ttft = time.perf_counter() - start
        _h_ttft().observe(ttft, path="static")
        _h_occupancy().observe(B / rows, mode="static")

        budgets = [min(n, seq - p) for n, p in zip(budgets, p_lens[:B])]
        remaining = max(budgets) - 1
        conts = [[int(first_host[b])] for b in range(B)]
        if return_logprobs:
            first_lp_host = first_lp.cpu()
            lps = [[float(first_lp_host[b])] for b in range(B)]
        else:
            lps = [[] for _ in range(B)]
        if remaining > 0:
            decode_start = time.perf_counter()
            bucket = self._scan_bucket(remaining)
            _c_decode_bucket().inc(bucket=str(bucket))
            toks, scan_lps = self._dispatch(
                "decode_scan", self._scan_cache, (bucket, sampled),
                lambda: self._build_decode_scan(bucket, sampled),
                cache, first[:, None], key, temp_v, topk_v,
            )
            toks_host = toks.cpu()   # [bucket, rows]
            _h_decode_step().observe(
                (time.perf_counter() - decode_start) / bucket,
                path="static",
            )
            for b in range(B):
                conts[b].extend(
                    int(t) for t in toks_host[: budgets[b] - 1, b]
                )
            if return_logprobs:
                lps_host = scan_lps.cpu()
                for b in range(B):
                    lps[b].extend(
                        float(v) for v in lps_host[: budgets[b] - 1, b]
                    )
        outs, out_lps = self._finish_outs(prompts, conts, lps)
        return (outs, out_lps, ttft) if return_logprobs else (outs, ttft)

    def _batch_setup(self, prompts, max_new_tokens):
        """Validate, window each prompt into the fixed-capacity cache
        (leaving room for ITS generation), pad to the power-of-two row
        bucket. Returns (budgets, p_lens, rows, padded)."""
        B = len(prompts)
        budgets = list(max_new_tokens)
        if len(budgets) != B:
            raise ValueError("one max_new_tokens per prompt")
        if min(budgets) < 1:
            raise ValueError("complete_batch needs budgets >= 1 "
                             "(complete() short-circuits 0)")
        if self.max_rows is not None and B > self.max_rows:
            raise ValueError(
                f"batch of {B} exceeds warmed max batch {self.max_rows}"
            )
        seq = self.config.max_seq_len
        windows, p_lens = [], []
        for toks, n in zip(prompts, budgets):
            keep = max(1, seq - n)
            w = list(toks)[-keep:] or [0]
            windows.append(w)
            p_lens.append(len(w))
        bucket = self._prefill_bucket(max(p_lens))
        _c_prefill_bucket().inc(bucket=str(bucket))
        rows = self._bucket(B, 1, cap=self.max_rows)
        padded = [w + [0] * (bucket - len(w)) for w in windows]
        while len(padded) < rows:          # dummy rows decode garbage
            padded.append([0] * bucket)
            p_lens.append(1)
        return budgets, p_lens, rows, padded

    def _finish_outs(self, prompts, conts, lps):
        """EOS-truncate each continuation (and its logprobs) and prepend
        the prompt."""
        outs, out_lps = [], []
        for p, c, lp in zip(prompts, conts, lps):
            if self.eos_id is not None and self.eos_id in c:
                cut = c.index(self.eos_id)
                c, lp = c[:cut], lp[:cut]
            outs.append(list(p) + c)
            out_lps.append(lp)
        return outs, out_lps

    @staticmethod
    def _bucket(n: int, floor: int, cap: int | None) -> int:
        """Smallest power-of-two >= max(n, floor), capped at ``cap`` —
        the one bucketing rule for prefill lengths, decode lengths and
        batch rows."""
        bucket = floor
        while bucket < n:
            bucket *= 2
        return bucket if cap is None else min(bucket, cap)

    def _prefill_bucket(self, p_len: int) -> int:
        # floor 128: the padded prefill (and its K/V written into the
        # cache) matches the reference's buckets token for token
        return self._bucket(p_len, 128, self.config.max_seq_len)

    def _scan_bucket(self, n: int) -> int:
        """Decode-loop length bucket for an n-token continuation."""
        return self._bucket(n, 8, self.config.max_seq_len)

    def _decode_steps(self, cache, tok, gen, temp, topk, steps: int,
                      sampled: bool = True):
        """``steps`` single-token decode steps over every cache row,
        updating ``cache`` in place (the reference's lax.scan carry).
        Returns (tokens [steps, rows], logprobs [steps, rows])."""
        toks, lps = [], []
        for _ in range(steps):
            last = self.model(tok, cache)[:, -1]
            if sampled:
                nxt, lp = self._sample_with_logp(last, gen, temp, topk)
            else:
                nxt = last.argmax(-1)
                lp = torch.log_softmax(last, dim=-1)[
                    torch.arange(last.shape[0], device=last.device), nxt]
            toks.append(nxt)
            lps.append(lp)
            tok = nxt[:, None]
        return torch.stack(toks), torch.stack(lps)

    def _build_decode_scan(self, bucket: int, sampled: bool = False):
        """The ``bucket``-token decode loop of complete_batch (dispatched
        through :meth:`_dispatch`). The greedy variant skips the
        sampling ops."""
        def decode_scan(cache, tok, gen, temp, topk):
            return self._decode_steps(cache, tok, gen, temp, topk, bucket,
                                      sampled=sampled)

        return decode_scan

    # ------------------------------------------------------------------
    # continuous batching device helpers
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def make_pool_cache(self, rows: int):
        """A fresh rows-wide kv-cache pool (per-row index vector)."""
        from k8s_device_plugin_tpu_torch.models.transformer import (
            new_cache,
            set_cache_index,
        )

        return set_cache_index(
            new_cache(self.config, rows, self.device),
            torch.ones((rows,), dtype=torch.long),
        )

    @torch.inference_mode()
    def insert_rows(self, pool, new_cache, row_ids):
        """Scatter prefilled cache rows into the pool at ``row_ids``, in
        place (the reference donates the pool and returns a new one).
        Every leaf — k/v blocks and the per-row index — has a leading
        row axis, so one scatter rule covers all of them."""
        ids = _long(row_ids, self.device)
        for dst, src in zip(pool.k + pool.v, new_cache.k + new_cache.v):
            dst.index_copy_(0, ids, src.to(dst.dtype))
        new_idx = new_cache.idx
        if new_idx.dim() == 0:
            new_idx = new_idx.expand(len(row_ids))
        pool.idx = pool.idx.index_copy(0, ids, new_idx.to(pool.idx.dtype))
        return pool

    @torch.inference_mode()
    def decode_segment(self, pool, tok, gen, temp, topk, segment: int):
        """One fixed-length decode segment over the whole row pool.

        Returns (pool, tokens [segment, rows], logprobs [segment,
        rows]); the pool is updated in place. Retired and unassigned
        rows decode garbage alongside the live ones — the matmuls run at
        pool width regardless, and their cache rows are overwritten at
        the next insert_rows."""
        dev = self.device

        def build():
            def run(pool, tok, gen, temp, topk):
                toks, lps = self._decode_steps(pool, tok, gen, temp, topk,
                                               segment)
                return pool, toks, lps

            return run

        return self._dispatch(
            "segment_scan", self._segment_cache,
            (segment, tok.shape[0]), build,
            pool, _long(tok, dev), gen, _f32(temp, dev), _long(topk, dev),
        )

    @torch.inference_mode()
    def prefill_rows(self, windows, p_lens, temps, topks, key):
        """Prefill padded prompt rows and sample each row's first token.

        Returns (cache with per-row indices, first tokens on host,
        first-token logprobs on host). Caller guarantees len(windows) is
        the power-of-two row bucket. ``key`` is a torch.Generator."""
        from k8s_device_plugin_tpu_torch.models.transformer import (
            set_cache_index,
        )

        dev = self.device
        bucket = self._prefill_bucket(max(p_lens))
        _c_prefill_bucket().inc(bucket=str(bucket))
        padded = [w + [0] * (bucket - len(w)) for w in windows]
        logits, cache = self._prefill(_long(padded, dev))
        lens = _long(p_lens, dev)
        cache = set_cache_index(cache, lens)
        first, first_lp = self._first_fn(
            logits, lens, key, _f32(temps, dev), _long(topks, dev),
        )
        return cache, first.cpu().numpy(), first_lp.cpu().numpy()
