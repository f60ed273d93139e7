"""LMServer — the serving model engine, in PyTorch.

The counterpart of ``k8s_device_plugin_tpu/models/serve_engine.py``:
the model on the ``dp x tp`` mesh of the ranks a launcher started (one
card without one), prefill
through the flash kernel, decode loops, sampling, the batch entry
points the rows-mode continuous batcher (serve_batch.py) drives, and
the paged programs its paged engine drives (chunked prefill and decode
segments over a page pool, read through kernel B2; page copies; the
export and import of page blocks for the disaggregated roles), and
self-draft speculative decoding over either KV layout
(models/speculative.py). No HTTP here — the protocol surface lives in
serve_http.py.

PyTorch runs eagerly, so the reference's jitted programs become plain
methods. The ``_dispatch`` seam stays: every shape-keyed serving
program still routes through it, and the counter and the phase
histogram keep their names, so dashboards read the same families. The
phases of a dispatch, against the reference's (serve_engine.py
``_dispatch``):

- ``execute``: a hit on the shape-keyed program cache.
- ``load``: a miss whose first call opened a kernel library from the
  persistent compile cache (``--compile-cache-dir``,
  models/compile_cache.py) and ran no nvcc; it does not count in
  ``tpu_serve_jit_compiles_total``, as a reference disk load does not.
- ``compile``: any other miss: one whose first call ran nvcc, or that
  only built its closure (a shape met for the first time). It counts
  in ``tpu_serve_jit_compiles_total{fn}``.

Without a persistent cache no dispatch is ``load``, and every count is
what it was before the cache existed.

**On a mesh.** ``LMServer`` builds ``mesh_from_env(("dp", "tp"))`` as
the reference does (world 2: ``{dp: 1, tp: 2}``; world 4: ``{dp: 2,
tp: 2}``), and its model is one rank's part of ``DecoderLM`` on a
``ShardPlan`` of that mesh: the q heads, the kv heads where they
divide, and the MLP's features split over tp (parallel/sharding.py's
rules; MoE experts replicate, there being no ep axis), each attention
and MLP block's output summed over tp. Weights come in whole (the
seed-0 init, ``params=`` or a checkpoint) on every rank, which keeps its
part. The KV caches and page pools of a rank hold its kv heads only
(transformer.py ``cache_kv_layout``), so B1 and B2 run on the rank's
share of the heads. dp replicas compute the same rows, as the
reference's GSPMD program does over an unsharded batch. The
programs run on every rank in one order: rank 0 serves and sends each
call to the others first (parallel/serve_ranks.py). Every rank's logits
of the rows that hold data are the same bits (the lm head is replicated
and reads the output of an all-reduce that hands each rank the same
sum), so every rank samples rank 0's tokens from the same generator
state; ``defined_result`` says which rows those are. A mesh of one rank
is the one-device engine.
"""

from __future__ import annotations

import functools
import inspect
import logging
import threading
import time

import torch

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace
from k8s_device_plugin_tpu_torch.ops import _build
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


# Engine methods that touch device state, each with the rule for the part
# of its result that is defined (None: all of it). On a mesh, rank 0's
# engine sends each call of one of them to the other ranks before it
# runs, and holds the ranks to the defined part of their results after
# (parallel/serve_ranks.py); any other method runs on rank 0 alone.
MIRRORED: dict = {}
# Engine attributes that shape later programs (complete_batch pads its
# rows up to max_rows): a set on rank 0 is sent too.
MIRRORED_ATTRS = frozenset({"max_rows"})


def mirrored(defined=None):
    """Mark an ``LMServer`` method as one that touches device state
    (``MIRRORED``). ``defined(arguments, out)``, given the call's bound
    arguments by name and its result, returns the part of the result
    that the ranks of a mesh must agree on."""
    def mark(fn):
        MIRRORED[fn.__name__] = defined
        return fn
    return mark


def _held_rows(arguments, out, steps_first: bool = False):
    """The tokens of a paged program's rows that hold a page. A padding
    row's block table is all scratch page (page 0, never allocated), and
    the padding rows' K/V writes collide on its slots, which on the card
    land in no fixed order; so a padding row's tokens read whichever
    write won, and nothing reads them. ``steps_first``: the tokens are
    ``[steps, rows]``."""
    held = torch.as_tensor(arguments["bt"])[:, 0].cpu() != 0
    toks = torch.as_tensor(out[1]).cpu()
    return toks[:, held] if steps_first else toks[held]


def _bundle_digest(arguments, out):
    """What the ranks agree on after ``export_pages``: the sha256 of the
    whole bundle each assembled (the same within a tp group by
    construction; across dp replicas only when they hold the same
    pages)."""
    import hashlib

    h = hashlib.sha256()
    for layer in sorted(out):
        for leaf in ("k_pages", "v_pages"):
            h.update(out[layer]["attn"][leaf].tobytes())
    return list(h.digest())


def default_config():
    """The daemon's model without --tiny: 8 layers, embed 1024, 16 heads,
    mlp 4096, max_seq 1024, vocab 32000, bf16 (the reference's default)."""
    from k8s_device_plugin_tpu_torch.models.transformer import LMConfig

    return LMConfig(num_layers=8, embed_dim=1024, mlp_dim=4096,
                    num_heads=16, max_seq_len=1024)


class LMServer:
    # No engine call will run again: never so for one process's engine
    # (serve_ranks.Leader's is closed once its ranks broke or stopped).
    closed = False

    def __init__(self, config=None, checkpoint: str | None = None,
                 device=None, params: dict | None = None,
                 compile_cache_dir: str | None = None, mesh=None):
        """The serving engine on ``device`` (default: the card; raises
        when there is none — pass ``device="cpu"`` to run on the CPU),
        over ``mesh`` (default: ``mesh_from_env(("dp", "tp"), device)``,
        one rank without a launcher; module docstring).

        Weights: ``params`` (a DecoderLM state_dict, e.g. from
        models/params.py); else ``checkpoint``, the port's checkpoint
        directory (models/params.py ``save_checkpoint``), whose
        ``lm_config.json`` sets the config when ``config`` is None and
        whose tokenizer files, when there are any, set the tokenizer; else
        random ones from a generator seeded with 0 (the reference's
        PRNGKey(0)). A directory holding only the reference's orbax
        ``params/`` raises ``ValueError`` naming tools/orbax_to_torch.py.

        ``compile_cache_dir`` (else ``TPU_COMPILE_CACHE_DIR``; unset:
        none) is the persistent kernel-library cache the process's
        kernel builds go through (models/compile_cache.py)."""
        from k8s_device_plugin_tpu_torch.models import transformer
        from k8s_device_plugin_tpu_torch.models.params import (
            load_checkpoint,
        )
        from k8s_device_plugin_tpu_torch.models.tokenizer import (
            ByteTokenizer,
            load_tokenizer,
        )
        from k8s_device_plugin_tpu_torch.parallel import sharding
        from k8s_device_plugin_tpu_torch.parallel.mesh import mesh_from_env

        self.mesh = mesh or mesh_from_env(("dp", "tp"), device)
        self.device = resolve_device(self.mesh.device or device)
        if checkpoint:
            ckpt_config, ckpt_params = load_checkpoint(checkpoint)
            if config is None and ckpt_config is not None:
                config = ckpt_config
                log.info("config from %s", checkpoint)
            if params is None:
                params = ckpt_params
        self.config = config or default_config()
        self.tokenizer = load_tokenizer(checkpoint)
        if self.tokenizer.vocab_size > self.config.vocab_size:
            if not isinstance(self.tokenizer, ByteTokenizer):
                # The checkpoint's own tokenizer not fitting its own
                # model is a broken conversion: refuse rather than emit
                # clamped ids.
                raise ValueError(
                    f"tokenizer vocab {self.tokenizer.vocab_size} exceeds "
                    f"model vocab {self.config.vocab_size}"
                )
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
        log.info("serving on mesh %s (%s)", self.mesh.shape, self.device)
        # Persistent kernel cache: the process's kernel libraries open
        # from this store when it holds them, and nvcc builds write back,
        # so a restarted (or Nth) replica runs no nvcc.
        from k8s_device_plugin_tpu_torch.models import compile_cache as cc

        cache_dir = compile_cache_dir or cc.cache_dir_from_env()
        self._compile_cache = None
        if cache_dir:
            pc = cc.CompileCache(cache_dir,
                                 max_bytes=cc.max_bytes_from_env())
            if pc.dir is not None:
                self._compile_cache = pc
                _build.set_persistent_cache(pc)
                log.info("persistent compile cache at %s", cache_dir)
        model = transformer.DecoderLM(self.config)
        if params is not None:
            # strict: every weight of the config, no stray one; the copy
            # casts float32 checkpoint weights to the serving dtype
            model.load_state_dict(params, strict=True)
            model = model.to(self.device)
        else:
            model = transformer.init_params(model.to(self.device), seed=0)
        self.plan = None
        if self.mesh.world > 1:
            # every rank holds the whole model here; keep this rank's part
            self.plan = transformer.ShardPlan(self.mesh, self.config,
                                              False, "ring")
            whole = model.state_dict()
            with torch.device("meta"):
                model = transformer.DecoderLM(self.config, plan=self.plan)
            model.load_state_dict(sharding.shard_state_dict(
                self.mesh, self.plan.specs, whole), strict=True,
                assign=True)
            del whole
        self.model = model.eval()
        # Set by the batcher's warmup: complete_batch then refuses
        # batches wider than what was warmed.
        self.max_rows: int | None = None
        # Shape-keyed program caches (see _dispatch).
        self._scan_cache: dict[tuple, object] = {}
        self._segment_cache: dict[tuple, object] = {}
        self._paged_cache: dict[tuple, object] = {}
        # Speculative decoding (enable_draft): the self-draft model and
        # the spec loops, keyed by budget bucket / segment shape.
        self.spec_k: int | None = None
        self.draft_config = None
        self.draft_model = None
        self._spec_cache: dict = {}
        # Live acceptance telemetry: emitted tokens / verify rounds is
        # the number operators tune --speculative-k and --draft-layers
        # by. Written by the engine thread, read by the /healthz handler
        # thread — every touch holds _spec_mu (spec_stats_snapshot is
        # the cross-thread read surface).
        self._spec_mu = threading.Lock()
        self.reset_spec_stats()

    def generator(self, seed: int = 0) -> torch.Generator:
        """A sampling generator on the serving device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _dispatch(self, fn: str, cache: dict, key, build, *args):
        """Run one shape-keyed serving program with phase timing.

        The single dispatch seam for the program caches: a miss builds
        the callable and runs it; it times as ``phase="load"`` when that
        first call opened a kernel library from the persistent cache and
        ran no nvcc, else as ``phase="compile"`` and bumps
        ``tpu_serve_jit_compiles_total{fn}`` (module docstring); a hit
        times as ``phase="execute"``. Each call emits a child trace
        span."""
        miss = key not in cache
        phase = "execute"
        start = time.perf_counter()
        with obs_trace.span(f"serve.dispatch.{fn}", journal=False,
                            fn=fn) as sp:
            if miss:
                before = _build.stats()
                cache[key] = build()
            out = cache[key](*args)
            if miss:
                after = _build.stats()
                loaded = (after["cache_loads"] > before["cache_loads"]
                          and after["builds"] == before["builds"])
                phase = "load" if loaded else "compile"
                if not loaded:
                    _c_compiles().inc(fn=fn)
            sp.fields["phase"] = phase
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
    # speculative decoding (greedy batches)
    # ------------------------------------------------------------------

    @mirrored()
    def enable_draft(self, draft_layers: int, k: int = 4):
        """Turn on self-draft speculative decoding: the first
        ``draft_layers`` of the target (sharing its parameter tensors)
        propose ``k`` tokens per target verify forward. Greedy-exact;
        sampled or logprob-requesting batches keep the plain loops.
        Applies to static batches (:meth:`complete_batch_spec`) and to
        all-greedy continuous pools (the engine switches per
        iteration)."""
        from k8s_device_plugin_tpu_torch.models.speculative import (
            draft_params_from_target,
        )

        if not 0 < draft_layers < self.config.num_layers:
            raise ValueError(
                f"draft layers must be in (0, {self.config.num_layers})"
            )
        if k < 2:
            raise ValueError("speculative k must be >= 2")
        # Startup-time binds: main() calls enable_draft() before the
        # batcher thread exists; after that these are read-only.
        self.draft_model = draft_params_from_target(self.model, draft_layers)
        self.draft_config = self.draft_model.cfg
        self.spec_k = k
        with self._spec_mu:
            self._spec_cache.clear()
        log.info("speculative decoding: %d-layer self-draft, k=%d",
                 draft_layers, k)

    def reset_spec_stats(self):
        """One definition of the telemetry shape (init and both warmups
        reset through here)."""
        with self._spec_mu:
            self.spec_stats = {"tokens": 0, "verify_rounds": 0}

    def spec_stats_snapshot(self) -> dict:
        """Point-in-time copy of the acceptance telemetry — the only
        read surface other threads (the /healthz handler) may use."""
        with self._spec_mu:
            return dict(self.spec_stats)

    def _record_spec(self, tokens: int, rounds: int) -> None:
        """Accumulate acceptance telemetry (host counters + registry).

        The accept ratio is emitted tokens per verify round over the
        round's maximum (k draft tokens + 1 target token): 1.0 means
        every draft token was accepted every round."""
        with self._spec_mu:
            self.spec_stats["tokens"] += tokens
            self.spec_stats["verify_rounds"] += rounds
            total_t = self.spec_stats["tokens"]
            total_r = self.spec_stats["verify_rounds"]
        obs_metrics.counter(
            "tpu_serve_speculative_tokens_total",
            "tokens emitted through the speculative verify loop",
        ).inc(tokens)
        obs_metrics.counter(
            "tpu_serve_speculative_verify_rounds_total",
            "target verify forwards run by the speculative loop",
        ).inc(rounds)
        if total_r and self.spec_k:
            obs_metrics.gauge(
                "tpu_serve_speculative_accept_ratio",
                "tokens per verify round / (k+1): 1.0 = every draft "
                "token accepted",
            ).set(total_t / (total_r * (self.spec_k + 1)))

    @mirrored()
    @torch.inference_mode()
    def complete_batch_spec(self, prompts, max_new_tokens):
        """Greedy batch decode through the speculative verify loop.

        Same contract as greedy ``complete_batch`` (token lists, shared
        TTFT) and token-identical with it — the loop only accepts the
        target's own argmax choices."""
        from k8s_device_plugin_tpu_torch.models.speculative import (
            draft_cache_from_target,
            make_spec_loop,
        )
        from k8s_device_plugin_tpu_torch.models.transformer import (
            set_cache_index,
        )

        if self.spec_k is None:
            raise RuntimeError("complete_batch_spec needs enable_draft()")
        dev = self.device
        B = len(prompts)
        if B < 1:
            return [], 0.0
        seq = self.config.max_seq_len
        budgets, p_lens, rows, padded = self._batch_setup(
            prompts, max_new_tokens
        )
        # Capacity edge: the k-wide verify block must never write past
        # the cache — clamped overflow writes land on slot seq-1 BEFORE
        # the logits read it, corrupting the K/V the final in-budget
        # token attends to (the plain loop only overshoots AFTER its
        # in-budget tokens are sampled). Rows that could touch the edge
        # take the plain loop; exactness beats speed here.
        if any(p + n > seq - self.spec_k
               for p, n in zip(p_lens[:B], budgets)):
            return self.complete_batch(prompts, max_new_tokens)
        zeros_f = torch.zeros((rows,), dtype=torch.float32, device=dev)
        zeros_i = torch.zeros((rows,), dtype=torch.long, device=dev)

        start = time.perf_counter()
        logits, cache = self._prefill(_long(padded, dev))
        lens = _long(p_lens, dev)
        t_cache = set_cache_index(cache, lens)
        # The self-draft shares the target's first layers, so its
        # prefill cache IS the target cache's first layers — no second
        # prefill forward in the TTFT.
        d_cache = set_cache_index(
            draft_cache_from_target(cache, self.draft_config.num_layers),
            lens,
        )
        first, _ = self._first_fn(logits, lens, self.generator(0), zeros_f,
                                  zeros_i)
        first_host = first.cpu()
        ttft = time.perf_counter() - start
        _h_ttft().observe(ttft, path="spec")
        _h_occupancy().observe(B / rows, mode="static")

        budgets = [min(n, seq - p) for n, p in zip(budgets, p_lens[:B])]
        conts = [[int(first_host[b])] for b in range(B)]
        maxrem = max(budgets) - 1
        if maxrem > 0:
            cap = self._scan_bucket(maxrem)
            rem = [max(0, budgets[b] - 1) for b in range(B)]
            rem += [0] * (rows - B)
            out, _, _, rounds = self._dispatch(
                "spec_loop", self._spec_cache, cap,
                lambda: make_spec_loop(
                    self.model, self.draft_model, self.spec_k, cap
                ),
                t_cache, d_cache, first[:, None], lens, _long(rem, dev),
            )
            self._record_spec(sum(rem), rounds)
            out_host = out.cpu()
            for b in range(B):
                conts[b].extend(int(t) for t in out_host[b, : rem[b]])
        outs, _ = self._finish_outs(
            prompts, conts, [[] for _ in range(B)]
        )
        return outs, ttft

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

        cache = new_cache(self.config, tokens.shape[0], self.device,
                          self.plan)
        logits = self.model(tokens, cache, prefill=True)
        return logits, cache

    @mirrored()
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

    @mirrored()
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
        """Decode-loop length bucket for an n-token continuation — also
        the static Batcher's grouping key, so co-batched requests share
        one decode-loop length."""
        return self._bucket(n, 8, self.config.max_seq_len)

    @mirrored()
    def warmup(self, decode_tokens: int = 16, max_batch: int = 1):
        """Run every (batch-rows, prompt-length) prefill bucket and each
        row bucket's default decode loop once (the static batcher's
        startup).

        Without this, the first request to hit a new bucket pays its
        first call — on the card, the flash kernel's nvcc build and
        load at the very first prefill — inside its own TTFT; serving
        should pay all of it at startup."""
        budget = min(decode_tokens, self.config.max_seq_len - 1)
        row_buckets, rows = [], 1
        while True:
            row_buckets.append(rows)
            if rows >= max_batch:
                break
            rows *= 2
        self.max_rows = row_buckets[-1]  # tpulint: shared-init (warmup precedes the engine thread)
        len_buckets, lb = [], self._prefill_bucket(1)
        while lb not in len_buckets:
            len_buckets.append(lb)
            lb = self._bucket(lb + 1, 128, self.config.max_seq_len)
        for rows in row_buckets:
            for lb in len_buckets:
                self._prefill(
                    torch.zeros((rows, lb), dtype=torch.long,
                                device=self.device)
                )
            if budget >= 1:
                # Through the real serving path, both decode-loop
                # variants: the first temperature/top_k request must not
                # pay the sampled loop's first call inside its TTFT.
                self.complete_batch([[0]] * rows, [budget] * rows)
                self.complete_batch(
                    [[0]] * rows, [budget] * rows, temps=[1.0] * rows,
                    key=self.generator(0),
                )
                if self.spec_k is not None:
                    # the speculative verify loop, per (rows,
                    # budget-bucket) too
                    self.complete_batch_spec([[0]] * rows, [budget] * rows)
        # Decode loops (and spec loops) only run for budgets >= 2: a
        # 1-token continuation is fully served by the prefill +
        # first-token sampler.
        scans = 2 * len(row_buckets) if budget > 1 else 0
        if self.spec_k is not None and budget > 1:
            scans += len(row_buckets)
        log.info(
            "warmup: %d prefill compiles (rows %s x lens %s) + %d decode "
            "scans", len(row_buckets) * len(len_buckets), row_buckets,
            len_buckets, scans,
        )
        # warmup's dummy decodes must not pollute acceptance telemetry
        self.reset_spec_stats()

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

    @mirrored()
    @torch.inference_mode()
    def make_pool_cache(self, rows: int):
        """A fresh rows-wide kv-cache pool (per-row index vector)."""
        from k8s_device_plugin_tpu_torch.models.transformer import (
            new_cache,
            set_cache_index,
        )

        return set_cache_index(
            new_cache(self.config, rows, self.device, self.plan),
            torch.ones((rows,), dtype=torch.long),
        )

    @mirrored()
    @torch.inference_mode()
    def draft_cache(self, cache):
        """The self-draft's rows cache from the target's ``cache``
        (models/speculative.py ``draft_cache_from_target``): its first
        ``draft_config.num_layers`` layers, cloned. An engine method, so
        that it runs on every rank of a mesh."""
        from k8s_device_plugin_tpu_torch.models.speculative import (
            draft_cache_from_target,
        )

        return draft_cache_from_target(cache, self.draft_config.num_layers)

    @mirrored()
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

    @mirrored()
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

    @mirrored()
    @torch.inference_mode()
    def spec_segment(self, pool, d_pool, tok, rowlen, budgets,
                     segment: int):
        """One speculative segment over the whole (all-greedy) row pool.

        The verify loop of the static path (make_spec_loop) with
        cap=segment and per-row budgets min(remaining, segment): the
        loop runs until every row emitted its budget, so the engine
        knows the counts without reading them back. Returns (pool,
        d_pool, tokens [rows, segment]); both caches' buffers are
        written in place, their indices rewound to ``rowlen +
        budgets``."""
        from k8s_device_plugin_tpu_torch.models.speculative import (
            make_spec_loop,
        )

        dev = self.device
        out, pool, d_pool, rounds = self._dispatch(
            "spec_loop", self._spec_cache, ("spec_segment", segment),
            lambda: make_spec_loop(
                self.model, self.draft_model, self.spec_k, segment
            ),
            pool, d_pool, _long(tok, dev), _long(rowlen, dev),
            _long(budgets, dev),
        )
        self._record_spec(int(budgets.sum()), rounds)
        return pool, d_pool, out

    @mirrored()
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

    # ------------------------------------------------------------------
    # paged KV cache programs
    #
    # The physical pool is a transformer.PagedKV of per-layer
    # [pool_pages, page_tokens, kv_heads, head_dim] tensors shared by
    # every row (the reference's {layer{i}: {attn: {k_pages, v_pages}}}
    # tree, same layout); the logical view (block tables + row lengths)
    # is host-owned by the paged engine (serve_batch.py) over
    # models/kv_cache.py bookkeeping. Every program here runs through a
    # shape-keyed cache (_paged_cache), so a first call per shape key is
    # counted in tpu_serve_jit_compiles_total — the counter the
    # steady-state tests read.
    # ------------------------------------------------------------------

    @mirrored()
    @torch.inference_mode()
    def make_paged_pool(self, pool_pages: int, page_tokens: int):
        """Fresh zeroed page pool (page 0 is the engine's scratch)."""
        from k8s_device_plugin_tpu_torch.models.transformer import (
            new_paged_pool,
        )

        return new_paged_pool(self.config, pool_pages, page_tokens,
                              self.device, self.plan)

    def defined_result(self, name: str, args, kwargs, out):
        """The part of the result of engine call ``name`` that is defined
        (``mirrored``'s rule; all of it where the method has none)."""
        rule = MIRRORED[name]
        if rule is None:
            return out
        return rule(inspect.signature(getattr(type(self), name)).bind(
            self, *args, **kwargs).arguments, out)

    def page_bucket(self, pages_needed: int, max_pages: int) -> int:
        """Block-table width bucket: power of two (floor 4) capped at
        the per-row maximum — the shape key one program serves for every
        batch whose longest row fits the bucket."""
        return self._bucket(max(1, pages_needed), min(4, max_pages),
                            cap=max_pages)

    @mirrored(_held_rows)
    @torch.inference_mode()
    def paged_prefill_chunk(self, pool, toks, bt, lens, last_idx, key,
                            temps, topks):
        """One chunked-prefill step: write ``toks`` [rows, C] into the
        rows' pages at positions ``lens + arange(C)`` and sample each
        row's token at chunk index ``last_idx`` (the first generated
        token for rows whose prompt ends in this chunk; ignored for the
        rest). Returns (pool, tokens on host, logprobs on host); the pool
        is updated in place. One program per (rows, C, W) bucket."""
        dev = self.device
        rows, chunk = toks.shape

        def build():
            def run(pool, toks, bt, lens, last_idx, gen, temp, topk):
                logits = self.model(toks, pool, pages=(bt, lens))
                tok, lp = self._sample_with_logp(
                    logits[torch.arange(rows, device=dev), last_idx],
                    gen, temp, topk,
                )
                return pool, tok, lp

            return run

        pool, tok, lp = self._dispatch(
            "paged_prefill", self._paged_cache,
            ("prefill_chunk", rows, chunk, bt.shape[1]), build,
            pool, _long(toks, dev), _long(bt, dev), _long(lens, dev),
            _long(last_idx, dev), key, _f32(temps, dev), _long(topks, dev),
        )
        return pool, tok.cpu().numpy(), lp.cpu().numpy()

    @mirrored(functools.partial(_held_rows, steps_first=True))
    @torch.inference_mode()
    def paged_decode_segment(self, pool, bt, tok, lens, key, temp, topk,
                             segment: int):
        """One fixed-length decode segment over the paged row pool.

        Same contract as :meth:`decode_segment` — (pool, tokens
        [segment, rows], logprobs [segment, rows]), the pool updated in
        place — but attention reads each row's pages through its table,
        so the program's shape key is (rows, W, segment): independent of
        prompt lengths. Row lengths advance on the device, step by
        step."""
        dev = self.device

        def build():
            def run(pool, bt, tok, lens, gen, temp, topk):
                toks, lps = [], []
                for _ in range(segment):
                    logits = self.model(tok, pool, pages=(bt, lens))
                    nxt, lp = self._sample_with_logp(logits[:, -1], gen,
                                                     temp, topk)
                    toks.append(nxt)
                    lps.append(lp)
                    tok, lens = nxt[:, None], lens + 1
                return pool, torch.stack(toks), torch.stack(lps)

            return run

        return self._dispatch(
            "paged_segment", self._paged_cache,
            ("segment", tok.shape[0], bt.shape[1], segment), build,
            pool, _long(bt, dev), _long(tok, dev), _long(lens, dev), key,
            _f32(temp, dev), _long(topk, dev),
        )

    @mirrored(_held_rows)
    @torch.inference_mode()
    def paged_spec_segment(self, pool, bt, tok, lens, budgets,
                           segment: int):
        """One speculative segment over the paged row pool.

        The paged counterpart of :meth:`spec_segment`: the
        ``make_paged_spec_loop`` program drafts through an alias of
        ``pool``'s first layers, runs the k-wide verify block through
        B2, and rewinds by not advancing the row lengths — so one pool
        is written, in place. Returns (pool, tokens [rows, segment]);
        each row's first budgets[r] entries are valid. One program per
        (rows, W, segment) bucket, dispatched as the ``paged_spec_loop``
        family.

        The caller must have provisioned every row's block table
        through ``lens + budgets + k`` tokens
        (``KVPageConfig.verify_span``) — the verify block may write up
        to k positions past the final accepted token."""
        from k8s_device_plugin_tpu_torch.models.speculative import (
            make_paged_spec_loop,
        )

        if self.spec_k is None:
            raise RuntimeError("paged_spec_segment needs enable_draft()")
        dev = self.device
        out, pool, rounds = self._dispatch(
            "paged_spec_loop", self._spec_cache,
            ("paged", tok.shape[0], bt.shape[1], segment),
            lambda: make_paged_spec_loop(
                self.model, self.draft_model, self.spec_k, segment,
                self.draft_config.num_layers,
            ),
            pool, _long(bt, dev), _long(tok, dev), _long(lens, dev),
            _long(budgets, dev),
        )
        self._record_spec(int(budgets.sum()), rounds)
        return pool, out

    @mirrored()
    @torch.inference_mode()
    def copy_pages(self, pool, src_ids, dst_ids):
        """Copy whole pages src -> dst in every layer (copy-on-extend),
        in place. The engine batches one call per iteration; the id
        lists pad to a power-of-two bucket with scratch -> scratch
        no-ops."""
        dev = self.device
        n = self._bucket(len(src_ids), 1, None)
        src = list(src_ids) + [0] * (n - len(src_ids))
        dst = list(dst_ids) + [0] * (n - len(dst_ids))

        def build():
            def run(pool, src, dst):
                for p in pool.k_pages + pool.v_pages:
                    p.index_copy_(0, dst, p[src])
                return pool

            return run

        return self._dispatch(
            "page_copy", self._paged_cache, ("copy", n), build,
            pool, _long(src, dev), _long(dst, dev),
        )

    def _kv_sources(self) -> list:
        """For each kv head of the model, ``(tp coordinate, index)`` of
        one tp rank's KV that holds it, by ``cache_kv_layout`` applied to
        every tp coordinate: the rank whose kv heads divide to it
        (*split*), the first of those sharing it (*shared*), or, where a
        rank holds one copy per q head (*expand*), the copy of the kv
        head's first q head."""
        from k8s_device_plugin_tpu_torch.models.transformer import (
            cache_kv_layout,
        )

        cfg = self.config
        n_rep = cfg.num_heads // cfg.kv_heads
        layouts = [cache_kv_layout(cfg, self.plan, t)
                   for t in range(self.mesh.size("tp"))]
        out = []
        for h in range(cfg.kv_heads):
            for t, (first, heads, expand) in enumerate(layouts):
                j = (h * n_rep if expand else h) - first
                if 0 <= j < heads:
                    out.append((t, j))
                    break
            else:
                raise RuntimeError(f"no tp rank holds kv head {h}")
        return out

    @mirrored(_bundle_digest)
    @torch.inference_mode()
    def export_pages(self, pool, page_ids):
        """Gather the K/V contents of ``page_ids`` to host for handoff.

        Returns the pool-shaped host tree (``{layer{i}: {attn:
        {k_pages, v_pages}}}`` of ``[len(page_ids), page_tokens,
        kv_heads, head_dim]`` numpy arrays; bf16 pages as their 16-bit
        words, models/handoff.py ``host_array``) the decode side
        scatters via :meth:`import_pages`. Ids pad to a power-of-two
        bucket with scratch-page reads trimmed from the host result.
        The pool is only read: the exporter keeps serving from it while
        the handoff lease is pending, and releases the pages on the
        decode ack (or lease expiry).

        On a tp mesh a rank holds only its kv heads: the pages are
        gathered over the tp group (every rank of a dp replica takes
        part, and each replica gathers its own), and each kv head is
        taken from one rank that holds it (``_kv_sources``), so the
        bundle holds whole pages, byte for byte what one device would
        export from the same pool contents. Rank 0's comes from its own
        replica; the ranks agree on the bundle's digest
        (``_bundle_digest``), which holds the dp replicas to the same
        pages."""
        from k8s_device_plugin_tpu_torch.models.handoff import host_array
        from k8s_device_plugin_tpu_torch.parallel import comm

        n = self._bucket(len(page_ids), 1, None)
        ids = list(page_ids) + [0] * (n - len(page_ids))

        def build():
            def run(pool, ids):
                # one gather and one transfer for every layer's K and V
                return torch.stack([p[ids]
                                    for p in pool.k_pages + pool.v_pages])

            return run

        out = self._dispatch(
            "page_export", self._paged_cache, ("export", n), build,
            pool, _long(ids, self.device),
        )[:, :len(page_ids)]
        if self.plan is not None:
            parts = comm.all_gather(out.contiguous(), self.mesh.group("tp"))
            out = torch.stack([parts[t][..., j, :]
                               for t, j in self._kv_sources()], dim=-2)
        host = host_array(out)
        layers = len(pool.k_pages)
        return {
            f"layer{i}": {"attn": {"k_pages": host[i],
                                   "v_pages": host[layers + i]}}
            for i in range(layers)
        }

    @mirrored()
    @torch.inference_mode()
    def import_pages(self, pool, page_ids, payload):
        """Scatter a handed-off page block into ``page_ids``, in place.

        ``payload`` is the pool-shaped host tree of :meth:`export_pages`
        (leaves ``[len(page_ids), page_tokens, kv_heads, head_dim]``,
        whole pages). Ids pad to a power-of-two bucket with zero-writes
        to the scratch page (page 0 is never allocated, so the padding
        is a no-op by construction). On a tp mesh every rank receives
        the whole block (the mirrored call carries it) and keeps the kv
        heads its pool holds (``cache_kv_layout``; one copy per q head,
        ``repeat_kv``'s expansion, where the layout expands). A payload
        that is not shaped like the pool raises ValueError or
        RuntimeError."""
        from k8s_device_plugin_tpu_torch.models.handoff import to_tensor

        cfg = self.config
        n = self._bucket(len(page_ids), 1, None)
        ids = list(page_ids) + [0] * (n - len(page_ids))
        layers = len(pool.k_pages)
        try:
            leaves = [payload[f"layer{i}"]["attn"][leaf]
                      for leaf in ("k_pages", "v_pages")
                      for i in range(layers)]
        except KeyError as e:
            raise ValueError(f"page block lacks {e}") from e
        src = torch.stack([to_tensor(a) for a in leaves])
        if tuple(src.shape[-2:]) != (cfg.kv_heads, cfg.head_dim):
            raise ValueError(
                f"page block of {tuple(src.shape[-2:])} (kv heads, head "
                f"dim); the model's pages hold "
                f"{(cfg.kv_heads, cfg.head_dim)}")
        first, heads, expand = self.model.layers[0].attn.cache_kv
        if expand:
            src = src.repeat_interleave(cfg.num_heads // cfg.kv_heads,
                                        dim=-2)
        src = src[..., first:first + heads, :]
        if n != len(page_ids):
            pad = src.new_zeros((src.shape[0], n - len(page_ids))
                                + src.shape[2:])
            src = torch.cat([src, pad], 1)

        def build():
            def run(pool, ids, src):
                for p, s in zip(pool.k_pages + pool.v_pages, src):
                    p.index_copy_(0, ids, s.to(p.dtype))
                return pool

            return run

        return self._dispatch(
            "page_import", self._paged_cache, ("import", n), build,
            pool, _long(ids, self.device), src.to(self.device),
        )
