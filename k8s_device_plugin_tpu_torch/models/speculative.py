"""Speculative decoding: self-draft + verify loop, in PyTorch.

The counterpart of ``k8s_device_plugin_tpu/models/speculative.py``. A
cheap DRAFT model proposes ``k`` tokens one at a time, the target
verifies all of them in ONE forward over the k-token block, and the
leading run of matches is accepted: up to k tokens a target forward,
token-identical to greedy decoding by construction (every accepted token
is the target's own argmax; the first mismatch is replaced by the
target's choice).

The draft is the SELF-draft: the first N blocks of the target with its
embedding, final norm and head, sharing the target's parameter tensors
(:func:`draft_params_from_target`).

The reference runs a whole generation as one ``lax.while_loop`` inside
one jit. PyTorch runs eagerly, so the loops here are Python loops over
explicit tensors on the model's device, with the reference's acceptance
arithmetic unchanged. Their one host read a verify round is the loop
test, ``(n < budgets).any()``; the draft steps, the verify forward, the
acceptance and the rewinds stay on the device.

Sampling is not speculated (rejection-sampling acceptance is a
different calculus): serving routes sampled or logprob-requesting
batches to the plain decode loops.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from k8s_device_plugin_tpu_torch.models.transformer import (
    DecoderLM,
    KVCache,
    PagedKV,
    set_cache_index,
)

__all__ = ["draft_cache_from_target", "draft_pages_from_target",
           "draft_params_from_target", "make_paged_spec_loop",
           "make_spec_loop"]


def draft_pages_from_target(pool: PagedKV, num_layers: int) -> PagedKV:
    """Self-draft *paged* cache: an alias of the target pool, not a copy.

    Pages are addressed through per-row block tables rather than owned
    per cache, so the draft's cache for its shared layers IS the target
    pool's first ``num_layers`` page tensors: it reads the prompt's K/V
    through the pages the target prefilled, and its writes land where
    the target's verify block rewrites the same positions. Returns a
    ``PagedKV`` whose lists hold the target's own tensors."""
    return PagedKV(k_pages=pool.k_pages[:num_layers],
                   v_pages=pool.v_pages[:num_layers])


def draft_cache_from_target(cache: KVCache, num_layers: int) -> KVCache:
    """Self-draft rows cache derived from the TARGET's prefill cache.

    The self-draft shares the target's first N layers and embeddings, so
    its prefill K/V equals the target cache's first N layers: taking
    them saves a draft prefill forward. The rows loop writes the two
    caches at different times (draft steps, then the verify block), so
    the draft keeps its own buffers: the layers and the index are
    cloned."""
    return KVCache(k=[t.clone() for t in cache.k[:num_layers]],
                   v=[t.clone() for t in cache.v[:num_layers]],
                   idx=cache.idx.clone())


def draft_params_from_target(model: DecoderLM, num_layers: int) -> DecoderLM:
    """The first-``num_layers`` self-draft of ``model``: a ``DecoderLM``
    for ``num_layers`` whose ``embed``, ``pos_embed``, ``ln_f``,
    ``lm_head`` and blocks are the target's own modules. Nothing is
    loaded or copied; the draft's parameters are the target's tensors
    (its shell is built on the meta device, then given them). A sharded
    target's draft is on the target's plan: the same rank's part."""
    cfg = dataclasses.replace(model.cfg, num_layers=num_layers)
    with torch.device("meta"):
        draft = DecoderLM(cfg, plan=model.plan)
    draft.embed = model.embed
    if cfg.position == "learned":
        draft.pos_embed = model.pos_embed
    draft.layers = nn.ModuleList(model.layers[:num_layers])
    draft.ln_f = model.ln_f
    if not cfg.tie_embeddings:
        draft.lm_head = model.lm_head
    return draft.eval()


def _accept(drafts, g, tok, out, n, active, budgets, k: int, cap: int):
    """One round's acceptance, the reference's arithmetic: leading
    matches ``m`` (cumprod), ``e = min(m + 1, k)`` tokens emitted on
    active rows, the correction ``g[m]``, the masked write into ``out``
    (column ``cap`` takes what is dropped). Returns (e, n, tok)."""
    match = (drafts == g).long()
    m = torch.cumprod(match, dim=1).sum(dim=1)          # leading matches
    e = torch.where(active, torch.clamp(m + 1, max=k), 0)
    ar = torch.arange(k, device=g.device)[None, :]
    corr = torch.gather(g, 1, torch.clamp(m, max=k - 1)[:, None])
    emitted = torch.where(ar < m[:, None], drafts, corr)
    idx = n[:, None] + ar
    writable = (ar < e[:, None]) & (idx < budgets[:, None])
    out.scatter_(1, torch.where(writable, idx, cap), emitted)
    n = torch.minimum(n + e, budgets)
    # Next shared token: d_k on a clean sweep, else the correction;
    # frozen rows keep theirs.
    last = torch.where(m >= k, drafts[:, k - 1], corr[:, 0])
    tok = torch.where(active, last, tok[:, 0])[:, None]
    return e, n, tok


def make_spec_loop(model, draft_model, k: int, cap: int):
    """Speculative generation loop over rows caches, for one ``cap``.

    Returns ``fn(t_cache, d_cache, first_tok, p0, budgets) -> (tokens
    [rows, cap], t_cache, d_cache, rounds)`` where ``first_tok`` [rows,
    1] is the prefill's first emitted token (not yet fed to either
    cache), ``p0`` [rows] the true prompt lengths and ``budgets`` [rows]
    the remaining token budget after first_tok. ``rounds`` is the number
    of verify forwards run. Emitted tokens equal the target's plain
    greedy decode, including post-EOS garbage (the host truncates both
    the same way)."""
    if k < 2:
        raise ValueError("speculative k must be >= 2 (k=1 is the plain scan)")

    def run(t_cache: KVCache, d_cache: KVCache, first_tok, p0, budgets):
        rows = first_tok.shape[0]
        dev = first_tok.device
        out = torch.zeros((rows, cap + 1), dtype=torch.long, device=dev)
        n = torch.zeros((rows,), dtype=torch.long, device=dev)
        tok, P = first_tok, p0
        # Entry rewind: the final round of a bounded run may accept past
        # the caller's budget cut, so a caller resuming from its own
        # count hands indices that must be authoritative.
        t_cache = set_cache_index(t_cache, p0)
        d_cache = set_cache_index(d_cache, p0)
        rounds = 0
        while bool((n < budgets).any()):        # the round's host read
            active = n < budgets
            # Draft: k feeds from the shared last token (each advances
            # the draft cache's index in place).
            t, drafts = tok, []
            for _ in range(k):
                t = draft_model(t, d_cache)[:, -1].argmax(-1)[:, None]
                drafts.append(t[:, 0])
            drafts = torch.stack(drafts, dim=1)             # [rows, k]
            # Target verifies the whole block in one forward: g[:, i] is
            # its choice after block[i], which checks drafts[:, i].
            block = torch.cat([tok, drafts[:, :k - 1]], dim=1)
            g = model(block, t_cache).argmax(-1)            # [rows, k]
            e, n, tok = _accept(drafts, g, tok, out, n, active, budgets,
                                k, cap)
            # Rewind both caches to the accepted prefix: K/V past the
            # index is masked and overwritten by the next round's feeds.
            # The clamp lands the freezing round's overshoot on p0 +
            # budgets exactly, the position a resuming caller feeds at.
            P = torch.minimum(P + e, p0 + budgets)
            t_cache = set_cache_index(t_cache, P)
            d_cache = set_cache_index(d_cache, P)
            rounds += 1
        return out[:, :cap], t_cache, d_cache, rounds

    return run


def make_paged_spec_loop(model, draft_model, k: int, cap: int,
                         draft_layers: int):
    """Speculative loop over the PAGED pool, for one ``cap``.

    Returns ``fn(pool, bt, first_tok, lens0, budgets) -> (tokens [rows,
    cap], pool, rounds)`` where ``pool`` is the page pool (written in
    place), ``bt`` [rows, W] the block tables, ``first_tok`` [rows, 1]
    the last emitted-but-unfed token, ``lens0`` [rows] each row's
    resident length and ``budgets`` [rows] the remaining token budget.

    The draft's cache is an alias of the pool's first ``draft_layers``
    layers (:func:`draft_pages_from_target`); it feeds at ``lens + i``.
    The verify block ``[tok, d1 .. d_{k-1}]`` at ``lens`` then rewrites
    those positions in every layer, and nothing advances ``lens`` but
    the accepted count: that IS the rewind. The caller provisions pages
    through ``lens0 + budgets + k`` (``KVPageConfig.verify_span``): the
    verify block is written before acceptance is known."""
    if k < 2:
        raise ValueError("speculative k must be >= 2 (k=1 is the plain scan)")

    def run(pool: PagedKV, bt, first_tok, lens0, budgets):
        rows = first_tok.shape[0]
        dev = first_tok.device
        d_pool = draft_pages_from_target(pool, draft_layers)
        out = torch.zeros((rows, cap + 1), dtype=torch.long, device=dev)
        n = torch.zeros((rows,), dtype=torch.long, device=dev)
        tok, lens = first_tok, lens0
        rounds = 0
        while bool((n < budgets).any()):        # the round's host read
            active = n < budgets
            t, drafts = tok, []
            for i in range(k):
                t = draft_model(t, d_pool, pages=(bt, lens + i))[:, -1] \
                    .argmax(-1)[:, None]
                drafts.append(t[:, 0])
            drafts = torch.stack(drafts, dim=1)             # [rows, k]
            block = torch.cat([tok, drafts[:, :k - 1]], dim=1)
            g = model(block, pool, pages=(bt, lens)).argmax(-1)
            e, n, tok = _accept(drafts, g, tok, out, n, active, budgets,
                                k, cap)
            # Advance over the accepted prefix only, clamped to lens0 +
            # budgets: the exit-length contract of the rows loop.
            lens = torch.minimum(lens + e, lens0 + budgets)
            rounds += 1
        return out[:, :cap], pool, rounds

    return run
