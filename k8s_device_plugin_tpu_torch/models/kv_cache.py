"""Paged KV cache: block-table pool, refcounted pages, prefix index.

The serving memory layer (ISSUE 8 tentpole). The legacy continuous
engine gives every pool row a private contiguous ``[max_seq_len]``
cache, so N requests sharing a system prompt pay N prefills and N
copies of identical K/V, and capacity is ``rows x max_seq_len``
regardless of how short the resident prompts are. This module replaces
that with the vLLM-style paged layout:

- **Pages**: K/V storage is one physical pool of fixed-size pages
  (``page_tokens`` token slots each) per layer; a request's cache is a
  *block table* — an ordered list of page ids — so its footprint is
  ``ceil(len/page_tokens)`` pages, not ``max_seq_len``.
- **Refcounts**: pages are shared safely across rows.  ``PagePool``
  tracks a reference count per page; a page returns to the free list
  only when its last holder releases it.
- **Prefix index**: a radix trie keyed on token-id *blocks* (one page's
  worth of ids per edge) maps previously-prefilled prompt prefixes to
  their pages.  A new request walks the trie, maps every matched page
  into its block table (ref++), and prefills only the unmatched suffix
  — identical system prompts skip their prefill entirely.
- **Copy-on-extend**: shared and index-published pages are *read-only*.
  Before a row writes into one (a partial tail page being extended by
  decode), the engine copies it to a fresh page and swaps the block
  table entry, so divergent suffixes can never corrupt a sibling's K/V.

Host-side bookkeeping (this module, no jax imports at module scope) is
owned by the engine thread in ``serve_batch.ContinuousBatcher``; the
device arrays and jitted page programs live on ``serve_engine.LMServer``
(``make_paged_pool`` / ``paged_prefill_chunk`` / ``paged_decode_segment``
/ ``copy_pages``), and the attention gather/scatter itself is
``transformer.Attention._paged_attention``.

Knobs: ``TPU_KV_PAGE_TOKENS`` (token slots per page, default 16) and
``TPU_KV_POOL_PAGES`` (physical pages in the pool, default sized to
``rows x max_seq_len`` worth).  See docs/serving.md.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "KVPageConfig",
    "PagePool",
    "PrefixIndex",
    "page_config_from_env",
]

# SLO scheduling classes, best first. Rank 0 is never shed in favour of
# anything; rank 2 is the first preemption/eviction victim.
SLO_CLASSES = ("interactive", "standard", "batch")
SLO_RANK = {name: rank for rank, name in enumerate(SLO_CLASSES)}

ENV_PAGE_TOKENS = "TPU_KV_PAGE_TOKENS"
ENV_POOL_PAGES = "TPU_KV_POOL_PAGES"


def _g_pages_in_use():
    return obs_metrics.gauge(
        "tpu_serve_kv_pages_in_use_count",
        "physical KV pages currently referenced (allocated - free)",
    )


def _c_page_allocs():
    return obs_metrics.counter(
        "tpu_serve_kv_page_allocs_total",
        "KV pages taken from the free list",
    )


def _c_page_frees():
    return obs_metrics.counter(
        "tpu_serve_kv_page_frees_total",
        "KV pages whose last reference was released",
    )


def _c_prefix_lookups():
    return obs_metrics.counter(
        "tpu_serve_kv_prefix_lookups_total",
        "prefix-index lookups at admission, by outcome (hit = at least "
        "one full page of prompt K/V reused)",
        labels=("outcome",),
    )


def _c_prefix_tokens():
    return obs_metrics.counter(
        "tpu_serve_kv_prefix_tokens_reused_total",
        "prompt tokens whose prefill was skipped via the prefix index",
    )


def _c_evictions():
    return obs_metrics.counter(
        "tpu_serve_kv_evictions_total",
        "pages reclaimed under pressure (index = cached prefix dropped "
        "LRU-first, preempt = live batch-class victim shed)",
        labels=("kind",),
    )


class KVPageConfig:
    """Sizing for one paged pool.

    ``page_tokens`` is the token capacity of one page; ``pool_pages``
    the number of physical pages; ``max_pages_per_row`` bounds one
    row's block table (== ceil(max_seq_len / page_tokens))."""

    def __init__(self, page_tokens: int, pool_pages: int,
                 max_seq_len: int):
        if page_tokens < 1 or pool_pages < 2:
            raise ValueError(
                f"need page_tokens >= 1 and pool_pages >= 2, got "
                f"{page_tokens}/{pool_pages}"
            )
        self.page_tokens = int(page_tokens)
        self.pool_pages = int(pool_pages)
        self.max_seq_len = int(max_seq_len)
        self.max_pages_per_row = -(-max_seq_len // page_tokens)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` token positions."""
        return -(-max(0, int(tokens)) // self.page_tokens)

    def verify_span(self, tokens: int, spec_k: int) -> int:
        """Token positions a speculative segment may WRITE when a row
        holds ``tokens`` after the segment's accepted output.

        The k-wide verify block is written before acceptance is known:
        every round feeds k tokens starting at the current accepted
        length, so the final round's writes can land ``spec_k``
        positions past the last token the host keeps — and that
        overshoot may straddle a page boundary the accepted span never
        touches (e.g. tokens=16, P=8, k=3 needs a THIRD page the
        emitted tokens never fill). The engine provisions block tables
        through this span so the in-kernel write clamp never fires for
        resident rows."""
        return int(tokens) + max(0, int(spec_k))


def page_config_from_env(max_seq_len: int, rows: int,
                         page_tokens: int = 0,
                         pool_pages: int = 0) -> KVPageConfig:
    """Build a :class:`KVPageConfig` from explicit args > env > default.

    The default pool holds ``rows x max_seq_len`` worth of tokens plus
    one page of headroom per row — enough that a full pool of
    max-length rows fits with the scratch page, so enabling paging
    never *loses* capacity versus the contiguous layout; operators
    shrink ``TPU_KV_POOL_PAGES`` to overcommit (prefix sharing is what
    makes overcommit safe).
    """
    pt = int(page_tokens or os.environ.get(ENV_PAGE_TOKENS, 0) or 16)
    default_pages = rows * (-(-max_seq_len // pt) + 1) + 1  # +1 scratch
    pp = int(pool_pages or os.environ.get(ENV_POOL_PAGES, 0)
             or default_pages)
    return KVPageConfig(pt, pp, max_seq_len)


class PagePool:
    """Host-side free list + per-page reference counts.

    Page id 0 is reserved as the *scratch* page: block-table fill for
    unassigned slots and the write target for padding rows, never
    allocated and never freed.  Single-threaded by design — only the
    engine thread (which owns all device calls) touches the pool, so
    allocation needs no lock and stays deterministic.
    """

    SCRATCH = 0

    def __init__(self, config: KVPageConfig):
        self.config = config
        # LIFO free list: recently freed pages are re-used first, which
        # keeps the hot working set of physical pages small.
        self._free: List[int] = list(range(config.pool_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.config.pool_pages - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages (refcount 1 each); None if short (caller
        reclaims and retries — partial grants would leak on failure)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            self._refs[pid] = 1
        if n:
            _c_page_allocs().inc(n)
            _g_pages_in_use().set(self.pages_in_use)
        return ids

    def ref(self, ids: Sequence[int]) -> None:
        for pid in ids:
            if pid == self.SCRATCH:
                continue
            self._refs[pid] += 1

    def refcount(self, pid: int) -> int:
        return 0 if pid == self.SCRATCH else self._refs.get(pid, 0)

    def release(self, ids: Sequence[int]) -> int:
        """Drop one reference per id; returns how many pages freed."""
        freed = 0
        for pid in ids:
            if pid == self.SCRATCH:
                continue
            left = self._refs[pid] - 1
            if left:
                self._refs[pid] = left
            else:
                del self._refs[pid]
                self._free.append(pid)
                freed += 1
        if freed:
            _c_page_frees().inc(freed)
            _g_pages_in_use().set(self.pages_in_use)
        return freed


class _TrieNode:
    __slots__ = ("page", "children", "tails", "last_use")

    def __init__(self, page: int):
        self.page = page
        # full-block edges: token-id tuple (page_tokens long) -> node
        self.children: Dict[tuple, "_TrieNode"] = {}
        # partial tail pages published under this node:
        # token-id tuple (< page_tokens long) -> page id
        self.tails: Dict[tuple, int] = {}
        self.last_use = 0


class PrefixIndex:
    """Radix trie over token-id blocks -> published KV pages.

    Every edge is one *full* page worth of token ids; each node owns one
    index reference on its page (taken at insert, dropped at evict).
    Nodes additionally carry *tail* entries — partial last pages of
    published prompts — so a prompt that extends a published prompt
    mid-page still reuses that page (the extender copy-on-extends
    before writing, see the engine).  Eviction is LRU over leaves:
    dropping a leaf releases the index's reference; the physical page
    is freed only when no live row still maps it.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_tokens = pool.config.page_tokens
        self._root = _TrieNode(PagePool.SCRATCH)
        self._clock = 0  # logical LRU clock (injectable-clock rule:
        #                  wall time would make eviction order racy)
        self._nodes = 0

    def __len__(self) -> int:
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int],
              max_tokens: Optional[int] = None
              ) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``tokens``.

        Returns (page_ids, matched_token_count); the caller must
        ``pool.ref`` the pages it maps.  ``max_tokens`` caps the match
        (admission passes len(prompt) - 1 so at least one position is
        left to prefill — the first token is sampled from its logits).
        Matched full blocks may be followed by at most one partial
        tail page.
        """
        P = self.page_tokens
        limit = len(tokens) if max_tokens is None else min(
            len(tokens), max_tokens
        )
        node, pages, matched = self._root, [], 0
        now = self._tick()
        while matched + P <= limit:
            block = tuple(tokens[matched:matched + P])
            child = node.children.get(block)
            if child is None:
                break
            child.last_use = now
            pages.append(child.page)
            matched += P
            node = child
        # Longest partial tail that the remaining prompt extends.
        best_tail, best_len = None, 0
        for tail, pid in node.tails.items():
            t = len(tail)
            if (best_len < t <= limit - matched
                    and tuple(tokens[matched:matched + t]) == tail):
                best_tail, best_len = pid, t
        if best_tail is not None:
            pages.append(best_tail)
            matched += best_len
        if pages:
            _c_prefix_lookups().inc(outcome="hit")
            _c_prefix_tokens().inc(matched)
        else:
            _c_prefix_lookups().inc(outcome="miss")
        return pages, matched

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish a prefilled prompt's pages under its token blocks.

        ``pages[i]`` holds positions ``[i*P, (i+1)*P)``; the last entry
        may be a partial tail.  Blocks already indexed keep their
        existing page (first writer wins — both hold identical K/V, and
        keeping one maximises sharing); new nodes take one index
        reference on the row's page.  Returns nodes created.
        """
        P = self.page_tokens
        node, created, now = self._root, 0, self._tick()
        for i, pid in enumerate(pages):
            start = i * P
            block = tuple(tokens[start:start + P])
            if len(block) == P:
                child = node.children.get(block)
                if child is None:
                    child = _TrieNode(pid)
                    node.children[block] = child
                    self.pool.ref([pid])
                    self._nodes += 1
                    created += 1
                child.last_use = now
                node = child
            elif block and block not in node.tails:
                node.tails[block] = pid
                self.pool.ref([pid])
                self._nodes += 1
                created += 1
        return created

    def published(self, pid: int) -> bool:
        """Whether the index holds a reference on ``pid`` (published
        pages are read-only: the engine copy-on-extends before any
        write).  O(nodes); the engine keeps its own per-row ownership
        set on the hot path and uses this only in tests/asserts."""
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root and node.page == pid:
                return True
            if pid in node.tails.values():
                return True
            stack.extend(node.children.values())
        return False

    def evict(self, want_pages: int) -> int:
        """Drop LRU leaves until ~``want_pages`` physical pages were
        actually freed (a dropped reference frees the page only when no
        live row maps it) or the index is empty.  Returns pages freed.
        """
        freed = 0
        while freed < want_pages:
            victim = self._lru_leaf()
            if victim is None:
                break
            parent, key, kind = victim
            if kind == "tail":
                pid = parent.tails.pop(key)
            else:
                pid = parent.children.pop(key).page
            self._nodes -= 1
            got = self.pool.release([pid])
            freed += got
            _c_evictions().inc(kind="index")
        return freed

    def _lru_leaf(self):
        """(parent, edge-key, kind) of the least-recently-used evictable
        entry: any tail, or a childless block node (evicting interior
        nodes would orphan longer cached prefixes)."""
        best, best_use = None, None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for tail in node.tails:
                if best_use is None or node.last_use < best_use:
                    best, best_use = (node, tail, "tail"), node.last_use
            for block, child in node.children.items():
                if not child.children and not child.tails:
                    if best_use is None or child.last_use < best_use:
                        best, best_use = (node, block, "block"), \
                            child.last_use
                else:
                    stack.append(child)
        return best
