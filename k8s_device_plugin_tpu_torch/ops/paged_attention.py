"""Paged attention — the read of the paged serving engine: the plain
PyTorch version and the hand-written CUDA kernel B2.

The counterpart of the reference's ``Attention._paged_attention_gather``
and ``_paged_attention_fused`` (k8s_device_plugin_tpu/models/
transformer.py:448-536). The layout at the public functions is the
reference's: q ``[b, L, heads, d]`` after RoPE, page pools
``[pool_pages, P, kv_heads, d]`` shared by every row, the block table
``bt [b, W]`` (row r's key position p lives at page ``bt[r, p // P]``,
offset ``p % P``) and ``q_pos [b, L]``, each query's absolute position;
a key is visible iff its position is <= the query's. The output is
``[b, L, heads, d]`` in q's dtype.

``paged_attention`` dispatches by device and nothing else: a CPU tensor
takes ``paged_attention_reference``, a CUDA tensor launches
``csrc/paged_attn.cu`` or raises. There is no fallback from the card to
the plain version.

``paged_attn_plan`` owns B2's launch plan: the route (decode: fp32
products on the CUDA cores; chunk: bf16 tensor-core tiles), the query
tile, the keys per K/V tile, the keys per split and the number of
splits, and the shared memory; the C entry point refuses a plan that
does not match its build. The grid and the workspace follow from the
plan alone, which depends on shapes and never on the row lengths.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from k8s_device_plugin_tpu_torch.ops.attention import (
    _KERNEL_DTYPES,
    KernelStats,
    _kernel_fn,
    _pad,
    _run,
    kernel_head_dim,
)

_NEG_INF = -1e30

PAGED_ATTN = KernelStats(
    "paged_attn",
    source="k8s_device_plugin_tpu_torch/csrc/paged_attn.cu",
    replaces="k8s_device_plugin_tpu/models/transformer.py:476 "
             "(Attention._paged_attention_fused, an XLA lax.scan)",
)
# B2's second kernel: the entry point launches it after the main one
# whenever the plan has more than one split.
PAGED_ATTN_COMBINE = KernelStats(
    "paged_attn_combine",
    source="k8s_device_plugin_tpu_torch/csrc/paged_attn.cu",
    replaces="k8s_device_plugin_tpu/models/transformer.py:476 "
             "(the scan's running softmax, across B2's splits)",
)


def paged_attention_reference(q, k_pages, v_pages, bt, q_pos):
    """Plain paged attention; the numerical reference for B2.

    Mirrors the reference's ``_paged_attention_gather``: gather each
    row's logical cache view ``[b, W·P, kv, d]`` through the table, then
    the unexpanded-GQA scores (q head h = kv · n_rep + r) in the input
    dtype, cast to float32 and scaled, masked with -1e30 past each
    query's position, softmax in float32, probabilities cast back to the
    input dtype for the PV product."""
    b, L, heads, d = q.shape
    kv_heads, page_tokens = k_pages.shape[2], k_pages.shape[1]
    n_rep = heads // kv_heads
    span = bt.shape[1] * page_tokens
    idx = bt.long()
    kc = k_pages[idx].reshape(b, span, kv_heads, d)
    vc = v_pages[idx].reshape(b, span, kv_heads, d)
    qg = q.reshape(b, L, kv_heads, n_rep, d)
    scores = torch.einsum("blkrd,bmkd->bkrlm", qg, kc).float() * d ** -0.5
    k_pos = torch.arange(span, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]       # [b, L, span]
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkrlm,bmkd->blkrd", probs, vc).reshape(
        b, L, heads, d)


# B2's bfloat16 outputs against ``paged_attention_fp32`` on the same
# operands (P rounded on the chunk route): the largest |B2 - read| of a
# query row over that row's largest |read|. What is left is the bf16
# rounding of the output (2^-9 of an element) and of P: chip_smoke's
# bf16 cases read at most 0.0054 on an H100 (PERF.md), and the bar is
# about three times that. A split's partial weighed 10% wrong reads far
# above it (tests/test_torch_paged_plan.py), where the plain read's 2e-2
# absolute bar can miss it on long rows, whose outputs are small.
PAGED_BF16_ROW_TOL = 1.5e-2


def row_rel_err(got, want) -> float:
    """Largest over query rows of max |got - want| / max |want| along the
    head dim."""
    err = (got.float() - want.float()).abs().amax(-1)
    return (err / want.float().abs().amax(-1)).max().item()


def paged_attention_fp32(q, k_pages, v_pages, bt, q_pos, round_p=False):
    """The same read in float32 from the same operands, out float32: P
    = exp(s - max) unnormalised, its fp32 sum l, out = P·V / l, P rounded
    to bf16 for P·V when ``round_p`` (as B2's chunk route feeds its
    tensor cores). The close yardstick of B2's bfloat16 outputs, which
    the plain read's bf16 scores and probabilities blur."""
    b, L, heads, d = q.shape
    kv_heads, page_tokens = k_pages.shape[2], k_pages.shape[1]
    n_rep = heads // kv_heads
    span = bt.shape[1] * page_tokens
    idx = bt.long()
    kc = k_pages[idx].reshape(b, span, kv_heads, d).float()
    vc = v_pages[idx].reshape(b, span, kv_heads, d).float()
    qg = q.reshape(b, L, kv_heads, n_rep, d).float()
    scores = torch.einsum("blkrd,bmkd->bkrlm", qg, kc) * d ** -0.5
    k_pos = torch.arange(span, device=q.device)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None, None]
    scores = scores.masked_fill(~mask, -torch.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1)
    if round_p:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bkrlm,bmkd->blkrd", p, vc)
    return (out / l.permute(0, 3, 1, 2)[..., None]).reshape(b, L, heads, d)


# ---------------------------------------------------------------------------
# the launch plan of kernel B2
# ---------------------------------------------------------------------------

PAGED_SMS = 132            # streaming multiprocessors of an H100 SXM
PAGED_BLOCKS_PER_SM = 4    # blocks the split aims for on each SM
PAGED_CHUNK_MIN_ROWS = 16  # query rows that make a tensor-core tile worth it
ROUTES = {"decode": 0, "chunk": 1}


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How one launch of B2 is cut (csrc/paged_attn.cu's ``Decode`` /
    ``Chunk`` hold the same tile sizes and bytes).

    Each block owns one (row, kv head), one tile of ``tile_rows`` query
    rows of the ``n_rep·L`` of that pair, and one split: key positions
    ``[split·keys_per_split, (split + 1)·keys_per_split)``, a whole number
    of pages and of ``tile_keys``-key K/V tiles, which it walks through a
    ring of two shared-memory stages. With ``n_splits`` > 1 each block
    writes an fp32 partial (m, l, acc) to the workspace and a combine
    kernel reduces the splits in split order."""

    route: str
    batch: int
    L: int
    heads: int
    kv_heads: int
    head_dim: int
    page_tokens: int
    W: int
    tile_rows: int
    tile_keys: int
    keys_per_split: int
    n_splits: int
    smem_bytes: int

    @property
    def dmax(self) -> int:
        """The column instance the head dim runs at (64, 128 or 256)."""
        return kernel_head_dim(self.head_dim)

    @property
    def rows(self) -> int:
        """Query rows of one (row, kv head): n_rep·L."""
        return self.heads // self.kv_heads * self.L

    @property
    def q_tiles(self) -> int:
        return -(-self.rows // self.tile_rows)

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.batch, self.kv_heads, self.q_tiles * self.n_splits)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    @property
    def workspace_floats(self) -> int:
        """fp32 scratch: (m, l) and acc[d] per query row and split; none
        with one split (the blocks write the output themselves)."""
        if self.n_splits == 1:
            return 0
        return (self.batch * self.heads * self.L * self.n_splits
                * (2 + self.head_dim))

    @property
    def args(self) -> tuple[int, int, int, int, int, int]:
        """What the C entry point takes of the plan; it checks the tile
        sizes and the bytes against its build."""
        return (ROUTES[self.route], self.tile_rows, self.tile_keys,
                self.keys_per_split, self.n_splits, self.smem_bytes)

    def splits(self) -> list[tuple[int, int]]:
        """Each split's key positions [first, end), in split order."""
        span = self.W * self.page_tokens
        return [(s * self.keys_per_split,
                 min((s + 1) * self.keys_per_split, span))
                for s in range(self.n_splits)]


def _decode_tile_keys(dmax: int, esize: int) -> int:
    """Keys per K/V tile of the decode route: 64 while a row is at most
    256 bytes, 32 at 512, 16 at 1024 (two stages stay near 70 KB)."""
    return {1: 64, 2: 32, 4: 16}[max(1, dmax * esize // 256)]


def _smem_bytes(route: str, dmax: int, esize: int, tile_rows: int,
                tile_keys: int) -> int:
    """Shared memory of one block: two stages of K and V tiles, rows
    padded by 16 bytes; decode: + q rows in fp32, the scores, and four
    per-row arrays (alpha, m, l, position); chunk: + the bf16 Q tile
    (padded like K/V) and the positions."""
    stride = dmax * esize + 16
    stages = 2 * 2 * tile_keys * stride
    if route == "decode":
        return (stages + tile_rows * dmax * 4 + tile_rows * tile_keys * 4
                + 4 * tile_rows * 4)
    return stages + tile_rows * stride + tile_rows * 4


@functools.lru_cache(maxsize=512)
def paged_attn_plan(b: int, L: int, heads: int, kv_heads: int, d: int,
                    page_tokens: int, W: int, dtype) -> PagedPlan:
    """B2's launch plan for q ``[b, L, heads, d]`` (d a multiple of 8,
    at most 256), pages of ``page_tokens`` tokens, tables ``W`` wide.

    Route: ``chunk`` (64-row bf16 tensor-core tiles, 64-key K/V tiles)
    for bfloat16 with n_rep·L >= 16, else ``decode`` (16-row tiles, fp32
    products). Splits: the fewest keys per split, a multiple of the K/V
    tile and of the page, that give about ``PAGED_BLOCKS_PER_SM`` blocks
    an SM over the (row, kv head, query tile) groups, or one split where
    the groups alone fill the card."""
    dmax = kernel_head_dim(d)  # raises above 256
    if d % 8:
        raise ValueError(f"paged_attn: head dim {d} is not a multiple of 8")
    esize = torch.empty((), dtype=dtype).element_size()
    rows = heads // kv_heads * L
    if dtype == torch.bfloat16 and rows >= PAGED_CHUNK_MIN_ROWS:
        route, tile_rows, tile_keys = "chunk", 64, 64
    else:
        route, tile_rows = "decode", 16
        tile_keys = _decode_tile_keys(dmax, esize)
    groups = b * kv_heads * -(-rows // tile_rows)
    span = W * page_tokens
    unit = math.lcm(tile_keys, page_tokens)
    want = -(-PAGED_SMS * PAGED_BLOCKS_PER_SM // groups)
    keys = -(-(-(-span // want)) // unit) * unit
    n_splits = -(-span // keys)
    return PagedPlan(route, b, L, heads, kv_heads, d, page_tokens, W,
                     tile_rows, tile_keys, keys, n_splits,
                     _smem_bytes(route, dmax, esize, tile_rows, tile_keys))


def _index(x, device):
    """An index tensor as the kernel reads it: int64 (what the engine
    holds, so its tables go through without a cast), contiguous, on
    ``device``."""
    return torch.as_tensor(x, device=device).to(torch.int64).contiguous()


def paged_attention_cuda(q, k_pages, v_pages, bt, q_pos):
    """Launch kernel B2 on CUDA tensors; out ``[b, L, heads, d]``.

    ``bt`` and ``q_pos`` are read on the device as int64 (another
    integer type is cast on the device; never copied to the host). A
    head dim that is not a multiple of 8 is zero-padded to one (scale of
    the true dim); the kernel takes any other d up to 256 as it is. The
    launch plan is ``paged_attn_plan``'s; with more than one split the
    wrapper allocates the fp32 workspace of the partials, and the entry
    point launches the combine after the main kernel (each counted)."""
    for what, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_attn: {what} is on {t.device}, not "
                             f"q's CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"paged_attn: {what} is {t.dtype}, q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"paged_attn: {what} must be 4-d")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"paged_attn: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    b, L, heads, d = q.shape
    pool_pages, page_tokens, kv_heads, _ = k_pages.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"paged_attn: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if heads % kv_heads:
        raise ValueError(f"paged_attn: {heads} heads not divisible by "
                         f"{kv_heads} kv heads")
    if bt.dim() != 2 or bt.shape[0] != b or tuple(q_pos.shape) != (b, L):
        raise ValueError(f"paged_attn: bt {tuple(bt.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match q "
                         f"{tuple(q.shape)}")
    dim = d + (-d) % 8
    plan = paged_attn_plan(b, L, heads, kv_heads, dim, page_tokens,
                           bt.shape[1], q.dtype)
    q_, k_, v_ = (_pad(x, dim) for x in (q, k_pages, v_pages))
    out = torch.empty_like(q_)
    if out.numel() == 0:
        return out[..., :d]
    bt_, pos_ = _index(bt, q.device), _index(q_pos, q.device)
    ws = None
    if plan.workspace_floats:
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                         device=q.device)
    fn = _kernel_fn("paged_attn", "paged_attn", 7, 16)
    _run(fn, "paged_attn", q, q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
         bt_.data_ptr(), pos_.data_ptr(), out.data_ptr(),
         None if ws is None else ws.data_ptr(), b, L, heads, kv_heads, dim,
         plan.dmax, page_tokens, bt.shape[1], pool_pages,
         _KERNEL_DTYPES[q.dtype], *plan.args, d ** -0.5)
    PAGED_ATTN.launches += 1
    if plan.n_splits > 1:
        PAGED_ATTN_COMBINE.launches += 1
    return out if dim == d else out[..., :d]


def paged_attention(q, k_pages, v_pages, bt, q_pos):
    """Paged attention by device: ``paged_attention_reference`` for CPU
    tensors, kernel B2 for CUDA ones."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, bt, q_pos)
    return paged_attention_cuda(q, k_pages, v_pages, bt, q_pos)
