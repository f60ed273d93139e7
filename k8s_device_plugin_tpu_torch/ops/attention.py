"""Flash-style attention, forward and backward: hand-written CUDA kernels
for Hopper and their plain PyTorch versions.

The counterpart of ``k8s_device_plugin_tpu/ops/attention.py``. The
layout at the public functions is the reference's: q ``[b, h, s, d]``,
k/v ``[b, kv_heads, s, d]``, outputs ``out [b, h, s, d]`` in q's dtype
and ``lse [b, h, s]`` in float32.

``FlashAttention`` is the autograd Function (the reference's custom_vjps
``_flash_diff`` / ``_flash_lse_diff``): its forward returns ``(out,
lse)`` and saves only ``q, k, v, out, lse``, never the probabilities;
its backward recomputes them blockwise. ``flash_attention`` returns its
``out``, ``flash_attention_with_lse`` both, and both are differentiable;
a missing lse cotangent counts as zero.

Dispatch is by the tensors' device, nothing else, forward and backward
alike: a CPU tensor takes the plain version (``reference_attention*``
mirror the reference's jnp code, ``reference_attention_backward`` its
backward kernels); a CUDA tensor launches the kernels or raises —
``csrc/flash_fwd.cu`` (B1) forward, ``csrc/flash_bwd.cu`` (B3 dQ, B4
dK/dV) backward. There is no fallback from the card to the plain version
or to a library call.

K/V may carry fewer heads than q (GQA): q head h attends kv head
``h // (heads // kv_heads)``, the ``repeat_kv`` order of
models/transformer.py. The kernels read the shared head in place and B4
sums its gradient over the group; the plain versions expand first.

The bfloat16 kernels B1, B3 and B4 are Hopper designs (TMA loads into a
ring of shared-memory stages, wgmma products, one producer warpgroup and
two consumer warpgroups); ``flash_fwd_plan`` / ``flash_bwd_dq_plan`` /
``flash_bwd_dkv_plan`` pick their launch plan — tile sizes, stages,
shared-memory bytes — and its schedule, which tile each block computes
and over which steps it loops, in launch order. The C entry point
refuses a plan that does not match its build, and each block reads its
row of the schedule.

The kernels take head dims 64, 128 and 256. On the card, any other head
dim up to 256 is zero-padded to the next of them with the softmax scale
of the true dim, and the results are sliced back: zero lanes add
nothing, so this is exact (the reference's own rule,
attention.py:575-599). Larger head dims raise (ROADMAP.md, queue C).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

_NEG_INF = -1e30
_KERNEL_DIMS = (64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class KernelStats:
    """Launch counter of one kernel wrapper: ``launches`` grows by one
    where the wrapper launches its kernel, and nowhere else."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


FLASH_FWD = KernelStats(
    "flash_fwd",
    source="k8s_device_plugin_tpu_torch/csrc/flash_fwd.cu",
    replaces="k8s_device_plugin_tpu/ops/attention.py:90 (_attn_kernel, "
             "pallas_call at :192)",
)
FLASH_BWD_DQ = KernelStats(
    "flash_bwd_dq",
    source="k8s_device_plugin_tpu_torch/csrc/flash_bwd.cu",
    replaces="k8s_device_plugin_tpu/ops/attention.py:221 (_bwd_dq_kernel, "
             "pallas_call at :382)",
)
FLASH_BWD_DKV = KernelStats(
    "flash_bwd_dkv",
    source="k8s_device_plugin_tpu_torch/csrc/flash_bwd.cu",
    replaces="k8s_device_plugin_tpu/ops/attention.py:275 (_bwd_dkv_kernel, "
             "pallas_call at :413)",
)


def expand_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    """[b, kv_heads, s, d] -> [b, heads, s, d], each kv head repeated for
    its consecutive q heads (the repeat_kv order)."""
    n_rep = heads // k.shape[1]
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=1)


def _causal_mask(seq_q: int, seq_k: int, device) -> torch.Tensor:
    return torch.ones(seq_q, seq_k, dtype=torch.bool, device=device).tril()


def reference_attention(q, k, v, causal: bool = False):
    """Plain attention; the numerical reference for the kernel.

    Mirrors the reference's jnp version: QK^T in the input dtype, scaled,
    masked with -1e30, softmax in float32, probabilities cast back to
    v's dtype for the PV product."""
    k, v = expand_kv(k, q.shape[1]), expand_kv(v, q.shape[1])
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        mask = _causal_mask(scores.shape[-2], scores.shape[-1], q.device)
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def reference_attention_with_lse(q, k, v, causal: bool = False):
    """Reference attention that also returns the per-row logsumexp
    ([b, h, s] float32)."""
    k, v = expand_kv(k, q.shape[1]), expand_kv(v, q.shape[1])
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        mask = _causal_mask(scores.shape[-2], scores.shape[-1], q.device)
        scores = scores.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return out, lse


def attention_delta(out, g, g_lse=None):
    """delta = rowsum(dO * O) - g_lse in float32 ([b, h, s]), from O as
    the forward returned it (in q's dtype, not its fp32 accumulator).
    The reference computes it in XLA outside its kernels
    (attention.py:354-360); the port in plain torch beside them."""
    delta = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def reference_attention_backward(q, k, v, out, lse, g, g_lse=None,
                                 causal: bool = False):
    """Plain backward; the numerical reference for kernels B3 and B4.

    Operation for operation what ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
    compute, in float32: S recomputed with the scale folded into q,
    P = exp(S - LSE), dP = dO V^T, dS = P (dP - delta), dQ = scale dS K,
    dK = dS^T (scale Q), dV = P^T dO. K/V come in unexpanded; dK and dV
    are summed over each group's n_rep q heads (what autodiff of
    repeat_kv gives the reference). Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, heads, s_q, d = q.shape
    kvh, s_k = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qs = q.float() * scale
    kf = expand_kv(k, heads).float()
    vf = expand_kv(v, heads).float()
    gf = g.float()
    delta = attention_delta(out, g, g_lse)
    scores = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    if causal:
        scores = scores.masked_fill(~_causal_mask(s_q, s_k, q.device),
                                    _NEG_INF)
    probs = torch.exp(scores - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = probs * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, gf)
    n_rep = heads // kvh
    dk = dk.view(b, kvh, n_rep, s_k, d).sum(2)
    dv = dv.view(b, kvh, n_rep, s_k, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_kernel_inputs(name, q, k, v, *rows):
    """Device, dtype, layout and shape checks shared by the three kernel
    wrappers; ``rows`` are [b, h, s, d] tensors that must match q."""
    for what, t in (("q", q), ("k", k), ("v", v)) + rows:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {what} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} is not contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype}, q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {what} must be [b, h, s, d]")
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v on different devices")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    b, h, _, d = q.shape
    if d not in _KERNEL_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported "
                         f"({_KERNEL_DIMS})")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{name}: {h} heads not divisible by "
                         f"{k.shape[1]} kv heads")
    for what, t in rows:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} does not "
                             f"match q {tuple(q.shape)}")


# ---------------------------------------------------------------------------
# launch plans of the bfloat16 Hopper kernels (B1, B3, B4)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448   # bytes of shared memory one block may use (H100)
TMA_BOX_ROW_LIMIT = 128  # bytes: the widest box row the 128-byte swizzle takes
_WG_ROWS = 64          # rows of one consumer warpgroup (the wgmma M)
_CONSUMERS = 2         # consumer warpgroups per block
_THREADS = 128 * (_CONSUMERS + 1)  # + one producer warpgroup
_BOX_ROW = 64 * 2      # a box row: 64 bf16 elements


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch of a bfloat16 Hopper kernel is cut.

    ``groups`` are the (batch, head) pairs the kernel runs over (b·h for
    B1 and B3, b·kv_heads for B4) and ``tiles`` the row tiles of each: q
    tiles of ``block_rows`` rows (B1, B3) or key tiles (B4). Each block
    loops over ``step_rows``-row steps (B1, B3: keys of a K/V stage; B4: q
    rows of a Q/dO stage) through a ring of ``stages`` shared-memory
    stages, the steps that ``schedule()`` gives it. ``boxes`` are the TMA
    boxes, (operand, bytes per box row, box rows). ``args`` is what the C
    entry point takes beside the schedule: the first four it checks
    against its build, the last is the schedule's length. ``splits`` is
    how many blocks run each schedule row, neighbours in launch order,
    each owning ``head_dim / splits`` output columns (B4 at d = 256)."""

    kernel: str
    head_dim: int
    causal: bool
    seq_q: int
    seq_k: int
    n_rep: int
    groups: int
    tiles: int
    block_rows: int
    step_rows: int
    stages: int
    threads: int
    smem_bytes: int
    boxes: tuple
    splits: int = 1

    @property
    def grid(self) -> int:
        return self.groups * self.tiles

    @property
    def args(self) -> tuple[int, int, int, int, int]:
        return (self.block_rows, self.step_rows, self.stages,
                self.smem_bytes, self.grid)

    def schedule(self) -> torch.Tensor:
        """[grid, 4] int32, one row per block in launch order: (group,
        tile, first step, end step). The kernel reads its row and nothing
        else: it computes that tile and loops over steps first .. end - 1
        (B4: for each of the group's n_rep q heads).

        B1 and B3 take q tiles from the last down, so under a causal mask
        the heaviest start first; a tile's K/V stages end at its last row
        (causal) or at seq_k. B4 takes key tiles from the first up, the
        ones that own the most q steps; its q steps start at the one
        holding the tile's first key (causal) or at 0, and end at seq_q."""
        i = torch.arange(self.grid)
        group, tile = i % self.groups, i // self.groups
        if self.kernel in ("flash_fwd", "flash_bwd_dq"):
            tile = self.tiles - 1 - tile
            end_row = torch.full_like(tile, self.seq_k)
            if self.causal:
                end_row = torch.clamp(
                    (tile + 1) * self.block_rows, max=self.seq_k)
            end = (end_row + self.step_rows - 1) // self.step_rows
            first = torch.zeros_like(end)
        else:
            end = torch.full_like(tile, -(-self.seq_q // self.step_rows))
            first = torch.zeros_like(end)
            if self.causal:
                first = torch.minimum(
                    tile * self.block_rows // self.step_rows, end)
        return torch.stack([group, tile, first, end], 1).to(torch.int32)


@functools.lru_cache(maxsize=256)
def flash_fwd_plan(batch: int, heads: int, kv_heads: int, seq_q: int,
                   seq_k: int, head_dim: int, causal: bool) -> LaunchPlan:
    """B1 (bf16): 128 q rows a block (two warpgroups of 64), K/V stages of
    128 keys (64 at d = 256, where the O accumulator takes 128 registers
    a thread), as many stages as fit beside Q (4 / 3 / 2 at d = 64 / 128 /
    256); the shared-memory layout of csrc/flash_fwd.cu's FwdPlan."""
    block = _WG_ROWS * _CONSUMERS
    step = 64 if head_dim == 256 else 128
    stages = {64: 4, 128: 3, 256: 2}[head_dim]
    q_bytes = block * head_dim * 2
    kv_bytes = step * head_dim * 2
    smem = 1024 + q_bytes + stages * 2 * kv_bytes + (2 * stages + 1) * 8
    boxes = (("q", _BOX_ROW, block), ("k", _BOX_ROW, step),
             ("v", _BOX_ROW, step))
    return LaunchPlan("flash_fwd", head_dim, bool(causal), seq_q, seq_k,
                      heads // kv_heads, batch * heads, -(-seq_q // block),
                      block, step, stages, _THREADS, smem, boxes)


@functools.lru_cache(maxsize=256)
def flash_bwd_dq_plan(batch: int, heads: int, kv_heads: int, seq_q: int,
                      seq_k: int, head_dim: int, causal: bool) -> LaunchPlan:
    """B3 (bf16): 128 q rows a block (two warpgroups of 64) with Q and dO
    resident, K/V stages of 128 keys in a ring of 4 at d = 64, of 64 keys
    in a ring of 5 at d = 128, of 32 keys in a ring of 3 at d = 256; the
    shared-memory layout of csrc/flash_bwd.cu's dq::Build. The key stage
    is what keeps a consumer's dQ accumulator (d/2 fp32), its S and dP
    tiles and dS's bf16 operands in registers without spills."""
    block = _WG_ROWS * _CONSUMERS
    step, stages = {64: (128, 4), 128: (64, 5), 256: (32, 3)}[head_dim]
    q_bytes = block * head_dim * 2
    kv_bytes = step * head_dim * 2
    smem = 1024 + 2 * q_bytes + stages * 2 * kv_bytes + (2 * stages + 1) * 8
    boxes = (("q", _BOX_ROW, block), ("do", _BOX_ROW, block),
             ("k", _BOX_ROW, step), ("v", _BOX_ROW, step))
    return LaunchPlan("flash_bwd_dq", head_dim, bool(causal), seq_q, seq_k,
                      heads // kv_heads, batch * heads, -(-seq_q // block),
                      block, step, stages, _THREADS, smem, boxes)


@functools.lru_cache(maxsize=256)
def flash_bwd_dkv_plan(batch: int, heads: int, kv_heads: int, seq_q: int,
                       seq_k: int, head_dim: int, causal: bool) -> LaunchPlan:
    """B4 (bf16): 128 keys a block (two warpgroups of 64), q steps of 64
    rows (32 at d = 256), Q/dO stages as fit beside K and V (4 / 3 / 3 at
    d = 64 / 128 / 256); the shared-memory layout of csrc/flash_bwd.cu's
    dkv::Plan and dkv::Build. The q step is what keeps a consumer's dK and
    dV accumulators (2·d/2 fp32) and its S^T and dP^T tiles in registers
    without spills; at d = 256 the accumulators are split over two blocks
    per schedule row, one per 128-column half of dK and dV."""
    block = _WG_ROWS * _CONSUMERS
    step = 32 if head_dim == 256 else 64
    stages = 4 if head_dim == 64 else 3
    kv_bytes = block * head_dim * 2
    step_bytes = step * head_dim * 2
    smem = (1024 + 2 * kv_bytes + stages * 2 * step_bytes
            + stages * 2 * step * 4 + (2 * stages + 1) * 8)
    boxes = (("q", _BOX_ROW, step), ("do", _BOX_ROW, step),
             ("k", _BOX_ROW, block), ("v", _BOX_ROW, block))
    return LaunchPlan("flash_bwd_dkv", head_dim, bool(causal), seq_q, seq_k,
                      heads // kv_heads, batch * kv_heads, -(-seq_k // block),
                      block, step, stages, _THREADS, smem, boxes,
                      splits=2 if head_dim == 256 else 1)


@functools.lru_cache(maxsize=256)
def _schedule_on(plan: LaunchPlan, device: torch.device) -> torch.Tensor:
    """The plan's schedule in ``device`` memory, copied once per plan."""
    return plan.schedule().to(device)


def _launch_plan(plan_fn, q, k, causal):
    """(schedule pointer, plan ints) for a kernel's C entry point: the
    bfloat16 kernel's plan from ``plan_fn`` with its schedule on q's
    device; float32 takes none."""
    if q.dtype != torch.bfloat16:
        return None, (0, 0, 0, 0, 0)
    b, h, s, d = q.shape
    plan = plan_fn(b, h, k.shape[1], s, k.shape[2], d, bool(causal))
    return _schedule_on(plan, q.device).data_ptr(), plan.args


def _kernel_fn(lib: str, symbol: str, n_ptr: int, n_int: int):
    """A built kernel's C entry point, typed for ctypes once (ctypes
    caches the function object on the library): ``n_ptr`` pointers,
    ``n_int`` ints, then the scale and the stream."""
    from k8s_device_plugin_tpu_torch.ops import _build

    fn = getattr(_build.load(lib), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


_KERNEL_ERRORS = {
    -1: "dtype or head dim not built",
    -2: "launch plan does not match the build",
    -3: "cuTensorMapEncodeTiled not found in libcuda",
    -4: "libcuda refused a TMA tensor map",
}


def _run(fn, name, q, *args):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        why = _KERNEL_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{name} launch failed: {why} ({rc})")


def flash_forward_cuda(q, k, v, causal: bool, scale: float | None = None):
    """Launch kernel B1 (flash forward); (out, lse).

    bfloat16 runs the Hopper design (TMA + wgmma) with the launch plan of
    ``flash_fwd_plan``, float32 on FP32 FMA (csrc/flash_fwd.cu says why).
    ``scale`` defaults to d^-0.5."""
    _check_kernel_inputs("flash_fwd", q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    schedule, plan = _launch_plan(flash_fwd_plan, q, k, causal)
    fn = _kernel_fn("flash_fwd", "flash_fwd", 6, 13)
    _run(fn, "flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), lse.data_ptr(), schedule, b, h, k.shape[1], s,
         k.shape[2], d, _KERNEL_DTYPES[q.dtype], int(bool(causal)), *plan,
         d ** -0.5 if scale is None else scale)
    FLASH_FWD.launches += 1
    return out, lse


def _bwd_args(q, k, causal, scale):
    b, h, s, d = q.shape
    return (b, h, k.shape[1], s, k.shape[2], d, _KERNEL_DTYPES[q.dtype],
            int(bool(causal)), d ** -0.5 if scale is None else scale)


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal: bool,
                      scale: float | None = None):
    """Launch kernel B3: dQ ([b, h, s, d], q's dtype) from the saved
    forward tensors, the output cotangent ``g`` and fp32 ``lse`` /
    ``delta`` ([b, h, s]). bfloat16 runs the Hopper design with the plan
    of ``flash_bwd_dq_plan``."""
    _check_kernel_inputs("flash_bwd_dq", q, k, v, ("g", g))
    dq = torch.empty_like(q)
    if dq.numel() == 0 or k.numel() == 0:
        return dq.zero_()
    schedule, plan = _launch_plan(flash_bwd_dq_plan, q, k, causal)
    *ints, scale = _bwd_args(q, k, causal, scale)
    fn = _kernel_fn("flash_bwd", "flash_bwd_dq", 8, 13)
    _run(fn, "flash_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
         schedule, *ints, *plan, scale)
    FLASH_BWD_DQ.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal: bool,
                       scale: float | None = None):
    """Launch kernel B4: (dK, dV), unexpanded ([b, kv_heads, s, d]),
    summed over each kv head's group of q heads inside the kernel.
    bfloat16 runs the Hopper design with the plan of
    ``flash_bwd_dkv_plan``."""
    _check_kernel_inputs("flash_bwd_dkv", q, k, v, ("g", g))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0 or q.numel() == 0:
        return dk.zero_(), dv.zero_()
    schedule, plan = _launch_plan(flash_bwd_dkv_plan, q, k, causal)
    *ints, scale = _bwd_args(q, k, causal, scale)
    fn = _kernel_fn("flash_bwd", "flash_bwd_dkv", 9, 13)
    _run(fn, "flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
         dv.data_ptr(), schedule, *ints, *plan, scale)
    FLASH_BWD_DKV.launches += 1
    return dk, dv


def flash_backward_cuda(q, k, v, out, lse, g, g_lse=None,
                        causal: bool = False, scale: float | None = None):
    """Kernels B3 and B4 for one backward; (dq, dk, dv).

    delta = rowsum(dO * O) - g_lse is plain torch (attention_delta), as
    in the reference, from the ``out`` the forward returned."""
    _check_kernel_inputs("flash_bwd", q, k, v, ("out", out), ("g", g))
    lse = lse.float().contiguous()
    delta = attention_delta(out, g, g_lse).contiguous()
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a true head dim ``d`` at: the next of
    64 / 128 / 256. Raises above 256 (no model config of the repository
    has such a head dim; ROADMAP.md, queue C)."""
    for dim in _KERNEL_DIMS:
        if d <= dim:
            return dim
    raise ValueError(f"flash attention: head dim {d} not supported on the "
                     f"card (at most {_KERNEL_DIMS[-1]}; ROADMAP.md, "
                     f"queue C)")


def _pad(x, dim):
    pad = dim - x.shape[-1]
    x = x.contiguous()
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad))


def attention_forward(q, k, v, causal):
    """(out, lse) by device: the plain version on the CPU, B1 on CUDA
    (head dim zero-padded to the kernel's, scale of the true dim). No
    autograd: ``FlashAttention`` and parallel/ring_attention.py's ring
    call it in their forwards."""
    if q.device.type == "cpu":
        return reference_attention_with_lse(q, k, v, causal=causal)
    d = q.shape[-1]
    dim = kernel_head_dim(d)
    out, lse = flash_forward_cuda(_pad(q, dim), _pad(k, dim), _pad(v, dim),
                                  causal, scale=d ** -0.5)
    return out[..., :d].contiguous() if dim != d else out, lse


def attention_backward(q, k, v, out, lse, g, g_lse, causal):
    """(dq, dk, dv) by device: the plain version on the CPU, B3 + B4 on
    CUDA (padded as the forward is), from the forward's ``out`` and
    ``lse``; ``FlashAttention`` and the ring call it in their
    backwards."""
    if q.device.type == "cpu":
        return reference_attention_backward(q, k, v, out, lse, g, g_lse,
                                            causal=causal)
    d = q.shape[-1]
    dim = kernel_head_dim(d)
    grads = flash_backward_cuda(
        _pad(q, dim), _pad(k, dim), _pad(v, dim), _pad(out, dim), lse,
        _pad(g, dim), g_lse, causal=causal, scale=d ** -0.5)
    if dim == d:
        return grads
    return tuple(x[..., :d] for x in grads)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``apply(q, k, v, causal)`` returns
    ``(out, lse)``; both outputs carry gradients (the lse cotangent
    folds into delta, as in the reference's ``_flash_lse_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = attention_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        dq, dk, dv = attention_backward(q, k, v, out, lse, g, g_lse,
                                        ctx.causal)
        return dq, dk, dv, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention_with_lse(q, k, v, causal: bool = False):
    """Fused attention that also returns the per-row logsumexp.

    Returns (out [b, h, s, d], lse [b, h, s] float32), differentiable in
    both. CPU tensors take the plain versions; CUDA tensors the kernels."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return attention_forward(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = False):
    """Fused attention for [batch, heads, seq, head_dim] inputs.

    Differentiable through ``FlashAttention``. Without gradients (serving
    under ``torch.inference_mode``) it launches only the forward: CPU
    tensors take ``reference_attention`` (as the reference falls back to
    its jnp version off the TPU), CUDA tensors kernel B1."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)[0]
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal)
    return attention_forward(q, k, v, causal)[0]
