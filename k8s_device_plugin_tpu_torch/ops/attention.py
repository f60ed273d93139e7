"""Flash-style attention forward: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

The counterpart of ``k8s_device_plugin_tpu/ops/attention.py``. The
layout at the public functions is the reference's: q ``[b, h, s, d]``,
k/v ``[b, kv_heads, s, d]``, outputs ``out [b, h, s, d]`` in q's dtype
and ``lse [b, h, s]`` in float32.

Dispatch is by the tensors' device, nothing else: a CPU tensor takes
the plain version (``reference_attention`` / ``..._with_lse``, which
mirror the reference's jnp code operation for operation); a CUDA tensor
launches the kernel in ``csrc/flash_fwd.cu`` or raises. There is no
fallback from the card to the plain version or to a library call.

K/V may carry fewer heads than q (GQA): q head h attends kv head
``h // (heads // kv_heads)``, the ``repeat_kv`` order of
models/transformer.py. The kernel reads the shared head in place; the
plain version expands it first.

Only the forward is ported: the backward kernels (the reference's
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``) are training work still to
port (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30
_KERNEL_DIMS = (64, 128)
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


def _check_kernel_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_fwd: {name} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} is not contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_fwd: {name} is {t.dtype}, q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_fwd: {name} must be [b, h, s, d]")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_fwd: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    b, h, _, d = q.shape
    if d not in _KERNEL_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not supported "
                         f"({_KERNEL_DIMS})")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"flash_fwd: {h} heads not divisible by "
                         f"{k.shape[1]} kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k, v on different devices")


def _flash_fn():
    """The built kernel's C entry point, typed for ctypes once (ctypes
    caches the function object on the library)."""
    from k8s_device_plugin_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


def flash_forward_cuda(q, k, v, causal: bool):
    """Launch the CUDA kernel (kernel B1 of PERF.md); (out, lse).

    bfloat16 runs on the tensor cores (mma.sync), float32 on FP32 FMA
    (csrc/flash_fwd.cu says why)."""
    _check_kernel_inputs(q, k, v)
    fn = _flash_fn()
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, k.shape[1], s, k.shape[2], d,
                _KERNEL_DTYPES[q.dtype], int(bool(causal)), d ** -0.5,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    FLASH_FWD.launches += 1
    return out, lse


def flash_attention_with_lse(q, k, v, causal: bool = False):
    """Fused attention that also returns the per-row logsumexp.

    Returns (out [b, h, s, d], lse [b, h, s] float32). CPU tensors take
    ``reference_attention_with_lse``; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return reference_attention_with_lse(q, k, v, causal=causal)
    return flash_forward_cuda(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = False):
    """Fused attention for [batch, heads, seq, head_dim] inputs.

    CPU tensors take ``reference_attention`` (as the reference falls back
    to its jnp version off the TPU); CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal)
    return flash_forward_cuda(q, k, v, causal)[0]
