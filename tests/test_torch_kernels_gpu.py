"""The port's CUDA kernels on the card (``gpu`` marker; skipped without
a CUDA device, since a CUDA kernel has no CPU mode).

Run on the machine with the card, which has no JAX — so this file
imports only the port:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Each kernel against its plain PyTorch version on the same inputs (made
with numpy from a seed), then the model and the continuous engine with
the kernel against the plain path. Tolerances: float32 1e-4 (summation
order only); bfloat16 3e-2 (the plain version rounds QK^T to bf16, the
kernel keeps fp32).
"""

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.models import transformer
from k8s_device_plugin_tpu_torch.models.serve import (
    ContinuousBatcher,
    LMServer,
)
from k8s_device_plugin_tpu_torch.ops import attention

pytestmark = pytest.mark.gpu

# head_dim 64: a shape the kernel takes (d in {64, 128})
SMALL = transformer.LMConfig(vocab_size=256, num_layers=2, num_heads=2,
                             embed_dim=128, mlp_dim=256, max_seq_len=128,
                             dtype=torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, kv_heads, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    out = []
    for heads in (h, kv_heads, kv_heads):
        a = rng.standard_normal((b, heads, s, d), dtype=np.float32)
        out.append(torch.from_numpy(a).cuda().to(dtype))
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,kv_heads", [((2, 8, 200, 64), 2),
                                            ((1, 4, 256, 128), 4)])
def test_flash_kernel_matches_plain(cuda, shape, kv_heads, dtype, tol,
                                    causal):
    q, k, v = _qkv(shape, kv_heads, dtype)
    before = attention.FLASH_FWD.launches
    got_o, got_l = attention.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert attention.FLASH_FWD.launches == before + 1
    want_o, want_l = attention.reference_attention_with_lse(q, k, v, causal)
    assert got_o.dtype == dtype and got_l.dtype == torch.float32
    assert (got_o.float() - want_o.float()).abs().max().item() <= tol
    assert (got_l - want_l).abs().max().item() <= tol


def test_flash_kernel_raises_on_unsupported_head_dim(cuda):
    q, k, v = _qkv((1, 2, 128, 32), 2, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, k, v, causal=True)


def test_model_prefill_kernel_matches_plain(cuda, monkeypatch):
    srv = LMServer(config=SMALL, device=cuda)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 128))).cuda()
    got, _ = srv._prefill(toks)
    monkeypatch.setattr(transformer, "flash_attention",
                        attention.reference_attention)
    want, _ = srv._prefill(toks)
    assert (got - want).abs().max().item() <= 1e-4


def test_continuous_engine_on_card_matches_oracle(cuda):
    srv = LMServer(config=SMALL, device=cuda)
    jobs = [([5, 17, 99], 7), ([7, 3, 42, 11], 23), ([1], 4), ([88, 2], 12)]
    want = [srv.complete(p, n)[0] for p, n in jobs]
    eng = ContinuousBatcher(srv, max_batch=4, segment_tokens=4)
    before = attention.FLASH_FWD.launches
    reqs = [eng.submit_async(p, n) for p, n in jobs]
    got = [eng.wait(r, timeout=120)[0] for r in reqs]
    assert got == want
    assert attention.FLASH_FWD.launches > before
    assert eng.drain(timeout=30)
