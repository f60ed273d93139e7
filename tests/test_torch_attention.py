"""The port's flash attention (k8s_device_plugin_tpu_torch.ops.attention)
against the JAX reference's.

On the CPU the port's wrappers take their plain PyTorch version; the
reference's flash_attention runs its Pallas kernel in interpret mode (as
tests/test_workloads.py runs it). Inputs come from numpy with a seed and
go through both; float32, atol/rtol 1e-5 (the two differ only in
summation order). The CUDA kernel itself runs only on the card:
tests/test_torch_kernels_gpu.py and chip_smoke.py hold it against the
plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.ops import attention as jattn
from k8s_device_plugin_tpu_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(shape, kv_heads=None, seed=0):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    kvh = kv_heads or h
    q = rng.standard_normal((b, h, s, d), dtype=np.float32)
    k = rng.standard_normal((b, kvh, s, d), dtype=np.float32)
    v = rng.standard_normal((b, kvh, s, d), dtype=np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq,dim", [(128, 64), (256, 128)])
def test_flash_with_lse_matches_jax_interpret(seq, dim, causal):
    q, k, v = _qkv((2, 4, seq, dim))
    want_o, want_l = jattn.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128, interpret=True,
    )
    got_o, got_l = tattn.flash_attention_with_lse(*_torch(q, k, v),
                                                  causal=causal)
    assert got_o.shape == (2, 4, seq, dim) and got_o.dtype == torch.float32
    assert got_l.shape == (2, 4, seq) and got_l.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_references(causal):
    q, k, v = _qkv((2, 4, 128, 64), seed=1)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    got = tattn.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jattn.reference_attention(jq, jk, jv, causal=causal)),
        **TOL)
    got_o, got_l = tattn.reference_attention_with_lse(*_torch(q, k, v),
                                                      causal=causal)
    want_o, want_l = jattn.reference_attention_with_lse(jq, jk, jv,
                                                        causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_gqa_reads_kv_head_h_div_nrep():
    """K/V with fewer heads: q head h attends kv head h // n_rep, the
    reference's repeat_kv order, against the expanded JAX reference."""
    q, k, v = _qkv((2, 4, 128, 64), kv_heads=2, seed=2)
    kx, vx = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    want_o, want_l = jattn.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), causal=True,
        block_q=128, block_k=128, interpret=True,
    )
    got_o, got_l = tattn.flash_attention_with_lse(*_torch(q, k, v),
                                                  causal=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_ragged_seq_matches_jax_reference():
    """A sequence that is no multiple of any block (the kernel masks the
    ragged tile; the reference falls back to its jnp version)."""
    q, k, v = _qkv((1, 2, 200, 64), seed=3)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True)
    got = tattn.flash_attention(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_path_launches_no_kernel():
    q, k, v = _torch(*_qkv((1, 2, 128, 64)))
    before = tattn.FLASH_FWD.launches
    tattn.flash_attention(q, k, v, causal=True)
    assert tattn.FLASH_FWD.launches == before


def test_kernel_entry_refuses_cpu_tensors():
    """The kernel wrapper itself never runs the plain version: a CPU (or
    otherwise unsupported) input raises before any build or launch."""
    q, k, v = _torch(*_qkv((1, 2, 128, 64)))
    with pytest.raises(ValueError, match="not CUDA"):
        tattn.flash_forward_cuda(q, k, v, causal=True)
