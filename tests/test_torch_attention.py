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


# ---------------------------------------------------------------------------
# backward: FlashAttention against the reference's custom_vjp
# ---------------------------------------------------------------------------

BWD_TOL = dict(atol=5e-4, rtol=5e-4)  # the reference's own kernel bar


def _port_grads(q, k, v, causal, loss):
    """Gradients of ``loss(out, lse)`` through the port's FlashAttention
    on the CPU (plain forward and plain backward)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tattn.FlashAttention.apply(qt, kt, vt, causal)
    loss(out, lse).backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


def _jax_flash(causal, with_lse=False):
    fn = jattn.flash_attention_with_lse if with_lse else jattn.flash_attention
    return lambda q_, k_, v_: fn(q_, k_, v_, causal=causal, block_q=128,
                                 block_k=128, interpret=True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dim", [64, 128])
def test_flash_backward_matches_jax_interpret(dim, causal):
    """jax.vjp of the reference's Pallas backward (interpret mode, B3/B4)
    against the port's FlashAttention backward, random cotangent."""
    import jax

    q, k, v = _qkv((1, 2, 256, dim), seed=10)
    g = np.random.default_rng(11).standard_normal(q.shape, dtype=np.float32)
    _, vjp = jax.vjp(_jax_flash(causal), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _port_grads(q, k, v, causal,
                      lambda o, _: (o * torch.from_numpy(g)).sum())
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), **BWD_TOL,
                                   err_msg=f"d{name}")


def test_with_lse_loss_gradients_match_jax():
    """The composite loss of tests/test_workloads.py:190-213 on both
    packages: a loss on both outputs, lse nonlinearly."""
    import jax

    q, k, v = _qkv((1, 2, 256, 128), seed=12)

    def jloss(q_, k_, v_):
        out, lse = _jax_flash(True, with_lse=True)(q_, k_, v_)
        return (out ** 2).mean() + jnp.exp(lse / 8.0).mean()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(q, k, v, True, lambda o, lse: (
        (o ** 2).mean() + torch.exp(lse / 8.0).mean()))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), **BWD_TOL,
                                   err_msg=f"d{name}")


def test_gqa_backward_matches_jax_over_repeat_kv():
    """JAX over repeat_kv-expanded K/V, differentiated with respect to the
    unexpanded arrays, against the port's grouped dK/dV."""
    import jax

    q, k, v = _qkv((1, 4, 256, 64), kv_heads=2, seed=13)
    g = np.random.default_rng(14).standard_normal(q.shape, dtype=np.float32)
    flash = _jax_flash(True)

    def jfn(q_, k_, v_):
        return flash(q_, jnp.repeat(k_, 2, axis=1), jnp.repeat(v_, 2, axis=1))

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _port_grads(q, k, v, True,
                      lambda o, _: (o * torch.from_numpy(g)).sum())
    assert got[1].shape == k.shape and got[2].shape == v.shape
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), **BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,kv_heads", [((2, 4, 200, 64), 2),
                                            ((1, 2, 64, 16), 1)])
def test_reference_backward_matches_autograd(shape, kv_heads, causal):
    """reference_attention_backward (what B3/B4 are held to on the card)
    equals torch.autograd of reference_attention_with_lse, with an lse
    cotangent and grouped kv heads; float64 inputs, computed in float32."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in _qkv(shape, kv_heads=kv_heads, seed=15))
    rng = np.random.default_rng(16)
    g = torch.from_numpy(rng.standard_normal(shape)).double()
    g_lse = torch.from_numpy(rng.standard_normal(shape[:3])).double()
    out, lse = tattn.reference_attention_with_lse(q, k, v, causal)
    want = torch.autograd.grad((out * g).sum() + (lse * g_lse).sum(),
                               (q, k, v))
    with torch.no_grad():
        got = tattn.reference_attention_backward(q, k, v, out, lse, g,
                                                 g_lse, causal=causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_cpu_backward_launches_no_kernel():
    q, k, v = (t.requires_grad_() for t in _torch(*_qkv((1, 2, 128, 64))))
    counters = (tattn.FLASH_FWD, tattn.FLASH_BWD_DQ, tattn.FLASH_BWD_DKV)
    before = [c.launches for c in counters]
    tattn.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and k.grad.shape == k.shape
    assert [c.launches for c in counters] == before


def test_backward_kernel_entry_refuses_cpu_tensors():
    q, k, v = _torch(*_qkv((1, 2, 128, 64)))
    out, lse = tattn.reference_attention_with_lse(q, k, v, True)
    with pytest.raises(ValueError, match="not CUDA"):
        tattn.flash_backward_cuda(q, k, v, out, lse, out, causal=True)


@pytest.mark.parametrize("dim,want", [(16, 64), (64, 64), (96, 128),
                                      (128, 128), (192, 256), (256, 256),
                                      (384, None)])
def test_kernel_head_dim_pads_up_to_64_or_128(dim, want):
    """Head dims run on the card zero-padded to the next kernel width,
    64, 128 or 256 (the reference's rule pads to 128 lanes); above 256
    raises, naming ROADMAP's queue C."""
    if want is None:
        with pytest.raises(ValueError, match="head dim.*ROADMAP"):
            tattn.kernel_head_dim(dim)
    else:
        assert tattn.kernel_head_dim(dim) == want
