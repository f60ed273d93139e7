"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from k8s_device_plugin_tpu_torch.ops.attention import (
    FlashAttention,
    flash_attention,
    flash_attention_with_lse,
    reference_attention,
    reference_attention_backward,
    reference_attention_with_lse,
)

__all__ = ["FlashAttention", "flash_attention", "flash_attention_with_lse",
           "reference_attention", "reference_attention_backward",
           "reference_attention_with_lse"]
