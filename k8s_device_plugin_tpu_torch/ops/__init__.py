"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from k8s_device_plugin_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_with_lse,
    reference_attention,
    reference_attention_with_lse,
)

__all__ = ["flash_attention", "flash_attention_with_lse",
           "reference_attention", "reference_attention_with_lse"]
