"""PyTorch + CUDA port of the llm-serve workload, for NVIDIA Hopper.

A package beside the JAX reference ``k8s_device_plugin_tpu``, mirroring
its layout (models/, ops/, obs/, utils/) so each counterpart sits at the
same relative path. It imports torch, numpy and the standard library and
nothing of the reference package: the host-only modules it needs are
copies (tests/test_torch_isolation.py holds the list). Kernels are
hand-written CUDA under csrc/, built at first use (ops/_build.py), through
the persistent kernel cache when one is set (models/compile_cache.py).
"""
