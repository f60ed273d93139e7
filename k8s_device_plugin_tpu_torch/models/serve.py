"""LM serving daemon of the PyTorch port (llm-serve on an NVIDIA card).

    python -m k8s_device_plugin_tpu_torch.models.serve

Serves the DecoderLM over HTTP with the reference's vLLM-compatible
``POST /v1/completions`` surface plus ``GET /healthz`` and
``GET /metrics``, through the continuous batcher: a fixed pool of
``--max-batch`` rows decodes in ``--segment-tokens`` segments (or, with
``--batching static``, the static batcher: requests arriving within
``--batch-window-ms`` share one prefill and one decode loop, after a
startup warmup of every bucket). With
``--kv-cache paged`` (the default) K/V live in a page pool with prefix
reuse, prompts prefill in ``--prefill-chunk`` chunks between segments,
and every attention read runs through the hand-written paged kernel
(B2); with ``--kv-cache rows`` each row has its own cache and prompts
prefill through the flash kernel (B1). ``--role prefill`` and ``--role
decode --handoff-peer URL`` split one paged deployment into a replica
that prefills and ships KV pages and one that decodes
(models/handoff.py). ``--checkpoint DIR`` serves the weights, config
and tokenizer of a port checkpoint directory (models/params.py;
tools/orbax_to_torch.py converts the reference's). ``--experts N``
serves switch-MoE layers (models/moe.py); ``--compile-cache-dir DIR``
keeps the kernel libraries in a persistent cache, so a restart runs no
nvcc (models/compile_cache.py). ``--device cpu`` runs it on the CPU.

This module re-exports the public surface of serve_engine (device core),
serve_batch (scheduling) and serve_http (protocol + CLI), as the
reference's serve.py does.
"""

from __future__ import annotations

import sys

from k8s_device_plugin_tpu_torch.models.serve_batch import (  # noqa: F401
    Batcher,
    ContinuousBatcher,
    _BatcherBase,
    _Request,
)
from k8s_device_plugin_tpu_torch.models.serve_engine import (  # noqa: F401
    TOP_K_CAP,
    DeadlineError,
    LMServer,
    ServerClosingError,
    ShedError,
    log,
)
from k8s_device_plugin_tpu_torch.models.serve_http import (  # noqa: F401
    build_arg_parser,
    main,
)

__all__ = [
    "TOP_K_CAP", "LMServer", "Batcher", "ContinuousBatcher",
    "ShedError", "ServerClosingError", "DeadlineError",
    "build_arg_parser", "main",
]


if __name__ == "__main__":
    sys.exit(main())
