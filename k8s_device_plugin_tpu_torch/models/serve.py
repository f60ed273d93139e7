"""LM serving daemon of the PyTorch port (llm-serve on an NVIDIA card).

    python -m k8s_device_plugin_tpu_torch.models.serve --kv-cache rows

Serves the DecoderLM over HTTP with the reference's vLLM-compatible
``POST /v1/completions`` surface plus ``GET /healthz`` and
``GET /metrics``, through the rows-mode continuous batcher: a fixed pool
of ``--max-batch`` cache rows decodes in ``--segment-tokens`` segments,
and waiting prompts prefill into free rows between segments through the
hand-written flash kernel. ``--device cpu`` runs it on the CPU.

This module re-exports the public surface of serve_engine (device core),
serve_batch (scheduling) and serve_http (protocol + CLI), as the
reference's serve.py does.
"""

from __future__ import annotations

import sys

from k8s_device_plugin_tpu_torch.models.serve_batch import (  # noqa: F401
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
    "TOP_K_CAP", "LMServer", "ContinuousBatcher",
    "ShedError", "ServerClosingError", "DeadlineError",
    "build_arg_parser", "main",
]


if __name__ == "__main__":
    sys.exit(main())
