"""L2 health services: per-device health from the metrics exporter socket.

Counterpart of the reference's internal/pkg/exporter (health.go). Only
the health merge is ported; the exporter daemon and its runtime and
telemetry pollers are not yet (ROADMAP A10).
"""

from k8s_device_plugin_tpu_torch.exporter.health import (
    DEFAULT_HEALTH_SOCKET,
    get_tpu_health,
    populate_per_tpu_health,
)

__all__ = [
    "DEFAULT_HEALTH_SOCKET",
    "get_tpu_health",
    "populate_per_tpu_health",
]
