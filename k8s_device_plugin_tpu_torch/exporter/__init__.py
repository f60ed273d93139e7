"""L2 health services: per-GPU health from the metrics exporter socket.

Counterpart of the reference's internal/pkg/exporter (health.go): the
device plugin's health merge (health.py), and the readers the exporter
daemon (cmd/metrics_exporter.py) serves: temperature and PCIe link from
sysfs or NVML (telemetry.py), device memory and utilisation from NVML
behind a poll state and a circuit breaker (runtime.py).
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
