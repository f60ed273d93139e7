"""Plugin configuration shared by the daemon, lister, and plugin instances."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

from k8s_device_plugin_tpu_torch.api import constants


@dataclass
class PluginConfig:
    """Everything a GPUDevicePlugin needs to find and expose hardware.

    All roots are injectable for fixture-driven tests, mirroring the
    reference's optional root-dir parameters (SURVEY.md section 4).
    """

    sysfs_root: str = "/sys"
    dev_root: str = "/dev"
    # The driver's procfs tree (/proc/driver/nvidia/gpus) is read from
    # here: the discovery path without NVML.
    proc_root: str = "/proc"
    device_plugin_dir: str = constants.DEVICE_PLUGIN_PATH

    # Unix socket of the external metrics exporter supplying per-device
    # health (exporter/health.py); probed on each heartbeat with graceful
    # degradation to local device probes when absent.
    health_socket: Optional[str] = None

    # When set, a CDI spec for the advertised devices is written to this
    # directory and Allocate responses include fully-qualified CDI names
    # alongside the classic DeviceSpecs (plugin/cdi.py). None = disabled.
    cdi_spec_dir: Optional[str] = None

    # Directory for the crash-safe allocation/health checkpoint
    # (dpm/checkpoint.py). None disables checkpointing (and with it the
    # restart double-assign guard); the daemon defaults it to
    # TPU_CHECKPOINT_DIR or /var/lib/tpu-device-plugin.
    checkpoint_dir: Optional[str] = None

    # Called when the ListAndWatch stream dies unexpectedly. Production
    # default exits the process so the DaemonSet restarts and re-registers
    # (reference plugin.go:322-324); tests replace it.
    on_stream_end: Callable[[], None] = field(default=lambda: os._exit(1))

    # Seconds between ListAndWatch liveness checks of the stream/heartbeat.
    watch_poll_interval_s: float = 0.5
