"""Per-GPU telemetry from standard kernel interfaces, then NVML.

The reference's readers, for NVIDIA GPUs: temperature via the hwmon
class (``<device>/hwmon/hwmon*/temp*_input``, millidegrees) and PCIe
link state via the PCI core's ``current_link_speed`` /
``current_link_width`` attributes, under the GPU's PCI function
``/sys/bus/pci/devices/<pci_address>``. NVIDIA's driver registers no
hwmon device, and a runtime that virtualises the GPU shows no PCI
function at all, so where sysfs gives no value NVML's answer for the
GPU's UUID fills it (the die temperature; the link's generation, mapped
to GT/s, and width). Everything stays optional: a field neither source
gives is None, and the exporter emits no sample for it.

Served through the metrics exporter's Prometheus endpoint; the gRPC
metricssvc wire contract is unchanged (the reference's GPUState carries
no telemetry either, metricssvc.pb.go:95-110).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional

from k8s_device_plugin_tpu_torch.utils import sysfs as sysfs_util

# PCIe generation -> per-lane rate in GT/s (what ``current_link_speed``
# reads for a link at that generation).
PCIE_GEN_GTS = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}


@dataclass(frozen=True)
class ChipTelemetry:
    temp_c: Optional[float] = None          # hottest sensor, Celsius
    link_speed_gts: Optional[float] = None  # PCIe GT/s
    link_width: Optional[int] = None        # PCIe lanes


def _device_dir(chip, sysfs_root: str) -> Optional[str]:
    """The GPU's PCI function directory; None where its address is
    unknown."""
    if chip.pci_address:
        return os.path.join(
            sysfs_root, "bus", "pci", "devices", chip.pci_address
        )
    return None


def _read_sysfs(dev: str) -> ChipTelemetry:
    temp_c = None
    for temp_file in sorted(
        glob.glob(os.path.join(dev, "hwmon", "hwmon*", "temp*_input"))
    ):
        raw = sysfs_util.read_int(temp_file)
        if raw is None:
            continue
        celsius = raw / 1000.0
        temp_c = celsius if temp_c is None else max(temp_c, celsius)

    speed = None
    raw_speed = sysfs_util.read_str(os.path.join(dev, "current_link_speed"))
    if raw_speed:
        # Kernel format: "16.0 GT/s PCIe" (older: "8 GT/s").
        try:
            speed = float(raw_speed.split()[0])
        except (ValueError, IndexError):
            speed = None

    width = sysfs_util.read_int(os.path.join(dev, "current_link_width"))

    return ChipTelemetry(temp_c=temp_c, link_speed_gts=speed,
                         link_width=width)


def read_chip_telemetry(chip, sysfs_root: str = "/sys") -> ChipTelemetry:
    dev = _device_dir(chip, sysfs_root)
    got = _read_sysfs(dev) if dev is not None else ChipTelemetry()
    if None not in (got.temp_c, got.link_speed_gts, got.link_width) \
            or not chip.uuid:
        return got
    from k8s_device_plugin_tpu_torch.native import binding

    nvml = binding.sample(chip.uuid)
    if nvml is None:
        return got
    temp_c, speed, width = got.temp_c, got.link_speed_gts, got.link_width
    if temp_c is None and nvml["temp_c"] is not None:
        temp_c = float(nvml["temp_c"])
    if speed is None:
        speed = PCIE_GEN_GTS.get(nvml["pcie_gen"])
    if width is None:
        width = nvml["pcie_width"]
    return ChipTelemetry(temp_c=temp_c, link_speed_gts=speed,
                         link_width=width)
