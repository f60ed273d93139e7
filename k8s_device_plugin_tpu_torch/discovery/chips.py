"""NVIDIA GPU enumeration from NVML, procfs, sysfs and devfs.

Counterpart of the reference's TPU chip walk (and, further up, of the Go
reference's GetAMDGPUs, internal/pkg/amdgpu/amdgpu.go:156-279). Two
discovery paths, tried in order:

  1. NVML (``native/binding.py``), when the driver's ``libnvidia-ml.so.1``
     loads: the GPUs, their UUIDs, PCI addresses, device minors and the
     far ends of their active NVLinks;
  2. the driver's procfs tree, ``/proc/driver/nvidia/gpus/<bdf>/information``
     (Model, GPU UUID, Bus Location, Device Minor), with
     ``/sys/bus/pci/devices/<bdf>/{vendor,device,numa_node}``.

A GPU's device node is ``/dev/nvidia<minor>``; the minor is neither
nvidia-smi's index nor CUDA's ordinal, so the plugin keys nothing on
either. Every function takes injectable sysfs/dev/proc roots so tests run
against fixture trees (reference pattern: amdgpu.go:103-107,156-166).
"""

from __future__ import annotations

import logging
import os
import stat as stat_mod
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from k8s_device_plugin_tpu_torch.native.binding import normalize_pci_address
from k8s_device_plugin_tpu_torch.utils import faults, sysfs

log = logging.getLogger(__name__)

NVIDIA_VENDOR_ID = 0x10DE

# PCI device-id ranges -> GPU generation (the reference's device-id table
# with its "unknown" default). GH100 parts are 0x2300-0x233f (H100 SXM5
# 0x2330, H100 PCIe 0x2331, H100 NVL 0x2321, H200 0x2335), GA100 parts
# 0x20b0-0x20ff.
DEVICE_ID_RANGES = (
    (0x2300, 0x233F, "hopper"),
    (0x20B0, 0x20FF, "ampere"),
)

MODEL_GENERATIONS = (("H100", "hopper"), ("H200", "hopper"),
                     ("H800", "hopper"), ("A100", "ampere"),
                     ("A800", "ampere"))

PRODUCT_NAMES = {
    "hopper": "NVIDIA Hopper GPU",
    "ampere": "NVIDIA Ampere GPU",
}

# Nodes every CUDA container needs beside its GPUs' own: the control
# node and the unified-memory nodes, mounted where the host has them.
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")

# Like the reference's FatalOnDriverUnavailable kill-switch
# (amdgpu.go:150-163): production treats "no GPU driver" as fatal so the
# DaemonSet pod restarts until the driver appears; tests flip it off.
_FATAL_ON_DRIVER_UNAVAILABLE = True


class DiscoveryError(RuntimeError):
    """No GPU driver / no GPUs found and fatality is enabled."""


def fatal_on_driver_unavailable(value: bool) -> None:
    global _FATAL_ON_DRIVER_UNAVAILABLE
    _FATAL_ON_DRIVER_UNAVAILABLE = value


@dataclass
class GPUChip:
    """One NVIDIA GPU attached to this host."""

    index: int                      # device minor: /dev/nvidia<index>
    # "0000:1b:00.0" (sysfs form); "" where the host hides it (a
    # container runtime that virtualises the GPU, whose NVML answers
    # NOT_SUPPORTED for PCI info)
    pci_address: str
    dev_path: str                   # host device node to mount into pods
    # Dense rank among the host's discovered GPUs (0..n-1): the index
    # into the topology. Differs from ``index`` when the minors have gaps
    # (a GPU fallen off the bus): nvidia0,nvidia2,nvidia3 get 0,1,2.
    mesh_index: int = -1
    vendor_id: int = NVIDIA_VENDOR_ID
    device_id: int = 0
    numa_node: int = -1
    generation: str = "unknown"
    extra_dev_paths: Tuple[str, ...] = ()  # the control nodes
    uuid: str = ""                  # "GPU-8c1c..."; what Allocate exports
    model: str = ""                 # "NVIDIA H100 80GB HBM3"
    # Far ends of the active NVLinks (peer GPUs' or NVSwitches' PCI
    # addresses; NVML only: procfs does not show links).
    nvlinks: Tuple[str, ...] = ()

    @property
    def device_spec_paths(self) -> List[str]:
        return [self.dev_path, *self.extra_dev_paths]

    @property
    def key(self) -> str:
        """The GPU's kubelet device id: its PCI address (the reference's
        rule), or its UUID where the PCI address is unknown."""
        return device_key(self.pci_address, self.uuid)


def device_key(pci_address: str, uuid: str) -> str:
    """``GPUChip.key`` of a GPU with this PCI address ("" where unknown)
    and UUID."""
    return pci_address or uuid


def _control_nodes(dev_root: str) -> Tuple[str, ...]:
    paths = (os.path.join(dev_root, n) for n in CONTROL_NODES)
    return tuple(p for p in paths if os.path.exists(p))


def _read_pci_attrs(sysfs_root: str, addr: str) -> Tuple[int, int, int]:
    """(vendor, device, numa_node) of a PCI function from sysfs."""
    device_dir = os.path.join(sysfs_root, "bus", "pci", "devices", addr)
    vendor = sysfs.read_hex(os.path.join(device_dir, "vendor")) or 0
    device = sysfs.read_hex(os.path.join(device_dir, "device")) or 0
    numa = sysfs.read_int(os.path.join(device_dir, "numa_node"))
    return vendor, device, -1 if numa is None else numa


def parse_information(text: str) -> Dict[str, str]:
    """``/proc/driver/nvidia/gpus/<bdf>/information`` -> {key: value}
    ("Model", "GPU UUID", "Bus Location", "Device Minor", ...)."""
    out = {}
    for line in text.splitlines():
        key, sep, value = line.partition(":")
        if sep:
            out[key.strip()] = value.strip()
    return out


def _discover_procfs(sysfs_root: str, dev_root: str,
                     proc_root: str) -> List[GPUChip]:
    gpus_dir = os.path.join(proc_root, "driver", "nvidia", "gpus")
    extra = _control_nodes(dev_root)
    chips: List[GPUChip] = []
    for name in sysfs.list_dir(gpus_dir):
        info_text = sysfs.read_str(os.path.join(gpus_dir, name, "information"))
        if info_text is None:
            continue
        info = parse_information(info_text)
        addr = normalize_pci_address(info.get("Bus Location", name))
        try:
            minor = int(info["Device Minor"])
        except (KeyError, ValueError):
            log.warning("GPU %s: no device minor in %s; skipping", name,
                        os.path.join(gpus_dir, name, "information"))
            continue
        if addr is None:
            continue
        vendor, device, numa = _read_pci_attrs(sysfs_root, addr)
        if vendor and vendor != NVIDIA_VENDOR_ID:
            log.debug("skipping non-NVIDIA function %s (vendor 0x%x)",
                      addr, vendor)
            continue
        chips.append(GPUChip(
            index=minor,
            pci_address=addr,
            dev_path=os.path.join(dev_root, f"nvidia{minor}"),
            vendor_id=vendor or NVIDIA_VENDOR_ID,
            device_id=device,
            numa_node=numa,
            extra_dev_paths=extra,
            uuid=info.get("GPU UUID", ""),
            model=info.get("Model", ""),
        ))
    return sorted(chips, key=lambda c: c.index)


def get_gpu_chips(
    sysfs_root: str = "/sys",
    dev_root: str = "/dev",
    proc_root: str = "/proc",
) -> Dict[str, GPUChip]:
    """Enumerate NVIDIA GPUs, keyed by PCI address (``GPUChip.key``).

    Raises DiscoveryError if nothing is found and fatal_on_driver_unavailable
    is set — the DaemonSet analogue of the reference's glog.Fatalf
    driver-missing exit (amdgpu.go:159).
    """
    chips = _discover_native(sysfs_root, dev_root)
    if chips is None:
        chips = _discover_procfs(sysfs_root, dev_root, proc_root)
    if not chips:
        msg = (f"no NVIDIA GPUs found (NVML or "
               f"{os.path.join(proc_root, 'driver', 'nvidia', 'gpus')})")
        if _FATAL_ON_DRIVER_UNAVAILABLE:
            raise DiscoveryError(msg)
        log.warning("%s", msg)
        return {}
    # Topology positions are dense ranks over the discovered GPUs, not
    # raw minors — a numbering gap must not leave an index past the end.
    for rank, chip in enumerate(sorted(chips, key=lambda c: c.index)):
        chip.mesh_index = rank
        if chip.generation == "unknown":
            chip.generation = generation_for(chip.device_id, chip.model)
    return {c.key: c for c in chips}


def _discover_native(sysfs_root: str, dev_root: str) -> Optional[List[GPUChip]]:
    """GPU enumeration through NVML; None -> the procfs walk.

    The native path mirrors the reference's libtpuinfo-first order; the
    procfs walk remains the degradation path when the driver's library is
    absent, exactly as the reference degrades without its shim.
    """
    try:
        # Chaos hook: the native reader failing is an OSError here —
        # the same degradation as a missing library.
        faults.inject("discovery.native_enumerate", sysfs_root=sysfs_root)
        from k8s_device_plugin_tpu_torch.native import binding
    except Exception as e:
        log.debug("native enumeration unavailable (%s); using procfs walk", e)
        return None
    records = binding.enumerate_chips(sysfs_root, dev_root)
    if records is None:
        return None
    extra = _control_nodes(dev_root)
    chips = [
        GPUChip(
            index=r["index"],
            pci_address=r["pci_address"],
            dev_path=r["dev_path"],
            vendor_id=r["vendor_id"] or NVIDIA_VENDOR_ID,
            device_id=r["device_id"],
            numa_node=r["numa_node"],
            extra_dev_paths=extra,
            uuid=r["uuid"],
            model=r["model"],
            nvlinks=tuple(r["nvlinks"]),
        )
        for r in records
    ]
    return sorted(chips, key=lambda c: c.index) or None


def generation_for(device_id: int, model: str = "") -> str:
    """GPU generation from the PCI device id, else from the model name
    (where the PCI ids are unknown); "unknown" outside both tables (the
    reference's family-table-with-unknown-default, amdgpu.go:86-101)."""
    for lo, hi, gen in DEVICE_ID_RANGES:
        if lo <= device_id <= hi:
            return gen
    for part, gen in MODEL_GENERATIONS:
        if part in model:
            return gen
    return "unknown"


def is_homogeneous(chips: Dict[str, GPUChip]) -> bool:
    """All GPUs the same silicon (IsHomogeneous, amdgpu.go:298-304)."""
    ids = {(c.vendor_id, c.device_id, c.generation) for c in chips.values()}
    return len(ids) <= 1


def dev_functional(chip: GPUChip) -> bool:
    """Health probe: the device node exists and is openable.

    Analogue of the reference's openAMDGPU/DevFunctional libdrm open probe
    (amdgpu.go:358-399). On fixture trees the node is a regular file; on a
    real host it is a char device we open non-blocking and close.
    """
    try:
        st = os.stat(chip.dev_path)
    except OSError:
        return False
    if not stat_mod.S_ISCHR(st.st_mode):
        return True  # fixture file: presence is the probe
    try:
        fd = os.open(chip.dev_path, os.O_RDONLY | os.O_NONBLOCK)
        os.close(fd)
        return True
    except OSError as e:
        log.warning("device open probe failed for %s: %s", chip.dev_path, e)
        return False


def generation_name(chip: GPUChip) -> str:
    """Generation string for a GPU (GetCardFamilyName analogue)."""
    return chip.generation


def product_name(chip: GPUChip) -> str:
    """Marketing name (GetCardProductName analogue): the driver's model
    string where discovery read one."""
    if chip.model:
        return chip.model
    return PRODUCT_NAMES.get(
        chip.generation, f"NVIDIA GPU (device 0x{chip.device_id:04x})")
