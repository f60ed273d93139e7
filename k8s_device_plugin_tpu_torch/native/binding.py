"""ctypes binding for NVML, the NVIDIA driver's management library.

The reference binds its own C++ ``libtpuinfo.so`` and degrades gracefully
when it is absent (every caller falls back to the pure-Python path; the
daemon never hard-requires native code). The port binds the library the
NVIDIA driver installs on every GPU host, ``libnvidia-ml.so.1``, the same
way: nothing is built and no package is needed, and when the library
does not load (no driver, a CPU-only host) ``available()`` is false and
discovery walks ``/proc/driver/nvidia`` and ``/sys`` instead.

NVML describes the host the process runs on: it takes no sysfs or dev
root. ``enumerate_chips`` uses the roots only for what NVML does not
report (the NUMA node from sysfs, the device node under the dev root).

``sample`` reads one GPU's memory, utilisation, temperature and PCIe
link for the metrics exporter. Its queries are optional: a driver
whose library lacks one still enumerates, and the field reads None.
"""

from __future__ import annotations

import ctypes
import logging
import os
import re
from typing import List, Optional

from k8s_device_plugin_tpu_torch.utils import sysfs

log = logging.getLogger(__name__)

NVML_LIBRARY = "libnvidia-ml.so.1"  # what the driver installs
NVML_SUCCESS = 0
# NVML_NVLINK_MAX_LINKS in nvml.h (18 on Hopper); links past a GPU's own
# count answer NVML_ERROR_INVALID_ARGUMENT or NOT_SUPPORTED.
NVLINK_MAX_LINKS = 18
_UUID_LEN = 96       # NVML_DEVICE_UUID_V2_BUFFER_SIZE
_NAME_LEN = 96       # NVML_DEVICE_NAME_V2_BUFFER_SIZE
_VERSION_LEN = 80    # NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE
_NVML_FEATURE_ENABLED = 1
NVML_TEMPERATURE_GPU = 0  # nvmlTemperatureSensors_t: the GPU die

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

_BUS_ID_RE = re.compile(
    r"^(?:([0-9a-fA-F]{1,8}):)?([0-9a-fA-F]{1,2}):([0-9a-fA-F]{1,2})\.([0-7])$"
)


class PciInfo(ctypes.Structure):
    """nvmlPciInfo_t (nvml.h): what nvmlDeviceGetPciInfo_v3 and
    nvmlDeviceGetNvLinkRemotePciInfo_v2 fill."""

    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        # device id in the high 16 bits, vendor id in the low 16
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


class Memory(ctypes.Structure):
    """nvmlMemory_t (nvml.h): what nvmlDeviceGetMemoryInfo fills, bytes."""

    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


class Utilization(ctypes.Structure):
    """nvmlUtilization_t (nvml.h): percent of the last sample period in
    which a kernel ran (``gpu``) and device memory was read or written
    (``memory``)."""

    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


def normalize_pci_address(bus_id: str) -> Optional[str]:
    """``00000000:1B:00.0`` (nvidia-smi, NVML) or ``1b:00.0`` ->
    ``0000:1b:00.0``, the sysfs and procfs form; None when unparseable."""
    m = _BUS_ID_RE.match(bus_id.strip())
    if not m:
        return None
    domain, bus, dev, fn = m.groups()
    return f"{int(domain or '0', 16):04x}:{int(bus, 16):02x}:{int(dev, 16):02x}.{fn}"


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every NVML function the port calls;
    AttributeError when one that discovery needs is missing."""
    handle_p = ctypes.POINTER(ctypes.c_void_p)
    uint_p = ctypes.POINTER(ctypes.c_uint)
    sigs = {
        "nvmlInit_v2": [],
        "nvmlSystemGetDriverVersion": [ctypes.c_char_p, ctypes.c_uint],
        "nvmlDeviceGetCount_v2": [uint_p],
        "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, handle_p],
        "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
        "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
        "nvmlDeviceGetMinorNumber": [ctypes.c_void_p, uint_p],
        "nvmlDeviceGetPciInfo_v3": [ctypes.c_void_p, ctypes.POINTER(PciInfo)],
        "nvmlDeviceGetNvLinkState": [ctypes.c_void_p, ctypes.c_uint, uint_p],
        "nvmlDeviceGetNvLinkRemotePciInfo_v2": [
            ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(PciInfo)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # The queries sample() makes, declared where the library has them: a
    # library without one of them still serves discovery.
    optional = {
        "nvmlDeviceGetHandleByUUID": [ctypes.c_char_p, handle_p],
        "nvmlDeviceGetMemoryInfo": [ctypes.c_void_p, ctypes.POINTER(Memory)],
        "nvmlDeviceGetUtilizationRates": [
            ctypes.c_void_p, ctypes.POINTER(Utilization)],
        "nvmlDeviceGetTemperature": [ctypes.c_void_p, ctypes.c_uint, uint_p],
        "nvmlDeviceGetCurrPcieLinkGeneration": [ctypes.c_void_p, uint_p],
        "nvmlDeviceGetCurrPcieLinkWidth": [ctypes.c_void_p, uint_p],
    }
    for name, argtypes in optional.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = ctypes.CDLL(NVML_LIBRARY)
    except OSError:
        return None
    try:
        _declare(lib)
    except AttributeError:
        log.warning("%s lacks the NVML functions; ignoring it", NVML_LIBRARY)
        return None
    rc = lib.nvmlInit_v2()
    if rc != NVML_SUCCESS:
        log.warning("nvmlInit_v2 failed (%d); NVML unavailable", rc)
        return None
    _lib = lib
    log.info("loaded NVML (driver %s)", version())
    return _lib


def available() -> bool:
    return _load() is not None


def version() -> Optional[str]:
    """The NVIDIA driver's version as NVML reports it; None without NVML."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(_VERSION_LEN)
    if lib.nvmlSystemGetDriverVersion(buf, _VERSION_LEN) != NVML_SUCCESS:
        return None
    return buf.value.decode()


def _nvlinks(lib: ctypes.CDLL, handle: ctypes.c_void_p) -> List[str]:
    """PCI addresses at the far end of the GPU's active NVLinks (a peer
    GPU, or an NVSwitch), one entry per active link."""
    out = []
    for link in range(NVLINK_MAX_LINKS):
        state = ctypes.c_uint()
        if lib.nvmlDeviceGetNvLinkState(handle, link, ctypes.byref(state)) \
                != NVML_SUCCESS or state.value != _NVML_FEATURE_ENABLED:
            continue
        remote = PciInfo()
        if lib.nvmlDeviceGetNvLinkRemotePciInfo_v2(
                handle, link, ctypes.byref(remote)) != NVML_SUCCESS:
            continue
        addr = normalize_pci_address(remote.busId.decode())
        if addr:
            out.append(addr)
    return out


def enumerate_chips(sysfs_root: str, dev_root: str) -> Optional[List[dict]]:
    """GPU enumeration through NVML; None when NVML is unavailable or errs.

    Returns dicts with the same fields the procfs walk produces (plus the
    active NVLinks' far ends) so discovery can use either interchangeably.
    """
    lib = _load()
    if lib is None:
        return None
    count = ctypes.c_uint()
    if lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) != NVML_SUCCESS:
        return None
    out = []
    for i in range(count.value):
        handle = ctypes.c_void_p()
        uuid = ctypes.create_string_buffer(_UUID_LEN)
        name = ctypes.create_string_buffer(_NAME_LEN)
        minor = ctypes.c_uint()
        pci = PciInfo()
        rcs = (
            lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(handle)),
            lib.nvmlDeviceGetUUID(handle, uuid, _UUID_LEN),
            lib.nvmlDeviceGetName(handle, name, _NAME_LEN),
            lib.nvmlDeviceGetMinorNumber(handle, ctypes.byref(minor)),
        )
        if any(rc != NVML_SUCCESS for rc in rcs):
            log.warning("NVML query of GPU %d failed (%s)", i, rcs)
            return None
        # A runtime that virtualises the GPU may answer NOT_SUPPORTED
        # here (nvidia-smi then prints the bus id as [N/A]): the GPU is
        # still there, its PCI address and ids unknown ("", 0).
        addr = ""
        if lib.nvmlDeviceGetPciInfo_v3(handle, ctypes.byref(pci)) \
                == NVML_SUCCESS:
            addr = normalize_pci_address(pci.busId.decode()) or ""
        numa = sysfs.read_int(os.path.join(
            sysfs_root, "bus", "pci", "devices", addr, "numa_node")) \
            if addr else None
        out.append({
            "index": minor.value,
            "pci_address": addr,
            "dev_path": os.path.join(dev_root, f"nvidia{minor.value}"),
            "vendor_id": pci.pciDeviceId & 0xFFFF,
            "device_id": pci.pciDeviceId >> 16,
            "numa_node": -1 if numa is None else numa,
            "uuid": uuid.value.decode(),
            "model": name.value.decode(),
            "nvlinks": _nvlinks(lib, handle),
        })
    return out


# The keys of sample()'s result besides ``errors``.
SAMPLE_FIELDS = ("memory_total", "memory_free", "memory_used", "util_gpu",
                 "util_memory", "temp_c", "pcie_gen", "pcie_width")


def sample(uuid: str) -> Optional[dict]:
    """One GPU's live state by UUID: ``memory_total`` / ``memory_free`` /
    ``memory_used`` (bytes), ``util_gpu`` / ``util_memory`` (percent),
    ``temp_c`` (the die, Celsius), ``pcie_gen`` / ``pcie_width`` (the
    current link). A field NVML refuses (NOT_SUPPORTED, or any other
    error, or a library without the query) is None, and ``errors`` maps
    the NVML function to its status (-1: the library lacks it). None
    without NVML or when no GPU has this UUID."""
    lib = _load()
    if lib is None:
        return None
    by_uuid = getattr(lib, "nvmlDeviceGetHandleByUUID", None)
    if by_uuid is None:
        return None
    handle = ctypes.c_void_p()
    if by_uuid(uuid.encode(), ctypes.byref(handle)) != NVML_SUCCESS:
        return None
    out = dict.fromkeys(SAMPLE_FIELDS)
    errors = {}

    def query(name, *args):
        fn = getattr(lib, name, None)
        rc = -1 if fn is None else fn(handle, *args)
        if rc != NVML_SUCCESS:
            errors[name] = rc
        return rc == NVML_SUCCESS

    mem = Memory()
    if query("nvmlDeviceGetMemoryInfo", ctypes.byref(mem)):
        out.update(memory_total=mem.total, memory_free=mem.free,
                   memory_used=mem.used)
    util = Utilization()
    if query("nvmlDeviceGetUtilizationRates", ctypes.byref(util)):
        out.update(util_gpu=util.gpu, util_memory=util.memory)
    for key, name, args in (
            ("temp_c", "nvmlDeviceGetTemperature", (NVML_TEMPERATURE_GPU,)),
            ("pcie_gen", "nvmlDeviceGetCurrPcieLinkGeneration", ()),
            ("pcie_width", "nvmlDeviceGetCurrPcieLinkWidth", ())):
        value = ctypes.c_uint()
        if query(name, *args, ctypes.byref(value)):
            out[key] = value.value
    out["errors"] = errors
    return out
