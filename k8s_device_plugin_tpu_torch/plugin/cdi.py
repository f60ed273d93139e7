"""CDI (Container Device Interface) spec generation.

A beyond-the-reference capability: modern container runtimes prefer CDI
device injection over raw DeviceSpecs, and the kubelet passes
``cdi_devices`` from AllocateResponse straight through (api.proto
CDIDevice). When enabled, the plugin writes a CDI spec describing every
GPU (device nodes + per-device container edits) to the standard
CDI dir and returns fully-qualified CDI names alongside the classic
DeviceSpecs — runtimes that understand CDI use the names, older ones fall
back to the mounts.

Spec format: https://github.com/cncf-tags/container-device-interface
(version 0.6.0 JSON).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.dpm.checkpoint import atomic_write_json

log = logging.getLogger(__name__)

CDI_SPEC_DIR = "/var/run/cdi"
CDI_KIND = f"{constants.RESOURCE_NAMESPACE}/{constants.RESOURCE_GPU}"


def device_cdi_name(device_id: str) -> str:
    """Fully-qualified CDI device name for a kubelet device id."""
    return f"{CDI_KIND}={_cdi_safe(device_id)}"


def _cdi_safe(device_id: str) -> str:
    # CDI device names allow [A-Za-z0-9_.:-]; PCI addresses and GPU
    # UUIDs qualify as-is.
    return "".join(c if c.isalnum() or c in "_.:-" else "-" for c in device_id)


def build_spec(devices: Dict[str, Iterable[str]]) -> dict:
    """CDI spec dict from device id -> host device-node paths.

    Two invariants:
      - No env edits. The visibility env is scoped to the *allocation
        set* (CUDA_VISIBLE_DEVICES lists every allocated GPU) and comes
        from the AllocateResponse; per-device CDI env edits would clobber
        each other on multi-device allocations.
      - Device nodes shared by several devices (/dev/nvidiactl and the
        unified-memory nodes) go into the spec-level containerEdits, applied once per
        container — per-device listing would duplicate OCI device entries,
        the condition the classic Allocate path dedupes.
    """
    path_owners: Dict[str, int] = {}
    for paths in devices.values():
        for p in paths:
            path_owners[p] = path_owners.get(p, 0) + 1
    shared = {p for p, n in path_owners.items() if n > 1}

    cdi_devices: List[dict] = []
    for device_id, paths in sorted(devices.items()):
        own = [p for p in paths if p not in shared]
        cdi_devices.append(
            {
                "name": _cdi_safe(device_id),
                "containerEdits": {
                    "deviceNodes": [
                        {"path": p, "permissions": "rw"} for p in own
                    ],
                },
            }
        )
    spec = {
        "cdiVersion": "0.6.0",
        "kind": CDI_KIND,
        "devices": cdi_devices,
    }
    if shared:
        spec["containerEdits"] = {
            "deviceNodes": [
                {"path": p, "permissions": "rw"} for p in sorted(shared)
            ],
        }
    return spec


def cleanup_stale_specs(spec_dir: str, keep_resources: Iterable[str]) -> None:
    """Remove our spec files for resources no longer advertised.

    A strategy/layout change renames the per-resource spec files; stale
    ones would keep old device names live in the runtime's CDI cache (and
    can conflict with the fresh specs under the same kind). Called at
    daemon startup, where the full resource list is known — individual
    plugin instances must not delete their siblings' files.
    """
    prefix = f"{constants.RESOURCE_NAMESPACE}-"
    keep = {f"{prefix}{_cdi_safe(r)}.json" for r in keep_resources}
    try:
        entries = os.listdir(spec_dir)
    except OSError:
        return
    for name in entries:
        if name.startswith(prefix) and name.endswith(".json") and name not in keep:
            try:
                os.remove(os.path.join(spec_dir, name))
                log.info("removed stale CDI spec %s", name)
            except OSError as e:
                log.warning("cannot remove stale CDI spec %s: %s", name, e)


def write_spec(spec: dict, spec_dir: str = CDI_SPEC_DIR,
               resource: str = constants.RESOURCE_GPU) -> str:
    """Atomically write the CDI spec; returns its path.

    One file per advertised resource (``nvidia.com-gpu.json``): a later
    strategy serving several resources (MIG) would otherwise be
    last-writer-wins. CDI-aware runtimes merge same-kind specs across
    files, and the per-resource device names are disjoint by
    construction.
    """
    os.makedirs(spec_dir, exist_ok=True)
    path = os.path.join(
        spec_dir,
        f"{constants.RESOURCE_NAMESPACE}-{_cdi_safe(resource)}.json",
    )
    # tmp -> fsync -> rename (dpm/checkpoint.py): a runtime reading a CDI
    # spec mid-crash must see the old spec or the new one, never a torn
    # file (tpulint TPU009 flags writes that skip the helper).
    atomic_write_json(path, spec, indent=2, sort_keys=True)
    log.info("wrote CDI spec with %d devices to %s", len(spec["devices"]), path)
    return path
