"""Small sysfs reading helpers shared by discovery and the labeller.

Every consumer takes an injectable root directory so unit tests can point at
captured fixture trees under ``testdata/`` instead of the live ``/sys`` —
the same pattern the reference uses throughout (optional root-dir parameters
on every discovery function, e.g. GetDevIdsFromTopology in
internal/pkg/amdgpu/amdgpu.go:103-107).
"""

from __future__ import annotations

import os
from typing import Optional

from k8s_device_plugin_tpu_torch.utils import faults


def read_str(path: str) -> Optional[str]:
    """Read a one-line sysfs attribute, stripped; None when absent/unreadable."""
    try:
        # Inside the OSError envelope on purpose: an armed
        # ``discovery.sysfs_read=error:OSError`` plan exercises the same
        # degrade-to-None path a flaky kernel attribute produces, while
        # any other injected type escapes loudly.
        faults.inject("discovery.sysfs_read", path=path)
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.read().strip()
    except OSError:
        return None


def read_int(path: str, base: int = 10) -> Optional[int]:
    s = read_str(path)
    if s is None or s == "":
        return None
    try:
        return int(s, base)
    except ValueError:
        return None


def read_hex(path: str) -> Optional[int]:
    """Read a sysfs hex attribute like ``0x1ae0`` (always base 16)."""
    s = read_str(path)
    if s is None or s == "":
        return None
    try:
        return int(s, 16)
    except ValueError:
        return None


def list_dir(path: str) -> list:
    try:
        faults.inject("discovery.sysfs_read", path=path)
        return sorted(os.listdir(path))
    except OSError:
        return []
