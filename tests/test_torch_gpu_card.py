"""The port's GPU discovery on the card's own host (``gpu`` marker;
skipped without a CUDA device). Imports only the port, as the card's
machine has no JAX:

    python -m pytest tests/test_torch_gpu_card.py -m gpu -q

Discovery on the real roots finds the GPUs nvidia-smi lists, with the
same UUIDs and PCI addresses (nvidia-smi's ``00000000:1B:00.0`` and
``[N/A]`` normalised; a host whose NVML hides PCI info shows neither),
and every device node opens. NVML's ``sample`` of each GPU reads the
memory total nvidia-smi prints.
"""

import subprocess

import pytest
import torch

from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod
from k8s_device_plugin_tpu_torch.native import binding

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def smi_gpus():
    """[(uuid, normalised PCI address or None)] as nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,pci.bus_id",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    rows = [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.strip()]
    return [(uuid, binding.normalize_pci_address(bus))
            for _, uuid, bus in rows]


def test_discovery_on_the_real_roots_equals_nvidia_smi(cuda):
    chips = chips_mod.get_gpu_chips()
    got = sorted((c.uuid, c.pci_address or None) for c in chips.values())
    assert got == sorted(smi_gpus())
    assert all(chips_mod.dev_functional(c) for c in chips.values())
    assert len(chips) == len({c.key for c in chips.values()})


def test_nvml_sample_memory_total_equals_nvidia_smi(cuda):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,memory.total",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    rows = [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.strip()]
    assert rows
    for uuid, mib in rows:
        got = binding.sample(uuid)
        assert got is not None, uuid
        # nvidia-smi prints whole MiB
        assert abs(got["memory_total"] - int(mib) * 2**20) < 2**20
