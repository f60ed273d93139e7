"""GPU discovery and topology of the port (k8s_device_plugin_tpu_torch
discovery/, native/binding.py) on fixture trees built here.

Four layouts: the H100 host chip_smoke.py runs on, as probed there (a
container runtime that virtualises the GPU: /dev/nvidia0 and
/dev/nvidia6, no /proc/driver/nvidia/gpus, no /sys/bus/pci, NVML
without PCI info, 18 NVLinks to switches); an HGX H100
board (8 GPUs, every pair NVLink through NVSwitch, two NUMA nodes of
four, GPUs in pairs under PCIe switches); two PCIe H100s joined by an
NVLink bridge beside two without; and an empty tree. NVML is a stub with
the library's calling convention (ctypes byref arguments, status codes),
so the binding's own code runs; without it, discovery walks procfs.

The builders (``make_gpu_tree``, ``FakeNVML``, the layouts) are shared
with tests/test_torch_gpu_allocator.py and tests/test_torch_device_plugin.py.
"""

import os

import pytest

from k8s_device_plugin_tpu.discovery import chips as ref_chips
from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod
from k8s_device_plugin_tpu_torch.discovery import topology as topo_mod
from k8s_device_plugin_tpu_torch.native import binding

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "testdata")

H100_SXM = 0x2330
H100_PCIE = 0x2331
SXM_MODEL = "NVIDIA H100 80GB HBM3"
PCIE_MODEL = "NVIDIA H100 PCIe"
CARD_UUID = "GPU-116bbece-78ef-61de-2d88-3ae2892ec442"


def gpu(minor, bdf, numa, uuid=None, device_id=H100_SXM, model=SXM_MODEL,
        upstream=(), nvlinks=()):
    """One GPU of a fixture tree: its device minor, PCI address, NUMA node,
    the PCI functions above it (root port first) and its NVLink far ends."""
    return {"minor": minor, "bdf": bdf, "numa": numa,
            "uuid": uuid or f"GPU-{minor:08x}-1111-2222-3333-"
                            f"{int(bdf[5:7], 16):012x}",
            "device_id": device_id, "model": model,
            "upstream": tuple(upstream), "nvlinks": tuple(nvlinks)}


def hgx_gpus():
    """DGX/HGX H100: GPUs 0-3 on NUMA 0, 4-7 on NUMA 1, two GPUs under
    each PCIe switch, every GPU's 18 NVLinks on the four NVSwitches."""
    bdfs = ["0000:1b:00.0", "0000:43:00.0", "0000:52:00.0", "0000:61:00.0",
            "0000:9d:00.0", "0000:c3:00.0", "0000:d1:00.0", "0000:df:00.0"]
    switches = [f"0000:{b:02x}:00.0" for b in (5, 6, 7, 8)]
    out = []
    for i, bdf in enumerate(bdfs):
        pair = i // 2  # root port, then the switch's upstream port
        upstream = (f"0000:{0x10 + 0x20 * pair:02x}:01.0",
                    f"0000:{0x11 + 0x20 * pair:02x}:00.0")
        out.append(gpu(i, bdf, i // 4, upstream=upstream,
                       nvlinks=[switches[k % 4] for k in range(18)]))
    return out


def pcie_bridged_gpus():
    """Four H100 PCIe: 0 and 1 joined by an NVLink bridge (12 links),
    2 and 3 under one PCIe switch without a bridge; all NUMA 0."""
    a, b, c, d = "0000:17:00.0", "0000:31:00.0", "0000:b1:00.0", "0000:b2:00.0"
    return [
        gpu(0, a, 0, device_id=H100_PCIE, model=PCIE_MODEL,
            upstream=("0000:16:01.0",), nvlinks=[b] * 12),
        gpu(1, b, 0, device_id=H100_PCIE, model=PCIE_MODEL,
            upstream=("0000:30:01.0",), nvlinks=[a] * 12),
        gpu(2, c, 0, device_id=H100_PCIE, model=PCIE_MODEL,
            upstream=("0000:b0:01.0", "0000:b0:02.0")),
        gpu(3, d, 0, device_id=H100_PCIE, model=PCIE_MODEL,
            upstream=("0000:b0:01.0", "0000:b0:03.0")),
    ]


def four_gpus():
    """The shape of testdata/tpu-v5e-4: four GPUs, NUMA 0, 0, 1, 1."""
    return [gpu(i, f"0000:{0x1b + 0x10 * i:02x}:00.0", i // 2,
                upstream=(f"0000:{0x1a + 0x10 * i:02x}:01.0",))
            for i in range(4)]


def make_gpu_tree(root, gpus, procfs=True, pci=True, control=True,
                  extra_dev=()):
    """A host tree under ``root``: sys/, dev/, proc/. Returns the roots
    (sysfs, dev, proc)."""
    sys_root, dev_root, proc_root = (os.path.join(root, d)
                                     for d in ("sys", "dev", "proc"))
    os.makedirs(os.path.join(sys_root, "bus", "pci", "devices"))
    os.makedirs(dev_root)
    drv = os.path.join(proc_root, "driver", "nvidia")
    os.makedirs(drv)
    if procfs:
        with open(os.path.join(drv, "version"), "w") as f:
            f.write("NVRM version: NVIDIA UNIX x86_64 Kernel Module  "
                    "580.159.03  Release Build\nGCC version:  gcc 13.3.0\n")
    for g in gpus:
        if procfs:
            d = os.path.join(drv, "gpus", g["bdf"])
            os.makedirs(d)
            with open(os.path.join(d, "information"), "w") as f:
                f.write(f"Model: \t\t {g['model']}\nIRQ:   \t\t 0\n"
                        f"GPU UUID: \t {g['uuid']}\nVideo BIOS: \t "
                        f"96.00.99.00.01\nBus Type: \t PCIe\nDMA Size: \t "
                        f"52 bits\nDMA Mask: \t 0xfffffffffffff\nBus "
                        f"Location: \t {g['bdf']}\nDevice Minor: \t "
                        f"{g['minor']}\nGPU Excluded:\t No\n")
        if pci:
            real = os.path.join(sys_root, "devices", "pci0000:00",
                                *g["upstream"], g["bdf"])
            os.makedirs(real)
            for name, value in (("vendor", "0x10de"),
                                ("device", f"0x{g['device_id']:04x}"),
                                ("numa_node", str(g["numa"]))):
                with open(os.path.join(real, name), "w") as f:
                    f.write(value + "\n")
            os.symlink(os.path.relpath(real, os.path.join(
                sys_root, "bus", "pci", "devices")),
                os.path.join(sys_root, "bus", "pci", "devices", g["bdf"]))
        open(os.path.join(dev_root, f"nvidia{g['minor']}"), "w").close()
    names = list(extra_dev)
    if control:
        names += list(chips_mod.CONTROL_NODES)
    for name in names:
        open(os.path.join(dev_root, name), "w").close()
    return sys_root, dev_root, proc_root


def live_fields(g):
    """A GPU's live state as the fake NVML reports it: 80 GB HBM3
    (81559 MiB, what nvidia-smi shows for an H100 SXM), distinct values
    per minor, a PCIe 5 x16 link."""
    m = g["minor"]
    return {"memory_total": 81559 << 20, "memory_used": (m + 1) << 30,
            "util_gpu": 10 * m + 5, "util_memory": 2 * m + 1,
            "temp_c": 30 + m, "pcie_gen": 5, "pcie_width": 16}


class FakeNVML:
    """libnvidia-ml's calling convention over a list of GPUs: handles are
    1-based indices, outputs go through ctypes byref / string buffers,
    every call returns an NVML status. ``pci=False`` answers PCI info
    NOT_SUPPORTED (3), as the H100 host's virtualising runtime does.

    The exporter's queries read ``live`` (uuid -> ``live_fields``, which
    a test may change); ``refuse`` names the functions answered
    NOT_SUPPORTED, ``lacks`` those the library does not have."""

    NOT_SUPPORTED = 3
    INVALID_ARGUMENT = 2
    NOT_FOUND = 6

    def __init__(self, gpus, pci=True, driver="580.159.03", refuse=(),
                 lacks=()):
        self.gpus = list(gpus)
        self.pci = pci
        self.driver = driver
        self.calls = 0
        self.live = {g["uuid"]: live_fields(g) for g in self.gpus}
        self.refuse = set(refuse)
        for name in lacks:
            setattr(self, name, None)  # getattr(lib, name, None) is None

    def _gpu(self, handle):
        self.calls += 1
        return self.gpus[handle.value - 1]

    @staticmethod
    def _bus_id(bdf):  # nvidia-smi's form: 00000000:1B:00.0
        dom, rest = bdf.split(":", 1)
        return f"{int(dom, 16):08X}:{rest.upper()}".encode()

    def nvmlSystemGetDriverVersion(self, buf, n):
        buf.value = self.driver.encode()
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.gpus)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = i + 1
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, n):
        buf.value = self._gpu(handle)["uuid"].encode()
        return 0

    def nvmlDeviceGetName(self, handle, buf, n):
        buf.value = self._gpu(handle)["model"].encode()
        return 0

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        minor._obj.value = self._gpu(handle)["minor"]
        return 0

    def nvmlDeviceGetPciInfo_v3(self, handle, pci):
        g = self._gpu(handle)
        if not self.pci:
            return self.NOT_SUPPORTED
        pci._obj.busId = self._bus_id(g["bdf"])
        pci._obj.pciDeviceId = (g["device_id"] << 16) | 0x10DE
        return 0

    def nvmlDeviceGetNvLinkState(self, handle, link, state):
        g = self._gpu(handle)
        if link >= 18:
            return self.INVALID_ARGUMENT
        if not g["nvlinks"]:
            return self.NOT_SUPPORTED
        state._obj.value = 1 if link < len(g["nvlinks"]) else 0
        return 0

    def nvmlDeviceGetNvLinkRemotePciInfo_v2(self, handle, link, pci):
        g = self._gpu(handle)
        if link >= len(g["nvlinks"]):
            return self.INVALID_ARGUMENT
        pci._obj.busId = self._bus_id(g["nvlinks"][link])
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, handle):
        for i, g in enumerate(self.gpus):
            if g["uuid"].encode() == uuid:
                handle._obj.value = i + 1
                return 0
        return self.NOT_FOUND

    def _live(self, name, handle):
        """The GPU's live fields, or None where ``name`` is refused."""
        g = self._gpu(handle)
        return None if name in self.refuse else self.live[g["uuid"]]

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        v = self._live("nvmlDeviceGetMemoryInfo", handle)
        if v is None:
            return self.NOT_SUPPORTED
        mem._obj.total = v["memory_total"]
        mem._obj.used = v["memory_used"]
        mem._obj.free = v["memory_total"] - v["memory_used"]
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        v = self._live("nvmlDeviceGetUtilizationRates", handle)
        if v is None:
            return self.NOT_SUPPORTED
        util._obj.gpu, util._obj.memory = v["util_gpu"], v["util_memory"]
        return 0

    def nvmlDeviceGetTemperature(self, handle, sensor, temp):
        v = self._live("nvmlDeviceGetTemperature", handle)
        if v is None or sensor != 0:
            return self.NOT_SUPPORTED
        temp._obj.value = v["temp_c"]
        return 0

    def nvmlDeviceGetCurrPcieLinkGeneration(self, handle, gen):
        v = self._live("nvmlDeviceGetCurrPcieLinkGeneration", handle)
        if v is None:
            return self.NOT_SUPPORTED
        gen._obj.value = v["pcie_gen"]
        return 0

    def nvmlDeviceGetCurrPcieLinkWidth(self, handle, width):
        v = self._live("nvmlDeviceGetCurrPcieLinkWidth", handle)
        if v is None:
            return self.NOT_SUPPORTED
        width._obj.value = v["pcie_width"]
        return 0


def use_nvml(monkeypatch, lib):
    """Route the binding to ``lib`` (None: NVML unavailable)."""
    monkeypatch.setattr(binding, "_lib", lib)
    monkeypatch.setattr(binding, "_load_attempted", True)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    """No test reads the host's NVML, and discovery never raises."""
    use_nvml(monkeypatch, None)
    chips_mod.fatal_on_driver_unavailable(False)
    yield
    chips_mod.fatal_on_driver_unavailable(True)


def discover(roots):
    return chips_mod.get_gpu_chips(*roots)


def _identity(chip):
    """The fields both discovery paths report."""
    return (chip.index, chip.pci_address, chip.dev_path, chip.mesh_index,
            chip.vendor_id, chip.device_id, chip.numa_node, chip.generation,
            chip.extra_dev_paths, chip.uuid, chip.model)


# -- procfs / sysfs walk ------------------------------------------------------


def test_procfs_walk_reads_every_field(tmp_path):
    gpus = four_gpus()
    roots = make_gpu_tree(str(tmp_path), gpus)
    chips = discover(roots)
    assert list(chips) == [g["bdf"] for g in gpus]
    for rank, (g, c) in enumerate(zip(gpus, chips.values())):
        assert c.index == g["minor"] and c.mesh_index == rank
        assert c.dev_path == os.path.join(roots[1], f"nvidia{g['minor']}")
        assert (c.vendor_id, c.device_id, c.numa_node) == \
            (0x10DE, H100_SXM, g["numa"])
        assert (c.uuid, c.model, c.generation) == \
            (g["uuid"], SXM_MODEL, "hopper")
        assert c.extra_dev_paths == tuple(
            os.path.join(roots[1], n) for n in chips_mod.CONTROL_NODES)
        assert c.device_spec_paths[0] == c.dev_path
        assert c.nvlinks == ()
        assert chips_mod.product_name(c) == SXM_MODEL


def test_minor_gaps_get_dense_mesh_indices(tmp_path):
    """nvidia0, nvidia2, nvidia3: mesh indices 0, 1, 2 (the reference's
    accel-gap rule)."""
    gpus = [g for g in four_gpus() if g["minor"] != 1]
    chips = discover(make_gpu_tree(str(tmp_path), gpus))
    assert [(c.index, c.mesh_index) for c in chips.values()] == \
        [(0, 0), (2, 1), (3, 2)]


def test_control_nodes_only_where_present(tmp_path):
    roots = make_gpu_tree(str(tmp_path), four_gpus()[:1], control=False,
                          extra_dev=("nvidiactl",))
    (chip,) = discover(roots).values()
    assert chip.extra_dev_paths == (os.path.join(roots[1], "nvidiactl"),)
    assert chip.device_spec_paths == [chip.dev_path, chip.extra_dev_paths[0]]


def test_non_nvidia_function_is_skipped(tmp_path):
    gpus = four_gpus()[:2]
    roots = make_gpu_tree(str(tmp_path), gpus)
    with open(os.path.join(roots[0], "bus", "pci", "devices",
                           gpus[1]["bdf"], "vendor"), "w") as f:
        f.write("0x8086\n")
    assert list(discover(roots)) == [gpus[0]["bdf"]]


def test_missing_sysfs_leaves_numa_and_ids_unknown(tmp_path):
    """procfs alone (no /sys/bus/pci): the GPU is found, its NUMA node and
    device id unknown, the model still names its generation."""
    roots = make_gpu_tree(str(tmp_path), four_gpus()[:1], pci=False)
    (chip,) = discover(roots).values()
    assert (chip.numa_node, chip.device_id, chip.generation) == \
        (-1, 0, "hopper")


@pytest.mark.parametrize("text,want", [
    ("00000000:1B:00.0", "0000:1b:00.0"),
    ("0000:1b:00.0", "0000:1b:00.0"),
    ("1b:00.0", "0000:1b:00.0"),
    ("00000001:C3:1F.7", "0001:c3:1f.7"),
    ("[N/A]", None),
    ("", None),
])
def test_pci_address_normalisation(text, want):
    assert binding.normalize_pci_address(text) == want


# -- empty trees --------------------------------------------------------------


def test_empty_tree_gives_no_chips(tmp_path):
    assert discover(make_gpu_tree(str(tmp_path), [], procfs=False,
                                  control=False)) == {}


def test_empty_tree_raises_when_fatal(tmp_path):
    """As the reference on testdata/tpu-none (tests/test_discovery.py:99-103)."""
    roots = make_gpu_tree(str(tmp_path), [], procfs=False, control=False)
    chips_mod.fatal_on_driver_unavailable(True)
    with pytest.raises(chips_mod.DiscoveryError):
        discover(roots)
    ref_chips.fatal_on_driver_unavailable(True)
    try:
        with pytest.raises(ref_chips.DiscoveryError):
            ref_chips.get_tpu_chips(
                os.path.join(TESTDATA, "tpu-none", "sys"),
                os.path.join(TESTDATA, "tpu-none", "dev"),
                tpu_env_path=os.path.join(TESTDATA, "tpu-none", "tpu-env"))
    finally:
        ref_chips.fatal_on_driver_unavailable(False)


# -- dev_functional -----------------------------------------------------------


def test_dev_functional_rules(tmp_path):
    roots = make_gpu_tree(str(tmp_path), four_gpus()[:2])
    a, b = discover(roots).values()
    assert chips_mod.dev_functional(a)  # a fixture file counts as present
    os.remove(b.dev_path)
    assert not chips_mod.dev_functional(b)
    # a real character device is opened non-blocking and closed
    null = chips_mod.GPUChip(index=9, pci_address="", dev_path="/dev/null")
    assert chips_mod.dev_functional(null)


def test_dev_functional_matches_the_reference(tmp_path):
    """Same rule as the reference's probe on every kind of path."""
    present = tmp_path / "present"
    present.write_text("")
    for path in (str(present), str(tmp_path / "absent"), "/dev/null"):
        ours = chips_mod.GPUChip(index=0, pci_address="", dev_path=path)
        theirs = ref_chips.TPUChip(index=0, pci_address="", dev_path=path,
                                   iface="accel")
        assert chips_mod.dev_functional(ours) == \
            ref_chips.dev_functional(theirs)


# -- NVML ---------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["four", "hgx", "pcie_bridged"])
def test_nvml_path_equals_procfs_path(tmp_path, monkeypatch, layout):
    gpus = {"four": four_gpus, "hgx": hgx_gpus,
            "pcie_bridged": pcie_bridged_gpus}[layout]()
    roots = make_gpu_tree(str(tmp_path), gpus)
    walked = discover(roots)
    fake = FakeNVML(gpus)
    use_nvml(monkeypatch, fake)
    native = discover(roots)
    assert fake.calls > 0, "the NVML path did not run"
    assert [_identity(c) for c in native.values()] == \
        [_identity(c) for c in walked.values()]
    assert [c.nvlinks for c in native.values()] == \
        [g["nvlinks"] for g in gpus]


def test_nvml_wins_over_procfs(tmp_path, monkeypatch):
    """NVML goes first, as the reference's native enumeration does."""
    roots = make_gpu_tree(str(tmp_path), four_gpus())
    use_nvml(monkeypatch, FakeNVML(four_gpus()[:1]))
    assert len(discover(roots)) == 1


def test_card_layout(tmp_path, monkeypatch):
    """The H100 host chip_smoke.py runs on, as probed: NVML lists one H100
    (minor 6) and answers its PCI info NOT_SUPPORTED; /dev also holds an
    unrelated nvidia0; no procfs GPU directory, no PCI functions in sysfs.
    The GPU is found with its UUID as the device id, its NUMA node
    unknown, its 18 NVLinks ending on switches."""
    card = gpu(6, "0000:cb:00.0", -1, uuid=CARD_UUID,
               nvlinks=[f"0000:{b:02x}:00.0" for b in (6, 7, 8, 9)
                        for _ in range(5)][:18])
    roots = make_gpu_tree(str(tmp_path), [card], procfs=False, pci=False,
                          extra_dev=("nvidia0",))
    assert discover(roots) == {}
    use_nvml(monkeypatch, FakeNVML([card], pci=False))
    (key, chip), = discover(roots).items()
    assert key == CARD_UUID == chip.key and chip.pci_address == ""
    assert chip.dev_path == os.path.join(roots[1], "nvidia6")
    assert (chip.index, chip.mesh_index, chip.numa_node) == (6, 0, -1)
    assert (chip.generation, chip.model) == ("hopper", SXM_MODEL)
    assert len(chip.nvlinks) == 18
    assert chips_mod.dev_functional(chip)
    topo = topo_mod.gpu_topology([chip], roots[0])
    assert topo.num_gpus == 1 and topo.cliques == ((0,),)


def test_binding_version(monkeypatch):
    assert binding.version() is None
    use_nvml(monkeypatch, FakeNVML([]))
    assert binding.version() == "580.159.03"
    assert binding.available()


# -- topology -----------------------------------------------------------------


def _topology(tmp_path, monkeypatch, gpus, nvml=True):
    roots = make_gpu_tree(str(tmp_path), gpus)
    if nvml:
        use_nvml(monkeypatch, FakeNVML(gpus))
    chips = discover(roots)
    return topo_mod.gpu_topology(list(chips.values()), roots[0])


def test_hgx_topology(tmp_path, monkeypatch):
    topo = _topology(tmp_path, monkeypatch, hgx_gpus())
    assert topo.num_gpus == 8 and topo.numa == (0,) * 4 + (1,) * 4
    assert topo.cliques == (tuple(range(8)),)
    assert all(topo.link(a, b) == topo_mod.NVLINK and
               topo.nvlink_hops(a, b) == 1
               for a in range(8) for b in range(8) if a != b)
    # GPUs 2k and 2k+1 share a PCIe switch
    assert topo.pcie_switch == frozenset((2 * k, 2 * k + 1) for k in range(4))
    assert topo.is_clique(range(8)) and topo.largest_free_clique([1, 5]) == 2


def test_hgx_without_nvml_sees_only_pcie_and_numa(tmp_path, monkeypatch):
    topo = _topology(tmp_path, monkeypatch, hgx_gpus(), nvml=False)
    assert topo.nvlink == frozenset()
    assert topo.cliques == tuple((i,) for i in range(8))
    assert topo.link(0, 1) == topo_mod.PCIE_SWITCH
    assert topo.link(0, 2) == topo_mod.SAME_NUMA
    assert topo.link(0, 4) == topo_mod.OTHER


def test_pcie_bridged_topology(tmp_path, monkeypatch):
    topo = _topology(tmp_path, monkeypatch, pcie_bridged_gpus())
    assert topo.nvlink == frozenset({(0, 1)})
    assert topo.cliques == ((0, 1), (2,), (3,))
    assert topo.link(0, 1) == topo_mod.NVLINK
    assert topo.link(2, 3) == topo_mod.PCIE_SWITCH
    assert topo.link(0, 2) == topo_mod.SAME_NUMA
    assert topo.nvlink_hops(0, 2) is None
    assert topo.is_clique([0, 1]) and not topo.is_clique([1, 2])


def test_four_gpu_topology(tmp_path, monkeypatch):
    topo = _topology(tmp_path, monkeypatch, four_gpus(), nvml=False)
    assert topo.cliques == ((0,), (1,), (2,), (3,))
    assert [topo.link(0, b) for b in (1, 2, 3)] == \
        [topo_mod.SAME_NUMA, topo_mod.OTHER, topo_mod.OTHER]


def test_nvlink_chain_hops():
    """A chain 0-1-2-3 of bridges: hops along it, cliques its edges."""
    topo = topo_mod.GPUTopology(4, nvlink=frozenset({(0, 1), (1, 2), (2, 3)}))
    assert [topo.nvlink_hops(0, b) for b in range(4)] == [0, 1, 2, 3]
    assert topo.cliques == ((0, 1), (1, 2), (2, 3))
    assert topo.largest_free_clique([0, 2]) == 1
    with pytest.raises(IndexError):
        topo.link(0, 4)
    with pytest.raises(ValueError):
        topo_mod.GPUTopology(2, nvlink=frozenset({(0, 2)}))
