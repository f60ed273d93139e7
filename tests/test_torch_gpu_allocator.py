"""The port's BestEffortPolicy against the reference's.

Parity: a ``GPUTopology`` whose NVLink graph is the ICI mesh's neighbour
graph (GPUs bridged to their mesh neighbours) and whose NUMA nodes are
the reference fixtures' gives pair weights equal, pair for pair, to the
reference's ``build_pair_weights`` on ``TPUTopology`` for a 2x2 and a 2x4
host. Over every request on those hosts (each available set, each
allocation size, no or one must-include device) both policies then pick
subsets of the same pair weight. On the 2x2 host they are the same
subsets. On the 2x4 host the two notions of contiguity part: the
reference prefers a gap-free rectangle and the move that leaves the
largest free rectangle, the port an NVLink clique and the move that
leaves the largest free clique. A grid graph has no clique above two
GPUs, so where the reference's rectangle (1x3, 1x4, 2x2) decides among
subsets of equal weight, the port picks by fragmentation and index
instead. Those requests are counted and each one's cause is checked. The
reference's error cases (tests/test_allocator.py:129-150) raise the same
``AllocationError`` messages in both.

The port's own cases run on the fixture layouts of
tests/test_torch_gpu_discovery.py: on an HGX board sizes 2, 4 and 8 stay
inside one NUMA node where they fit, and on two bridged PCIe GPUs beside
two unbridged ones size 2 takes the bridged pair.
"""

import itertools

import pytest

from k8s_device_plugin_tpu.allocator import AllocationError as RefError
from k8s_device_plugin_tpu.allocator import BestEffortPolicy as RefPolicy
from k8s_device_plugin_tpu.allocator import Device as RefDevice
from k8s_device_plugin_tpu.allocator import build_pair_weights as ref_weights
from k8s_device_plugin_tpu.discovery.topology import TPUTopology
from k8s_device_plugin_tpu_torch.allocator import (
    AllocationError,
    BestEffortPolicy,
    Device,
    build_pair_weights,
    devices_from_chips,
)
from k8s_device_plugin_tpu_torch.allocator import besteffort_policy
from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod
from k8s_device_plugin_tpu_torch.discovery.topology import GPUTopology, gpu_topology
from tests.test_torch_gpu_discovery import (
    FakeNVML,
    hgx_gpus,
    make_gpu_tree,
    pcie_bridged_gpus,
    use_nvml,
)

# (mesh shape, NUMA node per chip: the reference fixtures' rows)
HOSTS = {"2x2": ((2, 2), (0, 0, 1, 1)),
         "2x4": ((2, 4), (0, 0, 0, 0, 1, 1, 1, 1))}
# Requests per allocation size on the 2x4 host where the reference's
# rectangle decides among equal-weight subsets (see the module docstring).
MESH_TIE_BREAKS_2X4 = {1: 43, 2: 22, 3: 22, 4: 46}


def _ids(n):
    return [f"dev{i}" for i in range(n)]


def _pair_policies(host):
    shape, numa = HOSTS[host]
    topo = TPUTopology(shape=shape)
    n = topo.num_chips
    ref_devs = [RefDevice(id=f"dev{i}", index=i, numa_node=numa[i],
                          chip_indices=(i,)) for i in range(n)]
    devs = [Device(id=f"dev{i}", index=i, numa_node=numa[i],
                   chip_indices=(i,)) for i in range(n)]
    bridges = {(a, b) for a in range(n) for b in topo.neighbors(a) if a < b}
    gtopo = GPUTopology(n, nvlink=frozenset(bridges), numa=numa)
    ref = RefPolicy(use_native=False)
    ref.init(ref_devs, topo)
    ours = BestEffortPolicy()
    ours.init(devs, gtopo)
    return ref, ours, ref_devs, devs, topo, gtopo


def _requests(n, size):
    """Every (available, must_include) with no or one required device."""
    for k in range(size, n + 1):
        for avail in itertools.combinations(range(n), k):
            yield list(avail), []
            for r in avail:
                yield list(avail), [r]


@pytest.mark.parametrize("host", sorted(HOSTS))
def test_pair_weights_equal_the_references(host):
    _, _, ref_devs, devs, topo, gtopo = _pair_policies(host)
    want = ref_weights(ref_devs, topo)
    assert build_pair_weights(devs, gtopo) == want
    assert len(set(want.values())) >= 3


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_same_subsets_2x2(size):
    ref, ours, *_ = _pair_policies("2x2")
    ids = _ids(4)
    n = 0
    for avail, req in _requests(4, size):
        a, r = [ids[i] for i in avail], [ids[i] for i in req]
        assert ours.allocate(a, r, size) == ref.allocate(a, r, size), \
            (avail, req, size)
        n += 1
    assert n > 0


@pytest.mark.parametrize("size", range(1, 9))
def test_same_weight_and_subsets_but_mesh_tie_breaks_2x4(size):
    ref, ours, *_ = _pair_policies("2x4")
    ids = _ids(8)
    tie_breaks = same = 0
    for avail, req in _requests(8, size):
        a, r = [ids[i] for i in avail], [ids[i] for i in req]
        want, got = ref.allocate(a, r, size), ours.allocate(a, r, size)
        if got == want:
            same += 1
            continue
        tie_breaks += 1
        ref_devs = [ref._by_id[i] for i in a]
        rs_want = ref._score([ref._by_id[i] for i in want], ref_devs)
        rs_got = ref._score([ref._by_id[i] for i in got], ref_devs)
        our_devs = [ours._by_id[i] for i in a]
        os_want = ours._score([ours._by_id[i] for i in want], our_devs)
        os_got = ours._score([ours._by_id[i] for i in got], our_devs)
        # same pair weight; the reference chose on its rectangle terms
        # (contiguity, then free rectangle), the port on its clique terms
        assert rs_want[1] == rs_got[1] == os_want[1] == os_got[1]
        assert (rs_want[0], rs_want[2]) < (rs_got[0], rs_got[2])
        assert os_got < os_want
        # both or neither an NVLink clique: the port's pick is its own
        # fragmentation / index tie-break among equal weights
        assert os_got[0] == os_want[0]
    assert tie_breaks == MESH_TIE_BREAKS_2X4.get(size, 0)
    assert same > tie_breaks


def test_subsets_2x4_kubelet_sequence():
    """Pods of 4, 2, 1 and 1 GPUs arriving on an empty 2x4 host, each
    taking what the policy prefers: both policies fill the host alike
    (a row, then a pair, then single GPUs)."""
    ref, ours, *_ = _pair_policies("2x4")
    free = _ids(8)
    for size in (4, 2, 1, 1):
        want = ref.allocate(free, [], size)
        assert ours.allocate(free, [], size) == want
        free = [i for i in free if i not in want]
    assert len(free) == 0


IDS8 = _ids(8)
ERROR_CASES = [
    # (available, must_include, size, message): the reference's
    # tests/test_allocator.py:129-150 (size, available, must_include,
    # candidate, unknown) on the 2x4 host
    (IDS8, [], 0, besteffort_policy.INVALID_SIZE),
    (IDS8[:2], [], 3, besteffort_policy.INVALID_AVAILABLE),
    (IDS8, IDS8[:3], 2, besteffort_policy.INVALID_REQUIRED),
    (IDS8[:4], [IDS8[7]], 3, besteffort_policy.NO_CANDIDATE_FOUND),
    (IDS8[:6] + ["bogus-id"], [], 2,
     besteffort_policy.NO_CANDIDATE_FOUND + ": unknown ids ['bogus-id']"),
]


@pytest.mark.parametrize("avail,req,size,message", ERROR_CASES)
def test_errors_equal_the_references(avail, req, size, message):
    ref, ours, *_ = _pair_policies("2x4")
    with pytest.raises(RefError) as want:
        ref.allocate(avail, req, size)
    with pytest.raises(AllocationError) as got:
        ours.allocate(avail, req, size)
    assert str(got.value) == str(want.value) == message


def test_init_errors_equal_the_references():
    for policy, error in ((RefPolicy(use_native=False), RefError),
                          (BestEffortPolicy(), AllocationError)):
        with pytest.raises(error) as empty:
            policy.init([], None)
        assert "devices list is empty" in str(empty.value)
    with pytest.raises(AllocationError) as uninit:
        BestEffortPolicy().allocate(["a", "b"], [], 1)
    with pytest.raises(RefError) as ref_uninit:
        RefPolicy(use_native=False).allocate(["a", "b"], [], 1)
    assert str(uninit.value) == str(ref_uninit.value) == \
        besteffort_policy.INVALID_INIT


def test_early_returns():
    _, ours, *_ = _pair_policies("2x4")
    assert ours.allocate(["dev3", "dev1"], [], 2) == ["dev3", "dev1"]
    assert ours.allocate(_ids(8), ["dev6", "dev2"], 2) == ["dev6", "dev2"]


# -- the port's own layouts ----------------------------------------------------


def _layout_policy(tmp_path, monkeypatch, gpus):
    use_nvml(monkeypatch, FakeNVML(gpus))
    roots = make_gpu_tree(str(tmp_path), gpus)
    chips = chips_mod.get_gpu_chips(*roots)
    devices = devices_from_chips(chips.values())
    policy = BestEffortPolicy()
    policy.init(devices, gpu_topology(list(chips.values()), roots[0]))
    return policy, [d.id for d in devices], devices


@pytest.mark.parametrize("size", [2, 4, 8])
def test_hgx_sizes_stay_in_one_numa_node(tmp_path, monkeypatch, size):
    policy, ids, devices = _layout_policy(tmp_path, monkeypatch, hgx_gpus())
    numa = {d.id: d.numa_node for d in devices}
    got = policy.allocate(ids, [], size)
    assert len(got) == size
    if size <= 4:
        assert len({numa[i] for i in got}) == 1
    # with NUMA 0 half taken, the next pod of 4 takes NUMA 1 whole
    if size == 4:
        rest = [i for i in ids if i not in got]
        nxt = policy.allocate(rest, [], 4)
        assert {numa[i] for i in nxt} == {1 - numa[got[0]]}


def test_hgx_pairs_stay_with_the_required_gpus_numa_node(tmp_path, monkeypatch):
    """Every pair is NVLink-linked (NVLink is each pair's closest link,
    so the PCIe switches do not enter): a pair takes the first two GPUs,
    and one that must include GPU 5 takes its NUMA node's first free
    partner."""
    policy, ids, _ = _layout_policy(tmp_path, monkeypatch, hgx_gpus())
    assert policy.allocate(ids, [], 2) == ids[:2]
    assert policy.allocate(ids, [ids[5]], 2) == [ids[4], ids[5]]


def test_pcie_bridged_pair_wins(tmp_path, monkeypatch):
    policy, ids, _ = _layout_policy(tmp_path, monkeypatch,
                                    pcie_bridged_gpus())
    assert policy.allocate(ids, [], 2) == ids[:2]
    # without the bridged pair, the two under one PCIe switch
    assert policy.allocate(ids[1:], [], 2) == ids[2:]
    # with one bridged GPU required, its bridge partner
    assert policy.allocate(ids, [ids[1]], 2) == ids[:2]


def test_pcie_without_nvml_falls_back_to_the_switch(tmp_path, monkeypatch):
    """Without NVML no bridge is seen: the PCIe switch pair wins."""
    roots = make_gpu_tree(str(tmp_path), pcie_bridged_gpus())
    use_nvml(monkeypatch, None)
    chips = chips_mod.get_gpu_chips(*roots)
    devices = devices_from_chips(chips.values())
    policy = BestEffortPolicy()
    policy.init(devices, gpu_topology(list(chips.values()), roots[0]))
    ids = [d.id for d in devices]
    assert policy.allocate(ids, [], 2) == ids[2:]
