"""The port's metrics exporter (cmd/metrics_exporter.py, exporter/
telemetry.py, exporter/runtime.py, native/binding.py ``sample``) against
the reference's.

The reference's exporter runs on copies of testdata/tpu-v5e-8 and on
its fake libtpu runtime-metrics service (tests/test_telemetry.py); the
port's on eight-GPU trees built by tests/test_torch_gpu_discovery.py
(``make_gpu_tree``) with the ctypes-shaped ``FakeNVML``, whose
exporter queries read ``live_fields``. The gRPC transcripts, the
Prometheus text's families, order and label keys, and the breaker's
state and counters under the same polls and fault plan compare whole;
the values come from the fakes. Then the readers' own cases, the unified
endpoint, the watchdog loop, and the command line.
"""

import contextlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import astuple

import grpc
import pytest

from k8s_device_plugin_tpu.api.metricssvc import metricssvc_grpc, metricssvc_pb2
from k8s_device_plugin_tpu.cmd import metrics_exporter as ref_exp
from k8s_device_plugin_tpu.discovery import chips as ref_chips
from k8s_device_plugin_tpu.exporter import runtime as ref_rt
from k8s_device_plugin_tpu.exporter import telemetry as ref_telemetry
from k8s_device_plugin_tpu.obs import metrics as ref_metrics
from k8s_device_plugin_tpu.utils import faults as ref_faults
from k8s_device_plugin_tpu_torch.cmd import metrics_exporter as exp
from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod
from k8s_device_plugin_tpu_torch.exporter import runtime as rt
from k8s_device_plugin_tpu_torch.exporter import telemetry
from k8s_device_plugin_tpu_torch.exporter.health import DEFAULT_HEALTH_SOCKET
from k8s_device_plugin_tpu_torch.native import binding
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import faults
from k8s_device_plugin_tpu_torch.utils import watchdog
from tests.test_telemetry import FakeRuntimeMetricService, _serve_fake_runtime
from tests.test_torch_gpu_discovery import (
    CARD_UUID, FakeNVML, four_gpus, gpu, hgx_gpus, live_fields,
    make_gpu_tree, use_nvml)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "testdata")
RUNTIME_GAUGES = ("HBM_USAGE", "HBM_TOTAL", "DUTY_CYCLE")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    """No test reads the host's NVML; neither package's discovery
    raises."""
    use_nvml(monkeypatch, None)
    chips_mod.fatal_on_driver_unavailable(False)
    ref_chips.fatal_on_driver_unavailable(False)
    yield
    chips_mod.fatal_on_driver_unavailable(True)
    ref_chips.fatal_on_driver_unavailable(True)


@pytest.fixture
def registries():
    """A fresh registry installed in each package."""
    regs = {"ref": ref_metrics.MetricsRegistry(),
            "port": obs_metrics.MetricsRegistry()}
    ref_metrics.install(regs["ref"])
    obs_metrics.install(regs["port"])
    yield regs
    ref_metrics.uninstall()
    obs_metrics.uninstall()


def ref_service(tmp_path, fixture="tpu-v5e-8"):
    root = tmp_path / "ref"
    shutil.copytree(os.path.join(TESTDATA, fixture), root)
    return ref_exp.ChipHealthService(
        str(root / "sys"), str(root / "dev"), str(root / "tpu-env")), root


def port_service(tmp_path, gpus=None, **tree):
    roots = make_gpu_tree(str(tmp_path / "port"),
                          hgx_gpus() if gpus is None else gpus, **tree)
    return exp.ChipHealthService(*roots), roots


def _series(text, family):
    """{labels string: value} of one family's samples."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        rf"^{family}(?:\{{(.*?)\}})? (\S+)$", text, re.M)}


# -- the gRPC service ---------------------------------------------------------


def _transcript(serve, service, remove_node, sock):
    """List; List after one device node goes; GetTPUState of one id, of
    an unknown id and of none. Devices by their position in the first
    List."""
    server = serve(sock, service)
    try:
        with grpc.insecure_channel(f"unix://{sock}") as channel:
            stub = metricssvc_grpc.MetricsServiceStub(channel)
            first = stub.List(metricssvc_pb2.Empty(), timeout=10)
            devices = [s.device for s in first.tpu_state]
            pos = {d: i for i, d in enumerate(devices)}

            def rows(resp):
                return [(s.id, s.health, pos.get(s.device, s.device))
                        for s in resp.tpu_state]

            def get(ids):
                return rows(stub.GetTPUState(
                    metricssvc_pb2.TPUGetRequest(id=ids), timeout=10))

            out = {"list": rows(first)}
            remove_node(5)
            out["after_remove"] = rows(stub.List(metricssvc_pb2.Empty(),
                                                 timeout=10))
            out["one"] = get([devices[2]])
            out["unknown"] = get(["no-such-device"])
            out["none"] = get([])
        return out, devices
    finally:
        server.stop(grace=0).wait()


@pytest.fixture(scope="module")
def service_transcripts(tmp_path_factory):
    ref_chips.fatal_on_driver_unavailable(False)
    chips_mod.fatal_on_driver_unavailable(False)
    saved = (binding._lib, binding._load_attempted)
    binding._lib, binding._load_attempted = None, True
    try:
        tmp = tmp_path_factory.mktemp("svc")
        service, root = ref_service(tmp)
        ref = _transcript(ref_exp.serve, service,
                          lambda i: os.remove(root / "dev" / f"accel{i}"),
                          str(tmp / "ref.sock"))
        service, (_, dev, _) = port_service(tmp)
        port = _transcript(exp.serve, service,
                           lambda i: os.remove(os.path.join(dev, f"nvidia{i}")),
                           str(tmp / "port.sock"))
        return {"ref": ref, "port": port}
    finally:
        binding._lib, binding._load_attempted = saved
        ref_chips.fatal_on_driver_unavailable(True)
        chips_mod.fatal_on_driver_unavailable(True)


def test_service_lists_every_gpu_healthy_by_key(service_transcripts):
    out, devices = service_transcripts["port"]
    assert devices == [g["bdf"] for g in hgx_gpus()]
    assert out["list"] == [(str(i), "healthy", i) for i in range(8)]


def test_service_one_node_removed_makes_exactly_that_gpu_unhealthy(
        service_transcripts):
    out, _ = service_transcripts["port"]
    assert [h for _, h, _ in out["after_remove"]] == \
        ["healthy"] * 5 + ["unhealthy"] + ["healthy"] * 2


def test_service_get_state_filters_on_keys(service_transcripts):
    out, _ = service_transcripts["port"]
    assert out["one"] == [("2", "healthy", 2)]
    assert out["unknown"] == []
    assert len(out["none"]) == 8


def test_service_transcripts_equal_but_the_device_ids(service_transcripts):
    (ref, ref_devices), (port, port_devices) = \
        service_transcripts["ref"], service_transcripts["port"]
    assert port == ref
    assert ref_devices != port_devices


def test_service_keys_gpus_by_uuid_where_pci_is_hidden(tmp_path, monkeypatch):
    """The card's layout: NVML without PCI info, so the state's device is
    the UUID (what the plugin advertises there), the id its minor."""
    card = gpu(6, "0000:cb:00.0", 0, uuid=CARD_UUID)
    use_nvml(monkeypatch, FakeNVML([card], pci=False))
    service, _ = port_service(tmp_path, [card], procfs=False, pci=False)
    (state,) = service._states()
    assert (state.id, state.health, state.device) == ("6", "healthy", CARD_UUID)
    assert [s.device for s in service._states({CARD_UUID})] == [CARD_UUID]
    assert service._states({"0000:cb:00.0"}) == []


# -- the Prometheus text ------------------------------------------------------


def _shape(text):
    """The text's structure: HELP and TYPE lines by family (TYPE with its
    kind), samples by family and label keys, a run of samples of one
    shape counted once (the hosts have different GPU and accelerator
    counts)."""
    out = []
    for line in text.splitlines():
        if line.startswith("# "):
            kind, family, *rest = line[2:].split()
            out.append((kind, family, rest[0] if kind == "TYPE" else None))
        elif line:
            m = re.match(r"^(\w+)(?:\{(.*)\})? \S+$", line)
            keys = tuple(re.findall(r'(\w+)="', m.group(2) or ""))
            item = ("sample", m.group(1), keys)
            if out[-1] != item:
                out.append(item)
    return out


@pytest.fixture
def nvml_hgx(monkeypatch):
    fake = FakeNVML(hgx_gpus())
    use_nvml(monkeypatch, fake)
    return fake


def test_prometheus_text_has_the_references_families_order_and_labels(
        tmp_path, nvml_hgx, registries):
    service, _ = ref_service(tmp_path)
    server, addr = _serve_fake_runtime(FakeRuntimeMetricService())
    try:
        ref_text = ref_exp.chip_metric_text(service, addr)
    finally:
        server.stop(grace=None)
    service, _ = port_service(tmp_path, pci=False)
    text = exp.chip_metric_text(service, "nvml")
    assert _shape(text) == _shape(ref_text)
    families = [f for k, f, _ in _shape(text) if k == "TYPE"]
    assert families == [
        "tpu_chip_health", "tpu_chip_temp_celsius",
        "tpu_chip_pcie_link_speed_gts", "tpu_chip_pcie_link_width",
        "tpu_exporter_runtime_staleness_seconds", "tpu_hbm_usage_bytes",
        "tpu_hbm_total_bytes", "tpu_tensorcore_duty_cycle_percent",
        "tpu_chip_count"]


def test_prometheus_values_come_from_nvml(tmp_path, nvml_hgx):
    """No sysfs telemetry on the tree: temperature and link from NVML,
    memory and utilisation from NVML by GPU key, byte counts exact."""
    service, _ = port_service(tmp_path)
    text = exp.chip_metric_text(service, "nvml")
    for g in hgx_gpus():
        live = live_fields(g)
        labels = f'device="{g["bdf"]}",chip="{g["minor"]}"'
        acc = f'accelerator="{g["bdf"]}"'
        assert _series(text, "tpu_chip_health")[labels] == 1
        assert _series(text, "tpu_chip_temp_celsius")[labels] == live["temp_c"]
        assert _series(text, "tpu_chip_pcie_link_speed_gts")[labels] == 32.0
        assert _series(text, "tpu_chip_pcie_link_width")[labels] == 16
        assert f'tpu_hbm_usage_bytes{{{acc}}} {float(live["memory_used"])!r}' \
            in text
        assert f'tpu_hbm_total_bytes{{{acc}}} 85520809984.0' in text
        assert _series(text, "tpu_tensorcore_duty_cycle_percent")[acc] == \
            live["util_gpu"]
    assert _series(text, "tpu_chip_count") == {None: 8}


def test_no_runtime_families_without_the_address(tmp_path, nvml_hgx):
    service, _ = port_service(tmp_path)
    text = exp.chip_metric_text(service)
    assert "tpu_hbm_" not in text and "tpu_exporter_runtime" not in text
    assert "tpu_chip_temp_celsius" in text


# -- the telemetry readers ----------------------------------------------------


def _pci_dir(sys_root, bdf):
    return os.path.realpath(os.path.join(sys_root, "bus", "pci", "devices",
                                         bdf))


def test_sysfs_telemetry_reads_the_references_files(tmp_path):
    """Each fixture chip's hwmon and link files copied under a GPU's PCI
    function read as the reference reads them there."""
    service, root = ref_service(tmp_path)
    ref_chip_list = service._chips()
    gpus = hgx_gpus()
    port, (sys_root, _, _) = port_service(tmp_path, gpus)
    for rc, c in zip(ref_chip_list, port._chips()):
        src = ref_telemetry._device_dir(rc, str(root / "sys"))
        dst = _pci_dir(sys_root, c.pci_address)
        shutil.copytree(os.path.join(src, "hwmon"), os.path.join(dst, "hwmon"))
        for name in ("current_link_speed", "current_link_width"):
            shutil.copy(os.path.join(src, name), dst)
        want = ref_telemetry.read_chip_telemetry(rc, str(root / "sys"))
        assert want.temp_c is not None
        assert astuple(telemetry.read_chip_telemetry(c, sys_root)) == \
            astuple(want)


def test_sysfs_wins_and_nvml_fills_what_it_lacks(tmp_path, monkeypatch):
    gpus = four_gpus()
    roots = make_gpu_tree(str(tmp_path), gpus)
    sys_root = roots[0]
    fake = FakeNVML(gpus)
    use_nvml(monkeypatch, fake)
    dev = _pci_dir(sys_root, gpus[1]["bdf"])
    os.makedirs(os.path.join(dev, "hwmon", "hwmon0"))
    for name, value in (("hwmon/hwmon0/temp1_input", "40500"),
                        ("hwmon/hwmon0/temp2_input", "45000"),
                        ("current_link_width", "8")):
        with open(os.path.join(dev, name), "w") as f:
            f.write(value + "\n")
    chips = chips_mod.get_gpu_chips(*roots)
    got = telemetry.read_chip_telemetry(chips[gpus[1]["bdf"]], sys_root)
    # hottest hwmon sensor and sysfs's width; the link speed from NVML's
    # generation 5
    assert got == telemetry.ChipTelemetry(45.0, 32.0, 8)
    fake.live[gpus[0]["uuid"]].update(pcie_gen=4, pcie_width=8, temp_c=52)
    got = telemetry.read_chip_telemetry(chips[gpus[0]["bdf"]], sys_root)
    assert got == telemetry.ChipTelemetry(52.0, 16.0, 8)


@pytest.mark.parametrize("gen,gts", sorted(telemetry.PCIE_GEN_GTS.items()))
def test_pcie_generation_maps_to_its_rate(gen, gts, tmp_path, monkeypatch):
    card = gpu(2, "0000:cb:00.0", 0, uuid=CARD_UUID)
    fake = FakeNVML([card], pci=False)
    fake.live[CARD_UUID]["pcie_gen"] = gen
    use_nvml(monkeypatch, fake)
    (chip,) = chips_mod.get_gpu_chips(
        *make_gpu_tree(str(tmp_path), [card], procfs=False, pci=False)).values()
    assert chip.pci_address == ""
    assert telemetry.read_chip_telemetry(chip).link_speed_gts == gts


def test_absent_telemetry_is_none_and_emits_no_sample(tmp_path, monkeypatch):
    service, (sys_root, _, _) = port_service(tmp_path)
    for c in service._chips():
        assert telemetry.read_chip_telemetry(c, sys_root) == \
            telemetry.ChipTelemetry()
    text = exp.chip_metric_text(service)
    assert "tpu_chip_temp_celsius" not in text
    assert "tpu_chip_pcie_link" not in text
    assert "tpu_chip_count 8" in text
    # NVML refusing every telemetry query reads the same
    use_nvml(monkeypatch, FakeNVML(hgx_gpus(), refuse={
        "nvmlDeviceGetTemperature", "nvmlDeviceGetCurrPcieLinkGeneration",
        "nvmlDeviceGetCurrPcieLinkWidth"}))
    assert all(telemetry.read_chip_telemetry(c, sys_root)
               == telemetry.ChipTelemetry() for c in service._chips())
    assert "tpu_chip_temp_celsius" not in exp.chip_metric_text(service)


# -- the runtime reader -------------------------------------------------------


def _failures(text, side_rt):
    """{(gauge position, reason): count} of the poll-failure counter."""
    names = [getattr(side_rt, n) for n in RUNTIME_GAUGES]
    return {(names.index(m.group(1)), m.group(2)): float(m.group(3))
            for m in re.finditer(
                r'^tpu_exporter_runtime_poll_failures_total\{metric="([^"]+)",'
                r'reason="([^"]+)"\} (\S+)$', text, re.M)}


def test_reads_all_three_gauges_by_key(nvml_hgx, registries):
    got = rt.read_runtime_metrics("nvml")
    assert list(got.accelerators) == [g["bdf"] for g in hgx_gpus()]
    for g in hgx_gpus():
        acc, live = got.accelerators[g["bdf"]], live_fields(g)
        assert (acc.hbm_usage_bytes, acc.hbm_total_bytes, acc.duty_cycle_pct) \
            == (live["memory_used"], live["memory_total"],
                float(live["util_gpu"]))
    assert _failures(registries["port"].expose(), rt) == {}


def test_keys_are_uuids_where_pci_is_hidden(monkeypatch, registries):
    card = gpu(4, "0000:cb:00.0", 0, uuid=CARD_UUID)
    use_nvml(monkeypatch, FakeNVML([card], pci=False))
    got = rt.read_runtime_metrics("nvml")
    assert list(got.accelerators) == [CARD_UUID]


def test_partial_support_keeps_going(monkeypatch, registries):
    use_nvml(monkeypatch, FakeNVML(four_gpus(),
                                   refuse={"nvmlDeviceGetMemoryInfo"}))
    got = rt.read_runtime_metrics("nvml")
    acc = got.accelerators[four_gpus()[0]["bdf"]]
    assert (acc.hbm_usage_bytes, acc.hbm_total_bytes, acc.duty_cycle_pct) == \
        (None, None, 5.0)
    assert _failures(registries["port"].expose(), rt) == {
        (0, "unsupported"): 1, (1, "unsupported"): 1}


def test_no_gpus_listed_is_empty(monkeypatch, registries):
    use_nvml(monkeypatch, FakeNVML([]))
    assert rt.read_runtime_metrics("nvml") is None
    assert _failures(registries["port"].expose(), rt) == {
        (i, "empty"): 1 for i in range(3)}


def test_no_nvml_is_none_and_counted_unreachable(registries):
    assert rt.read_runtime_metrics("nvml") is None
    assert _failures(registries["port"].expose(), rt) == {
        (i, "unreachable"): 1 for i in range(3)}


def test_other_addresses_are_refused():
    with pytest.raises(ValueError, match="nvml"):
        rt.read_runtime_metrics(ref_rt.DEFAULT_RUNTIME_METRICS_ADDR)


def test_nvml_without_utilisation_still_enumerates(tmp_path, monkeypatch,
                                                   registries):
    gpus = four_gpus()
    use_nvml(monkeypatch, FakeNVML(
        gpus, lacks={"nvmlDeviceGetUtilizationRates"}))
    chips = chips_mod.get_gpu_chips(
        *make_gpu_tree(str(tmp_path), gpus, procfs=False))
    assert list(chips) == [g["bdf"] for g in gpus]
    s = binding.sample(gpus[0]["uuid"])
    assert (s["util_gpu"], s["util_memory"]) == (None, None)
    assert s["memory_total"] == 81559 << 20
    assert s["errors"] == {"nvmlDeviceGetUtilizationRates": -1}
    acc = rt.read_runtime_metrics("nvml").accelerators[gpus[0]["bdf"]]
    assert acc.duty_cycle_pct is None and acc.hbm_usage_bytes == 1 << 30
    assert _failures(registries["port"].expose(), rt) == {(2, "unsupported"): 1}


class _Fn:
    """A C function's stand-in: takes argtypes and restype."""


class _Lib:
    def __init__(self, lacks=()):
        for name in ("nvmlInit_v2", "nvmlSystemGetDriverVersion",
                     "nvmlDeviceGetCount_v2", "nvmlDeviceGetHandleByIndex_v2",
                     "nvmlDeviceGetUUID", "nvmlDeviceGetName",
                     "nvmlDeviceGetMinorNumber", "nvmlDeviceGetPciInfo_v3",
                     "nvmlDeviceGetNvLinkState",
                     "nvmlDeviceGetNvLinkRemotePciInfo_v2",
                     "nvmlDeviceGetHandleByUUID", "nvmlDeviceGetMemoryInfo",
                     "nvmlDeviceGetUtilizationRates",
                     "nvmlDeviceGetTemperature",
                     "nvmlDeviceGetCurrPcieLinkGeneration",
                     "nvmlDeviceGetCurrPcieLinkWidth"):
            if name not in lacks:
                setattr(self, name, _Fn())


def test_declare_needs_only_discoverys_functions():
    """A library without an exporter query is declared (discovery goes
    on); one without a discovery function is refused, as before."""
    lib = _Lib(lacks={"nvmlDeviceGetUtilizationRates",
                      "nvmlDeviceGetHandleByUUID"})
    binding._declare(lib)
    assert lib.nvmlDeviceGetMemoryInfo.argtypes[1]._type_ is binding.Memory
    assert lib.nvmlDeviceGetUUID.restype is binding.ctypes.c_int
    with pytest.raises(AttributeError):
        binding._declare(_Lib(lacks={"nvmlDeviceGetMinorNumber"}))


def _sample_without(monkeypatch, name):
    use_nvml(monkeypatch, FakeNVML(four_gpus(), lacks={name}))
    return binding.sample(four_gpus()[0]["uuid"])


def test_sample_without_handle_by_uuid_is_none(monkeypatch):
    assert _sample_without(monkeypatch, "nvmlDeviceGetHandleByUUID") is None


def test_sample_is_none_without_nvml_or_for_an_unknown_uuid(monkeypatch):
    assert binding.sample(CARD_UUID) is None
    use_nvml(monkeypatch, FakeNVML(four_gpus()))
    assert binding.sample(CARD_UUID) is None
    assert binding.sample(four_gpus()[3]["uuid"]) == dict(
        live_fields(four_gpus()[3]), errors={},
        memory_free=(81559 << 20) - (4 << 30))


# -- the breaker, beside the reference's --------------------------------------


class _RefSide:
    name = "ref"
    rt, faults, metrics = ref_rt, ref_faults, ref_metrics

    def __init__(self, monkeypatch):
        self.server, self.alive_addr = _serve_fake_runtime(
            FakeRuntimeMetricService())

    def read(self, alive):
        addr = self.alive_addr if alive else "127.0.0.1:1"
        return self.rt.read_runtime_metrics(addr, timeout_s=0.2)

    def close(self):
        self.server.stop(grace=None)


class _PortSide:
    name = "port"
    rt, faults, metrics = rt, faults, obs_metrics

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def read(self, alive):
        use_nvml(self.monkeypatch, FakeNVML(four_gpus()) if alive else None)
        return self.rt.read_runtime_metrics("nvml", timeout_s=0.2)

    def close(self):
        pass


def _breaker_run(side):
    """Trip at the threshold (2), skip while open, a failed half-open
    probe reopens, a good one closes; then the same under a
    ``runtime.poll`` fault plan. Returns the breaker-state gauge after
    each poll, each poll's outcome, the skips and the failures."""
    reg = side.metrics.MetricsRegistry()
    side.metrics.install(reg)
    br = side.rt.configure_breaker(threshold=2, reset_s=0.2)
    gauge = reg.gauge("tpu_exporter_runtime_breaker_state_count")
    seq, got = [gauge.value()], []

    def poll(alive):
        got.append(side.read(alive) is not None)
        seq.append(gauge.value())

    try:
        poll(False)
        poll(False)     # trips
        poll(True)      # open: skipped though the source is back
        time.sleep(0.25)
        poll(False)     # the half-open probe fails: reopens
        time.sleep(0.25)
        poll(True)      # the probe succeeds: closes
        with side.faults.plan("runtime.poll=error:count=2") as p:
            poll(True)
            poll(True)  # trips on the injected blackout
            fires = p.fires("runtime.poll")
        poll(True)      # open
        time.sleep(0.25)
        poll(True)      # recovers
        state = br.state
        text = reg.expose()
    finally:
        side.rt.configure_breaker()
        side.metrics.uninstall()
        side.close()
    skips = _series(text, "tpu_exporter_runtime_breaker_skips_total")
    return {"gauge": seq, "results": got, "fires": fires, "state": state,
            "skips": skips, "failures": _failures(text, side.rt)}


@pytest.fixture(scope="module")
def breaker_runs():
    mp = pytest.MonkeyPatch()
    try:
        return {side.name: _breaker_run(side(mp))
                for side in (_RefSide, _PortSide)}
    finally:
        mp.undo()


def test_breaker_gauge_sequence_equals_the_references(breaker_runs):
    ref, port = breaker_runs["ref"], breaker_runs["port"]
    assert port["gauge"] == ref["gauge"] == \
        [0, 0, 1, 1, 1, 0, 0, 1, 1, 0]
    assert port["results"] == ref["results"] == \
        [False, False, False, False, True, False, False, False, True]
    assert port["state"] == ref["state"] == "closed"


def test_breaker_counters_equal_the_references(breaker_runs):
    ref, port = breaker_runs["ref"], breaker_runs["port"]
    assert port["skips"] == ref["skips"] == {None: 2}
    assert port["fires"] == ref["fires"] == 2
    assert port["failures"] == ref["failures"] == {
        **{(i, "unreachable"): 3 for i in range(3)},
        **{(i, "fault"): 2 for i in range(3)}}


# -- the unified endpoint, the watchdog ---------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_control_plane_and_gpu_series_in_one_scrape(tmp_path, registries):
    """The reference's TestUnifiedEndpoint case on the port: a real
    Allocate and a health flip on the port's plugin, a serving
    histogram, and the GPU families, in one /metrics body; /healthz
    counts GPUs."""
    from k8s_device_plugin_tpu.api.deviceplugin.v1beta1 import api_pb2
    from k8s_device_plugin_tpu_torch.models import serve_engine
    from k8s_device_plugin_tpu_torch.plugin import GPUDevicePlugin, PluginConfig

    service, (sys_root, dev_root, proc_root) = port_service(tmp_path)
    plugin = GPUDevicePlugin(resource="gpu", config=PluginConfig(
        sysfs_root=sys_root, dev_root=dev_root, proc_root=proc_root,
        health_socket=str(tmp_path / "none.sock")))
    plugin.start()
    bdf = hgx_gpus()[0]["bdf"]
    plugin.Allocate(api_pb2.AllocateRequest(container_requests=[
        api_pb2.ContainerAllocateRequest(devices_ids=[bdf])]), None)
    plugin._record_health_transitions([api_pb2.Device(ID=bdf,
                                                      health="Healthy")])
    plugin._record_health_transitions([api_pb2.Device(ID=bdf,
                                                      health="Unhealthy")])
    serve_engine._h_ttft().observe(0.25, path="static")
    os.remove(os.path.join(dev_root, "nvidia7"))
    httpd = exp.serve_http_metrics(service, 0, "127.0.0.1")
    try:
        port = httpd.server_address[1]
        status, body = _get(port, "/metrics")
        hstatus, health = _get(port, "/healthz")
    finally:
        httpd.shutdown()
        plugin.stop()
    assert status == 200
    assert 'tpu_plugin_allocate_total{resource="gpu",outcome="ok"} 1' in body
    assert ('tpu_plugin_health_transitions_total{resource="gpu",'
            f'device="{bdf}",to="Unhealthy"}} 1') in body
    assert 'tpu_serve_ttft_seconds_count{path="static"} 1' in body
    assert f'tpu_chip_health{{device="{bdf}",chip="0"}} 1' in body
    assert "tpu_chip_count 8" in body
    doc = json.loads(health)
    assert hstatus == 200 and (doc["chips"], doc["healthy"]) == (8, 7)


def test_watchdog_loop_beats_and_a_hung_pass_flips_healthz(tmp_path,
                                                           monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(watchdog, "_default",
                        watchdog.WatchdogRegistry(clock=lambda: now[0]))
    service, _ = port_service(tmp_path)
    passes, hang, release = [], threading.Event(), threading.Event()
    chips = service._chips

    def discovery_pass():
        # only the loop's passes hang; /healthz and /metrics discover too
        if threading.current_thread().name == "chips-poll":
            passes.append(1)
            if hang.is_set():
                release.wait(30)
        return chips()

    service._chips = discovery_pass
    stop = threading.Event()
    thread = exp.start_chip_poll_watchdog(service, stop, interval_s=0.01)
    httpd = exp.serve_http_metrics(service, 0, "127.0.0.1")
    port = httpd.server_address[1]
    try:
        deadline = time.time() + 10
        while len(passes) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert len(passes) >= 3
        status, body = _get(port, "/healthz")
        assert status == 200
        assert "exporter.chips_poll" in json.loads(body)["watchdog"]["loops"]
        hang.set()
        n = len(passes)
        while len(passes) == n:
            time.sleep(0.01)
        now[0] += 61.0  # past max(60, 6 x interval) without a beat
        status, body = _get(port, "/healthz")
        assert status == 503
        assert "exporter.chips_poll" in json.loads(body)["watchdog"]["stalled"]
        assert _get(port, "/metrics")[0] == 200
        hang.clear()
        release.set()
        deadline = time.time() + 10
        while _get(port, "/healthz")[0] != 200 and time.time() < deadline:
            time.sleep(0.01)
        assert _get(port, "/healthz")[0] == 200
    finally:
        stop.set()
        release.set()
        thread.join(timeout=10)
        httpd.shutdown()
    assert not thread.is_alive()


# -- the command line ---------------------------------------------------------


def _options(parser):
    return {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_flags_are_the_references_with_proc_root_for_tpu_env_path():
    ref, port = _options(ref_exp.build_arg_parser()), \
        _options(exp.build_arg_parser())
    assert ref.pop("--tpu-env-path") is None
    assert port.pop("--proc-root") == "/proc"
    assert port == ref
    assert exp.build_arg_parser().prog == "gpu-metrics-exporter"


def test_socket_defaults_pair_the_exporter_with_the_plugin():
    from k8s_device_plugin_tpu_torch.cmd import device_plugin
    from k8s_device_plugin_tpu_torch.plugin import PluginConfig

    assert _options(exp.build_arg_parser())["--socket"] == \
        DEFAULT_HEALTH_SOCKET == ref_exp.DEFAULT_HEALTH_SOCKET
    # the plugin's flag defaults to unset, which its merge reads as the
    # exporter's well-known path (plugin.py's _device_list)
    assert device_plugin.build_arg_parser().parse_args([]).health_socket \
        is None
    assert PluginConfig().health_socket is None


@pytest.mark.parametrize("addr", ["localhost:8431", "NVML", "nvml:0"])
def test_other_runtime_addresses_stop_the_daemon(addr, capsys):
    assert exp.main(["--runtime-metrics-addr", addr]) == 1
    err = capsys.readouterr().err
    assert "--runtime-metrics-addr" in err and "'nvml'" in err


def test_runtime_address_from_the_config_file_is_checked(tmp_path, capsys):
    cfg = tmp_path / "exporter.json"
    cfg.write_text(json.dumps({"runtime-metrics-addr": "localhost:8431"}))
    assert exp.main(["--config", str(cfg)]) == 1
    assert "'nvml'" in capsys.readouterr().err
    cfg.write_text(json.dumps({"tpu-env-path": "/run/tpu-env"}))
    assert exp.main(["--config", str(cfg)]) == 1
    assert "unknown config keys" in capsys.readouterr().err


def _free_port():
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_command_line_daemon_serves_socket_metrics_and_healthz(tmp_path):
    """``python -m ...cmd.metrics_exporter --config FILE`` on a GPU tree:
    List by key, /metrics, /healthz, then SIGTERM: exit 0, socket gone."""
    if binding.available():
        pytest.skip("this host's NVML would answer for its own GPUs")
    from k8s_device_plugin_tpu_torch.exporter import health

    sys_root, dev_root, proc_root = make_gpu_tree(str(tmp_path / "host"),
                                                  four_gpus())
    sock = str(tmp_path / "run" / "exporter.sock")
    http_port = _free_port()
    cfg = tmp_path / "exporter.json"
    cfg.write_text(json.dumps({
        "socket": sock, "sysfs-root": sys_root, "dev-root": dev_root,
        "proc-root": proc_root, "http-port": str(http_port),
        "http-addr": "127.0.0.1", "poll-interval": 0.5}))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log_path = tmp_path / "exporter.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "k8s_device_plugin_tpu_torch.cmd.metrics_exporter",
             "--config", str(cfg)],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path), env=env)
    try:
        deadline = time.time() + 30
        while not os.path.exists(sock) and time.time() < deadline:
            assert proc.poll() is None, log_path.read_text()
            time.sleep(0.05)
        got = health.get_tpu_health(sock)
        assert got == {g["bdf"]: "Healthy" for g in four_gpus()}
        while time.time() < deadline:
            try:
                status, body = _get(http_port, "/metrics")
                break
            except urllib.error.URLError:
                time.sleep(0.05)
        assert status == 200
        assert "tpu_chip_count 4" in body
        assert "tpu_hbm_usage_bytes" not in body
        status, doc = _get(http_port, "/healthz")
        assert status == 200
        assert (json.loads(doc)["chips"], json.loads(doc)["healthy"]) == (4, 4)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, log_path.read_text()
        assert not os.path.exists(sock)
        assert "GPU metrics exporter version" in log_path.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
