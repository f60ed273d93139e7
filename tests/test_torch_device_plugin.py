"""The port's device-plugin daemon against the reference's, under
tests/fakekubelet.FakeKubelet.

Both daemons (the dpm ``Manager`` + their lister, in process) run the same
conversation: the reference's over testdata/tpu-v5e-4 (four chips, NUMA
0, 0, 1, 1), the port's over a four-GPU tree of that shape built by
tests/test_torch_gpu_discovery.py (procfs walk, NVML off). The transcript
records Register's version, endpoint and options; the first ListAndWatch
list; a health transition driven by one ``health.exporter_query`` fault
plan against a metrics-exporter stub; GetPreferredAllocation;
Allocate of one and two devices, NOT_FOUND on an unknown id and the
double-assign guard; a restart that restores the checkpoint; the
re-registration after the kubelet socket goes and comes back; and the
metric families recorded. Devices are named by their index, so the
transcripts compare whole; what may differ is only the resource name and
the envs (asserted exactly for the port), and the device nodes: the port
maps each GPU's node where the reference maps its chip's, plus the three
control nodes once.

Then the port's command line, ``python -m
k8s_device_plugin_tpu_torch.cmd.device_plugin``, registers on the same
tree and serves the four RPCs over its socket, and refuses the
reference's flags of the parts not ported.
"""

import contextlib
import importlib
import json
import os
import queue
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent import futures

import grpc
import pytest

from k8s_device_plugin_tpu.api.deviceplugin.v1beta1 import api_pb2
from k8s_device_plugin_tpu.api.metricssvc import metricssvc_grpc, metricssvc_pb2
from k8s_device_plugin_tpu_torch.native import binding
from tests.fakekubelet import FakeKubelet
from tests.test_torch_gpu_discovery import four_gpus, make_gpu_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "testdata")
PLAN = "health.exporter_query=error:count=3"
CONTROL = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


class _Exporter(metricssvc_grpc.MetricsServiceServicer):
    """Reports every device it is given as healthy."""

    def __init__(self, devices):
        self.devices = devices

    def List(self, request, context):
        return metricssvc_pb2.TPUStateResponse(tpu_state=[
            metricssvc_pb2.TPUState(id=str(i), health="healthy", device=d)
            for i, d in enumerate(self.devices)])


@contextlib.contextmanager
def exporter(path, devices):
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    metricssvc_grpc.add_MetricsServiceServicer_to_server(
        _Exporter(devices), server)
    server.add_insecure_port(f"unix://{path}")
    server.start()
    try:
        yield
    finally:
        server.stop(grace=0).wait()


class Side:
    """One package's daemon in process: modules, host tree, config."""

    def __init__(self, name, tmp):
        self.name = name
        pkg = ("k8s_device_plugin_tpu" if name == "ref"
               else "k8s_device_plugin_tpu_torch")
        self.plugin = importlib.import_module(pkg + ".plugin")
        self.dpm = importlib.import_module(pkg + ".dpm")
        self.faults = importlib.import_module(pkg + ".utils.faults")
        self.metrics = importlib.import_module(pkg + ".obs.metrics")
        self.chips = importlib.import_module(pkg + ".discovery.chips")
        self.tmp = tmp
        self.kubelet_dir = os.path.join(tmp, "kubelet")
        self.ckpt_dir = os.path.join(tmp, "ckpt")
        self.health_socket = os.path.join(tmp, "exporter.sock")
        os.makedirs(self.kubelet_dir)
        if name == "ref":
            shutil.copytree(os.path.join(TESTDATA, "tpu-v5e-4"),
                            os.path.join(tmp, "host"))
            host = os.path.join(tmp, "host")
            self.roots = dict(sysfs_root=os.path.join(host, "sys"),
                              dev_root=os.path.join(host, "dev"),
                              tpu_env_path=os.path.join(host, "tpu-env"))
            self.lister_cls = self.plugin.TPULister
            self.node_prefix = "accel"
        else:
            sys_root, dev_root, proc_root = make_gpu_tree(
                os.path.join(tmp, "host"), four_gpus())
            self.roots = dict(sysfs_root=sys_root, dev_root=dev_root,
                              proc_root=proc_root)
            self.lister_cls = self.plugin.GPULister
            self.node_prefix = "nvidia"

    def config(self):
        return self.plugin.PluginConfig(
            device_plugin_dir=self.kubelet_dir, checkpoint_dir=self.ckpt_dir,
            health_socket=self.health_socket, on_stream_end=lambda: None,
            **self.roots)

    @contextlib.contextmanager
    def daemon(self):
        heartbeat = queue.Queue()
        lister = self.lister_cls(config=self.config(), heartbeat=heartbeat)
        mgr = self.dpm.Manager(lister, device_plugin_dir=self.kubelet_dir,
                               start_retry_wait_s=0.05,
                               install_signal_handlers=False)
        thread = threading.Thread(target=mgr.run, daemon=True)
        thread.start()
        lister.resource_updates.put(lister.compute_resources())
        try:
            yield lister, heartbeat
        finally:
            mgr.stop()
            thread.join(timeout=10)
            assert not thread.is_alive()


def _code(fn):
    try:
        fn()
    except grpc.RpcError as e:
        return e.code().name
    return "OK"


def drive(side):
    """The conversation; returns (transcript, envs by allocation, the
    devices in index order)."""
    out = {}
    envs = {}
    reg = side.metrics.MetricsRegistry()
    side.metrics.install(reg)
    side.chips.fatal_on_driver_unavailable(False)
    kubelet = FakeKubelet(side.kubelet_dir)
    kubelet.start()
    try:
        with side.daemon() as (lister, heartbeat):
            assert kubelet.wait_for_registration()
            r = kubelet.registrations[0]
            out["register"] = (r.version, r.resource_name,
                               r.endpoint == r.resource_name.replace("/", "_"),
                               r.options.get_preferred_allocation_available,
                               r.options.pre_start_required)
            stub, channel = kubelet.plugin_stub(r.endpoint)
            with channel:
                stream = stub.ListAndWatch(api_pb2.Empty())
                first = next(stream)
                ids = [d.ID for d in first.devices]
                idx = {d: i for i, d in enumerate(ids)}
                out["list"] = [(idx[d.ID], d.health,
                                [n.ID for n in d.topology.nodes])
                               for d in first.devices]
                # device 3's node is gone: the exporter still vouches for
                # it until the plan fails three polls, then the local
                # probe's verdict demotes it
                os.remove(os.path.join(side.roots["dev_root"],
                                       side.node_prefix + "3"))
                health = []
                with exporter(side.health_socket, ids):
                    with side.faults.plan(PLAN) as p:
                        for _ in range(4):
                            heartbeat.put(True)
                            health.append([d.health for d in next(stream).devices])
                        out["fault_fires"] = p.fires("health.exporter_query")
                    heartbeat.put(True)
                    health.append([d.health for d in next(stream).devices])
                out["health"] = health

                def gpa(avail, must, size):
                    resp = stub.GetPreferredAllocation(
                        api_pb2.PreferredAllocationRequest(container_requests=[
                            api_pb2.ContainerPreferredAllocationRequest(
                                available_deviceIDs=[ids[i] for i in avail],
                                must_include_deviceIDs=[ids[i] for i in must],
                                allocation_size=size)]), timeout=10)
                    return [idx[d] for d in resp.container_responses[0].deviceIDs]

                out["preferred"] = [gpa([0, 1, 2, 3], [], 2),
                                    gpa([0, 1, 2, 3], [3], 2),
                                    gpa([0, 1, 2], [], 3),
                                    gpa([0, 1, 2, 3], [], 1),
                                    gpa([1, 2, 3], [], 2)]
                out["preferred_error"] = _code(lambda: gpa([0], [], 5))

                def allocate(*which):
                    resp = stub.Allocate(api_pb2.AllocateRequest(
                        container_requests=[api_pb2.ContainerAllocateRequest(
                            devices_ids=[ids[i] for i in which])]), timeout=10)
                    car = resp.container_responses[0]
                    envs[which] = dict(car.envs)
                    return [d.host_path for d in car.devices], \
                        {d.permissions for d in car.devices}

                out["allocate_1"] = allocate(0)
                out["allocate_2"] = allocate(2, 3)
                out["not_found"] = _code(lambda: stub.Allocate(
                    api_pb2.AllocateRequest(container_requests=[
                        api_pb2.ContainerAllocateRequest(devices_ids=["bogus"])
                    ]), timeout=10))
                # an overlap with a record of this lifetime: the pod is
                # gone, the record is released and the grant proceeds
                out["overlap_live"] = _code(lambda: allocate(0, 1))
                channel.close()
        ids_by_index = ids
        # restart over the same checkpoint: an exact replay keeps its
        # allocation id; an overlap with a restored record is refused
        with side.daemon() as (lister, heartbeat):
            assert kubelet.wait_for_registration(count=2)
            r = kubelet.registrations[1]
            stub, channel = kubelet.plugin_stub(r.endpoint)
            with channel:
                first_envs = dict(envs[(2, 3)])
                out["replay"] = _code(lambda: allocate(2, 3))
                out["replay_same_id"] = (
                    envs[(2, 3)]["TPU_ALLOCATION_ID"]
                    == first_envs["TPU_ALLOCATION_ID"])
                out["overlap_restored"] = _code(lambda: allocate(1))
                # the kubelet's socket goes and comes back: re-register
                kubelet.stop(remove_socket=True)
                time.sleep(0.3)
                kubelet.start()
                out["reregistered"] = kubelet.wait_for_registration(count=3)
                out["reregister_resource"] = \
                    kubelet.registrations[2].resource_name
        text = reg.expose()
    finally:
        kubelet.stop()
        side.metrics.uninstall()
        side.chips.fatal_on_driver_unavailable(True)
    out["metrics"] = sorted(
        {m for m in re.findall(r"^# TYPE (\S+)", text, re.M)
         if m.startswith(("tpu_plugin_", "tpu_dpm_", "tpu_allocator_"))})
    return out, envs, ids_by_index


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    saved = (binding._lib, binding._load_attempted)
    binding._lib, binding._load_attempted = None, True
    try:
        return {name: drive(Side(name, str(tmp_path_factory.mktemp(name))))
                for name in ("ref", "port")}
    finally:
        binding._lib, binding._load_attempted = saved


def _port_tree_uuids():
    return [g["uuid"] for g in four_gpus()]


def test_register(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    assert ref["register"] == ("v1beta1", "google.com/tpu", True, True, False)
    assert port["register"] == ("v1beta1", "nvidia.com/gpu", True, True, False)


def test_first_list(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    assert port["list"] == ref["list"] == [
        (0, "Healthy", [0]), (1, "Healthy", [0]),
        (2, "Healthy", [1]), (3, "Healthy", [1])]
    assert transcripts["port"][2] == [g["bdf"] for g in four_gpus()]


def test_health_transition_under_the_same_fault_plan(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    assert port["fault_fires"] == ref["fault_fires"] == 3
    assert port["health"] == ref["health"]
    # SUSPECT twice (still schedulable), UNHEALTHY at the third bad poll,
    # held there while the exporter vouches again (recovery needs a run
    # of good polls)
    assert [h[3] for h in port["health"]] == \
        ["Healthy", "Healthy", "Unhealthy", "Unhealthy", "Unhealthy"]
    assert all(h[:3] == ["Healthy"] * 3 for h in port["health"])


def test_preferred_allocation(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    assert port["preferred"] == ref["preferred"]
    assert port["preferred_error"] == ref["preferred_error"] == \
        "INVALID_ARGUMENT"


def test_allocate_device_specs(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    for key, minors in (("allocate_1", (0,)), ("allocate_2", (2, 3))):
        (ref_paths, ref_perms), (paths, perms) = ref[key], port[key]
        assert ref_perms == perms == {"rw"}
        # one node per device, as the reference; then the control nodes
        gpu_nodes = [p for p in paths if os.path.basename(p) not in CONTROL]
        assert len(gpu_nodes) == len(ref_paths) == len(minors)
        assert [os.path.basename(p) for p in gpu_nodes] == \
            [f"nvidia{m}" for m in minors]
        assert [os.path.basename(p) for p in ref_paths] == \
            [f"accel{m}" for m in minors]
        assert [os.path.basename(p) for p in paths] == \
            [f"nvidia{minors[0]}", *CONTROL,
             *[f"nvidia{m}" for m in minors[1:]]]


def test_allocate_envs_exactly(transcripts):
    envs = transcripts["port"][1]
    uuids = _port_tree_uuids()
    for which in ((0,), (2, 3), (0, 1)):
        got = dict(envs[which])
        alloc = got.pop("TPU_ALLOCATION_ID")
        trace = got.pop("TPU_TRACEPARENT")
        visible = ",".join(uuids[i] for i in which)
        assert got == {"NVIDIA_VISIBLE_DEVICES": visible,
                       "CUDA_VISIBLE_DEVICES": visible}
        assert alloc.startswith("alloc-")
        assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-0[01]", trace)
    ref_envs = transcripts["ref"][1]
    assert ref_envs[(0,)]["TPU_VISIBLE_CHIPS"] == "0"
    assert set(ref_envs[(0,)]) >= {"TPU_ALLOCATION_ID", "TPU_TRACEPARENT"}


def test_allocate_errors_and_double_assign(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    for key in ("not_found", "overlap_live", "replay", "replay_same_id",
                "overlap_restored"):
        assert port[key] == ref[key], key
    assert (port["not_found"], port["overlap_live"], port["replay"],
            port["replay_same_id"], port["overlap_restored"]) == \
        ("NOT_FOUND", "OK", "OK", True, "FAILED_PRECONDITION")


def test_reregisters_after_the_kubelet_socket_returns(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    assert ref["reregistered"] and port["reregistered"]
    assert ref["reregister_resource"] == "google.com/tpu"
    assert port["reregister_resource"] == "nvidia.com/gpu"


def test_metric_families_keep_the_references_names(transcripts):
    ref, port = transcripts["ref"][0], transcripts["port"][0]
    assert port["metrics"] == ref["metrics"]
    assert "tpu_plugin_allocate_seconds" in port["metrics"]
    assert "tpu_allocator_decisions_total" in port["metrics"]


def test_transcripts_differ_only_in_the_resource_name(transcripts):
    ref, port = dict(transcripts["ref"][0]), dict(transcripts["port"][0])
    for d in (ref, port):
        for key in ("register", "reregister_resource", "allocate_1",
                    "allocate_2"):
            d.pop(key)
    assert port == ref


# -- the command line ---------------------------------------------------------


def _daemon_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_command_line_daemon_serves_the_four_rpcs(tmp_path):
    if binding.available():
        pytest.skip("this host's NVML would answer for its own GPUs")
    sys_root, dev_root, proc_root = make_gpu_tree(str(tmp_path / "host"),
                                                  four_gpus())
    kdir = tmp_path / "kubelet"
    kdir.mkdir()
    kubelet = FakeKubelet(str(kdir))
    kubelet.start()
    log_path = tmp_path / "daemon.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "k8s_device_plugin_tpu_torch.cmd.device_plugin",
             "--kubelet-dir", str(kdir), "--sysfs-root", sys_root,
             "--dev-root", dev_root, "--proc-root", proc_root,
             "--checkpoint-dir", str(tmp_path / "ckpt"), "--pulse", "1",
             "--driver-wait-seconds", "5", "--cdi-spec-dir",
             str(tmp_path / "cdi")],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path),
            env=_daemon_env())
    try:
        assert kubelet.wait_for_registration(timeout=30), \
            log_path.read_text()
        reg = kubelet.registrations[0]
        assert (reg.resource_name, reg.endpoint) == \
            ("nvidia.com/gpu", "nvidia.com_gpu")
        stub, channel = kubelet.plugin_stub(reg.endpoint)
        with channel:
            stream = stub.ListAndWatch(api_pb2.Empty())
            first = next(stream)
            ids = [d.ID for d in first.devices]
            assert ids == [g["bdf"] for g in four_gpus()]
            assert [d.topology.nodes[0].ID for d in first.devices] == \
                [0, 0, 1, 1]
            assert all(d.health == "Healthy" for d in next(stream).devices)
            pref = stub.GetPreferredAllocation(
                api_pb2.PreferredAllocationRequest(container_requests=[
                    api_pb2.ContainerPreferredAllocationRequest(
                        available_deviceIDs=ids, allocation_size=2)]),
                timeout=10)
            got = list(pref.container_responses[0].deviceIDs)
            assert got == ids[:2]
            resp = stub.Allocate(api_pb2.AllocateRequest(container_requests=[
                api_pb2.ContainerAllocateRequest(devices_ids=got)]),
                timeout=10)
            car = resp.container_responses[0]
            visible = ",".join(g["uuid"] for g in four_gpus()[:2])
            assert car.envs["CUDA_VISIBLE_DEVICES"] == visible
            assert car.envs["NVIDIA_VISIBLE_DEVICES"] == visible
            assert [os.path.basename(d.host_path) for d in car.devices] == \
                ["nvidia0", *CONTROL, "nvidia1"]
            assert [c.name for c in car.cdi_devices] == \
                [f"nvidia.com/gpu={i}" for i in got]
            spec = json.loads((tmp_path / "cdi" / "nvidia.com-gpu.json")
                              .read_text())
            assert spec["kind"] == "nvidia.com/gpu"
            assert len(spec["devices"]) == 4
            # SIGTERM while the kubelet still holds the stream: an orderly
            # stop (a dropped stream alone makes the daemon exit 1 to
            # re-register, as the reference's does)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0, log_path.read_text()
        assert not (kdir / "nvidia.com_gpu").exists()
        text = log_path.read_text()
        assert "NVML: NVML unavailable" in text
        assert (tmp_path / "ckpt" / "gpu-checkpoint.json").exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        kubelet.stop()


@pytest.mark.parametrize("flag", ["--podresources-socket", "--node-name",
                                  "--api-server", "--drain-deadline",
                                  "--partition"])
def test_refused_flags_name_the_roadmap(flag, capsys):
    from k8s_device_plugin_tpu_torch.cmd import device_plugin

    assert device_plugin.main([flag, "x"]) == 1
    err = capsys.readouterr().err
    assert flag in err and "ROADMAP A10" in err


def test_refused_flag_in_the_config_file(tmp_path, capsys):
    from k8s_device_plugin_tpu_torch.cmd import device_plugin

    cfg = tmp_path / "dp.json"
    cfg.write_text(json.dumps({"podresources-socket": "/x.sock"}))
    assert device_plugin.main(["--config", str(cfg)]) == 1
    assert "ROADMAP A10" in capsys.readouterr().err


def test_mixed_strategy_is_refused(monkeypatch):
    from k8s_device_plugin_tpu_torch.cmd import device_plugin
    from k8s_device_plugin_tpu_torch.plugin import resource_naming

    with pytest.raises(resource_naming.StrategyError, match="MIG"):
        resource_naming.parse_strategy("mixed")
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_load_attempted", True)
    assert device_plugin.main(["--resource-naming-strategy", "mixed"]) == 1


def test_driver_present(tmp_path, monkeypatch):
    from k8s_device_plugin_tpu_torch.cmd.device_plugin import driver_present

    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_load_attempted", True)
    sys_root, _, proc_root = make_gpu_tree(str(tmp_path / "a"), four_gpus())
    assert driver_present(sys_root, proc_root)
    sys_root, _, proc_root = make_gpu_tree(str(tmp_path / "b"), four_gpus(),
                                           procfs=False)
    assert driver_present(sys_root, proc_root)  # an NVIDIA PCI function
    sys_root, _, proc_root = make_gpu_tree(str(tmp_path / "c"), [],
                                           procfs=False)
    assert not driver_present(sys_root, proc_root)
    from tests.test_torch_gpu_discovery import FakeNVML

    monkeypatch.setattr(binding, "_lib", FakeNVML([]))
    assert driver_present(sys_root, proc_root)  # NVML answers

