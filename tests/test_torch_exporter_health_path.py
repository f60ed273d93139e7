"""The device plugin's health path through the metrics exporter, in the
port and in the reference.

Each package's plugin daemon (the dpm ``Manager`` and its lister, in
process, under tests/fakekubelet.FakeKubelet) points ``--health-socket``
at that package's own exporter (``ChipHealthService`` served by
``serve``) watching a second copy of the host: the reference on two
copies of testdata/tpu-v5e-4, the port on two four-GPU trees built by
tests/test_torch_gpu_discovery.py (procfs walk, NVML off). One device
node is removed from the exporter's copy only, so the plugin's own open
probe still passes and whatever the plugin advertises came through the
exporter; the node then comes back. The pulses are the heartbeats the
test feeds, the same number on both sides; the lifecycle's soak is 0 s,
so recovery is counted in pulses alone. The transitions compare whole.

Then the port's two commands as a node runs them: ``cmd.metrics_exporter``
and ``cmd.device_plugin --health-socket <its socket> --pulse 1``.
"""

import contextlib
import importlib
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from k8s_device_plugin_tpu.api.deviceplugin.v1beta1 import api_pb2
from k8s_device_plugin_tpu_torch.native import binding
from tests.fakekubelet import FakeKubelet
from tests.test_torch_device_plugin import Side
from tests.test_torch_gpu_discovery import four_gpus, make_gpu_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "testdata")
DOWN, UP = 6, 6  # pulses with the node gone, then back
GONE = 3         # the device whose node goes


def _exporter_side(side):
    """The side's exporter on its own copy of the host: (the service,
    the dev root it probes)."""
    pkg = ("k8s_device_plugin_tpu" if side.name == "ref"
           else "k8s_device_plugin_tpu_torch")
    exp = importlib.import_module(pkg + ".cmd.metrics_exporter")
    root = os.path.join(side.tmp, "exporter-host")
    if side.name == "ref":
        shutil.copytree(os.path.join(TESTDATA, "tpu-v5e-4"), root)
        service = exp.ChipHealthService(
            os.path.join(root, "sys"), os.path.join(root, "dev"),
            os.path.join(root, "tpu-env"))
        dev_root = os.path.join(root, "dev")
    else:
        roots = make_gpu_tree(root, four_gpus())
        service = exp.ChipHealthService(*roots)
        dev_root = roots[1]
    return exp, service, dev_root


def drive(side):
    """The first list, then the advertised health of every device after
    each pulse: DOWN pulses with device GONE's node missing from the
    exporter's copy, UP pulses with it back."""
    reg = side.metrics.MetricsRegistry()
    side.metrics.install(reg)
    side.chips.fatal_on_driver_unavailable(False)
    exp, service, ex_dev = _exporter_side(side)
    server = exp.serve(side.health_socket, service)
    kubelet = FakeKubelet(side.kubelet_dir)
    kubelet.start()
    out = {}
    try:
        with side.daemon() as (lister, heartbeat):
            assert kubelet.wait_for_registration()
            r = kubelet.registrations[0]
            stub, channel = kubelet.plugin_stub(r.endpoint)
            with channel:
                stream = stub.ListAndWatch(api_pb2.Empty())
                first = next(stream)
                out["ids"] = [d.ID for d in first.devices]
                out["first"] = [d.health for d in first.devices]

                def pulse():
                    heartbeat.put(True)
                    return [d.health for d in next(stream).devices]

                node = os.path.join(ex_dev, side.node_prefix + str(GONE))
                os.remove(node)
                out["down"] = [pulse() for _ in range(DOWN)]
                open(node, "w").close()
                out["up"] = [pulse() for _ in range(UP)]
                out["plugin_node_present"] = os.path.exists(os.path.join(
                    side.roots["dev_root"], side.node_prefix + str(GONE)))
                out["states"] = lister_states(lister)
                channel.close()
    finally:
        kubelet.stop()
        server.stop(grace=0).wait()
        side.metrics.uninstall()
        side.chips.fatal_on_driver_unavailable(True)
    return out


def lister_states(lister):
    """{health key: lifecycle state} of the lister's one plugin."""
    (plugin,) = lister._plugins_snapshot()
    return plugin.health_sm.states()


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_HEALTH_SOAK_S", "0")
    mp.setattr(binding, "_lib", None)
    mp.setattr(binding, "_load_attempted", True)
    try:
        return {name: drive(Side(name, str(tmp_path_factory.mktemp(name))))
                for name in ("ref", "port")}
    finally:
        mp.undo()


def _gone(out):
    return [h[GONE] for h in out["down"] + out["up"]]


def test_first_list_is_healthy_by_the_exporters_keys(transcripts):
    port = transcripts["port"]
    assert port["ids"] == [g["bdf"] for g in four_gpus()]
    assert port["first"] == ["Healthy"] * 4


def test_a_node_gone_from_the_exporter_demotes_the_device(transcripts):
    """Suspect at the first bad poll (still Healthy to the kubelet),
    Unhealthy at the third of the last five: dpm/healthsm.py's demote
    rule, though the plugin's own probe still opens the node."""
    port = transcripts["port"]
    assert port["plugin_node_present"]
    assert _gone(port)[:DOWN] == ["Healthy", "Healthy"] + ["Unhealthy"] * 4
    assert all(h[:GONE] == ["Healthy"] * GONE for h in port["down"])


def test_the_node_back_recovers_the_device(transcripts):
    """Three good polls to RECOVERING, the soak (0 s) at the fourth."""
    port = transcripts["port"]
    assert _gone(port)[DOWN:] == ["Unhealthy"] * 3 + ["Healthy"] * 3
    assert set(port["states"].values()) == {"HEALTHY"}


def test_transitions_equal_the_references_pair(transcripts):
    ref, port = transcripts["ref"], transcripts["port"]
    for key in ("first", "down", "up", "plugin_node_present"):
        assert port[key] == ref[key], key
    assert sorted(port["states"].values()) == sorted(ref["states"].values())


# -- the two commands ---------------------------------------------------------


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@contextlib.contextmanager
def _process(argv, log_path, env):
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", *argv], stdout=log,
                                stderr=subprocess.STDOUT, env=env)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_the_commands_pair_on_a_node(tmp_path):
    """The exporter's command on one copy of a four-GPU host, the
    plugin's with ``--health-socket`` at it and ``--pulse 1`` on
    another: a node gone from the exporter's copy shows Unhealthy on the
    kubelet's stream within 10 pulses and Healthy within 15 of its
    return; SIGTERM stops both with exit 0 and their sockets gone."""
    if binding.available():
        pytest.skip("this host's NVML would answer for its own GPUs")
    ex_roots = make_gpu_tree(str(tmp_path / "exporter-host"), four_gpus())
    dp_roots = make_gpu_tree(str(tmp_path / "plugin-host"), four_gpus())
    sock = str(tmp_path / "exporter" / "health.sock")
    kdir = tmp_path / "kubelet"
    kdir.mkdir()
    kubelet = FakeKubelet(str(kdir))
    kubelet.start()
    env = _env(TPU_HEALTH_SOAK_S="2")
    try:
        with _process(["k8s_device_plugin_tpu_torch.cmd.metrics_exporter",
                       "--socket", sock, "--sysfs-root", ex_roots[0],
                       "--dev-root", ex_roots[1], "--proc-root", ex_roots[2]],
                      tmp_path / "exporter.log", env) as exporter:
            deadline = time.time() + 30
            while not os.path.exists(sock) and time.time() < deadline:
                assert exporter.poll() is None, \
                    (tmp_path / "exporter.log").read_text()
                time.sleep(0.05)
            with _process(["k8s_device_plugin_tpu_torch.cmd.device_plugin",
                           "--kubelet-dir", str(kdir),
                           "--sysfs-root", dp_roots[0],
                           "--dev-root", dp_roots[1],
                           "--proc-root", dp_roots[2],
                           "--checkpoint-dir", str(tmp_path / "ckpt"),
                           "--health-socket", sock, "--pulse", "1",
                           "--driver-wait-seconds", "5"],
                          tmp_path / "plugin.log", env) as plugin:
                assert kubelet.wait_for_registration(timeout=30), \
                    (tmp_path / "plugin.log").read_text()
                reg = kubelet.registrations[0]
                stub, channel = kubelet.plugin_stub(reg.endpoint)
                with channel:
                    stream = stub.ListAndWatch(api_pb2.Empty())
                    first = next(stream)
                    gone = first.devices[GONE].ID
                    assert [d.health for d in first.devices] == \
                        ["Healthy"] * 4

                    def pulses_until(health, limit):
                        for n in range(1, limit + 1):
                            devs = {d.ID: d.health
                                    for d in next(stream).devices}
                            if devs[gone] == health:
                                return n, devs
                        raise AssertionError(
                            f"{gone} not {health} in {limit} pulses")

                    node = os.path.join(ex_roots[1], f"nvidia{GONE}")
                    os.remove(node)
                    n_down, devs = pulses_until("Unhealthy", 10)
                    assert n_down >= 3
                    assert sum(h == "Unhealthy" for h in devs.values()) == 1
                    open(node, "w").close()
                    n_up, devs = pulses_until("Healthy", 15)
                    assert n_up >= 4
                    assert set(devs.values()) == {"Healthy"}
                    plugin.send_signal(signal.SIGTERM)
                    assert plugin.wait(timeout=30) == 0, \
                        (tmp_path / "plugin.log").read_text()
                assert not (kdir / reg.endpoint).exists()
            exporter.send_signal(signal.SIGTERM)
            assert exporter.wait(timeout=30) == 0
            assert not os.path.exists(sock)
    finally:
        kubelet.stop()
