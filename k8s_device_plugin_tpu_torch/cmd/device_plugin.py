"""gpu-device-plugin daemon entry point.

    python -m k8s_device_plugin_tpu_torch.cmd.device_plugin [flags]

The reference's tpu-device-plugin (itself the Go reference's
cmd/k8s-device-plugin/main.go) for NVIDIA GPUs: version banner with the
driver version NVML reports (the hwloc.GetVersions analogue,
main.go:94-98), -pulse heartbeat ticker (main.go:129-137), wait for the
GPU driver to appear (the /sys/class/kfd wait, main.go:139-152),
resource-list computation, then the dpm manager loop (main.go:153). It
advertises ``nvidia.com/gpu``.

The reference's flags for the parts not ported yet (the pod-resources
reconcile, node remediation and its informers, partitions) are refused
with a message naming ROADMAP A10, not accepted and ignored.
"""

from __future__ import annotations

import argparse
import logging
import os
import queue
import sys
import threading
import time

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.dpm import Manager
from k8s_device_plugin_tpu_torch.plugin import GPULister, PluginConfig, parse_strategy
from k8s_device_plugin_tpu_torch.plugin.resource_naming import StrategyError
from k8s_device_plugin_tpu_torch.version import git_describe

log = logging.getLogger("gpu-device-plugin")

# The reference's flags this slice does not serve: each names what it
# belongs to. Given on the command line or in --config, they stop the
# daemon before it starts.
REFUSED_FLAGS = {
    "--podresources-socket": "the pod-resources reconcile",
    "--node-name": "node remediation",
    "--api-server": "node remediation and its informers",
    "--drain-deadline": "node remediation",
    "--partition": "MIG partitions (the mixed strategy)",
}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpu-device-plugin",
        description="Kubernetes device plugin for NVIDIA GPUs (nvidia.com/gpu)",
    )
    p.add_argument(
        "--pulse", type=int, default=0,
        help="seconds between health polls; 0 disables the heartbeat",
    )
    p.add_argument(
        "--resource-naming-strategy", default="single",
        help="single (mixed needs MIG, not served yet)",
    )
    p.add_argument("--sysfs-root", default="/sys")
    p.add_argument("--dev-root", default="/dev")
    p.add_argument(
        "--proc-root", default="/proc",
        help="procfs root holding driver/nvidia (GPU discovery without NVML)",
    )
    p.add_argument(
        "--cdi-spec-dir", default=None,
        help="write a CDI spec here and emit CDI device names in Allocate "
        "responses (e.g. /var/run/cdi); unset disables CDI",
    )
    p.add_argument(
        "--health-socket", default=None,
        help="unix socket of the metrics exporter for per-GPU health "
        "(default: its well-known path; absent socket degrades to local probes)",
    )
    from k8s_device_plugin_tpu_torch.dpm import checkpoint as ckpt_mod

    p.add_argument(
        "--checkpoint-dir", default=ckpt_mod.default_checkpoint_dir(),
        help="directory for the crash-safe allocation/health checkpoint "
        "(default: $TPU_CHECKPOINT_DIR or "
        f"{ckpt_mod.DEFAULT_CHECKPOINT_DIR}; empty string disables)",
    )
    p.add_argument(
        "--kubelet-dir", default=constants.DEVICE_PLUGIN_PATH,
        help="kubelet device-plugin socket directory",
    )
    p.add_argument(
        "--driver-wait-seconds", type=float, default=0.0,
        help="wait up to this long for the GPU driver to appear before "
        "advertising resources (0 = wait forever, checking each second)",
    )
    p.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve this daemon's control-plane metrics (allocate "
        "latency, health transitions, ...) + watchdog-backed /healthz "
        "on this HTTP port (0 disables)",
    )
    p.add_argument(
        "--metrics-addr", default="0.0.0.0",
        help="bind address for --metrics-port",
    )
    for flag, what in REFUSED_FLAGS.items():
        p.add_argument(
            flag, default=None,
            help=f"refused: {what} is not ported yet (ROADMAP A10)",
        )
    p.add_argument("-v", "--verbose", action="count", default=0)
    from k8s_device_plugin_tpu_torch.utils.configfile import add_config_flag

    add_config_flag(p)
    return p


def refused_flags(args) -> list:
    """The refused flags that ``args`` sets (command line or config)."""
    return [flag for flag in REFUSED_FLAGS
            if getattr(args, flag[2:].replace("-", "_")) is not None]


def driver_present(sysfs_root: str, proc_root: str) -> bool:
    """GPU analogue of the reference's /sys/class/kfd existence check:
    the driver's ``/proc/driver/nvidia/version``, a PCI function of
    vendor 0x10de, or NVML answering (a container runtime that
    virtualises the GPU may show neither of the first two)."""
    if os.path.exists(os.path.join(proc_root, "driver", "nvidia", "version")):
        return True
    from k8s_device_plugin_tpu_torch.discovery.chips import NVIDIA_VENDOR_ID
    from k8s_device_plugin_tpu_torch.utils import sysfs as sysfs_util

    devices = os.path.join(sysfs_root, "bus", "pci", "devices")
    for addr in sysfs_util.list_dir(devices):
        if sysfs_util.read_hex(os.path.join(devices, addr, "vendor")) \
                == NVIDIA_VENDOR_ID:
            return True
    from k8s_device_plugin_tpu_torch.native import binding

    return binding.available()


def main(argv=None) -> int:
    from k8s_device_plugin_tpu_torch.utils.configfile import parse_daemon_args

    args = parse_daemon_args(build_arg_parser(), argv, "gpu-device-plugin")
    if args is None:
        return 1
    refused = refused_flags(args)
    if refused:
        print(f"gpu-device-plugin: {', '.join(refused)}: not served by the "
              "GPU device plugin yet ("
              + "; ".join(REFUSED_FLAGS[f] for f in refused)
              + " is ROADMAP A10's second half)", file=sys.stderr)
        return 1
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s",
    )
    try:
        strategy = parse_strategy(args.resource_naming_strategy)
    except StrategyError as e:
        log.error("%s", e)
        return 1

    from k8s_device_plugin_tpu_torch.native import binding
    from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

    # Install the registry unconditionally: instrumented layers (plugin,
    # dpm, allocator) record from startup, and the optional HTTP endpoint
    # exposes them.
    obs_metrics.install()
    if args.metrics_port:
        from k8s_device_plugin_tpu_torch.obs import http as obs_http

        obs_http.start_metrics_server(args.metrics_port, args.metrics_addr)

    log.info("NVIDIA GPU device plugin for Kubernetes")
    log.info("%s version %s", sys.argv[0], git_describe())
    driver = binding.version()
    log.info("NVML: %s", f"driver {driver}" if driver else "NVML unavailable")

    config = PluginConfig(
        sysfs_root=args.sysfs_root,
        dev_root=args.dev_root,
        proc_root=args.proc_root,
        device_plugin_dir=args.kubelet_dir,
        health_socket=args.health_socket,
        cdi_spec_dir=args.cdi_spec_dir,
        checkpoint_dir=args.checkpoint_dir or None,
    )
    # Bounded: with no ListAndWatch consumer (kubelet down) beats must be
    # dropped, not accumulated — an unbounded queue would replay the whole
    # backlog as a burst of device-list re-sends on reconnect.
    heartbeat: "queue.Queue" = queue.Queue(maxsize=1)
    lister = GPULister(config=config, heartbeat=heartbeat, strategy=strategy)
    manager = Manager(lister, device_plugin_dir=args.kubelet_dir)

    from k8s_device_plugin_tpu_torch.utils import watchdog

    if args.pulse > 0:
        def beat():
            log.info("heart beating every %d seconds (jittered)", args.pulse)
            # Watchdog liveness: a wedged pulse loop flips /healthz to
            # 503 so the kubelet's liveness probe restarts the daemon.
            hb = watchdog.register(
                "dpm.heartbeat", stall_after_s=max(30.0, 3.0 * args.pulse)
            )
            # Full-jitter pacing: N nodes restarting together must not
            # flush checkpoints in lockstep forever (utils/retry.Pacer).
            from k8s_device_plugin_tpu_torch.utils import retry as retrylib

            pacer = retrylib.Pacer(float(args.pulse))
            time.sleep(pacer.first_delay())
            while True:
                try:
                    heartbeat.put_nowait(True)
                except queue.Full:
                    pass  # no consumer; drop the beat
                hb.beat()
                time.sleep(pacer.next_delay())

        threading.Thread(target=beat, name="heartbeat", daemon=True).start()

    def discover_when_ready():
        deadline = (
            time.monotonic() + args.driver_wait_seconds
            if args.driver_wait_seconds > 0 else None
        )
        while not driver_present(args.sysfs_root, args.proc_root):
            if deadline and time.monotonic() > deadline:
                log.error("GPU driver did not appear; advertising nothing")
                return
            time.sleep(1)
        try:
            resources = lister.compute_resources()
        except StrategyError as e:
            log.error("%s", e)
            os._exit(1)
        except Exception as e:
            log.error("resource discovery failed: %s", e)
            os._exit(2)  # the reference's glog.Fatalf driver-missing exit code
        if args.cdi_spec_dir:
            from k8s_device_plugin_tpu_torch.plugin import cdi

            # Drop spec files from a previous strategy before the plugins
            # write fresh ones.
            cdi.cleanup_stale_specs(args.cdi_spec_dir, resources)
        if resources:
            lister.resource_updates.put(resources)
        else:
            log.warning("no GPU resources found on this host")

    threading.Thread(
        target=discover_when_ready, name="driver-wait", daemon=True
    ).start()

    manager.run()
    shutdown_cleanup(lister, args.kubelet_dir)
    return 0


def shutdown_cleanup(lister, kubelet_dir: str) -> None:
    """SIGTERM teardown. The manager already stopped every plugin (each
    stop() flushes its checkpoint and each server unlinks its own
    socket); this pass is the belt for the crash-adjacent cases — a
    plugin that never started a server, or a socket left by an earlier
    incarnation — so a restarting kubelet never dials a dead socket and
    the checkpoint always carries the final health snapshot.
    """
    import glob

    for plugin in lister.plugins.values():
        try:
            if not plugin.flush_checkpoint():
                log.warning(
                    "final checkpoint flush failed for %s", plugin.resource
                )
        except Exception as e:
            log.error("final checkpoint flush for %s raised: %s",
                      plugin.resource, e)
    for sock in glob.glob(os.path.join(
        kubelet_dir, f"{constants.RESOURCE_NAMESPACE}_*"
    )):
        try:
            os.remove(sock)
            log.info("removed plugin socket %s on shutdown", sock)
        except OSError as e:
            log.warning("cannot remove plugin socket %s: %s", sock, e)


if __name__ == "__main__":
    sys.exit(main())
