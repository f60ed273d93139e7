"""gpu-metrics-exporter: node-local per-GPU health/metrics daemon.

    python -m k8s_device_plugin_tpu_torch.cmd.metrics_exporter [flags]

The reference's tpu-metrics-exporter for NVIDIA GPUs. It serves the
metricssvc contract (api/metricssvc/metricssvc.proto) on a unix socket:
per-GPU health from the device-node open probe, refreshed on every RPC,
each state's ``device`` the GPU's kubelet id (``GPUChip.key``), so the
device plugin's ``--health-socket`` merge finds it. With ``--http-port``
it also serves Prometheus text on /metrics (the reference's family
names: health, temperature and PCIe link from sysfs or NVML, and with
``--runtime-metrics-addr nvml`` device memory used and total and GPU
utilisation from NVML) and /healthz. Deployed beside the device plugin;
both default to the same socket path.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
from concurrent import futures

import grpc

from k8s_device_plugin_tpu_torch.api.metricssvc import metricssvc_pb2, metricssvc_grpc
from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod
from k8s_device_plugin_tpu_torch.discovery import dev_functional
from k8s_device_plugin_tpu_torch.exporter.health import DEFAULT_HEALTH_SOCKET
from k8s_device_plugin_tpu_torch.version import git_describe

log = logging.getLogger("gpu-metrics-exporter")


class ChipHealthService(metricssvc_grpc.MetricsServiceServicer):
    def __init__(self, sysfs_root: str = "/sys", dev_root: str = "/dev",
                 proc_root: str = "/proc"):
        self._sysfs_root = sysfs_root
        self._dev_root = dev_root
        self._proc_root = proc_root

    def _chips(self):
        chips_mod.fatal_on_driver_unavailable(False)
        chips = chips_mod.get_gpu_chips(
            self._sysfs_root, self._dev_root, self._proc_root
        )
        return sorted(chips.values(), key=lambda c: c.index)

    def _states(self, only_ids=None):
        states = []
        for chip in self._chips():
            if only_ids and chip.key not in only_ids:
                continue
            healthy = dev_functional(chip)
            states.append(
                metricssvc_pb2.TPUState(
                    id=str(chip.index),
                    health="healthy" if healthy else "unhealthy",
                    device=chip.key,
                )
            )
        return states

    def List(self, request, context):
        return metricssvc_pb2.TPUStateResponse(tpu_state=self._states())

    def GetTPUState(self, request, context):
        return metricssvc_pb2.TPUStateResponse(
            tpu_state=self._states(only_ids=set(request.id))
        )


def serve_http_metrics(service: ChipHealthService, port: int,
                       bind_addr: str = "0.0.0.0",
                       runtime_metrics_addr: str = ""):
    """Prometheus-format scrape endpoint (GET /metrics + /healthz).

    Served through the shared obs endpoint (obs/http.py), so the body is
    the process-wide registry (control-plane/serving series recorded in
    this process) followed by the per-scrape GPU families below. With
    ``runtime_metrics_addr`` set (``nvml``), each scrape also reads
    device memory used and total and GPU utilisation from NVML
    (exporter/runtime.py; an absent NVML degrades silently and is
    counted/timestamped by its poll state).
    """
    from k8s_device_plugin_tpu_torch.obs import http as obs_http

    def health_doc():
        chips = service._chips()
        return {
            "chips": len(chips),
            "healthy": sum(1 for c in chips if dev_functional(c)),
        }

    return obs_http.start_metrics_server(
        port, bind_addr,
        extra_text_fn=lambda: chip_metric_text(
            service, runtime_metrics_addr
        ),
        health_fn=health_doc,
    )


def chip_metric_text(service: ChipHealthService,
                     runtime_metrics_addr: str = "") -> str:
    """The hand-rolled per-GPU families (health, temperature and PCIe
    link, NVML runtime gauges) under the reference's names and label
    keys, rendered fresh per scrape; registry-backed series are
    concatenated ahead of them by the shared endpoint."""
    from k8s_device_plugin_tpu_torch.exporter.telemetry import (
        read_chip_telemetry,
    )

    chips = service._chips()
    lines = [
        "# HELP tpu_chip_health 1 when the GPU's device node is openable",
        "# TYPE tpu_chip_health gauge",
    ]
    telem = []
    for c in chips:
        labels = f'device="{c.key}",chip="{c.index}"'
        lines.append(
            f"tpu_chip_health{{{labels}}} "
            f"{1 if dev_functional(c) else 0}"
        )
        telem.append(
            (labels, read_chip_telemetry(c, service._sysfs_root))
        )
    # Telemetry from sysfs (hwmon, PCI link attrs) or NVML; GPUs that
    # give neither emit no sample.
    temps = [(lb, t) for lb, t in telem if t.temp_c is not None]
    if temps:
        lines += [
            "# HELP tpu_chip_temp_celsius hottest hwmon sensor, else "
            "the GPU die (NVML)",
            "# TYPE tpu_chip_temp_celsius gauge",
        ]
        lines += [
            f"tpu_chip_temp_celsius{{{lb}}} {t.temp_c:g}"
            for lb, t in temps
        ]
    links = [
        (lb, t) for lb, t in telem if t.link_speed_gts is not None
    ]
    if links:
        lines += [
            "# HELP tpu_chip_pcie_link_speed_gts negotiated PCIe speed",
            "# TYPE tpu_chip_pcie_link_speed_gts gauge",
        ]
        lines += [
            f"tpu_chip_pcie_link_speed_gts{{{lb}}} {t.link_speed_gts:g}"
            for lb, t in links
        ]
    widths = [
        (lb, t) for lb, t in telem if t.link_width is not None
    ]
    if widths:
        lines += [
            "# HELP tpu_chip_pcie_link_width negotiated PCIe lanes",
            "# TYPE tpu_chip_pcie_link_width gauge",
        ]
        lines += [
            f"tpu_chip_pcie_link_width{{{lb}}} {t.link_width}"
            for lb, t in widths
        ]
    if runtime_metrics_addr:
        from k8s_device_plugin_tpu_torch.exporter.runtime import (
            poll_state,
            read_runtime_metrics,
        )

        runtime = read_runtime_metrics(runtime_metrics_addr)
        # Staleness of the runtime gauges: seconds since the oldest
        # per-gauge success, so a dead NVML shows as a climbing gauge,
        # not silently-missing families.
        stale = poll_state().staleness_s()
        if stale is not None:
            lines += [
                "# HELP tpu_exporter_runtime_staleness_seconds seconds "
                "since the oldest successful runtime-metrics read",
                "# TYPE tpu_exporter_runtime_staleness_seconds gauge",
                f"tpu_exporter_runtime_staleness_seconds {stale:.3f}",
            ]
        if runtime is not None and runtime.accelerators:
            for metric, attr, help_text in (
                ("tpu_hbm_usage_bytes", "hbm_usage_bytes",
                 "device memory in use (NVML)"),
                ("tpu_hbm_total_bytes", "hbm_total_bytes",
                 "device memory capacity (NVML)"),
                ("tpu_tensorcore_duty_cycle_percent",
                 "duty_cycle_pct",
                 "share of the last sample period a kernel ran (NVML "
                 "utilization.gpu)"),
            ):
                samples = [
                    (dev, getattr(acc, attr))
                    for dev, acc in sorted(runtime.accelerators.items())
                    if getattr(acc, attr) is not None
                ]
                if samples:
                    lines += [
                        f"# HELP {metric} {help_text}",
                        f"# TYPE {metric} gauge",
                    ]
                    lines += [
                        # repr keeps byte counts exact ('%g' would
                        # round 80 GiB to 6 significant digits)
                        f'{metric}{{accelerator="{dev}"}} '
                        f"{float(val)!r}"
                        for dev, val in samples
                    ]
    lines += [
        "# HELP tpu_chip_count GPUs discovered on this host",
        "# TYPE tpu_chip_count gauge",
        f"tpu_chip_count {len(chips)}",
        "",
    ]
    return "\n".join(lines)


def start_chip_poll_watchdog(service: ChipHealthService,
                             stop: threading.Event,
                             interval_s: float = 10.0) -> threading.Thread:
    """Self-paced GPU enumeration loop behind the daemon watchdog.

    The exporter's real work is scrape-driven, so by itself it has no
    loop whose death a probe could see, and a wedged discovery pass (a
    hung NVML call or device node) would leave /healthz answering 200
    from a daemon that can no longer enumerate GPUs. This loop does one
    discovery pass per interval and beats only after the pass returns:
    a hang stops the beats, the watchdog marks the loop stalled, and
    /healthz (obs/http.py) flips to 503 while /metrics stays up.
    """
    from k8s_device_plugin_tpu_torch.utils import watchdog

    hb = watchdog.register(
        "exporter.chips_poll", stall_after_s=max(60.0, 6.0 * interval_s)
    )

    def poll():
        while not stop.is_set():
            try:
                service._chips()
            except Exception as e:
                # Discovery errors degrade (zero GPUs) but the loop is
                # alive — liveness and health are different questions.
                log.warning("GPU poll failed: %s", e)
            hb.beat()
            stop.wait(interval_s)
        hb.close()

    thread = threading.Thread(target=poll, name="chips-poll", daemon=True)
    thread.start()
    return thread


def serve(socket_path: str, service: ChipHealthService) -> grpc.Server:
    os.makedirs(os.path.dirname(socket_path), exist_ok=True)
    if os.path.exists(socket_path):
        os.remove(socket_path)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    metricssvc_grpc.add_MetricsServiceServicer_to_server(service, server)
    server.add_insecure_port(f"unix://{socket_path}")
    server.start()
    log.info("serving GPU health on %s", socket_path)
    return server


def build_arg_parser() -> argparse.ArgumentParser:
    from k8s_device_plugin_tpu_torch.exporter.runtime import NVML_ADDR

    p = argparse.ArgumentParser(prog="gpu-metrics-exporter")
    p.add_argument("--socket", default=DEFAULT_HEALTH_SOCKET)
    p.add_argument("--sysfs-root", default="/sys")
    p.add_argument("--dev-root", default="/dev")
    p.add_argument(
        "--proc-root", default="/proc",
        help="procfs root holding driver/nvidia (GPU discovery without NVML)",
    )
    p.add_argument(
        "--http-port", type=int, default=0,
        help="serve Prometheus-format metrics on this port (0 disables)",
    )
    p.add_argument(
        "--http-addr", default="0.0.0.0",
        help="bind address for the metrics endpoint (e.g. 127.0.0.1 to "
        "restrict to the host)",
    )
    p.add_argument(
        "--runtime-metrics-addr", default="",
        help=f"source of the device-memory and utilisation gauges: "
        f"{NVML_ADDR!r} (the driver's NVML); empty disables",
    )
    p.add_argument(
        "--poll-interval", type=float, default=10.0,
        help="seconds between the watchdog's self-paced GPU-discovery "
        "passes (liveness for /healthz)",
    )
    from k8s_device_plugin_tpu_torch.utils.configfile import add_config_flag

    add_config_flag(p)
    return p


def main(argv=None) -> int:
    from k8s_device_plugin_tpu_torch.exporter.runtime import NVML_ADDR
    from k8s_device_plugin_tpu_torch.utils.configfile import parse_daemon_args

    args = parse_daemon_args(build_arg_parser(), argv, "gpu-metrics-exporter")
    if args is None:
        return 1
    if args.runtime_metrics_addr not in ("", NVML_ADDR):
        print(f"gpu-metrics-exporter: --runtime-metrics-addr "
              f"{args.runtime_metrics_addr!r}: the GPU exporter reads "
              f"{NVML_ADDR!r} (the driver's NVML) or nothing (''); libtpu's "
              "runtime-metrics service has no GPU counterpart",
              file=sys.stderr)
        return 1
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    log.info("GPU metrics exporter version %s", git_describe())

    # The process-wide registry: scrape counters, runtime-poll failure
    # series, and anything else this process records land on /metrics.
    from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.install()

    service = ChipHealthService(args.sysfs_root, args.dev_root, args.proc_root)
    server = serve(args.socket, service)
    httpd = (
        serve_http_metrics(service, args.http_port, args.http_addr,
                           runtime_metrics_addr=args.runtime_metrics_addr)
        if args.http_port else None
    )
    stop = threading.Event()
    start_chip_poll_watchdog(service, stop, args.poll_interval)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    if httpd is not None:
        httpd.shutdown()
    server.stop(grace=1).wait()
    try:
        os.remove(args.socket)
    except OSError:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
