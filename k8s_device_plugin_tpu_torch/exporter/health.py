"""Per-chip health from the external TPU metrics exporter.

Behavioral mirror of the reference's exporter/health.go:

  - socket stat'ed before dialing; absence is a silent degrade
    (health.go:45-47)
  - connection is short-lived per poll — the exporter can come and go
    independently of the plugin (health.go:51-53)
  - 5s query timeout (health.go:37)
  - merge semantics: with the service up, per-device states override; any
    device the exporter doesn't know keeps the caller's default health
    (health.go:86-106)

Beyond the reference (ISSUE 4): poll failures follow the warn-once /
recovery-logged pattern with a ``tpu_plugin_health_poll_failures_total``
counter (a down exporter no longer log.errors on every heartbeat), the
``health.exporter_query`` fault point makes exporter flaps injectable,
and :func:`populate_per_tpu_health` optionally routes raw poll results
through the health lifecycle state machine (dpm/healthsm.py) so one bad
poll demotes to SUSPECT instead of evicting the device.

The exporter daemon itself (cmd/metrics_exporter.py) is first-party here —
there is no external TPU equivalent of amd-device-metrics-exporter to lean
on.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Iterable, Optional

import grpc

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api.metricssvc import metricssvc_pb2, metricssvc_grpc
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import faults

log = logging.getLogger(__name__)

DEFAULT_HEALTH_SOCKET = (
    "/var/lib/tpu-metrics-exporter/tpu_device_metrics_exporter_grpc.socket"
)
QUERY_TIMEOUT_S = 5.0

# Warn-once bookkeeping for poll failures (the runtime-poll precedent,
# exporter/runtime.py PollState): the heartbeat polls this every few
# seconds, and an exporter outage must cost one WARNING, not a log line
# per heartbeat. Module-level because every plugin instance in the
# daemon shares the one exporter socket.
_poll_lock = threading.Lock()
_poll_was_ok = True


def _c_poll_failures():
    return obs_metrics.counter(
        "tpu_plugin_health_poll_failures_total",
        "exporter health polls that returned no data, by reason",
        labels=("reason",),
    )


def _note_poll_failure(reason: str, socket_path: str, err: object) -> None:
    global _poll_was_ok
    with _poll_lock:
        first = _poll_was_ok
        _poll_was_ok = False
    _c_poll_failures().inc(reason=reason)
    if first:
        log.warning(
            "error getting health info from exporter at %s (%s); counting "
            "failures silently until it recovers", socket_path, err,
        )


def _note_poll_success() -> None:
    global _poll_was_ok
    with _poll_lock:
        recovered = not _poll_was_ok
        _poll_was_ok = True
    if recovered:
        log.info("exporter health polls recovered")


def get_tpu_health(
    socket_path: str = DEFAULT_HEALTH_SOCKET,
) -> Optional[Dict[str, str]]:
    """Device-id -> Healthy/Unhealthy from the exporter; None when the
    service is unavailable (socket absent, dial or RPC failure, or an
    injected ``health.exporter_query`` fault)."""
    if not os.path.exists(socket_path):
        return None
    try:
        faults.inject("health.exporter_query", socket=socket_path)
        with grpc.insecure_channel(f"unix://{socket_path}") as channel:
            stub = metricssvc_grpc.MetricsServiceStub(channel)
            resp = stub.List(metricssvc_pb2.Empty(), timeout=QUERY_TIMEOUT_S)
    except faults.FaultError as e:
        _note_poll_failure("fault", socket_path, e)
        return None
    except grpc.RpcError as e:
        _note_poll_failure("rpc_error", socket_path, e)
        return None
    _note_poll_success()
    out: Dict[str, str] = {}
    for state in resp.tpu_state:
        if state.health.lower() == constants.UNHEALTHY.lower():
            out[state.device] = constants.UNHEALTHY
        else:
            out[state.device] = constants.HEALTHY
    return out


def populate_per_tpu_health(
    devices: Iterable,
    default_health_fn,
    socket_path: str = DEFAULT_HEALTH_SOCKET,
    member_addrs_fn=None,
    state_machine=None,
) -> Optional[Dict[str, str]]:
    """Set .health on each api_pb2.Device — THE merge implementation, used
    by the plugin's heartbeat path and tested directly.

    ``default_health_fn(device_id) -> str`` supplies the fallback health
    (the reference passes its node-level simpleHealthCheck result; our
    plugin passes its per-device probe). ``member_addrs_fn(device_id) ->
    [pci_address, ...]`` maps a kubelet device onto the exporter's per-chip
    keys — identity for whole-chip devices, member expansion for partition
    devices (any member unhealthy -> device unhealthy).

    Without ``state_machine``, health is the instantaneous merge (the
    reference semantics) and the return value is None. With a
    ``dpm.healthsm.HealthStateMachine``, each member chip's raw poll is
    observed per-key (exporter-known members use the exporter value,
    unknown members fall back to the device default — so an exporter that
    knows only some partition members degrades per-member, not
    per-device), the device inherits the **worst member state**, and
    ``.health`` carries the kubelet projection of that state. Returns
    {device_id: lifecycle_state} for the caller's gauges.
    """
    from k8s_device_plugin_tpu_torch.dpm import healthsm

    health_map = get_tpu_health(socket_path)
    states: Optional[Dict[str, str]] = (
        {} if state_machine is not None else None
    )
    for dev in devices:
        if state_machine is None:
            if health_map is None:
                dev.health = default_health_fn(dev.ID)
                continue
            addrs = member_addrs_fn(dev.ID) if member_addrs_fn else [dev.ID]
            known = [health_map[a] for a in addrs if a in health_map]
            if constants.UNHEALTHY in known:
                dev.health = constants.UNHEALTHY
            elif addrs and len(known) == len(addrs):
                dev.health = constants.HEALTHY
            else:
                # Exporter doesn't know (all of) this device; fall back.
                dev.health = default_health_fn(dev.ID)
            continue

        addrs = member_addrs_fn(dev.ID) if member_addrs_fn else [dev.ID]
        if not addrs:
            # No resolvable member chips (hardware drift): track the
            # device itself; its default probe decides the raw signal.
            addrs = [dev.ID]
        default: Optional[str] = None
        member_states = []
        for addr in addrs:
            if health_map is not None and addr in health_map:
                raw_ok = health_map[addr] == constants.HEALTHY
            else:
                if default is None:
                    default = default_health_fn(dev.ID)
                raw_ok = default == constants.HEALTHY
            member_states.append(state_machine.observe(addr, raw_ok))
        state = healthsm.worst(member_states)
        states[dev.ID] = state
        dev.health = healthsm.kubelet_health(state)
    return states
