"""GPUDevicePlugin: the 5 kubelet RPCs + GPULister.

The reference's TPUDevicePlugin/TPULister (counterparts of the Go
reference's AMDGPUPlugin/AMDGPULister, plugin.go) for NVIDIA GPUs. Key
behavioral parity points, each tagged with the Go reference's location:

  - start() initialises the allocator; on failure the plugin degrades to
    kubelet-default packing (plugin.go:82-91,210-217)
  - ListAndWatch re-scans hardware on stream open, advertises devices with
    NUMA TopologyInfo, streams health updates on heartbeat, and exits the
    process when the kubelet stream dies so the DaemonSet restart
    re-registers us (plugin.go:229-334)
  - GetPreferredAllocation delegates to the policy (plugin.go:341-355)
  - Allocate maps device nodes into the container (plugin.go:360-397) and
    sets NVIDIA_VISIBLE_DEVICES / CUDA_VISIBLE_DEVICES to the allotted
    GPUs' UUIDs (plugin/allocation.py, importable without gRPC)
  - PreStartContainer is a no-op (plugin.go:222-224)

Where the reference mounts /dev/accel<N>, a GPU allocation mounts
/dev/nvidia<minor> and the control nodes (/dev/nvidiactl, /dev/nvidia-uvm,
/dev/nvidia-uvm-tools). The reference's gang reservations, multi-host
slice env, pod-resources reconcile and node drain hooks are not ported
yet (ROADMAP A10).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import grpc

from k8s_device_plugin_tpu_torch.allocator import (
    AllocationError,
    BestEffortPolicy,
    Device,
    devices_from_chips,
)
from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api.deviceplugin.v1beta1 import api_pb2, api_grpc
from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod
from k8s_device_plugin_tpu_torch.discovery import dev_functional
from k8s_device_plugin_tpu_torch.discovery.topology import GPUTopology, gpu_topology
from k8s_device_plugin_tpu_torch.dpm import checkpoint as ckpt_mod
from k8s_device_plugin_tpu_torch.dpm import healthsm
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace
from k8s_device_plugin_tpu_torch.plugin import allocation
from k8s_device_plugin_tpu_torch.plugin.config import PluginConfig
from k8s_device_plugin_tpu_torch.plugin.resource_naming import (
    Strategy,
    get_resource_list,
)

log = logging.getLogger(__name__)


class GPUDevicePlugin(api_grpc.DevicePluginServicer):
    def __init__(
        self,
        resource: str,
        config: Optional[PluginConfig] = None,
        heartbeat: Optional["queue.Queue"] = None,
        policy: Optional[object] = None,
        health_fn: Optional[Callable[[Device], str]] = None,
        health_sm: Optional[healthsm.HealthStateMachine] = None,
    ):
        self.resource = resource
        self.config = config or PluginConfig()
        self.heartbeat = heartbeat
        self.policy = policy if policy is not None else BestEffortPolicy()
        self.allocator_init_error = False
        self._stop_event = threading.Event()
        # Health lifecycle state machine (dpm/healthsm.py): raw exporter/
        # probe polls feed it per member chip; the kubelet sees only its
        # projection (SUSPECT still schedules, QUARANTINED never does).
        self.health_sm = health_sm or healthsm.HealthStateMachine(
            healthsm.HealthConfig.from_env()
        )
        if self.health_sm.on_transition is None:
            self.health_sm.on_transition = self._on_sm_transition
        # Crash-safe allocation checkpoint (dpm/checkpoint.py). None when
        # the config doesn't name a directory (unit tests, degraded ops);
        # then allocation state is memory-only.
        self._ckpt: Optional[ckpt_mod.CheckpointStore] = None
        if self.config.checkpoint_dir:
            self._ckpt = ckpt_mod.CheckpointStore(os.path.join(
                self.config.checkpoint_dir, f"{resource}-checkpoint.json"
            ))
        # alloc_id -> {"devices": [...], "envs": {...}, "created_at": ...};
        # device id -> alloc_id. Restored from the checkpoint on start().
        self._allocations: Dict[str, dict] = {}
        self._device_owner: Dict[str, str] = {}
        self._alloc_lock = threading.Lock()
        # device id -> allocator Device, refreshed on every ListAndWatch
        # open like the reference's p.AMDGPUs re-scan.
        self._devices: Dict[str, Device] = {}
        self._chips: Dict[str, chips_mod.GPUChip] = {}
        self._chips_by_mesh: Dict[int, chips_mod.GPUChip] = {}
        self._topo: Optional[GPUTopology] = None
        self._cdi_spec_written = False
        # Injectable per-device health (the exporter merge point, Task:
        # exporter/health.py); default probes device nodes directly.
        self._health_fn = health_fn or self._default_health
        # Last advertised health per device id, so heartbeat updates can
        # count actual transitions rather than steady-state re-sends.
        self._last_health: Dict[str, str] = {}
        # Device ids whose lifecycle gauges were published last
        # heartbeat: a device that disappears on re-scan must have its
        # per-device series removed, not frozen at the last state.
        self._gauge_devices: frozenset = frozenset()

    # -- dpm optional hooks (dpm/plugin.go:26-37 analogue) -------------------

    def start(self) -> None:
        # Re-arm after a previous orderly stop (kubelet restart cycle).
        self._stop_event.clear()
        self._refresh_devices()
        try:
            self.policy.init(list(self._devices.values()), self._topo)
        except AllocationError as e:
            log.error(
                "allocator init failed; falling back to kubelet default "
                "allocation: %s", e,
            )
            self.allocator_init_error = True  # tpulint: shared-init (start() precedes serving)
        self._restore_checkpoint()

    def stop(self) -> None:
        self._stop_event.set()
        # Orderly shutdown persists the latest health lifecycle snapshot
        # alongside the allocations (SIGTERM).
        self.flush_checkpoint()

    # -- checkpoint plumbing (dpm/checkpoint.py) -----------------------------

    def flush_checkpoint(self) -> bool:
        """Persist allocations + health lifecycle now; True on success
        (or when checkpointing is disabled)."""
        if self._ckpt is None:
            return True
        # Snapshot the health SM before taking _alloc_lock: the machine
        # has its own lock (the heartbeat thread observes concurrently),
        # and nesting it under _alloc_lock would impose a cross-subsystem
        # lock order for no atomicity gain — health and allocations
        # advance independently between flushes anyway.
        health = self.health_sm.snapshot()
        with self._alloc_lock:
            allocations = {
                # "restored" is process-lifetime bookkeeping, not state:
                # whatever is loaded from disk is restored by definition.
                a: {k: v for k, v in rec.items() if k != "restored"}
                for a, rec in self._allocations.items()
            }
        return self._ckpt.save({
            "resource": self.resource,
            "allocations": allocations,
            "health": health,
        })

    def _restore_checkpoint(self) -> None:
        if self._ckpt is None:
            return
        payload = self._ckpt.load()
        if payload is None:
            return
        self.health_sm.restore(payload.get("health") or {})
        restored: Dict[str, dict] = {}
        owner: Dict[str, str] = {}
        for alloc_id, rec in (payload.get("allocations") or {}).items():
            devices = [str(d) for d in rec.get("devices", [])]
            known = [d for d in devices if d in self._devices]
            if not known:
                log.warning(
                    "dropping checkpointed allocation %s: none of its "
                    "devices (%s) exist after rescan", alloc_id,
                    ", ".join(devices) or "<none>",
                )
                continue
            if len(known) < len(devices):
                log.warning(
                    "checkpointed allocation %s lost devices across the "
                    "restart: %s", alloc_id,
                    ", ".join(sorted(set(devices) - set(known))),
                )
            conflicts = [d for d in known if d in owner]
            if conflicts:
                log.error(
                    "checkpointed allocation %s overlaps %s on %s; "
                    "keeping the earlier record", alloc_id,
                    owner[conflicts[0]], ", ".join(conflicts),
                )
                continue
            restored[alloc_id] = {
                "devices": sorted(known),
                "envs": dict(rec.get("envs") or {}),
                "created_at": rec.get("created_at"),
                # Provisional until the kubelet vouches for it — via an
                # exact Allocate replay (the pod-resources reconciliation
                # is not ported yet, ROADMAP A10). Only provisional
                # records can veto a grant in _check_double_assign.
                "restored": True,
            }
            for d in known:
                owner[d] = alloc_id
        with self._alloc_lock:
            self._allocations = restored
            self._device_owner = owner
        quarantined = self.health_sm.quarantined()
        log.info(
            "restored checkpoint for %s: %d allocation(s) over %d "
            "device(s), %d quarantined device key(s)%s",
            self.resource, len(restored), len(owner), len(quarantined),
            f" ({', '.join(quarantined)})" if quarantined else "",
        )

    def release_allocation(self, alloc_id: str) -> bool:
        """Drop one recorded allocation (operator/eviction path) and
        persist. Returns False for an unknown id."""
        with self._alloc_lock:
            rec = self._allocations.pop(alloc_id, None)
            if rec is not None:
                for d in rec.get("devices", []):
                    if self._device_owner.get(d) == alloc_id:
                        del self._device_owner[d]
        if rec is None:
            return False
        self._count_releases("operator", 1)
        self.flush_checkpoint()
        return True

    def _count_releases(self, reason: str, n: int) -> None:
        obs_metrics.counter(
            "tpu_plugin_allocation_releases_total",
            "allocation records released (dropped or trimmed), by cause",
            labels=("resource", "reason"),
        ).inc(n, resource=self.resource, reason=reason)

    # -- discovery plumbing --------------------------------------------------

    def _refresh_devices(self) -> None:
        cfg = self.config
        chips = chips_mod.get_gpu_chips(
            cfg.sysfs_root, cfg.dev_root, cfg.proc_root
        )
        self._chips = chips
        chip_list = sorted(chips.values(), key=lambda c: c.index)
        self._chips_by_mesh = {
            (c.mesh_index if c.mesh_index >= 0 else c.index): c
            for c in chip_list
        }
        self._topo = gpu_topology(chip_list, cfg.sysfs_root)
        devices = devices_from_chips(chip_list)
        self._devices = {d.id: d for d in devices}
        obs_metrics.gauge(
            "tpu_plugin_devices_count",
            "devices advertised to the kubelet for this resource",
            labels=("resource",),
        ).set(len(self._devices), resource=self.resource)
        log.info(
            "resource %s: %d devices (%s)",
            self.resource, len(self._devices), ", ".join(self._devices),
        )
        if self.config.cdi_spec_dir:
            self._write_cdi_spec()

    def _write_cdi_spec(self) -> None:
        from k8s_device_plugin_tpu_torch.plugin import cdi

        paths = {
            d.id: [
                p
                for chip in self._chips_of(d)
                for p in chip.device_spec_paths
            ]
            for d in self._devices.values()
        }
        try:
            cdi.write_spec(
                cdi.build_spec(paths), self.config.cdi_spec_dir,
                resource=self.resource,
            )
            self._cdi_spec_written = True
        except OSError as e:
            # Emitting CDI names without a spec on disk would make every
            # allocation fail on CDI-aware runtimes; Allocate checks this.
            self._cdi_spec_written = False
            log.error("cannot write CDI spec: %s", e)

    def _chips_of(self, device: Device) -> List[chips_mod.GPUChip]:
        # _chips_by_mesh is rebuilt on every _refresh_devices; this runs per
        # device on every heartbeat and Allocate, so it must not rebuild.
        return [
            self._chips_by_mesh[i]
            for i in device.chip_indices
            if i in self._chips_by_mesh
        ]

    def _default_health(self, device: Device) -> str:
        chips = self._chips_of(device)
        if chips and all(dev_functional(c) for c in chips):
            return constants.HEALTHY
        return constants.UNHEALTHY

    def _device_list(self, with_health: bool = False) -> List[api_pb2.Device]:
        out = []
        for dev in sorted(self._devices.values(), key=lambda d: d.index):
            msg = api_pb2.Device(ID=dev.id, health=constants.HEALTHY)
            if dev.numa_node >= 0:
                msg.topology.CopyFrom(
                    api_pb2.TopologyInfo(
                        nodes=[api_pb2.NUMANode(ID=dev.numa_node)]
                    )
                )
            out.append(msg)
        if with_health:
            # Exporter-supplied per-GPU health overrides; local device
            # probes fill the gaps (the reference's merge semantics,
            # health.go:86-106, with a per-device rather than node-level
            # default). The exporter keys on device ids (PCI addresses).
            from k8s_device_plugin_tpu_torch.exporter import health as exporter_health

            def default_health(device_id: str) -> str:
                d = self._devices.get(device_id)
                return self._health_fn(d) if d is not None else constants.UNHEALTHY

            def member_addrs(device_id: str):
                d = self._devices.get(device_id)
                if d is None:
                    return []
                return [c.key for c in self._chips_of(d)]

            states = exporter_health.populate_per_tpu_health(
                out,
                default_health,
                self.config.health_socket or exporter_health.DEFAULT_HEALTH_SOCKET,
                member_addrs_fn=member_addrs,
                state_machine=self.health_sm,
            )
            self._record_health_transitions(out)
            self._publish_health_gauges(states or {})
        return out

    def _publish_health_gauges(self, states: Dict[str, str]) -> None:
        """Per-device lifecycle gauges + the allocated/idle unhealthy
        split (an unhealthy chip under a running pod is page-worthy; an
        idle one is capacity news)."""
        state_gauge = obs_metrics.gauge(
            "tpu_plugin_health_state_count",
            "current health lifecycle state per device (1 = in state)",
            labels=("resource", "device", "state"),
        )
        unhealthy_gauge = obs_metrics.gauge(
            "tpu_plugin_unhealthy_devices_count",
            "devices advertised Unhealthy, split by allocation status",
            labels=("resource", "allocated"),
        )
        counts = {"true": 0, "false": 0}
        with self._alloc_lock:
            owned = set(self._device_owner)
        for device_id, state in states.items():
            for s in healthsm.ALL_STATES:
                state_gauge.set(
                    1 if s == state else 0,
                    resource=self.resource, device=device_id, state=s,
                )
            if healthsm.kubelet_health(state) == constants.UNHEALTHY:
                counts["true" if device_id in owned else "false"] += 1
        # A device gone from the re-scan (a GPU fallen off the bus) must drop off the dashboard, not keep reporting its
        # last state as a phantom.
        for device_id in self._gauge_devices - set(states):
            for s in healthsm.ALL_STATES:
                state_gauge.remove(
                    resource=self.resource, device=device_id, state=s,
                )
        self._gauge_devices = frozenset(states)
        for allocated, n in counts.items():
            unhealthy_gauge.set(
                n, resource=self.resource, allocated=allocated
            )

    def _on_sm_transition(self, key: str, frm: str, to: str,
                          now: float) -> None:
        obs_metrics.counter(
            "tpu_plugin_health_sm_transitions_total",
            "health lifecycle state-machine transitions",
            labels=("resource", "key", "frm", "to"),
        ).inc(resource=self.resource, key=key, frm=frm, to=to)
        obs_trace.event(
            "plugin.health_sm", "transition", resource=self.resource,
            key=key, frm=frm, to=to,
        )

    def _record_health_transitions(self, devices: List[api_pb2.Device]) -> None:
        """Count actual healthy<->unhealthy flips (the operator-facing
        series; steady-state heartbeat re-sends don't move it)."""
        transitions = obs_metrics.counter(
            "tpu_plugin_health_transitions_total",
            "device health flips observed on heartbeat updates",
            labels=("resource", "device", "to"),
        )
        for dev in devices:
            prev = self._last_health.get(dev.ID)
            if prev is not None and prev != dev.health:
                transitions.inc(
                    resource=self.resource, device=dev.ID, to=dev.health
                )
                obs_trace.event(
                    "plugin.health", "transition", resource=self.resource,
                    device=dev.ID, frm=prev, to=dev.health,
                )
            # tpulint: disable=TPU004 — heartbeat-thread-owned; _alloc_lock guards allocation state only
            self._last_health[dev.ID] = dev.health
        # Prune devices gone from the advertisement (whole-dict rebuild:
        # heartbeat-thread-owned, and a swap never exposes a torn dict),
        # so a later re-appearance counts as a fresh baseline rather
        # than a flip against months-stale state.
        advertised = {dev.ID for dev in devices}
        self._last_health = {
            k: v for k, v in self._last_health.items() if k in advertised
        }

    # -- the 5 RPCs ----------------------------------------------------------

    def GetDevicePluginOptions(
        self, request: api_pb2.Empty,
        context: Optional[grpc.ServicerContext],
    ) -> api_pb2.DevicePluginOptions:
        if self.allocator_init_error:
            return api_pb2.DevicePluginOptions()
        return api_pb2.DevicePluginOptions(get_preferred_allocation_available=True)

    def PreStartContainer(
        self, request: api_pb2.PreStartContainerRequest,
        context: Optional[grpc.ServicerContext],
    ) -> api_pb2.PreStartContainerResponse:
        return api_pb2.PreStartContainerResponse()

    def ListAndWatch(
        self, request: api_pb2.Empty,
        context: Optional[grpc.ServicerContext],
    ) -> Iterator[api_pb2.ListAndWatchResponse]:
        self._refresh_devices()
        obs_metrics.counter(
            "tpu_plugin_listandwatch_streams_total",
            "ListAndWatch stream opens (kubelet connects/reconnects)",
            labels=("resource",),
        ).inc(resource=self.resource)
        log.info("found %d GPU devices for %s", len(self._devices), self.resource)

        if context is not None:
            # gRPC fires this when the RPC terminates for any reason. An
            # unexpected termination (kubelet died / dropped the stream)
            # triggers the crash-to-re-register behavior of the reference
            # (plugin.go:322-324); an orderly stop (our own stop() ran
            # first) does not.
            def _on_rpc_done():
                if not self._stop_event.is_set():
                    log.error(
                        "ListAndWatch stream disconnected; exiting to "
                        "trigger re-registration"
                    )
                    self.config.on_stream_end()

            context.add_callback(_on_rpc_done)

        yield api_pb2.ListAndWatchResponse(devices=self._device_list())

        poll = self.config.watch_poll_interval_s
        while True:
            beat = False
            if self.heartbeat is not None:
                try:
                    self.heartbeat.get(timeout=poll)
                    beat = True
                except queue.Empty:
                    pass
            else:
                self._stop_event.wait(poll)

            if self._stop_event.is_set():
                # Orderly shutdown: returning ends the stream and the
                # kubelet unregisters us (plugin.go:326-333).
                log.info("%s: stopping ListAndWatch", self.resource)
                return
            if beat:
                # One store-only span per heartbeat: the
                # pod-resources reconcile + health refresh is the
                # plugin's steady-state work, and a heartbeat that
                # suddenly takes 100x longer (a wedged kubelet socket,
                # a slow exporter poll) should be visible as a span
                # duration, not only as a watchdog stall. Not
                # journaled — one chiplog line per pulse would bury
                # the wedge suspect list.
                with obs_trace.span("plugin.heartbeat", journal=False,
                                    resource=self.resource):
                    obs_metrics.counter(
                        "tpu_plugin_listandwatch_updates_total",
                        "health-refreshed device lists streamed to the "
                        "kubelet",
                        labels=("resource",),
                    ).inc(resource=self.resource)
                    update = api_pb2.ListAndWatchResponse(
                        devices=self._device_list(with_health=True)
                    )
                yield update

    def GetPreferredAllocation(
        self, request: api_pb2.PreferredAllocationRequest,
        context: Optional[grpc.ServicerContext],
    ) -> api_pb2.PreferredAllocationResponse:
        response = api_pb2.PreferredAllocationResponse()
        for creq in request.container_requests:
            try:
                ids = self.policy.allocate(
                    list(creq.available_deviceIDs),
                    list(creq.must_include_deviceIDs),
                    int(creq.allocation_size),
                )
            except AllocationError as e:
                log.error("unable to get preferred allocation list: %s", e)
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unable to get preferred allocation list: {e}",
                )
            response.container_responses.append(
                api_pb2.ContainerPreferredAllocationResponse(deviceIDs=ids)
            )
        return response

    @staticmethod
    def _inbound_trace_context(context) -> Optional[object]:
        """The caller's trace context from gRPC metadata (a
        ``traceparent`` entry), or None. Defensive throughout: kubelet
        sends none, tests pass ``context=None``, and a malformed value
        must never fail an Allocate."""
        meta_fn = getattr(context, "invocation_metadata", None)
        if not callable(meta_fn):
            return None
        try:
            for key, value in (meta_fn() or ()):
                if str(key).lower() == "traceparent":
                    return obs_trace.parse_traceparent(str(value))
        except Exception:  # noqa: BLE001 — tracing never breaks an RPC
            log.debug("unreadable gRPC metadata", exc_info=True)
        return None

    def Allocate(
        self, request: api_pb2.AllocateRequest,
        context: Optional[grpc.ServicerContext],
    ) -> api_pb2.AllocateResponse:
        start = time.perf_counter()
        outcome = "ok"
        # One span per RPC, joining the caller's trace when gRPC
        # metadata carried a traceparent (store-only: the per-container
        # grant/reject events below remain the journal records, keyed
        # by allocation id). The latency histogram observed in the
        # finally block runs inside it, so the Allocate histogram's
        # exemplars link straight back to this trace.
        with obs_trace.span(
            "plugin.allocate_rpc",
            parent=self._inbound_trace_context(context),
            journal=False, resource=self.resource,
            containers=len(request.container_requests),
        ):
            try:
                response = self._allocate(request, context)
            except BaseException:
                # context.abort raises; any other failure counts the
                # same way.
                outcome = "error"
                raise
            finally:
                obs_metrics.histogram(
                    "tpu_plugin_allocate_seconds",
                    "Allocate RPC latency (device mapping + env synthesis)",
                    labels=("resource",),
                ).observe(time.perf_counter() - start,
                          resource=self.resource)
                obs_metrics.counter(
                    "tpu_plugin_allocate_total",
                    "Allocate RPC outcomes",
                    labels=("resource", "outcome"),
                ).inc(resource=self.resource, outcome=outcome)
        return response

    def _allocate(self, request, context):
        if not self._devices:
            self._refresh_devices()
        response = api_pb2.AllocateResponse()
        # (alloc_id, devices, envs) per container, committed to the
        # allocation table + checkpoint only after EVERY container in the
        # request validated — a mid-request abort must not leave phantom
        # records claiming devices the kubelet never received.
        granted: List[tuple] = []
        for creq in request.container_requests:
            car = api_pb2.ContainerAllocateResponse()
            # One correlation id per container allocation: injected into
            # the container env so the serving process (and any request
            # record it emits) can be traced back to this device set.
            alloc_id = obs_trace.new_correlation_id("alloc")
            allocated: List[Device] = []
            for device_id in creq.devices_ids:
                dev = self._devices.get(device_id)
                if dev is None:
                    obs_trace.event(
                        "plugin.allocate", "reject", trace_id=alloc_id,
                        resource=self.resource, device=device_id,
                    )
                    context.abort(
                        grpc.StatusCode.NOT_FOUND,
                        f"unknown device id {device_id}",
                    )
                allocated.append(dev)
                log.info("allocating device ID: %s", device_id)
            alloc_id = self._check_double_assign(alloc_id, allocated, context)
            obs_trace.event(
                "plugin.allocate", "grant", trace_id=alloc_id,
                resource=self.resource,
                devices=",".join(sorted(d.id for d in allocated)),
            )
            chips = [c for dev in allocated for c in self._chips_of(dev)]
            paths, envs = allocation.container_allocation(chips)
            for path in paths:
                spec = car.devices.add()
                spec.host_path = path
                spec.container_path = path
                spec.permissions = "rw"
            for key, value in envs.items():
                car.envs[key] = value
            car.envs[obs_trace.ALLOCATION_ID_ENV] = alloc_id
            rpc_ctx = obs_trace.current_context()
            if rpc_ctx is not None:
                # The serving process's startup span (serve_http.main)
                # parents to this via TPU_TRACEPARENT, so a replica's
                # cold-start compiles land on the allocation's trace.
                car.envs[obs_trace.TRACEPARENT_ENV] = \
                    obs_trace.format_traceparent(rpc_ctx)
            if self.config.cdi_spec_dir and getattr(self, "_cdi_spec_written", False):
                from k8s_device_plugin_tpu_torch.plugin import cdi

                for dev in allocated:
                    car.cdi_devices.add().name = cdi.device_cdi_name(dev.id)
            granted.append((alloc_id, allocated, dict(car.envs)))
            response.container_responses.append(car)
        for alloc_id, allocated, envs in granted:
            self._record_allocation(alloc_id, allocated, envs)
        self.flush_checkpoint()
        return response

    def _check_double_assign(self, alloc_id: str, allocated: Sequence[Device],
                             context) -> str:
        """Restart double-assign guard over the checkpointed table.

        Three outcomes: a request exactly matching a recorded allocation
        is an idempotent replay (the kubelet retrying after a plugin
        crash) and reuses the recorded id, so the pod re-receives the
        same TPU_ALLOCATION_ID (and the record is thereby confirmed). An
        overlap with a record created in this process lifetime — or one
        a replay has confirmed — means the recorded pod is gone: the
        kubelet only offers devices it believes free, and it is the only
        truth we have, so the stale record is released and the grant
        proceeds. Only an overlap with a still-provisional
        checkpoint-restored record aborts FAILED_PRECONDITION — granting
        inside that window could double-assign GPUs held by a pod that
        survived the restart.
        """
        requested = sorted(d.id for d in allocated)
        with self._alloc_lock:
            held = {
                d.id: self._device_owner[d.id]
                for d in allocated if d.id in self._device_owner
            }
            owners = sorted(set(held.values()))
            if len(owners) == 1:
                rec = self._allocations.get(owners[0])
                if rec is not None and sorted(rec["devices"]) == requested:
                    # The kubelet re-asked for exactly this set: as
                    # authoritative as a reconciliation hit.
                    rec["restored"] = False
                    log.info(
                        "allocation replay for %s (devices %s)",
                        owners[0], ", ".join(requested),
                    )
                    return owners[0]
            provisional = sorted(
                o for o in owners
                if self._allocations.get(o, {}).get("restored")
            )
        if not held:
            return alloc_id
        if provisional:
            obs_trace.event(
                "plugin.allocate", "reject_double_assign",
                trace_id=alloc_id, resource=self.resource,
                devices=",".join(sorted(held)),
                owners=",".join(provisional),
            )
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "device(s) {} held by allocation(s) {} restored from the "
                "checkpoint and not yet reconciled against the kubelet; "
                "refusing to double-assign".format(
                    ", ".join(sorted(held)), ", ".join(provisional)
                ),
            )
        log.info(
            "releasing allocation(s) %s: the kubelet re-offered device(s) "
            "%s, so those pods are gone",
            ", ".join(owners), ", ".join(sorted(held)),
        )
        # Whole records, not just the re-offered devices: a container
        # holds all of its granted set or none of it, so a single
        # re-offered member proves the rest free too — trimming would
        # leave phantom partial holds.
        with self._alloc_lock:
            for owner in owners:
                rec = self._allocations.pop(owner, None)
                if rec is None:
                    continue
                for dev_id in rec["devices"]:
                    if self._device_owner.get(dev_id) == owner:
                        del self._device_owner[dev_id]
        self._count_releases("overlap", len(owners))
        return alloc_id

    def _record_allocation(self, alloc_id: str, allocated: Sequence[Device],
                           envs: Dict[str, str]) -> None:
        with self._alloc_lock:
            prev = self._allocations.get(alloc_id)
            self._allocations[alloc_id] = {
                "devices": sorted(d.id for d in allocated),
                "envs": envs,
                "created_at": (
                    prev["created_at"] if prev and prev.get("created_at")
                    else time.time()
                ),
                # Created in this process lifetime: the kubelet just
                # granted it, so it never vetoes a later grant the way a
                # provisional checkpoint-restored record does.
                "restored": False,
            }
            for d in allocated:
                self._device_owner[d.id] = alloc_id

class GPULister:
    """The dpm Lister for the nvidia.com/gpu resource (AMDGPULister
    analogue, plugin.go:402-442)."""

    def __init__(
        self,
        config: Optional[PluginConfig] = None,
        heartbeat: Optional["queue.Queue"] = None,
        strategy: Strategy = Strategy.SINGLE,
        policy_factory: Callable[[], object] = BestEffortPolicy,
    ):
        self.config = config or PluginConfig()
        self.heartbeat = heartbeat
        self.strategy = strategy
        self.policy_factory = policy_factory
        self.resource_updates: "queue.Queue[List[str]]" = queue.Queue()
        # Written by the manager loop (new_plugin), iterated by the
        # heartbeat-fanout thread: every touch goes through _plugins_mu /
        # _plugins_snapshot().
        self._plugins_mu = threading.Lock()
        self.plugins: Dict[str, GPUDevicePlugin] = {}
        self._fanout_started = False

    def _plugins_snapshot(self) -> List[GPUDevicePlugin]:
        """Consistent view of the live plugins for cross-thread walks."""
        with self._plugins_mu:
            return list(self.plugins.values())

    def _fanout_heartbeat(self) -> None:
        """Relay beats from the daemon's pulse queue to every plugin.

        Each plugin owns a maxsize-1 queue: with a single shared queue
        per-resource ListAndWatch streams would consume beats
        competitively. Per-plugin queues keep the
        drop-when-unconsumed semantics while every resource sees every
        beat.
        """
        while True:
            beat = self.heartbeat.get()
            if beat is None:
                return
            for plugin in self._plugins_snapshot():
                if plugin.heartbeat is None:
                    continue
                try:
                    plugin.heartbeat.put_nowait(beat)
                except queue.Full:
                    pass  # that stream has no consumer; drop its beat

    def get_resource_namespace(self) -> str:
        return constants.RESOURCE_NAMESPACE

    def compute_resources(self) -> List[str]:
        chips = chips_mod.get_gpu_chips(
            self.config.sysfs_root, self.config.dev_root,
            self.config.proc_root,
        )
        return get_resource_list(chips, self.strategy)

    def discover(self, out: "queue.Queue") -> None:
        while True:
            names = self.resource_updates.get()
            if names is None:
                return
            out.put(names)

    def new_plugin(self, resource_last_name: str) -> GPUDevicePlugin:
        plugin = GPUDevicePlugin(
            resource=resource_last_name,
            config=self.config,
            heartbeat=(
                queue.Queue(maxsize=1) if self.heartbeat is not None else None
            ),
            policy=self.policy_factory(),
        )
        with self._plugins_mu:
            self.plugins[resource_last_name] = plugin
        if self.heartbeat is not None and not self._fanout_started:
            self._fanout_started = True
            threading.Thread(
                target=self._fanout_heartbeat,
                name="heartbeat-fanout",
                daemon=True,
            ).start()
        return plugin
