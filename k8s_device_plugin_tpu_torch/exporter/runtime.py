"""Per-GPU runtime telemetry from NVML.

The reference reads HBM usage/capacity and TensorCore duty cycle from
libtpu's runtime-metrics gRPC service (default localhost:8431), what no
kernel interface exposes. On an NVIDIA GPU the driver's own library
answers the same questions: ``nvmlDeviceGetMemoryInfo`` (device memory
used and total) and ``nvmlDeviceGetUtilizationRates`` (the share of the
last sample period in which a kernel ran), read per GPU by UUID through
native/binding.py. The address ``nvml`` selects that source; there is no
service to dial. The reference's degradation discipline stays: any
failure (no NVML, a query the driver refuses, a GPU it no longer lists)
returns partial-or-None instead of raising, each failed gauge is counted
with its reason, and the circuit breaker and the ``runtime.poll`` fault
point work as the reference's. Accelerators are keyed by
``GPUChip.key`` (the PCI address, or the UUID where it is hidden), never
by a device minor or NVML's index, which change from boot to boot.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import faults
from k8s_device_plugin_tpu_torch.utils import retry as retrylib

log = logging.getLogger(__name__)

# The one source the port reads: the driver's NVML.
NVML_ADDR = "nvml"
DEFAULT_RUNTIME_METRICS_ADDR = NVML_ADDR
# The reference's per-RPC bound. NVML queries are local library calls
# with no timeout of their own; read_runtime_metrics keeps the argument.
QUERY_TIMEOUT_S = 3.0

# Circuit-breaker knobs (docs/robustness.md). A host whose NVML is gone
# (driver unloaded, library missing) fails every poll the same way;
# once it is known-dead the scrape path stops asking until a half-open
# probe. Threshold <= 0 disables.
BREAKER_THRESHOLD = int(os.environ.get("TPU_RUNTIME_BREAKER_THRESHOLD", "5"))
BREAKER_RESET_S = float(os.environ.get("TPU_RUNTIME_BREAKER_RESET_S", "30"))

# The gauges, by the NVML query and field each reads (the reference's
# names for the same three: HBM usage, HBM capacity, duty cycle).
HBM_USAGE = "nvml.memory.used.bytes"
HBM_TOTAL = "nvml.memory.total.bytes"
DUTY_CYCLE = "nvml.utilization.gpu.percent"


class PollState:
    """Per-gauge success/failure accounting for the runtime poll.

    Failures used to be silently swallowed (debug-level, no counters);
    operators discovered a dead runtime-metrics service only by noticing
    HBM gauges had quietly vanished from scrapes. Now every failure is
    counted (exposed via the registry as
    ``tpu_exporter_runtime_poll_failures_total``), the last successful
    read is timestamped (staleness gauge material), and the first
    failure after a success logs at WARNING — once per outage, not once
    per poll.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.failures: Dict[str, int] = {}
        self.last_success: Dict[str, float] = {}
        self._was_ok: Dict[str, bool] = {}

    def record_success(self, gauge_name: str) -> None:
        with self._lock:
            self.last_success[gauge_name] = time.time()
            self._was_ok[gauge_name] = True
        obs_metrics.gauge(
            "tpu_exporter_runtime_last_success_seconds",
            "unix time of the last successful runtime-metrics read",
            labels=("metric",),
        ).set_to_current_time(metric=gauge_name)

    def record_failure(self, gauge_name: str, reason: str) -> bool:
        """Count one failure; returns True when this is the first
        failure after a success (the one worth a WARNING)."""
        with self._lock:
            self.failures[gauge_name] = self.failures.get(gauge_name, 0) + 1
            first = self._was_ok.get(gauge_name, True)
            self._was_ok[gauge_name] = False
        obs_metrics.counter(
            "tpu_exporter_runtime_poll_failures_total",
            "runtime-metrics reads that returned no sample",
            labels=("metric", "reason"),
        ).inc(metric=gauge_name, reason=reason)
        return first

    def staleness_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the OLDEST per-gauge success (worst case), or
        None before any success."""
        with self._lock:
            if not self.last_success:
                return None
            return (now or time.time()) - min(self.last_success.values())


# Module-level: the exporter daemon polls from scrape handlers across
# threads; one shared state keeps the first-failure WARNING one-shot.
_poll_state = PollState()


def poll_state() -> PollState:
    return _poll_state


def _g_breaker_state():
    return obs_metrics.gauge(
        "tpu_exporter_runtime_breaker_state_count",
        "runtime-poll circuit breaker state "
        "(0=closed, 1=open, 2=half-open)",
    )


def _c_breaker_skips():
    return obs_metrics.counter(
        "tpu_exporter_runtime_breaker_skips_total",
        "runtime polls skipped because the circuit breaker was open",
    )


def _set_breaker_gauge(state: str) -> None:
    _g_breaker_state().set(retrylib.CircuitBreaker.STATE_VALUES[state])


def _new_breaker(threshold: int,
                 reset_s: float) -> Optional[retrylib.CircuitBreaker]:
    if threshold <= 0:
        return None
    _set_breaker_gauge(retrylib.CircuitBreaker.CLOSED)
    return retrylib.CircuitBreaker(
        failure_threshold=threshold,
        reset_timeout_s=reset_s,
        on_state_change=_set_breaker_gauge,
    )


_breaker = _new_breaker(BREAKER_THRESHOLD, BREAKER_RESET_S)


def breaker() -> Optional[retrylib.CircuitBreaker]:
    return _breaker


def configure_breaker(threshold: int = BREAKER_THRESHOLD,
                      reset_s: float = BREAKER_RESET_S,
                      ) -> Optional[retrylib.CircuitBreaker]:
    """Rebuild the module breaker (tests; daemons use the env knobs)."""
    global _breaker
    _breaker = _new_breaker(threshold, reset_s)
    return _breaker


def _note_failure(gauge_name: str, reason: str, addr: str) -> None:
    if _poll_state.record_failure(gauge_name, reason):
        log.warning(
            "runtime metric %s unavailable at %s (%s); counting failures "
            "silently until it recovers", gauge_name, addr, reason,
        )


@dataclass
class AcceleratorRuntime:
    hbm_usage_bytes: Optional[int] = None
    hbm_total_bytes: Optional[int] = None
    duty_cycle_pct: Optional[float] = None


@dataclass
class RuntimeMetrics:
    # keyed by GPUChip.key: the PCI address, or the UUID where the host
    # hides it
    accelerators: Dict[str, AcceleratorRuntime] = field(
        default_factory=dict
    )


def read_runtime_metrics(
    addr: str = DEFAULT_RUNTIME_METRICS_ADDR,
    timeout_s: float = QUERY_TIMEOUT_S,
    breaker: Optional[retrylib.CircuitBreaker] = None,
) -> Optional[RuntimeMetrics]:
    """Poll NVML for every GPU it lists; None when it is unavailable.

    ``addr`` must be ``"nvml"`` (ValueError otherwise: the port has no
    other source). Guarded by the module circuit breaker (or ``breaker``
    when given): after ``TPU_RUNTIME_BREAKER_THRESHOLD`` consecutive
    all-failure polls the breaker opens and this returns None
    immediately until ``TPU_RUNTIME_BREAKER_RESET_S`` passes and a
    half-open probe poll tests recovery.
    """
    if addr != NVML_ADDR:
        raise ValueError(
            f"runtime metrics address {addr!r}: the GPU exporter reads "
            f"{NVML_ADDR!r} only")
    br = _breaker if breaker is None else breaker
    if br is not None and not br.allow():
        _c_breaker_skips().inc()
        return None
    try:
        faults.inject("runtime.poll", addr=addr)
        result = _read_runtime_metrics_once(addr, timeout_s)
    except faults.FaultError as e:
        # Injected blackout (chaos suite): account it exactly like a
        # real all-gauge poll failure.
        log.debug("runtime poll fault injected: %s", e)
        for name in (HBM_USAGE, HBM_TOTAL, DUTY_CYCLE):
            _note_failure(name, "fault", addr)
        result = None
    if br is not None:
        if result is None:
            br.record_failure()
        else:
            br.record_success()
    return result


def _read_runtime_metrics_once(
    addr: str,
    timeout_s: float,
) -> Optional[RuntimeMetrics]:
    from k8s_device_plugin_tpu_torch.discovery.chips import device_key
    from k8s_device_plugin_tpu_torch.native import binding

    fields = (
        (HBM_USAGE, "hbm_usage_bytes", "memory_used", int),
        (HBM_TOTAL, "hbm_total_bytes", "memory_total", int),
        (DUTY_CYCLE, "duty_cycle_pct", "util_gpu", float),
    )
    records = binding.enumerate_chips("/sys", "/dev") \
        if binding.available() else None
    if records is None:
        # no NVML (or it failed to list the GPUs): nothing was read
        for name, _, _, _ in fields:
            _note_failure(name, "unreachable", addr)
        log.debug("runtime metrics: NVML unavailable")
        return None
    samples = {device_key(r["pci_address"], r["uuid"]):
               binding.sample(r["uuid"]) or {} for r in records}
    got_any = False
    result = RuntimeMetrics()
    for metric_name, attr_name, key, cast in fields:
        got_this = False
        for dev, values in samples.items():
            if values.get(key) is None:
                continue
            acc = result.accelerators.setdefault(dev, AcceleratorRuntime())
            setattr(acc, attr_name, cast(values[key]))
            got_any = got_this = True
        if got_this:
            _poll_state.record_success(metric_name)
        elif samples:
            # the driver refuses this query on every GPU: keep going
            _note_failure(metric_name, "unsupported", addr)
        else:
            _note_failure(metric_name, "empty", addr)
    return result if got_any else None
