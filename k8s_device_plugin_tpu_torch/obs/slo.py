"""Live SLO burn-rate monitor (ISSUE 13 — the sensor half of the
ROADMAP-5 autoscaler, landed ahead of the actuator).

Multi-window, multi-burn-rate alerting in the Google-SRE-workbook
shape, evaluated in-process over the signals serving already emits:

- **objective "ttft"** — the latency SLO: the fraction of requests
  whose time-to-first-token stayed under ``TPU_SLO_TTFT_S``, read from
  the ``tpu_serve_ttft_seconds`` histogram's buckets (the threshold
  snaps DOWN to the nearest bucket bound — a histogram cannot answer
  finer, and snapping down errs toward alerting);
- **objective "availability"** — the success SLO: requests not shed
  and not failed, from ``tpu_serve_requests_total``,
  ``tpu_serve_shed_total`` and ``tpu_serve_http_errors_total``.

Burn rate over a window = (bad fraction in the window) / (1 − target):
1.0 means the error budget burns exactly at the sustainable rate. Each
severity pairs a long and a short window (the workbook's reset-fast
trick: the long window gives significance, the short window makes the
alert clear quickly once the bleeding stops) and fires only when BOTH
exceed its threshold:

- **fast** (page): long ``TPU_SLO_FAST_LONG_S`` (default 3600 s) and
  short ``TPU_SLO_FAST_SHORT_S`` (300 s), burn ≥ ``TPU_SLO_FAST_BURN``
  (14.4 — budget gone in ~2 days at that pace);
- **slow** (ticket): ``TPU_SLO_SLOW_LONG_S`` (21600 s) /
  ``TPU_SLO_SLOW_SHORT_S`` (1800 s), burn ≥ ``TPU_SLO_SLOW_BURN`` (6).

Outputs: ``tpu_slo_burn_rate{objective,window}``,
``tpu_slo_budget_remaining_ratio{objective}`` (over the slow long
window), ``tpu_slo_alert_state{objective}`` (0 = ok, 1 = slow-burn,
2 = fast-burn — gauge encoding documented like the breaker's), and a
one-shot trace event per state *transition* (never per evaluation), so
the journal shows exactly when an alert raised and cleared.

The monitor is a step-driven controller (injectable clock, no threads
of its own) like RemediationController; :func:`start_from_env` wraps it
in the jittered, watchdog-registered daemon loop llm-serve starts when
``TPU_SLO_MONITOR=1`` (the Helm chart's ``observability.slo.enabled``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.obs import trace as obs_trace
from k8s_device_plugin_tpu_torch.utils import retry as retrylib
from k8s_device_plugin_tpu_torch.utils import watchdog as watchdog_mod

log = logging.getLogger(__name__)

__all__ = [
    "SLOConfig",
    "BurnRateMonitor",
    "start_from_env",
    "ALERT_STATE_VALUES",
    "MONITOR_ENV",
]

# Enable knob for the in-serve daemon loop (rendered by Helm's
# observability.slo.enabled).
MONITOR_ENV = "TPU_SLO_MONITOR"

# Gauge encoding for tpu_slo_alert_state — docs and dashboards rely on
# one mapping repo-wide (the CircuitBreaker.STATE_VALUES discipline).
OK, SLOW, FAST = "ok", "slow", "fast"
ALERT_STATE_VALUES = {OK: 0, SLOW: 1, FAST: 2}

_WINDOW_LABELS = ("fast_long", "fast_short", "slow_long", "slow_short")


def _g_burn():
    return obs_metrics.gauge(
        "tpu_slo_burn_rate",
        "error-budget burn rate per objective and evaluation window "
        "(1.0 = burning exactly the sustainable pace)",
        labels=("objective", "window"),
    )


def _g_budget():
    return obs_metrics.gauge(
        "tpu_slo_budget_remaining_ratio",
        "fraction of the error budget left over the slow long window "
        "(1 = untouched, 0 = exhausted)",
        labels=("objective",),
    )


def _g_alert():
    return obs_metrics.gauge(
        "tpu_slo_alert_state",
        "burn-rate alert state per objective (0 = ok, 1 = slow-burn, "
        "2 = fast-burn)",
        labels=("objective",),
    )


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %s", name, raw, default)
        return default


@dataclass(frozen=True)
class SLOConfig:
    """Thresholds and windows, all overridable via ``TPU_SLO_*`` env."""

    target: float = 0.99           # SLO objective (good/total)
    ttft_threshold_s: float = 0.5  # "good" TTFT bound
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    fast_long_s: float = 3600.0
    fast_short_s: float = 300.0
    slow_long_s: float = 21600.0
    slow_short_s: float = 1800.0
    step_s: float = 15.0           # daemon-loop evaluation cadence

    @classmethod
    def from_env(cls) -> "SLOConfig":
        return cls(
            target=_env_float("TPU_SLO_TARGET", cls.target),
            ttft_threshold_s=_env_float("TPU_SLO_TTFT_S",
                                        cls.ttft_threshold_s),
            fast_burn=_env_float("TPU_SLO_FAST_BURN", cls.fast_burn),
            slow_burn=_env_float("TPU_SLO_SLOW_BURN", cls.slow_burn),
            fast_long_s=_env_float("TPU_SLO_FAST_LONG_S", cls.fast_long_s),
            fast_short_s=_env_float("TPU_SLO_FAST_SHORT_S",
                                    cls.fast_short_s),
            slow_long_s=_env_float("TPU_SLO_SLOW_LONG_S", cls.slow_long_s),
            slow_short_s=_env_float("TPU_SLO_SLOW_SHORT_S",
                                    cls.slow_short_s),
            step_s=_env_float("TPU_SLO_STEP_S", cls.step_s),
        )

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1): {self.target}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


# -- objectives: (good, total) extractors over registry snapshots -----------


def _sum_counter(snapshot: Dict[str, dict], name: str,
                 want: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                 ) -> float:
    fam = snapshot.get(name)
    if not fam or fam.get("type") != "counter":
        return 0.0
    return sum(
        float(v) for key, v in fam["samples"].items()
        if want is None or want(key)
    )


def _hist_good_total(snapshot: Dict[str, dict], name: str,
                     threshold: float,
                     buckets: Optional[Tuple[float, ...]],
                     ) -> Tuple[float, float]:
    """(observations ≤ the largest bucket bound ≤ threshold, total
    observations) summed across every labeled series of ``name``."""
    fam = snapshot.get(name)
    if not fam or fam.get("type") != "histogram" or not buckets:
        return 0.0, 0.0
    # The threshold snaps DOWN to a representable answer: observations
    # in the bucket straddling the threshold count as bad.
    idx = -1
    for i, bound in enumerate(buckets):
        if bound <= threshold:
            idx = i
    good = total = 0.0
    for sample in fam["samples"].values():
        counts = sample["buckets"]
        good += sum(counts[: idx + 1])
        total += sample["count"]
    return good, total


class _Objective:
    """One SLO objective: extracts (good, total) from a snapshot."""

    def __init__(self, name: str,
                 fn: Callable[[Dict[str, dict]], Tuple[float, float]]):
        self.name = name
        self._fn = fn

    def good_total(self, snapshot: Dict[str, dict]) -> Tuple[float, float]:
        return self._fn(snapshot)


def _builtin_objectives(config: SLOConfig,
                        registry_fn: Callable[[], Optional[object]],
                        ) -> List[_Objective]:
    def _ttft_buckets() -> Optional[Tuple[float, ...]]:
        reg = registry_fn()
        if reg is None:
            return None
        h = reg.get("tpu_serve_ttft_seconds")
        return getattr(h, "buckets", None)

    def ttft(snapshot: Dict[str, dict]) -> Tuple[float, float]:
        return _hist_good_total(
            snapshot, "tpu_serve_ttft_seconds",
            config.ttft_threshold_s, _ttft_buckets(),
        )

    def availability(snapshot: Dict[str, dict]) -> Tuple[float, float]:
        finished = _sum_counter(snapshot, "tpu_serve_requests_total")
        shed = _sum_counter(snapshot, "tpu_serve_shed_total")
        # 4xx classes are the client's fault, not budget spend; count
        # server-side failure classes only.
        errors = _sum_counter(
            snapshot, "tpu_serve_http_errors_total",
            want=lambda key: any(
                k in ("internal", "closing", "deadline") for k in key
            ),
        )
        total = finished + shed
        bad = shed + errors
        return max(0.0, total - bad), total

    return [
        _Objective("ttft", ttft),
        _Objective("availability", availability),
    ]


class BurnRateMonitor:
    """Step-driven burn-rate evaluator over the installed registry.

    Call :meth:`step` on a cadence (the daemon loop does, tests drive
    it with an injected clock). Each step snapshots the registry,
    appends to the sample ring, computes each objective's burn over the
    four windows, publishes the gauges, and fires one trace event per
    alert-state transition. Windows shorter than the ring's history
    fall back to the oldest sample — a freshly started monitor
    evaluates over its whole life rather than staying silent until the
    slow-long window fills.
    """

    def __init__(
        self,
        config: Optional[SLOConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        snapshot_fn: Callable[[], Dict[str, dict]] = obs_metrics.snapshot,
        objectives: Optional[List[_Objective]] = None,
    ):
        self.config = config or SLOConfig.from_env()
        self._clock = clock
        self._snapshot = snapshot_fn
        self.objectives = (
            objectives if objectives is not None
            else _builtin_objectives(self.config, obs_metrics.get_registry)
        )
        self._history: Deque[Tuple[float, Dict[str, dict]]] = deque()
        self.alert_state: Dict[str, str] = {
            o.name: OK for o in self.objectives
        }
        self.transitions: List[dict] = []  # audit trail (tests assert on it)
        self._windows = {
            "fast_long": self.config.fast_long_s,
            "fast_short": self.config.fast_short_s,
            "slow_long": self.config.slow_long_s,
            "slow_short": self.config.slow_short_s,
        }

    # -- window math ---------------------------------------------------------

    def _at_or_before(self, ts: float) -> Optional[Dict[str, dict]]:
        """Newest snapshot taken at or before ``ts`` (oldest held as
        fallback); None with no history."""
        if not self._history:
            return None
        chosen = self._history[0][1]
        for t, snap in self._history:
            if t <= ts:
                chosen = snap
            else:
                break
        return chosen

    def _burn(self, objective: _Objective, now: float,
              current: Dict[str, dict], window_s: float) -> float:
        boundary = self._at_or_before(now - window_s)
        if boundary is None:
            return 0.0
        g0, t0 = objective.good_total(boundary)
        g1, t1 = objective.good_total(current)
        total = t1 - t0
        if total <= 0:
            return 0.0  # no traffic in the window: nothing burned
        bad = total - (g1 - g0)
        return (bad / total) / self.config.budget

    # -- the step ------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Dict[str, dict]:
        """One evaluation; returns per-objective
        ``{"burn": {window: rate}, "budget_remaining": r, "state": s}``."""
        now = self._clock() if now is None else now
        current = self._snapshot()
        self._history.append((now, current))
        horizon = now - max(self._windows.values()) - 2 * self.config.step_s
        while len(self._history) > 1 and self._history[0][0] < horizon:
            self._history.popleft()

        out: Dict[str, dict] = {}
        for objective in self.objectives:
            burns = {
                label: self._burn(objective, now, current, window)
                for label, window in self._windows.items()
            }
            if (burns["fast_long"] >= self.config.fast_burn
                    and burns["fast_short"] >= self.config.fast_burn):
                state = FAST
            elif (burns["slow_long"] >= self.config.slow_burn
                    and burns["slow_short"] >= self.config.slow_burn):
                state = SLOW
            else:
                state = OK
            remaining = max(0.0, 1.0 - burns["slow_long"])
            for label in _WINDOW_LABELS:
                _g_burn().set(round(burns[label], 4),
                              objective=objective.name, window=label)
            _g_budget().set(round(remaining, 4), objective=objective.name)
            _g_alert().set(ALERT_STATE_VALUES[state],
                           objective=objective.name)
            prev = self.alert_state[objective.name]
            if state != prev:
                self._transition(objective.name, prev, state, burns, now)
            out[objective.name] = {
                "burn": burns,
                "budget_remaining": remaining,
                "state": state,
            }
        return out

    def _transition(self, objective: str, frm: str, to: str,
                    burns: Dict[str, float], now: float) -> None:
        self.alert_state[objective] = to
        record = {
            "objective": objective, "frm": frm, "to": to,
            "at": round(now, 3),
            "fast_burn": round(burns["fast_short"], 3),
            "slow_burn": round(burns["slow_short"], 3),
        }
        self.transitions.append(record)
        # One-shot journal/trace event per transition — raised and
        # cleared alerts are findable in chip_log.jsonl, never a
        # per-evaluation firehose.
        raised = ALERT_STATE_VALUES[to] > ALERT_STATE_VALUES[frm]
        obs_trace.event(
            "slo.monitor",
            "alert_raised" if raised else "alert_cleared",
            objective=objective, frm=frm, to=to,
            fast_burn=record["fast_burn"], slow_burn=record["slow_burn"],
        )
        if raised:
            # A raise is the "something just went wrong" edge: dump the
            # engine flight recorder next to the alert in the journal —
            # exactly once per transition, never while the alert holds
            # (ISSUE 16). Lazy import: slo must stay importable before
            # any engine exists.
            from k8s_device_plugin_tpu_torch.obs import flightrec

            flightrec.dump_installed(
                f"slo:{objective}:{to}",
                note=f"burn fast={record['fast_burn']} "
                     f"slow={record['slow_burn']}",
            )
        level = logging.WARNING if to != OK else logging.INFO
        log.log(level, "SLO %s: alert %s -> %s (fast=%.2f slow=%.2f)",
                objective, frm, to, record["fast_burn"],
                record["slow_burn"])

    # -- daemon loop ---------------------------------------------------------

    def run(self, stop_event: threading.Event,
            jitter_seed: Optional[int] = None) -> None:
        """Step until ``stop_event``; jittered cadence, watchdog-backed."""
        pacer = retrylib.Pacer(self.config.step_s, seed=jitter_seed)
        hb = watchdog_mod.register(
            "slo.monitor", stall_after_s=max(4 * self.config.step_s, 60.0)
        )
        try:
            if stop_event.wait(pacer.first_delay()):
                return
            while not stop_event.is_set():
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — monitor must survive
                    log.exception("SLO evaluation failed")
                hb.beat()
                if stop_event.wait(pacer.next_delay()):
                    return
        finally:
            hb.close()


@dataclass
class _RunningMonitor:
    monitor: BurnRateMonitor
    stop_event: threading.Event
    thread: threading.Thread = field(repr=False, default=None)  # type: ignore[assignment]

    def stop(self, timeout_s: float = 5.0) -> None:
        self.stop_event.set()
        if self.thread is not None:
            self.thread.join(timeout=timeout_s)


def start_from_env() -> Optional[_RunningMonitor]:
    """Start the daemon-loop monitor when ``TPU_SLO_MONITOR=1``;
    returns the running handle (``.stop()``) or None when disabled.
    llm-serve calls this after its registry is installed."""
    if os.environ.get(MONITOR_ENV) != "1":
        return None
    monitor = BurnRateMonitor(SLOConfig.from_env())
    stop_event = threading.Event()
    thread = threading.Thread(
        target=monitor.run, args=(stop_event,), name="slo-monitor",
        daemon=True,
    )
    handle = _RunningMonitor(monitor=monitor, stop_event=stop_event,
                             thread=thread)
    thread.start()
    log.info(
        "SLO burn-rate monitor on: target=%.4f ttft<=%.3fs fast>=%.1f "
        "slow>=%.1f step=%.0fs",
        monitor.config.target, monitor.config.ttft_threshold_s,
        monitor.config.fast_burn, monitor.config.slow_burn,
        monitor.config.step_s,
    )
    return handle
