"""Deterministic, seedable fault injection (ISSUE 3 tentpole).

The reference plugin's recovery story is crash-and-restart and is
entirely untested upstream; every robustness claim this repo makes
(graceful re-registration, degradation instead of crashes, bounded
overload behavior) needs failure to be an *input* the test suite can
dial in — not something only a flaky cluster provides. This module is
the shared switchboard: call sites declare **named fault points**
inline (``faults.inject("kube.request", method=method)``) and test code
or a ``TPU_FAULT_PLAN`` environment spec arms them.

Design constraints:

- **No-op when unarmed.** ``inject()`` on an un-armed process is one
  module-global read + a truthiness check; with a plan armed but the
  point not named, one dict lookup. Production cost is nil, so fault
  points stay in shipped code (they document the failure surface).
- **Deterministic.** Probabilistic rules (``rate=0.3``) draw from a
  per-rule ``random.Random(seed)``; the same plan + the same call
  sequence always injects the same faults, so chaos tests assert exact
  retry/shed counts and re-run to identical results.
- **Bounded.** ``count=N`` caps total fires, ``after=N`` skips warmup
  calls; an exhausted rule reverts to pass-through.

Plan grammar (``TPU_FAULT_PLAN`` or :func:`arm`)::

    plan  := entry ( (';' | ',') entry )*
    entry := point '=' mode (':' arg)*
    mode  := 'error' | 'delay'

    kube.request=error:KubeError:rate=0.3:seed=7
    runtime.poll=delay:2.0:count=3
    kubelet.register=error:count=2;serve.decode_step=error

``error`` raises the named exception class (positional arg; resolved
from :func:`register_exception` entries, then builtins; default
:class:`FaultError`). ``delay`` sleeps its positional argument in
seconds. Options everywhere: ``rate=`` (fire probability, default 1),
``count=`` (max fires), ``after=`` (skip first N eligible calls),
``seed=`` (rate-draw seed, default 0), ``message=`` (exception text).

Fault-point names in this repo are cataloged in docs/robustness.md;
grep for ``faults.inject(`` to regenerate the list.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Type

log = logging.getLogger(__name__)

__all__ = [
    "FaultError",
    "FaultRule",
    "arm",
    "arm_point",
    "disarm",
    "fires",
    "inject",
    "plan",
    "register_exception",
    "reload_from_env",
    "snapshot",
]

ENV_PLAN = "TPU_FAULT_PLAN"


class FaultError(RuntimeError):
    """Default exception an ``error`` rule raises (callers that catch
    broadly see it like any other infrastructure failure)."""


# Exception classes resolvable by name in plan specs. Builtins resolve
# without registration; repo-specific classes (KubeError, DiscoveryError)
# self-register at import so a plan can name them before any call.
_EXCEPTIONS: Dict[str, Type[BaseException]] = {"FaultError": FaultError}


def register_exception(cls: Type[BaseException]) -> Type[BaseException]:
    """Make ``cls`` resolvable by name in plan specs (class decorator)."""
    _EXCEPTIONS[cls.__name__] = cls
    return cls


def _resolve_exception(name: str) -> Type[BaseException]:
    if name in _EXCEPTIONS:
        return _EXCEPTIONS[name]
    import builtins

    candidate = getattr(builtins, name, None)
    if isinstance(candidate, type) and issubclass(candidate, BaseException):
        return candidate
    raise ValueError(
        f"unknown exception {name!r} in fault plan (register it via "
        "faults.register_exception, or use a builtin name)"
    )


class FaultRule:
    """One armed fault point: mode + firing policy + deterministic rng."""

    def __init__(
        self,
        point: str,
        mode: str,
        exc: object = None,
        delay_s: float = 0.0,
        rate: float = 1.0,
        count: Optional[int] = None,
        after: int = 0,
        seed: int = 0,
        message: Optional[str] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if mode not in ("error", "delay"):
            raise ValueError(f"{point}: unknown fault mode {mode!r}")
        self.point = point
        self.mode = mode
        # A string exc resolves lazily at first fire: an env plan is
        # parsed at import, BEFORE the module that registers the named
        # exception (e.g. kube/client's KubeError) has loaded — but by
        # the time the point actually fires, its own module has.
        self.exc: object = exc or FaultError
        self.delay_s = float(delay_s)
        self.rate = float(rate)
        self.count = count
        self.after = int(after)
        self.seed = int(seed)
        self.message = message
        self._sleep = sleep
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.calls = 0   # inject() arrivals at this point
        self.fires = 0   # faults actually delivered

    def describe(self) -> str:
        with self._lock:
            exc = self.exc
        exc_name = exc if isinstance(exc, str) else exc.__name__
        extra = f":{exc_name}" if self.mode == "error" else \
            f":{self.delay_s:g}"
        return (
            f"{self.point}={self.mode}{extra}:rate={self.rate:g}"
            f":seed={self.seed}"
            + (f":count={self.count}" if self.count is not None else "")
            + (f":after={self.after}" if self.after else "")
        )

    def _should_fire(self) -> bool:
        # One lock guards counters AND the rng draw: concurrent callers
        # (HTTP handler threads, the dpm loop) must consume draws in a
        # serialized order or determinism dies exactly when it matters.
        with self._lock:
            self.calls += 1
            if self.calls <= self.after:
                return False
            if self.count is not None and self.fires >= self.count:
                return False
            if self.rate < 1.0 and self._rng.random() >= self.rate:
                return False
            self.fires += 1
            return True

    def _exc_class(self) -> Type[BaseException]:
        # The lazy str->class memoization is shared state: inject() can
        # fire this point from several threads at once, and describe()
        # reads it — same lock as the counters (tpulint TPU019).
        with self._lock:
            if isinstance(self.exc, str):
                try:
                    self.exc = _resolve_exception(self.exc)
                except ValueError as e:
                    # A typo'd name must still fault (the operator armed
                    # chaos); the detail names the unresolved class.
                    log.warning("%s: %s — raising FaultError instead",
                                self.point, e)
                    self.exc = FaultError
            return self.exc  # type: ignore[return-value]

    def fire(self, ctx: Dict[str, object]) -> None:
        if not self._should_fire():
            return
        _count_injection(self.point, self.mode)
        _notify_flight_recorder(self.point, self.mode)
        with self._lock:
            nfires = self.fires
        detail = self.message or (
            f"injected fault at {self.point} (fire #{nfires})"
        )
        log.debug("fault %s firing: %s %s ctx=%s", self.point, self.mode,
                  detail, ctx)
        if self.mode == "delay":
            self._sleep(self.delay_s)
        else:
            raise self._exc_class()(detail)


def _count_injection(point: str, mode: str) -> None:
    # Imported lazily: obs imports nothing from utils.faults, but keep
    # the fault switchboard importable even mid-bootstrap.
    from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.counter(
        "tpu_faults_injected_total",
        "faults delivered by the injection registry",
        labels=("point", "mode"),
    ).inc(point=point, mode=mode)


def _notify_flight_recorder(point: str, mode: str) -> None:
    """An armed ``serve.*`` fault about to deliver is a postmortem
    moment: dump the engine flight-recorder ring to the journal BEFORE
    the raise, so the dump captures the iterations leading up to the
    fault (ISSUE 16). Same lazy-import seam as the injection counter;
    never raises — the plan's fault must be the only failure."""
    if not point.startswith("serve."):
        return
    try:
        from k8s_device_plugin_tpu_torch.obs import flightrec

        flightrec.dump_installed(f"fault:{point}", note=f"mode={mode}")
    # tpulint: disable=TPU001 — best-effort postmortem hook
    except Exception:
        pass


# The armed plan. Replaced wholesale (never mutated in place) so
# inject()'s unlocked read sees either the old or the new plan — both
# self-consistent.
_plan: Dict[str, FaultRule] = {}
_plan_lock = threading.Lock()


def inject(point: str, **ctx: object) -> None:
    """Declare a fault point. No-op unless a plan arms ``point``.

    Call sites name the failure they simulate, e.g.::

        faults.inject("kube.request", method=method, path=path)

    An armed ``error`` rule raises from here (the caller's normal error
    handling takes over — that's the point); ``delay`` blocks.
    """
    plan_now = _plan
    if not plan_now:
        return
    rule = plan_now.get(point)
    if rule is not None:
        rule.fire(ctx)


def _parse_opts(args: List[str], point: str) -> Tuple[List[str], Dict[str, str]]:
    positional: List[str] = []
    opts: Dict[str, str] = {}
    for a in args:
        if "=" in a:
            k, _, v = a.partition("=")
            opts[k.strip()] = v.strip()
        elif a:
            positional.append(a)
    for k in opts:
        if k not in ("rate", "count", "after", "seed", "message"):
            raise ValueError(f"{point}: unknown fault option {k!r}")
    return positional, opts


def parse_plan(spec: str) -> Dict[str, FaultRule]:
    """Parse a plan spec into rules (no arming)."""
    rules: Dict[str, FaultRule] = {}
    for raw in spec.replace(";", ",").split(","):
        entry = raw.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"bad fault entry {entry!r} (want point=mode...)")
        point, _, rhs = entry.partition("=")
        point = point.strip()
        parts = [p.strip() for p in rhs.split(":")]
        mode = parts[0]
        positional, opts = _parse_opts(parts[1:], point)
        kw = dict(
            rate=float(opts.get("rate", 1.0)),
            count=int(opts["count"]) if "count" in opts else None,
            after=int(opts.get("after", 0)),
            seed=int(opts.get("seed", 0)),
            message=opts.get("message"),
        )
        if mode == "error":
            exc: object = None
            if positional:
                try:
                    exc = _resolve_exception(positional[0])
                except ValueError:
                    # Not registered YET (env plans parse at import,
                    # ahead of the module that registers the class):
                    # keep the name, resolve at first fire.
                    exc = positional[0]
            rules[point] = FaultRule(point, "error", exc=exc, **kw)
        elif mode == "delay":
            if not positional:
                raise ValueError(f"{point}: delay needs seconds, e.g. delay:2.0")
            rules[point] = FaultRule(
                point, "delay", delay_s=float(positional[0]), **kw
            )
        else:
            raise ValueError(f"{point}: unknown fault mode {mode!r}")
    return rules


def arm(spec: str) -> Dict[str, FaultRule]:
    """Arm a plan spec (merging over any already-armed points)."""
    global _plan
    rules = parse_plan(spec)
    with _plan_lock:
        merged = dict(_plan)
        merged.update(rules)
        _plan = merged
    log.info("fault plan armed: %s",
             "; ".join(r.describe() for r in rules.values()))
    return rules


def arm_point(point: str, rule: FaultRule) -> FaultRule:
    """Arm one pre-built rule (tests that need a custom sleep/exc)."""
    global _plan
    with _plan_lock:
        merged = dict(_plan)
        merged[point] = rule
        _plan = merged
    return rule


def disarm(point: Optional[str] = None) -> None:
    """Drop one point's rule, or the whole plan when ``point`` is None."""
    global _plan
    with _plan_lock:
        if point is None:
            _plan = {}
        elif point in _plan:
            merged = dict(_plan)
            del merged[point]
            _plan = merged


class plan:
    """Context manager: arm a spec, restore the previous plan on exit.

    The chaos suite's idiom::

        with faults.plan("kubelet.register=error:count=2"):
            ...provoke...
    """

    def __init__(self, spec: str):
        self._spec = spec
        self.rules: Dict[str, FaultRule] = {}

    def __enter__(self) -> "plan":
        global _plan
        with _plan_lock:
            self._saved = _plan
        self.rules = arm(self._spec)
        return self

    def __exit__(self, *exc_info: object) -> None:
        global _plan
        with _plan_lock:
            _plan = self._saved

    def fires(self, point: str) -> int:
        return self.rules[point].fires

    def total_fires(self) -> int:
        return sum(r.fires for r in self.rules.values())


def fires(point: str) -> int:
    """Faults delivered so far at ``point`` (0 when unarmed)."""
    rule = _plan.get(point)
    return 0 if rule is None else rule.fires


def snapshot() -> Dict[str, Tuple[int, int]]:
    """point -> (calls, fires) for every armed rule (determinism asserts)."""
    return {p: (r.calls, r.fires) for p, r in _plan.items()}


def reload_from_env(environ: Optional[Dict[str, str]] = None) -> None:
    """Replace the plan from ``TPU_FAULT_PLAN`` (empty/unset disarms)."""
    env = os.environ if environ is None else environ
    spec = env.get(ENV_PLAN, "").strip()
    disarm()
    if spec:
        arm(spec)


# Daemons pick up TPU_FAULT_PLAN just by importing the module — no main()
# wiring to forget. Tests are unaffected: conftest strips TPU_* env.
if os.environ.get(ENV_PLAN, "").strip():
    try:
        reload_from_env()
    except ValueError as e:
        # A typo'd plan must not take the daemon down before main() —
        # the operator armed chaos, not a crash loop.
        log.error("ignoring invalid %s: %s", ENV_PLAN, e)
