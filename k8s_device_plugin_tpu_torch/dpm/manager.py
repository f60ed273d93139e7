"""Device-plugin Manager: resource discovery + kubelet lifecycle handling.

Mirrors dpm's Manager.Run (vendor .../dpm/manager.go:41-94):

  - a Lister pushes resource-name lists; new names get plugin servers,
    vanished names get stopped (handleNewPlugins, manager.go:96-134)
  - kubelet.sock CREATE -> (re)start+re-register every plugin server;
    REMOVE -> stop servers (manager.go:73-84) — this is how kubelet
    restarts are survived
  - plugin-server start is retried 3x with 3s waits (manager.go:17-19,
    205-219)
  - SIGTERM/SIGINT/SIGQUIT stop everything and return (manager.go:47-48)

The reference's optional Start()/Stop() plugin hooks (dpm/plugin.go:26-37)
are honoured by duck-typing: implementations may define start()/stop().
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import threading
from typing import Dict, List, Optional

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.dpm.inotify import DirWatcher, FileEvent
from k8s_device_plugin_tpu_torch.dpm.lister import Lister
from k8s_device_plugin_tpu_torch.dpm.plugin_server import DevicePluginServer
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import retry as retrylib

log = logging.getLogger(__name__)


def _active_plugins_gauge():
    return obs_metrics.gauge(
        "tpu_dpm_active_plugins_count",
        "plugin servers currently managed (one per advertised resource)",
    )


def _plugin_starts_counter():
    return obs_metrics.counter(
        "tpu_dpm_plugin_starts_total",
        "plugin server start attempts by outcome",
        labels=("resource", "outcome"),
    )

START_RETRIES = 3
START_RETRY_WAIT_S = 3.0


class Manager:
    def __init__(
        self,
        lister: Lister,
        device_plugin_dir: str = constants.DEVICE_PLUGIN_PATH,
        start_retries: int = START_RETRIES,
        start_retry_wait_s: float = START_RETRY_WAIT_S,
        install_signal_handlers: bool = True,
    ):
        self._lister = lister
        self._dir = device_plugin_dir
        self._retries = start_retries
        # Shared engine, not a fixed time.sleep: with multiple plugin
        # servers retrying against a flapping kubelet, lockstep 3s waits
        # synchronize every re-registration attempt into the same
        # instant; full jitter over an exponential ceiling spreads them.
        self._start_backoff = retrylib.Backoff(
            base_s=start_retry_wait_s, cap_s=max(start_retry_wait_s, 30.0)
        )
        self._install_signals = install_signal_handlers
        self._plugins: Dict[str, DevicePluginServer] = {}
        self._events: "queue.Queue" = queue.Queue()
        self._stopped = threading.Event()
        # Set directly from the signal handler: Queue.put from a handler
        # can deadlock against a main thread blocked in Queue.get (one
        # non-reentrant mutex), so signals only flip this event and the
        # main loop polls it.
        self._stop_requested = threading.Event()

    # -- event producers -----------------------------------------------------

    def _on_fs_event(self, ev: FileEvent) -> None:
        if ev.name == constants.KUBELET_SOCKET_NAME:
            self._events.put(("kubelet", ev))

    def _discover_thread(self) -> None:
        resource_queue: "queue.Queue[List[str]]" = queue.Queue()
        thread = threading.Thread(
            target=self._lister.discover,
            args=(resource_queue,),
            name="dpm-discover",
            daemon=True,
        )
        thread.start()
        while not self._stopped.is_set():
            try:
                names = resource_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            self._events.put(("resources", names))

    def stop(self) -> None:
        """Request run() to shut everything down and return."""
        # The event first: a main loop blocked in a start-retry backoff
        # wakes from the interruptible wait before it would ever read
        # the queue.
        self._stop_requested.set()
        self._events.put(("signal", None))

    # -- main loop -----------------------------------------------------------

    def run(self) -> None:
        log.info("starting device plugin manager (dir=%s)", self._dir)
        if self._install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGQUIT):
                signal.signal(sig, lambda *_: self._stop_requested.set())

        watcher = DirWatcher(self._dir, self._on_fs_event)
        watcher.start()
        pump = threading.Thread(
            target=self._discover_thread, name="dpm-discover-pump", daemon=True
        )
        pump.start()

        try:
            while True:
                try:
                    kind, payload = self._events.get(timeout=0.5)
                except queue.Empty:
                    if self._stop_requested.is_set():
                        log.info("shutdown requested by signal")
                        break
                    continue
                if kind == "resources":
                    self._handle_new_plugins(payload)
                elif kind == "kubelet":
                    ev: FileEvent = payload
                    if ev.created:
                        log.info("kubelet socket appeared; (re)starting plugin servers")
                        obs_metrics.counter(
                            "tpu_dpm_kubelet_events_total",
                            "kubelet socket lifecycle events observed",
                            labels=("event",),
                        ).inc(event="created")
                        self._start_all()
                    elif ev.deleted:
                        log.info("kubelet socket removed; stopping plugin servers")
                        obs_metrics.counter(
                            "tpu_dpm_kubelet_events_total",
                            "kubelet socket lifecycle events observed",
                            labels=("event",),
                        ).inc(event="removed")
                        self._stop_all_servers()
                elif kind == "signal":
                    log.info("shutdown requested")
                    break
        finally:
            self._stopped.set()
            self._stop_all_plugins()
            watcher.stop()

    # -- plugin bookkeeping --------------------------------------------------

    def _handle_new_plugins(self, names: List[str]) -> None:
        wanted = set(names)
        for name in names:
            if name in self._plugins:
                continue
            log.info("adding plugin %r", name)
            server = DevicePluginServer(
                self._lister.get_resource_namespace(),
                name,
                self._lister.new_plugin(name),
                device_plugin_dir=self._dir,
            )
            self._start_plugin(server)
            self._plugins[name] = server
        for name in list(self._plugins):
            if name not in wanted:
                log.info("removing unused plugin %r", name)
                self._stop_plugin(self._plugins.pop(name))
        _active_plugins_gauge().set(len(self._plugins))

    def _start_plugin(self, server: DevicePluginServer) -> None:
        impl_start = getattr(server.implementation, "start", None)
        if callable(impl_start):
            try:
                impl_start()
            except Exception as e:
                log.error("plugin %s Start() failed: %s", server.name, e)
                return
        self._start_server_with_retries(server)

    def _start_server_with_retries(self, server: DevicePluginServer) -> None:
        # The retry sleep waits on _stop_requested, so a SIGTERM during
        # a kubelet outage interrupts the backoff instead of blocking
        # the event loop for the rest of the schedule (the old fixed
        # time.sleep held the loop hostage mid-shutdown).
        def _attempt() -> None:
            server.start()
            _plugin_starts_counter().inc(resource=server.name, outcome="ok")

        def _on_retry(attempt: int, exc: BaseException, delay: float) -> None:
            _plugin_starts_counter().inc(resource=server.name,
                                         outcome="error")
            log.warning(
                "start %s attempt %d/%d failed (%s); retrying in %.2fs",
                server.name, attempt, self._retries, exc, delay,
            )

        try:
            retrylib.retry_call(
                _attempt,
                component="dpm.server_start",
                backoff=self._start_backoff,
                max_attempts=self._retries,
                stop_event=self._stop_requested,
                on_retry=_on_retry,
            )
        except retrylib.RetryAborted as e:
            log.info("start %s abandoned: %s", server.name, e)
        except Exception as e:
            _plugin_starts_counter().inc(resource=server.name,
                                         outcome="error")
            log.error(
                "failed to start %s server within %d tries: %s",
                server.name, self._retries, e,
            )

    def _stop_plugin(self, server: DevicePluginServer) -> None:
        # Implementation stop runs first so plugins can mark the shutdown
        # orderly before the gRPC server cancels their in-flight streams
        # (TPUDevicePlugin distinguishes orderly stops from kubelet stream
        # loss, which triggers its exit-to-re-register path).
        impl_stop = getattr(server.implementation, "stop", None)
        if callable(impl_stop):
            try:
                impl_stop()
            except Exception as e:
                log.error("plugin %s Stop() failed: %s", server.name, e)
        server.stop()

    def _start_all(self) -> None:
        for server in self._plugins.values():
            # Re-arm the implementation first: a plugin stopped by a kubelet
            # restart must clear its orderly-stop state (and refresh
            # hardware) before its server re-registers.
            impl_start = getattr(server.implementation, "start", None)
            if callable(impl_start):
                try:
                    impl_start()
                except Exception as e:
                    log.error("plugin %s Start() failed: %s", server.name, e)
                    continue
            self._start_server_with_retries(server)

    def _stop_all_servers(self) -> None:
        # Mark each implementation stopped *before* cancelling its streams,
        # so a kubelet restart is an orderly pause rather than looking like
        # an unexpected stream loss (which would fire the plugin's
        # exit-to-re-register path and kill the daemon on every kubelet
        # restart).
        for server in self._plugins.values():
            impl_stop = getattr(server.implementation, "stop", None)
            if callable(impl_stop):
                try:
                    impl_stop()
                except Exception as e:
                    log.error("plugin %s Stop() failed: %s", server.name, e)
            server.stop()

    def _stop_all_plugins(self) -> None:
        for name in list(self._plugins):
            self._stop_plugin(self._plugins.pop(name))
        _active_plugins_gauge().set(0)
