"""Per-resource device-plugin gRPC server lifecycle.

Mirrors dpm's devicePlugin (vendor .../dpm/plugin.go): serve on
``<dir>/<namespace>_<name>`` (dpm/plugin.go:54), register with the kubelet
using options from GetDevicePluginOptions (dpm/plugin.go:127-162), make
start/stop idempotent under a lock (dpm/plugin.go:63-91), clean stale
sockets before binding.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent import futures
from typing import Optional

import grpc

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api.deviceplugin.v1beta1 import api_pb2, api_grpc
from k8s_device_plugin_tpu_torch.utils import faults
from k8s_device_plugin_tpu_torch.utils import retry as retrylib

log = logging.getLogger(__name__)

# Registration is retried briefly HERE (transient socket races while the
# kubelet finishes binding its socket) before failing the whole start —
# the manager's outer dpm.server_start retry then re-serves + re-registers
# on its own, slower schedule.
REGISTER_ATTEMPTS = 3
# Tight on purpose: this retry only papers over sub-second socket races;
# anything longer belongs to the manager's schedule (and would let a
# lagging registration from one kubelet restart bleed into the next).
REGISTER_BACKOFF = retrylib.Backoff(base_s=0.05, cap_s=0.25)


class DevicePluginServer:
    def __init__(
        self,
        resource_namespace: str,
        name: str,
        implementation: object,
        device_plugin_dir: str = constants.DEVICE_PLUGIN_PATH,
        api_version: str = constants.VERSION,
    ):
        self.implementation = implementation
        self.name = name
        self.resource_name = f"{resource_namespace}/{name}"
        self.device_plugin_dir = device_plugin_dir
        self.socket_path = os.path.join(
            device_plugin_dir, f"{resource_namespace}_{name}"
        )
        self.api_version = api_version
        self._server: Optional[grpc.Server] = None
        self._running = False
        self._starting = threading.Lock()

    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> None:
        """Serve + register; idempotent (no-op when already running).

        The kubelet registration retries (jittered backoff, up to
        ~30s against a flapping kubelet) run OUTSIDE the ``_starting``
        critical section: holding the lock across them would block a
        concurrent ``stop()`` — a SIGTERM landing mid-backoff — for the
        whole retry budget (tpulint TPU021, the heartbeat-stall seam).
        The lock claims the transition and serves the socket; a second
        ``start()`` arriving during registration sees ``_running`` and
        returns (re-registration is idempotent kubelet-side anyway).
        """
        with self._starting:
            if self._running:
                return
            self._serve()
            self._running = True
        try:
            self._register()
        except Exception:
            self.stop()
            raise
        log.info("%s: serving %s on %s", self.name, self.resource_name, self.socket_path)

    def _serve(self) -> None:
        self._cleanup_socket()
        server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix=f"dp-{self.name}"
            )
        )
        api_grpc.add_DevicePluginServicer_to_server(self.implementation, server)
        server.add_insecure_port(f"unix://{self.socket_path}")
        server.start()
        self._server = server

    def _register(self) -> None:
        kubelet_socket = os.path.join(
            self.device_plugin_dir, constants.KUBELET_SOCKET_NAME
        )

        def _attempt() -> None:
            # Chaos hook: a registration RPC that errors mid-burst is
            # the exact failure a kubelet restart produces.
            faults.inject("kubelet.register",
                          resource=self.resource_name)
            with grpc.insecure_channel(
                f"unix://{kubelet_socket}"
            ) as channel:
                stub = api_grpc.RegistrationStub(channel)
                options = self.implementation.GetDevicePluginOptions(
                    api_pb2.Empty(), None
                )
                request = api_pb2.RegisterRequest(
                    version=self.api_version,
                    endpoint=os.path.basename(self.socket_path),
                    resource_name=self.resource_name,
                    options=options,
                )
                stub.Register(request, timeout=10)

        retrylib.retry_call(
            _attempt,
            component="kubelet.register",
            backoff=REGISTER_BACKOFF,
            max_attempts=REGISTER_ATTEMPTS,
            # No socket file -> the kubelet is GONE, not flaky: fail
            # fast and let the manager's inotify watcher re-start us
            # when it returns. Retrying here would stall the manager's
            # event loop behind sleeps precisely while restart events
            # are queueing up (the lag cascade the chaos burst test
            # catches).
            giveup=lambda e: not os.path.exists(kubelet_socket),
        )
        log.info("%s: registered with kubelet as %s", self.name, self.resource_name)

    def stop(self) -> None:
        with self._starting:
            self._stop_locked()

    def _stop_locked(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5).wait()
            self._server = None
        self._running = False
        self._cleanup_socket()

    def _cleanup_socket(self) -> None:
        try:
            os.remove(self.socket_path)
        except FileNotFoundError:
            pass
        except OSError as e:
            log.error("%s: cannot remove socket %s: %s", self.name, self.socket_path, e)
            raise
