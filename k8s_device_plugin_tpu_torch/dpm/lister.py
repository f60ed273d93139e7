"""Lister interface: how the Manager learns which resources to serve.

Mirrors dpm's ListerInterface (vendor .../dpm/lister.go): the lister names
the resource namespace, streams lists of resource last-names as they appear
(static listers push once; dynamic ones keep pushing), and constructs a
plugin implementation per resource.
"""

from __future__ import annotations

import queue
from typing import List, Protocol


class Lister(Protocol):
    def get_resource_namespace(self) -> str:
        """Vendor namespace, e.g. "google.com" for google.com/tpu."""

    def discover(self, out: "queue.Queue[List[str]]") -> None:
        """Push lists of resource last-names into ``out``; may block.

        Called on a daemon thread by Manager.run(). Push once and return for
        a static resource set; keep pushing for dynamic sets.
        """

    def new_plugin(self, resource_last_name: str) -> object:
        """Build the DevicePluginServicer implementation for one resource."""
