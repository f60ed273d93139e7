"""Crash-safe allocation/health checkpointing (ISSUE 4 tentpole).

All allocation state (TPU_ALLOCATION_ID, device -> pod assignments,
partition claims) used to live only in process memory, so a plugin
restart forgot which chips were held by running pods and could
double-assign a topology group. This module persists that state with
the classic durability discipline:

- **write-tmp -> fsync -> rename** (:func:`atomic_write_json`, the ONE
  helper state-file writes must route through — tpulint TPU009 flags
  renames that skip it): a crash mid-write leaves either the old file
  or the new file, never a torn one;
- **versioned envelope**: ``{"version": 1, "written_at": ..., "payload":
  ...}`` so future schema changes are detected, not misparsed;
- **corrupt/stale files are quarantined, not crashed on**: a truncated
  or unparseable checkpoint is renamed aside (``*.corrupt-<ts>``) and
  the plugin degrades to empty state with a logged warning.

Fault points ``checkpoint.write`` and ``checkpoint.load`` make both
failure directions chaos-testable (``TPU_FAULT_PLAN``).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Optional

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import faults

log = logging.getLogger(__name__)

__all__ = [
    "CHECKPOINT_VERSION",
    "DEFAULT_CHECKPOINT_DIR",
    "ENV_CHECKPOINT_DIR",
    "CheckpointStore",
    "atomic_write_bytes",
    "atomic_write_json",
    "default_checkpoint_dir",
]

CHECKPOINT_VERSION = 1
ENV_CHECKPOINT_DIR = "TPU_CHECKPOINT_DIR"
DEFAULT_CHECKPOINT_DIR = "/var/lib/tpu-device-plugin"


def default_checkpoint_dir() -> str:
    """The daemon default: ``TPU_CHECKPOINT_DIR`` or the hostPath the
    shipped manifests mount."""
    return os.environ.get(ENV_CHECKPOINT_DIR) or DEFAULT_CHECKPOINT_DIR


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durably replace ``path`` with ``data`` (the binary twin of
    :func:`atomic_write_json` — same tmp -> fsync -> rename ->
    fsync(dir) discipline, for artifacts that are not JSON, e.g. the
    serialized XLA executables of the persistent compilation cache).
    """
    dirpath = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(
        dir=dirpath, prefix=os.path.basename(path) + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(dirpath, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: object, **json_kw: object) -> None:
    """Durably replace ``path`` with ``obj`` serialized as JSON.

    tmp in the same directory -> flush -> fsync(file) -> rename ->
    fsync(directory). Raises OSError on failure (callers decide whether
    a failed state write is fatal); the tmp file never survives.
    """
    atomic_write_bytes(
        path, json.dumps(obj, **json_kw).encode("utf-8")
    )


def _c_writes():
    return obs_metrics.counter(
        "tpu_plugin_checkpoint_writes_total",
        "allocation-checkpoint write attempts by outcome",
        labels=("outcome",),
    )


def _c_loads():
    return obs_metrics.counter(
        "tpu_plugin_checkpoint_loads_total",
        "allocation-checkpoint load attempts by outcome",
        labels=("outcome",),
    )


class CheckpointStore:
    """One checkpoint file, owned by one plugin instance.

    ``save`` is deliberately non-raising: a checkpoint write failure
    must degrade the restart story, never fail the Allocate RPC that
    triggered it. ``load`` is equally non-raising: any unreadable file
    quarantines aside and yields empty state.
    """

    def __init__(self, path: str):
        self.path = path

    def save(self, payload: dict) -> bool:
        """Write ``payload`` under the versioned envelope; True on
        success. Failures are logged (warn-once per outage) + counted."""
        envelope = {
            "version": CHECKPOINT_VERSION,
            # tpulint: disable=TPU011 — operator-facing wall-clock stamp
            "written_at": time.time(),
            "payload": payload,
        }
        try:
            faults.inject("checkpoint.write", path=self.path)
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            atomic_write_json(self.path, envelope, sort_keys=True)
        except (OSError, faults.FaultError) as e:
            _c_writes().inc(outcome="error")
            if self._write_was_ok:
                log.warning(
                    "checkpoint write to %s failed (%s); allocation state "
                    "will not survive a restart until this recovers",
                    self.path, e,
                )
            self._write_was_ok = False
            return False
        if not self._write_was_ok:
            log.info("checkpoint writes to %s recovered", self.path)
        self._write_was_ok = True
        _c_writes().inc(outcome="ok")
        return True

    # warn-once bookkeeping (class default so __init__ stays trivial and
    # restored instances behave identically)
    _write_was_ok = True

    def load(self) -> Optional[dict]:
        """The payload of a valid checkpoint, or None (no file, or a
        corrupt/stale file — which is quarantined aside)."""
        try:
            faults.inject("checkpoint.load", path=self.path)
            with open(self.path, encoding="utf-8") as f:
                raw = f.read()
        except FileNotFoundError:
            _c_loads().inc(outcome="absent")
            return None
        except (OSError, faults.FaultError) as e:
            # Unreadable is not provably corrupt: leave the file for the
            # operator, start empty.
            log.warning(
                "cannot read checkpoint %s (%s); starting with empty "
                "allocation state", self.path, e,
            )
            _c_loads().inc(outcome="error")
            return None
        try:
            envelope = json.loads(raw)
            if not isinstance(envelope, dict):
                raise ValueError("checkpoint root is not an object")
            version = envelope.get("version")
            if version != CHECKPOINT_VERSION:
                raise ValueError(
                    f"unsupported checkpoint version {version!r} "
                    f"(want {CHECKPOINT_VERSION})"
                )
            payload = envelope.get("payload")
            if not isinstance(payload, dict):
                raise ValueError("checkpoint payload is not an object")
        except ValueError as e:
            quarantined = self._quarantine_corrupt()
            log.warning(
                "corrupt/stale checkpoint %s (%s); moved to %s, starting "
                "with empty allocation state", self.path, e, quarantined,
            )
            _c_loads().inc(outcome="corrupt")
            return None
        _c_loads().inc(outcome="ok")
        return payload

    def _quarantine_corrupt(self) -> str:
        """Move the unparseable file aside so the next save starts clean
        and the evidence survives for the operator."""
        # tpulint: disable=TPU011 — wall-clock quarantine filename suffix
        dest = f"{self.path}.corrupt-{int(time.time())}"
        n = 0
        while os.path.exists(dest):
            n += 1
            # tpulint: disable=TPU011 — wall-clock quarantine filename suffix
            dest = f"{self.path}.corrupt-{int(time.time())}.{n}"
        try:
            os.replace(self.path, dest)
        except OSError as e:
            log.error("cannot quarantine corrupt checkpoint %s: %s",
                      self.path, e)
            try:
                os.remove(self.path)
            except OSError:
                pass
        return dest

    def delete(self) -> None:
        """Remove the checkpoint (tests / operator reset)."""
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
