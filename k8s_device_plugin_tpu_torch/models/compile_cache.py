"""Persistent kernel-library cache: the port's ``--compile-cache-dir``.

The counterpart of ``k8s_device_plugin_tpu/models/compile_cache.py``.
The reference keeps serialized XLA executables; the one artifact the
eager port builds is the nvcc library of each hand-written kernel source
(``csrc/<name>.cu``, ops/_build.py), so that is what this store keeps:
one entry per source, so a fresh pod or a restarted replica that shares
the directory opens the libraries another process built instead of
running nvcc again.

- **Key.** An entry's name is the source's name and digest (the ``.cu``
  file plus the shared ``csrc/*.cuh`` headers, ``_build.source_digest``):
  an edited source never matches an old entry.
- **Header.** Each entry carries ``backend_fingerprint()`` (nvcc's
  release line, ``NVCC_FLAGS``, the card's compute capability and name,
  ``torch.version.cuda``) and the payload's sha256. Both are checked
  before anything is opened: a mismatch, a truncated file or a bad
  checksum is quarantined aside (``*.corrupt-<ts>``), counted in
  ``tpu_serve_compile_cache_corrupt_total``, and the caller builds with
  nvcc, as the reference degrades to a plain compile.
- **Writes** go tmp -> fsync -> rename -> fsync(dir)
  (``atomic_write_bytes``, the reference's dpm/checkpoint.py helper
  statement for statement; tests/test_torch_isolation.py holds it to
  it); fault points
  ``compile_cache.read`` / ``compile_cache.write`` make both directions
  chaos-testable.
- **LRU cap.** Loads touch the entry's mtime, and the writer evicts the
  least recently used entries past ``TPU_COMPILE_CACHE_MAX_BYTES``.
- **Loading.** A verified payload is written to a process-private file,
  which the caller opens with ``ctypes.CDLL`` and may then unlink.

A directory that cannot be created disables the store, with a log line:
serving comes up exactly as without one. The five metric families are
the reference's, by name.

Security note: an entry is a shared library the process maps and runs;
the cache directory must be operator-owned, as the reference's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import subprocess
import tempfile
import time
from typing import Optional

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.utils import faults

log = logging.getLogger("llm-serve")

__all__ = [
    "CACHE_VERSION",
    "ENV_COMPILE_CACHE_DIR",
    "ENV_COMPILE_CACHE_MAX_BYTES",
    "CompileCache",
    "backend_fingerprint",
    "cache_dir_from_env",
    "max_bytes_from_env",
]

CACHE_VERSION = 1
ENV_COMPILE_CACHE_DIR = "TPU_COMPILE_CACHE_DIR"
ENV_COMPILE_CACHE_MAX_BYTES = "TPU_COMPILE_CACHE_MAX_BYTES"

# Entry file layout: MAGIC, u32 header length, header JSON, payload.
_MAGIC = b"TPUKL001"
_SUFFIX = ".culib"


def _c_hits():
    return obs_metrics.counter(
        "tpu_serve_compile_cache_hits_total",
        "kernel libraries opened from the persistent cache (no nvcc run)",
    )


def _c_misses():
    return obs_metrics.counter(
        "tpu_serve_compile_cache_misses_total",
        "persistent-cache probes that found no usable entry (absent, "
        "unreadable, corrupt, or fingerprint-mismatched)",
    )


def _c_writes():
    return obs_metrics.counter(
        "tpu_serve_compile_cache_writes_total",
        "kernel libraries written back to the persistent cache",
    )


def _c_evictions():
    return obs_metrics.counter(
        "tpu_serve_compile_cache_evictions_total",
        "entries removed by the size-capped LRU GC "
        "(TPU_COMPILE_CACHE_MAX_BYTES)",
    )


def _c_corrupt():
    return obs_metrics.counter(
        "tpu_serve_compile_cache_corrupt_total",
        "corrupt or fingerprint-mismatched entries quarantined aside "
        "(*.corrupt-<ts>) with degrade to an nvcc build",
    )


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durably replace ``path`` with ``data``: tmp in the same directory
    -> fsync -> rename -> fsync(dir), so a reader sees the old entry or
    the new one, never a torn one."""
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


def cache_dir_from_env() -> Optional[str]:
    """The configured cache directory, or None (cache disabled)."""
    return os.environ.get(ENV_COMPILE_CACHE_DIR) or None


def max_bytes_from_env() -> Optional[int]:
    raw = os.environ.get(ENV_COMPILE_CACHE_MAX_BYTES, "")
    try:
        n = int(raw) if raw else 0
    except ValueError:
        log.warning("%s=%r is not an integer; LRU cap disabled",
                    ENV_COMPILE_CACHE_MAX_BYTES, raw)
        return None
    return n if n > 0 else None


def _nvcc_release() -> str:
    """nvcc's ``release`` line, or ``none`` where there is no nvcc."""
    from k8s_device_plugin_tpu_torch.ops import _build

    try:
        out = subprocess.run([_build.nvcc_path(), "--version"],
                             capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        log.debug("no nvcc version for the fingerprint: %s", e)
        return "none"
    lines = [ln.strip() for ln in out.stdout.splitlines() if "release" in ln]
    return lines[-1] if lines else "unknown"


def backend_fingerprint() -> str:
    """Identity of everything a built library depends on besides its
    source: nvcc's release, the build flags, the card's compute
    capability and name, and the CUDA version torch was built for. Any
    difference makes a stored library unusable by contract, so it is
    verified before every open."""
    import torch

    from k8s_device_plugin_tpu_torch.ops import _build

    parts = [f"nvcc={_nvcc_release()}",
             f"flags={' '.join(_build.NVCC_FLAGS)}",
             f"torch_cuda={torch.version.cuda}"]
    if torch.cuda.is_available():
        cap = torch.cuda.get_device_capability(0)
        parts.append(f"sm={cap[0]}{cap[1]}")
        parts.append(f"device={torch.cuda.get_device_name(0)}")
    else:
        parts.append("device=none")
    return ";".join(parts)


class CompileCache:
    """One cache directory, shared by any number of processes.

    Every entry point is non-raising by design: a broken cache degrades
    to the nvcc build the process would have run anyway, never to a
    failed request. Calls come from ``_build.load`` under its lock;
    cross-process safety comes from atomic renames.
    """

    def __init__(self, directory: str, max_bytes: Optional[int] = None):
        self.dir = directory
        self.max_bytes = max_bytes
        self.fingerprint = backend_fingerprint()
        self._warned_write = False
        self._warned_read = False
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError as e:
            log.warning("cannot create compile cache dir %s (%s); "
                        "cache disabled", self.dir, e)
            self.dir = None

    def entry_path(self, name: str, digest: str) -> str:
        """Where the entry of (name, digest) lives."""
        return os.path.join(self.dir, f"lib{name}-{digest}{_SUFFIX}")

    # ------------------------------------------------------------------
    # load / stage
    # ------------------------------------------------------------------

    def load(self, name: str, digest: str) -> Optional[str]:
        """A process-private file holding the verified library of
        ``csrc/<name>.cu`` at ``digest``, or None.

        Misses, unreadable files and quarantines all return None: the
        caller builds with nvcc, exactly as if the cache did not exist.
        The caller opens the file and may unlink it afterwards."""
        if self.dir is None:
            return None
        path = self.entry_path(name, digest)
        try:
            faults.inject("compile_cache.read", fn=name, path=path)
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            _c_misses().inc()
            return None
        except (OSError, faults.FaultError) as e:
            # Unreadable is not provably corrupt: leave the file for the
            # operator, pay the build.
            if not self._warned_read:
                log.warning("compile cache read failed (%s); degrading "
                            "to nvcc builds", e)
                self._warned_read = True
            _c_misses().inc()
            return None
        payload = self._parse(path, blob)
        if payload is None:
            _c_misses().inc()
            return None
        fd, private = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
        except OSError as e:
            log.warning("cannot write a private copy of %s (%s); "
                        "building instead", os.path.basename(path), e)
            _remove(private)
            _c_misses().inc()
            return None
        # LRU bookkeeping: a hit is a use (best-effort; shared volumes
        # may be read-only for followers).
        try:
            os.utime(path, None)
        except OSError:
            pass
        _c_hits().inc()
        return private

    def _parse(self, path: str, blob: bytes) -> Optional[bytes]:
        """Validated payload bytes, or None (file quarantined)."""
        try:
            if blob[:8] != _MAGIC:
                raise ValueError("bad magic")
            (hlen,) = struct.unpack("<I", blob[8:12])
            header = json.loads(blob[12:12 + hlen].decode("utf-8"))
            payload = blob[12 + hlen:]
            if header.get("version") != CACHE_VERSION:
                raise ValueError(
                    f"unsupported entry version {header.get('version')!r}"
                )
            digest = hashlib.sha256(payload).hexdigest()
            if header.get("payload_sha256") != digest:
                raise ValueError("payload checksum mismatch")
            if header.get("fingerprint") != self.fingerprint:
                raise ValueError(
                    f"backend fingerprint mismatch (entry: "
                    f"{header.get('fingerprint')!r})"
                )
        except (ValueError, KeyError, IndexError, struct.error,
                UnicodeDecodeError, json.JSONDecodeError) as e:
            self.reject(path, str(e))
            return None
        return payload

    def reject(self, path: str, why: str) -> None:
        """Quarantine an entry that cannot be used (a bad header, or a
        payload the loader refused to open) and count it corrupt."""
        log.warning(
            "corrupt compile cache entry %s (%s); quarantined, "
            "degrading to an nvcc build", os.path.basename(path), why,
        )
        self._quarantine(path)
        _c_corrupt().inc()

    def stage(self, name: str, digest: str, library: str) -> None:
        """Write the freshly built ``library`` file back as the entry of
        (name, digest). Failures are logged once and never raised."""
        if self.dir is None:
            return
        try:
            with open(library, "rb") as f:
                payload = f.read()
        except OSError as e:
            log.warning("cannot read built library %s: %s", library, e)
            return
        header = json.dumps({
            "version": CACHE_VERSION,
            "fn": name,
            "key": digest,
            "fingerprint": self.fingerprint,
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "created_at": time.time(),
        }, sort_keys=True).encode("utf-8")
        blob = _MAGIC + struct.pack("<I", len(header)) + header + payload
        path = self.entry_path(name, digest)
        try:
            faults.inject("compile_cache.write", fn=name, path=path)
            atomic_write_bytes(path, blob)
        except (OSError, faults.FaultError) as e:
            if not self._warned_write:
                log.warning(
                    "compile cache write to %s failed (%s); replicas "
                    "will rebuild until this recovers", self.dir, e,
                )
                self._warned_write = True
            return
        self._warned_write = False
        _c_writes().inc()
        self.gc()

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    def _quarantine(self, path: str) -> None:
        """Move an unusable entry aside so the next write starts clean
        and the evidence survives for the operator."""
        dest = f"{path}.corrupt-{int(time.time())}"
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = f"{path}.corrupt-{int(time.time())}.{n}"
        try:
            # Move-aside of an already-unusable file: torn durability is
            # acceptable here, the entry is dead either way.
            os.replace(path, dest)
        except OSError as e:
            log.warning("cannot quarantine compile cache entry %s: %s",
                        path, e)
            _remove(path)

    def entries(self):
        """[(path, size, mtime)] of live entries, oldest-use first."""
        out = []
        try:
            names = os.listdir(self.dir)
        except (OSError, TypeError):
            return out
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            path = os.path.join(self.dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((path, st.st_size, st.st_mtime))
        out.sort(key=lambda e: e[2])
        return out

    def gc(self) -> int:
        """Evict least-recently-used entries past ``max_bytes``;
        returns the number evicted. No-op without a cap."""
        if not self.max_bytes or self.dir is None:
            return 0
        entries = self.entries()
        total = sum(size for _, size, _ in entries)
        evicted = 0
        for path, size, _ in entries:
            if total <= self.max_bytes:
                break
            try:
                os.remove(path)
            except OSError:
                continue
            total -= size
            evicted += 1
            _c_evictions().inc()
        if evicted:
            log.info("compile cache GC: evicted %d entr%s (cap %d bytes)",
                     evicted, "y" if evicted == 1 else "ies",
                     self.max_bytes)
        return evicted


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
