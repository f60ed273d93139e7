"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which ``ctypes`` loads.
Nothing includes PyTorch's headers, so a build takes seconds. Builds
happen at first use, never at import, into ``build/kernels/`` at the
root of the checkout. The library's file name carries a digest of its
source and of the shared headers (``csrc/*.cuh``), so an edited source
never loads a stale build.

With a persistent cache set (``set_persistent_cache``, which
``LMServer(compile_cache_dir=)`` and ``llm-serve --compile-cache-dir``
do; models/compile_cache.py), ``load`` first asks that cache for the
library of the source's digest: a verified entry is opened without
nvcc; a miss builds with nvcc into a private directory, writes the
library back and opens it; an entry that fails to open is quarantined
and rebuilt. ``stats()`` counts nvcc runs and libraries opened from
the cache, which the serving dispatch reads to tell ``phase="load"``
from ``phase="compile"``. A library already open in the process is
never opened again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
_REPO = os.path.dirname(os.path.dirname(CSRC))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILD_DIR = os.path.join(_REPO, "build", "kernels")

_lock = threading.Lock()
_lock_stats = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# The process-wide persistent cache (a models.compile_cache.CompileCache)
# and the counts of nvcc runs and of libraries opened from it.
_persistent = None
_stats = {"builds": 0, "cache_loads": 0}


def _c_builds():
    return obs_metrics.counter(
        "tpu_serve_kernel_builds_total",
        "nvcc runs building a kernel library (csrc/<lib>.cu); a warm "
        "restart on a persistent compile cache runs none",
        labels=("lib",),
    )


def set_persistent_cache(cache) -> None:
    """Route ``load`` through ``cache`` (None: the build directory
    only, the default)."""
    global _persistent
    with _lock:
        _persistent = cache


def stats() -> dict:
    """{"builds": nvcc runs, "cache_loads": libraries opened from the
    persistent cache} since the process started."""
    with _lock_stats:
        return dict(_stats)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels build on the machine with the card"
    )


def source_digest(name: str) -> str:
    """sha256 of ``csrc/<name>.cu`` and the shared headers, in hex."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (digest of the source and the
    shared headers in the file name)."""
    return os.path.join(BUILD_DIR, f"lib{name}-{source_digest(name)[:12]}.so")


def _nvcc(name: str, out: str) -> str:
    """Run nvcc on ``csrc/<name>.cu`` into ``out``; returns its output
    (``-Xptxas -v``'s report) and raises when it fails."""
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with _lock_stats:
        _stats["builds"] += 1
    _c_builds().inc(lib=name)
    return proc.stdout + proc.stderr


def compile_source(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` if its library is not built yet.

    Returns (library path, nvcc's output: ``-Xptxas -v`` register and
    shared-memory report, empty when the build was already there). The
    library is written under a temporary name and renamed, so builds
    racing from several processes never load a half-written file.
    """
    out = library_path(name)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    report = _nvcc(name, tmp)
    os.replace(tmp, out)
    return out, report


def _open_private(path: str) -> ctypes.CDLL:
    """Open a process-private library file, then unlink it (the mapping
    outlives the name)."""
    try:
        return ctypes.CDLL(path)
    finally:
        try:
            os.remove(path)
        except OSError:
            pass


def _load_cached(name: str, cache) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library through the persistent cache: its
    verified entry, else an nvcc build written back. An entry the loader
    refuses is quarantined and rebuilt; a failed nvcc raises."""
    digest = source_digest(name)
    private = cache.load(name, digest)
    if private is not None:
        try:
            lib = _open_private(private)
        except OSError as e:
            cache.reject(cache.entry_path(name, digest),
                         f"the loader refused it: {e}")
        else:
            with _lock_stats:
                _stats["cache_loads"] += 1
            return lib
    tmpdir = tempfile.mkdtemp(prefix="kernels-")
    try:
        out = os.path.join(tmpdir, f"lib{name}.so")
        _nvcc(name, out)
        cache.stage(name, digest, out)
        return ctypes.CDLL(out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first call
    (through the persistent cache when one is set)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _persistent is not None and _persistent.dir is not None:
                lib = _load_cached(name, _persistent)
            else:
                path, _ = compile_source(name)
                lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
