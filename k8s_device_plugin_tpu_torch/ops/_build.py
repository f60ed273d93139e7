"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which ``ctypes`` loads.
Nothing includes PyTorch's headers, so a build takes seconds. Builds
happen at first use, never at import, into ``build/kernels/`` at the
root of the checkout. The library's file name carries a digest of its
source and of the shared headers (``csrc/*.cuh``), so an edited source
never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
_REPO = os.path.dirname(os.path.dirname(CSRC))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILD_DIR = os.path.join(_REPO, "build", "kernels")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (digest of the source and the
    shared headers in the file name)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


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
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = compile_source(name)
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
