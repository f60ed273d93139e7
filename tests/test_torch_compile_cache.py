"""The port's persistent kernel cache (models/compile_cache.py) and its
use by ops/_build.py and the serving dispatch, on the CPU.

Each case of the reference's tests/test_compile_cache.py that applies to
a store of kernel libraries, mirrored: the binary atomic write; the
round trip; a miss on an absent entry and on another source digest;
corrupt, checksum-mismatched and fingerprint-mismatched entries
quarantined (``*.corrupt-<ts>``) with degrade to a build; a verified
entry the loader refuses (the reference's undeserializable payload);
the LRU order and the uncapped no-op; read and write faults; the env
knobs; an unwritable directory.

There is no nvcc here, so ``gcc`` builds a tiny C library as its stand-in
(``_build``'s compiler and flags patched, its source directory a temp
one): the real ``dlopen`` path runs, and the library's function is
called. The cases skip only where ``gcc`` is missing. The real nvcc case
is in tests/test_torch_kernels_gpu.py.
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from k8s_device_plugin_tpu_torch.models import compile_cache as cc_mod
from k8s_device_plugin_tpu_torch.models import serve_http
from k8s_device_plugin_tpu_torch.models.compile_cache import (
    CompileCache,
    atomic_write_bytes,
)
from k8s_device_plugin_tpu_torch.models.serve import LMServer
from k8s_device_plugin_tpu_torch.models.transformer import LMConfig
from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics
from k8s_device_plugin_tpu_torch.ops import _build
from k8s_device_plugin_tpu_torch.utils import faults

GCC = shutil.which("gcc")
needs_gcc = pytest.mark.skipif(GCC is None, reason="needs gcc as the "
                               "stand-in compiler")
FP = "test-fingerprint"
SRC = "int answer(void) { return %d; }\n"


@pytest.fixture()
def registry():
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.install(reg)
    yield reg
    obs_metrics.uninstall()


def _cache(directory):
    """A store on ``directory`` with a fixed fingerprint."""
    cache = CompileCache(str(directory))
    cache.fingerprint = FP
    return cache


def _counter(reg, name):
    c = reg.get(name)
    return c.value() if c is not None else 0.0


def _build_lib(tmp_path, value=42, name="tiny"):
    """A shared library whose ``answer()`` returns ``value``."""
    src = tmp_path / f"{name}-{value}.c"
    src.write_text(SRC % value)
    out = tmp_path / f"lib{name}-{value}.so"
    subprocess.run([GCC, "-shared", "-fPIC", "-o", str(out), str(src)],
                   check=True)
    return str(out)


def _answer(path):
    lib = ctypes.CDLL(path)
    lib.answer.restype = ctypes.c_int
    return lib.answer()


def _entries(d):
    return [p for p in d.iterdir() if p.name.endswith(".culib")]


# ---------------------------------------------------------------------------
# atomic_write_bytes (the reference's; tests/test_torch_isolation.py
# holds its statements to it)
# ---------------------------------------------------------------------------

def test_atomic_write_bytes_round_trip(tmp_path):
    path = tmp_path / "blob.bin"
    atomic_write_bytes(str(path), b"\x00\x01payload\xff")
    assert path.read_bytes() == b"\x00\x01payload\xff"
    atomic_write_bytes(str(path), b"replaced")
    assert path.read_bytes() == b"replaced"
    assert [p.name for p in tmp_path.iterdir()] == ["blob.bin"]


def test_atomic_write_bytes_failure_leaves_no_tmp(tmp_path, monkeypatch):
    path = tmp_path / "blob.bin"
    monkeypatch.setattr(os, "replace",
                        lambda *a: (_ for _ in ()).throw(OSError("boom")))
    with pytest.raises(OSError):
        atomic_write_bytes(str(path), b"x")
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# store round trip + keying
# ---------------------------------------------------------------------------

@needs_gcc
def test_stage_then_load_round_trip(tmp_path, registry):
    store = tmp_path / "cache"
    lib = _build_lib(tmp_path)
    cache = _cache(store)
    cache.stage("tiny", "d1", lib)
    assert _counter(registry, "tpu_serve_compile_cache_writes_total") == 1
    assert len(_entries(store)) == 1
    # a "restarted replica": a fresh store object on the same directory
    private = _cache(store).load("tiny", "d1")
    assert private is not None and private != lib
    assert not private.startswith(str(store))
    assert _answer(private) == 42
    assert _counter(registry, "tpu_serve_compile_cache_hits_total") == 1
    os.remove(private)


@needs_gcc
def test_load_miss_on_absent_and_on_another_digest(tmp_path, registry):
    cache = _cache(tmp_path / "cache")
    assert cache.load("tiny", "d1") is None
    cache.stage("tiny", "d1", _build_lib(tmp_path))
    assert cache.load("tiny", "d2") is None       # an edited source
    assert cache.load("other", "d1") is None      # another library
    assert _counter(registry, "tpu_serve_compile_cache_misses_total") == 3
    assert _counter(registry, "tpu_serve_compile_cache_hits_total") == 0


@needs_gcc
def test_corrupt_entry_quarantined_and_degrades(tmp_path, registry):
    store = tmp_path / "cache"
    cache = _cache(store)
    lib = _build_lib(tmp_path)
    cache.stage("tiny", "d1", lib)
    (entry,) = _entries(store)
    entry.write_bytes(entry.read_bytes()[:40])    # a torn write
    assert cache.load("tiny", "d1") is None       # degrade, no raise
    assert _counter(registry, "tpu_serve_compile_cache_corrupt_total") == 1
    quarantined = [p for p in store.iterdir() if ".corrupt-" in p.name]
    assert len(quarantined) == 1 and not entry.exists()
    cache.stage("tiny", "d1", lib)
    assert _answer(cache.load("tiny", "d1")) == 42


@needs_gcc
def test_checksum_mismatch_is_corrupt(tmp_path, registry):
    store = tmp_path / "cache"
    cache = _cache(store)
    cache.stage("tiny", "d1", _build_lib(tmp_path))
    (entry,) = _entries(store)
    blob = bytearray(entry.read_bytes())
    blob[-1] ^= 0xFF
    entry.write_bytes(bytes(blob))
    assert cache.load("tiny", "d1") is None
    assert _counter(registry, "tpu_serve_compile_cache_corrupt_total") == 1


@needs_gcc
def test_fingerprint_mismatch_quarantined(tmp_path, registry):
    store = tmp_path / "cache"
    _cache(store).stage("tiny", "d1", _build_lib(tmp_path))
    upgraded = _cache(store)
    upgraded.fingerprint = "nvcc=release 99.9"
    assert upgraded.load("tiny", "d1") is None
    assert _counter(registry, "tpu_serve_compile_cache_corrupt_total") == 1
    assert [p for p in store.iterdir() if ".corrupt-" in p.name]


def test_fingerprint_names_the_build():
    fp = cc_mod.backend_fingerprint()
    assert f"flags={' '.join(_build.NVCC_FLAGS)}" in fp
    assert f"torch_cuda={torch.version.cuda}" in fp
    assert "nvcc=" in fp and "device=" in fp


# ---------------------------------------------------------------------------
# LRU GC
# ---------------------------------------------------------------------------

@needs_gcc
def test_lru_gc_evicts_oldest_first(tmp_path, registry):
    cache = _cache(tmp_path / "cache")
    for i, value in enumerate((1, 2, 3)):
        cache.stage("tiny", f"d{value}", _build_lib(tmp_path, value))
        staged = cache.entry_path("tiny", f"d{value}")
        os.utime(staged, (1000.0 + i, 1000.0 + i))  # deterministic ages
    entries = cache.entries()
    assert len(entries) == 3
    cache.max_bytes = sum(size for _, size, _ in entries) - 1
    assert cache.gc() == 1
    assert _counter(registry, "tpu_serve_compile_cache_evictions_total") == 1
    remaining = {os.path.basename(p) for p, _, _ in cache.entries()}
    assert os.path.basename(entries[0][0]) not in remaining
    assert cache.load("tiny", "d1") is None
    assert _answer(cache.load("tiny", "d3")) == 3


@needs_gcc
def test_gc_uncapped_is_noop(tmp_path, registry):
    cache = _cache(tmp_path / "cache")
    cache.stage("tiny", "d1", _build_lib(tmp_path))
    assert cache.gc() == 0
    assert len(cache.entries()) == 1


# ---------------------------------------------------------------------------
# fault points
# ---------------------------------------------------------------------------

@needs_gcc
def test_read_fault_degrades_to_miss(tmp_path, registry):
    cache = _cache(tmp_path / "cache")
    cache.stage("tiny", "d1", _build_lib(tmp_path))
    with faults.plan("compile_cache.read=error"):
        assert cache.load("tiny", "d1") is None
    assert _counter(registry, "tpu_serve_compile_cache_misses_total") == 1
    # the entry is untouched: an unreadable file is not provably corrupt
    assert len(cache.entries()) == 1
    assert _answer(cache.load("tiny", "d1")) == 42


@needs_gcc
def test_write_fault_degrades_silently(tmp_path, registry):
    cache = _cache(tmp_path / "cache")
    lib = _build_lib(tmp_path)
    with faults.plan("compile_cache.write=error"):
        cache.stage("tiny", "d1", lib)
    assert cache.entries() == []
    assert _counter(registry, "tpu_serve_compile_cache_writes_total") == 0
    assert _answer(lib) == 42


# ---------------------------------------------------------------------------
# env knobs + an unwritable directory
# ---------------------------------------------------------------------------

def test_env_knobs(monkeypatch):
    monkeypatch.delenv(cc_mod.ENV_COMPILE_CACHE_DIR, raising=False)
    assert cc_mod.cache_dir_from_env() is None
    monkeypatch.setenv(cc_mod.ENV_COMPILE_CACHE_DIR, "/x/y")
    assert cc_mod.cache_dir_from_env() == "/x/y"
    monkeypatch.setenv(cc_mod.ENV_COMPILE_CACHE_MAX_BYTES, "1048576")
    assert cc_mod.max_bytes_from_env() == 1048576
    monkeypatch.setenv(cc_mod.ENV_COMPILE_CACHE_MAX_BYTES, "0")
    assert cc_mod.max_bytes_from_env() is None
    monkeypatch.setenv(cc_mod.ENV_COMPILE_CACHE_MAX_BYTES, "not-a-number")
    assert cc_mod.max_bytes_from_env() is None


def test_unwritable_dir_disables_cache(tmp_path, monkeypatch, registry):
    def deny(*a, **kw):
        raise PermissionError("read-only volume")

    monkeypatch.setattr(os, "makedirs", deny)
    cache = _cache(tmp_path / "nope")
    assert cache.dir is None
    assert cache.load("tiny", "d1") is None
    cache.stage("tiny", "d1", str(tmp_path / "absent.so"))
    assert cache.entries() == []


# ---------------------------------------------------------------------------
# ops/_build.py through the cache, gcc standing in for nvcc
# ---------------------------------------------------------------------------

@pytest.fixture()
def fake_csrc(tmp_path, monkeypatch):
    """``_build`` over a temp source directory holding ``tiny.cu`` (C
    code), compiled by gcc; no process-wide cache, no library loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "tiny.cu").write_text(SRC % 42)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: GCC)
    monkeypatch.setattr(_build, "NVCC_FLAGS", ("-x", "c", "-shared", "-fPIC"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_persistent", None)
    return csrc


def _call(lib):
    lib.answer.restype = ctypes.c_int
    return lib.answer()


def _delta(before):
    after = _build.stats()
    return {k: after[k] - before[k] for k in after}


@needs_gcc
def test_build_cold_then_warm_runs_the_compiler_once(fake_csrc, tmp_path,
                                                     monkeypatch, registry):
    store = tmp_path / "cache"
    _build.set_persistent_cache(_cache(store))
    before = _build.stats()
    assert _call(_build.load("tiny")) == 42
    assert _delta(before) == {"builds": 1, "cache_loads": 0}
    assert _counter(registry, "tpu_serve_compile_cache_misses_total") == 1
    assert _counter(registry, "tpu_serve_compile_cache_writes_total") == 1
    builds = registry.get("tpu_serve_kernel_builds_total")
    assert builds.value(lib="tiny") == 1
    (entry,) = _entries(store)
    assert entry.name.startswith(f"libtiny-{_build.source_digest('tiny')}")
    # the default build directory is not used with a cache
    assert not os.path.exists(_build.BUILD_DIR)
    # loaded libraries are never reopened
    lib = _build.load("tiny")
    assert _build.load("tiny") is lib
    assert _delta(before) == {"builds": 1, "cache_loads": 0}
    # a warm restart: nothing loaded, the same directory
    monkeypatch.setattr(_build, "_libs", {})
    _build.set_persistent_cache(_cache(store))
    before = _build.stats()
    assert _call(_build.load("tiny")) == 42
    assert _delta(before) == {"builds": 0, "cache_loads": 1}
    assert _counter(registry, "tpu_serve_compile_cache_hits_total") == 1
    # no private copy is left behind
    assert not [p for p in store.iterdir() if p.suffix == ".so"]


@needs_gcc
def test_build_rebuilds_a_truncated_entry(fake_csrc, tmp_path, monkeypatch,
                                          registry):
    store = tmp_path / "cache"
    _build.set_persistent_cache(_cache(store))
    _build.load("tiny")
    (entry,) = _entries(store)
    entry.write_bytes(entry.read_bytes()[:100])
    monkeypatch.setattr(_build, "_libs", {})
    before = _build.stats()
    assert _call(_build.load("tiny")) == 42
    assert _delta(before) == {"builds": 1, "cache_loads": 0}
    assert _counter(registry, "tpu_serve_compile_cache_corrupt_total") == 1
    assert [p for p in store.iterdir() if ".corrupt-" in p.name]
    assert len(_entries(store)) == 1


@needs_gcc
def test_build_quarantines_an_entry_the_loader_refuses(fake_csrc, tmp_path,
                                                       monkeypatch, registry):
    """A structurally valid entry (checksum and fingerprint pass) whose
    payload is no library: dlopen refuses it, the entry is quarantined
    and the source rebuilt; nothing raises."""
    store = tmp_path / "cache"
    cache = _cache(store)
    junk = tmp_path / "junk.so"
    junk.write_bytes(b"not an ELF file")
    cache.stage("tiny", _build.source_digest("tiny"), str(junk))
    _build.set_persistent_cache(cache)
    before = _build.stats()
    assert _call(_build.load("tiny")) == 42
    assert _delta(before) == {"builds": 1, "cache_loads": 0}
    assert _counter(registry, "tpu_serve_compile_cache_corrupt_total") == 1
    assert [p for p in store.iterdir() if ".corrupt-" in p.name]


@needs_gcc
def test_build_with_the_read_fault_armed_still_loads(fake_csrc, tmp_path,
                                                     monkeypatch, registry):
    store = tmp_path / "cache"
    _build.set_persistent_cache(_cache(store))
    _build.load("tiny")
    monkeypatch.setattr(_build, "_libs", {})
    before = _build.stats()
    with faults.plan("compile_cache.read=error"):
        assert _call(_build.load("tiny")) == 42
    assert _delta(before) == {"builds": 1, "cache_loads": 0}
    assert len(_entries(store)) == 1


@needs_gcc
def test_build_without_a_cache_uses_the_build_directory(fake_csrc):
    before = _build.stats()
    assert _call(_build.load("tiny")) == 42
    assert _delta(before) == {"builds": 1, "cache_loads": 0}
    assert os.path.exists(_build.library_path("tiny"))


# ---------------------------------------------------------------------------
# the server: LMServer(compile_cache_dir=), the env, the dispatch phases
# ---------------------------------------------------------------------------

def _tiny_server(**kw):
    return LMServer(config=LMConfig.tiny(), device="cpu", **kw)


def test_server_sets_the_process_cache_from_flag_or_env(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(_build, "_persistent", None)
    monkeypatch.delenv(cc_mod.ENV_COMPILE_CACHE_DIR, raising=False)
    srv = _tiny_server()
    assert srv._compile_cache is None and _build._persistent is None
    srv = _tiny_server(compile_cache_dir=str(tmp_path / "a"))
    assert _build._persistent is srv._compile_cache
    assert srv._compile_cache.dir == str(tmp_path / "a")
    monkeypatch.setenv(cc_mod.ENV_COMPILE_CACHE_DIR, str(tmp_path / "b"))
    srv = _tiny_server()
    assert srv._compile_cache.dir == str(tmp_path / "b")
    args = serve_http.build_arg_parser().parse_args(
        ["--compile-cache-dir", "/c"])
    assert args.compile_cache_dir == "/c"


@needs_gcc
def test_dispatch_phases_follow_the_reference_rules(fake_csrc, tmp_path,
                                                    monkeypatch, registry):
    """A miss whose first call opened a library from the cache and ran no
    compiler is phase="load" and bumps no compile count; a miss that ran
    the compiler, or only built its closure, is "compile"; a hit is
    "execute"."""
    store = str(tmp_path / "cache")
    srv = _tiny_server(compile_cache_dir=store)
    srv._compile_cache.fingerprint = FP
    programs: dict = {}

    def build():
        return lambda: _call(_build.load("tiny"))

    def phases():
        h = registry.get("tpu_serve_phase_seconds")
        return {p: h.count(phase=p, fn="unit") for p in
                ("compile", "load", "execute")}

    compiles = registry.counter("tpu_serve_jit_compiles_total",
                                labels=("fn",))
    assert srv._dispatch("unit", programs, "k1", build) == 42
    assert phases() == {"compile": 1, "load": 0, "execute": 0}
    assert compiles.value(fn="unit") == 1
    assert srv._dispatch("unit", programs, "k1", build) == 42
    assert srv._dispatch("unit", programs, "k2", build) == 42   # closure only
    assert phases() == {"compile": 2, "load": 0, "execute": 1}
    assert compiles.value(fn="unit") == 2
    # a warm restart of the process: nothing loaded, a fresh server
    monkeypatch.setattr(_build, "_libs", {})
    srv = _tiny_server(compile_cache_dir=store)
    srv._compile_cache.fingerprint = FP
    assert srv._dispatch("unit", {}, "k1", build) == 42
    assert phases() == {"compile": 2, "load": 1, "execute": 1}
    assert compiles.value(fn="unit") == 2
