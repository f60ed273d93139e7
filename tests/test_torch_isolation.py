"""The PyTorch port stands alone: no JAX, nothing of the reference.

An AST walk of ``k8s_device_plugin_tpu_torch`` and ``chip_smoke.py``
finds no import of jax, flax, optax, orbax or the reference package
``k8s_device_plugin_tpu`` (at module level or inside functions). The
host-only modules the port needs are copies of the reference's, equal to
their source after the import-prefix substitution; COPIES is the list.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "k8s_device_plugin_tpu_torch")
REF = os.path.join(REPO, "k8s_device_plugin_tpu")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "k8s_device_plugin_tpu"}

COPIES = [
    "obs/metrics.py", "obs/trace.py", "obs/ledger.py", "obs/flightrec.py",
    "obs/http.py", "obs/slo.py",
    "utils/chiplog.py", "utils/faults.py", "utils/retry.py",
    "utils/watchdog.py",
    "models/tokenizer.py", "models/serve_text.py", "models/kv_cache.py",
    "models/handoff.py",
]


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_no_jax_and_nothing_of_the_reference():
    sources = _port_sources()
    assert len(sources) > 20
    bad = [f"{os.path.relpath(p, REPO)}:{line} imports {root}"
           for p in sources for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert bad == []


def test_the_walk_catches_a_reference_import(tmp_path):
    """The check itself: a function-level import of the reference package
    is found (the exact name, not the port's own prefix)."""
    src = tmp_path / "m.py"
    src.write_text("import k8s_device_plugin_tpu_torch.ops\n"
                   "def f():\n"
                   "    from k8s_device_plugin_tpu.obs import metrics\n")
    roots = [r for r, _ in _imported_roots(str(src))]
    assert roots == ["k8s_device_plugin_tpu_torch", "k8s_device_plugin_tpu"]
    assert [r for r in roots if r in FORBIDDEN] == ["k8s_device_plugin_tpu"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_reference(rel):
    with open(os.path.join(REF, rel)) as f:
        want = f.read().replace("k8s_device_plugin_tpu.",
                                "k8s_device_plugin_tpu_torch.")
    with open(os.path.join(PORT, rel)) as f:
        assert f.read() == want, f"{rel} drifted from its reference"
