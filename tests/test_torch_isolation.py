"""The PyTorch port stands alone: no JAX, nothing of the reference.

An AST walk of ``k8s_device_plugin_tpu_torch`` and ``chip_smoke.py``
finds no import of jax, flax, optax, orbax, ml_dtypes or the reference
package ``k8s_device_plugin_tpu`` (at module level or inside functions).
The host-only modules the port needs are copies of the reference's,
equal to their source after the import-prefix substitution; COPIES is
the list. models/handoff.py left it when its bundles learned to carry
bfloat16 without ``ml_dtypes``: every definition of it but those is
still the reference's (HANDOFF_CHANGED, HANDOFF_ADDED). PORTED lists
the modules rewritten for the port whose reference imports jax
(models/compile_cache.py, models/moe.py, ops/s2d.py, the four conv
models, the pipelined trainers and parallel/): walked like the rest, and
keeping the reference's public names; the schedule half of
parallel/pipeline_interleaved.py is pinned to the reference's
(SCHEDULE_PINNED).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "k8s_device_plugin_tpu_torch")
REF = os.path.join(REPO, "k8s_device_plugin_tpu")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "k8s_device_plugin_tpu"}

COPIES = [
    "obs/metrics.py", "obs/trace.py", "obs/ledger.py", "obs/flightrec.py",
    "obs/http.py", "obs/slo.py",
    "utils/chiplog.py", "utils/faults.py", "utils/retry.py",
    "utils/watchdog.py",
    "models/tokenizer.py", "models/serve_text.py", "models/kv_cache.py",
]
# Port modules whose reference counterpart imports jax: walked like every
# port module, and holding the reference's public names.
PORTED = {"models/compile_cache.py": ("CACHE_VERSION",
                                      "ENV_COMPILE_CACHE_DIR",
                                      "ENV_COMPILE_CACHE_MAX_BYTES",
                                      "CompileCache", "backend_fingerprint",
                                      "cache_dir_from_env",
                                      "max_bytes_from_env"),
          "models/moe.py": ("MoEConfig", "MoELayer", "is_expert_weight"),
          "ops/s2d.py": ("direct_conv", "space_to_depth_conv"),
          "parallel/__init__.py": ("build_mesh", "mesh_from_env",
                                   "visible_chip_indices", "batch_sharding",
                                   "shard_params_for_tp"),
          "parallel/mesh.py": ("visible_chip_indices", "_factor",
                               "build_mesh", "mesh_from_env"),
          "parallel/sharding.py": ("batch_sharding", "shard_params_for_tp"),
          "parallel/ring_attention.py": ("ring_attention",
                                         "ring_attention_sharded"),
          "parallel/ulysses.py": ("ulysses_attention",
                                  "ulysses_attention_sharded"),
          "parallel/pipeline.py": ("pipeline_apply", "shard_stage_params"),
          "parallel/pipeline_1f1b.py": ("schedule_ticks", "peak_stash",
                                        "pipeline_value_and_grad",
                                        "spec_mentions", "tp_edge_reduce",
                                        "opt_specs_like",
                                        "validate_data_axis", "dp_reduce",
                                        "microbatch_inputs",
                                        "seeded_backward",
                                        "assemble_result"),
          "parallel/pipeline_interleaved.py": (
              "InterleavedSchedule", "_rank_op_order", "build_schedule",
              "interleave_stack", "interleaved_pipeline_value_and_grad"),
          "models/transformer_pp.py": ("init_pp_params",
                                       "init_embed_head_params",
                                       "embed_apply", "head_loss",
                                       "make_stage_fn", "make_pp_train_step",
                                       "validate_cli_batch_flags", "main",
                                       "reference_forward"),
          "models/transformer_tp.py": ("tp_block_apply",
                                       "init_tp_block_params",
                                       "tp_block_specs",
                                       "reference_block_apply",
                                       "make_pp_tp_train_step", "main"),
          "models/alexnet.py": ("NUM_CLASSES", "IMAGE_SIZE", "AlexNet",
                                "_stem_direct", "_stem_space_to_depth",
                                "init_params", "forward", "loss_fn",
                                "make_train_step", "synthetic_batch",
                                "benchmark", "main"),
          "models/resnet.py": ("NUM_CLASSES", "IMAGE_SIZE", "STAGE_SIZES",
                               "_stem_direct", "_stem_space_to_depth",
                               "Bottleneck", "ResNet", "tiny_model",
                               "init_variables", "loss_fn",
                               "make_train_step", "synthetic_batch",
                               "benchmark", "main"),
          "models/mobilenet.py": ("NUM_CLASSES", "IMAGE_SIZE", "V2_BLOCKS",
                                  "_round_channels", "InvertedResidual",
                                  "MobileNetV2", "tiny_model",
                                  "init_variables", "loss_fn",
                                  "make_train_step", "benchmark", "main"),
          "models/inception.py": ("NUM_CLASSES", "IMAGE_SIZE", "ConvBN",
                                  "InceptionA", "InceptionB", "InceptionC",
                                  "InceptionD", "InceptionE", "InceptionV3",
                                  "init_variables", "make_train_step",
                                  "benchmark", "main")}
# parallel/pipeline_interleaved.py: the schedule half, numpy only, the
# reference's definition for definition (its module imports jax inside
# the executor, so it cannot be a copy)
SCHEDULE_PINNED = ("(IDLE, FWD, BWD)", "InterleavedSchedule",
                   "_rank_op_order", "build_schedule")
# models/handoff.py: the definitions that differ from the reference's
# (bfloat16 held as tagged 16-bit words) and those the port adds.
HANDOFF_CHANGED = {"_np_dtype", "PageBlockBundle.to_bytes"}
HANDOFF_ADDED = {"import torch", "BF16_WORDS", "_dtype_name", "host_array",
                 "to_tensor"}


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


@pytest.mark.parametrize("rel", sorted(PORTED))
def test_ported_module_is_walked_and_keeps_the_reference_names(rel):
    path = os.path.join(PORT, rel)
    assert path in _port_sources()
    assert [r for r, _ in _imported_roots(path) if r in FORBIDDEN] == []
    ref = _module_names(os.path.join(REF, rel))
    port = _module_names(path)
    for name in PORTED[rel]:
        assert name in ref and name in port, name


def _module_names(path):
    """The names a module binds at its top level: its definitions,
    annotated assignments (``V2_BLOCKS: Tuple[...] = ...``) and the names
    its imports bind (the port's resnet.py re-exports the AlexNet
    harness's ``make_train_step``, as the reference's inception takes
    resnet's ``loss_fn``)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set(_definitions(path))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.AnnAssign):
            names.add(ast.unparse(node.target))
    return names


def test_atomic_write_bytes_is_the_references():
    """models/compile_cache.py keeps its own ``atomic_write_bytes`` (the
    reference's dpm/checkpoint.py imports more than the port needs): its
    statements after the docstring equal the reference's."""
    def body(path):
        with open(path) as f:
            tree = ast.parse(f.read())
        (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "atomic_write_bytes"]
        return [ast.dump(n) for n in fn.body[1:]], ast.dump(fn.args)

    assert body(os.path.join(PORT, "models/compile_cache.py")) == \
        body(os.path.join(REF, "dpm/checkpoint.py"))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_reference(rel):
    with open(os.path.join(REF, rel)) as f:
        want = f.read().replace("k8s_device_plugin_tpu.",
                                "k8s_device_plugin_tpu_torch.")
    with open(os.path.join(PORT, rel)) as f:
        assert f.read() == want, f"{rel} drifted from its reference"


def _definitions(path):
    """{name: ast dump} of a module's (or a class body's) statements: a
    def, class or assignment by its name, an import by its source, the
    docstring as "doc"; a class's methods under "Class.method"."""
    with open(path) as f:
        src = f.read().replace("k8s_device_plugin_tpu.",
                               "k8s_device_plugin_tpu_torch.")
    return _body_definitions(ast.parse(src).body, src)


def _body_definitions(body, src, prefix=""):
    out = {}
    for i, node in enumerate(body):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = prefix + node.name
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            name = ast.get_source_segment(src, node)
        elif isinstance(node, ast.Assign):
            name = prefix + ast.unparse(node.targets[0])
        elif i == 0 and isinstance(node, ast.Expr):
            name = prefix + "doc"
        else:
            name = prefix + ast.dump(node)
        if isinstance(node, ast.ClassDef):
            out.update(_body_definitions(node.body, src, name + "."))
            node = ast.ClassDef(node.name, node.bases, node.keywords, [],
                                node.decorator_list)
        out[name] = ast.dump(node)
    return out


def test_handoff_is_the_reference_but_its_bfloat16_wire():
    """The port's models/handoff.py against the reference's: the same
    definitions, equal after the import-prefix substitution, except
    HANDOFF_CHANGED (bfloat16 held as tagged words, without ml_dtypes)
    and the port's additions HANDOFF_ADDED; no ml_dtypes anywhere."""
    rel = "models/handoff.py"
    ref = _definitions(os.path.join(REF, rel))
    port = _definitions(os.path.join(PORT, rel))
    assert set(port) - set(ref) == HANDOFF_ADDED
    assert set(ref) - set(port) == set()
    drifted = sorted(n for n in ref
                     if n not in HANDOFF_CHANGED and ref[n] != port[n])
    assert drifted == []
    assert all(ref[n] != port[n] for n in HANDOFF_CHANGED)
    assert "ml_dtypes" in FORBIDDEN
    with open(os.path.join(PORT, rel)) as f:
        assert "import ml_dtypes" not in f.read()


def test_interleaved_schedule_is_the_references():
    """The port's parallel/pipeline_interleaved.py keeps the reference's
    schedule definitions (the op constants, ``InterleavedSchedule`` and
    its fields, ``_rank_op_order``, ``build_schedule`` with its clobber
    and arrival checks) and their imports unchanged."""
    rel = "parallel/pipeline_interleaved.py"
    ref = _definitions(os.path.join(REF, rel))
    port = _definitions(os.path.join(PORT, rel))
    pinned = [n for n in ref if n in SCHEDULE_PINNED
              or n.startswith("InterleavedSchedule.")
              or n.startswith("from typing") or n == "import numpy as np"
              or n.startswith("from dataclasses")]
    assert len(pinned) > len(SCHEDULE_PINNED)
    assert [n for n in pinned if port.get(n) != ref[n]] == []
