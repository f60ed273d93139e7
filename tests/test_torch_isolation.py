"""The PyTorch port stands alone: no JAX, nothing of the reference.

An AST walk of ``k8s_device_plugin_tpu_torch`` and ``chip_smoke.py``
finds no import of jax, flax, optax, orbax, ml_dtypes or the reference
package ``k8s_device_plugin_tpu`` (at module level or inside functions).
The host-only modules the port needs are copies of the reference's,
equal to their source after the import-prefix substitution; COPIES is
the list. models/handoff.py left it when its bundles learned to carry
bfloat16 without ``ml_dtypes``: every definition of it but those is
still the reference's (HANDOFF_CHANGED, HANDOFF_ADDED). PORTED lists
the modules rewritten for the port: those whose reference imports jax
(models/compile_cache.py, models/moe.py, ops/s2d.py, the four conv
models, the pipelined trainers and parallel/) and the device-plugin
daemon's rewrites for NVIDIA GPUs: walked like the rest, and keeping the
reference's public names (RENAMED pairs a reference name with its GPU
name; the metrics exporter's ``--tpu-env-path`` is its ``--proc-root``,
checked with its flags in tests/test_torch_metrics_exporter.py); the
schedule half of parallel/pipeline_interleaved.py is pinned to the
reference's (SCHEDULE_PINNED). ADDED lists port modules that hold a
part of a reference module. The daemon's discovery, topology, allocator
and allocate core import without grpc and google.protobuf
(GRPC_FREE_CORE).
"""

import ast
import os
import subprocess
import sys

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
    # the device-plugin daemon (slice 15)
    "utils/sysfs.py", "utils/configfile.py", "version.py",
    "api/__init__.py", "api/deviceplugin/__init__.py",
    "api/deviceplugin/v1beta1/__init__.py",
    "api/deviceplugin/v1beta1/api_pb2.py",
    "api/deviceplugin/v1beta1/api_grpc.py",
    "api/metricssvc/__init__.py", "api/metricssvc/metricssvc_pb2.py",
    "api/metricssvc/metricssvc_grpc.py",
    "dpm/checkpoint.py", "dpm/healthsm.py", "dpm/inotify.py",
    "dpm/lister.py", "dpm/manager.py", "dpm/plugin_server.py",
    "exporter/health.py", "native/__init__.py", "cmd/__init__.py",
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
                                  "benchmark", "main"),
          # the device-plugin daemon (slice 15): rewrites for NVIDIA GPUs
          "api/constants.py": ("HEALTHY", "UNHEALTHY", "VERSION",
                               "DEVICE_PLUGIN_PATH", "KUBELET_SOCKET_NAME",
                               "KUBELET_SOCKET", "RESOURCE_NAMESPACE"),
          "native/binding.py": ("available", "version", "enumerate_chips",
                                "_load"),
          "discovery/chips.py": ("DiscoveryError",
                                 "fatal_on_driver_unavailable",
                                 "dev_functional", "is_homogeneous",
                                 "generation_name", "product_name",
                                 "_discover_native", "_read_pci_attrs"),
          "discovery/topology.py": (),
          "discovery/__init__.py": ("DiscoveryError", "dev_functional",
                                    "fatal_on_driver_unavailable",
                                    "generation_name", "is_homogeneous",
                                    "product_name"),
          "allocator/__init__.py": ("AllocationError", "BestEffortPolicy",
                                    "Device", "Policy", "build_pair_weights",
                                    "devices_from_chips", "pair_weight"),
          "allocator/allocator.py": ("AllocationError", "Policy"),
          "allocator/device.py": ("Device", "SAME_NUMA_WEIGHT",
                                  "DIFF_NUMA_WEIGHT", "devices_from_chips",
                                  "pair_weight", "build_pair_weights",
                                  "subset_weight", "covered_chips",
                                  "is_contiguous_selection"),
          "allocator/besteffort_policy.py": (
              "INVALID_SIZE", "INVALID_AVAILABLE", "INVALID_REQUIRED",
              "INVALID_REQ_AVAILABLE", "INVALID_INIT", "NO_CANDIDATE_FOUND",
              "_EXHAUSTIVE_LIMIT", "BestEffortPolicy"),
          "plugin/__init__.py": ("PluginConfig", "Strategy",
                                 "get_resource_list", "parse_strategy"),
          "plugin/config.py": ("PluginConfig",),
          "plugin/resource_naming.py": ("Strategy", "StrategyError",
                                        "parse_strategy",
                                        "get_resource_list"),
          "plugin/cdi.py": ("CDI_SPEC_DIR", "CDI_KIND", "device_cdi_name",
                            "build_spec", "cleanup_stale_specs",
                            "write_spec"),
          "plugin/plugin.py": (),
          "dpm/__init__.py": ("CheckpointStore", "DevicePluginServer",
                              "HealthConfig", "HealthStateMachine", "Lister",
                              "Manager"),
          "exporter/__init__.py": ("DEFAULT_HEALTH_SOCKET", "get_tpu_health",
                                   "populate_per_tpu_health"),
          "cmd/device_plugin.py": ("build_arg_parser", "driver_present",
                                   "main", "shutdown_cleanup"),
          # the metrics exporter (slice 16): NVML where the reference
          # reads sysfs alone and libtpu's runtime-metrics service
          "exporter/telemetry.py": ("ChipTelemetry", "_device_dir",
                                    "read_chip_telemetry"),
          "exporter/runtime.py": ("DEFAULT_RUNTIME_METRICS_ADDR",
                                  "QUERY_TIMEOUT_S", "BREAKER_THRESHOLD",
                                  "BREAKER_RESET_S", "HBM_USAGE",
                                  "HBM_TOTAL", "DUTY_CYCLE", "PollState",
                                  "poll_state", "breaker",
                                  "configure_breaker", "AcceleratorRuntime",
                                  "RuntimeMetrics", "read_runtime_metrics",
                                  "_read_runtime_metrics_once",
                                  "_note_failure"),
          "cmd/metrics_exporter.py": ("ChipHealthService", "serve",
                                      "serve_http_metrics",
                                      "chip_metric_text",
                                      "start_chip_poll_watchdog",
                                      "build_arg_parser", "main")}
# Rewrites whose counterpart of a reference name has a GPU name: (module,
# reference name, port name).
RENAMED = [
    ("discovery/chips.py", "TPUChip", "GPUChip"),
    ("discovery/chips.py", "get_tpu_chips", "get_gpu_chips"),
    ("discovery/chips.py", "GOOGLE_VENDOR_ID", "NVIDIA_VENDOR_ID"),
    ("discovery/chips.py", "_discover_accel_class", "_discover_procfs"),
    ("discovery/topology.py", "TPUTopology", "GPUTopology"),
    ("discovery/__init__.py", "TPUChip", "GPUChip"),
    ("discovery/__init__.py", "TPUTopology", "GPUTopology"),
    ("discovery/__init__.py", "get_tpu_chips", "get_gpu_chips"),
    ("api/constants.py", "RESOURCE_TPU", "RESOURCE_GPU"),
    ("allocator/device.py", "largest_free_submesh", "largest_free_clique"),
    ("allocator/device.py", "candidate_submesh_selections",
     "candidate_clique_selections"),
    ("allocator/device.py", "ICI_NEIGHBOR_WEIGHT", "NVLINK_WEIGHT"),
    ("allocator/device.py", "NO_PATH_WEIGHT", "OTHER_WEIGHT"),
    ("plugin/plugin.py", "TPUDevicePlugin", "GPUDevicePlugin"),
    ("plugin/plugin.py", "TPULister", "GPULister"),
]
# Port modules with no file of their own in the reference: (module, the
# reference module whose part it holds).
ADDED = {"plugin/allocation.py": "plugin/plugin.py"}
# The device-plugin slice's packages: every module in them is a copy, a
# rewrite or an addition.
DAEMON_PACKAGES = ("api", "native", "discovery", "allocator", "plugin",
                   "dpm", "exporter", "cmd")
# What imports without grpc and google.protobuf: discovery, topology, the
# allocator and the allocate core (and what they import).
GRPC_FREE_CORE = (
    "k8s_device_plugin_tpu_torch.discovery",
    "k8s_device_plugin_tpu_torch.discovery.topology",
    "k8s_device_plugin_tpu_torch.native.binding",
    "k8s_device_plugin_tpu_torch.allocator",
    "k8s_device_plugin_tpu_torch.plugin.allocation",
    "k8s_device_plugin_tpu_torch.plugin.resource_naming",
)
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


@pytest.mark.parametrize("rel,ref_name,port_name", RENAMED)
def test_renamed_counterparts(rel, ref_name, port_name):
    assert ref_name in _module_names(os.path.join(REF, rel))
    assert port_name in _module_names(os.path.join(PORT, rel))


def test_daemon_packages_are_covered():
    """Every module of the daemon's packages is a copy, a rewrite or an
    addition, and every addition holds a part of a reference module."""
    found = set()
    for pkg in DAEMON_PACKAGES:
        for root, _, files in os.walk(os.path.join(PORT, pkg)):
            found |= {os.path.relpath(os.path.join(root, f), PORT)
                      for f in files if f.endswith(".py")}
    listed = set(COPIES) | set(PORTED) | set(ADDED)
    assert found - listed == set()
    for rel, ref in ADDED.items():
        assert not os.path.exists(os.path.join(REF, rel))
        assert os.path.exists(os.path.join(REF, ref))


def _imports_grpc(path):
    return any(root == "grpc" or (root == "google" and "protobuf" in mod)
               for root, mod in _imported_modules(path))


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = " ".join(a.name for a in node.names)
            yield node.module.split(".")[0], f"{node.module} {names}"


def test_grpc_free_core_imports_with_grpc_and_protobuf_blocked():
    """A fresh interpreter with ``grpc`` and ``google.protobuf`` set to
    None in ``sys.modules`` imports the core, places a request and builds
    a container's edits; the port modules it loaded import neither, and
    every port module that does lies outside it."""
    script = (
        "import sys, json\n"
        "for m in ('grpc', 'google', 'google.protobuf'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {GRPC_FREE_CORE!r}:\n"
        "    __import__(m)\n"
        "from k8s_device_plugin_tpu_torch.allocator import (\n"
        "    BestEffortPolicy, devices_from_chips)\n"
        "from k8s_device_plugin_tpu_torch.discovery import GPUChip, gpu_topology\n"
        "from k8s_device_plugin_tpu_torch.plugin.allocation import "
        "container_allocation\n"
        "chips = [GPUChip(index=i, pci_address=f'0000:0{i}:00.0', "
        "dev_path=f'/dev/nvidia{i}', mesh_index=i, uuid=f'GPU-{i}', "
        "extra_dev_paths=('/dev/nvidiactl',)) for i in range(2)]\n"
        "pol = BestEffortPolicy()\n"
        "pol.init(devices_from_chips(chips), gpu_topology(chips))\n"
        "got = pol.allocate([c.key for c in chips], [], 1)\n"
        "paths, envs = container_allocation(c for c in chips "
        "if c.key in got)\n"
        "print(json.dumps({'got': got, 'paths': paths, 'envs': envs,\n"
        "    'loaded': sorted(m for m in sys.modules if m.startswith(\n"
        "        'k8s_device_plugin_tpu_torch') and sys.modules[m])}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["got"] == ["0000:00:00.0"]
    assert out["paths"] == ["/dev/nvidia0", "/dev/nvidiactl"]
    assert out["envs"] == {"NVIDIA_VISIBLE_DEVICES": "GPU-0",
                           "CUDA_VISIBLE_DEVICES": "GPU-0"}
    loaded = set()
    for mod in out["loaded"]:
        rel = mod.split(".", 1)[1].replace(".", os.sep) \
            if "." in mod else ""
        path = os.path.join(PORT, rel + ".py")
        if not os.path.exists(path):
            path = os.path.join(PORT, rel, "__init__.py")
        loaded.add(os.path.relpath(path, PORT))
        assert not _imports_grpc(path), f"{mod} imports grpc or protobuf"
    assert {"plugin/allocation.py", "allocator/besteffort_policy.py",
            "discovery/topology.py", "native/binding.py"} <= loaded
    grpc_users = {os.path.relpath(p, PORT) for p in _port_sources()
                  if p.startswith(PORT) and _imports_grpc(p)}
    assert "plugin/plugin.py" in grpc_users
    assert "dpm/plugin_server.py" in grpc_users
    assert grpc_users & loaded == set()
