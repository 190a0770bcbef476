"""Hygiene of the PyTorch port: it loads without JAX or the JAX package,
its entry points run on the GPU unless asked for the CPU, and its
kernels are built from sources in the package."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import distributed_tensorflow_tpu_torch as port
from distributed_tensorflow_tpu_torch.models import gpt
from distributed_tensorflow_tpu_torch.ops import kernels
from distributed_tensorflow_tpu_torch.serving.engine import (DecodeEngine,
                                                             EngineConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = gpt.GptConfig(vocab_size=16, hidden_size=16, num_layers=1,
                     num_heads=2, intermediate_size=32, max_position=16,
                     dtype="float32")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def test_every_port_module_imports_without_jax():
    """A fresh interpreter (this one has JAX loaded by the test setup).
    The checkpoint reader imports tensorstore and zstandard only where a
    layout needs them, so importing the port loads neither; the exchange
    holds bf16 as 16-bit words, so nothing loads ``ml_dtypes`` (the card's
    machine has none)."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "from distributed_tensorflow_tpu_torch.cluster import coordination\n"
        "coordination._load_library()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'optax',\n"
        "                              'orbax', 'tensorstore', 'zstandard',\n"
        "                              'ml_dtypes'))\n"
        "             or m.split('.')[0] == 'distributed_tensorflow_tpu')\n"
        "# No shared object of the JAX package's tree is mapped.\n"
        "bad += sorted({line.split()[-1] for line in open('/proc/self/maps')\n"
        "               if '/distributed_tensorflow_tpu/' in line\n"
        "               or '/src/coordination/' in line})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(_port_modules()) >= 15
    assert {f"{port.__name__}.{name}" for name in (
        "parallel.mesh", "parallel.ring", "models.drafting",
        # Tensor and sequence parallelism in one process.
        "parallel.sharding", "parallel.ulysses",
        "tools.checkpoint_io", "tools.export_model", "tools.serve",
        "serving.hot_swap", "config", "train",
        # The reference trainer, sync mode.
        "cluster.spec", "cluster.server", "cluster.coordination",
        "utils.faults", "utils.native", "utils.summary", "utils.profiling",
        "models.mlp", "models.image_input", "data.datasets",
        "data.prefetch", "parallel.sync", "training.preemption",
        "training.supervisor", "training.loop",
        # The reference trainer, async mode.
        "parallel.async_replicas", "cluster.param_sync", "training.elastic",
        "utils.pytree",
        # The serving fleet tier.
        "serving.router", "serving.cells", "tools.serve_fleet",
        "tools.serve_cell", "tools.coord_shard", "tools.loadgen",
        "tools.watch_serve", "tools.summarize_run",
        "tools.export_trace",
        # FSDP, int8 beside tensor parallelism, the pipeline.
        "parallel.pipeline", "ops.quant_train", "ops.quant_matmul")} <= set(
        _port_modules())


def test_the_native_coordination_library_is_built_from_the_port():
    """The port compiles its own copy of the coordination service's source
    into its own tree; it never names the JAX package's source or
    library (``src/`` is a link into the JAX package)."""
    from distributed_tensorflow_tpu_torch.cluster import coordination
    root = os.path.dirname(port.__file__)
    assert coordination._SRC == os.path.join(root, "csrc", "coordination",
                                             "coord.cc")
    assert os.path.isfile(coordination._SRC)
    assert coordination._BUILD == os.path.join(root, "_build")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "*.so" in f.read().split()


def test_no_port_file_or_chip_smoke_names_jax_in_an_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(port.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "orbax", "ml_dtypes",
                                   "distributed_tensorflow_tpu"), \
                    f"{path} imports {name}"


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(port.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _module_of(node, assigned):
    """The module name an expression after ``"-m"`` evaluates to: a string,
    or an f-string whose names bound to strings in the same file are
    filled in (any other part reads ``{?}``); None for anything else."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(v.value)
            elif (isinstance(v, ast.FormattedValue)
                  and isinstance(v.value, ast.Name)
                  and v.value.id in assigned):
                parts.append(assigned[v.value.id])
            else:
                parts.append("{?}")
        return "".join(parts)
    return None


def test_every_module_a_port_source_spawns_is_the_ports():
    """A ``python -m`` target in a port source (or ``chip_smoke.py``) is
    a module of the port: a fleet or cell copied with the JAX package's
    name left in would spawn the JAX package's replicas.  No string in
    them names a JAX module (``distributed_tensorflow_tpu.<...>``)."""
    spawned = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        assigned = {t.id: node.value.value for node in ast.walk(tree)
                    if isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                    for t in node.targets if isinstance(t, ast.Name)}
        docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                      if isinstance(n, (ast.Module, ast.FunctionDef,
                                        ast.ClassDef))
                      and n.body and isinstance(n.body[0], ast.Expr)
                      and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docstrings):
                assert "distributed_tensorflow_tpu." not in node.value, \
                    f"{path}: {node.value!r}"
            if isinstance(node, (ast.List, ast.Tuple)):
                elts = node.elts
            elif isinstance(node, ast.Call):
                elts = node.args
            else:
                continue
            for i, e in enumerate(elts[:-1]):
                if isinstance(e, ast.Constant) and e.value == "-m":
                    mod = _module_of(elts[i + 1], assigned)
                    assert mod is not None, f"{path}:{e.lineno}"
                    spawned.append((os.path.basename(path), mod))
    for where, mod in spawned:
        assert mod.startswith("distributed_tensorflow_tpu_torch."), \
            (where, mod)
    assert {("serve_fleet.py", "distributed_tensorflow_tpu_torch.tools."
             "serve"),
            ("serve_cell.py", "distributed_tensorflow_tpu_torch.tools."
             "coord_shard"),
            ("serve_cell.py", "distributed_tensorflow_tpu_torch.tools."
             "serve_fleet")} <= set(spawned)


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.GptLM(TINY)
    model = gpt.GptLM(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, None, EngineConfig(num_slots=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.init_kv_pool(TINY, 4, 4)
    engine = DecodeEngine(model, None, EngineConfig(num_slots=1),
                          device="cpu")
    assert engine.pools[0][0].device.type == "cpu"
    # A mesh defaults to the visible cards; the CPU only by devices=.
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    with pytest.raises(RuntimeError, match="devices="):
        create_mesh(seq=2)
    assert create_mesh(seq=2, devices=["cpu"] * 2).shape["seq"] == 2


def test_kernel_sources_ship_in_the_package_and_hash_stably():
    names = sorted(os.path.basename(s) for s in kernels.sources())
    assert names == ["flash_attention.cu", "flash_attention_bwd.cu",
                     "flash_attention_chunk.cu", "hopper.cuh", "launch.cuh",
                     "layer_norm.cu", "quant.cuh", "quant_gemm.cu"]
    assert kernels.source_hash() == kernels.source_hash()
    assert kernels.BUILD_ROOT.endswith("_build")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "_build/" in f.read().split()
    for src in kernels.sources():
        if src.endswith(".cuh"):        # shared helpers, no kernel of their own
            continue
        with open(src) as f:
            head = f.read(3000)
        # Each source says what TPU kernel it replaces and what bounds it.
        assert "Replaces:" in head and "Bound on the H100" in head
