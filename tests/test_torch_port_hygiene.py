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
    layout needs them, so importing the port loads neither."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'optax',\n"
        "                              'orbax', 'tensorstore', 'zstandard'))\n"
        "             or m.split('.')[0] == 'distributed_tensorflow_tpu')\n"
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
        "tools.checkpoint_io", "tools.export_model", "tools.serve",
        "serving.hot_swap", "config", "train")} <= set(_port_modules())


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
                                   "orbax", "distributed_tensorflow_tpu"), \
                    f"{path} imports {name}"


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
