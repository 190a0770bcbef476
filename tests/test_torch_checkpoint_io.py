"""The port's checkpoint reader and writer
(distributed_tensorflow_tpu_torch/tools/checkpoint_io.py, _zarr_layout.py)
and its restore recipe (tools/export_model.py, models/gpt.py
merge_pipeline_params) against the JAX package's on the same directories.

The JAX package writes a GPT train state through orbax's ``StandardSave``
(params, Adam's opt_state with its tuples, global_step, and bf16 EMA
params), once in orbax's default OCDBT layout and once with
``use_ocdbt=False`` (zstd chunks).  Every restored leaf must equal the
reference's bit for bit; the port's ``save_raw`` must restore bit for bit
through the reference; the port must read its own write with neither
``tensorstore`` nor ``zstandard`` importable.  Integrity verdicts and the
inferred configs must be the reference's."""

import dataclasses
import functools
import json
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.tools import checkpoint_io as jio
from distributed_tensorflow_tpu.tools import export_model as jexport
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import registry as tregistry
from distributed_tensorflow_tpu_torch.tools import _zarr_layout
from distributed_tensorflow_tpu_torch.tools import checkpoint_io as tio
from distributed_tensorflow_tpu_torch.tools import export_model as texport

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position=64, dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(cfg, seed=0, step=7):
    """A trainer-shaped state tree: fp32 params, Adam's opt_state (a
    tuple of a namedtuple and an empty state), the step, bf16 EMA."""
    model = jgpt.GptLM(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                       jnp.zeros((1, 8), jnp.int32))["params"])
    opt_state = optax.adam(1e-3).init(params)
    return {"params": params, "opt_state": opt_state,
            "global_step": jnp.asarray(step, jnp.int32),
            "ema_params": jax.tree.map(
                lambda x: (x + 1.0).astype(jnp.bfloat16), params)}


def _orbax_save(logdir, step, tree, use_ocdbt=True):
    handler = (None if use_ocdbt
               else ocp.StandardCheckpointHandler(use_ocdbt=False))
    mgr = ocp.CheckpointManager(os.path.join(logdir, "checkpoints"),
                                item_handlers=handler)
    mgr.save(step, args=ocp.args.StandardSave(tree))
    mgr.wait_until_finished()
    mgr.close()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The reference's writes: {layout: logdir} and the saved tree."""
    root = tmp_path_factory.mktemp("ckpt")
    tree = _jax_state(jgpt.GptConfig(**SMALL))
    dirs = {}
    for layout, ocdbt in (("ocdbt", True), ("zstd", False)):
        dirs[layout] = str(root / layout)
        _orbax_save(dirs[layout], 7, tree, use_ocdbt=ocdbt)
    return dirs, tree


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an integer (or bool) numpy array, dtype kept in
    the view's width, so equality is bit equality."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.kind == "f" or a.dtype == ml_dtypes.bfloat16:
        return a.view(f"u{a.dtype.itemsize}")
    return a


def _assert_same_tree(got, want):
    """Same structure (dicts, lists, None) and bit-equal leaves of the same
    dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif want is None:
        assert got is None
    else:
        g, w = _bits(got), _bits(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _as_saved(tree):
    """orbax's raw restore of a tree: namedtuples and tuples as lists, an
    empty state as None."""
    if isinstance(tree, dict):
        return {k: _as_saved(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ({k: _as_saved(getattr(tree, k)) for k in tree._fields}
                if tree._fields else None)
    if isinstance(tree, (list, tuple)):
        return [_as_saved(v) for v in tree]
    return np.asarray(tree)


# ------------------------------------------------------------ the reader


@pytest.mark.parametrize("layout", ["ocdbt", "zstd"])
def test_restore_raw_equals_the_reference(written, layout):
    pytest.importorskip("tensorstore" if layout == "ocdbt" else "zstandard")
    dirs, tree = written
    want, step, steps = jio.restore_raw(dirs[layout])
    got, got_step, got_steps = tio.restore_raw(dirs[layout])
    assert (got_step, got_steps) == (step, steps) == (7, [7])
    _assert_same_tree(got, want)
    _assert_same_tree(got, _as_saved(tree))
    assert got["ema_params"]["lm_head"]["kernel"].dtype == torch.bfloat16
    assert isinstance(got["opt_state"], list) and got["opt_state"][1] is None
    assert got["global_step"].shape == () and int(got["global_step"]) == 7


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_save_raw_restores_bit_for_bit_through_the_reference(
        written, tmp_path, source):
    """The port's write, fed the reference's restored tree (numpy with
    ml_dtypes bf16) or the port's (tensors), is the reference's input
    again through the reference's restore_raw."""
    dirs, tree = written
    if source == "numpy":
        src = jax.tree.map(np.asarray, jio.restore_raw(dirs["zstd"])[0])
    else:
        src = tio.restore_raw(dirs["zstd"])[0]
    step_dir = tio.save_raw(str(tmp_path / "checkpoints"), 7, src)
    assert step_dir == str(tmp_path / "checkpoints" / "7")
    assert tio.verify_checkpoint(step_dir)[0] == "valid"
    assert jio.verify_checkpoint(step_dir)[0] == "valid"
    got, step, _ = jio.restore_raw(str(tmp_path))
    assert step == 7
    _assert_same_tree(got, _as_saved(tree))
    with open(os.path.join(step_dir, "_CHECKPOINT_METADATA")) as fh:
        assert "StandardCheckpointHandler" in json.load(fh)[
            "item_handlers"]["default"]


def test_the_port_reads_its_own_write_with_numpy_alone(written, tmp_path,
                                                       monkeypatch):
    """A GPU host may lack tensorstore and zstandard: the port's own
    layout needs neither, and the reference layouts name what they
    need."""
    dirs, tree = written
    src = tio.restore_raw(dirs["zstd"])[0]
    tio.save_raw(str(tmp_path / "checkpoints"), 3, src)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    got, step, steps = tio.restore_raw(str(tmp_path))
    assert (step, steps) == (3, [3])
    _assert_same_tree(got, _as_saved(tree))
    with pytest.raises(ImportError, match="'tensorstore'"):
        tio.restore_raw(dirs["ocdbt"])
    with pytest.raises(ImportError, match="'zstandard'"):
        tio.restore_raw(dirs["zstd"])


def test_zlib_chunks_read_by_the_stdlib_and_the_reference(written,
                                                          tmp_path):
    """A chunk rewritten zlib-compressed (a zarr v2 compressor numpy's
    stdlib reads) restores equal through both packages."""
    _, tree = written
    tio.save_raw(str(tmp_path / "checkpoints"), 5, _as_saved(tree))
    array_dir = tmp_path / "checkpoints" / "5" / "default" / "params.lm_head.kernel"
    zarray = json.loads((array_dir / ".zarray").read_text())
    zarray["compressor"] = {"id": "zlib", "level": 1}
    (array_dir / ".zarray").write_text(json.dumps(zarray))
    chunk = array_dir / "0.0"
    chunk.write_bytes(zlib.compress(chunk.read_bytes(), 1))
    got = tio.restore_raw(str(tmp_path))[0]
    _assert_same_tree(got, _as_saved(tree))
    _assert_same_tree(got, jio.restore_raw(str(tmp_path))[0])


def test_zarr_edge_and_missing_chunks_read_as_tensorstore_reads_them(
        tmp_path):
    """Chunks that do not tile the array (edge chunks stored at full size,
    cropped on read) and a missing chunk (fill_value), against
    tensorstore's own zarr reader."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(0)
    full = rng.standard_normal((10, 3)).astype("<f4")
    array_dir = tmp_path / "a"
    array_dir.mkdir()
    (array_dir / ".zarray").write_text(json.dumps({
        "chunks": [4, 2], "compressor": {"id": "zlib", "level": 1},
        "dimension_separator": ".", "dtype": "<f4", "fill_value": 7.0,
        "filters": None, "order": "C", "shape": [10, 3],
        "zarr_format": 2}))
    for i in range(3):
        for j in range(2):
            if (i, j) == (1, 1):
                continue                       # missing: fill_value
            block = np.zeros((4, 2), "<f4")
            part = full[4 * i:4 * i + 4, 2 * j:2 * j + 2]
            block[:part.shape[0], :part.shape[1]] = part
            (array_dir / f"{i}.{j}").write_bytes(
                zlib.compress(block.tobytes()))
    got = _zarr_layout._read_zarr_v2(str(array_dir))
    want = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": str(array_dir)}}).result().read().result()
    assert got.dtype == torch.float32 and tuple(got.shape) == (10, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[4:8, 2] == 7.0).all()


def test_layouts_the_reader_does_not_take_raise(written, tmp_path):
    _, tree = written
    tio.save_raw(str(tmp_path / "checkpoints"), 1, _as_saved(tree))
    item = tmp_path / "checkpoints" / "1" / "default"
    meta = json.loads((item / "_METADATA").read_text())
    (item / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr3"):
        tio.restore_raw(str(tmp_path))
    (item / "_METADATA").write_text(json.dumps({**meta, "use_ocdbt": None}))
    with pytest.raises(ValueError, match="layout"):
        tio.restore_raw(str(tmp_path))
    (item / "_METADATA").write_text(json.dumps(meta))
    zarray_path = item / "global_step" / ".zarray"
    zarray = json.loads(zarray_path.read_text())
    zarray_path.write_text(json.dumps({**zarray,
                                       "compressor": {"id": "blosc"}}))
    with pytest.raises(ValueError, match="compressor"):
        tio.restore_raw(str(tmp_path))
    for other in ({"order": "F"}, {"dtype": ">i4"}):
        zarray_path.write_text(json.dumps({**zarray, **other}))
        with pytest.raises(ValueError, match="C-order"):
            tio.restore_raw(str(tmp_path))


def test_steps_errors_and_the_tmp_directory(written, tmp_path):
    """Missing directories and steps raise as the reference's do; a save
    in flight (``<step>.orbax-checkpoint-tmp``) is not a step; a step is
    written once."""
    _, tree = written
    for fn in (tio.restore_raw, jio.restore_raw):
        with pytest.raises(FileNotFoundError, match="checkpoints"):
            fn(str(tmp_path / "nope"))
    ckpt = tmp_path / "checkpoints"
    (ckpt / "9.orbax-checkpoint-tmp").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        tio.open_checkpoints(str(tmp_path))
    tio.save_raw(str(ckpt), 2, _as_saved(tree))
    tio.save_raw(str(ckpt), 4, _as_saved(tree))
    assert tio.open_checkpoints(str(tmp_path)) == [2, 4]
    for fn in (tio.restore_raw, jio.restore_raw):
        with pytest.raises(ValueError, match="step 3 not found"):
            fn(str(tmp_path), 3)
    with pytest.raises(FileExistsError):
        tio.save_raw(str(ckpt), 4, _as_saved(tree))
    assert tio.restore_raw(str(tmp_path))[1] == 4
    assert jio.restore_raw(str(tmp_path))[1] == 4


# ------------------------------------------------------------ verdicts


def _damage(step_dir, case):
    data = os.path.join(step_dir, "default", "params.lm_head.kernel", "0.0")
    manifest = os.path.join(step_dir, tio.MANIFEST_NAME)
    if case == "no_manifest":
        os.remove(manifest)
    elif case == "truncated":
        with open(data, "r+b") as fh:
            fh.truncate(os.path.getsize(data) - 3)
    elif case == "flipped_bit":
        with open(data, "r+b") as fh:
            fh.seek(11)
            byte = fh.read(1)[0]
            fh.seek(11)
            fh.write(bytes([byte ^ 0x10]))
    elif case == "missing_file":
        os.remove(data)
    elif case == "unreadable_manifest":
        with open(manifest, "w") as fh:
            fh.write("{not json")


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("case", ["valid", "no_manifest", "truncated",
                                  "flipped_bit", "missing_file",
                                  "unreadable_manifest"])
def test_verify_checkpoint_verdicts_equal_the_reference(written, tmp_path,
                                                        case, full):
    _, tree = written
    step_dir = tio.save_raw(str(tmp_path / "checkpoints"), 1,
                            _as_saved(tree))
    _damage(step_dir, case)
    got = tio.verify_checkpoint(step_dir, full=full)
    assert got == jio.verify_checkpoint(step_dir, full=full)
    want = {"valid": "valid", "no_manifest": "unverified",
            "flipped_bit": "corrupt" if full else "valid"}.get(case,
                                                              "corrupt")
    assert got[0] == want, got


# ------------------------------------------------- the restore recipe


@pytest.mark.parametrize("n_virtual", [1, 2])
def test_merge_pipeline_params_equals_the_reference(n_virtual):
    cfg = jgpt.GptConfig(**{**SMALL, "num_layers": 4})
    params = _jax_state(cfg)["params"]
    pp = jax.device_get(jgpt.split_params_for_pipeline(params, 2, 4))
    if n_virtual > 1:
        # An interleaved tree: [n_virtual, n_pipe, per, ...] leaves.
        pp["stages"] = jax.tree.map(
            lambda x: x.reshape((n_virtual, 2, 1) + x.shape[2:]),
            pp["stages"])
    want = jgpt.merge_pipeline_params(pp, 4, n_virtual=n_virtual)
    got = tgpt.merge_pipeline_params(
        jax.tree.map(torch.from_numpy, pp), 4, n_virtual=n_virtual)
    _assert_same_tree(got, jax.device_get(want))
    _assert_same_tree(got, params)


def test_pipeline_bundle_name_equals_the_reference():
    from distributed_tensorflow_tpu.models import registry as jregistry
    for args in ((2, "gpipe", 2), (4, "1f1b", 2), (2, "interleaved", 3)):
        assert (tregistry.pipeline_bundle_name(*args)
                == jregistry.pipeline_bundle_name(*args))


ARCHS = {
    "learned": {},
    "rope": dict(pos_encoding="rope"),
    "gqa": dict(num_heads=4, kv_heads=2),
    "swiglu_rmsnorm": dict(activation="swiglu", norm="rmsnorm"),
}


@functools.lru_cache(maxsize=None)
def _mini_params(arch):
    cfg = dataclasses.replace(jgpt.mini(), **ARCHS[arch])
    return cfg, jax.device_get(jgpt.GptLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("pipelined", [False, True])
def test_gpt_tree_and_cfg_infers_the_references_config(arch, pipelined):
    """At ``mini()``'s widths (which the reference keeps) every field the
    reference infers agrees, and the trees are the same."""
    cfg, params = _mini_params(arch)
    if pipelined:
        params = jax.device_get(jgpt.split_params_for_pipeline(
            params, 2, cfg.num_layers))
    want_cfg, want_tree = jexport._gpt_tree_and_cfg(params)
    got_cfg, got_tree = texport._gpt_tree_and_cfg(
        jax.tree.map(torch.from_numpy, jax.device_get(params)))
    for field in dataclasses.fields(want_cfg):
        assert getattr(got_cfg, field.name) == getattr(
            want_cfg, field.name), field.name
    _assert_same_tree(got_tree, jax.device_get(want_tree))
    kernel = texport.kernel_config(got_cfg)
    assert kernel.attention_backend == "pallas"
    assert kernel.fused_ln == (got_cfg.norm == "layernorm")


def test_gpt_tree_and_cfg_infers_the_widths():
    """The port reads the widths from the tree, so checkpoints wider than
    ``mini()`` restore (the reference's restore keeps ``mini()``'s)."""
    cfg = jgpt.GptConfig(**{**SMALL, "num_heads": 4, "kv_heads": 2})
    params = jax.tree.map(torch.from_numpy, _jax_state(cfg)["params"])
    got, _ = texport._gpt_tree_and_cfg(params)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position", "kv_heads"):
        assert getattr(got, field) == getattr(cfg, field), field


def test_restore_memo(written, tmp_path):
    """EMA preferred; a size-1 memo keyed on the resolved step; ``None``
    re-resolves the newest step at every call; clear drops it."""
    _, tree = written
    texport.clear_restore_memo()
    ckpt = str(tmp_path / "checkpoints")
    tio.save_raw(ckpt, 1, _as_saved(tree))
    first = texport._restore_raw(str(tmp_path), None)
    assert first[2] == 7 and first[1] is None      # the saved global_step
    _assert_same_tree(first[0], _as_saved(tree["ema_params"]))
    assert texport._restore_raw(str(tmp_path), 1) is first
    newer = dict(_as_saved(tree), global_step=np.asarray(9, np.int32))
    del newer["ema_params"]
    tio.save_raw(ckpt, 2, newer)
    second = texport._restore_raw(str(tmp_path), None)
    assert second[2] == 9
    _assert_same_tree(second[0], _as_saved(tree["params"]))
    assert texport._restore_raw(str(tmp_path), 2) is second
    texport.clear_restore_memo()
    assert texport._restore_raw(str(tmp_path), 2) is not second
    texport.clear_restore_memo()
    with pytest.raises(FileNotFoundError, match="checkpoints"):
        texport._restore_raw(str(tmp_path / "nope"), None)
