"""The port's declarative layout (distributed_tensorflow_tpu_torch/parallel/
mesh.py: ParallelConfig, create_mesh, the run profiles) against the JAX
package's over the same arguments: validation messages, describe,
resolve, resolved_attention, from_flags, to_dict/from_dict, the meshes
they build (the JAX side on the 8 fake CPU devices of tests/conftest.py,
the port on [cpu] * n), placement dispatch, and a run profile written by
one package and read by the other.  Port-only: the axes not ported yet
raise naming their ROADMAP slice, and a worker's positions go round robin
over its cards."""

import types

import pytest
import torch

from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import TrainState

CPU = torch.device("cpu")

CONFIGS = [
    dict(),
    dict(data=4),
    dict(data=2, model=2, microbatch=2, quantize="int8"),
    dict(data=-1, model=2, seq=2, attention="ulysses"),
    dict(seq=4),
    dict(data=1, pipe=2, expert=2, dcn_data=2, fsdp=True,
         fsdp_min_size=1024),
    dict(model=4, attention="pallas"),
]


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_config_methods_match_jax(kwargs):
    j, t = jmesh.ParallelConfig(**kwargs), tmesh.ParallelConfig(**kwargs)
    assert t.describe() == j.describe()
    assert t.axis_sizes() == j.axis_sizes()
    assert t.resolved_attention() == j.resolved_attention()
    assert t.to_dict() == j.to_dict()
    assert tmesh.ParallelConfig.from_dict(j.to_dict()) == t
    for n in (8, 16):
        try:
            want = j.resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                t.resolve(n)
        else:
            assert t.resolve(n).to_dict() == want.to_dict()
            assert t.total_devices(n) == j.total_devices(n)


@pytest.mark.parametrize("kwargs", [
    dict(quantize="fp4"), dict(model=0), dict(data=-2), dict(seq=0),
    dict(seq=2, attention="xla"), dict(seq=2, attention="pallas"),
    dict(attention="flash"), dict(microbatch=0),
])
def test_validation_messages_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jmesh.ParallelConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        tmesh.ParallelConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_from_dict_is_strict_and_from_flags_maps_the_cli():
    with pytest.raises(ValueError) as want:
        jmesh.ParallelConfig.from_dict({"data": 1, "typo": 3})
    with pytest.raises(ValueError) as got:
        tmesh.ParallelConfig.from_dict({"data": 1, "typo": 3})
    assert str(got.value) == str(want.value)
    flags = types.SimpleNamespace(
        tensor_parallel=2, sequence_parallel=2, pipeline_parallel=1,
        expert_parallel=1, dcn_data_parallel=1, grad_accum_steps=2,
        gpt_matmul_int8=True, attention_backend="ulysses", fsdp=False,
        fsdp_min_size=1024)
    assert (tmesh.ParallelConfig.from_flags(flags).to_dict()
            == jmesh.ParallelConfig.from_flags(flags).to_dict())
    empty = types.SimpleNamespace()
    assert (tmesh.ParallelConfig.from_flags(empty).to_dict()
            == jmesh.ParallelConfig.from_flags(empty).to_dict())


@pytest.mark.parametrize("kwargs", [
    dict(data=-1), dict(data=-1, model=2), dict(data=-1, seq=2),
    dict(data=-1, model=2, seq=2), dict(data=2), dict(data=1, model=4),
])
def test_build_mesh_matches_jax(kwargs):
    j, t = jmesh.ParallelConfig(**kwargs), tmesh.ParallelConfig(**kwargs)
    want = j.build_mesh()
    got = t.build_mesh([CPU] * 8)
    assert got.axis_names == want.axis_names == tmesh.AXIS_ORDER
    assert got.shape == dict(want.shape)
    assert t.batch_sharding(got) == tuple(j.batch_sharding(want).spec)
    assert (t.batch_sharding(got, stacked=True)
            == tuple(j.batch_sharding(want, stacked=True).spec))
    assert tmesh.num_replicas(got) == jmesh.num_replicas(want)


def test_mesh_views_and_the_axes_not_ported():
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = tmesh.create_mesh(data=2, seq=2, model=2, devices=devs)
    assert mesh.model_devices() == [devs[0], devs[1]]
    assert [str(d) for d in mesh.grid(1).flatten()] == [
        "cpu:1", "cpu:3", "cpu:5", "cpu:7"]
    col = mesh.column(1)
    assert col.shape == {"data": 2, "seq": 2, "pipe": 1, "expert": 1,
                         "model": 1}
    assert list(col.grid(0).flatten()) == list(mesh.grid(1).flatten())
    assert tmesh.data_parallel_mesh(4, devices=devs).shape["data"] == 4
    # The expert axis is ported (item 7c): expert e on expert device e.
    experts = tmesh.create_mesh(data=1, expert=4, model=2, devices=devs)
    assert [str(d) for d in experts.axis_devices("expert")] == [
        "cpu:0", "cpu:2", "cpu:4", "cpu:6"]
    # The DCN factor is ported (slice 8d): slice-major order (one
    # positional group for torch devices), its rows grouped by slice.
    hybrid = tmesh.create_mesh(devices=devs, dcn_data=2)
    assert list(hybrid.devices.flatten()) == devs
    assert hybrid.row_slices() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    # The pipe axis is ported (slice 8c): stage s on pipe device s.
    piped = tmesh.create_mesh(data=2, pipe=4, devices=devs)
    assert piped.shape["pipe"] == 4
    assert [str(d) for d in piped.pipe_devices()] == [
        "cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    with pytest.raises(ValueError, match="needs 16 devices"):
        tmesh.ParallelConfig(data=8, model=2).build_mesh(devs)


def test_worker_positions_lay_seq_times_model_over_the_cards(monkeypatch):
    assert tmesh.worker_positions("cpu", 3, 4) == [CPU] * 4
    assert tmesh.worker_positions("cuda:1", 0, 2) == [torch.device(
        "cuda", 1)] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.worker_positions("cuda", 0, 1) == [torch.device("cuda", 0)]
    assert tmesh.worker_positions("cuda", 1, 1) == [torch.device("cuda", 1)]
    assert [d.index for d in tmesh.worker_positions("cuda", 1, 2)] == [2, 3]
    assert [d.index for d in tmesh.worker_positions("cuda", 0, 8)] == [
        0, 1, 2, 3, 0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.worker_positions("cuda", 0, 4) == [torch.device(
        "cuda", 0)] * 4


def _mlp_state():
    model = tmlp.MnistMLP(8, seed=0, device="cpu")
    return TrainState.create(model, topt.make_optimizer("sgd", 0.1),
                             params_to_tree=tmlp.params_to_jax,
                             params_from_tree=tmlp.params_from_jax)


def test_place_state_dispatch():
    """Rules engage only on a model axis (JAX's use_tp): on a model=1 mesh
    the same rules leave every parameter replicated; FSDP raises."""
    rules = tsh.ShardingRules([(r"hid/kernel", tsh.P(None, "model")),
                               (r"sm/kernel", tsh.P("model", None))])
    flat = tmesh.ParallelConfig()
    state = flat.place_state(flat.build_mesh([CPU]), _mlp_state(), rules)
    assert not tsh.is_sharded(state.model)
    tp = tmesh.ParallelConfig(model=2)
    state = tp.place_state(tp.build_mesh([CPU] * 2), _mlp_state(), rules)
    assert tsh.shard_dim(state.model.hid, "kernel") == 1
    assert [tuple(p.shape) for p in tsh.shards(state.model.hid,
                                               "kernel")] == [(784, 4)] * 2
    assert tsh.shard_dim(state.model.sm, "kernel") == 0
    assert tsh.shards(state.model.hid, "bias") is None     # no rule
    # FSDP (slice 8b) shards over the workers' process group; one process
    # without a group keeps the state replicated, as JAX's data=1 mesh.
    fsdp = tmesh.ParallelConfig(fsdp=True)
    state = fsdp.place_state(fsdp.build_mesh([CPU]), _mlp_state(), None)
    assert not tsh.is_fsdp(state.model) and not tsh.is_sharded(state.model)
    # Data beside the model axis (slice 8d): each data row holds its own
    # copy of its shards.
    rows = tsh.shard_state(tmesh.create_mesh(data=2, model=2,
                                             devices=[CPU] * 4),
                           _mlp_state(), rules)
    assert len(rows.rows) == 1
    assert tsh.shard_dim(rows.rows[0].hid, "kernel") == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_profile_crosses_the_packages(tmp_path, writer):
    cfg = dict(data=2, model=2, seq=2, attention="ulysses", microbatch=2)
    path = str(tmp_path / "profile.json")
    save, load = ((jmesh.save_run_profile, tmesh.load_run_profile)
                  if writer == "jax" else
                  (tmesh.save_run_profile, jmesh.load_run_profile))
    pc = (jmesh if writer == "jax" else tmesh).ParallelConfig(**cfg)
    written = save(path, pc, workload={"model": "gpt_mini",
                                       "batch_size": 8},
                   tuning={"step_ms": 1.5})
    payload = load(path)
    assert payload == written
    reader = tmesh if writer == "jax" else jmesh
    assert reader.ParallelConfig.from_dict(payload["parallel"]).to_dict() \
        == pc.to_dict()


def test_run_profile_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "something/else"}')
    with pytest.raises(ValueError, match="run profile"):
        tmesh.load_run_profile(str(bad))
    worse = tmp_path / "worse.json"
    worse.write_text('{"schema": "%s", "parallel": {"data": 0}}'
                     % tmesh.PROFILE_SCHEMA)
    with pytest.raises(ValueError, match="positive"):
        tmesh.load_run_profile(str(worse))


def test_gpt_rules_engage_through_place_state():
    cfg = tgpt.GptConfig(vocab_size=16, hidden_size=16, num_layers=1,
                         num_heads=2, intermediate_size=32, max_position=16,
                         dtype="float32")
    model = tgpt.GptLM(cfg, device="cpu", param_dtype=torch.float32)
    state = TrainState.create(model, topt.make_optimizer("adam", 1e-3),
                              params_to_tree=tgpt.params_to_jax,
                              params_from_tree=tgpt.params_from_jax)
    pc = tmesh.ParallelConfig(model=2)
    pc.place_state(pc.build_mesh([CPU] * 2), state, tgpt.gpt_sharding_rules())
    assert tsh.shard_dim(model.layers[0].qkv, "kernel") == 2
    assert model.layers[0].mesh.shape["model"] == 2
