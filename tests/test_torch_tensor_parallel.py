"""The port's tensor parallelism (distributed_tensorflow_tpu_torch/parallel/
sharding.shard_state with models/gpt.gpt_sharding_rules: column-parallel
qkv/q_proj/mlp_in/mlp_gate, per-shard attention, row-parallel out/mlp_out
summed once with their biases added once, vocab-parallel embeddings and a
column-parallel LM head) against the JAX package's shard_state under
GSPMD on create_mesh(data=4, model=2) of the 8 fake CPU devices of
tests/conftest.py; the port on a single-process mesh of [cpu] * n (one
data replica a process; the data axis is the worker processes).

Cases: the GPT forward (f32, 2e-4 as JAX's test_tp_forward_matches_
replicated), three Adam sync steps' losses against the JAX TP step (1e-4,
as JAX's test_tp_training_matches_dp), the TP step against the port's
unsharded step (SGD: the parameters show the gradients; 1e-6), GQA, tp2 x
ring2 and tp2 x ulysses2 against JAX's dp x seq x model mesh, a TP
checkpoint restored by the other package both ways with equal logits, two
gloo workers each on a seq=2 x model=2 mesh (dp x sp x tp, as JAX's
test_tp_sp_dp_combined_mesh composes it) against the one-process step,
and the CLI with --device=cpu, --log_sharding and JAX's flag errors.  The
port's attention runs the flash function's plain version on the CPU; the
JAX side's dense xla attention (both exact)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.ops.attention import attention_mesh as jamesh
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.training.state import (
    TrainState as JTrainState)
from distributed_tensorflow_tpu.training.supervisor import (
    Supervisor as JSupervisor)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import TrainState
from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position=32, dtype="float32")
GQA = dict(kv_heads=2, activation="swiglu", pos_encoding="rope",
           norm="rmsnorm")
B, S = 8, 16
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return {**SMALL, **kw}


def _jax_model(backend="xla", **kw):
    return jgpt.GptLM(jgpt.GptConfig(**_cfg(attention_backend=backend,
                                             **kw)))


def _jax_params(**kw):
    model = _jax_model(**kw)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])


def _batches(n, seed=0):
    cfg = tgpt.GptConfig(**_cfg())
    return [tgpt.synthetic_lm_batch(seed + i, B, S, cfg)["tokens"]
            for i in range(n)]


def _port_state(params, *, backend="pallas", mesh=None, tx=None,
                fused=True, **kw):
    cfg = tgpt.GptConfig(**_cfg(attention_backend=backend,
                                fused_ln=fused and kw.get("norm") != "rmsnorm",
                                **kw))
    model = tgpt.GptLM(cfg, device="cpu", param_dtype=torch.float32,
                       mesh=mesh)
    model.load_state_dict(tgpt.params_from_jax(params))
    return TrainState.create(model, tx or topt.make_optimizer("adam", 1e-3),
                             params_to_tree=tgpt.params_to_jax,
                             params_from_tree=tgpt.params_from_jax)


def _tp(state, seq=1, model=2):
    mesh = tmesh.create_mesh(data=1, seq=seq, model=model,
                             devices=[CPU] * (seq * model))
    return tsh.shard_state(mesh, state, tgpt.gpt_sharding_rules())


def _loss_fn(model, tokens):
    t = torch.as_tensor(tokens).long()
    loss, acc = tgpt.lm_loss(model(t), t)
    return loss, {"accuracy": acc}


def _jax_loss_fn(model):
    def loss_fn(params, tokens):
        loss, acc = jgpt.lm_loss(model.apply({"params": params}, tokens),
                                 tokens)
        return loss, {"accuracy": acc}
    return loss_fn


# 3 heads and a 33-row position table do not split over model=2: those
# leaves stay replicated (with the warning), the MLP and the vocabulary
# still split.
MISFIT = dict(num_heads=3, hidden_size=48, max_position=33)


@pytest.mark.parametrize("arch", ["mha", "gqa", "misfit"])
def test_tp_forward_matches_jax_shard_state(arch):
    kw = {"mha": {}, "gqa": GQA, "misfit": MISFIT}[arch]
    params = _jax_params(**kw)
    mesh = jmesh.create_mesh(data=4, model=2)
    model = _jax_model(**kw)
    js = JTrainState.create(lambda p, t: model.apply({"params": p}, t),
                            params, optax.adam(1e-3))
    placed = jsh.shard_state(mesh, js, jgpt.gpt_sharding_rules())
    tokens = _batches(1)[0]
    want = np.asarray(jax.jit(placed.apply_fn)(
        placed.params, jax.device_put(tokens, jmesh.batch_sharding(mesh))))
    ts = _tp(_port_state(params, **kw))
    assert tsh.shard_dim(ts.model.lm_head, "kernel") == 1
    assert tsh.shard_dim(ts.model.layers[0].mlp_in, "kernel") == 1
    got = ts.model(torch.from_numpy(tokens).long()).detach().numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_three_adam_steps_match_the_jax_tp_step():
    params = _jax_params()
    mesh = jmesh.create_mesh(data=4, model=2)
    model = _jax_model()
    js = jsh.shard_state(mesh, JTrainState.create(
        lambda p, t: model.apply({"params": p}, t), params,
        optax.adam(1e-3)), jgpt.gpt_sharding_rules())
    jstep = jsync.build_sync_train_step(mesh, _jax_loss_fn(model),
                                        donate=False, log_grad_norm=True)
    ts = _tp(_port_state(params))
    tstep = tsync.build_sync_train_step(_loss_fn, log_grad_norm=True)
    for i, tokens in enumerate(_batches(3)):
        js, jm = jstep(js, jax.device_put(tokens,
                                          jmesh.batch_sharding(mesh)))
        ts, tm = tstep(ts, tokens)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **STEP_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert tm["global_step"] == int(jm["global_step"]) == i + 2
    # Parameters stay sharded after the steps (no silent gather).
    assert len(tsh.shards(ts.model.layers[0].qkv, "kernel")) == 2


@pytest.mark.parametrize("arch", ["mha", "gqa"])
def test_tp_step_equals_the_unsharded_step(arch):
    """The same weights and batches through the TP model and the unsharded
    one: losses, global norms (each shard counted once), SGD-updated
    parameters and their moving averages (per shard) agree to the order
    of fp32 sums, and the dropout masks are the unsharded ones.  The GQA
    model also recomputes its blocks in the backward (remat) with the
    mesh its blocks hold."""
    kw = dict(GQA, remat=True) if arch == "gqa" else {}
    params = _jax_params(**GQA) if arch == "gqa" else _jax_params()
    sgd = topt.make_optimizer("sgd", 0.5)
    drop = dict(dropout_rate=0.1)
    tp = _port_state(params, tx=sgd, **drop, **kw)
    plain = _port_state(params, tx=sgd, **drop, **kw)
    for s in (tp, plain):
        s.rng = torch.Generator().manual_seed(5)
        s.ema_params = {n: p.detach().clone()
                        for n, p in s.model.named_parameters()}
    _tp(tp)
    step = tsync.build_sync_train_step(
        lambda m, b, rng: (lambda t: (tgpt.lm_loss(m(t, rng), t)[0], {}))(
            torch.as_tensor(b).long()), needs_rng=True, log_grad_norm=True,
        ema_decay=0.5)
    for tokens in _batches(3, seed=7):
        tp, a = step(tp, tokens)
        plain, b = step(plain, tokens)
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(a["grad_norm"]),
                                   float(b["grad_norm"]), rtol=1e-5)
    got = tsh.gather_named(tp.model, dict(tp.model.named_parameters()))
    ema = tsh.gather_named(tp.model, tp.ema_params)
    for name, p in plain.model.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(),
                                   plain.ema_params[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_tp2_with_sequence_parallel_matches_jax(backend):
    """tp2 x ring2 (the heads-sharded ring: each model column its own ring
    over its heads) and tp2 x ulysses2, three Adam steps against JAX's
    dp2 x seq2 x model2 mesh from the same weights."""
    params = _jax_params()
    mesh = jmesh.create_mesh(data=2, seq=2, model=2)
    model = _jax_model(backend)
    with jamesh(mesh):
        js = jsh.shard_state(mesh, JTrainState.create(
            lambda p, t: model.apply({"params": p}, t), params,
            optax.adam(1e-3)), jgpt.gpt_sharding_rules())
        jstep = jsync.build_sync_train_step(mesh, _jax_loss_fn(model),
                                            donate=False)
        tmesh_ = tmesh.create_mesh(data=1, seq=2, model=2, devices=[CPU] * 4)
        ts = tsh.shard_state(tmesh_, _port_state(params, backend=backend,
                                                 mesh=tmesh_),
                             tgpt.gpt_sharding_rules())
        assert ts.model.layers[0].mesh is tmesh_
        tstep = tsync.build_sync_train_step(_loss_fn)
        for tokens in _batches(3, seed=20):
            js, jm = jstep(js, jax.device_put(
                tokens, jmesh.batch_sharding(mesh)))
            ts, tm = tstep(ts, tokens)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       **STEP_TOL)


def test_a_tp_checkpoint_restores_across_the_packages(tmp_path):
    """Port TP run -> its Supervisor's checkpoint -> the JAX Supervisor
    into a JAX shard_state template; and a JAX TP run's checkpoint -> the
    port's Supervisor into a sharded port state.  Logits equal."""
    params = _jax_params()
    mesh = jmesh.create_mesh(data=4, model=2)
    model = _jax_model()
    apply_fn = lambda p, t: model.apply({"params": p}, t)

    def jax_template():
        return jsh.shard_state(mesh, JTrainState.create(
            apply_fn, params, optax.adam(1e-3)), jgpt.gpt_sharding_rules())
    tokens = _batches(2, seed=30)
    probe = torch.from_numpy(tokens[1]).long()
    # Port -> JAX.
    ts = _tp(_port_state(params))
    sv = Supervisor(is_chief=True, logdir=str(tmp_path / "port"),
                    init_fn=lambda: ts)
    ts = sv.prepare_or_wait_for_state()
    ts, _ = tsync.build_sync_train_step(_loss_fn)(ts, tokens[0])
    sv.maybe_save(ts, force=True)
    sv.close()
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path / "port"),
                      init_fn=jax_template)
    restored = jsv.prepare_or_wait_for_state()
    jsv.close()
    assert int(restored.global_step) == 2
    assert not restored.params["layer0"]["qkv"][
        "kernel"].sharding.is_fully_replicated
    np.testing.assert_allclose(
        np.asarray(jax.jit(apply_fn)(restored.params, tokens[1])),
        ts.model(probe).detach().numpy(), **FWD_TOL)
    # JAX -> port.
    js = jax_template()
    jstep = jsync.build_sync_train_step(mesh, _jax_loss_fn(model),
                                        donate=False)
    js, _ = jstep(js, jax.device_put(tokens[0], jmesh.batch_sharding(mesh)))
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path / "jax"),
                      init_fn=lambda: js)
    jsv.prepare_or_wait_for_state()
    jsv.maybe_save(js, force=True)
    jsv.close()
    target = _tp(_port_state(_jax_params()))
    sv = Supervisor(is_chief=True, logdir=str(tmp_path / "jax"),
                    init_fn=lambda: target)
    got = sv.prepare_or_wait_for_state()
    sv.close()
    assert got.global_step == 2 and got.optimizer.count == 1
    np.testing.assert_allclose(
        got.model(probe).detach().numpy(),
        np.asarray(jax.jit(apply_fn)(js.params, tokens[1])), **FWD_TOL)


_RANK = r"""
import sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch.models import gpt
from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_lib, sync
from distributed_tensorflow_tpu_torch.parallel.sharding import (
    gather_named, shard_state)
from distributed_tensorflow_tpu_torch.training.optimizers import make_optimizer
from distributed_tensorflow_tpu_torch.training.state import TrainState
rank, store, data, out, backend = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
mesh = mesh_lib.create_mesh(data=1, seq=2, model=2,
                            devices=[torch.device("cpu")] * 4)
d = np.load(data)
cfg = gpt.GptConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, intermediate_size=64, max_position=32,
                    dtype="float32", attention_backend=backend,
                    fused_ln=True)
model = gpt.GptLM(cfg, device="cpu", param_dtype=torch.float32, mesh=mesh)
model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in d.items()
                       if k.startswith("p:")})
state = shard_state(mesh, TrainState.create(
    model, make_optimizer("sgd", 0.5), params_to_tree=gpt.params_to_jax,
    params_from_tree=gpt.params_from_jax), gpt.gpt_sharding_rules())
def loss_fn(m, tokens):
    t = torch.from_numpy(tokens).long()
    return gpt.lm_loss(m(t), t)[0], {}
step = sync.build_sync_train_step(loss_fn, all_reduce=sync.GradientAllReduce())
losses = []
for tokens in d["tokens"]:
    half = tokens.shape[0] // 2
    state, m = step(state, tokens[rank * half:(rank + 1) * half])
    losses.append(float(m["loss"]))
whole = gather_named(model, dict(model.named_parameters()))
np.savez(out, losses=np.asarray(losses),
         **{k: v.detach().numpy() for k, v in whole.items()})
dist.destroy_process_group()
"""


@pytest.mark.parametrize("backend", ["ulysses"])
def test_two_gloo_workers_each_a_seq_model_mesh(tmp_path, backend):
    """dp x sp x tp: two processes, each a seq=2 x model=2 mesh on half of
    every global batch, one gloo all-reduce of every shard's gradient a
    step; the workers end bit-equal, and equal to the one-process
    unsharded step on the whole batch (SGD, 1e-6) and to JAX's dp2 x seq2
    x model2 losses (1e-4)."""
    params = _jax_params()
    tokens = np.stack(_batches(3, seed=40))
    flat = tgpt.params_from_jax(params)
    np.savez(tmp_path / "data.npz", tokens=tokens,
             **{f"p:{k}": v.numpy() for k, v in flat.items()})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / "data.npz"), str(tmp_path / f"rank{r}.npz"),
         backend], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=180)
        assert p.returncode == 0, out
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    plain = _port_state(params, tx=topt.make_optimizer("sgd", 0.5))
    step = tsync.build_sync_train_step(_loss_fn)
    losses = []
    for t in tokens:
        plain, m = step(plain, t)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], losses, atol=1e-6)
    for name, p in plain.model.named_parameters():
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
        np.testing.assert_allclose(ranks[0][name], p.detach().numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    mesh = jmesh.create_mesh(data=2, seq=2, model=2)
    model = _jax_model(backend)
    with jamesh(mesh):
        js = jsh.shard_state(mesh, JTrainState.create(
            lambda p, t: model.apply({"params": p}, t), params,
            optax.sgd(0.5)), jgpt.gpt_sharding_rules())
        jstep = jsync.build_sync_train_step(mesh, _jax_loss_fn(model),
                                            donate=False)
        for t, want in zip(tokens, ranks[0]["losses"]):
            js, jm = jstep(js, jax.device_put(t, jmesh.batch_sharding(mesh)))
            np.testing.assert_allclose(want, float(jm["loss"]), **STEP_TOL)


# ---------------------------------------------------------------- the CLI


def _cli(tmp_path, *flags):
    return ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--worker_hosts=localhost:0",
        "--ps_hosts=", "--device=cpu", "--model=gpt_mini",
        "--fused_layer_norm", "--bert_seq_len=32", "--batch_size=8",
        "--train_steps=8", "--log_every=4", "--validation_every=0",
        f"--logdir={tmp_path}/run", *flags])


@pytest.fixture
def standalone(monkeypatch):
    """The port's Server without the coordination service or a process
    group (single-process CLI runs)."""
    from distributed_tensorflow_tpu_torch.cluster.server import Server
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def test_cli_trains_evals_and_generates_tp2_ulysses2(tmp_path, standalone,
                                                     capsys):
    flags = ("--tensor_parallel=2", "--sequence_parallel=2",
             "--attention_backend=ulysses")
    result = _cli(tmp_path, *flags, "--log_sharding",
                  "--sync_replicas=true")
    out = capsys.readouterr().out
    for line in (
            "Worker 0: mesh dp-1-tp2-sp2-mb1 (seq=2, model=2): 4 positions "
            "on 1 distinct device(s) cpu, cpu, cpu, cpu",
            "Worker 0: param layer0/qkv/kernel (128, 3, 4, 32) -> "
            "PartitionSpec(None, None, 'model', None) on cpu, cpu",
            "Worker 0: param layer0/out/bias (128,) -> PartitionSpec() on "
            "cpu",
            "Worker 0: param word_emb/embedding (256, 128) -> "
            "PartitionSpec('model', None) on cpu, cpu"):
        assert line in out, line
    assert result.final_global_step == 8
    evaluated = _cli(tmp_path, *flags, "--mode=eval")
    assert evaluated["global_step"] == 8
    assert evaluated["test_accuracy"] == result.test_accuracy
    toks = ttrain.app.run(ttrain.main, [
        "--mode=generate", "--model=gpt_mini", f"--logdir={tmp_path}/run",
        "--device=cpu", "--gen_tokens=4", "--gen_prompt=1,2,3"])
    assert "Restored global step: 8" in capsys.readouterr().out
    assert len(toks) == 7


def test_cli_async_flag_with_tp_trains_in_sync_and_mlp_stays_replicated(
        tmp_path, standalone, capsys):
    _cli(tmp_path, "--tensor_parallel=2", "--attention_backend=pallas",
         "--sync_replicas=false", "--train_steps=3")
    assert ("tensor parallelism requires lockstep replicas; async mode "
            "unsupported — using sync." in capsys.readouterr().out)
    ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--worker_hosts=localhost:0",
        "--device=cpu", "--data_dir=/nonexistent", "--train_steps=3",
        "--batch_size=16", "--hidden_units=8", "--tensor_parallel=2",
        "--sync_replicas=true", "--log_sharding",
        f"--logdir={tmp_path}/mlp"])
    assert ("Worker 0: param hid/kernel (784, 8) -> PartitionSpec() on cpu"
            in capsys.readouterr().out)


@pytest.mark.parametrize("flags,error,match", [
    (("--pipeline_parallel=2", "--tensor_parallel=2"), ValueError,
     "--pipeline_parallel with --tensor_parallel is not supported"),
    (("--pipeline_parallel=2", "--sequence_parallel=2",
      "--attention_backend=ring"), ValueError, "cannot nest"),
    (("--expert_parallel=2",), ValueError, "needs an MoE model"),
    (("--model=bert_moe", "--expert_parallel=3"), ValueError,
     "must be divisible by --expert_parallel=3"),
    (("--sequence_parallel=2",), ValueError,
     "needs a sequence-parallel attention backend"),
    # The model axis across two sync workers of one CPU each: 8f's (local
    # rows beside the pipeline run since 8e:
    # test_cli_pipeline_beside_local_rows_trains).
    (("--tensor_parallel=2", "--worker_hosts=localhost:1,localhost:2"),
     NotImplementedError, "ROADMAP.*8f"),
    (("--pipeline_parallel=2", "--gpt_matmul_int8"), ValueError,
     "--gpt_matmul_int8 with --pipeline_parallel is not wired up"),
    (("--pipeline_parallel=2", "--fsdp"), ValueError,
     "--fsdp is incompatible with models that own their placement"),
    (("--dcn_data_parallel=3", "DTF_TORCH_CPU_DEVICES=4"), ValueError,
     "not divisible by dcn_data=3"),
    (("--model=bert_moe", "--expert_parallel=4", "--num_experts=6"),
     ValueError, "must be divisible by --expert_parallel=4"),
])
def test_cli_flag_errors_match_jax(tmp_path, standalone, monkeypatch, flags,
                                  error, match):
    for f in flags:
        if not f.startswith("--"):
            monkeypatch.setenv(*f.split("=", 1))
    with pytest.raises(error, match=match):
        _cli(tmp_path, "--sync_replicas=true",
             *(f for f in flags if f.startswith("--")))


def test_tp_with_int8_matmuls_raises():
    # Int8 beside tensor parallelism is ported (slice 8b:
    # tests/test_torch_int8_tp.py), and beside an in-process data axis
    # too (slice 8d): each data row holds its own int8 model's shards.
    params = _jax_params()
    state = _port_state(params, matmul_int8=True)
    tsh.shard_state(tmesh.create_mesh(data=2, model=2, devices=[CPU] * 4),
                    state, tgpt.gpt_sharding_rules())
    assert len(state.rows) == 1
    for (n, p), (m, q) in zip(state.model.named_parameters(),
                              state.rows[0].named_parameters()):
        assert n == m and torch.equal(p, q)


def test_cli_pipeline_beside_local_rows_trains(tmp_path, standalone,
                                               monkeypatch, capsys):
    # A NAME=value item of the flag cases above sets an environment
    # variable; here the CPU as four devices gives the data axis two local
    # rows beside --pipeline_parallel=2 (each row a pipelined copy).
    monkeypatch.setenv("DTF_TORCH_CPU_DEVICES", "4")
    result = _cli(tmp_path, "--sync_replicas=true", "--pipeline_parallel=2",
                  "--train_steps=4")
    assert result.final_global_step == 4
    assert ("mesh dp-1-pp2-mb1 (data=2, pipe=2, seq=1, model=1): 4 "
            "positions" in capsys.readouterr().out)
