"""Two layouts of one process that the port's global mesh work opened
(``parallel/sharding._place_rows`` with a pipelined model,
``parallel/pipeline.py``'s steps over local data rows, and
``parallel/sharding.fsdp_state`` over local rows beside tensor
parallelism), held to the JAX package on the 8 fake CPU devices of
tests/conftest.py.

- Data rows beside the pipeline: gpt_mini's GPipe, 1F1B and interleaved
  steps at data=2 x pipe=2, the port on ``[cpu] * 4`` (each row a
  pipelined copy on its row's pipe positions), JAX on four devices.  One
  SGD step from the JAX bundle's weights and a numpy-seeded batch: the
  loss within 1e-5 (relative) and the updated stage-stacked tree within
  rtol 1e-4, atol 1e-5 (the test_torch_pipeline.py tolerances: the
  packages sum a gradient in different orders); the rows bit-equal; the
  checkpoint tree JAX's, restored by each package from the other's.
- FSDP over data=2 beside model=2: each position's slice has the shape
  and values of JAX's addressable shard of ``P("data", "model")`` (or
  its composed spec), and three SGD steps match JAX's within 1e-4 (the
  GPT tolerance of tests/test_torch_data_axis.py).  fp32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.models import registry as jreg
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.training.optimizers import (
    make_optimizer as jmake)
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu.training.supervisor import (
    Supervisor as JSupervisor)
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.tools.checkpoint_io import (
    restore_raw, save_raw)
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, load_checkpoint_tree)

CPU = torch.device("cpu")
SEQ = 16
LR = 0.05
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position=32, dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_trees(got, want, **tol):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), **tol), got, jax.device_get(want))


def _rows_equal(state):
    lead = dict(state.model.named_parameters())
    assert state.rows
    for model in state.rows:
        for name, p in model.named_parameters():
            assert torch.equal(p, lead[name]), name


# ------------------------------------------------- rows beside the pipeline


def _jax_pipeline(schedule, mesh):
    jb = jreg.build_gpt_pipeline(LR, mesh, seq_len=SEQ, n_micro=2,
                                 dtype="float32", tx=jmake("sgd", LR),
                                 schedule=schedule, virtual_stages=2)
    return jb, jb.place_state(mesh, jb.state)


def _port_pipeline(schedule, jparams=None, data=2):
    mesh = tmesh.create_mesh(data=data, pipe=2, devices=[CPU] * (2 * data))
    b = treg.build_gpt_pipeline(LR, mesh, seq_len=SEQ, n_micro=2,
                                dtype="float32",
                                tx=topt.make_optimizer("sgd", LR),
                                schedule=schedule, virtual_stages=2)
    if jparams is not None:
        # Before placement: every row copies the lead's weights.
        b.state.model.load_state_dict(
            b.state.model.params_from_tree(jparams))
    state = b.place_state(mesh, b.state)
    step = (b.train_step_builder(mesh) if b.train_step_builder
            else tsync.build_sync_train_step(b.loss_fn))
    return mesh, b, state, step


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_rows_beside_the_pipeline_match_jax(tmp_path, schedule):
    """data=2 x pipe=2: one SGD step, the loss and the updated tree
    against JAX's data=2 x pipe=2 step (2 micro-batches a data shard,
    2 a port row), the rows bit-equal, the checkpoint JAX's tree; the
    port's checkpoint restores in JAX's Supervisor and JAX's stepped
    state in the port's rows."""
    jm = jmesh.create_mesh(data=2, pipe=2, devices=jax.devices()[:4])
    jb, jstate = _jax_pipeline(schedule, jm)
    jparams = jax.device_get(jb.state.params)
    tokens = tgpt.synthetic_lm_batch(7, 8, SEQ, tgpt.mini())["tokens"]
    jstep = (jb.train_step_builder(jm) if jb.train_step_builder
             else jsync.build_sync_train_step(jm, jb.loss_fn, donate=False))
    jstate, jmet = jstep(jstate, jax.device_put(
        {"tokens": jnp.asarray(tokens)}, jmesh.batch_sharding(jm)))

    mesh, b, state, step = _port_pipeline(schedule, jparams)
    assert len(state.rows) == 1
    row = state.rows[0]
    assert row is not state.model and len(row.stages) == len(
        state.model.stages)
    state, met = step(state, {"tokens": tokens})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _rows_equal(state)
    tree = checkpoint_tree(state)
    assert _shapes(tree["params"]) == _shapes(jax.device_get(jstate.params))
    _close_trees(tree["params"], jstate.params, rtol=1e-4, atol=1e-5)

    # Port -> JAX: the raw checkpoint restores in JAX's Supervisor.
    save_raw(str(tmp_path / "port" / "checkpoints"), 2, tree)
    sv = JSupervisor(is_chief=True, logdir=str(tmp_path / "port"),
                     init_fn=lambda: _jax_pipeline(schedule, jm)[1])
    restored = sv.prepare_or_wait_for_state()
    sv.close()
    assert int(restored.global_step) == 2
    _close_trees(restored.params, tree["params"], rtol=0, atol=0)

    # JAX -> port: JAX's Supervisor saves its stepped state, the port's
    # rows restore it.
    sv = JSupervisor(is_chief=True, logdir=str(tmp_path / "jax"),
                     init_fn=lambda: jstate)
    sv.maybe_save(jstate, force=True)
    sv.close()
    _, _, fresh, _ = _port_pipeline(schedule)
    load_checkpoint_tree(fresh, restore_raw(str(tmp_path / "jax"))[0])
    _rows_equal(fresh)
    _close_trees(checkpoint_tree(fresh)["params"], jstate.params, rtol=0,
                 atol=0)
    t = torch.as_tensor(tokens[:4]).long()
    with torch.no_grad():
        np.testing.assert_array_equal(fresh.model(t).numpy(),
                                      fresh.rows[0](t).numpy())


def test_rows_beside_the_pipeline_keep_each_row_on_its_positions():
    """Each row's chunks sit on its row's pipe positions and the row's
    own device takes its part of the batch; two steps keep the rows
    bit-equal and equal the one-row pipeline on the whole batch."""
    mesh, b, state, step = _port_pipeline("1f1b")
    assert [m.device for m in tsh.row_models(state)] == [
        mesh.row(r).model_devices()[0] for r in range(2)]
    _, _, one, one_step = _port_pipeline("1f1b", data=1)
    for i in range(2):
        tokens = tgpt.synthetic_lm_batch(20 + i, 8, SEQ,
                                         tgpt.mini())["tokens"]
        state, met = step(state, {"tokens": tokens})
        one, met1 = one_step(one, {"tokens": tokens})
        np.testing.assert_allclose(float(met["loss"]), float(met1["loss"]),
                                   rtol=1e-5)
        _rows_equal(state)
    _close_trees(checkpoint_tree(state)["params"],
                 checkpoint_tree(one)["params"], rtol=1e-4, atol=1e-6)


# ------------------------------------------------------ FSDP beside TP


def _gpt_params():
    model = jgpt.GptLM(jgpt.GptConfig(**SMALL))
    return model, jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])


def _gpt_loss(model, tokens):
    t = torch.as_tensor(tokens).long()
    loss, acc = tgpt.lm_loss(model(t), t)
    return loss, {"accuracy": acc}


def _jax_gpt_loss(model):
    def loss_fn(params, tokens):
        loss, acc = jgpt.lm_loss(model.apply({"params": params}, tokens),
                                 tokens)
        return loss, {"accuracy": acc}
    return loss_fn


def test_fsdp_over_local_rows_beside_tp_matches_jax():
    """FSDP over data=2 x model=2 in one process: each position's slice
    is JAX's addressable shard (shape and values), a TP shard split over
    the rows along the dim the composed spec gives ``data``; three SGD
    steps against JAX's (loss, gradient norm, parameters; SGD: the
    parameters show the gradients, where Adam's first steps divide the
    near-zero moments of the key bias)."""
    jmodel, params = _gpt_params()
    jm = jmesh.create_mesh(data=2, model=2, devices=jax.devices()[:4])
    rules = jgpt.gpt_sharding_rules()
    js = jsh.fsdp_state(jm, JState.create(
        lambda p, t: jmodel.apply({"params": p}, t), params,
        optax.sgd(0.5)), rules, min_size=1024)
    jstep = jsync.build_sync_train_step(jm, _jax_gpt_loss(jmodel),
                                        donate=False, log_grad_norm=True)
    tm = tmesh.create_mesh(data=2, model=2, devices=[CPU] * 4)
    cfg = tgpt.GptConfig(**SMALL, attention_backend="pallas", fused_ln=True)
    model = tgpt.GptLM(cfg, device="cpu", param_dtype=torch.float32,
                       mesh=tm)
    model.load_state_dict(tgpt.params_from_jax(params))
    state = tsh.fsdp_state(tm, TrainState.create(
        model, topt.make_optimizer("sgd", 0.5),
        params_to_tree=tgpt.params_to_jax,
        params_from_tree=tgpt.params_from_jax),
        tgpt.gpt_sharding_rules(), min_size=1024)
    rows = tsh.row_models(state)
    leaf = js.params["layer0"]["mlp_in"]["kernel"]
    assert tuple(leaf.sharding.spec) == ("data", "model")
    # The port's positions in the mesh's order, as JAX's devices.
    positions = [(r, j) for r in range(2) for j in range(2)]
    order = [d.id for d in jm.devices.flatten()]
    for shard in leaf.addressable_shards:
        r, j = positions[order.index(shard.device.id)]
        got = tsh.shards(rows[r].layers[0].mlp_in, "kernel")[j]
        assert tuple(got.shape) == shard.data.shape
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(shard.data))
    step = tsync.build_sync_train_step(_gpt_loss, log_grad_norm=True)
    for i in range(3):
        tokens = tgpt.synthetic_lm_batch(40 + i, 8, 16,
                                         tgpt.GptConfig(**SMALL))["tokens"]
        js, jmet = jstep(js, jax.device_put(tokens,
                                            jmesh.batch_sharding(jm)))
        state, met = step(state, tokens)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   **GPT_TOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    _close_trees(checkpoint_tree(state)["params"], js.params, **GPT_TOL)
