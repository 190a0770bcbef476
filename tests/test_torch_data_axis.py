"""The port's data axis inside a worker (``parallel/mesh.py``'s
``dcn_data`` and data rows, ``parallel/sharding.py``'s rows beside
``model``/``seq``, FSDP over local positions, ``parallel/sync.py``'s
steps over the rows, ``parallel/async_replicas.py``'s replicas on their
own positions) against the JAX package on the 8 fake CPU devices of
``tests/conftest.py``; the port on ``devices=[cpu] * n``, weights carried
across with ``params_from_jax``, inputs from numpy seeds.

Tolerances, fp32: the MLP's losses 1e-5 absolute, gradient norms 1e-5
relative, parameters after three steps 1e-6 (the packages sum a gradient
in different orders); the GPT's losses and parameters 1e-4 (JAX's own
``test_tp_training_matches_dp``); FSDP slices bit-equal at placement;
BatchNorm's loss and running statistics 1e-5 (JAX's fp32 BatchNorm,
``tests/test_torch_batchnorm.py``).  The data rows of a worker hold
bit-equal parameters after every step."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.ops.attention import attention_mesh as jamesh
from distributed_tensorflow_tpu.parallel import async_replicas as jasync
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.parallel.sharding import replicate_tree
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import async_replicas as tasync
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree)

CPU = torch.device("cpu")
HIDDEN = 16
LOSS_TOL = 1e-5
PARAM_TOL = 1e-6
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position=32, dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- helpers


def _mlp_params():
    model = jmlp.MnistMLP(hidden_units=HIDDEN)
    return model, jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 784)))["params"])


def _jax_mlp_state(mesh, tx):
    model, params = _mlp_params()
    state = JState.create(lambda p, x: model.apply({"params": p}, x),
                          params, tx)
    return state.replace(params=replicate_tree(mesh, state.params),
                         opt_state=replicate_tree(mesh, state.opt_state),
                         global_step=replicate_tree(mesh, state.global_step))


def _jax_mlp_loss(state):
    def loss_fn(params, batch):
        x, y = batch
        logits = state.apply_fn(params, x)
        return jmlp.cross_entropy_loss(logits, y), {
            "accuracy": jmlp.accuracy(logits, y)}
    return loss_fn


def _port_mlp(spec):
    model = tmlp.MnistMLP(HIDDEN, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(_mlp_params()[1]))
    return TrainState.create(model, spec, params_to_tree=tmlp.params_to_jax,
                             params_from_tree=tmlp.params_from_jax)


def _port_mlp_loss(model, batch):
    x, y = (torch.as_tensor(np.asarray(a)) for a in batch)
    logits = model(x)
    return tmlp.cross_entropy_loss(logits, y), {
        "accuracy": tmlp.accuracy(logits, y)}


def _mlp_batches(n, rows=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((rows, 784), dtype=np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)])
            for _ in range(n)]


def _assert_tree_close(got, want, tol):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), atol=tol, rtol=0), got,
        jax.device_get(want))


def _assert_rows_equal(state):
    """Every data row holds the lead's bits (its FSDP slices its own)."""
    lead = dict(state.model.named_parameters())
    assert state.rows
    for model in state.rows:
        for name, p in model.named_parameters():
            if getattr(p, "fsdp_info", None) is None:
                assert torch.equal(p, lead[name]), name
        for (name, b), c in zip(model.named_buffers(),
                                state.model.buffers()):
            assert torch.equal(b, c), name


# ---------------------------------------------------------------- mesh


def test_hybrid_mesh_orders_positions_as_jax():
    devices = [torch.device("cpu", i) for i in range(8)]
    got = tmesh.create_mesh(data=4, model=2, dcn_data=2, devices=devices)
    want = jmesh.create_mesh(data=4, model=2, dcn_data=2,
                             devices=jax.devices()[:8])
    assert got.shape == dict(want.shape)
    assert [d.index for d in got.devices.flatten()] == [
        d.id for d in want.devices.flatten()]
    assert got.dcn_data == 2 and got.row_slices() == [[0, 1], [2, 3]]
    for mod, devs in ((tmesh, [CPU] * 3), (jmesh, jax.devices()[:3])):
        with pytest.raises(ValueError, match="dcn_data"):
            mod.create_mesh(data=3, dcn_data=2, devices=devs)
    # A real topology must match the DCN factor (JAX's _slice_major).
    fake = [types.SimpleNamespace(slice_index=i // 2, process_index=0)
            for i in range(8)]
    assert [d.slice_index for d in tmesh._slice_major(fake, 4)] == [
        0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError, match="slice count"):
        tmesh._slice_major(fake, 2)
    assert tmesh.data_sharded(got, extra_dims=1) == tuple(
        jmesh.data_sharded(want, extra_dims=1).spec)


def test_local_data_size_and_positions(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    # One worker on four cards: four data rows; two workers, two each.
    assert tmesh.local_data_size("cuda", 1) == 4
    assert tmesh.local_data_size("cuda", 1, num_workers=2) == 2
    assert tmesh.local_data_size("cuda", 2, num_workers=2) == 1
    monkeypatch.delenv(tmesh.CPU_DEVICES_ENV, raising=False)
    assert tmesh.local_data_size("cpu", 1) == 1
    # The CPU as eight devices (JAX's fake-device count), one as one.
    monkeypatch.setenv(tmesh.CPU_DEVICES_ENV, "8")
    assert tmesh.local_data_size("cpu", 2) == 4
    assert tmesh.local_data_size("cuda:1", 1) == 1
    assert [d.index for d in tmesh.worker_positions("cuda", 1, 2)] == [2, 3]


# ---------------------------------------------------------- sync steps


@pytest.mark.parametrize("data,dcn", [(4, 1), (8, 2)])
def test_mlp_sync_steps_over_local_rows_match_jax(data, dcn):
    jm = jmesh.create_mesh(data=data, dcn_data=dcn,
                           devices=jax.devices()[:data])
    jstate = _jax_mlp_state(jm, optax.adam(1e-3))
    jstep = jsync.build_sync_train_step(jm, _jax_mlp_loss(jstate),
                                        donate=False, log_grad_norm=True)
    state = tsh.replicate_state(
        tmesh.create_mesh(data=data, dcn_data=dcn, devices=[CPU] * data),
        _port_mlp(topt.make_optimizer("adam", 1e-3)))
    assert len(state.rows) == data - 1
    step = tsync.build_sync_train_step(_port_mlp_loss, log_grad_norm=True)
    sharding = jmesh.data_sharded(jm)
    for b in _mlp_batches(3):
        jstate, jmet = jstep(jstate, tuple(jax.device_put(a, sharding)
                                           for a in b))
        state, met = step(state, b)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_TOL
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
        assert met["global_step"] == int(jmet["global_step"])
        _assert_rows_equal(state)
    _assert_tree_close(checkpoint_tree(state)["params"], jstate.params,
                       PARAM_TOL)


def test_masked_step_over_two_rows_a_task_matches_jax():
    """Two workers' worth of replicas (``devices_per_task=2``) in one
    process, worker 1 dead: its two replicas' gradients dropped, the mean
    over the live two."""
    jm = jmesh.create_mesh(data=4, devices=jax.devices()[:4])
    jstate = _jax_mlp_state(jm, optax.sgd(0.1))
    jstep = jsync.build_masked_sync_train_step(jm, _jax_mlp_loss(jstate))
    mask = tsync.replica_mask_from_tasks([True, False], 2, 2)
    np.testing.assert_array_equal(mask, jsync.replica_mask_from_tasks(
        [True, False], 2, 2))
    state = tsh.replicate_state(tmesh.create_mesh(data=4, devices=[CPU] * 4),
                                _port_mlp(topt.make_optimizer("sgd", 0.1)))
    step = tsync.build_masked_sync_train_step(_port_mlp_loss, 4)
    sharding = jmesh.data_sharded(jm)
    for b in _mlp_batches(3, seed=1):
        jstate, jmet = jstep(jstate, tuple(jax.device_put(a, sharding)
                                           for a in b),
                             jax.device_put(mask, sharding))
        state, met = step(state, b, mask)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_TOL
        _assert_rows_equal(state)
    _assert_tree_close(checkpoint_tree(state)["params"], jstate.params,
                       PARAM_TOL)


def _gpt_params(backend="xla"):
    """The JAX model of ``backend`` and weights from the xla model's init
    (the ring's needs a mesh context)."""
    init = jgpt.GptLM(jgpt.GptConfig(**SMALL)).init
    model = jgpt.GptLM(jgpt.GptConfig(**SMALL, attention_backend=backend))
    return model, jax.device_get(jax.jit(init)(
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


@pytest.mark.parametrize("axis", ["model", "seq", "seq_model"])
def test_gpt_data2_beside_model_or_seq_matches_jax(axis):
    """gpt_mini on data=2 x model=2 (Megatron's split, each row its own
    shards), on data=2 x seq=2 (the ring, each row its own ring) and on
    data=2 x seq=2 x model=2 (each row's heads-sharded ring),
    three SGD steps against the JAX bundle on the same mesh (SGD: the
    parameters show the gradients; Adam's first steps divide
    near-zero moments)."""
    ring = axis != "model"
    backend = "ring" if ring else "xla"
    sizes = {a: 2 for a in axis.split("_")}
    n = 2 * 2 ** len(sizes)
    jmodel, params = _gpt_params(backend)
    jm = jmesh.create_mesh(data=2, devices=jax.devices()[:n], **sizes)
    tm = tmesh.create_mesh(data=2, devices=[CPU] * n, **sizes)
    cfg = tgpt.GptConfig(**SMALL, attention_backend=(
        backend if ring else "pallas"), fused_ln=True)
    tmodel = tgpt.GptLM(cfg, device="cpu", param_dtype=torch.float32,
                        mesh=tm)
    tmodel.load_state_dict(tgpt.params_from_jax(params))
    state = TrainState.create(tmodel, topt.make_optimizer("sgd", 0.5),
                              params_to_tree=tgpt.params_to_jax,
                              params_from_tree=tgpt.params_from_jax)
    with jamesh(jm):
        js = JState.create(lambda p, t: jmodel.apply({"params": p}, t),
                           params, optax.sgd(0.5))
        sharded = "model" in sizes
        js = (jsh.shard_state(jm, js, jgpt.gpt_sharding_rules())
              if sharded else jsh.replicate_state(jm, js))
        jstep = jsync.build_sync_train_step(jm, _jax_gpt_loss(jmodel),
                                            donate=False)
        if sharded:
            tsh.shard_state(tm, state, tgpt.gpt_sharding_rules())
            assert len(tsh.shards(state.rows[0].layers[0].qkv,
                                  "kernel")) == 2
        else:
            tsh.replicate_state(tm, state)
        assert state.rows[0].layers[0].mesh.shape["data"] == 1
        step = tsync.build_sync_train_step(_gpt_loss)
        for i in range(3):
            tokens = tgpt.synthetic_lm_batch(40 + i, 8, 16,
                                             tgpt.GptConfig(**SMALL))["tokens"]
            js, jmet = jstep(js, jax.device_put(
                tokens, jmesh.batch_sharding(jm)))
            state, met = step(state, tokens)
            np.testing.assert_allclose(float(met["loss"]),
                                       float(jmet["loss"]), **GPT_TOL)
            _assert_rows_equal(state)
    got = checkpoint_tree(state)["params"]
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), **GPT_TOL), got,
        jax.device_get(js.params))


# ----------------------------------------------------------------- FSDP


def test_fsdp_over_four_local_positions_matches_jax():
    """Each position's slice has the shape and values of JAX's
    ``addressable_shards`` on the same data=4 mesh; three Adam steps later
    the parameters (gathered) match JAX's, and the positions' replicated
    leaves stay bit-equal."""
    jm = jmesh.create_mesh(data=4, devices=jax.devices()[:4])
    model, params = _mlp_params()
    js = jsh.fsdp_state(jm, JState.create(
        lambda p, x: model.apply({"params": p}, x), params,
        optax.adam(1e-3)), None, min_size=1024)
    jstep = jsync.build_sync_train_step(jm, _jax_mlp_loss(js), donate=False,
                                        log_grad_norm=True)
    state = tsh.fsdp_state(tmesh.create_mesh(data=4, devices=[CPU] * 4),
                           _port_mlp(topt.make_optimizer("adam", 1e-3)),
                           min_size=1024)
    rows = tsh.row_models(state)
    positions = [d.id for d in jm.devices.flatten()]
    leaf = js.params["hid"]["kernel"]
    assert not leaf.sharding.is_fully_replicated
    for shard in leaf.addressable_shards:
        got = rows[positions.index(shard.device.id)].hid.kernel
        assert tuple(got.shape) == shard.data.shape
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(shard.data))
    # The small leaves stay replicated, as JAX's min_size keeps them.
    assert js.params["sm"]["bias"].sharding.is_fully_replicated
    assert getattr(state.model.sm.bias, "fsdp_info", None) is None
    step = tsync.build_sync_train_step(_port_mlp_loss, log_grad_norm=True)
    sharding = jmesh.data_sharded(jm)
    for b in _mlp_batches(3, seed=2):
        js, jmet = jstep(js, tuple(jax.device_put(a, sharding) for a in b))
        state, met = step(state, b)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_TOL
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
        _assert_rows_equal(state)
    _assert_tree_close(checkpoint_tree(state)["params"], js.params,
                       PARAM_TOL)


# ---------------------------------------------------------------- async


def test_async_four_replicas_on_their_positions_match_jax():
    """R = 4 replicas, two devices of two (a stack and a template a
    device), against JAX's four-replica local step and merge."""
    jm = jmesh.create_mesh(data=4, devices=jax.devices()[:4])
    jstate = _jax_mlp_state(jm, optax.sgd(0.1))
    jstep, jastate = jasync.build_async_train_step(
        jm, _jax_mlp_loss(jstate), jstate, sync_period=2)
    devices = [torch.device("cpu", i // 2) for i in range(4)]
    step, astate = tasync.build_async_train_step(
        _port_mlp_loss, _port_mlp(topt.make_optimizer("sgd", 0.1)),
        num_replicas=4, sync_period=2, devices=devices)
    assert len(astate.stacks) == 2
    assert astate.replica_model(2) is not astate.replica_model(1)
    sharding = jmesh.data_sharded(jm)
    for b in _mlp_batches(5, seed=3):
        jastate, jmet = jstep(jastate, tuple(jax.device_put(a, sharding)
                                             for a in b))
        astate, met = step(astate, b)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_TOL
    assert astate.global_step == int(jastate.global_step) == 1 + 5 * 4
    want = jax.device_get(jastate.params)
    for r in range(4):
        got = tmlp.params_to_jax(astate.views(r))
        _assert_tree_close(got, jax.tree.map(lambda a: a[r], want),
                           PARAM_TOL)
    _assert_tree_close(tmlp.params_to_jax(tasync.merge_params(astate)),
                       jax.device_get(jasync.merge_params(jastate)),
                       PARAM_TOL)


# ------------------------------------------------------------ BatchNorm


def test_batchnorm_statistics_span_the_positions():
    """ResNet-20 on data=4: the statistics span every position's rows,
    so the step equals the one-row step on the whole batch bit for bit,
    the rows' running statistics stay equal, and the loss and statistics
    match JAX's stateful step on a data=4 mesh."""
    from distributed_tensorflow_tpu.models import resnet as jresnet
    from distributed_tensorflow_tpu_torch.models import registry as treg
    from distributed_tensorflow_tpu_torch.models import resnet as tresnet
    train = jresnet.ResNet20(use_running_average=False)
    v = jax.jit(train.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))

    def jloss(p, stats, batch):
        images, labels = batch
        logits, mutated = train.apply({"params": p, "batch_stats": stats},
                                      images, mutable=["batch_stats"])
        return jmlp.cross_entropy_loss(logits, labels), (
            {"accuracy": jmlp.accuracy(logits, labels)},
            mutated["batch_stats"])
    jm = jmesh.create_mesh(data=4, devices=jax.devices()[:4])
    js = JState.create(None, v["params"], optax.sgd(0.01),
                       model_state=v["batch_stats"])
    js = js.replace(params=replicate_tree(jm, js.params),
                    opt_state=replicate_tree(jm, js.opt_state),
                    model_state=replicate_tree(jm, js.model_state),
                    global_step=replicate_tree(jm, js.global_step))
    jstep = jsync.build_stateful_sync_train_step(jm, jloss, donate=False)

    def port():
        b = treg.build_resnet20(0.01, device="cpu",
                                tx=topt.make_optimizer("sgd", 0.01))
        b.state.model.load_state_dict(tresnet.params_from_jax(
            jax.device_get(v["params"]), jax.device_get(v["batch_stats"])))
        return b
    rows, one = port(), port()
    tsh.replicate_state(tmesh.create_mesh(data=4, devices=[CPU] * 4),
                        rows.state)
    step = tsync.build_stateful_sync_train_step(rows.stateful_loss_fn)
    rng = np.random.default_rng(4)
    batch = (rng.random((8, 32, 32, 3), dtype=np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)])
    a_state, a = step(rows.state, batch)
    b_state, b = step(one.state, batch)
    js, jmet = jstep(js, tuple(jax.device_put(x, jmesh.data_sharded(jm))
                               for x in batch))
    assert float(a["loss"]) == float(b["loss"])
    for (n, p), q in zip(a_state.model.named_parameters(),
                         b_state.model.parameters()):
        assert torch.equal(p, q), n
    _assert_rows_equal(a_state)
    assert abs(float(a["loss"]) - float(jmet["loss"])) <= 1e-5
    got = tresnet.params_from_jax(jax.device_get(js.params),
                                  jax.device_get(js.model_state))
    for name, t in a_state.model.state_dict().items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(t.numpy(), got[name].numpy(),
                                       atol=1e-5, err_msg=name)
