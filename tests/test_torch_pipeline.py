"""The port's pipeline (distributed_tensorflow_tpu_torch/parallel/pipeline.py,
models/gpt.PipelinedGptLM, models/registry.build_gpt_pipeline, train.py
--pipeline_parallel) held to the JAX package's own cases:
tests/test_pipeline.py (GPipe and 1F1B on a toy stage), test_gpt_pipeline.py
(the GPT's GPipe apply, split and merge, the CLI, generate from a pipelined
checkpoint) and test_interleaved_pipeline.py (the interleaved schedule and
step).  The JAX side runs as its tests run it: jitted, on the data=2 x
pipe=4 (or data=4 x pipe=2) mesh of the 8 fake CPU devices of
tests/conftest.py; the port on a single-process data=1 x pipe mesh of
[cpu] * pipe with the same global batch (both losses are the mean over
it).  Tolerances are the JAX tests' (rtol 1e-5 to 1e-4, atol 1e-5 to
1e-6); the GPT cases run in fp32 with the attention's and LayerNorm's
plain versions on the port's side and xla attention on JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.models import registry as jreg
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import pipeline as jpp
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.training.state import (
    TrainState as JTrainState)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import pipeline as tpp
from distributed_tensorflow_tpu_torch.parallel.sync import (
    build_sync_train_step)
from distributed_tensorflow_tpu_torch.tools.checkpoint_io import (
    restore_raw, save_raw)
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, load_checkpoint_tree)

CPU = torch.device("cpu")
N_PIPE = 4
DIM = 8
SEQ = 16
SMALL = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=2,
             intermediate_size=64, max_position=64, dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(pipe=N_PIPE):
    return tmesh.create_mesh(data=1, pipe=pipe, devices=[CPU] * pipe)


# ------------------------------------------------ the toy stage (test_pipeline)


def jstage(w, x):
    return x + jnp.tanh(x @ w)


def tstage(w, x):
    return x + torch.tanh(x @ w)


def stacked(seed=0, n=N_PIPE):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, DIM, DIM)) * 0.3).astype(np.float32)


def sequential(w, x):
    for s in range(w.shape[0]):
        x = jstage(w[s], x)
    return x


def _data(seed, rows):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, DIM)).astype(np.float32),
            rng.standard_normal((rows, DIM)).astype(np.float32))


class Toy(torch.nn.Module):
    """A pipelined model of toy stages: one weight a chunk, on its pipe
    device, no embedding or head."""

    def __init__(self, mesh, w):
        super().__init__()
        devs = mesh.pipe_devices()
        self.stages = torch.nn.ParameterList(
            torch.nn.Parameter(torch.tensor(w[c]).to(devs[c % len(devs)]))
            for c in range(len(w)))
        self.embed = self.head = None


def _toy_state(mesh, w, lr=0.05):
    return TrainState.create(Toy(mesh, w), topt.make_optimizer("sgd", lr))


def _mse_head(head, y, micro_batch):
    loss = torch.mean((y - torch.as_tensor(micro_batch[1])) ** 2)
    return loss, {"accuracy": -loss}


def _jax_pipe_out(w, x, n_micro):
    mesh = jmesh.create_mesh(data=2, pipe=N_PIPE)
    fn = jpp.make_pipeline_fn(mesh, jstage, n_micro=n_micro)
    return np.asarray(jax.jit(fn)(
        jpp.shard_stacked_params(mesh, jnp.asarray(w)),
        jax.device_put(jnp.asarray(x), jmesh.data_sharded(mesh))))


@pytest.mark.parametrize("rows,n_micro", [(8, 4), (12, 2)])
def test_pipeline_forward_matches_jax(rows, n_micro):
    # (8, 4): test_pipeline_forward_matches_sequential; (12, 2):
    # test_pipeline_forward_uneven_micro (n_micro != n_pipe: the bubble).
    # JAX runs n_micro per data shard (data=2), the port on the whole
    # batch: the same rows through the same stages.
    w = stacked(seed=3)
    x, _ = _data(4, rows)
    fn = tpp.make_pipeline_fn(_mesh(), tstage, n_micro=n_micro)
    with torch.no_grad():
        out = fn([torch.tensor(ws) for ws in w], torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), _jax_pipe_out(w, x, n_micro),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(sequential(w, x)),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_sequential():
    w = stacked(seed=5)
    x, _ = _data(6, 8)
    fn = tpp.make_pipeline_fn(_mesh(), tstage, n_micro=4)
    wt = torch.tensor(w, requires_grad=True)
    fn(wt, torch.tensor(x)).sum().backward()
    g_ref = jax.grad(lambda w_: sequential(w_, x).sum())(jnp.asarray(w))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-5)


def _gpipe_step(mesh, stage_fn, loss_from_output, *, n_micro):
    """JAX's ``build_pipeline_train_step`` as the port composes it: the
    plain sync step over a loss whose forward runs the GPipe schedule
    (``registry.build_gpt_pipeline``'s GPipe path)."""
    fwd = tpp.make_pipeline_fn(mesh, stage_fn, n_micro=n_micro)

    def loss_fn(model, batch):
        return loss_from_output(fwd(model.stages, batch[0]), batch)

    return build_sync_train_step(loss_fn)


def test_pipeline_train_step():
    w = stacked(seed=7)
    x, y = _data(8, 8)

    def loss_from_output(out, batch):
        loss = torch.mean((out - torch.as_tensor(batch[1])) ** 2)
        return loss, {"accuracy": -loss}

    state = _toy_state(_mesh(), w)
    step = _gpipe_step(_mesh(), tstage, loss_from_output, n_micro=4)
    batch = (torch.tensor(x), torch.tensor(y))
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9
    assert int(state.global_step) == 6
    # Stage parameters stay one a stage, each on its pipe device.
    assert len(state.model.stages) == N_PIPE


@pytest.mark.parametrize("P_,M_", [(1, 1), (2, 4), (4, 4), (4, 2), (4, 8),
                                   (3, 5)])
def test_1f1b_schedule_is_jax_and_keeps_its_invariants(P_, M_):
    F, B = tpp.schedule_1f1b(P_, M_)
    assert (F, B) == jpp.schedule_1f1b(P_, M_)
    fwd_done = [[-1] * M_ for _ in range(P_)]
    bwd_done = [[-1] * M_ for _ in range(P_)]
    inflight = [0] * P_
    for t, (f_row, b_row) in enumerate(zip(F, B)):
        for s in range(P_):
            m = f_row[s]
            if m >= 0:
                assert m == 0 or fwd_done[s][m - 1] >= 0
                if s > 0:
                    assert 0 <= fwd_done[s - 1][m] < t
                fwd_done[s][m] = t
                inflight[s] += 1
                assert inflight[s] <= P_ - s
        for s in range(P_):
            m = b_row[s]
            if m >= 0:
                if s == P_ - 1:
                    assert 0 <= fwd_done[s][m] <= t
                else:
                    assert 0 <= bwd_done[s + 1][m] < t
                bwd_done[s][m] = t
                inflight[s] -= 1
    assert all(v >= 0 for row in fwd_done for v in row)
    assert all(v >= 0 for row in bwd_done for v in row)
    assert len(F) <= 2 * (M_ + P_ - 1) + P_


def _jax_1f1b(w, x, y, n_micro):
    mesh = jmesh.create_mesh(data=2, pipe=N_PIPE)

    def head(hp, yy, micro):
        loss = jnp.mean((yy - micro[1]) ** 2)
        return loss, {"accuracy": -loss}
    st = JTrainState.create(lambda p, x_: None,
                            {"embed": {}, "stages": jnp.asarray(w),
                             "head": {}}, optax.sgd(0.05))
    st = st.replace(
        params={"embed": {}, "head": {},
                "stages": jpp.shard_stacked_params(mesh, jnp.asarray(w))},
        opt_state=jax.tree.map(
            lambda a: jax.device_put(a, jmesh.replicated(mesh)),
            st.opt_state))
    step = jpp.build_1f1b_pipeline_train_step(mesh, jstage, head,
                                              n_micro=n_micro, donate=False)
    sh = jmesh.data_sharded(mesh)
    new, metrics = step(st, (jax.device_put(jnp.asarray(x), sh),
                             jax.device_put(jnp.asarray(y), sh)))
    return float(metrics["loss"]), np.asarray(new.params["stages"])


def test_1f1b_grads_match_sequential_and_jax():
    """One 1F1B step == one full-batch SGD step on the sequential model,
    and == the JAX 1F1B step (JAX: 4 micro-batches a data shard of 8
    rows; the port: 8 micro-batches of the 16-row batch, the same
    micro-batch rows)."""
    w = stacked(seed=11)
    x, y = _data(12, 16)
    state = _toy_state(_mesh(), w)
    step = tpp.build_1f1b_pipeline_train_step(_mesh(), tstage, _mse_head,
                                              n_micro=8)
    state, metrics = step(state, (torch.tensor(x), torch.tensor(y)))
    got = np.stack([p.detach().numpy() for p in state.model.stages])

    ref_l, ref_g = jax.value_and_grad(
        lambda w_: jnp.mean((sequential(w_, x) - y) ** 2))(jnp.asarray(w))
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_l),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, w - 0.05 * np.asarray(ref_g),
                               rtol=1e-4, atol=1e-5)
    j_loss, j_w = _jax_1f1b(w, x, y, n_micro=4)
    np.testing.assert_allclose(float(metrics["loss"]), j_loss, rtol=1e-5)
    np.testing.assert_allclose(got, j_w, rtol=1e-4, atol=1e-5)


def test_1f1b_matches_gpipe_step():
    w = stacked(seed=13)
    x, y = _data(14, 8)
    batch = (torch.tensor(x), torch.tensor(y))

    def loss_from_output(out, b):
        return _mse_head(None, out, b)

    gp = _toy_state(_mesh(), w)
    gp, gp_m = _gpipe_step(_mesh(), tstage, loss_from_output,
                           n_micro=2)(gp, batch)
    f = _toy_state(_mesh(), w)
    f, f_m = tpp.build_1f1b_pipeline_train_step(
        _mesh(), tstage, _mse_head, n_micro=2)(f, batch)
    np.testing.assert_allclose(float(f_m["loss"]), float(gp_m["loss"]),
                               rtol=1e-5)
    for a, b in zip(f.model.stages, gp.model.stages):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_1f1b_trains():
    w = stacked(seed=15)
    x, y = _data(16, 16)
    state = _toy_state(_mesh(), w)
    step = tpp.build_1f1b_pipeline_train_step(_mesh(), tstage, _mse_head,
                                              n_micro=8)
    losses = []
    for _ in range(5):
        state, metrics = step(state, (torch.tensor(x), torch.tensor(y)))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9
    assert int(state.global_step) == 6


def test_1f1b_memory_bound_vs_gpipe():
    """At P=4, M=16 the schedule's stash peaks at P - s a stage, and the
    step holds at most the schedule's in-flight inputs at once (GPipe
    would hold all 16 micro-batches' activations)."""
    P_, M_ = 4, 16
    F, B = tpp.schedule_1f1b(P_, M_)
    inflight, peak = [0] * P_, [0] * P_
    for f_row, b_row in zip(F, B):
        for s in range(P_):
            if f_row[s] >= 0:
                inflight[s] += 1
                peak[s] = max(peak[s], inflight[s])
        for s in range(P_):
            if b_row[s] >= 0:
                inflight[s] -= 1
    assert peak == [4, 3, 2, 1]
    assert len(F) <= 2 * M_ + 2 * P_
    x, y = _data(17, 32)
    state = _toy_state(_mesh(), stacked(seed=17))
    step = tpp.build_1f1b_pipeline_train_step(_mesh(), tstage, _mse_head,
                                              n_micro=M_)
    step(state, (torch.tensor(x), torch.tensor(y)))
    assert step.peak_stash <= sum(peak) < M_


# ------------------------------------------ the interleaved schedule and step


@pytest.mark.parametrize("P,M,v", [(2, 4, 2), (4, 8, 2), (2, 8, 4)])
def test_interleaved_schedule_is_jax_and_valid(P, M, v):
    F, B = tpp.schedule_interleaved(P, M, v)
    assert (F, B) == jpp.schedule_interleaved(P, M, v)
    V = P * v
    ft, bt = {}, {}
    for t, row in enumerate(F):
        for s, slot in enumerate(row):
            if slot:
                c, m = slot
                assert c % P == s and slot not in ft
                ft[slot] = t
                if c > 0:
                    assert ft[(c - 1, m)] <= t - 1
    for t, row in enumerate(B):
        for s, slot in enumerate(row):
            if slot:
                c, m = slot
                assert c % P == s and slot not in bt
                bt[slot] = t
                if c == V - 1:
                    assert ft[slot] <= t
                else:
                    assert bt[(c + 1, m)] <= t - 1
    assert len(ft) == V * M and len(bt) == V * M


def test_interleaved_schedule_rejects_indivisible_microbatches():
    with pytest.raises(ValueError, match="divisible"):
        tpp.schedule_interleaved(4, 6, 2)


def test_interleaved_schedule_models_smaller_bubble_than_1f1b():
    P, M = 4, 8
    assert (len(tpp.schedule_interleaved(P, M, 2)[0]) / 2
            < len(tpp.schedule_1f1b(P, M)[0]))


def test_interleaved_step_matches_autodiff_ground_truth():
    P_pipe, v, M = 2, 2, 4
    V = P_pipe * v
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((V, DIM, DIM)) * 0.3).astype(np.float32)
    x = rng.standard_normal((4 * M * 2, DIM)).astype(np.float32)
    y = rng.standard_normal((4 * M * 2, DIM)).astype(np.float32)
    gt_loss, gt_grad = jax.value_and_grad(
        lambda w_: jnp.mean((sequential(w_, x) - y) ** 2))(jnp.asarray(w))
    mesh = _mesh(P_pipe)
    state = _toy_state(mesh, w)
    step = tpp.build_interleaved_1f1b_train_step(
        mesh, tstage, lambda h, yy, mb: (torch.mean(
            (yy - torch.as_tensor(mb[1])) ** 2), {}), n_micro=M,
        n_virtual=v)
    state, metrics = step(state, (torch.tensor(x), torch.tensor(y)))
    np.testing.assert_allclose(float(metrics["loss"]), float(gt_loss),
                               rtol=1e-5)
    moved = np.stack([p.detach().numpy() for p in state.model.stages])
    np.testing.assert_allclose(moved, w - 0.05 * np.asarray(gt_grad),
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- the pipelined GPT


def _jax_gpt(seed=0):
    cfg = jgpt.GptConfig(**SMALL)
    model = jgpt.GptLM(cfg)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, SEQ), jnp.int32))["params"])
    return cfg, model, params


def _tokens(seed, rows):
    cfg = tgpt.GptConfig(**SMALL)
    return tgpt.synthetic_lm_batch(seed, rows, SEQ, cfg)["tokens"]


def _port_bundle(pipe, schedule="gpipe", params=None, n_micro=2, v=2,
                 tx=None, remat=False):
    mesh = _mesh(pipe)
    width = {k: v_ for k, v_ in SMALL.items() if k != "dtype"}
    b = treg.build_gpt_pipeline(
        0.05, mesh, seq_len=SEQ, n_micro=n_micro, dtype="float32",
        tx=tx or topt.make_optimizer("sgd", 0.05), schedule=schedule,
        virtual_stages=v, width=width, remat=remat)
    if params is not None:
        m = b.state.model
        m.load_state_dict(m.params_from_tree(
            jgpt.split_params_for_pipeline(
                params, pipe * (v if schedule == "interleaved" else 1),
                SMALL["num_layers"]) if schedule != "interleaved" else
            _interleaved_tree(params, pipe, v)))
    return mesh, b, b.place_state(mesh, b.state)


def _interleaved_tree(params, pipe, v):
    tree = jgpt.split_params_for_pipeline(params, pipe * v,
                                          SMALL["num_layers"])
    tree["stages"] = jax.tree.map(
        lambda a: np.asarray(a).reshape((v, pipe) + a.shape[1:]),
        tree["stages"])
    return tree


@pytest.mark.parametrize("pipe,rows,n_micro,remat", [(4, 8, 2, False),
                                                     (2, 16, 4, True)])
def test_pipelined_gpt_forward_matches_jax_plain(pipe, rows, n_micro, remat):
    # (4, 8, 2): test_pipelined_forward_matches_plain; (2, 16, 4) with
    # remat: test_pipelined_two_stage_multi_layer (2 layers a stage).
    _, model, params = _jax_gpt(seed=pipe - 2)
    tokens = _tokens(1, rows)
    want = np.asarray(jax.jit(model.apply)({"params": params},
                                           jnp.asarray(tokens)))
    mesh, b, state = _port_bundle(pipe, params=params, n_micro=n_micro,
                                  remat=remat)
    apply = tgpt.make_pipelined_gpt_apply(state.model.cfg, mesh,
                                          n_micro=n_micro, remat=remat)
    with torch.no_grad():
        got = apply(state.model, torch.as_tensor(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The schedule-agnostic forward (eval, interleaved) is the same.
    with torch.no_grad():
        plain = state.model(torch.as_tensor(tokens).long())
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


def test_split_rejects_indivisible_layers():
    _, _, params = _jax_gpt()
    with pytest.raises(ValueError, match="divisible"):
        tgpt.split_params_for_pipeline(params, 3, SMALL["num_layers"])


def test_split_is_jax_and_merge_is_its_inverse():
    _, _, params = _jax_gpt()
    port = tgpt.split_params_for_pipeline(params, 2, SMALL["num_layers"])
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)),
        jgpt.split_params_for_pipeline(params, 2, SMALL["num_layers"]),
        port)
    merged = tgpt.merge_pipeline_params(port, SMALL["num_layers"])
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), params, merged)


def test_pipelined_gpt_rejects_indivisible_layers():
    """Every chunk holds the same number of blocks: 4 layers fit neither
    3 positions nor 2 positions of 3 virtual stages."""
    cfg = tgpt.GptConfig(**SMALL)
    plain = tgpt.GptLM(cfg, device=CPU, seed=0)
    with pytest.raises(ValueError, match="divisible"):
        tgpt.PipelinedGptLM.from_gpt(plain, [CPU] * 3)
    with pytest.raises(ValueError, match="divisible"):
        tgpt.PipelinedGptLM.from_gpt(plain, [CPU] * 2, n_virtual=3)


def test_interleaved_tree_keeps_chunk_i_p_plus_s_at_i_s():
    """Megatron's round robin (JAX gpt.py's interleaved layout): global
    chunk ``i * n_pipe + s`` is position ``s``'s ``i``-th chunk and sits
    at ``[i, s]`` of the checkpoint's stages; the tree goes back to the
    same modules."""
    P_, v = 2, 2
    cfg = tgpt.GptConfig(**SMALL)
    plain = tgpt.GptLM(cfg, device=CPU, seed=3)
    want = tgpt.params_to_jax(
        {n: p.detach().clone() for n, p in plain.named_parameters()})
    model = tgpt.PipelinedGptLM.from_gpt(plain, [CPU] * P_, v)
    named = dict(model.named_parameters())
    tree = model.params_to_tree(named)
    for i in range(v):
        for s_ in range(P_):
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(
                np.asarray(a)[i, s_, 0], np.asarray(b)),
                tree["stages"], want[f"layer{i * P_ + s_}"])
    back = model.params_from_tree(tree)
    assert set(back) == set(named)
    for n, p in named.items():
        np.testing.assert_array_equal(back[n].numpy(), p.detach().numpy())


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_gpt_pipeline_step_matches_jax(schedule):
    """One SGD step of the GPT pipeline from the same weights and batch:
    the loss and the updated stage-stacked tree against the JAX bundle's
    step on data=4 x pipe=2 (JAX: 2 micro-batches a data shard; the port:
    8 on the whole batch, the same micro-batch rows), through the
    port's checkpoint tree (JAX's layout, interleaved [v, P, ...] too)."""
    pipe, v = 2, 2
    jmesh_ = jmesh.create_mesh(data=4, pipe=pipe)
    kw = dict(seq_len=SEQ, n_micro=2, dtype="float32", tx=optax.sgd(0.05))
    jb = jreg.build_gpt_pipeline(0.05, jmesh_, schedule=schedule,
                                 virtual_stages=v, **kw)
    # The JAX bundle is mini()-wide; the port's takes the same width.
    jparams = jax.device_get(jb.state.params)
    tokens = _tokens(2, 8)
    jstate = jb.place_state(jmesh_, jb.state)
    batch = jax.device_put({"tokens": jnp.asarray(tokens)},
                           jmesh.batch_sharding(jmesh_))
    jstep = (jb.train_step_builder(jmesh_) if jb.train_step_builder
             else jsync.build_sync_train_step(jmesh_, jb.loss_fn,
                                              donate=False))
    jstate, jm = jstep(jstate, batch)

    mesh = _mesh(pipe)
    b = treg.build_gpt_pipeline(0.05, mesh, seq_len=SEQ, n_micro=8,
                                dtype="float32",
                                tx=topt.make_optimizer("sgd", 0.05),
                                schedule=schedule, virtual_stages=v)
    state = b.place_state(mesh, b.state)
    state.model.load_state_dict(state.model.params_from_tree(jparams))
    step = (b.train_step_builder(mesh) if b.train_step_builder
            else build_sync_train_step(b.loss_fn))
    state, m = step(state, {"tokens": tokens})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    got = checkpoint_tree(state)["params"]
    jax.tree.map(lambda a, b_: np.testing.assert_allclose(
        np.asarray(b_), np.asarray(a), rtol=1e-4, atol=1e-5),
        jax.device_get(jstate.params), got)


def test_gpt_interleaved_matches_gpipe_one_step():
    common = dict(n_micro=2, v=2)
    _, g_b, g_state = _port_bundle(2, "gpipe", **common)
    _, i_b, i_state = _port_bundle(2, "interleaved", **common)
    batch = g_b.load_datasets(None).train.next_batch(8)
    g_state, g_m = build_sync_train_step(g_b.loss_fn)(g_state, batch)
    i_state, i_m = i_b.train_step_builder(_mesh(2))(i_state, batch)
    np.testing.assert_allclose(float(i_m["loss"]), float(g_m["loss"]),
                               rtol=1e-5)
    gl = checkpoint_tree(g_state)["params"]["stages"]
    il = checkpoint_tree(i_state)["params"]["stages"]
    for a, b in zip(jax.tree.leaves(gl), jax.tree.leaves(il)):
        np.testing.assert_allclose(
            b.reshape((-1,) + b.shape[3:]), a.reshape((-1,) + a.shape[2:]),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved"])
def test_pipelined_checkpoints_cross_the_packages(tmp_path, schedule):
    """A port pipeline checkpoint (save_raw) holds JAX's stage-stacked
    tree and restores into a JAX pipeline state with equal logits; the
    JAX bundle's tree restores into the port's state."""
    pipe, v = 2, 2
    _, b, state = _port_bundle(pipe, schedule, v=v)
    tree = checkpoint_tree(state)
    save_raw(str(tmp_path / "checkpoints"), 1, tree)
    restored = restore_raw(str(tmp_path))[0]
    jb = jreg.build_gpt_pipeline(0.05, jmesh.create_mesh(data=4, pipe=pipe),
                                 seq_len=SEQ, n_micro=2, dtype="float32",
                                 schedule=schedule, virtual_stages=v)
    # The JAX tree has the JAX bundle's widths (mini()); check the
    # layout against it on the stage leaves' shapes.
    jl = jax.tree.map(lambda a: a.shape[:3 if schedule == "interleaved"
                                        else 2], jb.state.params["stages"])
    pl = jax.tree.map(lambda a: a.shape[:3 if schedule == "interleaved"
                                        else 2], restored["params"]["stages"])
    assert jl == pl
    # Port -> port through the raw tree; JAX's tree -> port.
    _, b2, state2 = _port_bundle(pipe, schedule, v=v)
    load_checkpoint_tree(state2, restored)
    tokens = torch.as_tensor(_tokens(3, 4)).long()
    with torch.no_grad():
        np.testing.assert_array_equal(state.model(tokens).numpy(),
                                      state2.model(tokens).numpy())
    merged = tgpt.merge_pipeline_params(restored["params"], 4,
                                        v if schedule == "interleaved" else 1)
    plain = tgpt.GptLM(tgpt.GptConfig(**SMALL), device="cpu")
    plain.load_state_dict(tgpt.params_from_jax(merged))
    with torch.no_grad():
        np.testing.assert_allclose(plain(tokens).numpy(),
                                   state.model(tokens).numpy(), atol=1e-6)
    jtree = _interleaved_tree(jax.device_get(_jax_gpt()[2]), pipe, v) \
        if schedule == "interleaved" else jgpt.split_params_for_pipeline(
            jax.device_get(_jax_gpt()[2]), pipe, 4)
    state2.model.load_state_dict(state2.model.params_from_tree(jtree))
    _, jmodel, jparams = _jax_gpt()
    with torch.no_grad():
        np.testing.assert_allclose(
            state2.model(tokens).numpy(),
            np.asarray(jmodel.apply({"params": jparams},
                                    jnp.asarray(tokens.numpy()))),
            rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- CLI


@pytest.fixture
def standalone(monkeypatch):
    from distributed_tensorflow_tpu_torch.cluster.server import Server
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def _cli(tmp_path, *flags):
    return ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--data_dir=/nonexistent",
        "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
        "--device=cpu", "--model=gpt_mini", "--pipeline_parallel=2",
        "--pipeline_microbatches=2", "--bert_seq_len=16", "--batch_size=16",
        "--log_every=1", f"--logdir={tmp_path}/logdir", *flags])


def test_pipeline_cli_e2e(tmp_path, standalone, capsys):
    result = _cli(tmp_path, "--sync_replicas=true", "--train_steps=3",
                  "--log_sharding")
    assert result.final_global_step >= 3
    assert result.last_loss is not None and np.isfinite(result.last_loss)
    assert result.test_accuracy is not None
    assert "mesh dp-1-pp2-mb1 (pipe=2, seq=1, model=1)" in \
        capsys.readouterr().out


def test_pipeline_cli_e2e_1f1b(tmp_path, standalone):
    """1F1B trains through the CLI and checkpoints in GPipe's layout: a
    GPipe-scheduled resume consumes it; a bogus schedule raises."""
    result = _cli(tmp_path, "--sync_replicas=true",
                  "--pipeline_schedule=1f1b", "--train_steps=3")
    assert result.final_global_step >= 3
    assert np.isfinite(result.last_loss)
    assert result.test_accuracy is not None
    result2 = _cli(tmp_path, "--sync_replicas=true",
                   "--pipeline_schedule=gpipe", "--train_steps=6")
    assert result2.final_global_step >= 6
    assert result2.local_steps <= 4     # resumed, not from scratch
    with pytest.raises(ValueError, match="pipeline_schedule"):
        _cli(tmp_path, "--sync_replicas=true",
             "--pipeline_schedule=bogus", "--train_steps=3")


def test_generate_and_eval_from_pipelined_checkpoint(tmp_path, standalone,
                                                     capsys):
    """--mode=generate merges a --pipeline_parallel run's stage-stacked
    checkpoint into the plain decode layout; --mode=eval restores it."""
    _cli(tmp_path, "--sync_replicas=true", "--train_steps=3",
         "--save_interval_steps=1")
    capsys.readouterr()
    out = _cli(tmp_path, "--mode=eval")
    assert out["global_step"] >= 3
    _cli(tmp_path, "--mode=generate", "--gen_tokens=4")
    text = capsys.readouterr().out
    step = int([x for x in text.splitlines()
                if x.startswith("Restored global step:")][0].split(":")[1])
    assert step >= 3 and "Generated tokens:" in text


def test_interleaved_cli_e2e_resume_and_generate(tmp_path, standalone,
                                                 capsys):
    args = ["--sync_replicas=true", "--pipeline_schedule=interleaved",
            "--pipeline_virtual_stages=2", "--batch_size=8",
            "--log_every=2", "--save_interval_steps=2"]
    result = _cli(tmp_path, *args, "--train_steps=4")
    assert result.final_global_step >= 4
    assert (tmp_path / "logdir" / "gpt_mini_pp2x2").exists()
    assert _cli(tmp_path, *args, "--train_steps=6").final_global_step >= 6
    capsys.readouterr()
    _cli(tmp_path, *args, "--mode=generate", "--gen_tokens=4")
    assert "Generated tokens:" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (("--model=mnist_mlp",), "gpt_mini"),
    (("--steps_per_call=4",), "exclusive"),
    (("--pipeline_schedule=interleaved", "--pipeline_virtual_stages=1"),
     "virtual_stages"),
    (("--pipeline_schedule=interleaved", "--pipeline_microbatches=3"),
     "divisible"),
    (("--tensor_parallel=2",), "--pipeline_parallel with --tensor_parallel"),
    (("--gpt_matmul_int8",), "--gpt_matmul_int8 with --pipeline_parallel"),
    (("--bert_dropout=0.1",), "rng-free"),
    (("--fsdp",), "--fsdp is incompatible"),
])
def test_pipeline_cli_rejects_bad_combos(tmp_path, standalone, flags, match):
    with pytest.raises(ValueError, match=match):
        _cli(tmp_path, "--sync_replicas=true", *flags)
