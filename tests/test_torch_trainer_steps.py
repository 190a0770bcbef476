"""The port's reference-model pieces against the JAX package's: the
synthetic MNIST splits, the MLP, the sync steps (plain, masked, scanned,
accumulating), optax's checkpoint layout of the optimizer slots, and a
two-rank gloo all-reduce step against the one-process step.

The same numpy inputs and the same weights (``mlp.params_from_jax``) go
through both packages; the JAX steps run jitted over the 8-device CPU mesh
of ``tests/conftest.py`` with the batch sharded over ``data``, as the JAX
package's own tests run them.  Tolerances, fp32: logits and losses 1e-5
absolute, gradient norms 1e-5 relative; parameters after the steps 1e-6
(the two packages sum a gradient in different orders, ~1e-8 apart at
these widths and rates).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.data import datasets as jdata
from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.parallel.sharding import replicate_tree
from distributed_tensorflow_tpu.training import optimizers as jopt
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu_torch.data import datasets as tdata
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, load_checkpoint_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 16
LOGIT_TOL = 1e-5
PARAM_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return jmesh.data_parallel_mesh()


def jax_params(seed=0):
    model = jmlp.MnistMLP(hidden_units=HIDDEN)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 784)))
    return model, jax.device_get(params["params"])


def jax_state(mesh, tx):
    model, params = jax_params()
    apply_fn = lambda p, x: model.apply({"params": p}, x)
    state = JState.create(apply_fn, params, tx)
    state = state.replace(params=replicate_tree(mesh, state.params),
                          opt_state=replicate_tree(mesh, state.opt_state),
                          global_step=replicate_tree(mesh,
                                                     state.global_step))
    return state, apply_fn


def jax_loss_fn(apply_fn):
    def loss_fn(params, batch):
        x, y = batch
        logits = apply_fn(params, x)
        return jmlp.cross_entropy_loss(logits, y), {
            "accuracy": jmlp.accuracy(logits, y)}
    return loss_fn


def port_state(spec):
    model = tmlp.MnistMLP(HIDDEN, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(jax_params()[1]))
    return TrainState.create(model, spec,
                             params_to_tree=tmlp.params_to_jax,
                             params_from_tree=tmlp.params_from_jax)


def port_loss_fn(model, batch):
    x, y = (torch.as_tensor(np.asarray(a)) for a in batch)
    logits = model(x)
    return tmlp.cross_entropy_loss(logits, y), {
        "accuracy": tmlp.accuracy(logits, y)}


def batches(n, rows=64, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((rows, 784), dtype=np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)])
            for _ in range(n)]


def assert_params_close(port_model, jax_tree, tol=PARAM_TOL):
    got = tmlp.params_to_jax(port_model.state_dict())
    want = jax.device_get(jax_tree)
    for layer in ("hid", "sm"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(want[layer][leaf]),
                                       atol=tol, rtol=0)


# ----------------------------------------------------------------- data


def test_synthetic_mnist_splits_are_bit_equal_to_jax():
    want = jdata.read_data_sets("/nonexistent")
    got = tdata.read_data_sets("/nonexistent")
    assert got.synthetic and want.synthetic
    for name in ("train", "validation", "test"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    # The shuffled feed and the per-rank shards too.
    for _ in range(3):
        for x, y in zip(got.train.next_batch(100), want.train.next_batch(100)):
            np.testing.assert_array_equal(x, y)
    a, b = got.train.shard(1, 2), want.train.shard(1, 2)
    for x, y in zip(a.next_batch(50), b.next_batch(50)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("double_softmax", [False, True])
def test_mlp_logits_and_loss_match_jax(double_softmax):
    model, params = jax_params()
    (x, y), = batches(1)
    want_logits = model.apply({"params": params}, x)
    want_loss = jmlp.cross_entropy_loss(want_logits, y,
                                        double_softmax=double_softmax)
    port = tmlp.MnistMLP(HIDDEN, device="cpu")
    port.load_state_dict(tmlp.params_from_jax(params))
    got_logits = port(torch.from_numpy(x))
    got_loss = tmlp.cross_entropy_loss(got_logits, torch.from_numpy(y),
                                       double_softmax=double_softmax)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGIT_TOL)
    assert abs(float(got_loss.detach()) - float(want_loss)) <= LOGIT_TOL
    assert float(tmlp.accuracy(got_logits, torch.from_numpy(y))) == float(
        jmlp.accuracy(want_logits, y))
    # uint8 feed: the same normalisation as the JAX model's.
    raw = (x * 255).astype(np.uint8)
    np.testing.assert_allclose(
        port(torch.from_numpy(raw)).detach().numpy(),
        np.asarray(model.apply({"params": params}, raw)), atol=LOGIT_TOL)


def test_mlp_init_follows_the_reference_initializers():
    model = tmlp.MnistMLP(100, device="cpu", seed=3)
    for dense, std in ((model.hid, 1 / 28), (model.sm, 0.1)):
        k = dense.kernel.detach()
        assert k.abs().max() <= 2 * std
        assert abs(float(k.std()) / std - 0.88) < 0.05  # truncated at 2 sd
        assert not dense.bias.detach().any()
    same = tmlp.MnistMLP(100, device="cpu", seed=3)
    assert torch.equal(same.hid.kernel, model.hid.kernel)


# ------------------------------------------------------------------ steps


@pytest.mark.parametrize("name,lr", [("sgd", 0.1), ("adam", 1e-3)])
def test_three_sync_steps_match_jax(mesh, name, lr):
    jtx = optax.sgd(lr) if name == "sgd" else optax.adam(lr)
    jstate, apply_fn = jax_state(mesh, jtx)
    jstep = jsync.build_sync_train_step(mesh, jax_loss_fn(apply_fn),
                                        donate=False, log_grad_norm=True)
    state = port_state(topt.make_optimizer(name, lr))
    step = tsync.build_sync_train_step(port_loss_fn, log_grad_norm=True)
    sharding = jmesh.data_sharded(mesh)
    for x, y in batches(3):
        jstate, jm = jstep(jstate, (jax.device_put(x, sharding),
                                    jax.device_put(y, sharding)))
        state, m = step(state, (x, y))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOGIT_TOL
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-5)
        assert m["global_step"] == int(jm["global_step"])
    assert_params_close(state.model, jstate.params)
    # The optimizer slots are optax's, in optax's layout.
    tree = checkpoint_tree(state)
    want = jax.device_get(jstate.opt_state)
    assert jax.tree_util.tree_structure(
        jax.tree.map(np.asarray, want)) == jax.tree_util.tree_structure(
        _as_optax(tree["opt_state"], want))
    for a, b in zip(jax.tree.leaves(_as_optax(tree["opt_state"], want)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def _as_optax(port_opt_state, like):
    """The port's opt_state (lists, dicts, None) in the structure of the
    optax state ``like`` (tuples, NamedTuples, EmptyState)."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        if not like._fields:
            assert port_opt_state is None
            return like
        return type(like)(**{f: _as_optax(port_opt_state[f], getattr(like, f))
                             for f in like._fields})
    if isinstance(like, tuple):
        assert len(port_opt_state) == len(like)
        return tuple(_as_optax(a, b) for a, b in zip(port_opt_state, like))
    if isinstance(like, dict):
        return {k: _as_optax(port_opt_state[k], v) for k, v in like.items()}
    return np.asarray(port_opt_state)


@pytest.mark.parametrize("flags", [
    dict(optimizer="sgd"),
    dict(optimizer="momentum", lr_schedule="cosine", grad_clip_norm=1.0),
    dict(optimizer="nesterov", weight_decay=0.1),
    dict(optimizer="adam", warmup_steps=2),
    dict(optimizer="adamw", weight_decay=0.1, grad_clip_norm=0.5),
])
def test_optimizer_slots_round_trip_in_optax_layout(mesh, flags):
    """Every ported ``--optimizer`` writes optax's opt_state tree (the
    checkpoint layout of the JAX trainer) after two steps of the JAX
    ``make_optimizer`` and the port's, and loads it back into a fresh
    optimizer that then takes the same third step."""
    import types
    F = types.SimpleNamespace(learning_rate=0.05, train_steps=10,
                              momentum=0.9, weight_decay=0.0,
                              lr_schedule="constant", warmup_steps=0,
                              decay_steps=0, end_lr_factor=0.0,
                              grad_clip_norm=0.0)
    for k, v in flags.items():
        setattr(F, k, v)
    jstate, apply_fn = jax_state(mesh, jopt.from_flags(F))
    jstep = jsync.build_sync_train_step(mesh, jax_loss_fn(apply_fn),
                                        donate=False)
    state = port_state(topt.from_flags(F))
    step = tsync.build_sync_train_step(port_loss_fn)
    b = batches(3, seed=1)
    sharding = jmesh.data_sharded(mesh)
    for x, y in b[:2]:
        jstate, _ = jstep(jstate, (jax.device_put(x, sharding),
                                   jax.device_put(y, sharding)))
        state, _ = step(state, (x, y))
    tree = checkpoint_tree(state)
    want = jax.device_get(jstate.opt_state)
    for a, c in zip(jax.tree.leaves(_as_optax(tree["opt_state"], want)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), atol=1e-6)
    fresh = port_state(topt.from_flags(F))
    load_checkpoint_tree(fresh, tree)
    assert fresh.global_step == 3
    state, _ = step(state, b[2])
    fresh, _ = step(fresh, b[2])
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="layout|opt_state"):
        other = port_state(topt.make_optimizer(
            "adam" if flags["optimizer"] != "adam" else "sgd", 0.1))
        load_checkpoint_tree(other, tree)


def test_masked_step_drops_a_straggler_like_jax(mesh):
    """tests/test_sync_training.py:110's case: 8 replicas of one example,
    replica 3 masked out, lr 1."""
    jstate, apply_fn = jax_state(mesh, optax.sgd(1.0))
    jstep = jsync.build_masked_sync_train_step(mesh, jax_loss_fn(apply_fn))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    mask = np.ones(8, np.float32)
    mask[3] = 0.0
    sharding = jmesh.data_sharded(mesh)
    jstate, jm = jstep(jstate, (jax.device_put(x, sharding),
                                jax.device_put(y, sharding)),
                       jnp.asarray(mask))
    state = port_state(topt.make_optimizer("sgd", 1.0))
    step = tsync.build_masked_sync_train_step(port_loss_fn, 8)
    state, m = step(state, (x, y), mask)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOGIT_TOL
    assert abs(float(m["accuracy"]) - float(jm["accuracy"])) <= LOGIT_TOL
    assert_params_close(state.model, jstate.params)
    # A full mask is the plain step.
    a = port_state(topt.make_optimizer("sgd", 1.0))
    b = port_state(topt.make_optimizer("sgd", 1.0))
    a, _ = tsync.build_sync_train_step(port_loss_fn)(a, (x, y))
    b, _ = step(b, (x, y), tsync.full_mask(8))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(p, q, atol=PARAM_TOL, rtol=0)


def test_replica_masks_and_r_resolution_match_jax():
    alive = [True, False, True, True]
    members = [True, True, False, True]
    for kw in ({}, {"members": members}):
        np.testing.assert_array_equal(
            tsync.replica_mask_from_tasks(alive, 4, 2, **kw),
            jsync.replica_mask_from_tasks(alive, 4, 2, **kw))
    np.testing.assert_array_equal(
        tsync.replica_mask_from_tasks([False] * 3, 3, 1), np.ones(3))
    for r, n in ((None, 4), (2, 4), (1, 2)):
        assert tsync.resolve_replicas_to_aggregate(r, n) == \
            jsync.resolve_replicas_to_aggregate(r, n)


@pytest.mark.parametrize("kind", ["scanned", "accumulating"])
def test_scanned_and_accumulating_steps_match_jax(mesh, kind):
    K = 4
    jstate, apply_fn = jax_state(mesh, optax.sgd(0.1))
    jloss = jax_loss_fn(apply_fn)
    state = port_state(topt.make_optimizer("sgd", 0.1))
    if kind == "scanned":
        jstep = jsync.build_scanned_sync_train_step(
            mesh, jloss, num_steps=K, donate=False, log_grad_norm=True)
        step = tsync.build_scanned_sync_train_step(
            port_loss_fn, num_steps=K, log_grad_norm=True)
    else:
        jstep = jsync.build_accumulating_sync_train_step(
            mesh, jloss, accum_steps=K, donate=False, log_grad_norm=True)
        step = tsync.build_accumulating_sync_train_step(
            port_loss_fn, accum_steps=K, log_grad_norm=True)
    sharding = jmesh.stacked_batch_sharding(mesh)
    for _ in range(2):
        stacked = tsync.stack_microbatches(batches(K, rows=32))
        np.testing.assert_array_equal(
            stacked[0], jsync.stack_microbatches(
                [(a, b) for a, b in zip(*stacked)])[0])
        jstate, jm = jstep(jstate, tuple(jax.device_put(a, sharding)
                                         for a in stacked))
        state, m = step(state, stacked)
        for key in ("loss", "accuracy"):
            assert abs(float(m[key]) - float(jm[key])) <= LOGIT_TOL, key
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-5)
        assert m["global_step"] == int(jm["global_step"])
    assert_params_close(state.model, jstate.params)


# -------------------------------------------------------- two gloo ranks

_RANK = r"""
import sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch.models import mlp
from distributed_tensorflow_tpu_torch.parallel import sync
from distributed_tensorflow_tpu_torch.training.optimizers import make_optimizer
from distributed_tensorflow_tpu_torch.training.state import TrainState
rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
model = mlp.MnistMLP(16, device="cpu")
state = TrainState.create(model, make_optimizer(sys.argv[5], 0.05))
def loss_fn(m, batch):
    x, y = (torch.from_numpy(a) for a in batch)
    logits = m(x)
    return mlp.cross_entropy_loss(logits, y), {"accuracy": mlp.accuracy(logits, y)}
reduce = sync.GradientAllReduce()
step = sync.build_sync_train_step(loss_fn, all_reduce=reduce)
d = np.load(data)
losses = []
for i in range(d["x"].shape[0]):
    half = d["x"].shape[1] // 2
    rows = slice(rank * half, (rank + 1) * half)
    state, m = step(state, (d["x"][i, rows], d["y"][i, rows]))
    losses.append(float(m["loss"]))
np.savez(out, losses=np.asarray(losses),
         **{k: v.numpy() for k, v in model.state_dict().items()})
dist.destroy_process_group()
"""


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_two_rank_gloo_step_equals_the_one_process_step(tmp_path, optimizer):
    """Two processes, each on half of every global batch, with one gloo
    all-reduce a step, end with bit-equal parameters that equal the
    one-process step on the whole batch within 1e-6, and report the
    global-batch loss.  (Adam is left out here: it divides a gradient by
    its own magnitude, so a component near zero that the two sum orders
    round apart moves by up to ~lr, not by the rounding.)"""
    b = batches(3, rows=64, seed=2)
    np.savez(tmp_path / "data.npz", x=np.stack([x for x, _ in b]),
             y=np.stack([y for _, y in b]))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / "data.npz"), str(tmp_path / f"rank{r}.npz"),
         optimizer], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    model = tmlp.MnistMLP(16, device="cpu")
    state = TrainState.create(model, topt.make_optimizer(optimizer, 0.05))
    step = tsync.build_sync_train_step(port_loss_fn)
    losses = []
    for x, y in b:
        state, m = step(state, (x, y))
        losses.append(float(m["loss"]))
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
        np.testing.assert_allclose(ranks[0][name], t.numpy(),
                                   atol=PARAM_TOL, rtol=0)
    np.testing.assert_allclose(ranks[0]["losses"], losses, atol=LOGIT_TOL)
