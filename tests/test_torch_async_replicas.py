"""The port's async replicas (``parallel/async_replicas.py``) against the
JAX package's: the seven cases of ``tests/test_async_training.py`` at
R = 8, the JAX 8-device CPU mesh's replica count, and parity of the
stacked parameters after the same per-replica batches.

The same numpy inputs and weights (``mlp.params_from_jax``) go through
both packages; the JAX steps run jitted over the 8-device CPU mesh of
``tests/conftest.py`` with the batch sharded over ``data``.  Tolerances,
fp32: stacked parameters 1e-6 absolute with SGD, 1e-5 with Adam (see
``PARAM_TOL_OPT``; the packages sum a gradient in different orders, ~1e-8
apart at these widths), the merged
trajectory of ``sync_period=1`` against the sync step 1e-5 (per-replica
gradients then a mean, against the mean gradient: JAX's own tolerance),
losses 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.parallel import async_replicas as jasync
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import replicate_tree
from distributed_tensorflow_tpu.training import optimizers as jopt
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu.training.supervisor import _pure_tree
from distributed_tensorflow_tpu_torch.data import datasets as tdata
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import async_replicas as tasync
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, load_checkpoint_tree)
from distributed_tensorflow_tpu_torch.utils.pytree import tree_paths

R = 8
HIDDEN = 16
PARAM_TOL = 1e-6
# Adam divides each gradient by its own root mean square: where a hidden
# unit is reached by one or two of a replica's 8 rows its gradient sits
# near eps (1e-8), and the ~1e-8 rounding difference between the packages'
# gradients becomes ~1e-6 of the update (measured 4.3e-6 after five steps
# at lr 1e-3).  SGD keeps the 1e-6 of the sync parity tests.
PARAM_TOL_OPT = {"sgd": PARAM_TOL, "adam": 1e-5}
LOSS_TOL = {"sgd": 1e-6, "adam": 1e-5}


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


def jax_params(seed=0, hidden=HIDDEN):
    model = jmlp.MnistMLP(hidden_units=hidden)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 784)))
    return model, jax.device_get(params["params"])


def jax_state(mesh, tx):
    model, params = jax_params()
    apply_fn = lambda p, x: model.apply({"params": p}, x)
    state = JState.create(apply_fn, params, tx)
    return state.replace(params=replicate_tree(mesh, state.params),
                         opt_state=replicate_tree(mesh, state.opt_state),
                         global_step=replicate_tree(mesh, state.global_step))


def jax_loss_fn(state):
    def loss_fn(params, batch):
        x, y = batch
        logits = state.apply_fn(params, x)
        return jmlp.cross_entropy_loss(logits, y), {
            "accuracy": jmlp.accuracy(logits, y)}
    return loss_fn


def port_state(spec=None, hidden=HIDDEN):
    model = tmlp.MnistMLP(hidden, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(jax_params(hidden=hidden)[1]))
    return TrainState.create(model, spec or topt.make_optimizer("sgd", 0.1),
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


def stacked_tree(astate):
    """The port's stacked parameters as the JAX flax tree ``[R, ...]``."""
    return {layer: {leaf: astate.params[f"{layer}.{leaf}"].numpy()
                    for leaf in ("kernel", "bias")}
            for layer in ("hid", "sm")}


def assert_stacks_close(astate, jax_params_tree, tol=PARAM_TOL):
    got = stacked_tree(astate)
    for layer in ("hid", "sm"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(
                got[layer][leaf], np.asarray(jax_params_tree[layer][leaf]),
                atol=tol, rtol=0)


def plain(tree):
    """A JAX state tree as a checkpoint holds it: optax's named tuples as
    dicts of their fields (None when empty), tuples as lists."""
    if hasattr(tree, "_fields"):
        return ({f: plain(getattr(tree, f)) for f in tree._fields}
                if tree._fields else None)
    if isinstance(tree, (list, tuple)):
        return [plain(x) for x in tree]
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


def spread(astate):
    w = astate.params["hid.kernel"].numpy()
    return np.abs(w - w.mean(axis=0, keepdims=True)).max()


# ---------------------------------------- tests/test_async_training.py


def test_async_replicas_diverge_then_merge():
    step, astate = tasync.build_async_train_step(
        port_loss_fn, port_state(), num_replicas=R, sync_period=4)
    data = batches(4)
    for b in data[:3]:
        astate, _ = step(astate, b)
    assert spread(astate) > 1e-7, "replicas should have diverged"
    astate, _ = step(astate, data[3])
    for t in astate.params.values():
        np.testing.assert_allclose(t.numpy(), np.broadcast_to(
            t[0:1].numpy(), t.shape), atol=1e-6)


def test_async_global_step_counts_all_replicas():
    step, astate = tasync.build_async_train_step(
        port_loss_fn, port_state(), num_replicas=R, sync_period=4)
    astate, metrics = step(astate, batches(1)[0])
    assert int(metrics["global_step"]) == 1 + R
    assert isinstance(metrics["loss"], tasync.HostMeanScalar)
    assert tuple(metrics["loss"].stacked.shape) == (R,)


def test_async_training_converges():
    # The JAX case's model: hidden 32, SGD 0.1.
    ds = tdata.read_data_sets("/nonexistent")
    step, astate = tasync.build_async_train_step(
        port_loss_fn, port_state(hidden=32), num_replicas=R, sync_period=4)
    losses = []
    for _ in range(40):
        astate, metrics = step(astate, ds.train.next_batch(64))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7
    replica0 = {n: t[0].clone() for n, t in astate.params.items()}
    with tasync.consensus_model(astate) as model, torch.no_grad():
        logits = model(torch.as_tensor(ds.test.images[:512]))
    acc = float(tmlp.accuracy(logits, torch.as_tensor(ds.test.labels[:512])))
    assert acc > 0.5
    # The evaluation left replica 0, whose views the template holds,
    # as it was.
    for n, p in astate.model.named_parameters():
        assert torch.equal(p, replica0[n])
        assert p.data_ptr() == astate.params[n].data_ptr()


def test_local_step_calls_no_collective_and_reduces_nothing(monkeypatch):
    """The counterpart of the JAX HLO check: the local step makes no
    ``torch.distributed`` call, and each replica's update is what training
    that replica alone on its shard gives (no cross-replica reduction);
    the merge is the one place the replicas meet."""
    import torch.distributed as dist

    def forbidden(*a, **k):
        raise AssertionError("the async local step called a collective")
    for name in ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
                 "all_to_all", "all_gather_into_tensor",
                 "reduce_scatter_tensor"):
        monkeypatch.setattr(dist, name, forbidden, raising=False)
    local = tasync.build_async_local_step(port_loss_fn)
    astate = tasync.make_async_state(port_state(), R)
    batch = batches(1)[0]
    astate, raw = local(astate, batch)
    for r in (0, 5):
        solo = port_state()
        step = tsync.build_sync_train_step(port_loss_fn)
        solo, m = step(solo, tsync._split(batch, R, r))
        for n, p in solo.model.named_parameters():
            np.testing.assert_allclose(astate.params[n][r].numpy(),
                                       p.detach().numpy(), atol=1e-7)
        assert abs(float(raw["loss"][r]) - float(m["loss"])) < 1e-6
    assert spread(astate) > 1e-7
    tasync.build_merge_step()(astate)
    assert spread(astate) < 1e-6


def test_scanned_async_matches_per_step():
    period = 4
    step_a, astate_a = tasync.build_async_train_step(
        port_loss_fn, port_state(), num_replicas=R, sync_period=period)
    step_s, astate_s = tasync.build_scanned_async_train_step(
        port_loss_fn, port_state(), num_replicas=R, sync_period=period)
    host = batches(period)
    for b in host:
        astate_a, metrics_a = step_a(astate_a, b)
    astate_s, metrics_s = step_s(astate_s, tsync.stack_microbatches(host))
    for n in astate_a.params:
        np.testing.assert_allclose(astate_a.params[n].numpy(),
                                   astate_s.params[n].numpy(), atol=1e-6)
    assert astate_a.global_step == astate_s.global_step == 1 + period * R
    assert abs(float(metrics_a["loss"]) - float(metrics_s["loss"])) < 1e-5


def test_scanned_async_merge_false_never_merges():
    period = 3
    step, astate = tasync.build_scanned_async_train_step(
        port_loss_fn, port_state(), num_replicas=R, sync_period=period,
        merge=False)
    astate, _ = step(astate, tsync.stack_microbatches(batches(period)))
    leaf = astate.params["hid.kernel"].numpy()
    assert not np.allclose(leaf[0], leaf[1])


def test_async_sync_period_one_matches_sync():
    sync_state = port_state()
    sync_step = tsync.build_sync_train_step(port_loss_fn)
    async_step, astate = tasync.build_async_train_step(
        port_loss_fn, port_state(), num_replicas=R, sync_period=1)
    for b in batches(3):
        sync_state, _ = sync_step(sync_state, b)
        astate, _ = async_step(astate, b)
    merged = tasync.merge_params(astate)
    for n, p in sync_state.model.named_parameters():
        np.testing.assert_allclose(merged[n].numpy(), p.detach().numpy(),
                                   atol=1e-5)


# ------------------------------------------------------------ parity


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_five_async_steps_equal_jax_stacks(mesh, opt):
    lr = 0.1 if opt == "sgd" else 1e-3
    jstate = jax_state(mesh, jopt.make_optimizer(opt, lr))
    jstep, jastate = jasync.build_async_train_step(
        mesh, jax_loss_fn(jstate), jstate, sync_period=4)
    step, astate = tasync.build_async_train_step(
        port_loss_fn, port_state(topt.make_optimizer(opt, lr)),
        num_replicas=R, sync_period=4)
    sharding = jmesh.data_sharded(mesh)
    for b in batches(5, seed=3):
        jastate, jm = jstep(jastate, tuple(jax.device_put(a, sharding)
                                           for a in b))
        astate, m = step(astate, b)
        assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_TOL[opt]
    assert astate.global_step == int(jastate.global_step) == 1 + 5 * R
    assert_stacks_close(astate, jax.device_get(jastate.params),
                        tol=PARAM_TOL_OPT[opt])
    # The async checkpoint is JAX's per-replica stacks, leaf for leaf.
    want = jax.tree_util.tree_flatten_with_path(
        jax.device_get(_pure_tree(jastate)))[0]
    got = dict(tree_paths(checkpoint_tree(astate)))
    from distributed_tensorflow_tpu.parallel.sharding import path_str
    want = {path_str(p).replace(".", "/"): np.asarray(v) for p, v in want}
    assert len(got) == len(want)
    for path, leaf in want.items():
        mine = got[path] if path in got else None
        assert mine is not None, path
        assert np.shape(mine) == leaf.shape, path
        # Adam's moments of the near-eps gradients above differ in their
        # third digit (2 of 1280 elements); the rest agree to 1e-6.
        slot = path.startswith("opt_state") and opt == "adam"
        np.testing.assert_allclose(np.asarray(mine, np.float64),
                                   leaf.astype(np.float64),
                                   atol=PARAM_TOL_OPT[opt],
                                   rtol=1e-2 if slot else 0)
    # ... and the JAX stacks restore into a fresh port async state.
    fresh = tasync.make_async_state(
        port_state(topt.make_optimizer(opt, lr)), R)
    load_checkpoint_tree(fresh, plain(jax.device_get(_pure_tree(jastate))))
    assert_stacks_close(fresh, jax.device_get(jastate.params), tol=0.0)
    assert fresh.global_step == astate.global_step


def _host_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"hid": {"kernel": (rng.standard_normal((784, HIDDEN)) * scale
                               ).astype(np.float32),
                    "bias": rng.standard_normal(HIDDEN).astype(np.float32)},
            "sm": {"kernel": rng.standard_normal((HIDDEN, 10)
                                                 ).astype(np.float32),
                   "bias": rng.standard_normal(10).astype(np.float32)}}


def test_adopt_consensus_and_delta_equal_jax(mesh):
    jstate = jax_state(mesh, jopt.make_optimizer("sgd", 0.1))
    jstep, jastate = jasync.build_async_train_step(
        mesh, jax_loss_fn(jstate), jstate, sync_period=4)
    step, astate = tasync.build_async_train_step(
        port_loss_fn, port_state(), num_replicas=R, sync_period=4)
    sharding = jmesh.data_sharded(mesh)
    for b in batches(2, seed=5):     # diverged replicas
        jastate, _ = jstep(jastate, tuple(jax.device_put(a, sharding)
                                          for a in b))
        astate, _ = step(astate, b)
    avg, snap = _host_tree(1), _host_tree(2, scale=0.5)
    want = jasync.adopt_consensus_delta(jastate.params, avg, snap)
    storage = {n: t.data_ptr() for n, t in astate.params.items()}
    tasync.adopt_consensus_delta(astate, avg, snap)
    assert_stacks_close(astate, jax.device_get(want))
    want = jasync.adopt_consensus(jastate.params, avg)
    tasync.adopt_consensus(astate, avg)
    assert_stacks_close(astate, jax.device_get(want), tol=0.0)
    # In place: the stacked tensors are the ones the optimizers update.
    assert storage == {n: t.data_ptr() for n, t in astate.params.items()}
    # The consensus host tree is the flax tree, in the stacked dtype.
    tree = tasync.host_tree(astate)
    assert tree["hid"]["kernel"].dtype == np.float32
    np.testing.assert_allclose(tree["hid"]["kernel"], avg["hid"]["kernel"],
                               atol=PARAM_TOL)


def test_template_holds_no_copy_and_evaluates_the_consensus():
    """The template's parameters are replica 0's views, so the device
    holds R copies and no more; at R = 1 the consensus model is the
    template itself, at R > 1 it runs the mean."""
    for n_rep in (1, 2):
        astate = tasync.make_async_state(port_state(), n_rep)
        own = dict(astate.model.named_parameters())
        for n, t in astate.params.items():
            assert own[n].data_ptr() == t.data_ptr()
        step = tasync.build_async_local_step(port_loss_fn)
        astate, _ = step(astate, batches(1, rows=8 * n_rep, seed=3)[0])
        merged = tasync.merge_params(astate)
        with tasync.consensus_model(astate) as model:
            for n, p in model.named_parameters():
                assert torch.equal(p, merged[n])
        for n, p in own.items():
            assert p.data_ptr() == astate.params[n].data_ptr()


def test_overlapped_snapshot_keeps_the_local_steps_on_the_cpu():
    """The host snapshot handed to the exchange thread is a copy: local
    steps taken while the exchange runs move the parameters but not the
    snapshot, and applying the consensus as a delta keeps them."""
    from distributed_tensorflow_tpu_torch.cluster import param_sync as tps

    import threading

    from distributed_tensorflow_tpu_torch.utils.pytree import tree_map
    averaged = threading.Event()

    class Shift:
        """A stand-in averager: the consensus is the snapshot + 0.25,
        from one peer."""

        def exchange(self, tree, alive=None):
            avg = tree_map(lambda x: np.asarray(x) + np.float32(0.25), tree)
            averaged.set()
            return avg, 1

    step, astate = tasync.build_async_train_step(
        port_loss_fn, port_state(), num_replicas=1, sync_period=1000)
    before = {n: t.clone() for n, t in astate.params.items()}
    overlapped = tps.OverlappedAverager(Shift(), print_fn=lambda *_: None)
    try:
        assert overlapped.submit(tasync.host_tree(astate))
        assert averaged.wait(30.0)
        for b in batches(2, seed=7):
            astate, _ = step(astate, b)
        stepped = {n: t.clone() for n, t in astate.params.items()}
        assert any(not torch.equal(stepped[n], before[n]) for n in before)
        avg, snap, peers = overlapped.drain(timeout=30.0)
    finally:
        overlapped.close()
    assert peers == 1
    tasync.adopt_consensus_delta(astate, avg, snap)
    for n, t in astate.params.items():
        np.testing.assert_allclose(t.numpy(), (stepped[n] + 0.25).numpy(),
                                   atol=1e-6, rtol=0)
