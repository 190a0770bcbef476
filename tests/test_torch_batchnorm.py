"""ResNet-20's synchronised BatchNorm and its non-trainable state in the
port (distributed_tensorflow_tpu_torch/models/resnet._moments,
parallel/sync.build_stateful_sync_train_step, training/state's
``model_state``) against the JAX package.

JAX takes a training step's BatchNorm statistics over the global batch
(GSPMD over the ``data`` axis).  The port's data axis is the sync
trainer's worker processes, so a two-rank gloo step on the CPU (ONE
module-scoped spawn, ``_RANK``; each rank feeds its half of the batch)
is held to the one-process JAX step on the concatenated batch: in
float64 (both ranks and JAX under ``jax.enable_x64``) the loss, the
running statistics and the updates within 1e-9; in fp32 the loss and the
running statistics within 1e-5 and the updates within 1e-4 where JAX's
fp32 rounding does not show (tests/test_torch_models.py); and to the
port's one-process step (the loss and statistics 1e-5, the updates
within 0.5% and, a step later, 2%); the ranks' parameters and statistics
bit-equal.  A one-rank group is plain BatchNorm.
Checkpoints with the model state go both ways through the two
supervisors; ``--mode=eval`` restores the running statistics."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu.training.supervisor import (
    Supervisor as JSupervisor)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.data.datasets import read_cifar10
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01
BATCH = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: As in tests/test_torch_models.py: where JAX's fp32 result is within
#: half the 1e-4 tolerance of its float64 result, the port's fp32 result
#: is held to JAX's at 1e-4.
ROUNDING = 5e-5


def _x64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jax.device_get(tree))


def _named(tree, prefix=""):
    """A JAX tree's leaves as float64 tensors under the port's names."""
    out = {}
    for key, value in jax.device_get(tree).items():
        if isinstance(value, dict):
            out.update(_named(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(
                np.array(value, np.float64))
    return out


def _jax_resnet():
    """JAX ``registry.build_resnet20``'s model, state and stateful loss
    (parameters from a jitted init)."""
    train = jresnet.ResNet20(use_running_average=False)
    ev = jresnet.ResNet20(use_running_average=True)
    v = jax.jit(train.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))

    def apply_eval(p, stats, x):
        return ev.apply({"params": p, "batch_stats": stats}, x)

    def loss_fn(p, stats, batch):
        images, labels = batch
        logits, mutated = train.apply({"params": p, "batch_stats": stats},
                                      images, mutable=["batch_stats"])
        return jmlp.cross_entropy_loss(logits, labels), (
            {"accuracy": jmlp.accuracy(logits, labels)},
            mutated["batch_stats"])
    state = JState.create(apply_eval, v["params"], optax.sgd(LR),
                          model_state=v["batch_stats"])
    return state, loss_fn


def _port_state(jstate):
    tb = treg.build_resnet20(LR, device="cpu",
                             tx=topt.make_optimizer("sgd", LR))
    tb.state.model.load_state_dict(tresnet.params_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.model_state)))
    return tb


_RANK = r"""
import json, sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch.models import registry, resnet
from distributed_tensorflow_tpu_torch.parallel import sync
from distributed_tensorflow_tpu_torch.training.optimizers import (
    make_optimizer)
rank, world, store, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
d = np.load(data)
res, arrays = {}, {}
n = d["x"].shape[1] // world
for tag in ("", "f64:"):            # fp32, then the same steps in float64
    b = registry.build_resnet20(0.01, device="cpu",
                                tx=make_optimizer("sgd", 0.01))
    b.state.model.load_state_dict({k[3:]: torch.from_numpy(d[k])
                                   for k in d.files if k.startswith("sd:")})
    if tag:
        b.state.model.double()
        b.state.model_state = resnet.batch_stats(b.state.model)
        resnet.nhwc_images = lambda t, s, c: t.reshape(-1, s, s, c).double()
    ar = sync.GradientAllReduce()
    step = sync.build_stateful_sync_train_step(b.stateful_loss_fn,
                                               all_reduce=ar)
    state, res[tag + "loss"] = b.state, []
    for i in range(d["x"].shape[0]):
        x, y = d["x"][i], d["y"][i]
        state, m = step(state, (x[rank * n:(rank + 1) * n],
                                y[rank * n:(rank + 1) * n]))
        res[tag + "loss"].append(float(m["loss"]))
        for k, t in state.model.state_dict().items():
            arrays[f"{tag}{i}:{k}"] = t.detach().numpy().copy()
    res[tag + "collective_calls"] = ar.calls
np.savez(out + ".npz", **arrays)
json.dump(res, open(out + ".json", "w"))
dist.destroy_process_group()
"""


def _spawn(tmp, x, y, jstate):
    """The two-rank group and the world of one, side by side."""
    sd = tresnet.params_from_jax(jax.device_get(jstate.params),
                                 jax.device_get(jstate.model_state))
    np.savez(tmp / "data.npz", x=x, y=y,
             **{f"sd:{k}": v.numpy() for k, v in sd.items()})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = [(2, 0), (2, 1), (1, 0)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world),
         str(tmp / f"store{world}"), str(tmp / "data.npz"),
         str(tmp / f"w{world}r{r}")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for world, r in runs]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    got = [(json.load(open(tmp / f"w{w}r{r}.json")),
            np.load(tmp / f"w{w}r{r}.npz")) for w, r in runs]
    return got[:2], got[2:]


def test_two_rank_step_takes_the_global_batch_statistics(tmp_path):
    """Two ranks, two steps on their halves of two batches; a world of one
    on the whole batches; the JAX step on the whole first batch.  (One
    test: the spawn is its cost.)"""
    ds = read_cifar10("/nonexistent").train
    batches = [ds.next_batch(BATCH) for _ in range(2)]
    x = np.stack([b[0] for b in batches])
    y = np.stack([b[1] for b in batches])
    jstate, loss_fn = _jax_resnet()
    two, one = _spawn(tmp_path, x, y, jstate)
    (r0, a0), (r1, a1) = two

    # The ranks stay bit-equal: parameters and running statistics.
    assert r0["loss"] == r1["loss"] and r0["f64:loss"] == r1["f64:loss"]
    for k in a0.files:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    assert any(k.endswith(".mean") for k in a0.files)
    # BatchNorm's collectives are untimed (``resnet._moments`` calls the
    # group itself): the trainer's ``all-reduce X ms a call`` line counts
    # the gradient all-reduce alone, one a step (after the first).
    assert r0["collective_calls"] == one[0][0]["collective_calls"] == 1

    # The port's one-process step on the concatenated batch (the world of
    # one takes the plain BatchNorm path, and equals the step without a
    # group bit for bit).  The sums differ in order only; BatchNorm's
    # backward cancels most of each gradient, so that rounding shows in
    # the parameters' updates at the level of the port's own fp32
    # distance from float64 (0.13% of the first step's update,
    # tests/test_torch_models.py).
    (w1, o1), = one
    before = tresnet.params_from_jax(jax.device_get(jstate.params))
    for i, rel in enumerate((5e-3, 2e-2)):
        np.testing.assert_allclose(r0["loss"][i], w1["loss"][i], rtol=1e-5)
        stats = [k for k in a0.files if k.startswith(f"{i}:")
                 and k.endswith((".mean", ".var"))]
        for k in stats:
            np.testing.assert_allclose(a0[k], o1[k], atol=1e-5, rtol=0,
                                       err_msg=k)
        params = sorted(k for k in a0.files if k.startswith(f"{i}:")
                        and k not in stats)
        base = np.concatenate([
            o1[f"{i - 1}:{k[2:]}"].ravel() if i
            else before[k[2:]].numpy().ravel() for k in params])
        u0 = np.concatenate([a0[k].ravel() for k in params]) - base
        u1 = np.concatenate([o1[k].ravel() for k in params]) - base
        assert np.linalg.norm(u0 - u1) / np.linalg.norm(u1) <= rel, i
    tb = _port_state(jstate)
    step = tsync.build_stateful_sync_train_step(tb.stateful_loss_fn)
    state, m = step(tb.state, (x[0], y[0]))
    assert float(m["loss"]) == w1["loss"][0]
    for k, t in state.model.state_dict().items():
        np.testing.assert_array_equal(o1[f"0:{k}"], t.numpy(), err_msg=k)

    # The JAX steps on the whole batches.  float64 (``jax.enable_x64``):
    # the two ranks' loss, running statistics and every parameter's
    # update within 1e-9, so the synchronised BatchNorm and its backward
    # are JAX's.  fp32: the loss and the running statistics of the first
    # step within 1e-5; each update within 1e-4 of JAX's where JAX's
    # fp32 update does not show its own rounding (``ROUNDING``), and the
    # whole update at least as close to float64 as JAX's.
    jstep = jsync.build_stateful_sync_train_step(None, loss_fn,
                                                 donate=False)
    js = jstate
    with jax.enable_x64(True):
        p64 = _x64(jstate.params)
        js64 = jstate.replace(params=p64, opt_state=optax.sgd(LR).init(p64),
                              model_state=_x64(jstate.model_state))
    prev = {k: v.double() for k, v in before.items()}
    held = 0
    for i in range(2):
        js, jm = jstep(js, (x[i], y[i]))
        with jax.enable_x64(True):
            js64, jm64 = jstep(js64, (x[i].astype(np.float64),
                                      y[i].astype(np.float64)))
        # (The loss the step reports is an fp32 metric.)
        np.testing.assert_allclose(r0["f64:loss"][i], float(jm64["loss"]),
                                   rtol=1e-7)
        for k, t in _named(js64.model_state).items():
            np.testing.assert_allclose(a0[f"f64:{i}:{k}"], t.numpy(),
                                       atol=1e-9, rtol=0, err_msg=k)
        want64 = _named(js64.params)
        want = _named(js.params)
        for k, w in want64.items():
            norm = float((w - prev[k]).norm())
            got64 = torch.from_numpy(a0[f"f64:{i}:{k}"])
            assert float((got64 - w).norm()) / norm <= 1e-9, (i, k)
            jax_err = float((want[k] - w).norm()) / norm
            if jax_err <= ROUNDING:
                held += 1
                got = torch.from_numpy(a0[f"{i}:{k}"]).double()
                assert float((got - want[k]).norm()) / norm <= 1e-4, (i, k)
        if i == 0:
            assert abs(r0["loss"][0] - float(jm["loss"])) <= 1e-5
            jstats = tresnet.params_from_jax({}, jax.device_get(
                js.model_state))
            for k, t in jstats.items():
                np.testing.assert_allclose(a0[f"0:{k}"], t.numpy(),
                                           atol=1e-5, rtol=0, err_msg=k)
        keys = sorted(want64)
        up_x = np.concatenate([(want64[k] - prev[k]).numpy().ravel()
                               for k in keys])
        up_t = np.concatenate([(a0[f"{i}:{k}"] - prev[k].numpy()).ravel()
                               for k in keys])
        up_j = np.concatenate([(want[k] - prev[k]).numpy().ravel()
                               for k in keys])
        norm = np.linalg.norm(up_x)
        assert (np.linalg.norm(up_t - up_x) / norm
                <= np.linalg.norm(up_j - up_x) / norm), i
        prev = want64
    assert held >= 5               # the 1e-4 check is not vacuous


# ----------------------------------------------------------- checkpoints


def test_a_port_checkpoint_restores_in_the_jax_supervisor(tmp_path):
    jstate, loss_fn = _jax_resnet()
    tb = _port_state(jstate)
    sv = Supervisor(is_chief=True, logdir=str(tmp_path),
                    init_fn=lambda: tb.state)
    state = sv.prepare_or_wait_for_state()
    step = tsync.build_stateful_sync_train_step(tb.stateful_loss_fn)
    ds = read_cifar10("/nonexistent").train
    for _ in range(2):
        state, _ = step(state, ds.next_batch(8))
    sv.maybe_save(state, force=True)
    sv.close()
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path),
                      init_fn=lambda: jstate)
    restored = jsv.prepare_or_wait_for_state()
    jsv.close()
    assert int(restored.global_step) == 3
    want = tresnet.params_from_jax(jax.device_get(restored.params),
                                   jax.device_get(restored.model_state))
    got = state.model.state_dict()
    assert set(want) == set(got)
    for k, t in got.items():
        np.testing.assert_array_equal(want[k].numpy(), t.numpy(), err_msg=k)
    x = ds.next_batch(4)[0]
    model = state.model.eval()
    np.testing.assert_allclose(
        np.asarray(restored.apply_fn(restored.params, restored.model_state,
                                     x)),
        model(torch.from_numpy(x)).detach().numpy(), atol=1e-4, rtol=0)


def test_a_jax_checkpoint_evaluates_in_the_port_cli(tmp_path, monkeypatch,
                                                    capsys):
    """JAX's stateful steps, saved by the JAX supervisor; the port's
    ``--mode=eval`` restores parameters and running statistics and
    reports the JAX eval's accuracy (the running statistics matter: eval
    with the initial ones gives another number)."""
    from distributed_tensorflow_tpu.training.loop import (
        make_stateful_eval_fn)
    from distributed_tensorflow_tpu_torch.cluster.server import Server
    from distributed_tensorflow_tpu_torch.data import datasets as tdata
    jstate, loss_fn = _jax_resnet()
    jstep = jsync.build_stateful_sync_train_step(None, loss_fn, donate=False)
    # The CIFAR stand-in with 400-image evaluation splits (the CLI
    # evaluates its whole validation and test splits).
    full = tdata.read_cifar10

    def small(data_dir, **kw):
        d = full(data_dir, **kw)
        return tdata.Datasets(
            train=d.train, synthetic=d.synthetic,
            validation=tdata.DataSet(d.validation.images[:400],
                                     d.validation.labels[:400]),
            test=tdata.DataSet(d.test.images[:400], d.test.labels[:400]))
    monkeypatch.setattr(tdata, "read_cifar10", small)
    data = small("/nonexistent")
    for _ in range(2):
        jstate, _ = jstep(jstate, data.train.next_batch(16))
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path / "run" /
                                                "resnet20"),
                      init_fn=lambda: jstate)
    jsv.prepare_or_wait_for_state()
    jsv.maybe_save(jstate, force=True)
    jsv.close()
    want = make_stateful_eval_fn(jstate.apply_fn)(jstate, data.test)
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)
    result = ttrain.app.run(ttrain.main, [
        "--mode=eval", "--model=resnet20", "--job_name=worker",
        "--task_index=0", "--worker_hosts=localhost:0", "--device=cpu",
        "--data_dir=/nonexistent", f"--logdir={tmp_path / 'run'}"])
    assert result["global_step"] == 3
    assert abs(result["test_accuracy"] - want) <= 2e-4
    assert "Worker 0: restored global step 3" in capsys.readouterr().out


def test_checkpoint_tree_carries_flax_batch_stats():
    from distributed_tensorflow_tpu_torch.training.state import (
        checkpoint_tree, load_checkpoint_tree)
    jstate, _ = _jax_resnet()
    tb = _port_state(jstate)
    tree = checkpoint_tree(tb.state)
    stats = jax.device_get(jstate.model_state)
    assert (jax.tree_util.tree_structure(tree["model_state"])
            == jax.tree_util.tree_structure(stats))
    np.testing.assert_array_equal(
        tree["model_state"]["stage1_block0"]["bn_proj"]["var"],
        stats["stage1_block0"]["bn_proj"]["var"])
    other = treg.build_resnet20(0.1, seed=3, device="cpu").state
    load_checkpoint_tree(other, tree)
    for k, t in other.model_state.items():
        torch.testing.assert_close(t, tb.state.model_state[k], rtol=0,
                                   atol=0)
    tree["model_state"]["bn0"]["mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="bn0.mean"):
        load_checkpoint_tree(other, tree)
