"""Selective fine-tuning in the port (``--trainable_params``,
``training/optimizers.freeze_except``): the four cases of
``tests/test_freeze.py``, and frozen-run checkpoints across the packages
(optax's ``multi_transform`` layout): a port run's restored by the JAX
supervisor and a JAX run's by the port's, with equal parameters and
slots.  The JAX side runs as its own tests run it (the MLP replicated
over the 8-device CPU mesh, orbax's default layout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.parallel.sharding import replicate_tree
from distributed_tensorflow_tpu.training import optimizers as jopt
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu.training.supervisor import (
    Supervisor as JSupervisor)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.server import Server
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, apply_freeze, checkpoint_tree)
from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor

HIDDEN = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    """``tests/test_freeze.py``'s tree, as numpy."""
    return {"hid": {"kernel": np.ones((8, 4), np.float32) * 0.1,
                    "bias": np.zeros((4,), np.float32)},
            "sm": {"kernel": np.ones((4, 2), np.float32) * 0.1,
                   "bias": np.zeros((2,), np.float32)}}


class _Tiny(torch.nn.Module):
    """A module whose parameters are ``_params()`` under flax's names."""

    def __init__(self):
        super().__init__()
        self.hid = torch.nn.Module()
        self.sm = torch.nn.Module()
        for layer, leaves in _params().items():
            for name, a in leaves.items():
                setattr(getattr(self, layer), name,
                        torch.nn.Parameter(torch.from_numpy(a.copy())))


def _tiny_state(spec):
    state = TrainState.create(_Tiny(), spec,
                              params_to_tree=tmlp.params_to_jax,
                              params_from_tree=tmlp.params_from_jax)
    tx, n_train, n_total = topt.freeze_except(
        spec, checkpoint_tree(state)["params"], r"sm")
    apply_freeze(state, tx)
    return state, n_train, n_total


def test_frozen_params_do_not_move():
    state, n_train, n_total = _tiny_state(topt.make_optimizer("adam", 0.1))
    assert n_train == 4 * 2 + 2
    assert n_total == 8 * 4 + 4 + 4 * 2 + 2
    for _ in range(2):
        for p in state.model.parameters():
            p.grad = torch.ones_like(p) if p.requires_grad else None
        state.apply_gradients()
    got = tmlp.params_to_jax(state.model.state_dict())
    np.testing.assert_array_equal(got["hid"]["kernel"],
                                  _params()["hid"]["kernel"])
    assert not np.array_equal(got["sm"]["kernel"], _params()["sm"]["kernel"])


def test_frozen_params_have_no_adam_slots():
    state, _, _ = _tiny_state(topt.make_optimizer("adam", 0.1))
    for p in state.model.parameters():
        p.grad = torch.ones_like(p) if p.requires_grad else None
    state.apply_gradients()
    slots = state.optimizer.base.state
    slot_elems = sum(t.numel() for st in slots.values()
                     for k, t in st.items() if k != "step")
    assert slot_elems <= 2 * (4 * 2 + 2) + 4
    assert len(slots) == 2          # sm/kernel and sm/bias only


def test_empty_match_rejected():
    state = TrainState.create(_Tiny(), topt.make_optimizer("sgd", 0.1),
                              params_to_tree=tmlp.params_to_jax)
    with pytest.raises(ValueError, match="matches no parameters"):
        topt.freeze_except(state.optimizer.spec,
                           checkpoint_tree(state)["params"],
                           r"nonexistent_layer")


def test_cli_head_only_finetune(tmp_path, monkeypatch, capsys):
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)
    result = ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--data_dir=/nonexistent",
        "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
        "--train_steps=150", "--batch_size=64", "--hidden_units=32",
        "--learning_rate=0.1", "--log_every=10", "--sync_replicas=true",
        "--trainable_params=sm", f"--logdir={tmp_path}/logdir",
        "--device=cpu"])
    out = capsys.readouterr().out
    assert "trains 330 of 25,450 parameters" in out
    assert result.final_global_step >= 150
    assert result.test_accuracy > 0.3


# ------------------------------------------------- across the packages


def _batches(n, rows=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((rows, 784), dtype=np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)])
            for _ in range(n)]


def _jax_frozen_state(mesh):
    model = jmlp.MnistMLP(hidden_units=HIDDEN)
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 784)))["params"])
    tx, _, _ = jopt.freeze_except(jopt.make_optimizer("adam", 1e-3),
                                  params, r"sm")
    apply_fn = lambda p, x: model.apply({"params": p}, x)
    state = JState.create(apply_fn, params, tx)
    state = state.replace(params=replicate_tree(mesh, state.params),
                          opt_state=replicate_tree(mesh, state.opt_state),
                          global_step=replicate_tree(mesh,
                                                     state.global_step))
    return state, params


def _port_frozen_state(params):
    model = tmlp.MnistMLP(HIDDEN, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params))
    state = TrainState.create(model, topt.make_optimizer("adam", 1e-3),
                              params_to_tree=tmlp.params_to_jax,
                              params_from_tree=tmlp.params_from_jax)
    tx, _, _ = topt.freeze_except(state.optimizer.spec,
                                  checkpoint_tree(state)["params"], r"sm")
    return apply_freeze(state, tx)


def _port_loss_fn(model, batch):
    x, y = (torch.as_tensor(np.asarray(a)) for a in batch)
    logits = model(x)
    return tmlp.cross_entropy_loss(logits, y), {}


def _jax_loss_fn(apply_fn):
    def loss_fn(params, batch):
        x, y = batch
        return jmlp.cross_entropy_loss(apply_fn(params, x), y), {}
    return loss_fn


def _assert_same(port_state, jax_state):
    got = checkpoint_tree(port_state)
    want = jax.device_get(jax_state.params)
    for layer in ("hid", "sm"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got["params"][layer][leaf],
                                          np.asarray(want[layer][leaf]))
    mu_j = jax_state.opt_state.inner_states["train"].inner_state[0].mu
    mu_t = got["opt_state"]["inner_states"]["train"]["inner_state"][0]["mu"]
    assert mu_t["hid"]["kernel"] is None
    np.testing.assert_allclose(mu_t["sm"]["kernel"],
                               np.asarray(mu_j["sm"]["kernel"]), atol=1e-7)
    assert int(port_state.global_step) == int(jax_state.global_step)


def test_a_port_frozen_run_restores_in_the_jax_supervisor(tmp_path):
    mesh = jmesh.data_parallel_mesh()
    template, params = _jax_frozen_state(mesh)
    state = _port_frozen_state(params)
    step = tsync.build_sync_train_step(_port_loss_fn)
    for b in _batches(3):
        state, _ = step(state, b)
    sv = Supervisor(is_chief=True, logdir=str(tmp_path),
                    init_fn=lambda: state)
    sv.maybe_save(state, force=True)
    sv.close()
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path),
                      init_fn=lambda: template)
    restored = jsv.prepare_or_wait_for_state()
    jsv.close()
    _assert_same(state, restored)
    # The frozen layer never moved.
    np.testing.assert_array_equal(
        np.asarray(restored.params["hid"]["kernel"]),
        np.asarray(params["hid"]["kernel"]))


def test_a_jax_frozen_run_restores_in_the_port_supervisor(tmp_path):
    mesh = jmesh.data_parallel_mesh()
    jstate, params = _jax_frozen_state(mesh)
    jstep = jsync.build_sync_train_step(mesh, _jax_loss_fn(jstate.apply_fn),
                                        donate=False)
    sharding = jmesh.data_sharded(mesh)
    for b in _batches(3):
        jstate, _ = jstep(jstate, tuple(jax.device_put(a, sharding)
                                        for a in b))
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path),
                      init_fn=lambda: jstate)
    jsv.maybe_save(jstate, force=True)
    jsv.close()
    fresh = _port_frozen_state(params)
    sv = Supervisor(is_chief=True, logdir=str(tmp_path),
                    init_fn=lambda: fresh)
    restored = sv.prepare_or_wait_for_state()
    sv.close()
    _assert_same(restored, jstate)
    # The restored slots drive the next step as JAX's do.
    b = _batches(1, seed=9)[0]
    restored, _ = tsync.build_sync_train_step(_port_loss_fn)(restored, b)
    jstate, _ = jstep(jstate, tuple(jax.device_put(a, sharding) for a in b))
    got = tmlp.params_to_jax(restored.model.state_dict())
    np.testing.assert_allclose(got["sm"]["kernel"],
                               np.asarray(jstate.params["sm"]["kernel"]),
                               atol=1e-6)
