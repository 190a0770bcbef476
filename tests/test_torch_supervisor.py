"""The port's supervisor (init-or-recover, checkpoints, the chief's init
signal, retention, the corrupt-checkpoint fallback), mirroring
``tests/test_supervisor.py``, and checkpoints across the two packages: a
port run's checkpoint restored by the JAX supervisor, and a JAX run's by
the port's ``--mode=eval``, give the same test accuracy.

The JAX side runs as its own tests run it (the MLP replicated over the
8-device CPU mesh of ``tests/conftest.py``, orbax's default OCDBT layout,
which the port reads through ``tensorstore``).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data.datasets import read_data_sets as jread
from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.parallel.sharding import replicate_tree
from distributed_tensorflow_tpu.training.loop import make_eval_fn as jeval
from distributed_tensorflow_tpu.training.state import (TrainState as JState,
                                                       gradient_descent)
from distributed_tensorflow_tpu.training.supervisor import (
    Supervisor as JSupervisor)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.coordination import (
    CoordinationClient, CoordinationServer)
from distributed_tensorflow_tpu_torch.models import registry
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.tools import checkpoint_io
from distributed_tensorflow_tpu_torch.training.supervisor import (
    INIT_DONE_KEY, CheckpointCorruptionError, Supervisor)
from distributed_tensorflow_tpu_torch.utils import faults

HIDDEN = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def init_fn():
    return registry.build_mnist_mlp(HIDDEN, 0.1, device="cpu").state


def bump(state, by=1.0, steps=41):
    """Mutate the weights and the step, so a restore is observable."""
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(by)
    state.global_step += steps
    return state


def weights(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def test_chief_initializes_fresh(tmp_path):
    sv = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn)
    state = sv.prepare_or_wait_for_state()
    assert state.global_step == 1
    assert sv.latest_step() is None
    sv.close()


def test_checkpoint_save_restore(tmp_path):
    sv = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn,
                    save_interval_steps=1)
    state = bump(sv.prepare_or_wait_for_state())
    assert sv.maybe_save(state, force=True)
    sv.close()
    assert checkpoint_io.verify_checkpoint(
        str(tmp_path / "checkpoints" / "42"))[0] == "valid"
    sv2 = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn)
    restored = sv2.prepare_or_wait_for_state()
    assert restored.global_step == 42
    for name, p in weights(init_fn()).items():
        torch.testing.assert_close(weights(restored)[name], p + 1.0)
    sv2.close()


def test_save_interval_gating(tmp_path):
    sv = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn,
                    save_interval_steps=100)
    state = sv.prepare_or_wait_for_state()
    assert sv.maybe_save(state, force=True)     # step 1 saved
    assert not sv.maybe_save(state)             # within interval
    state.global_step += 100
    assert sv.maybe_save(state)                 # interval elapsed
    sv.close()
    assert sv.all_steps() == [1, 101]


def test_non_chief_never_saves(tmp_path):
    sv = Supervisor(is_chief=False, logdir=str(tmp_path), init_fn=init_fn)
    assert not sv.maybe_save(sv.init_fn(), force=True)
    sv.close()
    assert sv.latest_step() is None


def test_non_chief_waits_for_chief_signal(tmp_path):
    """prepare_or_wait_for_session parity (distributed.py:121-125): the
    non-chief polls the coordination service until the chief signals, then
    restores exactly the signaled step."""
    seed = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn)
    seed.maybe_save(bump(seed.prepare_or_wait_for_state(), steps=9),
                    force=True)
    seed.close()
    srv = CoordinationServer(port=0, num_tasks=2, heartbeat_timeout=10.0)
    srv.start()
    try:
        chief_client = CoordinationClient("127.0.0.1", srv.port, 0)
        worker_client = CoordinationClient("127.0.0.1", srv.port, 1)
        order = []

        def chief_path():
            time.sleep(0.5)
            sv = Supervisor(is_chief=True, logdir=str(tmp_path),
                            init_fn=init_fn,
                            coordination_client=chief_client)
            sv.prepare_or_wait_for_state()
            order.append(("chief_done", time.monotonic()))
            sv.close()

        t = threading.Thread(target=chief_path)
        t.start()
        sv_w = Supervisor(is_chief=False, logdir=str(tmp_path),
                          init_fn=init_fn, recovery_wait_secs=0.1,
                          coordination_client=worker_client)
        state = sv_w.prepare_or_wait_for_state(timeout=30.0)
        order.append(("worker_done", time.monotonic()))
        t.join()
        assert state.global_step == 10
        assert worker_client.kv_get(INIT_DONE_KEY) == "10"
        names = [n for n, _ in sorted(order, key=lambda kv: kv[1])]
        assert names == ["chief_done", "worker_done"]
        # A signal of 1 (fresh init) ignores the stale checkpoint.
        chief_client.kv_set(INIT_DONE_KEY, "1")
        assert sv_w.prepare_or_wait_for_state().global_step == 1
        # A signaled step that is not on disk is an error, not a fresh init.
        chief_client.kv_set(INIT_DONE_KEY, "5")
        with pytest.raises(CheckpointCorruptionError, match="not on disk"):
            sv_w._restore_or_init(target_step=5)
        sv_w.close()
    finally:
        srv.stop()


def test_restore_for_rejoin_adopts_the_latest_durable_step(tmp_path):
    """A non-chief re-admitted mid-run drops the weights it holds and
    restores the step the chief last signaled (re-published at every
    durable save)."""
    srv = CoordinationServer(port=0, num_tasks=2, heartbeat_timeout=10.0)
    srv.start()
    try:
        chief = Supervisor(is_chief=True, logdir=str(tmp_path),
                           init_fn=init_fn, save_interval_steps=5,
                           coordination_client=CoordinationClient(
                               "127.0.0.1", srv.port, 0))
        state = chief.prepare_or_wait_for_state()
        worker = Supervisor(is_chief=False, logdir=str(tmp_path),
                            init_fn=init_fn, recovery_wait_secs=0.05,
                            coordination_client=CoordinationClient(
                                "127.0.0.1", srv.port, 1))
        stale = worker.prepare_or_wait_for_state()
        assert stale.global_step == 1
        for _ in range(2):
            chief.maybe_save(bump(state, by=0.25, steps=5))
        chief.wait_until_finished()            # step 11 is durable
        rejoined = worker.restore_for_rejoin(timeout=10.0)
        assert rejoined.global_step == 11
        for name, p in weights(state).items():
            torch.testing.assert_close(weights(rejoined)[name], p)
        chief.close()
        worker.close()
    finally:
        srv.stop()


def test_corrupt_newest_checkpoint_falls_back_and_retention(tmp_path):
    sv = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn,
                    save_interval_steps=1, max_to_keep=2)
    state = sv.prepare_or_wait_for_state()
    for _ in range(4):
        bump(state, by=0.5, steps=1)
        assert sv.maybe_save(state)
    sv.close()
    assert sv.all_steps() == [4, 5]             # retention: the last two
    step, _ = faults.truncate_newest_checkpoint(str(tmp_path))
    assert step == 5
    sv2 = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn)
    restored = sv2.prepare_or_wait_for_state()
    assert restored.global_step == 4
    actions = [e["action"] for e in sv2.recovery_events]
    assert actions == ["checkpoint_corrupt", "checkpoint_fallback",
                       "corrupt_checkpoint_deleted"]
    assert sv2.all_steps() == [4]
    # A corrupt chief-signaled step raises instead of restoring another.
    sv2.maybe_save(bump(restored, steps=3), force=True)
    sv2.close()
    faults.truncate_newest_checkpoint(str(tmp_path))
    with pytest.raises(CheckpointCorruptionError):
        sv2._restore_or_init(target_step=7)


def test_retention_never_rotates_out_the_newest_valid_step(tmp_path):
    sv = Supervisor(is_chief=True, logdir=str(tmp_path), init_fn=init_fn,
                    save_interval_steps=1, max_to_keep=1)
    state = sv.prepare_or_wait_for_state()
    sv.maybe_save(bump(state, steps=1))
    sv.wait_until_finished()
    assert sv.all_steps() == [2]
    faults.truncate_newest_checkpoint(str(tmp_path))
    sv.maybe_save(bump(state, steps=1))
    sv.close()
    # Step 2 is corrupt: step 3 is the newest valid one and is kept; the
    # corrupt step 2 went with the rotation.
    assert sv.all_steps() == [3]
    faults.truncate_newest_checkpoint(str(tmp_path))
    sv.maybe_save(bump(state, steps=1), force=True)
    sv.close()
    # Step 3 corrupt now too: rotation keeps step 4 (newest, valid).
    assert sv.all_steps() == [4]


# ------------------------------------------------- across the packages


def jax_state(mesh):
    model = jmlp.MnistMLP(hidden_units=HIDDEN)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 784)))["params"]
    apply_fn = lambda p, x: model.apply({"params": p}, x)
    state = JState.create(apply_fn, params, gradient_descent(0.1))
    return state.replace(
        params=replicate_tree(mesh, state.params),
        opt_state=replicate_tree(mesh, state.opt_state),
        global_step=replicate_tree(mesh, state.global_step)), apply_fn


def test_a_port_checkpoint_restores_in_the_jax_supervisor(tmp_path):
    data = jread("/nonexistent")
    bundle = registry.build_mnist_mlp(HIDDEN, 0.1, device="cpu")
    sv = Supervisor(is_chief=True, logdir=str(tmp_path),
                    init_fn=lambda: bundle.state)
    state = sv.prepare_or_wait_for_state()
    step = tsync.build_sync_train_step(bundle.loss_fn)
    for _ in range(5):
        state, _ = step(state, data.train.next_batch(32))
    sv.maybe_save(state, force=True)
    sv.close()
    port_acc = bundle.make_eval_fn()(state, data.test)

    mesh = jmesh.data_parallel_mesh()
    template, apply_fn = jax_state(mesh)
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path),
                      init_fn=lambda: template)
    restored = jsv.prepare_or_wait_for_state()
    jsv.close()
    assert int(restored.global_step) == 6
    for name, t in state.model.state_dict().items():
        layer, leaf = name.split(".")
        np.testing.assert_array_equal(
            np.asarray(restored.params[layer][leaf]), t.numpy())
    assert jeval(apply_fn)(restored, data.test) == port_acc
    assert 0.2 < port_acc < 1.0


def standalone_server(monkeypatch):
    """The port's Server without the coordination service or a process
    group (single-process CLI runs)."""
    from distributed_tensorflow_tpu_torch.cluster.server import Server
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def test_a_jax_checkpoint_evaluates_in_the_port_cli(tmp_path, capsys,
                                                    monkeypatch):
    standalone_server(monkeypatch)
    data = jread("/nonexistent")
    mesh = jmesh.data_parallel_mesh()
    state, apply_fn = jax_state(mesh)
    loss_fn = lambda p, b: (jmlp.cross_entropy_loss(apply_fn(p, b[0]), b[1]),
                            {})
    jstep = jsync.build_sync_train_step(mesh, loss_fn, donate=False)
    sharding = jmesh.data_sharded(mesh)
    for _ in range(5):
        x, y = data.train.next_batch(32)
        state, _ = jstep(state, (jax.device_put(x, sharding),
                                 jax.device_put(y, sharding)))
    jsv = JSupervisor(is_chief=True,
                      logdir=str(tmp_path / "run" / "mnist_mlp"),
                      init_fn=lambda: state)
    jsv.prepare_or_wait_for_state()
    jsv.maybe_save(state, force=True)
    jsv.close()
    want = jeval(apply_fn)(state, data.test)
    result = ttrain.app.run(ttrain.main, [
        "--mode=eval", "--job_name=worker", "--task_index=0",
        "--worker_hosts=localhost:0", "--device=cpu",
        "--data_dir=/nonexistent", f"--hidden_units={HIDDEN}",
        f"--logdir={tmp_path / 'run'}"])
    assert result["global_step"] == 6
    assert result["test_accuracy"] == want
    assert f"Worker 0: test accuracy {want:g}" in capsys.readouterr().out
