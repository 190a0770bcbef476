"""The port's data axis through its CLI and feed
(``distributed_tensorflow_tpu_torch/train.py --dcn_data_parallel
--sharded_feed`` with ``DTF_TORCH_CPU_DEVICES`` data positions a worker), ``training/loop.process_feed``,
``cluster/server.py``'s slice groups), against the JAX package's
behaviour.

- Two gloo workers on the CPU, two data rows each: with
  ``--dcn_data_parallel=2`` (JAX ``tests/test_config_ladder.py::
  test_dcn_data_parallel_flag``), and with ``--sharded_feed=false`` /
  ``true``: bit-equal losses and parameters across the workers, JAX's log
  lines; a ``--sharded_feed=false`` run trains on the whole global batch,
  so its losses equal one worker's with the four rows in one process
  (within the 1e-6 the printed losses carry; the sums' order differs).
- The loop's fallbacks and their lines (JAX ``tests/test_sharded_feed.py::
  test_sharded_feed_falls_back_when_data_axis_cannot_split`` and the
  conditions beside it).
- A data=2 x model=2 run's checkpoint evaluated by the JAX CLI (and
  restored by the port's serving CLI loader and ``--mode=generate``), and a JAX
  tensor-parallel run's by the port's on data=2 x model=2: the restored
  step, and the same test accuracy (the same parameters on the same
  split, fp32) within 1e-3: four of the split's 3968 tokens, whose
  argmax a near-tie at this barely trained model may flip between the
  packages' attention sums.
"""

import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.server import (
    Server, slice_group_ranks)
from distributed_tensorflow_tpu_torch.data import datasets as tdata
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel.mesh import CPU_DEVICES_ENV
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.loop import run_training_loop
from distributed_tensorflow_tpu_torch.training.state import TrainState

from helpers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(task, ports, logdir, *extra, cpus=1):
    """A worker whose CPU counts as ``cpus`` devices (its data rows)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **{CPU_DEVICES_ENV: str(cpus)})
    workers = ",".join(f"localhost:{p}" for p in ports)
    cmd = [sys.executable, "-m", "distributed_tensorflow_tpu_torch.train",
           "--device=cpu", "--job_name=worker", f"--task_index={task}",
           "--ps_hosts=", f"--worker_hosts={workers}",
           "--data_dir=/nonexistent", "--train_steps=12", "--batch_size=32",
           "--hidden_units=16", "--learning_rate=0.1", "--log_every=1",
           "--validation_every=0", "--save_interval_steps=1000",
           f"--logdir={logdir}", "--sync_replicas=true", *extra]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail(f"process timed out; output:\n{out}")
    assert proc.returncode == 0, out
    return out


def _losses(out):
    return [float(x) for x in re.findall(r"traing step \d+ \(global "
                                         r"step:\d+\) loss (\S+)", out)]


def _two_workers(tmp_path, *extra):
    """Two workers of two data rows each; returns their outputs, after
    checking the bit-equal losses and parameters JAX's lockstep gives."""
    ports = [free_port(), free_port()]
    procs = [_launch(t, ports, str(tmp_path / "run"), *extra, cpus=2)
             for t in (1, 0)]
    out1, out0 = (_finish(p) for p in procs)
    for out, task in ((out0, 0), (out1, 1)):
        assert f"Worker {task}: test accuracy" in out
        assert ("(data=2, seq=1, model=1): 2 positions on 1 distinct "
                "device(s) cpu, cpu") in out
        assert "over gloo (cpu tensors)" in out
    assert _losses(out0) == _losses(out1) and len(_losses(out0)) == 11
    digests = [re.search(r"parameter digest (\w+)", o)[1]
               for o in (out0, out1)]
    assert digests[0] == digests[1]
    return out0, out1


def test_dcn_data_parallel_two_workers(tmp_path):
    """--dcn_data_parallel=2 over two workers of two rows: each worker a
    DCN slice (the mean over its rows, then across the slices)."""
    out0, out1 = _two_workers(tmp_path, "--dcn_data_parallel=2")
    assert "Worker 0: sharded feed — this process loads 16/32 examples " \
           "per step" in out0
    # The loss falls: the run trains.
    losses = _losses(out0)
    assert losses[-1] < losses[0]


def test_slice_groups_of_the_dcn_factor():
    """Slices of several workers get a group each, and so does each place
    across the slices; a worker a slice needs one all-reduce only."""
    assert slice_group_ranks(2, 2) is None
    assert slice_group_ranks(4, 1) is None
    assert slice_group_ranks(4, 2) == ([[0, 1], [2, 3]], [[0, 2], [1, 3]])
    assert slice_group_ranks(6, 4) is None


@pytest.mark.parametrize("sharded", ["true", "false"])
def test_sharded_feed_true_and_false(tmp_path, sharded):
    out0, out1 = _two_workers(tmp_path, f"--sharded_feed={sharded}")
    line = "sharded feed — this process loads 16/32 examples per step"
    assert (line in out0) == (sharded == "true")
    assert (line in out1) == (sharded == "true")
    if sharded == "true":
        return
    # Without the sharded feed each worker loads the whole global batch
    # and trains on its half: one worker with the four rows in one
    # process trains on the same batches.
    one = _finish(_launch(0, [free_port()], str(tmp_path / "one"),
                          cpus=4))
    assert "sharded feed" not in one
    np.testing.assert_allclose(_losses(out0), _losses(one), atol=2e-6,
                               rtol=0)


# ---------------------------------------------------------- fallbacks


def _mlp_state():
    model = tmlp.MnistMLP(8, device="cpu")
    return TrainState.create(model, topt.make_optimizer("sgd", 0.1),
                             params_to_tree=tmlp.params_to_jax,
                             params_from_tree=tmlp.params_from_jax)


def _loss(model, batch):
    x, y = (torch.as_tensor(np.asarray(a)) for a in batch)
    logits = model(x)
    return tmlp.cross_entropy_loss(logits, y), {
        "accuracy": tmlp.accuracy(logits, y)}


class _NoShard:
    """A train split without ``shard()``."""

    def __init__(self, split):
        self._split = split

    def next_batch(self, n):
        return self._split.next_batch(n)


@pytest.mark.parametrize("case,line", [
    ("seq", "sharded feed unavailable with a seq-sharded batch layout — "
            "feeding full batches"),
    ("batch", "sharded feed needs batch_size (33) divisible by process "
              "count (2) — feeding full batches"),
    ("split", "train split _NoShard has no shard() — feeding full "
              "batches"),
])
def test_sharded_feed_falls_back_with_jax_lines(case, line):
    """A (mocked) second process: the feed cannot shard, so the loop
    prints JAX's fallback line and feeds full batches."""
    datasets = tdata.read_data_sets("/nonexistent")
    mesh = tmesh.create_mesh(data=1, seq=2 if case == "seq" else 1,
                             devices=["cpu"] * (2 if case == "seq" else 1))
    if case == "split":
        datasets.train = _NoShard(datasets.train)
    lines = []
    _, result = run_training_loop(
        state=_mlp_state(), train_step=tsync.build_sync_train_step(_loss),
        datasets=datasets, batch_size=33 if case == "batch" else 32,
        train_steps=3, eval_fn=lambda st, split: 0.0,
        device=torch.device("cpu"), validation_every=0, log_every=0,
        prefetch=0, print_fn=lines.append, sharded_feed=True, mesh=mesh,
        process_count=2, process_index=1)
    out = "\n".join(lines)
    assert f"Worker 0: {line}" in out, out
    assert "this process loads" not in out
    assert result.final_global_step >= 3


# ----------------------------------------------------- checkpoints


GPT = ("--model=gpt_mini", "--sync_replicas=true", "--tensor_parallel=2",
       "--bert_seq_len=32", "--batch_size=8", "--train_steps=4",
       "--log_every=2", "--validation_every=0", "--save_interval_steps=2")


def _port_cli(logdir, *flags):
    """The port's CLI with the CPU as four devices (data=2 x model=2)."""
    with mock.patch.dict(os.environ, {CPU_DEVICES_ENV: "4"}):
        return ttrain.app.run(ttrain.main, [
            "--job_name=worker", "--task_index=0",
            "--worker_hosts=localhost:0", "--ps_hosts=", "--device=cpu",
            f"--logdir={logdir}", *GPT, *flags])


def _jax_cli(logdir, *flags):
    from distributed_tensorflow_tpu import train as jtrain
    jtrain.FLAGS.parse([
        "--job_name=worker", "--task_index=0", "--worker_hosts=localhost:0",
        "--ps_hosts=localhost:0", "--platform=cpu", f"--logdir={logdir}",
        *GPT, *flags])
    return jtrain.main([])


@pytest.fixture
def standalone(monkeypatch):
    """Both CLIs in this process without a coordination service or a
    process group."""
    from helpers import patch_standalone_server
    patch_standalone_server(monkeypatch)
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def test_data2_model2_checkpoints_cross_the_packages(tmp_path, standalone,
                                                     capsys):
    # Port (data=2 x model=2 in one process) -> the JAX CLI's eval
    # (data=4 x model=2 over the 8 CPU devices).
    port = _port_cli(tmp_path / "port")
    assert "(data=2, seq=1, model=2): 4 positions" in capsys.readouterr().out
    jeval = _jax_cli(tmp_path / "port", "--mode=eval")
    assert jeval["global_step"] == port.final_global_step
    assert abs(jeval["test_accuracy"] - port.test_accuracy) <= 1e-3
    # The serving CLI's restore and --mode=generate take it as it is: the
    # unsharded tree.
    from distributed_tensorflow_tpu_torch.tools.serve import (
        load_gpt_serving_model)
    cfg, tree, step = load_gpt_serving_model(tmp_path / "port" / "gpt_mini")
    assert step == port.final_global_step
    assert tuple(tree["layer0"]["qkv"]["kernel"].shape) == (
        cfg.hidden_size, 3, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
    tokens = ttrain.app.run(ttrain.main, [
        "--mode=generate", "--model=gpt_mini", f"--logdir={tmp_path}/port",
        "--device=cpu", "--gen_tokens=4", "--gen_prompt=1,2,3"])
    assert np.asarray(tokens).reshape(-1).tolist()[:3] == [1, 2, 3]
    assert np.asarray(tokens).shape[-1] == 3 + 4       # prompt, then new
    # JAX -> the port's eval on data=2 x model=2.
    jrun = _jax_cli(tmp_path / "jax")
    teval = _port_cli(tmp_path / "jax", "--mode=eval")
    assert teval["global_step"] == jrun.final_global_step
    assert abs(teval["test_accuracy"] - jrun.test_accuracy) <= 1e-3
