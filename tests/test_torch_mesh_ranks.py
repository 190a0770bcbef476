"""The port's global mesh across worker processes
(distributed_tensorflow_tpu_torch/parallel/mesh.global_mesh,
cluster/server.form_mesh_groups, parallel/transport.py, the ring over
ranks in parallel/ring.py, the pipeline's stages over ranks in
parallel/pipeline.py and models/gpt.PipelinedGptLM, train.py's layout).

- The layout: JAX's ``create_mesh`` reshape over ``num_workers x local
  positions`` in process-major order (held to the JAX package's
  ``create_mesh`` on the 8 fake CPU devices, whose process-major order is
  their id order), each rank's coordinates and lines, ``data=-1`` over
  the global count, and the layouts ROADMAP.md's 8f holds raising.
- Two CPU ranks over gloo, spawned once for the test run (three two-rank
  launches side by side, each beside the same layout in one process,
  ``DTF_TORCH_CPU_DEVICES=2``): gpt_mini in fp32 with SGD (the weights
  show the gradients) through the trainer CLI with ``--pipeline_parallel=2`` across the two workers (1F1B and GPipe)
  and ``--sequence_parallel=2`` with the ring across them.  Both ranks
  log the same losses and gradient norms to the bit; against the
  one-process run the losses agree within 1e-6 (relative) and the
  chief's checkpoint tree within 1e-6 (absolute): the pipe's gradient
  norm sums its squares per rank and then over the pipe group, the
  ring's gradient sums its seq parts over the group, so the sums change
  order.  1F1B's first loss, the same slots and sums on both sides, is
  bit-equal."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.tools.checkpoint_io import restore_raw

from helpers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
STEPS = 5


# ------------------------------------------------------------- the layout


@pytest.mark.parametrize("workers,local,sizes", [
    (2, 1, dict(pipe=2)), (4, 1, dict(seq=2, pipe=2)),
    (2, 2, dict(seq=2, model=2)), (2, 4, dict(pipe=2)),
    (4, 2, dict(seq=2))])
def test_global_mesh_is_jax_reshape_over_every_process(workers, local,
                                                       sizes):
    """Each rank's positions sit where JAX's ``create_mesh`` puts its
    devices (ids in process-major order), its coordinates are theirs,
    and the lines along each axis are the ranks that hold that line's
    positions."""
    n = workers * local
    jm = jmesh.create_mesh(devices=jax.devices()[:n], **sizes)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(workers):
        mesh = tmesh.global_mesh(num_workers=workers, rank=rank,
                                 positions=[CPU] * local, **sizes)
        ranks = mesh.ranks
        assert ranks.shape == dict(jm.shape)
        where = np.argwhere((ids // local) == rank)
        for i, axis in enumerate(tmesh.AXIS_ORDER):
            assert ranks.coords[axis] == where[:, i].min()
            held = len(set(where[:, i]))
            assert mesh.shape[axis] == held
            crossing = axis in ranks.cross
            assert crossing == (axis != "data" and held == 1
                                and jm.shape[axis] > 1)
            line = ranks.axis_ranks(axis)
            index = list(where[0])
            index[i] = slice(None)
            want = []
            for x in ids[tuple(index)] // local:
                if int(x) not in want:
                    want.append(int(x))
            assert line == want
        assert sorted(r for l in ranks.grad_lines() for r in l) == list(
            range(workers))
        assert ranks.seq_parts == (jm.shape["seq"] if "seq" in ranks.cross
                                   else 1)


def test_two_one_card_workers_with_pipe2_are_one_pipeline():
    # data=-1 resolves over the global count, as JAX's over
    # jax.devices(): data=1 x pipe=2, not two private pipelines.
    for rank in range(2):
        mesh = tmesh.global_mesh(num_workers=2, rank=rank, positions=[CPU],
                                 pipe=2)
        assert mesh.global_shape["data"] == 1
        assert mesh.shape["pipe"] == 1 and mesh.crosses("pipe")
        assert mesh.ranks.coords["pipe"] == rank
        assert mesh.ranks.grad_lines() == [[0], [1]]
    # Where the axes fit in a worker they stay inside it (slice 8d).
    mesh = tmesh.global_mesh(num_workers=2, rank=1, positions=[CPU] * 4,
                             pipe=2)
    assert mesh.shape == {"data": 2, "seq": 1, "pipe": 2, "expert": 1,
                          "model": 1}
    assert not mesh.ranks.cross and mesh.global_shape["data"] == 4


def test_a_data_row_copy_shares_the_rank_layout():
    """A worker's data rows deep-copy the model, whose blocks hold the
    mesh: the copies share its rank layout and process groups (a process
    group cannot be copied), as each row is placed on its own row mesh."""
    import copy
    import threading
    from distributed_tensorflow_tpu_torch.models import gpt as tgpt
    from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
    from distributed_tensorflow_tpu_torch.training import optimizers as topt
    from distributed_tensorflow_tpu_torch.training.state import TrainState
    mesh = tmesh.global_mesh(num_workers=2, rank=0, positions=[CPU] * 2)
    mesh.ranks.groups["grad"] = threading.Lock()     # cannot be copied
    cfg = tgpt.GptConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, intermediate_size=64, max_position=32,
                         dtype="float32", attention_backend="ring")
    model = tgpt.GptLM(cfg, device="cpu", mesh=mesh)
    assert copy.deepcopy(model).layers[0].mesh.ranks is mesh.ranks
    state = tsh.replicate_state(mesh, TrainState.create(
        model, topt.make_optimizer("sgd", 0.1)))
    assert len(state.rows) == 1
    assert state.rows[0].layers[0].mesh.ranks is mesh.ranks


@pytest.mark.parametrize("workers,local,sizes,axis", [
    (2, 1, dict(model=2), "model"), (2, 1, dict(expert=2), "expert"),
    (4, 2, dict(pipe=4), "split"), (4, 1, dict(pipe=2, model=2), "model")])
def test_axes_not_ported_across_processes_raise(workers, local, sizes, axis):
    with pytest.raises(NotImplementedError, match="ROADMAP.*8f"):
        tmesh.global_mesh(num_workers=workers, rank=0,
                          positions=[CPU] * local, **sizes)


@pytest.mark.parametrize("flags", [
    ("--tensor_parallel=2",),
    ("--sequence_parallel=2", "--attention_backend=ulysses"),
    ("--model=bert_moe", "--expert_parallel=2"),
])
def test_cli_layouts_of_8f_raise(tmp_path, flags):
    """Two sync workers of one CPU each: an axis of 8f across them raises
    at the layout, before any process group forms."""
    args = ["--job_name=worker", "--task_index=0", "--device=cpu",
            f"--worker_hosts=localhost:{free_port()},localhost:"
            f"{free_port()}", "--ps_hosts=", "--sync_replicas=true",
            "--model=gpt_mini", "--bert_seq_len=32", "--batch_size=8",
            f"--logdir={tmp_path}", *flags]
    with pytest.raises(NotImplementedError, match="ROADMAP.*8f"):
        ttrain.app.run(ttrain.main, args)


# ------------------------------------------------- two ranks over gloo


CASES = {
    "pipe_1f1b": ("--pipeline_parallel=2", "--pipeline_schedule=1f1b",
                  "--pipeline_microbatches=4"),
    "pipe_gpipe": ("--pipeline_parallel=2", "--pipeline_schedule=gpipe",
                   "--pipeline_microbatches=4"),
    "seq_ring": ("--sequence_parallel=2", "--attention_backend=ring"),
}
NAMESPACE = {"pipe_1f1b": "gpt_mini_pp2", "pipe_gpipe": "gpt_mini_pp2",
             "seq_ring": "gpt_mini"}


def _args(logdir, hosts, task, flags):
    return [sys.executable, "-m", "distributed_tensorflow_tpu_torch.train",
            "--job_name=worker", f"--task_index={task}",
            f"--worker_hosts={hosts}", "--ps_hosts=", "--device=cpu",
            "--sync_replicas=true", "--model=gpt_mini",
            "--bert_dtype=float32", "--fused_layer_norm",
            "--bert_seq_len=32", "--batch_size=8",
            f"--train_steps={STEPS + 1}", "--log_every=1",
            "--validation_every=0", "--log_grad_norm", "--optimizer=sgd",
            "--learning_rate=0.1",
            "--save_interval_steps=1000", f"--logdir={logdir}",
            f"--metrics_file={logdir}/m.jsonl", *flags]


def _spawn(tmp) -> dict:
    procs = {}
    for case, flags in CASES.items():
        hosts = f"localhost:{free_port()},localhost:{free_port()}"
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs[case] = [subprocess.Popen(
            _args(tmp / case, hosts, t, flags), env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for t in range(2)]
        procs[case].append(subprocess.Popen(
            _args(tmp / f"{case}_one", f"localhost:{free_port()}", 0, flags),
            env=dict(env, DTF_TORCH_CPU_DEVICES="2"), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    out = {}
    for case, ps in procs.items():
        out[case] = []
        for p in ps:
            text, _ = p.communicate(timeout=300)
            out[case].append((p.returncode, text))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case as two gloo ranks and as one process of two CPU
    positions, all started together, once for the whole test run (the
    test processes share it under a file lock); ``{case: (outputs,
    logdir)}`` with ``outputs`` the two ranks' then the one process's."""
    from filelock import FileLock
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    tmp = root / "mesh_ranks"
    record = tmp / "runs.json"
    with FileLock(str(tmp) + ".lock"):
        if not record.exists():
            tmp.mkdir(exist_ok=True)
            record.write_text(json.dumps(_spawn(tmp)))
    out = {}
    for case, results in json.loads(record.read_text()).items():
        for rc, text in results:
            assert rc == 0, text
        out[case] = ([text for _, text in results], tmp / case)
    return out


def _steps(path):
    return [r for r in map(json.loads, open(path))
            if r.get("kind") == "train_step"]


@pytest.mark.parametrize("case", list(CASES))
def test_the_axis_crosses_the_two_workers(runs, case):
    texts, _ = runs[case]
    axis = case.split("_")[0]
    for task in range(2):
        assert (f"Worker {task}: process group rank {task} of 2 over gloo"
                in texts[task])
        assert (f"across the workers: {axis}=2 (this worker {axis} {task}, "
                "ranks [0, 1]), data=1" in texts[task]), texts[task]
        assert (f"Worker {task}: {axis} hops gloo over ranks [0, 1]"
                in texts[task])
    assert "across the workers" not in texts[2]
    assert "2 positions on 1 distinct device(s) cpu, cpu" in texts[2]


@pytest.mark.parametrize("case", list(CASES))
def test_both_ranks_log_the_same_losses_and_norms(runs, case):
    _, logdir = runs[case]
    r0, r1 = (_steps(f"{logdir}/m.jsonl.task{t}") for t in range(2))
    assert len(r0) == STEPS
    for a, b in zip(r0, r1):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert np.isfinite(a["loss"])


@pytest.mark.parametrize("case", list(CASES))
def test_the_two_ranks_match_one_process(runs, case):
    _, logdir = runs[case]
    ranks = _steps(f"{logdir}/m.jsonl.task0")
    one = _steps(f"{logdir}_one/m.jsonl")
    assert [r["step"] for r in ranks] == [r["step"] for r in one]
    for a, b in zip(ranks, one):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-5)
    if case == "pipe_1f1b":
        # The same slots, the same sums: the first loss to the bit (one
        # process's GPipe takes autograd through the ticks and the loss
        # over the whole batch at once).
        assert ranks[0]["loss"] == one[0]["loss"]


@pytest.mark.parametrize("case", list(CASES))
def test_the_chief_writes_the_one_process_tree(runs, case):
    _, logdir = runs[case]
    got, step = restore_raw(str(logdir / NAMESPACE[case]))[:2]
    want, want_step = restore_raw(
        str(logdir.parent / f"{case}_one" / NAMESPACE[case]))[:2]
    assert step == want_step == STEPS + 1
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), rtol=0, atol=1e-6), got, want)
