"""The port's trainer CLI (``train.py --mode=train|eval``, sync mode),
mirroring ``tests/test_train_e2e.py`` (``main()`` in this process, the
reference's printed lines) and three cases of
``tests/test_multiprocess.py`` (:73, :128, :188) as processes on
localhost: a PS and two workers with the real gloo all-reduce; a
SIGKILLed worker dropped from the replica mask under
``--replicas_to_aggregate=1``, run without a process group as the JAX test
runs its workers; and a chief restart that recovers from its checkpoint.
Tiny widths (hidden 16-32) on the CPU, torch on one thread.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading

import pytest
import torch

from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.server import Server
from distributed_tensorflow_tpu_torch.utils.summary import iter_events
from helpers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def standalone(monkeypatch):
    """Single-process CLI runs: no coordination service, no process
    group (the port's counterpart of ``helpers.patch_standalone_server``)."""
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def run_main(tmp_path, *flags):
    return ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--data_dir=/nonexistent",
        "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
        "--train_steps=30", "--batch_size=64", "--hidden_units=32",
        "--learning_rate=0.1", "--log_every=10", "--device=cpu",
        f"--logdir={tmp_path}/logdir", *flags])


def test_sync_training_prints_the_reference_lines(tmp_path, standalone,
                                                  capsys):
    result = run_main(tmp_path, "--sync_replicas=true", "--log_sharding")
    out = capsys.readouterr().out
    for line in ("Worker 0: Initailizing session...",
                 "Worker 0: param hid/kernel (784, 32) -> replicated on cpu",
                 "Worker 0: Session initialization  complete.",
                 "Worker 0: validation accuracy",
                 "Worker 0: traing step 10 (global step:11) loss",
                 "Training elapsed time:", "Worker 0: test accuracy",
                 "Worker 0: parameter digest"):
        assert line in out
    assert result.final_global_step == 30 and result.local_steps == 29
    assert result.test_accuracy > 0.5
    steps = sorted(int(d) for d in os.listdir(
        tmp_path / "logdir" / "mnist_mlp" / "checkpoints"))
    assert steps == [30]


def test_resume_and_eval_mode(tmp_path, standalone, capsys):
    run_main(tmp_path, "--sync_replicas=true", "--save_interval_steps=10")
    first = capsys.readouterr().out
    result = run_main(tmp_path, "--sync_replicas=true", "--train_steps=60",
                      "--save_interval_steps=10")
    assert result.local_steps == 30 and result.final_global_step == 60
    assert "(global step:40)" in capsys.readouterr().out
    evaluated = run_main(tmp_path, "--mode=eval")
    assert evaluated["global_step"] == 60
    assert evaluated["test_accuracy"] == result.test_accuracy
    out = capsys.readouterr().out
    assert "Worker 0: restored global step 60" in out
    assert "Worker 0: validation accuracy" in out
    assert "test accuracy" in first
    # A checkpoint of other widths is a flag problem, and says so.
    with pytest.raises(ValueError, match="could not restore"):
        run_main(tmp_path, "--mode=eval", "--hidden_units=16")


def test_eval_mode_without_a_checkpoint(tmp_path, standalone, capsys):
    result = run_main(tmp_path, "--mode=eval")
    assert result["global_step"] == 1
    assert "WARNING: no checkpoint found" in capsys.readouterr().out


@pytest.mark.parametrize("flags,local_steps,global_step", [
    (("--steps_per_call=4", "--log_every=5", "--validation_every=8"), 32,
     33),
    (("--grad_accum_steps=4",), 29, 30),
    (("--ema_decay=0.9", "--log_grad_norm"), 29, 30),
    (("--optimizer=momentum", "--lr_schedule=cosine", "--warmup_steps=2",
      "--grad_clip_norm=1.0"), 29, 30),
    (("--feed_dtype=uint8", "--prefetch=0"), 29, 30),
])
def test_step_variants(tmp_path, standalone, capsys, flags, local_steps,
                       global_step):
    result = run_main(tmp_path, "--sync_replicas=true", *flags)
    assert result.local_steps == local_steps
    assert result.final_global_step == global_step
    assert result.test_accuracy > 0.5
    if "--steps_per_call=4" in flags:
        assert ("rounding log_every 5->8, validation_every 8->8"
                in capsys.readouterr().out)
    # The checkpoint restores into the same flags (optax's slot layout).
    assert run_main(tmp_path, "--mode=eval", *flags)["global_step"] == \
        global_step


def test_graceful_shutdown_checkpoints_and_skips_the_final_eval(
        tmp_path, standalone, monkeypatch, capsys):
    """The shutdown latch set as the loop starts (a SIGTERM's effect):
    the loop exits after its first step, interrupted, with a checkpoint
    at that step and no final eval."""
    from distributed_tensorflow_tpu_torch.training.preemption import (
        ShutdownSignal)
    orig_enter = ShutdownSignal.__enter__

    def trigger_on_enter(self):
        self.trigger()
        return orig_enter(self)
    monkeypatch.setattr(ShutdownSignal, "__enter__", trigger_on_enter)
    result = run_main(tmp_path, "--sync_replicas=true")
    assert result.interrupted and result.test_accuracy is None
    assert result.final_global_step == 2
    assert ("shutdown requested; checkpointing at global step 2"
            in capsys.readouterr().out)
    assert os.listdir(tmp_path / "logdir" / "mnist_mlp" / "checkpoints") \
        == ["2"]


def test_metrics_file_summaries_and_profile(tmp_path, standalone):
    metrics = tmp_path / "m.jsonl"
    run_main(tmp_path, "--sync_replicas=true", f"--metrics_file={metrics}",
             f"--summary_dir={tmp_path / 'tb'}", "--summary_histograms",
             "--validation_every=10", "--log_grad_norm",
             "--save_interval_steps=10",
             "--optimizer=sgd", f"--profile_dir={tmp_path / 'prof'}")
    records = [json.loads(x) for x in open(metrics)]
    kinds = {r["kind"] for r in records}
    assert {"run_meta", "train_step", "eval", "checkpoint",
            "run_summary"} <= kinds
    step = [r for r in records if r["kind"] == "train_step"][-1]
    assert step["step"] == 21 and "grad_norm" in step
    assert step["learning_rate"] == pytest.approx(0.1)
    assert step["mfu"] is None                 # no peak FLOP/s on the CPU
    summary = [r for r in records if r["kind"] == "run_summary"][0]
    assert summary["histograms"]["step_ms"]["count"] == 29
    (events,) = [f for f in os.listdir(tmp_path / "tb")]
    tags = {e.tag for e in iter_events(str(tmp_path / "tb" / events))
            if hasattr(e, "tag")}
    assert {"loss/train", "accuracy/validation", "accuracy/test"} <= tags
    prof = json.load(open(tmp_path / "prof" / "summary.json"))
    assert prof["busy_share"] is None and prof["window_ms"] > 0


@pytest.mark.parametrize("flags,match", [
    (("--sync_replicas=true", "--fsdp=true"), "item 6"),
    (("--sync_replicas=true", "--dcn_data_parallel=2"), "item 6"),
    (("--sync_replicas=true", "--data_augmentation=true"), "item 7"),
    (("--sync_replicas=true", "--tensor_parallel=2"), "item 6"),
    (("--sync_replicas=true", "--pipeline_parallel=2"), "item 6"),
    (("--sync_replicas=true", "--model=resnet20"), "item 7"),
    (("--sync_replicas=true", "--profile=p.json"), "item 8"),
])
def test_paths_not_ported_raise(tmp_path, standalone, flags, match):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{match}"):
        run_main(tmp_path, *flags)


def test_the_default_device_needs_cuda(tmp_path, standalone, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        ttrain.app.run(ttrain.main, [
            "--job_name=worker", "--task_index=0", "--sync_replicas=true",
            f"--logdir={tmp_path}"])


# ---------------------------------------------------------- processes


def launch(job, task, ps_port, worker_ports, logdir, *extra,
           train_steps=20, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **(env_extra or {}))
    workers = ",".join(f"localhost:{p}" for p in worker_ports)
    cmd = [sys.executable, "-m", "distributed_tensorflow_tpu_torch.train",
           "--device=cpu", f"--job_name={job}", f"--task_index={task}",
           f"--ps_hosts=localhost:{ps_port}", f"--worker_hosts={workers}",
           "--data_dir=/nonexistent", f"--train_steps={train_steps}",
           "--batch_size=32", "--hidden_units=16", "--learning_rate=0.1",
           "--log_every=5", "--save_interval_steps=5", f"--logdir={logdir}",
           "--sync_replicas=true", *extra]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(proc, timeout=TIMEOUT):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail(f"process timed out; output:\n{out}")
    return out


def stop(ps):
    ps.send_signal(signal.SIGTERM)
    ps.wait(timeout=10)


def read_until(proc, pattern, timeout=60.0):
    """A reader thread over ``proc``'s output: returns (lines, event set
    when a line matches ``pattern``)."""
    lines: list[str] = []
    seen = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line)
            if pattern(line):
                seen.set()
    t = threading.Thread(target=reader, daemon=True)
    t.start()
    return lines, seen, t


def test_ps_plus_two_workers_with_a_gloo_all_reduce(tmp_path):
    ps_port, worker_ports = free_port(), [free_port(), free_port()]
    logdir = str(tmp_path / "logdir")
    ps = launch("ps", 0, ps_port, worker_ports, logdir)
    try:
        # The non-chief first: it waits for the chief's init signal.
        w1 = launch("worker", 1, ps_port, worker_ports, logdir)
        w0 = launch("worker", 0, ps_port, worker_ports, logdir)
        out0, out1 = finish(w0), finish(w1)
        assert w0.returncode == 0, out0
        assert w1.returncode == 0, out1
        assert "Initailizing session" in out0
        assert "Waiting for session" in out1
        digests = []
        for out, worker in ((out0, 0), (out1, 1)):
            assert f"Worker {worker}: test accuracy" in out
            assert "Training elapsed time" in out
            assert "over gloo (cpu tensors)" in out
            assert f"Worker {worker}: sharded feed — this process loads " \
                   "16/32 examples per step" in out
            assert re.search(
                rf"Worker {worker}: all-reduce .* 18 calls after the first",
                out)
            digests.append(re.search(r"parameter digest (\w+)", out)[1])
        assert digests[0] == digests[1]        # bit-equal parameters
        losses = [re.findall(r"loss (\S+)", out) for out in (out0, out1)]
        assert losses[0] == losses[1] and len(losses[0]) == 3
        assert ps.poll() is None               # parked in server.join()
    finally:
        stop(ps)


def test_dead_worker_dropped_from_replica_mask(tmp_path):
    """R<N sync without a process group (each worker steps on its whole
    batch, split into one replica a task, as the JAX single-controller
    workers split theirs over their devices): SIGKILL worker 1 once the
    chief sees both alive; the heartbeat timeout drops its replica and
    the chief trains to the end."""
    ps_port, worker_ports = free_port(), [free_port(), free_port()]
    logdir = str(tmp_path / "logdir")
    extra = ("--replicas_to_aggregate=1", "--heartbeat_timeout=2",
             "--inject_step_delay=0.004:0:100000", "--log_every=500")
    env = {"DTF_TORCH_DISABLE_DISTRIBUTED": "1"}
    ps = launch("ps", 0, ps_port, worker_ports, logdir, *extra,
                env_extra=env)
    victim = None
    try:
        w0 = launch("worker", 0, ps_port, worker_ports, logdir, *extra,
                    train_steps=1500, env_extra=env)
        victim = launch("worker", 1, ps_port, worker_ports, logdir, *extra,
                        train_steps=1500, env_extra=env)
        lines, all_live, t = read_until(
            w0, lambda line: "live replica mask [1, 1]" in line)
        assert all_live.wait(timeout=60), "".join(lines)
        victim.kill()
        victim.communicate()
        victim = None
        assert w0.wait(timeout=TIMEOUT) == 0, "".join(lines)
        t.join(timeout=10)
        out0 = "".join(lines)
        masks = re.findall(r"live replica mask \[([\d, ]+)\]", out0)
        assert masks[0] == "1, 1" and masks[-1] == "1, 0", out0
        assert "no process group" in out0 and "test accuracy" in out0
    finally:
        if victim is not None:
            victim.kill()
            victim.communicate()
        stop(ps)


def test_chief_restart_recovers_from_checkpoint(tmp_path):
    """Kill the chief mid-run; its restarted incarnation restores its own
    checkpoint and finishes: the global step continues past the restored
    checkpoint instead of restarting at 1 (the workers without a process
    group, as the JAX test runs them)."""
    ps_port, worker_ports = free_port(), [free_port(), free_port()]
    logdir = str(tmp_path / "logdir")
    extra = ("--inject_step_delay=0.01:0:100000",)
    env = {"DTF_TORCH_DISABLE_DISTRIBUTED": "1"}
    ps = launch("ps", 0, ps_port, worker_ports, logdir, *extra,
                env_extra=env)
    try:
        w1 = launch("worker", 1, ps_port, worker_ports, logdir, *extra,
                    train_steps=300, env_extra=env)
        w0 = launch("worker", 0, ps_port, worker_ports, logdir, *extra,
                    train_steps=300, env_extra=env)

        def past_40(line):
            m = re.search(r"\(global step:(\d+)\)", line)
            return bool(m) and int(m.group(1)) >= 40
        lines, saw, t = read_until(w0, past_40)
        assert saw.wait(timeout=60), "".join(lines)
        w0.kill()
        w0.wait(timeout=30)
        t.join(timeout=10)
        w0b = launch("worker", 0, ps_port, worker_ports, logdir, *extra,
                     train_steps=300, env_extra=env)
        out0b = finish(w0b)
        assert w0b.returncode == 0, out0b
        first_global = int(re.search(r"\(global step:(\d+)\)",
                                     out0b).group(1))
        assert first_global > 30, out0b
        assert "rejoined coordination service" in out0b
        assert "test accuracy" in out0b
        out1 = finish(w1)
        assert w1.returncode == 0, out1
    finally:
        stop(ps)
