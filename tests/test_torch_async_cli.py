"""The port's trainer CLI in async mode (``--sync_replicas=false``) and the
masked sync path's straggler and elastic flags.

In process (``main()``, as ``tests/test_torch_train_cli.py`` runs it): one
async worker alone, its scanned variant (``--steps_per_call`` equal to
the period), and each flag combination async mode refuses; the masked
(R<N) sync worker with ``--straggler_lag`` and with
``--elastic_mode=in_place``, against a coordination service and a peer
client held by the test.

As processes on localhost, three cases of ``tests/test_multiprocess.py``
paced as the JAX tests pace theirs: :240 (averaging, and a late joiner
adopting the published parameters), :282 (the overlapped exchange) and
:441 (the PS SIGKILLed and restarted; a fresh worker adopts the published
parameters from its journal).  One replica a worker, so ``--train_steps``
counts local steps.  Tiny widths, torch on one thread.
"""

import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.coordination import (
    CoordinationClient, CoordinationServer)
from distributed_tensorflow_tpu_torch.cluster.server import Server
from helpers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def standalone(monkeypatch):
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
        "--train_steps=40", "--batch_size=64", "--hidden_units=16",
        "--learning_rate=0.1", "--log_every=8", "--device=cpu",
        f"--logdir={tmp_path}/logdir", "--sync_replicas=false", *flags])


@pytest.mark.parametrize("flags,local_steps", [
    ((), 39),
    (("--steps_per_call=4", "--async_sync_period=4"), 40),
])
def test_one_async_worker_alone(tmp_path, standalone, capsys, flags,
                                local_steps):
    result = run_main(tmp_path, "--async_sync_period=4", *flags)
    out = capsys.readouterr().out
    assert result.local_steps == local_steps
    # One replica a worker: the global step (from 1) counts its local
    # steps, up to --train_steps=40 (a scanned call's chunk boundary).
    assert result.final_global_step == 1 + local_steps
    assert "no process group; training alone" in out
    assert re.search(r"traing step 8 \(global step:9\) loss", out)
    assert "Worker 0: test accuracy" in out
    assert 0.1 < result.test_accuracy <= 1.0
    # Alone there is nobody to exchange with.
    assert "averaged parameters" not in out
    # The checkpoint holds JAX's per-replica stacks: the sync --mode=eval
    # refuses it with its advice, as the JAX trainer does.
    with pytest.raises(ValueError, match="per-replica checkpoint"):
        ttrain.app.run(ttrain.main, [
            "--job_name=worker", "--task_index=0",
            "--data_dir=/nonexistent", "--hidden_units=16",
            "--device=cpu", f"--logdir={tmp_path}/logdir", "--mode=eval"])


@pytest.mark.parametrize("flags,match", [
    (("--ema_decay=0.9",), "--ema_decay requires sync mode"),
    (("--steps_per_call=4", "--async_sync_period=8"),
     "must equal --async_sync_period"),
    (("--grad_accum_steps=2",), "--grad_accum_steps > 1 requires sync"),
    (("--model=gpt_mini", "--bert_dropout=0.1", "--bert_seq_len=16",
      "--batch_size=4", "--bert_dtype=float32"),
     "--bert_dropout requires sync mode"),
    (("--log_grad_norm",), "--log_grad_norm requires sync mode"),
    (("--async_compress=fp8",), None),
])
def test_async_refused_flag_combinations(tmp_path, standalone, flags,
                                         match):
    if match is None:
        # --async_compress is checked where an exchange is set up (several
        # workers and a coordination service), as in JAX: alone it trains.
        run_main(tmp_path, "--train_steps=4", *flags)
        return
    with pytest.raises(ValueError, match=re.escape(match)):
        run_main(tmp_path, *flags)


@pytest.mark.parametrize("flag", [
    "--async_mode=local_sgd", "--async_sync_period=2",
    "--async_overlap_exchange=true", "--async_compress=bf16",
    "--async_anchor_every=2", "--async_quant_block=256", "--slice_size=2",
    "--elastic_mode=in_place", "--elastic_reshard_margin=5",
    "--straggler_lag=3", "--trainable_params=sm",
    "--coord_standbys=localhost:1",
    "--coord_instances=2"])
def test_the_former_slice_7b_flags_are_ported(tmp_path, standalone, flag):
    """Each flag the trainer refused before slice 7b now runs (alone, the
    exchange flags have no peer to act on) or fails a check of its own;
    none raises NotImplementedError."""
    try:
        result = run_main(tmp_path, "--train_steps=4", flag)
    except ValueError as e:
        # An elastic mode needs a coordination service to watch.
        assert flag.startswith("--elastic_mode") and "coordination" in str(e)
    else:
        assert result.final_global_step == 4


def _peer(port, task, progress):
    """A registered peer task that heartbeats a fixed step."""
    c = CoordinationClient("127.0.0.1", port, task_id=task)
    c.register(timeout=10.0)
    c.set_progress(progress)
    c.start_heartbeats(interval=0.2)
    return c


def _masked_main(tmp_path, port, monkeypatch, *flags):
    monkeypatch.setenv("DTF_TORCH_DISABLE_DISTRIBUTED", "1")
    return ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--data_dir=/nonexistent",
        f"--worker_hosts=localhost:{free_port()},localhost:{free_port()}",
        f"--ps_hosts=localhost:{port}", "--train_steps=500",
        "--batch_size=32", "--hidden_units=16", "--learning_rate=0.1",
        "--log_every=100", "--device=cpu", "--sync_replicas=true",
        "--replicas_to_aggregate=1", "--inject_step_delay=0.01:0:100000",
        f"--logdir={tmp_path}/logdir", *flags])


def test_straggler_lag_drops_a_slow_live_peer(tmp_path, monkeypatch,
                                              capsys):
    """--straggler_lag on the masked sync path: a peer that heartbeats but
    stays at step 1 is dropped from the live set once this worker is more
    than the lag ahead (the reference's drop-the-slow semantics)."""
    port = free_port()
    srv = CoordinationServer(port=port, num_tasks=2, heartbeat_timeout=30.0)
    srv.start()
    peer = _peer(port, 1, progress=1)
    try:
        result = _masked_main(tmp_path, port, monkeypatch,
                              "--straggler_lag=20", "--elastic_mode=off")
        out = capsys.readouterr().out
        masks = re.findall(r"live replica mask \[([\d, ]+)\]", out)
        assert masks[0] == "1, 1" and masks[-1] == "1, 0", out
        assert result.test_accuracy is not None
    finally:
        peer.close()
        srv.stop()


def test_elastic_in_place_masks_a_departed_peer(tmp_path, monkeypatch,
                                                capsys):
    """--elastic_mode=in_place on the masked sync path: the peer's LEAVE
    shrinks the membership epoch, and the mask (health AND membership)
    drops it while its heartbeats still say alive."""
    port = free_port()
    srv = CoordinationServer(port=port, num_tasks=2, heartbeat_timeout=30.0)
    srv.start()
    peer = _peer(port, 1, progress=1)
    timer = threading.Timer(2.0, peer.leave)
    timer.start()
    try:
        _masked_main(tmp_path, port, monkeypatch, "--elastic_mode=in_place")
        out = capsys.readouterr().out
        assert "elastic membership active (mode=in_place)" in out
        masks = re.findall(r"live replica mask \[([\d, ]+)\]", out)
        assert masks[0] == "1, 1" and masks[-1] == "1, 0", out
    finally:
        timer.cancel()
        peer.close()
        srv.stop()


# ---------------------------------------------------------- processes


def launch(job, task, ps_port, worker_ports, logdir, *extra,
           train_steps=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    workers = ",".join(f"localhost:{p}" for p in worker_ports)
    cmd = [sys.executable, "-m", "distributed_tensorflow_tpu_torch.train",
           "--device=cpu", f"--job_name={job}", f"--task_index={task}",
           f"--ps_hosts=localhost:{ps_port}", f"--worker_hosts={workers}",
           "--data_dir=/nonexistent", f"--train_steps={train_steps}",
           "--batch_size=32", "--hidden_units=16", "--learning_rate=0.1",
           "--log_every=5", "--save_interval_steps=50", f"--logdir={logdir}",
           "--sync_replicas=false", "--async_sync_period=4", *extra]
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


def stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def read_until(proc, pattern):
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


# Paced steps, as the JAX tests pace theirs: a fast machine must not run
# one worker's whole horizon before the other steps.
PACE = "--inject_step_delay=0.03:1:1000000000"


class _TornOnce:
    """A coordination KV whose first read of a payload chunk returns
    another publication's chunk: the peer republished between the
    reader's meta and its chunks, as a live worker does every period."""

    def __init__(self):
        self.kv, self.torn = {}, True

    def kv_set(self, key, value, *args, **kw):
        self.kv[key] = value

    def kv_get(self, key, *args, **kw):
        value = self.kv.get(key)
        if self.torn and key.endswith(".c0") and value:
            self.torn = False
            return value[::-1]
        return value


def test_rejoin_pull_reads_a_republishing_peer_again():
    """The startup adoption (``ParamAverager.pull_latest``, train.py's
    ``_async_exchange``) of a peer that republishes while it is read: a
    torn read is read again, so the late worker adopts the publication.
    Read once, the torn read started worker 1 from its own init under a
    loaded machine (test_async_cross_process_parameter_averaging)."""
    from distributed_tensorflow_tpu_torch.cluster.param_sync import (
        ParamAverager)
    kv = _TornOnce()
    tree = {"hid": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                    "bias": np.ones(4, np.float32)}}
    ParamAverager(kv, 0, 2, namespace="run")._publish(tree)
    got = ParamAverager(kv, 1, 2, namespace="run").pull_latest(tree)
    assert not kv.torn                 # the first read was torn
    assert got is not None
    np.testing.assert_array_equal(got["hid"]["kernel"], tree["hid"]["kernel"])


def test_async_cross_process_parameter_averaging(tmp_path):
    ps_port, worker_ports = free_port(), [free_port(), free_port()]
    logdir = str(tmp_path / "logdir")
    ps = launch("ps", 0, ps_port, worker_ports, logdir)
    try:
        w0 = launch("worker", 0, ps_port, worker_ports, logdir, PACE)
        # Worker 1 starts once worker 0 has published (its first exchange
        # runs at local step 4, before the step-5 line).
        lines, published, t = read_until(
            w0, lambda line: "traing step 5 " in line)
        assert published.wait(timeout=60), "".join(lines)
        w1 = launch("worker", 1, ps_port, worker_ports, logdir, PACE)
        out1 = finish(w1)
        assert w0.wait(timeout=TIMEOUT) == 0, "".join(lines)
        t.join(timeout=10)
        out0 = "".join(lines)
        assert w1.returncode == 0, out1
        combined = out0 + out1
        assert "averaged parameters with 1 peer(s)" in combined, combined
        assert "(kv publish" in combined, combined
        assert "adopted published collective parameters" in out1, out1
        for out in (out0, out1):
            assert "test accuracy" in out
        assert "no process group" in out1
    finally:
        stop(ps)


def test_async_overlapped_exchange_across_processes(tmp_path):
    ps_port, worker_ports = free_port(), [free_port(), free_port()]
    logdir = str(tmp_path / "logdir")
    extra = ("--async_overlap_exchange=true", "--async_compress=int8", PACE)
    ps = launch("ps", 0, ps_port, worker_ports, logdir)
    try:
        w0 = launch("worker", 0, ps_port, worker_ports, logdir, *extra)
        w1 = launch("worker", 1, ps_port, worker_ports, logdir, *extra)
        out0, out1 = finish(w0), finish(w1)
        assert w0.returncode == 0, out0
        assert w1.returncode == 0, out1
        combined = out0 + out1
        assert "compressed parameter exchange on" in combined, combined
        assert "applied overlapped average with 1 peer(s)" in combined, (
            combined)
        assert "in background" in combined, combined
        assert "averaged parameters with" not in combined, combined
        accs = [float(line.rsplit(None, 1)[-1])
                for line in combined.splitlines() if "test accuracy" in line]
        assert len(accs) == 2 and max(accs) > 0.9, accs
    finally:
        stop(ps)


def test_ps_restart_restores_published_state(tmp_path):
    ps_port, worker_ports = free_port(), [free_port(), free_port()]
    logdir = str(tmp_path / "logdir")
    ps = launch("ps", 0, ps_port, worker_ports, logdir)
    ps2 = w0 = w1 = None
    try:
        w0 = launch("worker", 0, ps_port, worker_ports, logdir,
                    train_steps=100000)

        def past_100(line):
            m = re.search(r"\(global step:(\d+)\)", line)
            return bool(m) and int(m.group(1)) >= 100
        lines, progressed, t = read_until(w0, past_100)
        assert progressed.wait(timeout=60), "".join(lines)
        w0.send_signal(signal.SIGTERM)   # graceful exit after publishing
        assert w0.wait(timeout=60) == 0, "".join(lines)
        t.join(timeout=10)
        ps.kill()                        # the in-memory KV is gone
        ps.communicate()
        ps2 = launch("ps", 0, ps_port, worker_ports, logdir)
        w1 = launch("worker", 1, ps_port, worker_ports, logdir,
                    train_steps=40)
        out1 = finish(w1)
        assert w1.returncode == 0, out1
        # The journal-restored KV held the collective's parameters and the
        # chief's init signal.
        assert "adopted published collective parameters" in out1, out1
        assert "test accuracy" in out1
    finally:
        for p in (w0, w1):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()
        if ps2 is not None:
            stop(ps2)
        if ps.poll() is None:
            ps.kill()
            ps.communicate()
