"""The port's serving CLI (distributed_tensorflow_tpu_torch/tools/serve.py)
and hot swap (serving/hot_swap.py) against the JAX package's.

A checkpoint the JAX trainer's ``Supervisor`` wrote is restored by the
port's ``load_gpt_serving_model``: its logits equal the JAX model's on the
same tree within 1e-4 in f32.  The watcher cases are the reference's
(tests/test_serving.py), and the engine's mid-stream swap keeps the JAX
model's greedy prefix.  Then the CLI as a process with ``--device=cpu``:
two tenants over four slots, a newer step written by ``save_raw`` while
they stream, every request run to its budget, the swap landing, and a
request after it answered with the new weights' tokens.  Small widths
(``mini()``'s, which the reference's restore keeps), torch on one
thread."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.tools import serve as jserve
from distributed_tensorflow_tpu.training.state import TrainState
from distributed_tensorflow_tpu.training.supervisor import Supervisor
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.serving.client import ServeClient
from distributed_tensorflow_tpu_torch.serving.engine import (DecodeEngine,
                                                             EngineConfig)
from distributed_tensorflow_tpu_torch.serving.hot_swap import (
    ModelWatcher, newest_verified_step)
from distributed_tensorflow_tpu_torch.serving.scheduler import Request
from distributed_tensorflow_tpu_torch.tools import checkpoint_io
from distributed_tensorflow_tpu_torch.tools import export_model as texport
from distributed_tensorflow_tpu_torch.tools import serve as tserve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 logits of the restored model against the JAX model's.
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed):
    return jax.device_get(jgpt.GptLM(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])


def _supervisor_save(logdir, params, step):
    """The JAX trainer's checkpoint: a TrainState through its Supervisor."""
    model = jgpt.GptLM(jgpt.mini())
    state = TrainState.create(lambda p, t: model.apply({"params": p}, t),
                              params, optax.adam(3e-3))
    state = state.replace(global_step=jnp.asarray(step, jnp.int32))
    sv = Supervisor(is_chief=True, logdir=str(logdir), init_fn=lambda: state)
    assert sv.maybe_save(state, force=True)
    sv.close()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A JAX-written run directory at step 1 and its params."""
    logdir = tmp_path_factory.mktemp("serve") / "gpt_mini"
    params = _jax_params(jgpt.mini(), 0)
    _supervisor_save(logdir, params, 1)
    return logdir, params


def _port_model(cfg, params, **kw):
    model = tgpt.GptLM(dataclasses.replace(cfg, **kw), device="cpu")
    model.load_state_dict(tgpt.params_from_jax(params))
    return model


def test_load_gpt_serving_model_gives_the_jax_models_logits(run):
    logdir, params = run
    texport.clear_restore_memo()
    cfg, tree, step = tserve.load_gpt_serving_model(str(logdir))
    want_cfg, _, want_step = jserve.load_gpt_serving_model(str(logdir))
    assert step == want_step == 1
    for field in dataclasses.fields(want_cfg):
        if field.name not in ("attention_backend", "fused_ln"):
            assert getattr(cfg, field.name) == getattr(want_cfg, field.name)
    assert (cfg.attention_backend, cfg.fused_ln) == ("pallas", True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    model = tgpt.GptLM(dataclasses.replace(cfg, dtype="float32"),
                       device="cpu")
    model.load_state_dict(tgpt.params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens)).numpy()
    want = jgpt.GptLM(dataclasses.replace(want_cfg, dtype="float32")).apply(
        {"params": params}, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_engine_hot_swap_mid_stream_continuity():
    """A weight swap between steps must not drop the in-flight stream: the
    pre-swap prefix is the old model's greedy decode (the JAX model's), the
    stream runs to its full budget, and the swap shows in the engine."""
    cfg = jgpt.GptConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, intermediate_size=64, max_position=64,
                         dtype="float32")
    params, params2 = _jax_params(cfg, 0), _jax_params(cfg, 1)
    model = _port_model(tgpt.GptConfig(**dataclasses.asdict(cfg)), params)
    engine = DecodeEngine(model, None, EngineConfig(
        num_slots=2, page_size=4, num_pages=32, max_pages_per_seq=8),
        device="cpu")
    req = Request([5, 6, 7, 8], 10)
    engine.admit(req)
    for _ in range(4):
        engine.step()
    prefix = list(req.tokens)
    engine.swap_params(tgpt.params_from_jax(params2), step=42)
    while engine.active_slots:
        engine.step()
    assert len(req.tokens) == 10                   # nothing dropped
    ref = np.asarray(jgpt.generate(
        jgpt.GptLM(cfg), params, jnp.asarray([[5, 6, 7, 8]], jnp.int32),
        4))[0]
    assert prefix == ref[4:].tolist()
    assert engine.model_step == 42 and engine.swaps == 1


# ------------------------------------------------------- model watcher


def test_model_watcher_picks_up_new_verified_checkpoint(tmp_path):
    ckpt = tmp_path / "checkpoints"
    for step, blob in ((2, b"x" * 64), (5, b"y" * 64)):
        d = ckpt / str(step)
        d.mkdir(parents=True)
        (d / "data.bin").write_bytes(blob)
        checkpoint_io.write_manifest(str(d))
    found = newest_verified_step(str(ckpt))
    assert found is not None and found[0] == 5
    # Corrupt the newest: the watcher must fall back to the older valid.
    (ckpt / "5" / "data.bin").write_bytes(b"y" * 63)
    assert newest_verified_step(str(ckpt))[0] == 2

    swapped = []
    watcher = ModelWatcher(
        str(tmp_path), lambda step: {"step": step},
        lambda params, step: swapped.append((params, step)),
        initial_step=0)
    assert watcher.poll_once() == 2
    assert swapped == [({"step": 2}, 2)]
    assert watcher.poll_once() is None     # nothing newer verifies
    # Repair step 5's manifest: next poll swaps forward.
    checkpoint_io.write_manifest(str(ckpt / "5"))
    assert watcher.poll_once() == 5
    assert watcher.current_step == 5


def test_model_watcher_load_failure_degrades_to_stale(tmp_path):
    d = tmp_path / "checkpoints" / "3"
    d.mkdir(parents=True)
    (d / "data.bin").write_bytes(b"z" * 16)
    checkpoint_io.write_manifest(str(d))

    def broken_load(step):
        raise RuntimeError("restore exploded")

    watcher = ModelWatcher(str(tmp_path), broken_load,
                           lambda *_: pytest.fail("must not swap"))
    assert watcher.poll_once() is None     # stale weights, not a crash
    assert watcher.current_step == 0


def test_model_watcher_coordination_hint_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.*slice 7"):
        ModelWatcher(str(tmp_path), lambda s: None, lambda *a: None,
                     coord_client=object())


# ------------------------------------------------------------- the CLI


def test_render_statz_prints_the_references_table():
    stats = {"engine": {"engine_step": 12, "model_step": 3, "swaps": 1,
                        "active_slots": 2, "num_slots": 4,
                        "kv_pool": {"pages_in_use": 5, "num_pages": 64,
                                    "utilization": 0.08,
                                    "internal_fragmentation": 0.1}},
             "queue_depth": 0,
             "tenants": {"alice": {"weight": 2, "queued": 0, "admitted": 3,
                                   "completed": 3, "rejected": 0,
                                   "served_tokens": 40}},
             "latency": {"serve_ttft_ms": {"count": 3, "p50": 4.0,
                                           "p95": 9.0}}}
    got, want = [], []
    tserve.render_statz(stats, got.append)
    jserve.render_statz(stats, want.append)
    assert got[1:] == want[1:] and len(got) == 5
    assert got[0].split(": ", 1)[1] == want[0].split(": ", 1)[1]


def test_cli_refuses_what_it_cannot_do(run, monkeypatch, capsys):
    logdir, _ = run
    with pytest.raises(NotImplementedError, match="ROADMAP.*slice 7"):
        tserve.main(["--logdir", str(logdir), "--coord", "localhost:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        tserve.main(["--logdir", str(logdir)])
    # --watch on a server that is not there: one snapshot, exit 1, the
    # message on stderr only.
    assert tserve.main(["--watch", "http://127.0.0.1:9", "--once",
                        "--json"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "unreachable" in out.err


def _read_banner(proc):
    seen = []
    for _ in range(80):
        line = proc.stdout.readline()
        if not line or (line.startswith("serving ") and " on :" in line):
            return line, seen
        seen.append(line)
    return "", seen


def test_serve_cli_hot_swaps_mid_stream_with_nothing_dropped(run,
                                                            tmp_path):
    """The reference's CLI scenario (test_serve_cli_e2e_with_hot_swap) on
    the port: the CLI restores the JAX-written step 1, serves two tenants
    over four slots, ``save_raw`` writes step 2 while they stream, every
    request runs to its budget, the swap lands, and a request after it
    gets the tokens of an engine holding step 2's weights."""
    logdir, params = run
    params2 = _jax_params(jgpt.mini(), 1)
    metrics = tmp_path / "serve.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.tools.serve",
         "--logdir", str(logdir), "--port", "0", "--device", "cpu",
         "--slots", "4", "--page_size", "8", "--num_pages", "64",
         "--max_pages_per_seq", "8", "--metrics_file", str(metrics),
         "--hot_swap", "--swap_poll_s", "0.2", "--tenants", "alice:2,bob:1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line, seen = _read_banner(proc)
        assert line.startswith("serving gpt_mini "), "".join(seen)
        assert "step 1 " in line and "hot-swap armed" in line
        port = int(line.split(" on :")[1].split(" ")[0])
        client = ServeClient(f"http://127.0.0.1:{port}", timeout_s=120.0)

        results = {}

        def call(key, tenant, n):
            results[key] = (n, client.generate([3, 4, 5], n, tenant=tenant))

        # Six requests over four slots with staggered budgets: early
        # retirements backfill queued requests while longer lanes decode.
        threads = [threading.Thread(target=call,
                                    args=((t, i), t, 20 + 10 * i))
                   for i in (0, 1, 2) for t in ("alice", "bob")]
        for t in threads:
            t.start()
        # Mid-stream: the port's writer saves a NEWER step to swap in.
        checkpoint_io.save_raw(
            str(logdir / "checkpoints"), 2,
            {"params": params2, "global_step": np.asarray(2, np.int32)})
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert len(results) == 6
        assert all(len(v["tokens"]) == 3 + n and v["tokens_out"] == n
                   for n, v in results.values()), results
        for _ in range(120):
            if client.health().get("model_step", 0) == 2:
                break
            time.sleep(0.25)
        else:
            pytest.fail("hot swap never landed")
        post = client.generate([3, 4, 5], 8, tenant="alice")
        assert post["model_step"] == 2
        assert client.stats()["engine"]["swaps"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
    assert proc.returncode == 0

    model2 = _port_model(tgpt.mini(), params2, attention_backend="pallas",
                         fused_ln=True)
    engine = DecodeEngine(model2, None, EngineConfig(
        num_slots=4, page_size=8, num_pages=64, max_pages_per_seq=8),
        device="cpu")
    req = Request([3, 4, 5], 8)
    engine.admit(req)
    while engine.active_slots:
        engine.step()
    assert post["tokens"] == [3, 4, 5] + req.tokens

    records = [json.loads(x) for x in metrics.read_text().splitlines()]
    kinds = {r.get("kind") for r in records}
    assert {"run_meta", "model_swap", "serve_request"} <= kinds
    (meta,) = [r for r in records if r.get("kind") == "run_meta"]
    assert meta["role"] == "serve" and meta["model"] == "gpt_mini"
    assert meta["model_step"] == 1 and meta["num_slots"] == 4
    (swap,) = [r for r in records if r.get("kind") == "model_swap"]
    assert (swap["from_model_step"], swap["to_model_step"]) == (1, 2)
    served = [r for r in records if r.get("kind") == "serve_request"]
    assert {r.get("tenant") for r in served} >= {"alice", "bob"}
