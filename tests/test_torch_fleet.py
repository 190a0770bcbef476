"""The port's serving fleet tier (``serving/router.py``, ``serving/cells.py``,
``tools/serve_fleet.py``, ``tools/serve_cell.py``, ``tools/coord_shard.py``,
``tools/loadgen.py``, ``tools/watch_serve.py``, ``tools/summarize_run.py``,
``tools/export_trace.py``) against the JAX package's.

**Mirrored cases.**  Every case of ``tests/test_router.py``,
``test_cells.py``, ``test_loadgen.py`` and ``test_summarize_run.py``, and
the cross-tier tracing cases of ``test_cross_tier_tracing.py``, run
against the port: the JAX test modules are loaded with their imports of
the serving tier, its tools, the coordination service and the utilities
pointed at the port (``mirror_module``; a module a test spawns with
``python -m`` is the port's CLI, and the JAX CLIs' ``--platform cpu`` is
the port's ``--device cpu``), and each test function, each of its
parameter sets, is one case here.  The bodies, inputs and tolerances are
the JAX files', unchanged; a ``slow`` case keeps its mark.

**End to end.**  ``test_fleet_e2e_through_a_replica_kill_gives_the_jax_
engines_tokens``: the port's ``serve_fleet`` with two CPU replicas of a
JAX ``Supervisor`` checkpoint, one SIGKILLed mid-load, against the JAX
package's ``DecodeEngine`` on the same tree.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_param_sync import mirror_module, run_mirrored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The JAX CLIs take ``--platform``; the port's take ``--device``.
DEVICE_FLAG = (('"--platform", "cpu"', '"--device", "cpu"'),)

MIRRORS = {
    "test_router.py": mirror_module("test_router.py", DEVICE_FLAG),
    "test_cells.py": mirror_module("test_cells.py", DEVICE_FLAG),
    "test_loadgen.py": mirror_module("test_loadgen.py"),
    "test_summarize_run.py": mirror_module("test_summarize_run.py"),
    "test_cross_tier_tracing.py": mirror_module(
        "test_cross_tier_tracing.py"),
}

#: JAX cases that do not run against the port, and why.
EXCLUDED = {
    "test_cross_tier_tracing.py": {
        # A JAX model behind the JAX engine and the (copied) server: the
        # port's engine takes a torch model, and the port's server with
        # it is held to the JAX engine in tests/test_torch_gpt_serving.py
        # and tests/test_torch_serve_cli.py.
        "test_server_adopts_wire_context_as_root": "JAX engine",
        "test_server_tail_sampling_keep_and_drop_over_http": "JAX engine",
        # The repo's static checker (tools/dtflint) over the JAX tree; it
        # is not part of the port (ROADMAP, section 1, item 8).
        "test_dtflint_flags_consumer_span_names_nobody_emits": "dtflint",
    },
}

# The mirrored modules' own fixtures, registered here by name (the two
# ``trained_logdir`` fixtures write the same JAX checkpoint).
capture = MIRRORS["test_cross_tier_tracing.py"].capture
trained_logdir = MIRRORS["test_router.py"].trained_logdir


def _cases():
    """One ``pytest.param`` per mirrored case and parameter set, with the
    case's own marks (``slow``, ``smoke``)."""
    out = []
    for filename, mod in MIRRORS.items():
        skip = EXCLUDED.get(filename, {})
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or name in skip:
                continue
            marks = list(getattr(fn, "pytestmark", []))
            params = [m for m in marks if m.name == "parametrize"]
            marks = [m for m in marks if m.name != "parametrize"]
            sets = [({}, "")]
            for m in params:
                argnames = m.args[0]
                if isinstance(argnames, str):
                    argnames = [a.strip() for a in argnames.split(",")]
                values = [v if len(argnames) > 1 else (v,)
                          for v in m.args[1]]
                sets = [({**kw, **dict(zip(argnames, v))},
                         f"{tag}[{'-'.join(map(str, v))}]")
                        for kw, tag in sets for v in values]
            for kwargs, tag in sets:
                out.append(pytest.param(filename, name, kwargs, marks=marks,
                                        id=f"{filename[5:-3]}::{name}{tag}"))
    return out


CASES = _cases()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("filename,name,kwargs", CASES)
def test_mirrored(filename, name, kwargs, request):
    run_mirrored(getattr(MIRRORS[filename], name), request, kwargs)


def test_mirrors_cover_every_case():
    """Each JAX case is mirrored or excluded with its reason, every
    parameter set of a parametrised case is a case of its own, and the
    slow cases keep their mark."""
    for filename, mod in MIRRORS.items():
        names = {n for n in vars(mod) if n.startswith("test_")}
        mirrored = {p.values[1] for p in CASES if p.values[0] == filename}
        assert names - set(EXCLUDED.get(filename, {})) == mirrored
    rehome = [p.values[2] for p in CASES
              if p.values[1] == "test_rehome_policy_on_cell_recovery"]
    assert len(rehome) == 2 and all(set(kw) == {"policy", "expect_home"}
                                    for kw in rehome)
    slow = {p.values[1] for p in CASES
            if any(m.name == "slow" for m in p.marks)}
    assert {"test_fleet_kill_replica_e2e_zero_failed_requests",
            "test_fleet_autoscale_scales_up_on_induced_slo_burn",
            "test_two_cell_drill_kill_cell_a_wholesale"} <= slow
    assert len(CASES) >= 79


# ------------------------------------------------------ CPU end to end


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """A run directory the JAX trainer's ``Supervisor`` wrote at step 1
    (``mini()``'s widths), and its parameters."""
    from test_torch_serve_cli import _jax_params, _supervisor_save
    from distributed_tensorflow_tpu.models import gpt as jgpt
    logdir = tmp_path_factory.mktemp("fleet") / "gpt_mini"
    params = _jax_params(jgpt.mini(), 0)
    _supervisor_save(logdir, params, 1)
    return logdir


GEOMETRY = dict(num_slots=4, page_size=8, num_pages=64, max_pages_per_seq=8)
NEW = 8
# The served model computes in bf16 (``mini()``'s dtype, as the JAX CLI
# serves it).  Two greedy streams may part only where the next token is a
# near tie: both tokens the f32 model's top two, their logits within
# about one bf16 step (2^-6 at the logits' magnitude of 2-4) of each
# other.
TIE = 0.02


def _jax_engine_tokens(logdir, prompts):
    """The JAX package's engine on the same tree, as its tests run it:
    every prompt greedy, admitted whenever a slot is free."""
    from distributed_tensorflow_tpu.models import gpt as jgpt
    from distributed_tensorflow_tpu.serving import engine as jengine
    from distributed_tensorflow_tpu.serving.scheduler import Request
    from distributed_tensorflow_tpu.tools import serve as jserve
    cfg, tree, _ = jserve.load_gpt_serving_model(str(logdir))
    engine = jengine.DecodeEngine(jgpt.GptLM(cfg), tree,
                                  jengine.EngineConfig(**GEOMETRY))
    requests = [Request(p, NEW) for p in prompts]
    pending = list(requests)
    while pending or engine.active_slots:
        while pending and engine.free_slots:
            engine.admit(pending.pop(0))
        engine.step()
    return [p + r.tokens for p, r in zip(prompts, requests)]


def _assert_greedy_equal(logdir, prompts, got, want):
    """Equal token streams, or streams that part at a near tie (``TIE``)
    of the JAX model's f32 logits on the common prefix."""
    import dataclasses

    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models import gpt as jgpt
    from distributed_tensorflow_tpu.tools import serve as jserve
    cfg, tree, _ = jserve.load_gpt_serving_model(str(logdir))
    model = jgpt.GptLM(dataclasses.replace(cfg, dtype="float32"))
    for prompt, a, b in zip(prompts, got, want):
        if a == b:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        assert k >= len(prompt), (a, b)
        logits = np.asarray(model.apply({"params": tree}, jnp.asarray(
            [a[:k]], jnp.int32)), np.float32)[0, -1]
        top = np.argsort(logits)[::-1][:2]
        assert {a[k], b[k]} == set(top.tolist()), (k, a, b, top)
        assert logits[top[0]] - logits[top[1]] < TIE, (k, logits[top])


def test_fleet_e2e_through_a_replica_kill_gives_the_jax_engines_tokens(
        fleet_run, tmp_path):
    """The port's ``serve_fleet`` with two CPU replicas of a JAX-written
    checkpoint: 8 greedy requests of 8 new tokens over two tenants, ``r1``
    SIGKILLed once 4 have completed.  Zero failed requests, ``r1`` dead
    and ``failed == 0`` in ``/fleetz``, ``summarize_run --check`` green on
    the router's stream, the survivor's clean exit printing its kernel
    launches (zeros: the plain versions ran), and every request's tokens
    those of the JAX package's engine on the same tree (or parting from
    them at a bf16 near tie, ``TIE``)."""
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    from distributed_tensorflow_tpu_torch.tools import summarize_run
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, int(n)).tolist()
               for n in rng.integers(4, 24, 8)]
    tenants = ["search", "ads"] * 4
    metrics, state_file = tmp_path / "router.jsonl", tmp_path / "fleet.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.tools."
         "serve_fleet", "--logdir", str(fleet_run), "--port", "0",
         "--device", "cpu", "--replicas", "2",
         "--slots", str(GEOMETRY["num_slots"]),
         "--page_size", str(GEOMETRY["page_size"]),
         "--num_pages", str(GEOMETRY["num_pages"]),
         "--max_pages_per_seq", str(GEOMETRY["max_pages_per_seq"]),
         "--poll_s", "0.5", "--fail_after", "2",
         "--tenants", "search:2,ads:1", "--metrics_file", str(metrics),
         "--state_file", str(state_file), "--fleet_dir", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("routing fleet on :"), line
        port = int(line.split(" on :")[1].split(" ")[0])
        client = ServeClient(f"http://127.0.0.1:{port}", timeout_s=120.0,
                             retries=3)
        # The JAX engine's tokens while the replicas boot.
        want = _jax_engine_tokens(fleet_run, prompts)
        deadline = time.time() + 120.0
        while client.fleetz()["router"]["healthy"] < 2:
            assert time.time() < deadline, client.fleetz()
            time.sleep(0.2)
        pids = {m["id"]: m["pid"]
                for m in json.load(open(state_file))["members"]}
        assert sorted(pids) == ["r0", "r1"] and all(pids.values())

        results, errors = {}, []
        half = threading.Event()

        def call(i):
            try:
                results[i] = client.generate(prompts[i], NEW,
                                             tenant=tenants[i])
            except Exception as e:  # noqa: BLE001 — the assertion target
                errors.append((i, e))
            if len(results) + len(errors) >= 4:
                half.set()

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        assert half.wait(timeout=120.0)
        os.kill(pids["r1"], signal.SIGKILL)
        for t in threads:
            t.join(timeout=120.0)
        assert not errors, errors
        for tenant in ("search", "ads"):          # the survivor serves both
            assert len(client.generate([5, 6], 4, tenant=tenant)[
                "tokens"]) == 6
        deadline = time.time() + 30.0
        while True:
            snap = client.fleetz()
            states = {m["id"]: m["state"] for m in snap["members"]}
            if states["r1"] == "dead":
                break
            assert time.time() < deadline, snap
            time.sleep(0.2)
        assert snap["router"]["failed"] == 0
        assert snap["router"]["healthy"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
    assert proc.returncode == 0
    _assert_greedy_equal(fleet_run, prompts,
                         [results[i]["tokens"] for i in range(8)], want)

    assert summarize_run.main([str(metrics), "--check"]) == 0
    records = [json.loads(x) for x in metrics.read_text().splitlines()]
    actions = {r.get("action") for r in records if r.get("kind") == "fleet"}
    assert "replica_dead" in actions, actions
    # The survivor's clean exit: its launch line, every counter zero.
    log = (tmp_path / "replica-r0.log").read_text().splitlines()
    (launches,) = [x for x in log if x.startswith("kernel launches ")]
    counts = json.loads(launches[len("kernel launches "):])
    assert counts["flash_attention_fwd"] == counts["layer_norm_fwd"] == 0
    assert not any(counts.values())
