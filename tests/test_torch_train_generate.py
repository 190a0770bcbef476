"""``train.py --mode=generate`` of the port (distributed_tensorflow_tpu_torch/
train.py) on checkpoints the JAX package wrote: its greedy, beam (width 2)
and speculative tokens equal the JAX package's ``generate_cached``,
``beam_search_cached`` and ``generate_cached_speculative_device`` on the
same restored tree (f32, exact token equality), with the JAX CLI's
printed lines; pipelined namespaces restore merged; a JAX command line
parses; the paths not ported yet raise.  Small widths (the port infers
them from the tree), torch on one thread, the JAX references jitted by
the JAX decode functions themselves."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.training.state import TrainState
from distributed_tensorflow_tpu.training.supervisor import Supervisor
from distributed_tensorflow_tpu_torch import train as ttrain

CFG = jgpt.GptConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64, max_position=64,
                     dtype="float32")
PROMPT = [5, 9, 2, 5, 9, 2, 5, 9]
NEW = 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.device_get(jgpt.GptLM(CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """A run directory whose gpt_mini namespace holds the JAX trainer's
    checkpoint at global step 7."""
    root = tmp_path_factory.mktemp("gen")
    model = jgpt.GptLM(CFG)
    state = TrainState.create(lambda p, t: model.apply({"params": p}, t),
                              _params(), optax.adam(1e-3))
    state = state.replace(global_step=jnp.asarray(7, jnp.int32))
    sv = Supervisor(is_chief=True, logdir=str(root / "gpt_mini"),
                    init_fn=lambda: state)
    assert sv.maybe_save(state, force=True)
    sv.close()
    return root


def _generate(logdir, *flags):
    return ttrain.app.run(ttrain.main, [
        "--mode=generate", "--model=gpt_mini", f"--logdir={logdir}",
        "--device=cpu", "--bert_dtype=float32", f"--gen_tokens={NEW}",
        "--gen_prompt=" + ",".join(map(str, PROMPT)), *flags])


def _prompt():
    return jnp.asarray([PROMPT], jnp.int32)


def test_greedy_tokens_and_lines_equal_the_jax_cli(logdir, capsys):
    toks = _generate(logdir)
    want = np.asarray(jgpt.generate_cached(jgpt.GptLM(CFG), _params(),
                                           _prompt(), NEW))[0]
    np.testing.assert_array_equal(toks, want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3:] == [
        "Restored global step: 7",
        "Prompt tokens:    " + " ".join(map(str, PROMPT)),
        "Generated tokens: " + " ".join(map(str, want[len(PROMPT):]))]
    # An eos id stops the row at its first terminator, as in JAX.
    eos = int(want[len(PROMPT) + 2])
    stop = 1 + int(np.flatnonzero(want[len(PROMPT):] == eos)[0])
    _generate(logdir, f"--gen_eos_id={eos}")
    out = capsys.readouterr().out
    assert f"Stopped at eos id {eos} after {stop} tokens" in out
    assert ("Generated tokens: " + " ".join(map(
        str, want[len(PROMPT):len(PROMPT) + stop]))) in out


def test_beam_tokens_equal_jax_beam_search_cached(logdir, capsys):
    toks = _generate(logdir, "--gen_beams=2")
    out, logprob = jgpt.beam_search_cached(jgpt.GptLM(CFG), _params(),
                                           _prompt(), NEW, beam_size=2)
    np.testing.assert_array_equal(toks, np.asarray(out)[0])
    assert (f"Beam search (width 2) best logprob: "
            f"{float(np.asarray(logprob)[0]):.4f}") in capsys.readouterr().out


@pytest.mark.parametrize("on_device", [True, False])
def test_speculative_tokens_equal_jax_device_speculation(logdir, capsys,
                                                         on_device):
    toks = _generate(logdir, "--gen_speculative=4",
                     f"--gen_speculative_device={on_device}")
    want, stats = jgpt.generate_cached_speculative_device(
        jgpt.GptLM(CFG), _params(), _prompt(), NEW, spec_k=4)
    np.testing.assert_array_equal(toks, np.asarray(want)[0])
    out = capsys.readouterr().out
    assert f"Speculative decode: {stats['tokens_generated']} tokens" in out


@pytest.mark.parametrize("schedule,name", [
    ("gpipe", "gpt_mini_pp2"), ("interleaved", "gpt_mini_pp2x2")])
def test_pipelined_namespaces_restore_merged(tmp_path, capsys, schedule,
                                             name):
    """A pipelined run's stage-stacked tree (pipe 2; interleaved: 2
    virtual stages, [n_virtual, n_pipe, per, ...] leaves), in its own
    namespace, decodes the plain tree's greedy tokens."""
    cfg = dataclasses.replace(CFG, num_layers=4)
    params = jax.device_get(jgpt.GptLM(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    if schedule == "interleaved":
        pp = jgpt.split_params_for_pipeline(params, 4, 4)
        pp["stages"] = jax.tree.map(
            lambda x: x.reshape((2, 2) + x.shape[1:]), pp["stages"])
    else:
        pp = jgpt.split_params_for_pipeline(params, 2, 4)
    mgr = ocp.CheckpointManager(str(tmp_path / name / "checkpoints"))
    mgr.save(3, args=ocp.args.StandardSave(
        {"params": pp, "global_step": jnp.asarray(3, jnp.int32)}))
    mgr.wait_until_finished()
    mgr.close()
    toks = _generate(tmp_path, "--pipeline_parallel=2",
                     f"--pipeline_schedule={schedule}",
                     "--pipeline_virtual_stages=2")
    want = np.asarray(jgpt.generate_cached(jgpt.GptLM(cfg), params,
                                           _prompt(), NEW))[0]
    np.testing.assert_array_equal(toks, want)
    assert "Restored global step: 3" in capsys.readouterr().out


def test_every_flag_of_the_jax_cli_is_declared():
    from distributed_tensorflow_tpu import train as jtrain
    assert set(ttrain.FLAGS._defs) - set(jtrain.FLAGS._defs) == {"device"}
    assert set(jtrain.FLAGS._defs) <= set(ttrain.FLAGS._defs)
    for name in jtrain.FLAGS._defs:
        assert ttrain.FLAGS._defs[name][:2] == jtrain.FLAGS._defs[name][:2], \
            name


def test_a_jax_command_line_parses(logdir):
    """Flags of the modes not ported yet parse and change nothing."""
    toks = _generate(logdir, "--sync_replicas=true", "--fsdp",
                     "--platform=cpu", "--attention_backend=pallas",
                     "--job_name=worker", "--task_index=0",
                     "--optimizer=adamw", "--metrics_file=/dev/null")
    np.testing.assert_array_equal(toks, _generate(logdir))


def test_no_checkpoint_warns_and_decodes_a_seeded_init(tmp_path, capsys):
    """The port's random init is torch's, not JAX's: reproducible from
    --seed, other tokens than the JAX CLI's."""
    first = _generate(tmp_path, "--seed=3")
    assert np.array_equal(first, _generate(tmp_path, "--seed=3"))
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint found under" in out
    assert "Restored global step: 1" in out
    assert first.shape == (len(PROMPT) + NEW,)


@pytest.mark.parametrize("flags,error,match", [
    (["--gen_prompt_text=hi"], NotImplementedError, "ROADMAP.*item 7"),
    (["--gen_stop_text=."], NotImplementedError, "ROADMAP.*item 7"),
    # The trainer's paths not ported yet (its async mode is, since slice
    # 7b): the parallelism axes and run profiles.
    (["--mode=train", "--job_name=worker", "--task_index=0",
      "--tensor_parallel=2"], NotImplementedError, "ROADMAP.*item 6"),
    (["--mode=eval", "--job_name=worker", "--task_index=0",
      "--profile=p.json"], NotImplementedError, "ROADMAP.*item 8"),
    (["--model=mnist_mlp"], ValueError, "gpt_mini"),
    (["--gen_beams=2", "--gen_speculative=4"], ValueError, "exclusive"),
    (["--gen_beams=2", "--gen_temperature=0.5"], ValueError, "exclusive"),
    (["--gen_prompt=1,999"], ValueError, "outside vocab"),
])
def test_paths_not_ported_and_bad_flags_raise(logdir, flags, error, match):
    with pytest.raises(error, match=match):
        _generate(logdir, *flags)


def test_the_default_device_needs_cuda(logdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        ttrain.app.run(ttrain.main, ["--mode=generate", "--model=gpt_mini",
                                     f"--logdir={logdir}"])
