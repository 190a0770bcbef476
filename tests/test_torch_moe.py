"""The port's mixture of experts (``distributed_tensorflow_tpu_torch/ops/
moe.py``), BERT-MoE (``models/bert.py``, ``registry.build_bert_moe``) and
the in-process ``expert`` axis against the JAX package's.

- ``MoeMlp`` from the JAX module's weights: output, aux loss and
  gradients (``jax.grad`` of the same scalar) within 1e-5 in fp32, at
  top-1 and top-2, with tokens dropped past the capacity, and the aux
  loss balanced against collapsed routing.
- The expert-sharded forward and gradients (``expert=2``, ``4`` and
  ``expert=2 x model=2`` on ``[cpu] * n`` positions) against the
  unsharded module within 1e-6.
- One ``bert_moe`` SGD step (fp32) against JAX's
  ``make_moe_mlm_loss_fn`` step: loss, ``moe_aux`` and parameters within
  1e-5, unsharded and over the expert positions, and over two data
  rows beside two expert positions (each row its own expert shards).
- The CLI: ``--model=bert_moe --expert_parallel=2 --optimizer=lamb``
  trains, its checkpoint is an unsharded run's (the JAX ``restore_raw``
  reads it; ``--mode=eval`` restores it without the expert axis and
  reports the trained accuracy), and bert_tiny's async exchange across
  two worker processes goes through the logdir side-channel (JAX
  ``tests/test_multiprocess.py:326``).

Inputs from numpy seeds; torch on one thread."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.ops import moe as jmoe
from distributed_tensorflow_tpu.tools.checkpoint_io import (
    restore_raw as jrestore_raw)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.server import Server
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.ops import moe as tmoe
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, flat_names)

H, I, E = 32, 64, 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_moe(top_k, capacity_factor):
    return jmoe.MoeMlp(num_experts=E, intermediate_size=I, top_k=top_k,
                       capacity_factor=capacity_factor)


def _port_moe(params, top_k, capacity_factor):
    m = tmoe.MoeMlp(H, E, I, top_k=top_k, capacity_factor=capacity_factor,
                    device="cpu")
    m.load_state_dict(flat_names(params))
    return m


def _inputs(seed, shape=(3, 16, H)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_grad(top_k, capacity_factor):
    """The jitted value and gradients (w.r.t. the parameters and the
    input) of ``sum(out * w) + aux`` through JAX's ``MoeMlp``."""
    module = _jax_moe(top_k, capacity_factor)

    def f(p, x, w):
        out, mut = module.apply({"params": p}, x,
                                mutable=[jmoe.AUX_LOSS_COLLECTION])
        aux = jmoe.collect_aux_loss(mut)
        return jnp.sum(out * w) + aux, (out, aux)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _jax_run(module, params, x, w):
    """Output, aux loss and gradients of JAX's ``module``."""
    (_, (out, aux)), grads = _jax_grad(module.top_k,
                                       module.capacity_factor)(params, x, w)
    return np.asarray(out), float(aux), jax.device_get(grads)


@pytest.mark.parametrize("top_k,capacity_factor", [
    (1, 2.0), (2, 2.0), (2, 0.5),      # 0.5: tokens dropped past capacity
])
def test_moe_mlp_matches_jax(top_k, capacity_factor):
    module = _jax_moe(top_k, capacity_factor)
    x, w = _inputs(0), _inputs(1)
    params = jax.device_get(module.init(jax.random.PRNGKey(0), x)["params"])
    out, aux, (gp, gx) = _jax_run(module, params, x, w)
    port = _port_moe(params, top_k, capacity_factor)
    tx = torch.tensor(x, requires_grad=True)
    got = port(tx)
    got_aux = tmoe.collect_aux_loss(port)
    ((got * torch.tensor(w)).sum() + got_aux).backward()
    np.testing.assert_allclose(got.detach().numpy(), out, **TOL)
    assert float(got_aux.detach()) == pytest.approx(aux, rel=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), gx, **TOL)
    for name, p in port.named_parameters():
        want = gp
        for key in name.split("."):
            want = want[key]
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name, **TOL)
    if capacity_factor < 1.0:
        # Dropped tokens: some outputs lose (part of) their experts.
        combine, _ = port.route(tx.detach().reshape(3, 16, H))
        assert float(combine.sum()) < 3 * 16 - 1e-3
    assert port.aux_loss is None            # read and cleared


def test_aux_loss_balanced_against_collapsed_routing():
    module = _jax_moe(2, 2.0)
    x = np.abs(_inputs(2))
    params = jax.device_get(module.init(jax.random.PRNGKey(1), x)["params"])
    # A zero router: uniform probabilities, the Switch loss's balanced
    # value 1; a router sending every token to expert 0: collapsed, E.
    uniform = jax.tree.map(np.copy, params)
    uniform["router"]["kernel"][:] = 0.0
    collapsed = jax.tree.map(np.copy, uniform)
    collapsed["router"]["kernel"][:, 0] = 5.0
    auxes = []
    for p in (params, uniform, collapsed):
        _, want, _ = _jax_run(module, p, x, np.zeros_like(x))
        port = _port_moe(p, 2, 2.0)
        port(torch.tensor(x))
        got = float(tmoe.collect_aux_loss(port))
        assert got == pytest.approx(want, rel=1e-5)
        auxes.append(got)
    assert auxes[1] == pytest.approx(1.0, rel=1e-6)
    assert auxes[2] > 0.9 * E


def _placed(module, expert, model=1):
    state = TrainState.create(module, topt.make_optimizer("sgd", 0.1))
    mesh = tmesh.create_mesh(data=1, expert=expert, model=model,
                             devices=["cpu"] * (expert * model))
    tsh.shard_state(mesh, state, tsh.ShardingRules(
        tmoe.moe_sharding_rules()))
    return state


@pytest.mark.parametrize("expert,model", [(2, 1), (4, 1), (2, 2)])
def test_expert_sharded_forward_and_gradients(expert, model):
    x, w = _inputs(3), _inputs(4)
    rng = np.random.default_rng(5)
    shapes = {"router": {"kernel": (H, E)},
              "experts": {"wi": {"kernel": (E, H, I), "bias": (E, I)},
                          "wo": {"kernel": (E, I, H), "bias": (E, H)}}}
    params = jax.tree.map(lambda s: (rng.normal(size=s) * 0.2).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
    whole = _port_moe(params, 2, 2.0)
    split = _port_moe(params, 2, 2.0)
    _placed(split, expert, model)
    assert len(tsh.shards(split.experts.wi, "kernel")) == expert
    outs = []
    for m in (whole, split):
        out = m(torch.tensor(x))
        ((out * torch.tensor(w)).sum() + tmoe.collect_aux_loss(m)).backward()
        outs.append(out.detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    for sub in ("wi", "wo"):
        for leaf in ("kernel", "bias"):
            d = getattr(whole.experts, sub)
            pieces = tsh.shards(getattr(split.experts, sub), leaf)
            got = torch.cat([p.grad for p in pieces])
            torch.testing.assert_close(got, getattr(d, leaf).grad,
                                       rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(split.router.kernel.grad,
                               whole.router.kernel.grad,
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- BERT-MoE


SEQ = 16
#: BERT-tiny's widths, one layer and a 512-word vocabulary (the JAX
#: step compiles in a few seconds).
CFG = dict(num_experts=E, dtype="float32", vocab_size=512, num_layers=1)


@functools.lru_cache(maxsize=None)
def _jax_bert_step(lr=0.1):
    """JAX BERT-MoE (fp32): its parameters, one SGD step of
    ``make_moe_mlm_loss_fn`` on the synthetic batch, its loss and aux."""
    cfg = dataclasses.replace(jbert.tiny(), **CFG)
    model = jbert.BertForMLM(cfg)
    # The port's init (seed 0) as the flax tree: no JAX init to compile.
    params = tbert.params_to_jax(tbert.BertForMLM(
        dataclasses.replace(tbert.tiny(), **CFG), device="cpu").state_dict())
    batch = jbert.synthetic_mlm_batch(3, 8, SEQ, cfg)
    loss_fn = jbert.make_moe_mlm_loss_fn(model)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, batch)
    after = jax.tree.map(lambda p, g: np.asarray(p - lr * g), params, grads)
    return params, batch, float(loss), float(aux["moe_aux"]), after


@pytest.mark.parametrize("expert,model", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_bert_moe_sync_step_matches_jax(expert, model):
    """``registry.build_bert_moe``'s model, objective and rules (one
    layer, a 512-word vocabulary) against JAX's step."""
    params, batch, loss, aux, after = _jax_bert_step()
    cfg = dataclasses.replace(tbert.tiny(), **CFG)
    net = tbert.BertForMLM(cfg, device="cpu")
    net.load_state_dict(tbert.params_from_jax(params))
    state = TrainState.create(net, topt.make_optimizer("sgd", 0.1),
                              params_to_tree=tbert.params_to_jax,
                              params_from_tree=tbert.params_from_jax)
    mesh = tmesh.create_mesh(data=1, expert=expert, model=model,
                             devices=["cpu"] * (expert * model))
    state = tmesh.ParallelConfig(data=1, expert=expert, model=model) \
        .place_state(mesh, state, tbert.bert_moe_sharding_rules())
    step = tsync.build_sync_train_step(tbert.make_moe_mlm_loss_fn())
    state, m = step(state, batch)
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    assert float(m["moe_aux"]) == pytest.approx(aux, rel=1e-5)
    got = tbert.params_from_jax(checkpoint_tree(state)["params"])
    for name, want in tbert.params_from_jax(after).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   err_msg=name, **TOL)


def test_bert_moe_rules_put_experts_on_expert_then_tp():
    rules = tbert.bert_moe_sharding_rules()
    assert tuple(rules.spec_for("bert/layer0/moe/experts/wi/kernel")) == (
        "expert", None, None)
    assert tuple(rules.spec_for("bert/layer1/moe/experts/wo/bias")) == (
        "expert", None)
    assert tuple(rules.spec_for("bert/layer0/attention/qkv/kernel")) == (
        None, None, "model", None)
    assert tuple(rules.spec_for("bert/layer0/moe/router/kernel")) == ()


# ---------------------------------------------------------------- CLI


@pytest.fixture
def standalone(monkeypatch):
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def test_cli_expert_parallel_trains_and_eval_restores(tmp_path, standalone,
                                                      capsys):
    logdir = tmp_path / "logdir"
    common = ["--job_name=worker", "--task_index=0", "--device=cpu",
              "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
              "--model=bert_moe", "--bert_seq_len=16", "--batch_size=8",
              "--bert_dtype=float32", "--optimizer=lamb",
              "--learning_rate=0.03", "--sync_replicas=true",
              f"--logdir={logdir}"]
    result = ttrain.app.run(ttrain.main, common + [
        "--expert_parallel=2", "--train_steps=4", "--log_sharding"])
    out = capsys.readouterr().out
    assert "mesh dp-1-ep2-mb1 (expert=2, seq=1, model=1)" in out
    assert re.search(r"param bert/layer0/moe/experts/wi/kernel \(4, 128, "
                     r"512\) -> PartitionSpec\('expert', None, None\) on "
                     r"cpu, cpu", out), out
    trained = result.test_accuracy
    assert trained > 0.0               # the eval gate below is not 0 == 0
    # The checkpoint is an unsharded run's: the JAX reader sees whole
    # stacked experts and optax's lamb state.
    raw, step, _ = jrestore_raw(str(logdir / "bert_moe"))
    assert step == result.final_global_step
    layer = raw["params"]["bert"]["layer0"]["moe"]
    assert np.asarray(layer["experts"]["wi"]["kernel"]).shape == (4, 128,
                                                                   512)
    lamb = raw["opt_state"][0]
    assert np.asarray(lamb["mu"]["bert"]["layer0"]["moe"]["experts"]["wo"][
        "kernel"]).shape == (4, 512, 128)
    got = ttrain.app.run(ttrain.main, common + ["--mode=eval"])
    assert got["global_step"] == step
    assert got["test_accuracy"] == trained


def test_bert_tiny_async_exchange_across_processes(tmp_path):
    """JAX ``tests/test_multiprocess.py:326``: bert_tiny's tree (~4.5M
    parameters, 18 MB fp32) crosses the binary threshold, so two async
    workers exchange it through the logdir side-channel."""
    from helpers import free_port
    from test_torch_async_cli import finish, launch, stop
    ps_port, worker_ports = free_port(), [free_port(), free_port()]
    logdir = str(tmp_path / "logdir")
    extra = ("--model=bert_tiny", "--bert_seq_len=16", "--batch_size=8",
             "--bert_dtype=float32", "--async_sync_period=6",
             "--validation_every=0", "--save_interval_steps=1000000")
    ps = launch("ps", 0, ps_port, worker_ports, logdir, *extra)
    try:
        pace = "--inject_step_delay=0.75:1:1000000000"
        w0 = launch("worker", 0, ps_port, worker_ports, logdir, *extra,
                    pace, train_steps=12)
        w1 = launch("worker", 1, ps_port, worker_ports, logdir, *extra,
                    pace, train_steps=12)
        out0, out1 = finish(w0), finish(w1)
        assert w0.returncode == 0, out0
        assert w1.returncode == 0, out1
        combined = out0 + out1
        assert "averaged parameters with 1 peer(s)" in combined, combined
        assert "(binary publish" in combined, combined
    finally:
        stop(ps)


def test_bert_moe_over_data_rows_beside_the_expert_axis():
    """data=2 x expert=2: each data row holds its own expert shards, the
    dispatched rows of a row go to the positions that own their experts,
    and the step (the rows' mean) is JAX's step on the whole batch."""
    params, batch, loss, aux, after = _jax_bert_step()
    cfg = dataclasses.replace(tbert.tiny(), **CFG)
    net = tbert.BertForMLM(cfg, device="cpu")
    net.load_state_dict(tbert.params_from_jax(params))
    state = TrainState.create(net, topt.make_optimizer("sgd", 0.1),
                              params_to_tree=tbert.params_to_jax,
                              params_from_tree=tbert.params_from_jax)
    mesh = tmesh.create_mesh(data=2, expert=2, devices=["cpu"] * 4)
    state = tmesh.ParallelConfig(data=2, expert=2).place_state(
        mesh, state, tbert.bert_moe_sharding_rules())
    assert len(state.rows) == 1
    step = tsync.build_sync_train_step(tbert.make_moe_mlm_loss_fn())
    state, m = step(state, batch)
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    got = tbert.params_from_jax(checkpoint_tree(state)["params"])
    for name, want in tbert.params_from_jax(after).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   err_msg=name, **TOL)
