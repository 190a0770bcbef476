"""The port's lamb, adagrad, rmsprop and adafactor
(``distributed_tensorflow_tpu_torch/training/optimizers.py``) against
optax through the JAX package's ``make_optimizer``.

- Five steps from the same parameters and gradients, with and without
  the clip, weight decay and a schedule; adafactor on factored (two dims
  of 128 or more) and unfactored leaves.  fp32, parameters within 1e-6
  (relative and absolute).
- Checkpoints both ways: the port's state written by ``save_raw`` reads
  in the JAX ``restore_raw`` as optax's state tree (slots within 1e-6 of
  a JAX run of the same steps); the JAX Supervisor's checkpoint of that
  run restores into the port and the next step equals JAX's.
- Adafactor's slots are sublinear; ``--trainable_params`` leaves frozen
  leaves without slots; a split parameter (the expert axis) takes the
  whole leaf's statistics.

Inputs from numpy seeds; torch on one thread."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.training import optimizers as jopt
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu.training.supervisor import (
    Supervisor as JSupervisor)
from distributed_tensorflow_tpu.tools.checkpoint_io import (
    restore_raw as jrestore_raw)
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.tools.checkpoint_io import (
    restore_raw, save_raw)
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, load_checkpoint_tree)

NEW = ("lamb", "adagrad", "rmsprop", "adafactor")
TOL = dict(rtol=1e-6, atol=1e-6)
#: factored (130 x 200, 4 x 128 x 144) and unfactored (5, 3 x 7,
#: 100 x 100) leaves
SHAPES = {"a": (130, 200), "b": (5,), "c": (4, 128, 144), "d": (3, 7),
          "e": (100, 100)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(seed, shapes, steps):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    return params, grads


def _schedules(kind, lr=0.05):
    if kind == "constant":
        return lr, lr
    return (optax.linear_schedule(lr, 0.0, 10),
            topt.make_schedule("linear", lr, decay_steps=10))


def _jax_run(tx, params, grads):
    update = jax.jit(tx.update)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(p)
    for g in grads:
        u, st = update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        p = optax.apply_updates(p, u)
    return p, st


@pytest.mark.parametrize("chain", ["plain", "clip_decay"])
@pytest.mark.parametrize("schedule", ["constant", "linear"])
@pytest.mark.parametrize("name", NEW)
def test_rule_matches_optax_over_five_steps(name, schedule, chain):
    kw = (dict(weight_decay=0.01, grad_clip_norm=1.0)
          if chain == "clip_decay" else {})
    jlr, tlr = _schedules(schedule)
    params, grads = _draws(0, SHAPES, 5)
    want, _ = _jax_run(jopt.make_optimizer(name, jlr, **kw), params, grads)
    ps = [torch.nn.Parameter(torch.tensor(params[k])) for k in SHAPES]
    opt = topt.make_optimizer(name, tlr, **kw).init(ps)
    for g in grads:
        for p, k in zip(ps, SHAPES):
            p.grad = torch.tensor(g[k])
        opt.step()
    for p, k in zip(ps, SHAPES):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_every_jax_optimizer_builds():
    """``make_optimizer`` takes every name of JAX's ``OPTIMIZERS``."""
    assert topt.OPTIMIZERS == jopt.OPTIMIZERS
    p = torch.nn.Parameter(torch.ones(3))
    for name in topt.OPTIMIZERS:
        opt = topt.make_optimizer(name, 0.1).init([p])
        p.grad = torch.ones(3)
        opt.step()
    with pytest.raises(ValueError, match="Unknown"):
        topt.make_optimizer("nope", 0.1)


# ------------------------------------------------------- checkpoints


HIDDEN = 128        # hid/kernel [784, 128] factors; sm/kernel [128, 10] not


def _raw(tree):
    """An optax state as the raw tree a checkpoint holds: named tuples as
    dicts, tuples as lists, empty states and masked leaves as None."""
    if isinstance(tree, (optax.EmptyState, optax.MaskedNode)):
        return None
    if hasattr(tree, "_fields"):
        return {f: _raw(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return [_raw(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _raw(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_trees_close(got, want, path="opt_state"):
    if want is None:
        assert got is None or (isinstance(got, dict) and not got), path
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, f"{path}/{i}")
        return
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=path, **TOL)


def _port_state(name, params, lr, kw):
    model = tmlp.MnistMLP(HIDDEN, seed=0, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params))
    return TrainState.create(model, topt.make_optimizer(name, lr, **kw),
                             params_to_tree=tmlp.params_to_jax,
                             params_from_tree=tmlp.params_from_jax)


def _port_step(state, grads):
    for n, p in state.model.named_parameters():
        layer, leaf = n.split(".")
        p.grad = torch.tensor(grads[layer][leaf])
    state.apply_gradients()


@pytest.mark.parametrize("name", NEW)
def test_checkpoints_cross_the_packages(name, tmp_path):
    kw = dict(weight_decay=0.01, grad_clip_norm=1.0)
    jlr, tlr = _schedules("linear")
    model = jmlp.MnistMLP(hidden_units=HIDDEN)
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 784)))["params"])
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32), params) for _ in range(4)]
    tx = jopt.make_optimizer(name, jlr, **kw)
    jstate = JState.create(lambda p, x: model.apply({"params": p}, x),
                           params, tx)
    apply = jax.jit(lambda st, g: st.apply_gradients(g))
    for g in grads[:3]:
        jstate = apply(jstate, g)

    # Port -> JAX: the port's save_raw, read by the JAX restore_raw.
    port = _port_state(name, params, tlr, kw)
    for g in grads[:3]:
        _port_step(port, g)
    save_raw(str(tmp_path / "port" / "checkpoints"), 4,
             checkpoint_tree(port))
    raw, step, _ = jrestore_raw(str(tmp_path / "port"))
    assert step == 4 and int(raw["global_step"]) == 4
    _assert_trees_close(raw["opt_state"], _raw(jstate.opt_state))

    # JAX -> port: the JAX Supervisor's checkpoint restores into a fresh
    # port state, and the next step is JAX's.
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path / "jax"),
                      init_fn=lambda: jstate)
    jsv.prepare_or_wait_for_state()
    jsv.maybe_save(jstate, force=True)
    jsv.close()
    tree, _, _ = restore_raw(str(tmp_path / "jax"))
    fresh = _port_state(name, params, tlr, kw)
    load_checkpoint_tree(fresh, tree)
    assert fresh.global_step == 4 and fresh.optimizer.count == 3
    _port_step(fresh, grads[3])
    jstate = apply(jstate, grads[3])
    for n, p in fresh.model.named_parameters():
        layer, leaf = n.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstate.params[layer][leaf]),
                                   err_msg=n, **TOL)


def test_adafactor_slots_are_sublinear():
    """Factored slots: a row and a column vector for a matrix whose two
    dims reach 128; a full ``v`` below that (JAX
    ``tests/test_optimizers.py``'s case)."""
    big = torch.nn.Parameter(torch.zeros(512, 256))
    small = torch.nn.Parameter(torch.zeros(16, 8))
    opt = topt.make_optimizer("adafactor", 0.01).init([big, small])
    slots = opt.base.state
    n_big = sum(v.numel() for v in slots[big].values())
    assert n_big == 512 + 256 + 1
    assert n_big < 0.01 * big.numel()
    assert slots[small]["v"].shape == small.shape


@pytest.mark.parametrize("name", NEW)
def test_frozen_parameters_keep_no_slots(name):
    """``freeze_except`` with each rule: the frozen leaves get no slots
    and no update, and the checkpoint masks them (optax's
    ``multi_transform`` layout)."""
    state = _port_state(name, jax.device_get(jmlp.MnistMLP(
        hidden_units=HIDDEN).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 784)))["params"]), 0.01, {})
    from distributed_tensorflow_tpu_torch.training.state import apply_freeze
    spec, n_train, _ = topt.freeze_except(
        state.optimizer.spec, checkpoint_tree(state)["params"], r"^sm/")
    apply_freeze(state, spec)
    frozen = state.model.hid.kernel.detach().clone()
    _port_step(state, jax.tree.map(np.ones_like, checkpoint_tree(state)[
        "params"]))
    assert torch.equal(state.model.hid.kernel, frozen)
    assert set(state.optimizer.base.state) == {state.model.sm.kernel,
                                               state.model.sm.bias}
    inner = checkpoint_tree(state)["opt_state"]["inner_states"]
    base = inner["train"]["inner_state"][0]
    slot = next(k for k in base if k != "count")
    assert base[slot]["hid"] == {"bias": None, "kernel": None}
    assert base[slot]["sm"]["kernel"] is not None
    assert n_train == 128 * 10 + 10


@pytest.mark.parametrize("name", ["lamb", "adafactor"])
def test_a_split_leaf_takes_the_whole_leafs_statistics(name):
    """A parameter split over the expert axis (its shards separate
    parameters) steps as the whole one: lamb's trust ratio and
    adafactor's factored means and RMS scalings span every shard; the
    checkpoint tree gathers to the unsplit run's."""
    params, grads = _draws(3, {"w": (4, 128, 160)}, 3)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(params["w"]))

    def run(expert):
        model = M()
        state = TrainState.create(model, topt.make_optimizer(name, 0.05))
        if expert > 1:
            mesh = tmesh.create_mesh(data=1, expert=expert,
                                     devices=["cpu"] * expert)
            tsh.shard_state(mesh, state, tsh.ShardingRules(
                [(r"w", tsh.P("expert", None, None))]))
        for g in grads:
            pieces = tsh.shards(model, "w") or [model.w]
            for p, gp in zip(pieces, torch.tensor(g["w"]).chunk(
                    len(pieces))):
                p.grad = gp.clone()
            state.apply_gradients()
        return checkpoint_tree(state)

    whole, split = run(1), run(2)
    np.testing.assert_allclose(split["params"]["w"], whole["params"]["w"],
                               **TOL)
    _assert_trees_close(split["opt_state"], _raw_np(whole["opt_state"]))


def _raw_np(tree):
    if isinstance(tree, dict):
        return {k: _raw_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_raw_np(v) for v in tree]
    return None if tree is None else np.asarray(tree)


@pytest.mark.parametrize("name", ["lamb", "adafactor"])
def test_a_pipeline_stack_takes_the_stacked_leafs_statistics(name):
    """The pipelined GPT keeps each layer a parameter of its own where
    JAX stacks a stage's layers into one leaf (``stages`` [n_pipe, per,
    ...]): lamb's trust ratio and adafactor's block RMS must span the
    stack.  One step of the port against optax's update of the stacked
    tree with the port's own gradients."""
    from distributed_tensorflow_tpu_torch.models import gpt as tgpt
    from distributed_tensorflow_tpu_torch.models import registry as treg
    width = dict(vocab_size=64, hidden_size=128, num_layers=4, num_heads=2,
                 intermediate_size=256, max_position=32)
    mesh = tmesh.create_mesh(data=1, pipe=2, devices=["cpu"] * 2)
    bundle = treg.build_gpt_pipeline(
        0.01, mesh, seq_len=16, n_micro=2, dtype="float32",
        tx=topt.make_optimizer(name, 0.01), width=width)
    state = bundle.state
    model = state.model
    # Copies: a tree's unstacked leaves may be views of the parameters.
    params = jax.tree.map(np.copy, checkpoint_tree(state)["params"])
    tokens = tgpt.synthetic_lm_batch(1, 4, 16, tgpt.GptConfig(**width))
    loss, _ = bundle.loss_fn(model, tokens)
    loss.backward()
    grads = jax.tree.map(np.copy, model.params_to_tree(
        {n: p.grad for n, p in model.named_parameters()}))
    state.apply_gradients()
    tx = jopt.make_optimizer(name, 0.01)
    u, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    want = optax.apply_updates(params, u)
    got = checkpoint_tree(state)["params"]
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), **TOL), got, want)


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_pipelined_adafactor_checkpoints_cross_the_packages(schedule,
                                                            tmp_path):
    """Adafactor beside the pipeline: the stage-stacked leaf holds ONE
    ``[1]`` placeholder a slot, as optax's state does, where the port
    keeps one a layer.  The port's ``save_raw`` reads in the JAX
    ``restore_raw`` as optax's state after the same update; the JAX
    Supervisor's checkpoint of that state restores into a fresh port
    state; the next update equals optax's.  fp32, within 1e-6."""
    from distributed_tensorflow_tpu_torch.models import gpt as tgpt
    from distributed_tensorflow_tpu_torch.models import registry as treg
    width = dict(vocab_size=64, hidden_size=128, num_layers=4, num_heads=2,
                 intermediate_size=256, max_position=32)
    mesh = tmesh.create_mesh(data=1, pipe=2, devices=["cpu"] * 2)

    def build():
        return treg.build_gpt_pipeline(
            0.01, mesh, seq_len=16, n_micro=2, dtype="float32",
            schedule=schedule, tx=topt.make_optimizer("adafactor", 0.01),
            width=width)

    bundle = build()
    state, model = bundle.state, bundle.state.model
    params = jax.tree.map(np.copy, checkpoint_tree(state)["params"])
    tokens = tgpt.synthetic_lm_batch(1, 4, 16, tgpt.GptConfig(**width))
    loss, _ = bundle.loss_fn(model, tokens)
    loss.backward()
    named_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    grads = jax.tree.map(np.copy, model.params_to_tree(named_grads))
    state.apply_gradients()
    tx = jopt.make_optimizer("adafactor", 0.01)
    u, jopt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    jparams = optax.apply_updates(params, u)

    # Port -> JAX.
    save_raw(str(tmp_path / "port" / "checkpoints"), 2,
             checkpoint_tree(state))
    raw, step, _ = jrestore_raw(str(tmp_path / "port"))
    assert step == 2
    _assert_trees_close(raw["opt_state"], _raw(jopt_state))

    # JAX -> port, then one more update against optax's.
    jstate = JState(params=jparams, opt_state=jopt_state,
                    global_step=jnp.asarray(2, jnp.int32), apply_fn=None,
                    tx=tx)
    jsv = JSupervisor(is_chief=True, logdir=str(tmp_path / "jax"),
                      init_fn=lambda: jstate)
    jsv.prepare_or_wait_for_state()
    jsv.maybe_save(jstate, force=True)
    jsv.close()
    tree, _, _ = restore_raw(str(tmp_path / "jax"))
    fresh = build().state
    load_checkpoint_tree(fresh, tree)
    for n, p in fresh.model.named_parameters():
        p.grad = named_grads[n].clone()
    fresh.apply_gradients()
    u, _ = jax.jit(tx.update)(grads, jopt_state, jparams)
    want = optax.apply_updates(jparams, u)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), **TOL), checkpoint_tree(fresh)["params"], want)
