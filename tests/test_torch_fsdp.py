"""The port's FSDP/ZeRO-3 (distributed_tensorflow_tpu_torch/parallel/
sharding.fsdp_state, FsdpExchange, parallel/sync.FsdpStep, train.py --fsdp)
held to the JAX package's tests/test_fsdp.py, case by case.

The port's data axis is the sync trainer's worker processes, so FSDP
shards over a process group: the library cases run in ONE module-scoped
spawn of two gloo ranks on the CPU (``_RANK``), which writes each
case's numbers, and each test asserts its own part of them.  The JAX side
runs as its tests run it, jitted on the 8 fake CPU devices of
tests/conftest.py, on a data=2 mesh (a prefix of them) where the port has
two workers: each worker's slice shape is JAX's
``addressable_shards[0]``.  The step is held to the replicated two-worker
sync step within JAX's atol 1e-5 (rtol 1e-5 on the loss); checkpoints
go both ways through ``save_raw`` and the JAX Supervisor.  JAX's
adafactor case (factored slots under FSDP x TP) is held to optax's
unsplit run within 1e-6."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.training import optimizers as jopt
from distributed_tensorflow_tpu.training.supervisor import (
    Supervisor as JSupervisor)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.tools.checkpoint_io import restore_raw
from distributed_tensorflow_tpu_torch.training import optimizers as topt

from helpers import free_port, make_mlp_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MIN = 1024
HIDDEN = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- spec unit


def _spec(base, shape, n, **kw):
    port = tuple(tsh.fsdp_spec(tsh.P(*base), shape, n, **kw))
    assert port == tuple(jsh.fsdp_spec(JP(*base), shape, n, **kw))
    return port


def test_fsdp_spec_picks_largest_divisible_dim():
    assert _spec((), (128, 512), 8, min_size=1) == (None, "data")
    assert _spec((), (512, 128), 8, min_size=1) == ("data", None)


def test_fsdp_spec_skips_claimed_and_indivisible_dims():
    assert _spec((None, "model"), (512, 512), 8, min_size=1) == (
        "data", "model")
    assert _spec((), (7, 3), 8, min_size=1) == ()


def test_fsdp_spec_respects_min_size_and_axis_one():
    assert _spec((), (8, 8), 8, min_size=1024) == ()
    assert _spec((), (1024, 1024), 1, min_size=1) == ()


def test_fsdp_rules_compose_with_tp_base():
    tp = tsh.ShardingRules([(r"kernel", tsh.P(None, "model"))])
    rules = tsh.FsdpRules(tp, 8, min_size=1)
    assert rules.spec_for("layer/kernel", torch.zeros(512, 256)) == (
        "data", "model")
    assert rules.spec_for("layer/bias", torch.zeros(256)) == ("data",)
    assert rules.spec_for("step", torch.zeros(())) == ()


# ------------------------------------------------------ the two-rank spawn


_RANK = r"""
import json, sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from distributed_tensorflow_tpu_torch.models import mlp, registry
from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_lib, sync
from distributed_tensorflow_tpu_torch.parallel import sharding as sh
from distributed_tensorflow_tpu_torch.parallel.pipeline import (
    build_1f1b_pipeline_train_step)
from distributed_tensorflow_tpu_torch.tools.checkpoint_io import (
    restore_raw, save_raw)
from distributed_tensorflow_tpu_torch.training.optimizers import (
    make_optimizer)
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, load_checkpoint_tree)
from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor
rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
CPU = torch.device("cpu")
d = np.load(data)
res, arrays = {}, {}

def state(tx="adam", rng=False):
    model = mlp.MnistMLP(64, seed=0, device="cpu")
    g = torch.Generator().manual_seed(7) if rng else None
    return TrainState.create(model, make_optimizer(tx, 0.01), rng=g,
                             params_to_tree=mlp.params_to_jax,
                             params_from_tree=mlp.params_from_jax)

def loss_fn(m, batch):
    x, y = (torch.as_tensor(a) for a in batch)
    logits = m(x)
    return mlp.cross_entropy_loss(logits, y), {
        "accuracy": mlp.accuracy(logits, y)}

def half(a):
    n = a.shape[0] // 2
    return a[rank * n:(rank + 1) * n]

def nbytes(st):
    slots = [v for p in st.optimizer.params
             for v in st.optimizer.base.state.get(p, {}).values()
             if torch.is_tensor(v) and v.dim()]
    return (sum(p.numel() * p.element_size() for p in st.model.parameters()),
            sum(v.numel() * v.element_size() for v in slots))

mesh = mesh_lib.create_mesh(data=1, devices=[CPU])
repl = state()
f = sh.fsdp_state(mesh, state(), min_size=1024)
def specs(st):
    out = {n: [] for n, _ in st.model.named_parameters()}
    out.update({n: list(i.spec) for n, _, _, i in sh.fsdp_entries(st.model)})
    return out
res["specs"] = specs(f)
res["shapes"] = {n: list(p.shape) for n, p in f.model.named_parameters()}

# The step: FSDP against the replicated two-worker sync step, same batches.
ar = sync.GradientAllReduce()
s_repl = sync.build_sync_train_step(loss_fn, all_reduce=ar,
                                    log_grad_norm=True)
s_fsdp = sync.build_sync_train_step(loss_fn, all_reduce=ar,
                                    log_grad_norm=True)
res["loss_repl"], res["loss_fsdp"], res["norm_repl"], res["norm_fsdp"] = (
    [], [], [], [])
def slot_shapes(st):
    # torch.optim makes Adam's slots at the first step.
    return {n: [list(v.shape) for v in st.optimizer.base.state.get(
        p, {}).values() if torch.is_tensor(v) and v.dim()]
        for n, p in st.model.named_parameters()}
for i, (x, y) in enumerate(zip(d["x"], d["y"])):
    repl, m = s_repl(repl, (half(x), half(y)))
    res["loss_repl"].append(float(m["loss"]))
    res["norm_repl"].append(float(m["grad_norm"]))
    f, m = s_fsdp(f, (half(x), half(y)))
    res["loss_fsdp"].append(float(m["loss"]))
    res["norm_fsdp"].append(float(m["grad_norm"]))
    if i == 0:
        res["slot_shapes_before"] = slot_shapes(f)
        res["bytes_fsdp"], res["bytes_repl"] = nbytes(f), nbytes(repl)
res["shapes_after"] = {n: list(p.shape) for n, p in f.model.named_parameters()}
res["slot_shapes_after"] = slot_shapes(f)
whole = sh.FsdpExchange(f.model).gather_named(dict(f.model.named_parameters()))
for n, p in whole.items():
    arrays["fsdp:" + n] = p.detach().numpy()
for n, p in repl.model.named_parameters():
    arrays["repl:" + n] = p.detach().numpy()

# Clipping by the global norm: a small GPT (slices along dim 0 and along
# other dims), plain SGD so that the clip factor is the update's scale,
# a limit the first step's norm is over.
from distributed_tensorflow_tpu_torch.models import gpt
CLIP = 0.05
gcfg = gpt.GptConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64, max_position=64,
                     dtype="float32")
def gpt_state():
    return TrainState.create(
        gpt.GptLM(gcfg, device="cpu", seed=0, param_dtype=torch.float32),
        make_optimizer("sgd", 0.5, grad_clip_norm=CLIP),
        params_to_tree=gpt.params_to_jax, params_from_tree=gpt.params_from_jax)
def gpt_loss(m, batch):
    tokens = torch.as_tensor(batch["tokens"]).long()
    loss, acc = gpt.lm_loss(m(tokens), tokens)
    return loss, {"accuracy": acc}
cr = gpt_state()
cf = sh.fsdp_state(mesh, gpt_state(), min_size=512)
res["clip"] = CLIP
res["clip_split"] = {n: i.dim for n, _, _, i in sh.fsdp_entries(cf.model)}
step_r = sync.build_sync_train_step(gpt_loss, all_reduce=ar,
                                    log_grad_norm=True)
step_f = sync.build_sync_train_step(gpt_loss, all_reduce=ar,
                                    log_grad_norm=True)
res["clip_norm_repl"], res["clip_norm_fsdp"] = [], []
for _ in range(3):
    cr, m = step_r(cr, {"tokens": half(d["tokens"])})
    res["clip_norm_repl"].append(float(m["grad_norm"]))
    cf, m = step_f(cf, {"tokens": half(d["tokens"])})
    res["clip_norm_fsdp"].append(float(m["grad_norm"]))
whole = sh.FsdpExchange(cf.model).gather_named(dict(cf.model.named_parameters()))
for n, p in whole.items():
    arrays["clipf:" + n] = p.detach().numpy()
for n, p in cr.model.named_parameters():
    arrays["clipr:" + n] = p.detach().numpy()

# Composed with tensor parallelism over an in-process model axis.
tp_mesh = mesh_lib.create_mesh(data=1, model=2, devices=[CPU] * 2)
rules = sh.ShardingRules([(r"hid/kernel", sh.P(None, "model"))])
t = sh.fsdp_state(tp_mesh, state(), rules, min_size=1024)
res["tp_specs"] = specs(t)
res["tp_shapes"] = {n: list(p.shape) for n, p in t.model.named_parameters()}
t, m = sync.build_sync_train_step(loss_fn, all_reduce=ar)(
    t, (half(d["x"][0]), half(d["y"][0])))
res["tp_loss"] = float(m["loss"])

# Adafactor under FSDP x TP (JAX tests/test_fsdp.py:158): w [512, 256]
# split over the model axis and each shard over the workers; the
# factored v_row/v_col stay whole (replicated), and the step reads the
# whole leaf (its row/column means and RMS over every piece).
class W(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((512, 256), 0.01))
def w_loss(m, batch):
    x = torch.as_tensor(batch[0])
    return ((x @ sh.full(m, "w") - 1.0) ** 2).mean(), {}
a = sh.fsdp_state(tp_mesh, TrainState.create(
    W(), make_optimizer("adafactor", 0.01)),
    sh.ShardingRules([(r"w", sh.P(None, "model"))]), min_size=1024)
res["ada_specs"] = specs(a)
res["ada_slots"] = {k: list(v.shape) for k, v in a.optimizer.base.state[
    a.model.w_shard0].items()}
ada_step = sync.build_sync_train_step(w_loss, all_reduce=ar)
res["ada_loss"] = []
for _ in range(2):
    a, m = ada_step(a, (half(d["x"][0][:8, :512]),))
    res["ada_loss"].append(float(m["loss"]))
tree = checkpoint_tree(a)
arrays["ada_w"] = np.asarray(tree["params"]["w"])
for k in ("v_row", "v_col"):
    arrays["ada_" + k] = np.asarray(tree["opt_state"][0][k]["w"])

# The rng and global_step stay replicated.
r0 = state(rng=True)
g = r0.rng
r1 = sh.fsdp_state(mesh, r0, min_size=1024)
res["rng_kept"] = r1.rng is g and r1.global_step == 1

# Non-trainable state: ResNet-20's BatchNorm statistics stay whole, the
# model's buffers, through the placement and a stateful step.
import hashlib
rn = registry.build_resnet20(0.01, device="cpu",
                             tx=make_optimizer("sgd", 0.01))
whole = {n: t.clone() for n, t in rn.state.model_state.items()}
rs = sh.fsdp_state(mesh, rn.state, min_size=1024)
res["bn_split"] = sorted(n for n, _, _, _ in sh.fsdp_entries(rs.model))
res["bn_stats_whole"] = all(torch.equal(rs.model_state[n], t)
                            for n, t in whole.items())
res["bn_stats_are_buffers"] = all(
    rs.model_state[n] is b for n, b in rs.model.named_buffers())
rng_x = np.random.default_rng(rank)
rs, _ = sync.build_stateful_sync_train_step(rn.stateful_loss_fn,
                                            all_reduce=ar)(
    rs, (rng_x.random((4, 3072), np.float32),
         np.eye(10, dtype=np.float32)[rng_x.integers(0, 10, 4)]))
h = hashlib.sha256()
for n in sorted(rs.model_state):
    h.update(rs.model_state[n].numpy().tobytes())
res["bn_stats_digest"] = h.hexdigest()

# Checkpoints: a replicated save restores into FSDP; an FSDP save (a
# collective, the chief writes) is the unsharded tree.
ckdir = store + ".ckpt"
if rank == 0:
    r = state()
    r.global_step = 5
    save_raw(ckdir + "/repl/checkpoints", 5, checkpoint_tree(r))
dist.barrier()
f2 = sh.fsdp_state(mesh, state(), min_size=1024)
load_checkpoint_tree(f2, restore_raw(ckdir + "/repl")[0])
res["restored_step"] = f2.global_step
for n, p in f2.model.named_parameters():
    arrays["restored:" + n] = p.detach().numpy()
sv = Supervisor(is_chief=rank == 0, logdir=ckdir + "/fsdp",
                init_fn=lambda: f)
res["saved"] = sv.maybe_save(f, force=True)
sv.close()
dist.barrier()

# The 1F1B pipeline over the two workers' all-reduce.
pb = registry.build_gpt_pipeline(
    0.05, mesh_lib.create_mesh(data=1, pipe=2, devices=[CPU] * 2),
    seq_len=16, n_micro=2, dtype="float32",
    tx=make_optimizer("sgd", 0.05), schedule="1f1b",
    width=dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, max_position=64))
step = pb.train_step_builder(mesh_lib.create_mesh(
    data=1, pipe=2, devices=[CPU] * 2), all_reduce=ar)
pstate, m = step(pb.state, {"tokens": half(d["tokens"])})
res["pipe_loss"] = float(m["loss"])
tree = checkpoint_tree(pstate)["params"]["stages"]["mlp_in"]["kernel"]
arrays["pipe_mlp_in"] = np.asarray(tree)
json.dump(res, open(out + ".json", "w"))
np.savez(out + ".npz", **arrays)
dist.destroy_process_group()
"""


def _batches(n=2, rows=64):
    rng = np.random.RandomState(0)
    x = rng.rand(n, rows, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, (n, rows))]
    return x, y


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    x, y = _batches()
    from distributed_tensorflow_tpu_torch.models import gpt as tgpt
    tokens = tgpt.synthetic_lm_batch(3, 8, 16, tgpt.GptConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position=64))["tokens"]
    np.savez(tmp / "data.npz", x=x, y=y, tokens=tokens)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp / "store"),
         str(tmp / "data.npz"), str(tmp / f"rank{r}")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    return tmp, [(json.load(open(tmp / f"rank{r}.json")),
                  np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _jax_fsdp(data=2, model=1, rules=None):
    mesh = jmesh.create_mesh(data=data, model=model,
                             devices=jax.devices()[:data * model])
    state, apply_fn = make_mlp_state(mesh, hidden=HIDDEN)
    return jsh.fsdp_state(mesh, state, rules, min_size=MIN), apply_fn


def test_fsdp_state_shards_params_and_opt_state(ranks):
    placed, _ = _jax_fsdp()
    hid = placed.params["hid"]["kernel"]
    for res, _ in ranks[1]:
        assert res["specs"]["hid.kernel"] == list(hid.sharding.spec)
        assert tuple(res["shapes"]["hid.kernel"]) == \
            hid.addressable_shards[0].data.shape == (784 // 2, HIDDEN)
        # 64 x 10 and the biases are under min_size: replicated.
        assert res["specs"]["sm.kernel"] == [] and \
            res["shapes"]["sm.kernel"] == [HIDDEN, 10]
        # Adam's slots follow their slice.
        assert res["slot_shapes_before"]["hid.kernel"] == [
            [392, HIDDEN], [392, HIDDEN]]
    assert placed.global_step.sharding.spec == JP()


def test_fsdp_cuts_per_device_bytes(ranks):
    placed, _ = _jax_fsdp()
    jax_param_bytes = sum(
        np.prod(s.data.shape) * s.data.dtype.itemsize
        for leaf in jax.tree.leaves(placed.params)
        for s in leaf.addressable_shards[:1])
    for res, _ in ranks[1]:
        params, slots = res["bytes_fsdp"]
        r_params, r_slots = res["bytes_repl"]
        assert params == jax_param_bytes        # the JAX shard's bytes
        assert params < 0.6 * r_params and slots < 0.6 * r_slots


def test_fsdp_step_matches_replicated_step(ranks):
    (r0, a0), (r1, a1) = ranks[1]
    np.testing.assert_allclose(r0["loss_fsdp"], r0["loss_repl"], rtol=1e-5)
    np.testing.assert_allclose(r0["norm_fsdp"], r0["norm_repl"], rtol=1e-5)
    for key in a0.files:
        if key.startswith("fsdp:"):
            name = key[5:]
            np.testing.assert_allclose(a0[key], a0["repl:" + name],
                                       atol=1e-5, err_msg=name)
            np.testing.assert_array_equal(a0[key], a1[key])


def test_fsdp_clips_by_the_global_norm(ranks):
    """JAX's FSDP step clips by the norm of the whole gradient (optax's
    clip_by_global_norm over the global arrays).  A small GPT under FSDP,
    its slices along dim 0 and along other dims, with a clip the norm is
    over: the FSDP steps equal the replicated ones within atol 1e-5, every
    worker logs the one norm, and the leaves FSDP leaves whole (biases,
    LayerNorm scales) stay equal on every worker."""
    (r0, a0), (r1, a1) = ranks[1]
    assert r0["clip_norm_repl"][0] > r0["clip"]
    dims = set(r0["clip_split"].values())
    assert 0 in dims and dims - {0}, dims
    np.testing.assert_allclose(r0["clip_norm_fsdp"], r0["clip_norm_repl"],
                               rtol=1e-5)
    assert r0["clip_norm_fsdp"] == r1["clip_norm_fsdp"]
    names = [k[len("clipf:"):] for k in a0.files if k.startswith("clipf:")]
    assert set(names) - set(r0["clip_split"])        # replicated leaves
    for name in names:
        np.testing.assert_allclose(a0["clipf:" + name], a0["clipr:" + name],
                                   atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(a0["clipf:" + name],
                                      a1["clipf:" + name], err_msg=name)


def test_fsdp_sharding_survives_the_step(ranks):
    for res, _ in ranks[1]:
        assert res["shapes_after"] == res["shapes"]
        assert res["slot_shapes_after"] == res["slot_shapes_before"]


def test_fsdp_composes_with_tensor_parallel(ranks):
    rules = jsh.ShardingRules([(r"hid/kernel", JP(None, "model"))])
    placed, _ = _jax_fsdp(data=2, model=2, rules=rules)
    hid = placed.params["hid"]["kernel"]
    assert hid.sharding.spec == JP("data", "model")
    for res, _ in ranks[1]:
        for j in range(2):
            name = f"hid.kernel_shard{j}"
            assert res["tp_specs"][name] == ["data", "model"]
            assert tuple(res["tp_shapes"][name]) == \
                hid.addressable_shards[0].data.shape
        assert np.isfinite(res["tp_loss"])


def test_fsdp_tp_with_adafactor_factored_slots(ranks):
    """JAX's case: adafactor's factored slots are lower-rank than their
    parameter, so the parameter's P("data", "model") cannot place them:
    they stay whole on every piece.  Each worker's shard is JAX's
    addressable shard, the loss finite, and two steps land on optax's
    unsplit run within 1e-6 (the parameter and both slots)."""
    params = {"w": jnp.ones((512, 256), jnp.float32) * 0.01}
    tx = jopt.make_optimizer("adafactor", 0.01)
    st = tx.init(params)
    x = _batches()[0][0][:8, :512]
    grad = jax.jit(jax.grad(lambda p: jnp.mean((x @ p["w"] - 1.0) ** 2)))
    for _ in range(2):
        u, st = tx.update(grad(params), st, params)
        params = optax.apply_updates(params, u)
    for res, arrays in ranks[1]:
        for j in range(2):
            assert res["ada_specs"][f"w_shard{j}"] == ["data", "model"]
        assert res["ada_slots"] == {"v_row": [256], "v_col": [512],
                                    "v": [1]}
        assert all(np.isfinite(res["ada_loss"]))
        np.testing.assert_allclose(arrays["ada_w"], params["w"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(arrays["ada_v_row"], st[0].v_row["w"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(arrays["ada_v_col"], st[0].v_col["w"],
                                   rtol=1e-6, atol=1e-6)


def test_indivisible_slot_dims_fall_back_to_replicated():
    mesh = tmesh.create_mesh(data=1, model=2, devices=[CPU] * 2)
    rules = tsh.ShardingRules([(r"bias", tsh.P("model"))])
    tree = {"bias": np.zeros((128,)), "nested": {"bias": np.zeros((1,))}}
    placed = tsh.apply_rules(mesh, tree, rules)
    assert [tuple(p.shape) for p in placed["bias"]] == [(64,), (64,)]
    assert [tuple(p.shape) for p in placed["nested"]["bias"]] == [(1,)]


def test_misconfigured_param_rule_warns(capsys):
    from distributed_tensorflow_tpu_torch.training.state import TrainState
    mesh = tmesh.create_mesh(data=1, model=8, devices=[CPU] * 8)

    class W(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(100, 100))
    state = TrainState.create(W(), topt.make_optimizer("sgd", 0.1))
    rules = tsh.ShardingRules([(r"w", tsh.P(None, "model"))])
    placed = tsh.shard_state(mesh, state, rules)
    assert not tsh.is_sharded(placed.model)
    out = capsys.readouterr().out
    assert "WARNING" in out and "cannot partition param w" in out, out


def test_fsdp_leaves_model_state_replicated(ranks):
    """JAX's case: non-trainable state keeps its placement.  A ResNet-20
    state under ``fsdp_state`` (``min_size`` 1024, so its large conv
    kernels split over the two workers) keeps every BatchNorm statistic
    whole on every rank, the model's own buffers; a stateful step
    leaves them bit-equal across the ranks.  The rng stays as it was."""
    for res, _ in ranks[1]:
        assert res["rng_kept"]
        assert res["bn_split"], res["bn_split"]      # FSDP did split
        assert res["bn_stats_whole"] and res["bn_stats_are_buffers"]
        assert not any(n.endswith((".mean", ".var"))
                       for n in res["bn_split"])
    (r0, a0), (r1, a1) = ranks[1]
    assert r0["bn_stats_digest"] == r1["bn_stats_digest"]


def test_replicated_checkpoint_restores_into_fsdp(ranks):
    for r, (res, arrays) in enumerate(ranks[1]):
        assert res["restored_step"] == 5
        assert res["saved"] == (r == 0)         # the chief writes
        # The slice is the worker's piece of the saved (initial) weights.
        init = tmlp.MnistMLP(HIDDEN, seed=0, device="cpu")
        np.testing.assert_array_equal(
            arrays["restored:hid.kernel"],
            init.hid.kernel.detach().numpy()[r * 392:(r + 1) * 392])


def test_fsdp_checkpoint_is_the_unsharded_tree_and_restores_in_jax(ranks):
    tmp, ((_, a0), _) = ranks
    tree = restore_raw(str(tmp / "store.ckpt" / "fsdp"))[0]
    np.testing.assert_array_equal(np.asarray(tree["params"]["hid"]["kernel"]),
                                  a0["fsdp:hid.kernel"])
    assert np.asarray(tree["opt_state"][0]["mu"]["hid"]["kernel"]).shape == (
        784, HIDDEN)
    mesh = jmesh.create_mesh(data=2, devices=jax.devices()[:2])

    def init():
        model = jmlp.MnistMLP(hidden_units=HIDDEN)
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 784)))["params"]
        from distributed_tensorflow_tpu.training.optimizers import (
            make_optimizer)
        from distributed_tensorflow_tpu.training.state import TrainState
        st = TrainState.create(lambda p, x: model.apply({"params": p}, x),
                               params, make_optimizer("adam", 0.01))
        return jsh.fsdp_state(mesh, st, min_size=MIN)
    sv = JSupervisor(is_chief=True, logdir=str(tmp / "store.ckpt" / "fsdp"),
                     init_fn=init)
    restored = sv.prepare_or_wait_for_state()
    sv.close()
    assert restored.params["hid"]["kernel"].sharding.spec == JP("data", None)
    np.testing.assert_array_equal(
        np.asarray(restored.params["hid"]["kernel"]), a0["fsdp:hid.kernel"])


def test_pipeline_step_over_two_sync_workers(ranks):
    """The 1F1B step with the trainer's all-reduce over two workers (each
    half the batch) equals the one-process step on the whole batch."""
    from distributed_tensorflow_tpu_torch.models import gpt as tgpt
    from distributed_tensorflow_tpu_torch.models import registry as treg
    tmp, ((r0, a0), (r1, a1)) = ranks
    tokens = np.load(tmp / "data.npz")["tokens"]
    mesh = tmesh.create_mesh(data=1, pipe=2, devices=[CPU] * 2)
    b = treg.build_gpt_pipeline(
        0.05, mesh, seq_len=16, n_micro=4, dtype="float32",
        tx=topt.make_optimizer("sgd", 0.05), schedule="1f1b",
        width=dict(vocab_size=64, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, max_position=64))
    state, m = b.train_step_builder(mesh)(b.state, {"tokens": tokens})
    assert r0["pipe_loss"] == r1["pipe_loss"]
    np.testing.assert_allclose(r0["pipe_loss"], float(m["loss"]), rtol=1e-5)
    from distributed_tensorflow_tpu_torch.training.state import (
        checkpoint_tree)
    want = checkpoint_tree(state)["params"]["stages"]["mlp_in"]["kernel"]
    np.testing.assert_array_equal(a0["pipe_mlp_in"], a1["pipe_mlp_in"])
    np.testing.assert_allclose(a0["pipe_mlp_in"], want, atol=1e-6)
    del tgpt


# ------------------------------------------------------------------- CLI


def _worker(task, ports, logdir, *extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.train",
         "--device=cpu", "--job_name=worker", f"--task_index={task}",
         "--ps_hosts=", "--worker_hosts=" + ",".join(
             f"localhost:{p}" for p in ports), "--data_dir=/nonexistent",
         "--batch_size=64", f"--hidden_units={HIDDEN}",
         "--learning_rate=0.1", "--log_every=10", "--log_sharding",
         "--fsdp=true", f"--fsdp_min_size={MIN}", f"--logdir={logdir}",
         *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("fsdp_cli") / "logdir"
    ports = [free_port(), free_port()]
    procs = [_worker(t, ports, logdir, "--sync_replicas=true",
                     "--train_steps=30", "--save_interval_steps=10")
             for t in (1, 0)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
        outs.append(out)
    return logdir, {1: outs[0], 0: outs[1]}


def test_fsdp_cli_e2e(cli_run):
    """Two sync workers with --fsdp through train.py: each holds half of
    hid/kernel (JAX's P('data', None)), both end bit-equal (the gathered
    digest) with a test accuracy over 0.5, as the JAX CLI case."""
    _, outs = cli_run
    digests = set()
    for task, out in outs.items():
        assert f"Worker {task}: param hid/kernel (784, {HIDDEN}) -> " \
            "PartitionSpec('data', None)" in out, out[-3000:]
        acc = float(out.split(f"Worker {task}: test accuracy ")[1].split()[0])
        assert acc > 0.5
        digests.add(out.split("parameter digest ")[1].split()[0])
    assert len(digests) == 1


def test_fsdp_eval_mode_allowed(cli_run):
    """--mode=eval with --fsdp (and the default --sync_replicas=false)
    restores the two workers' checkpoint in one process."""
    logdir, outs = cli_run
    p = _worker(0, [free_port()], logdir, "--mode=eval")
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 0, out
    assert "Worker 0: restored global step 30" in out
    trained = float(outs[0].split("Worker 0: test accuracy ")[1].split()[0])
    assert f"Worker 0: test accuracy {trained:g}" in out


@pytest.fixture
def standalone(monkeypatch):
    from distributed_tensorflow_tpu_torch.cluster.server import Server
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def test_fsdp_async_rejected(tmp_path, standalone):
    with pytest.raises(ValueError, match="fsdp requires sync mode"):
        ttrain.app.run(ttrain.main, [
            "--job_name=worker", "--task_index=0", "--data_dir=/nonexistent",
            "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
            "--device=cpu", "--train_steps=5", "--sync_replicas=false",
            "--fsdp=true", f"--logdir={tmp_path}/logdir"])
