"""The port's placement rules (distributed_tensorflow_tpu_torch/parallel/
sharding.py and models/gpt.gpt_sharding_rules) against the JAX package's:
every gpt_mini leaf's spec (through the port's own flax paths), the shard
shapes of the parameters and of Adam's slots against JAX's
``addressable_shards[0]`` on create_mesh(data=4, model=2) (the 8 fake CPU
devices of tests/conftest.py; the port on [cpu] * 2, one data replica a
process), the misfit warning word for word, fsdp_spec on the JAX
package's test_fsdp.py cases, and the PartitionSpec's printed form.
Port-only: a sharded state's checkpoint tree gathers the shards into the
unsharded tree and loading splits it again."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.training.state import (
    TrainState as JTrainState)
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState, checkpoint_tree, load_checkpoint_tree, param_paths)
from distributed_tensorflow_tpu_torch.utils.pytree import tree_paths

CPU2 = [torch.device("cpu")] * 2
SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position=32, dtype="float32")
ARCHS = {
    "mha_gelu_learned": {},
    "gqa_swiglu_rope": dict(kv_heads=2, activation="swiglu",
                            pos_encoding="rope", norm="rmsnorm"),
    # 3 heads and a 33-row position table do not split over model=2: the
    # rules fall back to replicated, with the warning.
    "misfit": dict(num_heads=3, hidden_size=48, max_position=33),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(arch):
    cfg = jgpt.GptConfig(**{**SMALL, **ARCHS[arch]})
    model = jgpt.GptLM(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return JTrainState.create(lambda p, t: model.apply({"params": p}, t),
                              params, optax.adam(1e-3))


def _port_state(arch):
    cfg = tgpt.GptConfig(**{**SMALL, **ARCHS[arch]})
    model = tgpt.GptLM(cfg, device="cpu", param_dtype=torch.float32)
    return TrainState.create(model, topt.make_optimizer("adam", 1e-3),
                             params_to_tree=tgpt.params_to_jax,
                             params_from_tree=tgpt.params_from_jax)


def _jax_leaves(tree):
    return {jsh.path_str(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _specs(tree, prefix=""):
    """{path: spec} of a tree of specs (a spec is a tuple: a leaf here)."""
    if isinstance(tree, tsh.P):
        return {prefix[:-1]: tree}
    out = {}
    for key, value in tree.items():
        out.update(_specs(value, f"{prefix}{key}/"))
    return out


def _shard_shapes(state):
    """{flax path: shard 0's shape} of the port state's parameters."""
    model = state.model
    whole = tsh.gather_named(model, dict(model.named_parameters()))
    first = {name: model.get_parameter(names[0]) for name, _, names in
             tsh._sharded_entries(model)}
    return {path: tuple(first.get(name, whole[name]).shape)
            for name, path in param_paths(whole,
                                          state.params_to_tree).items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_shard_shapes_match_jax(arch, capsys):
    js = _jax_state(arch)
    jmesh_ = jmesh.create_mesh(data=4, model=2)
    jplaced = jsh.shard_state(jmesh_, js, jgpt.gpt_sharding_rules())
    jwarn = capsys.readouterr().out
    ts = _port_state(arch)
    mesh = tmesh.create_mesh(data=1, model=2, devices=CPU2)
    rules = tgpt.gpt_sharding_rules()
    # The rules see the same flax paths on both sides.
    want = _jax_leaves(jplaced.params)
    tree = checkpoint_tree(ts)["params"]
    assert {p for p, _ in tree_paths(tree)} == set(want)
    specs = _specs(rules.tree_shardings(mesh, tree))
    for path, leaf in want.items():
        assert rules.spec_for(path) == tuple(
            jgpt.gpt_sharding_rules().spec_for(path)), path
        assert specs[path] == tuple(leaf.sharding.spec), path
    tsh.shard_state(mesh, ts, rules)
    assert capsys.readouterr().out == jwarn
    if arch == "misfit":
        assert "WARNING: sharding rule PartitionSpec(None, None, 'model', " \
               "None) cannot partition param layer0/qkv/kernel (48, 3, 3, " \
               "16) on this mesh — leaving it replicated" in jwarn
    got = _shard_shapes(ts)
    for path, leaf in want.items():
        assert got[path] == leaf.addressable_shards[0].data.shape, path
    # Adam's slots: per shard, of the shard's shape (torch makes them at
    # the first step), as JAX's mu/nu follow their parameter's path.
    for p in ts.optimizer.params:
        p.grad = torch.zeros_like(p)
    ts.optimizer.step()
    slots = {n: ts.optimizer.base.state[p]["exp_avg"].shape
             for n, p in ts.model.named_parameters()}
    assert all(tuple(slots[n]) == tuple(p.shape)
               for n, p in ts.model.named_parameters())
    mu = _jax_leaves(jplaced.opt_state[0].mu)
    for path, leaf in mu.items():
        assert got[path] == leaf.addressable_shards[0].data.shape, path
    tmu = dict(tree_paths(checkpoint_tree(ts)["opt_state"][0]["mu"]))
    assert {p: v.shape for p, v in tmu.items()} == {
        p: leaf.shape for p, leaf in mu.items()}


def test_out_kernel_rule_takes_the_attention_projection_only():
    rules = tgpt.gpt_sharding_rules()
    assert rules.spec_for("layer0/out/kernel") == tsh.P("model", None, None)
    assert rules.spec_for("layer0/mlp_out/kernel") == tsh.P("model", None)
    assert rules.spec_for("layer0/kv_proj/kernel") == tsh.P()
    assert rules.spec_for("layer0/out/bias") == tsh.P()
    assert rules.spec_for("0/mu/layer3/qkv/kernel") == tsh.P(
        None, None, "model", None)


def test_partition_spec_prints_as_jax():
    for entries in ((), (None, "model"), (("data", "model"), None),
                    ("model",)):
        assert repr(tsh.P(*entries)) == repr(JP(*entries))
        assert str(tsh.P(*entries)) == str(JP(*entries))
        assert tsh.P(*entries) == tuple(JP(*entries))
    assert tsh.P("a", None) != tsh.P("a")


def test_sharded_checkpoint_tree_is_the_unsharded_tree():
    """Gathered into whole arrays in the JAX layout (params, Adam's mu/nu,
    EMA), and split again on load, slot for slot."""
    a, b = _port_state("gqa_swiglu_rope"), _port_state("gqa_swiglu_rope")
    for s in (a, b):
        s.ema_params = {n: p.detach().clone() + 1.0
                        for n, p in s.model.named_parameters()}
        for p in s.optimizer.params:
            p.grad = torch.full_like(p, 0.5)
        s.optimizer.step()
        s.global_step += 1
    tsh.shard_state(tmesh.create_mesh(data=1, model=2, devices=CPU2), a,
                    tgpt.gpt_sharding_rules())
    ta, tb = checkpoint_tree(a), checkpoint_tree(b)
    pa, pb = dict(tree_paths(ta)), dict(tree_paths(tb))
    assert set(pa) == set(pb) and "ema_params/layer0/q_proj/kernel" in pa
    for path in pa:
        np.testing.assert_array_equal(np.asarray(pa[path]),
                                      np.asarray(pb[path]), err_msg=path)
    c = _port_state("gqa_swiglu_rope")
    c.ema_params = {n: p.detach().clone()
                    for n, p in c.model.named_parameters()}
    tsh.shard_state(tmesh.create_mesh(data=1, model=2, devices=CPU2), c,
                    tgpt.gpt_sharding_rules())
    load_checkpoint_tree(c, tb)
    for path, leaf in tree_paths(checkpoint_tree(c)):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(pb[path]),
                                      err_msg=path)
    assert c.optimizer.count == 1 and c.global_step == 2


def test_apply_rules_splits_a_tree_over_the_model_axis():
    mesh = tmesh.create_mesh(data=1, model=2, devices=CPU2)
    tree = {"layer0": {"qkv": {"kernel": np.zeros((8, 3, 4, 2))},
                       "ln_attn": {"scale": np.ones(8)}},
            "count": np.zeros(())}
    placed = tsh.apply_rules(mesh, tree, tgpt.gpt_sharding_rules())
    assert [tuple(x.shape) for x in placed["layer0"]["qkv"]["kernel"]] == [
        (8, 3, 2, 2)] * 2
    assert len(placed["layer0"]["ln_attn"]["scale"]) == 1
    assert len(placed["count"]) == 1


# ----------------------------------------- JAX test_fsdp.py:28-60's cases


def test_fsdp_spec_picks_largest_divisible_dim():
    for shape, want in (((128, 512), (None, "data")),
                        ((512, 128), ("data", None))):
        got = tsh.fsdp_spec(tsh.P(), shape, 8, min_size=1)
        assert got == want == tuple(jsh.fsdp_spec(JP(), shape, 8,
                                                  min_size=1))


def test_fsdp_spec_skips_claimed_and_indivisible_dims():
    assert tsh.fsdp_spec(tsh.P(None, "model"), (512, 512), 8,
                         min_size=1) == tsh.P("data", "model")
    assert tsh.fsdp_spec(tsh.P(), (7, 3), 8, min_size=1) == tsh.P()


def test_fsdp_spec_respects_min_size_and_axis_one():
    assert tsh.fsdp_spec(tsh.P(), (8, 8), 8, min_size=1024) == tsh.P()
    assert tsh.fsdp_spec(tsh.P(), (1024, 1024), 1, min_size=1) == tsh.P()


def test_fsdp_rules_compose_with_tp_base():
    tp = tsh.ShardingRules([(r"kernel", tsh.P(None, "model"))])
    rules = tsh.FsdpRules(tp, 8, min_size=1)
    jrules = jsh.FsdpRules(jsh.ShardingRules([(r"kernel", JP(None, "model"))]),
                           8, min_size=1)
    for path, shape, want in (("layer/kernel", (512, 256), ("data", "model")),
                              ("layer/bias", (256,), ("data",)),
                              ("step", (), ())):
        leaf = torch.zeros(shape)
        assert rules.spec_for(path, leaf) == want
        assert tuple(jrules.spec_for(path, jnp.zeros(shape))) == want


def test_fsdp_placement_is_not_ported_yet():
    # FSDP over in-process data positions is ported (slice 8d): each
    # position's row model holds its slice; beside tensor parallelism
    # with several local rows too (slice 8e): each row's model shard is
    # split over the rows along the dim the composed spec gives data.
    s = tsh.fsdp_state(tmesh.create_mesh(data=2, devices=CPU2),
                       _port_state("mha_gelu_learned"), min_size=1024)
    assert tsh.is_fsdp(s.model) and len(s.rows) == 1
    infos = [info for *_, info in tsh.fsdp_entries(s.rows[0])]
    assert infos and all(i.world == 2 and i.rank == 1 for i in infos)
    rules = tsh.ShardingRules([(r"kernel", tsh.P(None, "model"))])
    s = tsh.fsdp_state(tmesh.create_mesh(data=2, model=2, devices=CPU2 * 2),
                       _port_state("mha_gelu_learned"), rules, min_size=1024)
    assert tsh.is_sharded(s.model) and len(s.rows) == 1
    infos = [info for *_, info in tsh.fsdp_entries(s.rows[0])]
    assert infos and all(i.world == 2 and i.rank == 1 and i.local == 2
                         and i.spec[i.dim] == "data" for i in infos)


def test_replicate_state_keeps_one_set_of_tensors():
    s = _port_state("mha_gelu_learned")
    before = [p for p in s.model.parameters()]
    mesh = tmesh.create_mesh(data=1, seq=2, devices=CPU2)
    assert tsh.replicate_state(mesh, s) is s
    assert [p for p in s.model.parameters()] == before
    assert not tsh.is_sharded(s.model)
