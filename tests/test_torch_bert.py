"""The port's BERT-tiny MLM (distributed_tensorflow_tpu_torch/models/
bert.py, data/mlm.py, registry.build_bert_tiny) against the JAX
package's: the synthetic MLM batches and streams bit for bit, the loss,
logits with a ragged key-padding mask (``xla``, and ``pallas`` with
``fused_ln``: the JAX side's Pallas kernels in interpret mode, the
port's kernels' plain versions on the CPU), three SGD steps in fp32 and
in bf16, and the masked-position eval.  The weights go across with
``params_from_jax``; inputs are numpy, seeded; torch on one thread.

Tolerances: fp32 logits and losses 1e-4, parameters after each of three
SGD steps 1e-5 with an update cosine of 0.99999; bf16: the bf16
``TRAIN_CASES`` of tests/test_torch_gpt_training.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.data import mlm as jmlm
from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.training.state import TrainState as JState
from distributed_tensorflow_tpu_torch.data import mlm as tmlm
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt

SEQ = 32
BF16 = dict(loss_tol=3e-3, param_atol=3e-3, min_cos=0.999)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(named):
    return torch.cat([v.detach().double().flatten()
                      for _, v in sorted(named.items())])


@functools.lru_cache(maxsize=None)
def _jax_params():
    """BERT-tiny's flax parameters (``registry.build_bert_tiny``'s model,
    fp32 whatever the compute dtype), from a jitted init."""
    model = jbert.BertForMLM(jbert.tiny())
    ids = jnp.zeros((1, SEQ), jnp.int32)
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), ids,
                                              jnp.ones_like(ids))["params"])


def _jax_model(**kw):
    """The JAX model of ``registry.build_bert_tiny(**kw)`` and its loss
    (``_dense_loss``)."""
    model = jbert.BertForMLM(dataclasses.replace(jbert.tiny(), **kw))

    def loss_fn(params, batch):
        logits = model.apply({"params": params}, batch["input_ids"],
                             batch["attention_mask"])
        loss, acc = jbert.mlm_loss(logits, batch["labels"],
                                   batch["label_weights"])
        return loss, {"accuracy": acc}
    return model, loss_fn


def _port(lr=0.1, **kw):
    tb = treg.build_bert_tiny(lr, seq_len=SEQ, device="cpu",
                              tx=topt.make_optimizer("sgd", lr), **kw)
    tb.state.model.load_state_dict(tbert.params_from_jax(_jax_params()))
    return tb


def _ragged(batch, seed=0):
    """The batch with ragged key padding: per-row valid lengths from the
    seed, one row half padded."""
    rng = np.random.default_rng(seed)
    B, S = batch["attention_mask"].shape
    lengths = rng.integers(S // 2, S + 1, B)
    lengths[0] = S // 2
    batch = dict(batch)
    batch["attention_mask"] = (np.arange(S)[None, :]
                               < lengths[:, None]).astype(np.int32)
    return batch


# ------------------------------------------------------------- the data


@pytest.mark.parametrize("seed", [0, 7, 6_000_000])
def test_synthetic_mlm_batch_is_the_jax_batch(seed):
    cfg_j, cfg_t = jbert.tiny(), tbert.tiny()
    want = jbert.synthetic_mlm_batch(seed, 5, 48, cfg_j)
    got = tbert.synthetic_mlm_batch(seed, 5, 48, cfg_t)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    small = dataclasses.replace(cfg_t, vocab_size=40)
    np.testing.assert_array_equal(
        tbert.synthetic_mlm_batch(np.array([seed]), 2, 16, small)["labels"],
        jbert.synthetic_mlm_batch(np.array([seed]), 2, 16, dataclasses.replace(
            cfg_j, vocab_size=40))["labels"])


def test_mlm_streams_are_the_jax_streams():
    jd = jmlm.make_mlm_datasets(jbert.tiny(), seq_len=SEQ)
    td = tmlm.make_mlm_datasets(tbert.tiny(), seq_len=SEQ)
    for split in ("train", "validation", "test"):
        j, t = getattr(jd, split), getattr(td, split)
        for a, b in ((j, t), (j.shard(1, 2), t.shard(1, 2))):
            for _ in range(2):
                np.testing.assert_array_equal(a.next_batch(3)["input_ids"],
                                              b.next_batch(3)["input_ids"])
        for a, b in zip(j.fixed_batches(2, 2), t.fixed_batches(2, 2)):
            np.testing.assert_array_equal(a["label_weights"],
                                          b["label_weights"])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_mlm_loss_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    weights = (rng.random((2, 6)) < 0.5).astype(np.float32)
    jl, ja = jbert.mlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(weights), label_smoothing=smoothing)
    tl, ta = tbert.mlm_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            torch.from_numpy(weights),
                            label_smoothing=smoothing)
    assert abs(float(tl) - float(jl)) <= 1e-6
    assert float(ta) == float(ja)


def test_mlm_loss_ignores_unmasked_positions():
    """JAX ``test_models.py::test_mlm_loss_masking`` on the port."""
    logits = torch.zeros(1, 4, 8)
    logits[0, 0, 3] = 10.0
    logits[0, 1, 2] = 10.0
    weights = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    loss, acc = tbert.mlm_loss(logits, torch.tensor([[3, 5, 0, 0]]), weights)
    assert float(acc) == 0.5
    loss2, _ = tbert.mlm_loss(logits, torch.tensor([[3, 5, 7, 7]]), weights)
    np.testing.assert_allclose(float(loss), float(loss2), rtol=1e-6)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("backend,fused", [("xla", False), ("pallas", True)])
def test_bert_logits_match_jax_with_a_ragged_mask(backend, fused):
    kw = dict(dtype="float32", attention_backend=backend, fused_ln=fused)
    model, _ = _jax_model(**kw)
    tb = _port(**kw)
    batch = _ragged(jbert.synthetic_mlm_batch(3, 4, SEQ, jbert.tiny()))
    want = np.asarray(jax.jit(lambda p, i, m: model.apply(
        {"params": p}, i, m))(_jax_params(), batch["input_ids"],
                              batch["attention_mask"]))
    got = tb.state.model(torch.from_numpy(batch["input_ids"]).long(),
                         torch.from_numpy(batch["attention_mask"]))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)


def _three_steps(kw, tol):
    lr = 0.1
    _, jloss = _jax_model(**kw)
    tx = optax.sgd(lr)
    js = JState.create(None, _jax_params(), tx)
    tb = _port(lr, **kw)
    jstep = jsync.build_sync_train_step(None, jloss, donate=False,
                                        log_grad_norm=True)
    tstep = tsync.build_sync_train_step(tb.loss_fn, log_grad_norm=True)
    ts = tb.state
    data = tmlm.make_mlm_datasets(tbert.tiny(), seq_len=SEQ).train
    before = _flat(dict(ts.model.named_parameters()))
    for i in range(3):
        batch = _ragged(data.next_batch(4), seed=i)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=tol["loss_tol"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
        want = tbert.params_from_jax(jax.device_get(js.params))
        got = dict(ts.model.named_parameters())
        for n, w in want.items():
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       atol=tol["param_atol"], rtol=0,
                                       err_msg=f"step {i}: {n}")
        cos = torch.nn.functional.cosine_similarity(
            _flat(got) - before, _flat(want) - before, dim=0)
        assert cos >= tol["min_cos"], (i, float(cos))


def test_bert_three_fp32_steps_match_jax():
    _three_steps(dict(dtype="float32", attention_backend="pallas",
                      fused_ln=True),
                 dict(loss_tol=1e-5, param_atol=1e-5, min_cos=0.99999))


def test_bert_bf16_steps_track_jax():
    _three_steps(dict(attention_backend="pallas", fused_ln=True), BF16)


def test_mlm_eval_matches_jax():
    model, _ = _jax_model(dtype="float32")
    jeval = jmlm.make_mlm_eval_fn(lambda p, i, m: model.apply(
        {"params": p}, i, m), batch_size=4, num_batches=2)
    tb = _port(dtype="float32")
    teval = tmlm.make_mlm_eval_fn(lambda m, i, mask: m(i.long(), mask),
                                  batch_size=4, num_batches=2)
    js = JState.create(None, _jax_params(), optax.sgd(0.1))
    jsplit = jmlm.make_mlm_datasets(jbert.tiny(), seq_len=SEQ).test
    tsplit = tmlm.make_mlm_datasets(tbert.tiny(), seq_len=SEQ).test
    assert teval(tb.state, tsplit) == jeval(js, jsplit)
    assert tb.state.model.training


def test_bert_parameter_tree_is_flax_s():
    tree = tbert.params_to_jax(_port().state.model.state_dict())
    want = _jax_params()
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape
    rules = tbert.bert_sharding_rules()
    assert tuple(rules.spec_for("bert/layer0/attention/qkv/kernel")) == (
        None, None, "model", None)
    assert tuple(rules.spec_for("bert/word_emb/embedding")) == ("model",
                                                                None)


def test_mixture_of_experts_waits_for_item_7c():
    """Item 7c ported the MoE FFN (tests/test_torch_moe.py holds it to
    the JAX package's): ``num_experts > 0`` swaps each layer's MLP for
    it."""
    model = tbert.BertForMLM(tbert.BertConfig(num_experts=4), device="cpu")
    names = dict(model.named_parameters())
    assert tuple(names["bert.layer0.moe.experts.wi.kernel"].shape) == (
        4, 128, 512)
    assert "bert.layer0.mlp_in.kernel" not in names
