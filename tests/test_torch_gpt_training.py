"""The port's GPT training path (distributed_tensorflow_tpu_torch/models/
registry.build_gpt_mini, parallel/sync.build_sync_train_step,
training/optimizers.py, data/lm.py) against the JAX package's: three
train steps from the same weights, the optimizers and schedules against
optax, the LM streams bit for bit, and the loss.  Port-only: the
synthetic stream is learned, dropout keeps its rate and replays from its
seed, and remat gives the same gradients.  Small models on the CPU;
inputs from seeded numpy generators; the JAX side's Pallas kernels run in
interpret mode."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.data import lm as jlm
from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.models import registry as jreg
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu.training import optimizers as jopt
from distributed_tensorflow_tpu_torch.data import lm as tlm
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import (
    TrainState as TTrainState)

SEQ = 32

# The tolerances of three train steps of build_gpt_mini (pallas
# attention, fused LayerNorm) against the JAX step, with SGD: each
# parameter moves by lr * gradient, so the parameters show the gradients'
# agreement directly.  f32 sums differ in order only (measured max 1.2e-7
# after 3 steps); bf16 activations round at other places in the two
# frameworks (measured 8.3e-4 at lr 0.5, update cosine 0.9997).
# SGD rather than the bundle's default Adam: Adam divides each gradient
# element by its own RMS, so an element whose gradient is zero in exact
# arithmetic (the key bias: softmax is shift-invariant along a row) moves
# by up to +-lr on rounding noise alone, in both frameworks alike, and
# would hide the gradients' agreement.  Adam is held to optax on equal
# gradients below.
TRAIN_CASES = {
    "float32": dict(loss_tol=1e-6, param_atol=1e-6, min_cos=0.99999),
    "bfloat16": dict(loss_tol=3e-3, param_atol=3e-3, min_cos=0.999),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores: keep torch's
    intra-op pool to one thread so these small models do not
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(state_dict):
    return torch.cat([v.detach().float().flatten()
                      for _, v in sorted(state_dict.items())])


@functools.lru_cache(maxsize=None)
def _jax_bundle():
    """The JAX f32 bundle, built once: its eager init runs the Pallas
    kernels in interpret mode and is the slowest part here."""
    return jreg.build_gpt_mini(1e-3, seq_len=SEQ, dtype="float32",
                               attention_backend="pallas", fused_ln=True,
                               tx=optax.sgd(0.5))


def _jax_bf16_loss_fn():
    """The bf16 bundle's loss (registry.build_gpt_mini's ``_loss``),
    without its init: flax's initial parameters are fp32 whatever the
    compute dtype, so the f32 bundle's serve both."""
    model = jgpt.GptLM(dataclasses.replace(
        jgpt.mini(), dtype="bfloat16", attention_backend="pallas",
        fused_ln=True))

    def loss_fn(params, batch):
        logits = model.apply({"params": params}, batch["tokens"])
        loss, acc = jgpt.lm_loss(logits, batch["tokens"])
        return loss, {"accuracy": acc}
    return loss_fn


@pytest.mark.parametrize("dtype", sorted(TRAIN_CASES))
def test_three_train_steps_match_jax_sync_step(dtype):
    tol = TRAIN_CASES[dtype]
    jb = _jax_bundle()
    jloss = jb.loss_fn if dtype == "float32" else _jax_bf16_loss_fn()
    js = jb.state
    tb = treg.build_gpt_mini(1e-3, tx=topt.make_optimizer("sgd", 0.5),
                             seq_len=SEQ, dtype=dtype,
                             attention_backend="pallas", fused_ln=True,
                             device="cpu")
    model = tb.state.model
    assert model.layers[0].qkv.kernel.dtype == torch.float32   # masters
    model.load_state_dict(tgpt.params_from_jax(jax.device_get(
        jb.state.params)))
    jstep = jsync.build_sync_train_step(None, jloss, donate=False,
                                        log_grad_norm=True)
    tstep = tsync.build_sync_train_step(tb.loss_fn, log_grad_norm=True)
    ts = tb.state
    jdata, tdata = jb.load_datasets(None).train, tb.load_datasets(None).train
    before = _flat(model.state_dict())
    for i in range(3):
        jbatch, tbatch = jdata.next_batch(8), tdata.next_batch(8)
        np.testing.assert_array_equal(jbatch["tokens"], tbatch["tokens"])
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, tbatch)
        assert tm["global_step"] == int(jm["global_step"]) == i + 2
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=tol["loss_tol"])
        # One of the 8 x 31 argmax predictions may flip between two nearly
        # equal logits.
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]),
                                   atol=1.01 / (8 * (SEQ - 1)))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
        want = tgpt.params_from_jax(jax.device_get(js.params))
        got = model.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].float().numpy(), w.numpy(),
                                       atol=tol["param_atol"], rtol=0,
                                       err_msg=f"step {i}: {name}")
        after = _flat(got)
        cos = torch.nn.functional.cosine_similarity(
            after - before, _flat(want) - before, dim=0)
        assert cos >= tol["min_cos"], (i, float(cos))


def test_port_gpt_trains_on_synthetic_stream():
    """Port-only copy of test_gpt.py::test_gpt_trains_on_synthetic_stream."""
    bundle = treg.build_gpt_mini(1e-3, seq_len=SEQ, dtype="float32",
                                 tx=topt.make_optimizer("adam", 3e-3),
                                 device="cpu")
    state = bundle.state
    step = tsync.build_sync_train_step(bundle.loss_fn)
    split = bundle.load_datasets(None).train
    first_loss = final_loss = None
    for _ in range(100):
        state, metrics = step(state, split.next_batch(32))
        final_loss = float(metrics["loss"])
        if first_loss is None:
            first_loss = final_loss
    assert state.global_step == 101
    assert final_loss < first_loss * 0.5, (first_loss, final_loss)
    acc = bundle.make_eval_fn()(state, bundle.load_datasets(None).test)
    assert acc > 0.4, acc
    assert state.model.training       # eval restored the mode


# ---------------------------------------------------------- optimizers

def _opt_inputs(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {"b": rng.standard_normal(3).astype(np.float32),
              "w": rng.standard_normal((4, 3)).astype(np.float32)}
    # Alternate large and small gradients: the clip fires on some steps
    # and not on others.
    grads = [{k: (rng.standard_normal(v.shape) * (3.0 if i % 2 else 0.1))
              .astype(np.float32) for k, v in params.items()}
             for i in range(steps)]
    return params, grads


@pytest.mark.parametrize("variant", ["plain", "clip_decay_schedule"])
@pytest.mark.parametrize("name", topt.OPTIMIZERS)
def test_optimizer_updates_match_optax(name, variant):
    params, grads = _opt_inputs()
    kw, lr = {}, 0.05
    if variant == "clip_decay_schedule":
        kw = dict(weight_decay=0.01, grad_clip_norm=1.0)
        jlr = jopt.make_schedule("cosine", 0.05, warmup_steps=2,
                                 decay_steps=6, end_lr_factor=0.1)
        tlr = topt.make_schedule("cosine", 0.05, warmup_steps=2,
                                 decay_steps=6, end_lr_factor=0.1)
    else:
        jlr = tlr = lr
    tx = jopt.make_optimizer(name, jlr, momentum=0.9, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = topt.make_optimizer(name, tlr, momentum=0.9, **kw).init(
        [tp["b"], tp["w"]])
    for i, g in enumerate(grads):
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in tp:
            # fp32 on both sides; the same formulas evaluated in another
            # order (e.g. torch folds Adam's bias corrections into the
            # step size).
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i}: {k}")


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", topt.SCHEDULES)
def test_schedules_match_optax(name, warmup):
    kw = dict(warmup_steps=warmup, decay_steps=10, end_lr_factor=0.1)
    want = jopt.make_schedule(name, 0.2, **kw)
    got = topt.make_schedule(name, 0.2, **kw)
    for step in range(14):
        w = want(step) if callable(want) else want
        assert got(step) == pytest.approx(float(w), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("name", ["lamb", "adagrad", "rmsprop", "adafactor"])
def test_unported_optimizers_raise_naming_roadmap(name):
    """Item 7a ported these four (tests/test_torch_optimizers.py holds
    them to optax): each builds and steps; an unknown name still
    raises."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = topt.make_optimizer(name, 0.1).init([p])
    p.grad = torch.ones(4)
    opt.step()
    assert torch.all(p < 1.0)
    with pytest.raises(ValueError, match="Unknown"):
        topt.make_optimizer("nope", 0.1)


# ---------------------------------------------------------- data, loss

def test_lm_streams_equal_jax_bit_for_bit(tmp_path):
    jcfg, tcfg = jgpt.mini(), tgpt.mini()
    for seed in (0, 7):
        np.testing.assert_array_equal(
            tgpt.synthetic_lm_batch(seed, 3, 40, tcfg)["tokens"],
            jgpt.synthetic_lm_batch(seed, 3, 40, jcfg)["tokens"])
    js, ts = jlm.LmStream(jcfg, 24, 5), tlm.LmStream(tcfg, 24, 5)
    pairs = [(js.next_batch(4), ts.next_batch(4)),
             (js.next_batch(2), ts.next_batch(2)),
             (js.shard(1, 2).next_batch(3), ts.shard(1, 2).next_batch(3))]
    pairs += zip(js.fixed_batches(2, 2), ts.fixed_batches(2, 2))
    rng = np.random.default_rng(1)
    (tmp_path / "a.txt").write_bytes(rng.integers(0, 256, 9000,
                                                  dtype=np.uint8).tobytes())
    (tmp_path / "b.txt").write_bytes(b"hello corpus " * 300)
    jd = jlm.make_lm_datasets(jcfg, seq_len=16, data_dir=str(tmp_path))
    td = tlm.make_lm_datasets(tcfg, seq_len=16, data_dir=str(tmp_path))
    assert not td.synthetic and not jd.synthetic
    pairs += [(jd.train.next_batch(4), td.train.next_batch(4)),
              (jd.test.next_batch(2), td.test.next_batch(2))]
    pairs += zip(jd.validation.fixed_batches(2, 2),
                 td.validation.fixed_batches(2, 2))
    for want, got in pairs:
        assert got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_unported_data_sources_raise_naming_roadmap(tmp_path):
    """Item 7a ported the BPE tokenizer and the streaming corpus
    (tests/test_torch_tokenizer.py, test_torch_lm_corpus.py hold them to
    the JAX package): without a corpus BPE keeps the synthetic stream, a
    corpus past the threshold streams, and the BPE model's vocabulary is
    ``bpe_vocab``."""
    cfg = tgpt.mini()
    assert tlm.make_lm_datasets(cfg, tokenizer="bpe").synthetic
    (tmp_path / "a.txt").write_bytes(b"x" * 5000)
    ds = tlm.make_lm_datasets(cfg, data_dir=str(tmp_path),
                              stream_threshold_bytes=1000)
    assert isinstance(ds.train, tlm.StreamingByteLmStream)
    bundle = treg.build_gpt_mini(1e-3, tokenizer="bpe", bpe_vocab=320,
                                 device="cpu")
    assert bundle.state.model.cfg.vocab_size == 320
    with pytest.raises(ValueError, match="bpe_vocab"):
        treg.build_gpt_mini(1e-3, tokenizer="bpe", bpe_vocab=256,
                            device="cpu")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_lm_loss_matches_jax(smoothing):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    tokens = rng.integers(0, 11, (2, 6)).astype(np.int32)
    want = jgpt.lm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                        label_smoothing=smoothing)
    got = tgpt.lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                       label_smoothing=smoothing)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ---------------------------------------------- dropout, remat, masters

TINY = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=32, dtype="float32",
            attention_backend="pallas", fused_ln=True)


def test_dropout_keeps_its_rate_scales_and_replays_from_its_seed():
    n, rate = 200_000, 0.1
    x = torch.ones(n)
    y = tgpt.dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    # Binomial: the kept share within 5 standard deviations of 1 - rate.
    assert abs(kept.float().mean().item() - (1 - rate)) < 5 * (
        rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        1 / (1 - rate)))
    again = tgpt.dropout(x, rate, torch.Generator().manual_seed(0))
    other = tgpt.dropout(x, rate, torch.Generator().manual_seed(1))
    assert torch.equal(y, again) and not torch.equal(y, other)

    cfg = tgpt.GptConfig(**TINY, dropout_rate=rate)
    model = tgpt.GptLM(cfg, device="cpu", seed=0, param_dtype=torch.float32)
    plain = tgpt.GptLM(dataclasses.replace(cfg, dropout_rate=0.0),
                       device="cpu", seed=0, param_dtype=torch.float32)
    tokens = torch.from_numpy(tgpt.synthetic_lm_batch(0, 2, 16, cfg)[
        "tokens"]).long()
    with torch.no_grad():
        a = model(tokens, torch.Generator().manual_seed(5))
        b = model(tokens, torch.Generator().manual_seed(5))
        c = model(tokens, torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.allclose(a, c)
        assert not torch.allclose(a, plain(tokens))
        with pytest.raises(ValueError, match="rng"):
            model(tokens)
        model.eval()                       # dropout off outside training
        torch.testing.assert_close(model(tokens), plain(tokens))


def test_remat_gives_the_same_gradients():
    cfg = tgpt.GptConfig(**TINY, dropout_rate=0.1)
    grads = []
    for remat in (False, True):
        model = tgpt.GptLM(dataclasses.replace(cfg, remat=remat),
                           device="cpu", seed=0, param_dtype=torch.float32)
        tokens = torch.from_numpy(tgpt.synthetic_lm_batch(
            1, 2, 16, cfg)["tokens"]).long()
        loss, _ = tgpt.lm_loss(model(tokens,
                                     torch.Generator().manual_seed(3)),
                               tokens)
        loss.backward()
        grads.append({n: p.grad.clone()
                      for n, p in model.named_parameters()})
    for name in grads[0]:
        # The recomputed blocks draw the same dropout masks; only the
        # order of fp32 sums may differ.
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   atol=1e-6, rtol=1e-5, msg=name)


def test_training_keeps_fp32_masters_serving_keeps_compute_dtype():
    bundle = treg.build_gpt_mini(0.01, seq_len=SEQ, dtype="bfloat16",
                                 device="cpu")
    # The bundle's default optimizer, as JAX's: Adam at the rate capped to
    # 1e-3.
    spec = bundle.state.optimizer.spec
    assert spec.name == "adam" and spec.schedule(0) == 1e-3
    sd = bundle.state.model.state_dict()
    assert sd["layers.0.qkv.kernel"].dtype == torch.float32
    assert sd["layers.0.mlp_out.bias"].dtype == torch.float32
    serving = tgpt.GptLM(tgpt.GptConfig(**{**TINY, "dtype": "bfloat16"}),
                         device="cpu")
    assert serving.layers[0].qkv.kernel.dtype == torch.bfloat16
    # The masters are cast at each call: activations stay bf16.
    tokens = torch.zeros(1, 8, dtype=torch.long)
    h = bundle.state.model._embed(tokens, torch.arange(8)[None])
    assert bundle.state.model.layers[0](h).dtype == torch.bfloat16


def test_sync_step_ema_tracks_the_parameters():
    bundle = treg.build_gpt_mini(1e-3, seq_len=SEQ, dtype="float32",
                                 device="cpu")
    state = TTrainState.create(bundle.state.model,
                               topt.make_optimizer("adam", 1e-3), ema=True)
    start = {n: p.clone() for n, p in state.ema_params.items()}
    step = tsync.build_sync_train_step(bundle.loss_fn, ema_decay=0.9)
    state, _ = step(state, bundle.load_datasets(None).train.next_batch(4))
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema_params[name],
                                   0.9 * start[name] + 0.1 * p.detach())
