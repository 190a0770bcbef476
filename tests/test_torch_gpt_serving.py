"""The port's GPT serving subset (distributed_tensorflow_tpu_torch/models/
gpt.py) against the JAX package's GptLM on the same weights: the
parameter mapping round trip, prefill and paged-decode logits and KV
pools, and the int8-weight / float8-KV engine path.  Small f32 models;
inputs from seeded numpy generators; the JAX side's Pallas kernels run in
interpret mode on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.serving import engine as jengine
from distributed_tensorflow_tpu.serving.scheduler import Request as JRequest
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.ops import quant as tquant
from distributed_tensorflow_tpu_torch.serving import engine as tengine
from distributed_tensorflow_tpu_torch.serving.scheduler import Request

# f32 end to end; matmul and softmax summation orders differ.
TOL = 1e-4

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position=64, dtype="float32")
VARIANTS = {
    "plain": {},
    "pallas_fused_ln": dict(attention_backend="pallas", fused_ln=True),
    "rope": dict(pos_encoding="rope"),
    "gqa": dict(kv_heads=1, attention_backend="pallas", fused_ln=True),
    "swiglu_rmsnorm": dict(activation="swiglu", norm="rmsnorm"),
}


@functools.lru_cache(maxsize=None)
def _jax_model(variant):
    """JAX model and its initialised parameters, once per variant."""
    jm = jgpt.GptLM(jgpt.GptConfig(**{**SMALL, **VARIANTS[variant]}))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    return jm, params


def _models(variant):
    jm, params = _jax_model(variant)
    tm = tgpt.GptLM(tgpt.GptConfig(**{**SMALL, **VARIANTS[variant]}),
                    device="cpu")
    tm.load_state_dict(tgpt.params_from_jax(params))
    return jm, params, tm


def _assert_tree_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _assert_tree_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a[key], np.float32),
                                          b[key])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_from_jax_round_trip(variant):
    _, params, tm = _models(variant)
    _assert_tree_equal(params, tgpt.params_to_jax(tm.state_dict()))
    assert tgpt.infer_arch_from_layer0(params["layer0"]) == \
        tgpt.infer_arch_from_layer0(
            tgpt.params_to_jax(tm.state_dict())["layer0"])


def test_bf16_model_stores_compute_weights_in_bf16_and_the_rest_fp32():
    tm = tgpt.GptLM(tgpt.GptConfig(**{**SMALL, "dtype": "bfloat16"}),
                    device="cpu")
    sd = tm.state_dict()
    assert sd["layers.0.qkv.kernel"].dtype == torch.bfloat16
    assert sd["layers.1.mlp_out.bias"].dtype == torch.bfloat16
    for name in ("word_emb.embedding", "pos_emb.embedding",
                 "layers.0.ln_attn.scale", "lm_head.kernel"):
        assert sd[name].dtype == torch.float32, name
    assert sd["layers.0.qkv.kernel"].shape == (32, 3, 2, 16)
    assert sd["layers.0.out.kernel"].shape == (2, 16, 32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_prefill_match_jax(variant):
    jm, params, tm = _models(variant)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 64, (2, 12)).astype(np.int32)
    want = jm.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    jc = jgpt.init_kv_cache(jm.cfg, 2, 16)
    want_logits, want_caches = jm.apply({"params": params},
                                        jnp.asarray(tokens), jc,
                                        method=jgpt.GptLM.prefill)
    tc = tgpt.init_kv_cache(tm.cfg, 2, 16, device="cpu")
    got_logits, got_caches = tm.prefill(torch.from_numpy(tokens).long(), tc)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
    for (wk, wv), (gk, gv) in zip(want_caches, got_caches):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL)


def test_ragged_prefill_writes_only_real_positions():
    jm, params, tm = _models("plain")
    tokens = np.random.default_rng(2).integers(0, 64, (2, 10)).astype(
        np.int32)
    lengths = np.array([10, 6], np.int32)
    jc = jgpt.init_kv_cache(jm.cfg, 2, 16)
    _, want = jm.apply({"params": params}, jnp.asarray(tokens), jc,
                       jnp.asarray(lengths), method=jgpt.GptLM.prefill)
    tc = tgpt.init_kv_cache(tm.cfg, 2, 16, device="cpu")
    _, got = tm.prefill(torch.from_numpy(tokens).long(), tc,
                        torch.from_numpy(lengths))
    for (wk, _), (gk, _) in zip(want, got):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=TOL)
    assert not got[0][0][1, 6:].any()


@pytest.mark.parametrize("variant", ["plain", "pallas_fused_ln", "rope",
                                     "gqa"])
def test_decode_paged_logits_and_pools_match_jax(variant):
    """Row 0 decodes at position 5 over pages [2, 5]; row 1 is an idle lane
    (all-sentinel table): it must write nowhere and read zeros."""
    jm, params, tm = _models(variant)
    cfg = tm.cfg
    num_pages, page = 8, 4
    rng = np.random.default_rng(3)
    shape = (num_pages, page, cfg.num_kv_heads, cfg.head_dim)
    pools_np = [(rng.standard_normal(shape).astype(np.float32),
                 rng.standard_normal(shape).astype(np.float32))
                for _ in range(cfg.num_layers)]
    tables = np.array([[2, 5, num_pages], [num_pages] * 3], np.int32)
    positions = np.array([5, 0], np.int32)
    token = np.array([7, 3], np.int32)
    want_logits, want_pools = jm.apply(
        {"params": params}, jnp.asarray(token),
        [tuple(map(jnp.asarray, p)) for p in pools_np], jnp.asarray(tables),
        jnp.asarray(positions), method=jgpt.GptLM.decode_paged)
    pools = [tuple(torch.from_numpy(a.copy()) for a in p) for p in pools_np]
    got_logits, got_pools = tm.decode_paged(
        torch.from_numpy(token).long(), pools, torch.from_numpy(tables),
        torch.from_numpy(positions).long())
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
    for (wk, wv), (gk, gv), (k0, _) in zip(want_pools, got_pools, pools_np):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL)
        changed = np.argwhere((gk.numpy() != k0).any(axis=(2, 3)))
        assert changed.tolist() == [[5, 1]]    # page 5, offset 5 % 4


def test_quantize_tree_matches_jax_per_channel_rule():
    from distributed_tensorflow_tpu.ops import quant as jquant
    _, params, tm = _models("gqa")
    # min_size 1000 takes in the GQA projections [32, 2, 1, 16] of this
    # small model, whose scales vary along both small inner axes.
    want = jquant.quantize_tree(params, min_size=1000)
    got = tquant.quantize_tree(tm.state_dict(), min_size=1000)
    w_q = want["layer0"]["kv_proj"]["kernel"]
    g_q = got["layers.0.kv_proj.kernel"]
    np.testing.assert_array_equal(g_q["q"].numpy(), np.asarray(w_q["q"]))
    np.testing.assert_allclose(g_q["s"].numpy(), np.asarray(w_q["s"]),
                               rtol=1e-7)
    assert torch.is_tensor(got["layers.0.kv_proj.bias"])   # small: kept
    deq = tquant.dequantize_tree(got, torch.float32)
    assert deq.keys() == got.keys()
    assert tquant.quantized_bytes(got) < sum(
        t.numel() * 4 for t in tm.state_dict().values())
    assert tquant.resolve_kv_dtype("float8") == torch.float8_e4m3fn
    with pytest.raises(ValueError):
        tquant.resolve_kv_dtype("int4")


def test_int8_weights_float8_pool_engine_matches_jax_engine():
    jm, params, tm = _models("plain")
    geo = dict(num_slots=2, page_size=4, num_pages=32, max_pages_per_seq=8,
               quantize="int8", kv_dtype="float8")
    prompts = [[5, 6, 7, 8], [1, 2], [9, 10, 11, 12, 13, 14, 15]]
    got, want = [], []
    for engine, req_cls, out in (
            (tengine.DecodeEngine(tm, None, tengine.EngineConfig(**geo),
                                  device="cpu"), Request, got),
            (jengine.DecodeEngine(jm, params, jengine.EngineConfig(**geo)),
             JRequest, want)):
        reqs = [req_cls(p, 8) for p in prompts]
        pending = list(reqs)
        while pending or engine.active_slots:
            while pending and engine.free_slots:
                engine.admit(pending.pop(0))
            engine.step()
        out.extend(r.tokens for r in reqs)
    assert got == want
    assert all(len(t) == 8 for t in got)
