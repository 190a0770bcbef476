"""The port's paged chunk body (distributed_tensorflow_tpu_torch/models/
gpt.py: ``GptBlock.decode_chunk_paged`` and ``_attend_cache_chunk``,
``GptLM.decode_chunk_paged`` and ``prefill_chunk_paged``) against the JAX
package's on the same weights: logits and pools, the chunk against the
same tokens one paged decode step at a time, writes past the page table
dropped, and the prefill body's pools.  Small f32 models; inputs from
seeded numpy generators; the JAX side's Pallas LayerNorm runs in
interpret mode on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu_torch.models import gpt as tgpt

# f32 end to end; matmul and softmax summation orders differ.
TOL = 1e-4

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position=64, dtype="float32")
VARIANTS = {
    "mha": {},
    "gqa": dict(kv_heads=1),
    "rope": dict(pos_encoding="rope"),
    "pallas_fused_ln": dict(attention_backend="pallas", fused_ln=True),
}
NUM_PAGES, PAGE = 8, 4


@functools.lru_cache(maxsize=None)
def _jax_model(variant):
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


def _pools(cfg, seed, num_pages=NUM_PAGES):
    rng = np.random.default_rng(seed)
    shape = (num_pages, PAGE, cfg.num_kv_heads, cfg.head_dim)
    return [(rng.standard_normal(shape).astype(np.float32),
             rng.standard_normal(shape).astype(np.float32))
            for _ in range(cfg.num_layers)]


def _jax_pools(pools_np, dtype=jnp.float32):
    return [tuple(jnp.asarray(a).astype(dtype) for a in p) for p in pools_np]


def _torch_pools(pools_np, dtype=torch.float32):
    return [tuple(torch.from_numpy(a.copy()).to(dtype) for a in p)
            for p in pools_np]


# Row 0 feeds 4 tokens at positions 5..8 over pages [2, 5, 1]; row 1 at
# 9..12 over [3, 6, sentinel]: position 9-11's page is the sentinel and
# 12 lies past its 3-page table, so all its writes drop; row 2 is an idle
# lane (all-sentinel table) at position 0.
TABLES = np.array([[2, 5, 1], [3, 6, NUM_PAGES], [NUM_PAGES] * 3], np.int32)
POSITIONS = np.array([5, 9, 0], np.int32)


def _chunk(seed, B=3, K=4):
    return np.random.default_rng(seed).integers(0, 64, (B, K)).astype(
        np.int32)


def _jax_chunk(jm, params, method, tokens, pools, tables, positions):
    return jm.apply({"params": params}, jnp.asarray(tokens), pools,
                    jnp.asarray(tables), jnp.asarray(positions),
                    method=method)


def _torch_chunk(tm, method, tokens, pools, tables, positions):
    return getattr(tm, method)(torch.from_numpy(tokens).long(), pools,
                               torch.from_numpy(tables),
                               torch.from_numpy(positions).long())


def _written(pools_after, pools_np):
    """(page, offset) pairs of layer 0's K pool that changed."""
    k = pools_after[0][0].float().numpy()
    return np.argwhere((k != pools_np[0][0]).any(axis=(2, 3))).tolist()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_chunk_paged_logits_and_pools_match_jax(variant):
    jm, params, tm = _models(variant)
    pools_np = _pools(tm.cfg, 3)
    tokens = _chunk(4)
    want_logits, want_pools = _jax_chunk(
        jm, params, jgpt.GptLM.decode_chunk_paged, tokens,
        _jax_pools(pools_np), TABLES, POSITIONS)
    got_logits, got_pools = _torch_chunk(
        tm, "decode_chunk_paged", tokens, _torch_pools(pools_np), TABLES,
        POSITIONS)
    assert got_logits.shape == (3, 4, 64)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
    for (wk, wv), (gk, gv) in zip(want_pools, got_pools):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL)
    # Row 0's positions 5..8: page 5 offsets 1-3, then page 1 offset 0.
    # Row 1's and row 2's writes all dropped.
    assert _written(got_pools, pools_np) == [[1, 0], [5, 1], [5, 2], [5, 3]]


def test_float8_pool_round_trip_matches_jax():
    """The chunk's K/V are cast to the float8 pool's dtype before they are
    attended, on both sides."""
    jm, params, tm = _models("mha")
    pools_np = _pools(tm.cfg, 5)
    tokens = _chunk(6)
    want_logits, want_pools = _jax_chunk(
        jm, params, jgpt.GptLM.decode_chunk_paged, tokens,
        _jax_pools(pools_np, jnp.float8_e4m3fn), TABLES, POSITIONS)
    got_logits, got_pools = _torch_chunk(
        tm, "decode_chunk_paged", tokens,
        _torch_pools(pools_np, torch.float8_e4m3fn), TABLES, POSITIONS)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
    for (wk, wv), (gk, gv) in zip(want_pools, got_pools):
        assert gk.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            gk.float().numpy(), np.asarray(wk.astype(jnp.float32)))
        np.testing.assert_array_equal(
            gv.float().numpy(), np.asarray(wv.astype(jnp.float32)))


@pytest.mark.parametrize("variant", ["mha", "rope"])
def test_chunk_matches_a_sequence_of_paged_decode_steps(variant):
    """decode_chunk_paged == K sequential decode_paged calls: the same
    logits for the fed tokens and the same pool state."""
    _, _, tm = _models(variant)
    B, P, K = 1, 6, 4
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 64, (B, P))
    chunk = rng.integers(0, 64, (B, K)).astype(np.int32)

    def prefilled():
        pools = tgpt.init_kv_pool(tm.cfg, 16, 4, device="cpu")
        caches = tgpt.init_kv_cache(tm.cfg, B, 8, device="cpu")
        tm.prefill(torch.from_numpy(prompt).long(), caches)
        for (kc, vc), (kp, vp) in zip(caches, pools):
            kp[:2] = kc[0].reshape(2, 4, *kc.shape[2:])
            vp[:2] = vc[0].reshape(2, 4, *vc.shape[2:])
        return pools

    tables = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    logits_c, pools_c = tm.decode_chunk_paged(
        torch.from_numpy(chunk).long(), prefilled(), tables,
        torch.full((B,), P))
    pools_s = prefilled()
    for i in range(K):
        ref, pools_s = tm.decode_paged(torch.from_numpy(chunk[:, i]).long(),
                                       pools_s, tables,
                                       torch.full((B,), P + i))
        np.testing.assert_allclose(logits_c[:, i].numpy(), ref.numpy(),
                                   rtol=2e-5, atol=2e-5)
    for (kc, vc), (ks, vs) in zip(pools_c, pools_s):
        np.testing.assert_allclose(kc.numpy(), ks.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(vc.numpy(), vs.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_chunk_writes_past_the_table_drop_and_never_touch_real_pages():
    """A row owning every page of its 2-page table speculates past it:
    positions 8 and 9 drop, where a clamp would have written them onto
    the last real page's committed offsets 0 and 1."""
    jm, params, tm = _models("mha")
    pools_np = _pools(tm.cfg, 7)
    tables = np.array([[0, 1]], np.int32)
    positions = np.array([6], np.int32)
    tokens = np.array([[1, 2, 3, 4]], np.int32)
    _, got = _torch_chunk(tm, "decode_chunk_paged", tokens,
                          _torch_pools(pools_np), tables, positions)
    assert _written(got, pools_np) == [[1, 2], [1, 3]]
    _, want = _jax_chunk(jm, params, jgpt.GptLM.decode_chunk_paged, tokens,
                         _jax_pools(pools_np), tables, positions)
    for (wk, wv), (gk, gv) in zip(want, got):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL)


@pytest.mark.parametrize("variant", ["mha", "pallas_fused_ln"])
def test_prefill_chunk_pools_equal_the_verify_body_and_jax(variant):
    """prefill_chunk_paged is decode_chunk_paged without the LM head: the
    same pool writes bit for bit, and JAX's within TOL."""
    jm, params, tm = _models(variant)
    pools_np = _pools(tm.cfg, 8)
    tokens = _chunk(9)
    got = _torch_chunk(tm, "prefill_chunk_paged", tokens,
                       _torch_pools(pools_np), TABLES, POSITIONS)
    _, verify = _torch_chunk(tm, "decode_chunk_paged", tokens,
                             _torch_pools(pools_np), TABLES, POSITIONS)
    want = _jax_chunk(jm, params, jgpt.GptLM.prefill_chunk_paged, tokens,
                      _jax_pools(pools_np), TABLES, POSITIONS)
    for (gk, gv), (vk, vv), (wk, wv) in zip(got, verify, want):
        assert torch.equal(gk, vk) and torch.equal(gv, vv)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL)


def test_positions_past_max_position_embed_as_nan_like_jax():
    """A draft past the position table reads NaN rows, as flax's Embed
    (``jnp.take``) does, where indexing would raise."""
    _, params, tm = _models("mha")
    ids = np.array([[0, 63, 64, 70]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(params["pos_emb"]["embedding"]),
                               jnp.asarray(ids), axis=0))
    with torch.no_grad():
        got = tm.pos_emb(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[0, :2], want[0, :2])
    assert np.isnan(got[0, 2:]).all()


def test_window_checkpoints_are_refused():
    tm = tgpt.GptLM(tgpt.GptConfig(**{**SMALL, "attention_window": 8}),
                    device="cpu")
    pools = _torch_pools(_pools(tm.cfg, 1))
    with pytest.raises(ValueError, match="not pageable"):
        _torch_chunk(tm, "decode_chunk_paged", _chunk(1, B=1),
                     pools, TABLES[:1], POSITIONS[:1])
