"""The port's decode family (distributed_tensorflow_tpu_torch/models/gpt.py:
``sample_logits``, ``generate``, ``generate_cached`` and
``beam_search_cached``) against the JAX package's on the same weights and
prompts: greedy tokens (the windowed ring cache, int8 weights and a
float8 cache included), eos stopping, beam tokens and log-probabilities;
and the invariants of the JAX package's own decode tests (test_gpt.py,
test_eos_decode.py, test_beam_search.py, test_window_attention.py,
test_gqa.py, test_rope.py, test_gpt_arch_variants.py, test_quant.py with
seeded random weights).  Sampled streams are reproducible from a
generator's seed but are not JAX's (other random bits), so they are held
to the port's own uncached run and to JAX's filtered support.  Small f32
models; prompts from seeded numpy generators; the JAX side's Pallas
kernels run in interpret mode on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu_torch.models import gpt as tgpt

# f32 end to end: greedy tokens equal, log-probabilities within 1e-4.
TOL = 1e-4

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position=64, dtype="float32")
VARIANTS = {
    "mha": {},
    "pallas_fused_ln": dict(attention_backend="pallas", fused_ln=True),
    # True GQA: 4 query heads over 2 kv heads.
    "gqa_rope_swiglu_rmsnorm": dict(num_heads=4, kv_heads=2,
                                    pos_encoding="rope",
                                    activation="swiglu", norm="rmsnorm"),
    "window": dict(attention_window=4, pos_encoding="rope"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _prompt(seed, B=2, P=8):
    return np.random.default_rng(seed).integers(0, 64, (B, P)).astype(
        np.int32)


def _jax(fn, jm, params, prompt, *args, **kw):
    """``fn(jm, params, prompt, *args, **kw)`` as one jitted JAX program
    (one compile, where the eager call compiles op by op)."""
    run = jax.jit(lambda p, x: fn(jm, p, x, *args, **kw))
    return jax.tree.map(np.asarray, run(params, jnp.asarray(prompt)))


def _first_hit(row, eos):
    hits = np.flatnonzero(row == eos)
    return int(hits[0]) if hits.size else None


@pytest.mark.parametrize("variant", ["pallas_fused_ln",
                                     "gqa_rope_swiglu_rmsnorm", "window"])
def test_greedy_tokens_match_jax(variant):
    """Port generate_cached and the uncached generate give JAX
    generate_cached's greedy tokens (the window's prompt is longer than
    the window and the ring wraps)."""
    jm, params, tm = _models(variant)
    prompt = _prompt(1)
    want = _jax(jgpt.generate_cached, jm, params, prompt, 10)
    got = tgpt.generate_cached(tm, None, prompt, 10)
    assert got.shape == (2, 18) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # Params given as a mapping: the JAX tree through params_from_jax.
    full = tgpt.generate(tm, tgpt.params_from_jax(params), prompt, 10)
    np.testing.assert_array_equal(full.numpy(), want)


def test_int8_weights_and_float8_cache_match_jax():
    jm, params, tm = _models("mha")
    prompt = _prompt(2)
    arm = dict(quantize="int8", kv_dtype="float8")
    want = _jax(jgpt.generate_cached, jm, params, prompt, 12, **arm)
    got = tgpt.generate_cached(tm, None, prompt, 12, **arm).numpy()
    np.testing.assert_array_equal(got, want)
    # test_quant.py:105-117 on seeded random weights: int8 weights and a
    # float8 cache keep most of the greedy decode.
    full = tgpt.generate_cached(tm, None, prompt, 12).numpy()
    for kw in (dict(quantize="int8"), dict(kv_dtype="float8"), arm):
        quant = tgpt.generate_cached(tm, None, prompt, 12, **kw).numpy()
        assert np.mean(quant == full) > 0.9, (kw, quant, full)


def test_eos_truncates_pads_and_matches_jax():
    """test_eos_decode.py: a row stops at its first eos and pads with it,
    other rows go on unchanged, the uncached loop agrees, and the tokens
    are JAX's."""
    jm, params, tm = _models("mha")
    prompt = _prompt(3, B=3, P=6)
    N = 12
    free = tgpt.generate_cached(tm, None, prompt, N).numpy()
    gen = free[:, 6:]
    eos = int(gen[0, 4])
    out = tgpt.generate_cached(tm, None, prompt, N, eos_id=eos).numpy()
    np.testing.assert_array_equal(out[:, :6], prompt)
    for b in range(3):
        k = _first_hit(gen[b], eos)
        if k is None:
            np.testing.assert_array_equal(out[b, 6:], gen[b])
        else:
            np.testing.assert_array_equal(out[b, 6:6 + k + 1], gen[b, :k + 1])
            assert (out[b, 6 + k:] == eos).all()
    full = tgpt.generate(tm, None, prompt, N, eos_id=eos).numpy()
    np.testing.assert_array_equal(full, out)
    want = _jax(jgpt.generate_cached, jm, params, prompt, N, eos_id=eos)
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError, match="eos_id"):
        tgpt.generate_cached(tm, None, prompt, 4, eos_id=64)
    with pytest.raises(ValueError, match="eos_id"):
        tgpt.generate(tm, None, prompt, 4, eos_id=-2)


def test_sample_logits_filters_and_stays_in_jax_support(monkeypatch):
    """test_gpt.py:131: top_k=1 and a tiny nucleus are the argmax; top_k=2
    at a high temperature draws both and only the top two.  Every draw
    lies where JAX's own filter (captured at its categorical draw) keeps
    the logits."""
    logits = torch.tensor([[1.0, 2.0, 0.0, 5.0]] * 64)
    g = torch.Generator().manual_seed(0)
    assert (tgpt.sample_logits(logits, g, temperature=10.0, top_k=1)
            == 3).all()
    assert (tgpt.sample_logits(logits, g, temperature=10.0, top_p=1e-6)
            == 3).all()
    draws = torch.cat([tgpt.sample_logits(logits, g, temperature=50.0,
                                          top_k=2) for _ in range(20)])
    assert set(draws.tolist()) == {1, 3}

    rng = np.random.default_rng(4)
    step = rng.standard_normal((8, 64)).astype(np.float32) * 3
    seen = {}

    def capture(key, filtered, axis=-1):
        seen["logits"] = np.asarray(filtered)
        return jnp.argmax(filtered, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    for kw in (dict(top_k=5), dict(top_p=0.6), dict(top_k=7, top_p=0.5)):
        jgpt.sample_logits(jnp.asarray(step), jax.random.PRNGKey(0),
                           temperature=0.7, **kw)
        support = seen["logits"] > np.finfo(np.float32).min
        hits = set()
        for seed in range(30):
            got = tgpt.sample_logits(torch.from_numpy(step),
                                     torch.Generator().manual_seed(seed),
                                     temperature=0.7, **kw).numpy()
            assert support[np.arange(8), got].all(), kw
            hits.update(zip(range(8), got.tolist()))
        assert len(hits) > 8                  # not only the argmax


def test_sampled_cached_equals_uncached_from_the_same_seed():
    """test_gpt.py:150: both loops draw from the generator once a step in
    the same order, so sampled streams agree token for token; a sampled
    eos run stops and pads."""
    _, _, tm = _models("gqa_rope_swiglu_rmsnorm")
    prompt = _prompt(5)
    kw = dict(temperature=1.0, top_k=8, top_p=0.9)
    full = tgpt.generate(tm, None, prompt, 8,
                         generator=torch.Generator().manual_seed(7), **kw)
    cached = tgpt.generate_cached(tm, None, prompt, 8,
                                  generator=torch.Generator().manual_seed(7),
                                  **kw)
    np.testing.assert_array_equal(full.numpy(), cached.numpy())
    again = tgpt.generate_cached(tm, None, prompt, 8,
                                 generator=torch.Generator().manual_seed(7),
                                 **kw)
    np.testing.assert_array_equal(again.numpy(), cached.numpy())
    eos = int(cached[0, 8 + 4])
    out = tgpt.generate_cached(tm, None, prompt, 8, eos_id=eos,
                               generator=torch.Generator().manual_seed(7),
                               **kw).numpy()
    # The same draws up to row 0's eos, so row 0 stops there.
    assert _first_hit(out[0, 8:], eos) == _first_hit(
        cached[0, 8:].numpy(), eos)
    for b in range(2):
        k = _first_hit(out[b, 8:], eos)
        if k is not None:
            assert (out[b, 8 + k:] == eos).all()
    with pytest.raises(ValueError, match="generator"):
        tgpt.generate(tm, None, prompt, 4, temperature=1.0)
    with pytest.raises(ValueError, match="top_p"):
        tgpt.generate(tm, None, prompt, 4, temperature=1.0, top_p=1.5,
                      generator=torch.Generator())
    with pytest.raises(ValueError, match="max_position"):
        tgpt.generate_cached(tm, None, prompt, 57)


def _gen_logprob(tm, toks, split):
    """Cumulative log-probability of the generated region under the
    model's uncached forward."""
    with torch.no_grad():
        logp = torch.log_softmax(tm(toks, deterministic=True).float(), -1)
    rows = torch.arange(toks.shape[0])
    return sum(logp[rows, t - 1, toks[:, t]] for t in
               range(split, toks.shape[1]))


def test_beam_search_matches_jax_and_beats_greedy():
    """Tokens and log-probabilities of a width-4 beam are JAX's; width 1 is
    greedy; the wider beam scores at least greedy's and reports the
    model's own log-probability.  The model and prompt of
    test_beam_search.py:57 (``beam >= greedy`` is a property of that
    data, not a theorem: a beam can prune the greedy path)."""
    cfg = jgpt.GptConfig(**SMALL)
    jm = jgpt.GptLM(cfg)
    tokens = jgpt.synthetic_lm_batch(3, 2, 24, cfg)["tokens"]
    params = jax.device_get(jm.init(jax.random.PRNGKey(3),
                                    jnp.asarray(tokens))["params"])
    tm = tgpt.GptLM(tgpt.GptConfig(**SMALL), device="cpu")
    tm.load_state_dict(tgpt.params_from_jax(params))
    prompt = tokens[:, :8]
    want, want_lp = _jax(jgpt.beam_search_cached, jm, params, prompt, 10,
                         beam_size=4)
    got, got_lp = tgpt.beam_search_cached(tm, None, prompt, 10, beam_size=4)
    assert got.shape == (2, 18) and got_lp.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, atol=TOL, rtol=TOL)
    greedy = tgpt.generate_cached(tm, None, prompt, 10)
    one, _ = tgpt.beam_search_cached(tm, None, prompt, 10, beam_size=1)
    np.testing.assert_array_equal(one.numpy(), greedy.numpy())
    lp_beam = _gen_logprob(tm, got, 8)
    assert (lp_beam >= _gen_logprob(tm, greedy, 8) - 1e-4).all()
    torch.testing.assert_close(got_lp, lp_beam, atol=1e-4, rtol=1e-4)
    for kw, match in ((dict(beam_size=0), "beam_size"),
                      (dict(beam_size=65), "vocab_size"),
                      (dict(beam_size=2, eos_id=1, length_penalty=0.0),
                       "length_penalty")):
        with pytest.raises(ValueError, match=match):
            tgpt.beam_search_cached(tm, None, prompt, 4, **kw)
    with pytest.raises(ValueError, match="num_tokens"):
        tgpt.beam_search_cached(tm, None, prompt, 0, beam_size=2)


def test_beam_eos_freezes_and_matches_jax():
    """test_eos_decode.py:105-152: finished beams freeze (eos padding);
    an eos the search never picks changes nothing, whatever the length
    penalty; width 1 with eos is greedy with eos; the eos beams are
    JAX's."""
    jm, params, tm = _models("mha")
    prompt = _prompt(7, P=6)
    base, base_lp = tgpt.beam_search_cached(tm, None, prompt, 10,
                                            beam_size=4)
    eos = int(base[0, 6 + 5])
    out, lp = tgpt.beam_search_cached(tm, None, prompt, 10, beam_size=4,
                                      eos_id=eos)
    out = out.numpy()
    np.testing.assert_array_equal(out[:, :6], prompt)
    assert torch.isfinite(lp).all()
    for b in range(2):
        k = _first_hit(out[b, 6:], eos)
        if k is not None:
            assert (out[b, 6 + k:] == eos).all()
    want, want_lp = _jax(jgpt.beam_search_cached, jm, params, prompt, 10,
                         beam_size=4, eos_id=eos)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_allclose(lp.numpy(), want_lp, atol=TOL, rtol=TOL)
    unused = next(v for v in range(64)
                  if v not in set(base.flatten().tolist()))
    same, same_lp = tgpt.beam_search_cached(tm, None, prompt, 10,
                                            beam_size=4, eos_id=unused,
                                            length_penalty=2.0)
    np.testing.assert_array_equal(same.numpy(), base.numpy())
    torch.testing.assert_close(same_lp, base_lp, rtol=1e-5, atol=1e-5)
    greedy = tgpt.generate_cached(tm, None, prompt, 8, eos_id=eos)
    one, _ = tgpt.beam_search_cached(tm, None, prompt, 8, beam_size=1,
                                     eos_id=eos)
    np.testing.assert_array_equal(one.numpy(), greedy.numpy())


def test_beam_reorders_the_window_ring_and_float8_caches():
    """test_beam_search.py:80 and test_window_attention.py: the ring cache
    survives the parent reorder, with int8 weights and a float8 cache;
    the window's cached beam equals its uncached greedy at width 1."""
    _, _, tm = _models("window")
    prompt = _prompt(8)
    base, _ = tgpt.beam_search_cached(tm, None, prompt, 6, beam_size=3)
    q8, _ = tgpt.beam_search_cached(tm, None, prompt, 6, beam_size=3,
                                    quantize="int8", kv_dtype="float8")
    assert q8.shape == base.shape and int(q8.max()) < 64
    np.testing.assert_array_equal(q8[:, :8].numpy(), prompt)
    one, _ = tgpt.beam_search_cached(tm, None, prompt, 10, beam_size=1)
    np.testing.assert_array_equal(
        one.numpy(), tgpt.generate(tm, None, prompt, 10).numpy())
