"""The port's continuous-batching engine and HTTP tier
(distributed_tensorflow_tpu_torch/serving) against the JAX package's
engine on the same f32 weights, on the CPU: greedy token parity with
admissions interleaved with decoding, seeded sampling, the deferred
engine arms, and a ServingServer + ServeClient round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.serving import engine as jengine
from distributed_tensorflow_tpu.serving.scheduler import Request as JRequest
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.serving.client import ServeClient
from distributed_tensorflow_tpu_torch.serving.engine import (DecodeEngine,
                                                             EngineConfig)
from distributed_tensorflow_tpu_torch.serving.scheduler import (
    FairScheduler, Request)
from distributed_tensorflow_tpu_torch.serving.server import ServingServer
from distributed_tensorflow_tpu_torch.utils.telemetry import Telemetry

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position=64, dtype="float32",
           attention_backend="pallas", fused_ln=True)
GEO = dict(num_slots=2, page_size=4, num_pages=32, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def models():
    jm = jgpt.GptLM(jgpt.GptConfig(**CFG))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tgpt.GptLM(tgpt.GptConfig(**CFG), device="cpu")
    tm.load_state_dict(tgpt.params_from_jax(params))
    return jm, params, tm


def _engine(tm, **kw):
    return DecodeEngine(tm, None, EngineConfig(**{**GEO, **kw}),
                        device="cpu")


def _serve(engine, requests):
    """Admit whenever a slot is free, one step at a time, to the end."""
    pending = list(requests)
    while pending or engine.active_slots:
        while pending and engine.free_slots:
            engine.admit(pending.pop(0))
        engine.step()
    return [r.tokens for r in requests]


PROMPTS = [[1, 2, 3], [5] * 9, [7, 8], list(range(10, 23)), [4], [9, 1, 9]]


def test_greedy_tokens_equal_jax_engine_with_interleaved_admission(models):
    jm, params, tm = models
    budgets = [6, 4, 8, 5, 7, 3]
    got = _serve(_engine(tm), [Request(p, n)
                               for p, n in zip(PROMPTS, budgets)])
    want = _serve(jengine.DecodeEngine(jm, params,
                                       jengine.EngineConfig(**GEO)),
                  [JRequest(p, n) for p, n in zip(PROMPTS, budgets)])
    assert got == want
    assert [len(t) for t in got] == budgets


def test_seeded_sampling_is_reproducible_under_any_batch_composition(models):
    _, _, tm = models
    engine = _engine(tm, num_slots=3)
    kw = dict(temperature=0.9, top_k=16, seed=7)
    alone = Request([5, 6, 7], 10, **kw)
    _serve(engine, [alone])
    crowd = Request([5, 6, 7], 10, **kw)
    engine.admit(Request([1, 2], 12, temperature=0.5, seed=3))
    engine.step()
    _serve(engine, [crowd, Request([4, 4, 4, 4], 8)])
    assert crowd.tokens == alone.tokens
    other_seed = Request([5, 6, 7], 10, temperature=0.9, top_k=16, seed=8)
    _serve(engine, [other_seed])
    assert other_seed.tokens != alone.tokens
    # eos retires the lane the step it emits the stop token.
    eos = alone.tokens[3]
    stopped = Request([5, 6, 7], 10, eos_id=eos, **kw)
    _serve(engine, [stopped])
    assert stopped.tokens == alone.tokens[:alone.tokens.index(eos) + 1]


def test_top_k_one_sampling_is_greedy(models):
    _, _, tm = models
    greedy = _serve(_engine(tm), [Request([3, 1, 4, 1, 5], 8)])
    top1 = _serve(_engine(tm), [Request([3, 1, 4, 1, 5], 8,
                                        temperature=1.5, top_k=1, seed=11)])
    assert top1 == greedy


def test_sampling_stays_inside_top_k_and_top_p_support():
    rng = np.random.default_rng(0)
    B, V = 64, 50
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32)
                              * 3)
    top_k = torch.from_numpy(rng.integers(1, 6, B).astype(np.int32))
    temp = torch.full((B,), 1.0)
    u = tgpt.row_uniforms(np.arange(B), np.full(B, 5), V)
    out = tgpt.sample_logits_dynamic(logits, u, temp, top_k,
                                     torch.zeros(B))
    ranks = (logits > logits.gather(1, out.long()[:, None])).sum(1)
    assert (ranks < top_k).all()
    # top_p: the sampled token's exclusive mass is below p.
    p = torch.full((B,), 0.3)
    out = tgpt.sample_logits_dynamic(logits, u, temp, torch.zeros(B,
                                     dtype=torch.int32), p)
    probs = torch.softmax(logits, -1)
    picked = probs.gather(1, out.long()[:, None])[:, 0]
    excl = (probs * (probs > picked[:, None])).sum(1)
    assert (excl < p).all()
    # temperature 0 is the argmax whatever the noise.
    out = tgpt.sample_logits_dynamic(logits, u, torch.zeros(B), top_k,
                                     torch.zeros(B))
    assert torch.equal(out.long(), logits.argmax(-1))


def test_row_uniforms_depend_only_on_seed_and_position():
    a = tgpt.row_uniforms([1, 2, 3], [4, 5, 6], 16)
    b = tgpt.row_uniforms([9, 2, 1], [0, 5, 4], 16, rows=[1, 2])
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[2])
    assert torch.equal(b[0], torch.full((16,), 0.5))
    assert (a > 0).all() and (a < 1).all()


@pytest.mark.parametrize("kw", [dict(spec_k=2), dict(spec_k=4),
                                dict(prefill_chunk=8)])
def test_engine_rejects_unported_arms(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(**kw)


def test_engine_validates_requests_like_jax(models):
    _, _, tm = models
    engine = _engine(tm, num_slots=1, num_pages=16, max_pages_per_seq=4)
    for bad in (Request([], 4), Request([1], 0), Request([999], 4),
                Request([1], 4, top_p=1.5), Request([1], 4, eos_id=999),
                Request([1] * 10, 10), Request([1], 4, seed=2 ** 31),
                Request([1], 4, temperature=0.5, speculative=True)):
        with pytest.raises(ValueError):
            engine.validate(bad)
    with pytest.raises(ValueError):
        EngineConfig(spec_k=1)


def test_engine_telemetry_and_hot_swap(models):
    _, _, tm = models
    tel = Telemetry()
    engine = DecodeEngine(tm, None, EngineConfig(**GEO), tel, device="cpu")
    before = _serve(engine, [Request([2, 3, 4], 5)])
    zeros = {k: torch.zeros_like(v) for k, v in tm.state_dict().items()}
    engine.swap_params(zeros, step=9)
    after = _serve(engine, [Request([2, 3, 4], 5)])
    assert engine.model_step == 9 and engine.swaps == 1
    assert after == [[0] * 5] and before != after   # all-zero logits
    snap = tel.summary()
    assert snap["counters"]["serve_requests"] == 2
    assert snap["counters"]["serve_swaps"] == 1
    assert engine.stats()["kv_pool"]["pages_in_use"] == 0
    with pytest.raises(ValueError, match="do not match"):
        engine.swap_params({"nope": torch.zeros(1)})


def test_http_round_trip_matches_engine(models):
    _, _, tm = models
    want = _serve(_engine(tm), [Request([8, 9, 10], 6, tenant="a")])[0]
    engine = _engine(tm)
    server = ServingServer(engine, FairScheduler(), port=0,
                           host="127.0.0.1", telemetry=Telemetry())
    server.start()
    try:
        client = ServeClient(f"http://127.0.0.1:{server.port}", timeout_s=60)
        out = client.generate([8, 9, 10], 6, tenant="a")
        assert out["tokens"] == [8, 9, 10] + want
        assert out["tokens_out"] == 6 and out["ttft_ms"] > 0
        health = client.health()
        assert health["status"] == "ok" and health["num_slots"] == 2
        stats = client.stats()
        assert stats["tenants"]["a"]["completed"] == 1
        assert stats["engine"]["compile_cache"]["prefill_programs"] == 0
        with pytest.raises(ValueError):
            client.generate([999], 2)
    finally:
        server.shutdown()
