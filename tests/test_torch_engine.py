"""The port's continuous-batching engine and HTTP tier
(distributed_tensorflow_tpu_torch/serving) against the JAX package's
engine on the same f32 weights, on the CPU: greedy token parity with
admissions interleaved with decoding, seeded sampling, chunked prefill
and the speculative arm (each against the whole-bucket / plain engine
and the JAX engine with the same arm), and a ServingServer + ServeClient
round trip."""

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


# --------------------------------------------------------- chunked prefill


def _jax_engine(jm, params, **kw):
    return jengine.DecodeEngine(jm, params,
                                jengine.EngineConfig(**{**GEO, **kw}))


def _chunked_workload(engine, req_cls):
    """A 13-token prompt admitted while a seeded-sampled lane is mid-decode,
    with a one-token prompt beside it."""
    long_req = req_cls(list(range(1, 14)), 8)
    samp = req_cls([5, 6, 7], 6, temperature=0.8, top_k=16, seed=21)
    tiny = req_cls([9], 5)
    engine.admit(samp)
    engine.step()
    engine.admit(long_req)
    engine.admit(tiny)
    while engine.active_slots:
        engine.step()
    assert engine.allocator.pages_in_use == 0
    return long_req.tokens, samp.tokens, tiny.tokens


@pytest.mark.parametrize("quant", [{}, dict(quantize="int8",
                                            kv_dtype="float8")],
                         ids=["f32", "int8_float8"])
def test_chunked_prefill_tokens_equal_whole_bucket_and_jax(models, quant):
    """Greedy and seeded-sampled lanes emit the whole-bucket engine's
    tokens; the greedy lanes also the JAX chunked engine's."""
    jm, params, tm = models
    chunked = _chunked_workload(
        _engine(tm, num_slots=3, prefill_chunk=4, **quant), Request)
    assert chunked == _chunked_workload(_engine(tm, num_slots=3, **quant),
                                        Request)
    want = _chunked_workload(_jax_engine(jm, params, num_slots=3,
                                         prefill_chunk=4, **quant), JRequest)
    assert (chunked[0], chunked[2]) == (want[0], want[2])


def test_chunked_prefill_live_lane_keeps_decoding(models):
    """While a long prompt prefills in chunks, a live lane keeps emitting,
    and its tokens are the JAX engine's; telemetry counts the chunks."""
    jm, params, tm = models
    tel = Telemetry()
    records = []
    tel.emit = (lambda orig: lambda kind, step=0, **f: (
        records.append((kind, f)), orig(kind, step=step, **f)))(tel.emit)
    engine = DecodeEngine(tm, None, EngineConfig(**GEO, prefill_chunk=3),
                          tel, device="cpu")
    live = Request([5, 6, 7], 20)
    engine.admit(live)
    engine.step()
    long_req = Request(list(range(1, 14)), 4)   # target 12: 4 chunks
    engine.admit(long_req)
    assert engine.stats()["prefilling_slots"] == 1
    emitted = 0
    while any(s is not None and s.prefilling for s in engine._slots):
        n0 = len(live.tokens)
        engine.step()
        emitted += len(live.tokens) - n0
    assert emitted >= 3
    while engine.active_slots:
        engine.step()
    want = _serve(_jax_engine(jm, params), [JRequest([5, 6, 7], 20),
                                            JRequest(list(range(1, 14)), 4)])
    assert [live.tokens, long_req.tokens] == want
    steps = [f for kind, f in records if kind == "serve_step"]
    # 1 chunk for the live lane's own 2 positions, 4 for the long prompt.
    assert len([f for f in steps if f["prefill_rows"]]) == 5
    assert tel.summary()["counters"]["serve_prefill_chunks"] == 5
    assert engine.prefill_ms_total > 0.0


def test_spec_lane_stays_live_during_a_neighbours_prefill(models):
    """A speculative lane mid-decode while a neighbour chunk-prefills:
    both lanes emit the plain whole-bucket engine's tokens, and the JAX
    engine's with the same arms."""
    jm, params, tm = models

    def run(engine, req_cls, spec):
        spec_req = req_cls([5, 6, 7, 5, 6, 7], 12, speculative=spec)
        engine.admit(spec_req)
        engine.step()
        long_req = req_cls(list(range(1, 14)), 6)
        engine.admit(long_req)
        while engine.active_slots:
            engine.step()
        return spec_req.tokens, long_req.tokens

    got = run(_engine(tm, spec_k=6, prefill_chunk=4), Request, True)
    assert got == run(_engine(tm), Request, False)
    assert got == run(_jax_engine(jm, params, spec_k=6, prefill_chunk=4),
                      JRequest, True)


def test_abandoned_prefilling_lane_frees_its_pages(models):
    _, _, tm = models
    engine = _engine(tm, num_slots=1, prefill_chunk=2)
    req = Request(list(range(1, 14)), 4)
    engine.admit(req)
    assert engine.allocator.pages_in_use > 0
    engine.step()                           # one chunk lands
    assert engine._slots[0].prefilling
    req.abandoned = True
    retired = engine.step()
    assert [r.id for r in retired] == [req.id]
    assert engine.allocator.pages_in_use == 0 and engine.active_slots == 0
    assert req.tokens == []


# ---------------------------------------------------------- speculative arm


def test_spec_lane_equals_plain_greedy_in_fewer_steps(models):
    """A looping prompt: the spec lane emits the plain engine's and the
    JAX spec engine's tokens, several a step."""
    jm, params, tm = models
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7]
    req = Request(prompt, 16, speculative=True)
    engine = _engine(tm, spec_k=6)
    engine.validate(req)
    engine.admit(req)
    steps = 0
    while engine.active_slots:
        engine.step()
        steps += 1
    assert req.tokens == _serve(_engine(tm), [Request(prompt, 16)])[0]
    assert req.tokens == _serve(_jax_engine(jm, params, spec_k=6),
                                [JRequest(prompt, 16, speculative=True)])[0]
    assert req.spec_rounds == steps and len(req.tokens) == 16
    assert steps < 16


def test_spec_mixed_batch_with_admission_and_retirement(models):
    """Spec, plain and seeded-sampled lanes share the verify step under
    admission and retirement: every lane emits its plain-engine tokens,
    and the greedy lanes the JAX spec engine's."""
    jm, params, tm = models

    def run(engine, req_cls):
        r_spec = req_cls([5, 6, 7, 5, 6, 7], 12, speculative=True)
        r_plain = req_cls([1, 2, 3, 4], 10)
        r_samp = req_cls([9, 10, 11], 8, temperature=0.8, top_k=16,
                         seed=21)
        engine.admit(r_spec)
        engine.step()
        engine.admit(r_plain)
        engine.step()
        engine.admit(r_samp)
        while engine.active_slots:
            engine.step()
        assert engine.allocator.pages_in_use == 0
        return r_spec.tokens, r_plain.tokens, r_samp.tokens

    got = run(_engine(tm, num_slots=3, spec_k=6), Request)
    assert got == run(_engine(tm, num_slots=3), Request)
    want = run(_jax_engine(jm, params, num_slots=3, spec_k=6), JRequest)
    assert got[:2] == want[:2]


def test_spec_eos_mid_chunk_retires_exactly(models):
    """An eos accepted inside the chunk ends the emission there and
    retires the lane: the plain engine's eos-stopped tokens."""
    jm, params, tm = models
    prompt = [5, 6, 7, 5, 6, 7]
    free = _serve(_engine(tm), [Request(prompt, 12)])[0]
    eos = free[4]
    want = _serve(_engine(tm), [Request(prompt, 12, eos_id=eos)])[0]
    assert want[-1] == eos and len(want) <= 5
    tel = Telemetry()
    engine = DecodeEngine(tm, None, EngineConfig(**{**GEO, "num_slots": 1,
                                                    "spec_k": 6}), tel,
                          device="cpu")
    req = Request(prompt, 12, eos_id=eos, speculative=True)
    engine.admit(req)
    while engine.active_slots:
        engine.step()
    assert req.tokens == want
    # Only the tokens that landed count as accepted.
    assert tel.summary()["counters"]["serve_spec_tokens"] == len(want)
    jreq = JRequest(prompt, 12, eos_id=eos, speculative=True)
    _serve(_jax_engine(jm, params, num_slots=1, spec_k=6), [jreq])
    assert jreq.tokens == want


def test_spec_telemetry_stats_and_validation(models):
    _, _, tm = models
    for bad in (dict(spec_k=1), dict(spec_k=-2), dict(prefill_chunk=-1),
                dict(spec_k=4, spec_ngram=0), dict(prefill_cache_cap=0)):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    assert EngineConfig(spec_k=4).spec_k == 4
    assert EngineConfig(prefill_chunk=8).prefill_chunk == 8
    tel = Telemetry()
    records = []
    tel.emit = (lambda orig: lambda kind, step=0, **f: (
        records.append((kind, f)), orig(kind, step=step, **f)))(tel.emit)
    engine = DecodeEngine(tm, None, EngineConfig(**GEO, spec_k=6), tel,
                          device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        engine.validate(Request([1, 2], 4, speculative=True,
                                temperature=0.7))
    req = Request([5, 6, 7, 5, 6, 7], 10, speculative=True)
    engine.admit(req)
    engine.step()
    stats = engine.stats()
    assert stats["spec_k"] == 6 and stats["spec_rows"] == 1
    while engine.active_slots:
        engine.step()
    steps = [f for kind, f in records if kind == "serve_step"]
    assert sum(f["spec_accepted"] for f in steps) == len(req.tokens)
    assert all(f["spec_rows"] == 1 for f in steps)
    done = [f for kind, f in records if kind == "serve_request"]
    assert done[0]["speculative"] is True
    assert done[0]["spec_rounds"] == len(steps) == req.spec_rounds
    assert done[0]["spec_accepted_per_round"] == pytest.approx(
        len(req.tokens) / len(steps), abs=0.01)
    # An opt-in on an engine without the arm decodes plainly.
    plain = Request([5, 6, 7, 8], 8, speculative=True)
    _serve(_engine(tm), [plain])
    assert plain.tokens == _serve(_engine(tm), [Request([5, 6, 7, 8], 8)])[0]
    assert plain.spec_rounds == 0


def test_spec_request_over_http(models):
    _, _, tm = models
    prompt = [5, 6, 7, 5, 6, 7]
    want = _serve(_engine(tm), [Request(prompt, 10)])[0]
    server = ServingServer(_engine(tm, spec_k=6), FairScheduler(), port=0,
                           host="127.0.0.1", telemetry=Telemetry())
    server.start()
    try:
        client = ServeClient(f"http://127.0.0.1:{server.port}", timeout_s=60)
        out = client.generate(prompt, 10, speculative=True)
        assert out["tokens"] == prompt + want
        assert out["spec_rounds"] >= 1
        assert out["spec_accepted_per_round"] >= 1.0
        with pytest.raises(ValueError, match="greedy-only"):
            client.generate(prompt, 4, speculative=True, temperature=0.5)
    finally:
        server.shutdown()


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
