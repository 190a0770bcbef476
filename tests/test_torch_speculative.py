"""The port's speculative decoding (distributed_tensorflow_tpu_torch/models/
gpt.py: ``generate_cached_speculative``, the host loop, and
``generate_cached_speculative_device``, the device loop) and the device
drafter (models/drafting.py: ``ngram_hash`` on tensors, ``index_build2``,
``index_update2``, ``index_draft``, ``tail_gram``) against the JAX
package's: tokens and ``stats`` of each loop equal to JAX's on the same
weights and prompts (one JAX build per loop), the drafter's tables and
drafts bit-equal; and the invariants of the JAX package's
test_speculative.py (every case that passes on the reference; its
trained-model fixtures become seeded random weights, whose greedy streams
fall into cycles the drafter follows) and test_drafting.py.  Small f32
models; prompts from seeded numpy generators."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import drafting as jd
from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu_torch.models import drafting as td
from distributed_tensorflow_tpu_torch.models import gpt as tgpt

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position=128, dtype="float32",
             pos_encoding="rope")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model(seed):
    jm = jgpt.GptLM(jgpt.GptConfig(**SMALL))
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    return jm, params


def _models(seed=0):
    jm, params = _jax_model(seed)
    tm = tgpt.GptLM(tgpt.GptConfig(**SMALL), device="cpu")
    tm.load_state_dict(tgpt.params_from_jax(params))
    return jm, params, tm


def _phrase_prompts(seed, P=24):
    """Two rows repeating a seeded 7-token phrase (offset by 3 in row 1):
    the drafter finds continuations from the first round."""
    phrase = np.random.default_rng(seed).integers(0, 64, 7)
    return np.stack([np.resize(phrase, P),
                     np.resize(phrase[3:], P)]).astype(np.int32)


def _random_prompts(seed, P=16):
    return np.random.default_rng(seed).integers(0, 64, (2, P)).astype(
        np.int32)


def _stream(seed, length, vocab=24, period=None):
    rng = np.random.default_rng(seed)
    if period:
        row = np.resize(rng.integers(0, vocab, period), length)
        noise = rng.random(length) < 0.05
        row = np.where(noise, rng.integers(0, vocab, length), row)
    else:
        row = rng.integers(0, vocab, length)
    return row.astype(np.int32)


# ------------------------------------------------------------ the loops


def test_host_loop_tokens_and_stats_match_jax():
    """One host-loop run through drafting rounds, the fallback (4 rounds
    under 4 tokens a row) and an eos that fires after it: tokens and every
    stat equal JAX's, and the tokens are plain greedy's."""
    jm, params, tm = _models()
    prompt = _random_prompts(3, P=12)
    free = tgpt.generate_cached(tm, None, prompt, 30).numpy()
    eos = int(free[0, 12 + 20])
    kw = dict(spec_k=8, eos_id=eos, fallback_rounds=2, fallback_accept=4.0)
    want, want_stats = jgpt.generate_cached_speculative(
        jm, params, jnp.asarray(prompt), 30, **kw)
    got, stats = tgpt.generate_cached_speculative(tm, None, prompt, 30,
                                                  **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == want_stats and stats["fallback_at_round"] == 2
    plain = tgpt.generate_cached(tm, None, prompt, 30, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_device_loop_tokens_and_stats_match_jax():
    """Tree rounds (spec_k 8, a 2-node branch), small rounds and probes on
    cyclic greedy text: tokens and stats equal JAX's, branch hits
    included, and the tokens are plain greedy's."""
    jm, params, tm = _models()
    prompt = _phrase_prompts(0)
    want, want_stats = jgpt.generate_cached_speculative_device(
        jm, params, jnp.asarray(prompt), 40, spec_k=8, adapt_threshold=3.0,
        probe_every=4)
    got, stats = tgpt.generate_cached_speculative_device(
        tm, None, prompt, 40, spec_k=8, adapt_threshold=3.0, probe_every=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == want_stats
    assert stats["branch_hits"] > 0 and stats["rounds_small"] > 0
    assert stats["mean_accepted_per_round"] > 2.0          # B = 2 rows
    plain = tgpt.generate_cached(tm, None, prompt, 40)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_host_loop_equals_plain_greedy():
    """test_speculative.py:109-154, 186-256: plain greedy tokens with and
    without eos, under int8 weights and a bf16 cache, after the fallback,
    and with the fallback off; the default thresholds do not fall back
    where rows accept bursts."""
    _, _, tm = _models()
    prompt = _phrase_prompts(1)
    plain = tgpt.generate_cached(tm, None, prompt, 20)
    spec, stats = tgpt.generate_cached_speculative(tm, None, prompt, 20,
                                                   spec_k=5)
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())
    assert stats["tokens_generated"] == 2 * 20 and stats["rounds"] >= 1
    eos = int(plain[0, 24 + 5])
    spec, _ = tgpt.generate_cached_speculative(tm, None, prompt, 20,
                                               spec_k=4, eos_id=eos)
    np.testing.assert_array_equal(
        spec.numpy(),
        tgpt.generate_cached(tm, None, prompt, 20, eos_id=eos).numpy())
    arm = dict(quantize="int8", kv_dtype="bfloat16")
    spec, _ = tgpt.generate_cached_speculative(tm, None, prompt, 12,
                                               spec_k=4, **arm)
    np.testing.assert_array_equal(
        spec.numpy(), tgpt.generate_cached(tm, None, prompt, 12,
                                           **arm).numpy())
    rand = _random_prompts(7)
    spec, stats = tgpt.generate_cached_speculative(
        tm, None, rand, 40, spec_k=8, fallback_rounds=4, fallback_accept=4.0)
    assert stats["fallback_at_round"] == 4
    np.testing.assert_array_equal(
        spec.numpy(), tgpt.generate_cached(tm, None, rand, 40).numpy())
    _, stats = tgpt.generate_cached_speculative(
        tm, None, rand, 16, spec_k=4, fallback_rounds=0,
        fallback_accept=100.0)
    assert stats["fallback_at_round"] is None
    _, stats = tgpt.generate_cached_speculative(tm, None, _phrase_prompts(4),
                                                32, spec_k=8)
    assert stats["fallback_at_round"] is None, stats
    assert stats["mean_accepted_per_round"] / 2 > 1.5, stats


def test_device_loop_equals_plain_greedy():
    """test_speculative.py:259-289, 391-457: plain greedy tokens on
    repetitive and random text, with eos, under the int8 / float8 arms;
    adaptive K spends rounds in the small body on random text with probes
    at least every probe_every rounds; adaptive off runs full rounds
    only; the host and the device loops accept alike from one drafter."""
    _, _, tm = _models()
    for prompt, n in ((_phrase_prompts(2), 24), (_random_prompts(11), 20)):
        spec, stats = tgpt.generate_cached_speculative_device(
            tm, None, prompt, n, spec_k=4)
        np.testing.assert_array_equal(
            spec.numpy(), tgpt.generate_cached(tm, None, prompt, n).numpy())
        assert stats["tokens_generated"] == 2 * n and stats["rounds"] >= 1
    prompt = _phrase_prompts(3)
    free = tgpt.generate_cached(tm, None, prompt, 24).numpy()
    eos = int(free[0, 24 + 5])
    spec, _ = tgpt.generate_cached_speculative_device(tm, None, prompt, 24,
                                                      spec_k=4, eos_id=eos)
    np.testing.assert_array_equal(
        spec.numpy(),
        tgpt.generate_cached(tm, None, prompt, 24, eos_id=eos).numpy())
    for arm in (dict(quantize="int8"), dict(kv_dtype="float8"),
                dict(quantize="int8", kv_dtype="float8")):
        spec, stats = tgpt.generate_cached_speculative_device(
            tm, None, prompt, 20, spec_k=6, spec_branch=2, **arm)
        np.testing.assert_array_equal(
            spec.numpy(),
            tgpt.generate_cached(tm, None, prompt, 20, **arm).numpy(),
            err_msg=str(arm))
        assert stats["tokens_generated"] == 2 * 20
    rand = _random_prompts(13)
    spec, stats = tgpt.generate_cached_speculative_device(
        tm, None, rand, 40, spec_k=8, adapt_threshold=3.0, probe_every=8)
    np.testing.assert_array_equal(
        spec.numpy(), tgpt.generate_cached(tm, None, rand, 40).numpy())
    assert stats["rounds_small"] > 0, stats
    assert stats["rounds_small"] + stats["rounds_full"] == stats["rounds"]
    assert stats["rounds_full"] >= stats["rounds"] // 8
    _, stats = tgpt.generate_cached_speculative_device(
        tm, None, prompt, 16, spec_k=4, adaptive=False)
    assert stats["rounds_small"] == 0
    assert stats["rounds_full"] == stats["rounds"]
    prompt = _phrase_prompts(4)
    _, hstats = tgpt.generate_cached_speculative(tm, None, prompt, 32,
                                                 spec_k=8)
    _, dstats = tgpt.generate_cached_speculative_device(
        tm, None, prompt, 32, spec_k=8, spec_branch=0, adaptive=False)
    assert abs(hstats["mean_accepted_per_round"]
               - dstats["mean_accepted_per_round"]) < 1.0, (hstats, dstats)


def test_speculative_validation():
    _, _, tm = _models()
    prompt = _random_prompts(0, P=8)
    for fn in (tgpt.generate_cached_speculative,
               tgpt.generate_cached_speculative_device):
        with pytest.raises(ValueError, match="spec_k"):
            fn(tm, None, prompt, 8, spec_k=1)
        with pytest.raises(ValueError, match="num_tokens"):
            fn(tm, None, prompt, 0, spec_k=4)
    for kw, match in ((dict(ngram=0), "ngram"), (dict(probe_every=0),
                                                 "probe_every"),
                      (dict(spec_branch=-1), "spec_branch")):
        with pytest.raises(ValueError, match=match):
            tgpt.generate_cached_speculative_device(tm, None, prompt, 8,
                                                    **kw)
    windowed = tgpt.GptLM(tgpt.GptConfig(**{**SMALL, "attention_window": 8}),
                          device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tgpt.generate_cached_speculative(windowed, None, prompt, 8,
                                         spec_k=4)


# ------------------------------------------------------ the device drafter


def test_tensor_hash_equals_numpy_bucket_for_bucket():
    """Tokens up to 2^31 - 1 (the uint32 wraparound at every step) and
    several table sizes."""
    rng = np.random.default_rng(0)
    grams = np.concatenate([rng.integers(0, 64, (64, 3)),
                            rng.integers(0, 2 ** 31 - 1, (64, 3))])
    for size in (td.TABLE_SIZE, 2, 97):
        got = td.ngram_hash(torch.from_numpy(grams), size)
        assert got.dtype == torch.long
        np.testing.assert_array_equal(got.numpy(),
                                      jd.ngram_hash(grams, size))
        np.testing.assert_array_equal(got.numpy(),
                                      td.ngram_hash(grams, size))


@pytest.mark.parametrize("table_size", [td.TABLE_SIZE, 3])
def test_device_index_build_update_draft_match_jax(table_size):
    """The same streams (two rows at different lengths) built, updated in
    uneven spans and drafted from on both sides: tables, tail grams and
    drafts (newest and previous match) bit-equal.  A 3-bucket table makes
    grams of one span share a bucket, where the order of the inserts
    decides ``prev``."""
    n, total = 3, 96
    toks = np.stack([_stream(1, total, vocab=8, period=11),
                     _stream(2, total, vocab=8, period=7)])
    lens = np.array([30, 24], np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    build = jax.jit(lambda t, ln: jd.index_build2(
        t, ln, n=n, table_size=table_size, max_len=30))
    update = jax.jit(lambda last, prev, t, a, b: jd.index_update2(
        last, prev, t, a, b, n=n, span=7))
    draft = jax.jit(lambda index, t, eff: jd.index_draft(
        index, t, jd.tail_gram(t, eff, n=n), eff, n=n, k=5))
    tail = jax.jit(lambda t, eff: jd.tail_gram(t, eff, n=n))
    jtab = build(jt, jnp.asarray(lens))
    ttab = td.index_build2(tt, torch.from_numpy(lens).long(), n=n,
                           table_size=table_size, max_len=30)
    rng = np.random.default_rng(3)
    while lens.max() < total - 8:
        for got, want in zip(ttab, jtab):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        eff = lens + 1
        np.testing.assert_array_equal(
            td.tail_gram(tt, torch.from_numpy(eff).long(), n=n).numpy(),
            np.asarray(tail(jt, jnp.asarray(eff))))
        for got_t, want_t in zip(ttab, jtab):
            np.testing.assert_array_equal(
                td.index_draft(got_t, tt, td.tail_gram(
                    tt, torch.from_numpy(eff).long(), n=n),
                    torch.from_numpy(eff).long(), n=n, k=5).numpy(),
                np.asarray(draft(want_t, jt, jnp.asarray(eff))))
        new = lens + rng.integers(1, 8, 2).astype(np.int32)
        jtab = update(*jtab, jt, jnp.asarray(lens), jnp.asarray(new))
        ttab = td.index_update2(*ttab, tt, torch.from_numpy(lens).long(),
                                torch.from_numpy(new).long(), n=n, span=7)
        lens = new


def test_device_tables_equal_the_host_index_and_a_rebuild():
    """test_drafting.py:63, :96: a build over the whole row equals the host
    index's tables; incremental updates equal a full rebuild."""
    n, total = 3, 200
    row = _stream(11, total, period=19)
    host = td.NGramIndex(n)
    host.update(row, total)
    toks = torch.from_numpy(row[None, :]).long()
    last, prev = td.index_build2(toks, torch.tensor([total]), n=n)
    np.testing.assert_array_equal(last[0].numpy(), host.table)
    np.testing.assert_array_equal(prev[0].numpy(), host.prev)
    inc = td.index_build2(toks, torch.tensor([50]), n=n, max_len=50)
    at = 50
    while at < total:
        nxt = min(at + 7, total)
        inc = td.index_update2(*inc, toks, torch.tensor([at]),
                               torch.tensor([nxt]), n=n, span=7)
        at = nxt
    for got, want in zip(inc, (last, prev)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_device_drafts_prev_virtual_tail_and_short_rows():
    """test_drafting.py:112-183: ``last`` proposes the newest match and
    ``prev`` the one before; a virtual tail drafts the host's
    continuation; rows shorter than the gram propose nothing."""
    n, k = 2, 3
    row = np.asarray([7, 8, 1, 7, 8, 2, 7, 8], np.int32)
    toks = torch.from_numpy(row[None, :]).long()
    last, prev = td.index_build2(toks, torch.tensor([6]), n=n, max_len=6)
    eff, tail = torch.tensor([8]), torch.tensor([[7, 8]])
    assert td.index_draft(last, toks, tail, eff, n=n, k=k)[0].tolist() == \
        [2, 7, 8]
    assert td.index_draft(prev, toks, tail, eff, n=n, k=k)[0].tolist() == \
        [1, 7, 8]
    n, k = 3, 4
    row = np.asarray(list(range(10)) * 3, np.int32)
    host = td.NGramIndex(n)
    host.update(row, 28)
    want = host.draft(row, len(row), k, tail=np.asarray([7, 8, 9]))
    np.testing.assert_array_equal(want, [0, 1, 2, 3])
    toks = torch.from_numpy(row[None, :]).long()
    last, _ = td.index_build2(toks, torch.tensor([28]), n=n, max_len=28)
    got = td.index_draft(last, toks, torch.tensor([[7, 8, 9]]),
                         torch.tensor([len(row)]), n=n, k=k)
    np.testing.assert_array_equal(got[0].numpy(), want)
    toks = torch.tensor([[1, 2]])
    last, _ = td.index_build2(toks, torch.tensor([2]), n=4)
    eff = torch.tensor([2])
    got = td.index_draft(last, toks, td.tail_gram(toks, eff, n=4), eff,
                         n=4, k=3)
    assert not got.any()
