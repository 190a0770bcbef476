"""The port's cached decode bodies (distributed_tensorflow_tpu_torch/models/
gpt.py: ``GptBlock.decode_step``, ``decode_step_ragged`` and
``decode_chunk``, ``GptLM.decode_step``, ``decode_ragged`` and
``decode_chunk``, ``write_rows``, ``spec_tree``, ``fixup_tree_caches``)
against the JAX package's on the same weights and inputs: logits and caches
after a prefill, one step, one ragged step and one chunk (linear and
tree), the windowed ring cache, writes past the cache end dropped, the
float8 round trip and the tree compaction.  Small f32 models; inputs from
seeded numpy generators; the JAX side's Pallas kernels run in interpret
mode on the CPU."""

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
# MHA (through the pallas attention and the fused LayerNorm), GQA with
# rope, swiglu/rmsnorm, and the windowed ring cache.
VARIANTS = {
    "mha_pallas_fused_ln": dict(attention_backend="pallas", fused_ln=True),
    "gqa_rope": dict(kv_heads=1, pos_encoding="rope"),
    "swiglu_rmsnorm": dict(activation="swiglu", norm="rmsnorm"),
    "window": dict(attention_window=4, pos_encoding="rope"),
}
B, P, M = 2, 6, 12


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


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def _apply(jm, params, method, *args):
    return jm.apply({"params": params}, *args, method=method)


def _assert_close(got, want):
    logits, caches = got
    w_logits, w_caches = want
    np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits),
                               atol=TOL, rtol=TOL)
    for (gk, gv), (wk, wv) in zip(caches, w_caches):
        np.testing.assert_allclose(gk.float().numpy(),
                                   np.asarray(wk, np.float32), atol=TOL)
        np.testing.assert_allclose(gv.float().numpy(),
                                   np.asarray(wv, np.float32), atol=TOL)


def _copy(caches):
    return [tuple(t.clone() for t in pair) for pair in caches]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_step_ragged_and_chunk_match_jax(variant):
    """After a prefill: one step at position P, one ragged step at per-row
    positions P+1 / P+3 (row 1 skipping slots), then, on full-length
    caches, a linear and a tree chunk from per-row frontiers where row 1's
    chunk runs past the cache end (its writes there drop; the last slot
    takes its real write).  The JAX side is one jitted program."""
    jm, params, tm = _models(variant)
    windowed = bool(VARIANTS[variant].get("attention_window"))
    prompt, token, chunk = _ids(1, (B, P)), _ids(2, (B,)), _ids(3, (B, 4))
    positions = np.array([P + 1, P + 3], np.int32)
    # Row 0 at 7..10; row 1 at 9..12 against M = 12: slot 12 drops and
    # slot 11 holds row 1's third chunk token.
    starts = np.array([7, 9], np.int32)
    depths, anc, _, _ = tgpt.spec_tree(4, 1)

    @jax.jit
    def reference(params, prompt, token, positions, chunk, starts, depths,
                  anc):
        caches = jgpt.init_kv_cache(jm.cfg, B, M)
        _, caches = _apply(jm, params, jgpt.GptLM.prefill, prompt, caches)
        step = _apply(jm, params, jgpt.GptLM.decode_step, token, caches,
                      jnp.int32(P))
        ragged = _apply(jm, params, jgpt.GptLM.decode_ragged, token,
                        step[1], positions)
        if windowed:
            return step, ragged
        linear = _apply(jm, params, jgpt.GptLM.decode_chunk, chunk,
                        ragged[1], starts)
        tree = _apply(jm, params, jgpt.GptLM.decode_chunk, chunk, ragged[1],
                      starts, depths, anc)
        return step, ragged, linear, tree

    want = reference(params, *(jnp.asarray(a) for a in (
        prompt, token, positions, chunk, starts, depths, anc)))
    caches = tgpt.init_kv_cache(tm.cfg, B, M, device="cpu")
    if windowed:
        assert caches[0][0].shape[1] == 4          # a ring of window rows
    tm.prefill(torch.from_numpy(prompt).long(), caches)
    token = torch.from_numpy(token).long()
    step = tm.decode_step(token, caches, P)
    _assert_close((step[0], _copy(step[1])), want[0])
    ragged = tm.decode_ragged(token, caches,
                              torch.from_numpy(positions).long())
    _assert_close(ragged, want[1])
    chunk = torch.from_numpy(chunk).long()
    starts = torch.from_numpy(starts).long()
    if windowed:
        with pytest.raises(ValueError, match="full-length"):
            tm.decode_chunk(chunk, caches, starts)
        return
    _assert_close(tm.decode_chunk(chunk, _copy(caches), starts), want[2])
    _assert_close(tm.decode_chunk(chunk, caches, starts,
                                  torch.from_numpy(depths).long(),
                                  torch.from_numpy(anc)), want[3])


def test_window_ring_cache_wraps_like_jax():
    """Prompt (6) longer than the window (4), then steps that wrap the
    ring twice; and a longer cache than the window is refused."""
    jm, params, tm = _models("window")
    prompt, tokens = _ids(4, (B, P)), _ids(5, (8, B))

    @jax.jit
    def reference(params, prompt, tokens):
        caches = jgpt.init_kv_cache(jm.cfg, B, M)
        _, caches = _apply(jm, params, jgpt.GptLM.prefill, prompt, caches)

        def step(caches, xs):
            logits, caches = _apply(jm, params, jgpt.GptLM.decode_step,
                                    *xs[:1], caches, xs[1])
            return caches, (logits, caches)
        return jax.lax.scan(step, caches, (tokens, P + jnp.arange(
            len(tokens), dtype=jnp.int32)))[1]

    logits, caches_per_step = reference(params, jnp.asarray(prompt),
                                        jnp.asarray(tokens))
    caches = tgpt.init_kv_cache(tm.cfg, B, M, device="cpu")
    tm.prefill(torch.from_numpy(prompt).long(), caches)
    for i, token in enumerate(tokens):
        got = tm.decode_step(torch.from_numpy(token).long(), caches, P + i)
        _assert_close(got, (logits[i], jax.tree.map(lambda c: c[i],
                                                    caches_per_step)))
    wide = [(torch.zeros(B, 8, 2, 16), torch.zeros(B, 8, 2, 16))] * 2
    with pytest.raises(ValueError, match="attention_window"):
        tm.decode_step(torch.zeros(B, dtype=torch.long), wide, 0)


def test_chunk_equals_sequential_steps():
    """One chunk gives the logits and caches of K sequential steps (JAX's
    test_speculative.py:36), per-row frontiers included (:68)."""
    _, _, tm = _models("gqa_rope")
    prompt = torch.from_numpy(_ids(6, (B, 9))).long()
    chunk = torch.from_numpy(_ids(7, (B, 3))).long()
    starts = [6, 9]
    caches = tgpt.init_kv_cache(tm.cfg, B, 16, device="cpu")
    tm.prefill(prompt, caches)
    out, _ = tm.decode_chunk(chunk, caches, torch.tensor(starts))
    for b, s in enumerate(starts):
        ref = tgpt.init_kv_cache(tm.cfg, 1, 16, device="cpu")
        tm.prefill(prompt[b:b + 1, :s], ref)
        for i in range(3):
            logits, _ = tm.decode_step(chunk[b:b + 1, i], ref, s + i)
            torch.testing.assert_close(out[b, i], logits[0], atol=2e-5,
                                       rtol=2e-5)
        for (k, v), (rk, rv) in zip(caches, ref):
            torch.testing.assert_close(k[b, :s + 3], rk[0, :s + 3],
                                       atol=1e-6, rtol=1e-6)


def test_float8_cache_round_trip_matches_jax():
    """Steps and chunks write float8 caches and attend the float8 values
    (the chunk's fresh K/V are rounded before the intra-chunk attention),
    as in JAX."""
    jm, params, tm = _models("swiglu_rmsnorm")
    prompt, token, chunk = _ids(8, (B, P)), _ids(9, (B,)), _ids(10, (B, 3))
    starts = np.array([P + 1, 10], np.int32)

    @jax.jit
    def reference(params, prompt, token, chunk, starts):
        caches = jgpt.init_kv_cache(jm.cfg, B, M, dtype=jnp.float8_e4m3fn)
        _, caches = _apply(jm, params, jgpt.GptLM.prefill, prompt, caches)
        step = _apply(jm, params, jgpt.GptLM.decode_step, token, caches,
                      jnp.int32(P))
        return step, _apply(jm, params, jgpt.GptLM.decode_chunk, chunk,
                            step[1], starts)

    want = reference(params, *(jnp.asarray(a) for a in (prompt, token,
                                                         chunk, starts)))
    caches = tgpt.init_kv_cache(tm.cfg, B, M, dtype=torch.float8_e4m3fn,
                                device="cpu")
    tm.prefill(torch.from_numpy(prompt).long(), caches)
    step = tm.decode_step(torch.from_numpy(token).long(), caches, P)
    _assert_close((step[0], _copy(step[1])), want[0])
    got = tm.decode_chunk(torch.from_numpy(chunk).long(), caches,
                          torch.from_numpy(starts).long())
    assert got[1][0][0].dtype == torch.float8_e4m3fn
    _assert_close(got, want[1])


@pytest.mark.parametrize("K,M_", [(4, 12), (5, 3)])
def test_write_rows_drops_writes_past_the_end(K, M_):
    """Every row's in-range writes land, masked and out-of-range ones do
    not, and no other slot changes; the last slot takes its real write
    while a later column of the same row falls past the end."""
    rng = np.random.default_rng(K)
    dst = torch.from_numpy(rng.standard_normal((4, M_, 2)))
    src = torch.from_numpy(rng.standard_normal((4, K, 2)))
    start = torch.tensor([0, M_ - 2, M_, 1])
    mask = torch.from_numpy(rng.random((4, K)) < 0.7)
    mask[1] = True
    want = dst.clone()
    for b in range(4):
        for i in range(K):
            s = int(start[b]) + i
            if mask[b, i] and s < M_:
                want[b, s] = src[b, i]
    tgpt.write_rows(dst, start, src, mask)
    torch.testing.assert_close(dst, want, atol=0, rtol=0)
    if M_ >= 2:
        torch.testing.assert_close(dst[1, M_ - 1], src[1, 1], atol=0,
                                   rtol=0)


def test_spec_tree_matches_jax():
    for k, br in ((6, 2), (8, 2), (4, 0), (5, 3), (2, 0)):
        for got, want in zip(tgpt.spec_tree(k, br), jgpt.spec_tree(k, br)):
            np.testing.assert_array_equal(got, want)
    depths, anc, parent, path = tgpt.spec_tree(6, 2)
    assert depths.tolist() == [0, 1, 2, 3, 1, 2]
    assert parent.tolist() == [-1, 0, 1, 2, 0, 4]
    assert np.flatnonzero(anc[5]).tolist() == [0, 4, 5]
    assert path[5, :3].tolist() == [0, 4, 5]
    with pytest.raises(ValueError, match="main chain"):
        tgpt.spec_tree(4, 3)


def test_fixup_tree_caches_matches_jax():
    """Random caches, the branch path of a 6-node tree accepted in row 0,
    the main chain in row 1 (identity), nothing in row 2 and a path whose
    slots run past the cache end in row 3."""
    rng = np.random.default_rng(11)
    caches = [tuple(rng.standard_normal((4, 10, 2, 3)).astype(np.float32)
                    for _ in range(2)) for _ in range(2)]
    _, _, _, path = tgpt.spec_tree(6, 2)
    sel = np.maximum(np.stack([path[5], path[3], path[0], path[5]]), 0)
    positions = np.array([2, 1, 4, 8], np.int32)
    accept = np.array([3, 4, 0, 3], np.int32)
    want = jax.jit(jgpt.fixup_tree_caches)(
        [tuple(jnp.asarray(c) for c in p) for p in caches],
        jnp.asarray(positions), jnp.asarray(sel), jnp.asarray(accept))
    got = tgpt.fixup_tree_caches(
        [tuple(torch.from_numpy(c.copy()) for c in p) for p in caches],
        torch.from_numpy(positions).long(), torch.from_numpy(sel).long(),
        torch.from_numpy(accept).long())
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_tree_chunk_nodes_equal_sequential_paths_and_fixup_compacts():
    """Each tree node's logits equal a sequential decode of its root path,
    and after accepting the branch path the compacted caches equal that
    path's sequential decode (JAX's test_speculative.py:316, :351)."""
    _, _, tm = _models("gqa_rope")
    prompt = torch.from_numpy(_ids(12, (1, P))).long()
    depths, anc, _, path = tgpt.spec_tree(6, 2)
    chunk = torch.from_numpy(_ids(13, (1, 6))).long()
    caches = tgpt.init_kv_cache(tm.cfg, 1, 16, device="cpu")
    tm.prefill(prompt, caches)
    logits, _ = tm.decode_chunk(chunk, caches, torch.tensor([P]),
                                torch.from_numpy(depths).long(),
                                torch.from_numpy(anc))
    for leaf in (3, 5):
        ref = tgpt.init_kv_cache(tm.cfg, 1, 16, device="cpu")
        tm.prefill(prompt, ref)
        for d in range(int(depths[leaf]) + 1):
            node = int(path[leaf, d])
            want, _ = tm.decode_step(chunk[:, node], ref, P + d)
            torch.testing.assert_close(logits[:, node], want, atol=2e-5,
                                       rtol=2e-5)
    sel = torch.from_numpy(np.maximum(path[5], 0))[None].long()
    tgpt.fixup_tree_caches(caches, torch.tensor([P]), sel,
                           torch.tensor([3]))
    for (k, v), (rk, rv) in zip(caches, ref):
        torch.testing.assert_close(k[:, :P + 3], rk[:, :P + 3], atol=2e-5,
                                   rtol=2e-5)
        torch.testing.assert_close(v[:, :P + 3], rv[:, :P + 3], atol=2e-5,
                                   rtol=2e-5)
