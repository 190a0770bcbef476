"""The ring's chunk functions of the port (distributed_tensorflow_tpu_torch/
ops/flash_attention.py: flash_attention_chunk, _dq, _dkv, which take
their plain versions on CPU tensors) against the JAX package's Pallas
chunk kernels (K6 _chunk_kernel, K7 _chunk_dq_kernel / _chunk_dkv_kernel)
in interpret mode: a chunk in the past, on the diagonal and wholly in the
future, a padding mask with fully masked rows, a sliding window, and
non-causal attention.  Small shapes; inputs from a seeded numpy
generator, fed to both sides.

Tolerance: both sides compute in fp32 from the same inputs (bf16 inputs
are widened exactly), scale q before the product and take the same
masked online-softmax step; only the order of fp32 sums differs, so
every output agrees to 1e-5 (absolute and relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.pallas import flash_attention as jfa
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

B, S, H, D = 2, 32, 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (q_offset, k_offset, causal, window, masked): S = 32 per chunk.
CASES = {
    "past": (64, 0, True, 0, False),
    "diagonal": (32, 32, True, 0, False),
    "future": (0, 64, True, 0, False),
    "masked_rows": (32, 32, True, 0, True),
    "window": (64, 32, True, 20, False),
    "non_causal": (0, 64, False, 0, True),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int, masked: bool):
    """q, k, v, do [B, S, H, D]; a carry in flight (m, l, acc); the key
    mask (batch 0's first 8 keys masked: on the causal diagonal its rows
    0..7 see no key, and their carries are still neutral)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v, do = (f(B, S, H, D) for _ in range(4))
    m, acc = f(B, H, S), f(B, H, S, D)
    l = 1 + rng.random((B, H, S)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, S)) > 0.3
        mask[0, :8] = False
        m[0, :, :8], l[0, :, :8], acc[0, :, :8] = -1e30, 0.0, 0.0
    return q, k, v, do, m, l, acc, mask


def _both(arrays, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _check(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name,
                               **TOL)


@pytest.mark.parametrize("dtype,case", [("float32", c) for c in sorted(CASES)]
                         + [("bfloat16", "diagonal")])
def test_chunk_functions_match_pallas_chunk_kernels(dtype, case):
    q_off, k_off, causal, window, masked = CASES[case]
    q, k, v, do, m, l, acc, mask = _inputs(sorted(CASES).index(case),
                                           masked)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both([q, k, v, do], dtype)
    jm, jl, jacc = (jnp.asarray(a) for a in (m, l, acc))
    tm, tl, tacc = (torch.from_numpy(a) for a in (m, l, acc))
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, window=window)

    launches = tfa.chunk_launches
    got = tfa.flash_attention_chunk(tq, tk, tv, tmask, tm, tl, tacc, **kw)
    assert tfa.chunk_launches == launches        # CPU: the plain version
    want = jfa.flash_attention_chunk(jq, jk, jv, jmask, jm, jl, jacc, **kw)
    for name, a, b in zip(("m", "l", "acc"), got, want):
        assert a.dtype == torch.float32
        _check(a, b, name)
    if case == "future":                          # every pair acausal
        for a, b in zip(got, (tm, tl, tacc)):
            assert torch.equal(a, b)
    if case == "masked_rows":                     # nothing seen yet
        assert (got[0][0, :, :8] == -1e30).all()
        assert not got[1][0, :, :8].any() and not got[2][0, :, :8].any()

    # The backward partials from the finished state's lse and a delta.
    lse = want[0] + jnp.log(jnp.maximum(want[1], 1e-30))
    delta = np.random.default_rng(7).standard_normal(
        (B, H, S)).astype(np.float32)
    tlse, tdelta = torch.from_numpy(np.array(lse)), torch.from_numpy(delta)
    dq = tfa.flash_attention_chunk_dq(tq, tk, tv, tmask, tdo, tlse, tdelta,
                                      **kw)
    dk, dv = tfa.flash_attention_chunk_dkv(tq, tk, tv, tmask, tdo, tlse,
                                           tdelta, **kw)
    want_dq = jfa.flash_attention_chunk_dq(jq, jk, jv, jmask, jdo, lse,
                                           jnp.asarray(delta), **kw)
    want_dk, want_dv = jfa.flash_attention_chunk_dkv(
        jq, jk, jv, jmask, jdo, lse, jnp.asarray(delta), **kw)
    for name, a, b in (("dq", dq, want_dq), ("dk", dk, want_dk),
                       ("dv", dv, want_dv)):
        assert a.dtype == torch.float32 and a.shape == (B, H, S, D)
        _check(a, b, name)
    if case == "future":
        assert not dq.any() and not dk.any() and not dv.any()
    if case == "masked_rows":                     # exact zeros
        assert not dq[0, :, :8].any()


def test_chunk_valid_is_the_global_band():
    """Query q_offset + i sees key k_offset + j iff the key is not padding,
    not in the future and, with a window, within it."""
    mask = torch.tensor([[1, 0, 1, 1]])
    v = tfa.chunk_valid(1, 3, 4, mask, q_offset=5, k_offset=3, causal=True,
                        window=2, device="cpu")[0, 0]
    qp, kp = torch.arange(5, 8)[:, None], torch.arange(3, 7)[None, :]
    want = (mask[0] != 0) & (qp >= kp) & (qp - kp < 2)
    assert torch.equal(v, want)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention_chunk(*(torch.zeros(1, 2, 1, 64),) * 3, None,
                                  torch.zeros(1, 1, 2), torch.zeros(1, 1, 2),
                                  torch.zeros(1, 1, 2, 64), q_offset=0,
                                  k_offset=0, window=2)
