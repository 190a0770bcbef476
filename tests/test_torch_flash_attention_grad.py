"""Gradients of the port's flash attention and LayerNorm against the JAX
package's.

- ``flash_attention_backward_reference`` (the plain version the CPU takes)
  against ``_flash_backward``, the two Pallas backward kernels in
  interpret mode, called with the same forward output and logsumexp (the
  JAX forward's); and the autograd path (``flash_attention`` with
  ``requires_grad``, forward and backward on the port) against the same
  gradients.  Causal, key padding, sliding window, fully masked rows and
  non-causal, at S = 128 and 256, in f32 and bf16.
- LayerNorm gradients against ``jax.vjp`` of ``fused_layer_norm`` (its
  Pallas forward in interpret mode, the dense backward).

Inputs come from a seeded numpy generator.  The CUDA kernels are held
against the same plain versions on the card in test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.pallas import flash_attention as jfa
from distributed_tensorflow_tpu.ops.pallas.layer_norm import fused_layer_norm
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_tpu_torch.ops import layer_norm as tln

# f32: blockwise (JAX) and dense (port) sums differ in order; gradients of
# magnitude up to ~5 agree to a few fp32 ulps of the largest terms.
F32_TOL = 2e-4
# bf16 inputs: both sides compute in fp32 from the same bf16 values and
# round the gradients to bf16 once; rounding can land one bf16 ulp apart
# (2^-8 relative) at magnitudes up to ~4.
BF16_TOL = 3e-2

CASES = {
    "causal": dict(causal=True, window=0, mask=False, first_masked=0),
    "kv_mask": dict(causal=True, window=0, mask=True, first_masked=0),
    "window": dict(causal=True, window=24, mask=True, first_masked=0),
    # Causal rows 0..5 of batch 0 see no valid key.
    "fully_masked_rows": dict(causal=True, window=0, mask=True,
                              first_masked=6),
    "non_causal": dict(causal=False, window=0, mask=True, first_masked=0),
}


def _inputs(B, S, H, D, seed, case):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    mask = None
    if case["mask"]:
        mask = rng.random((B, S)) > 0.3
        mask[:, 0] = True
        mask[0, :case["first_masked"]] = False
    return q, k, v, g, mask


# Every case at S=128 in f32; each again at S=256, in f32 or bf16 (each
# interpret-mode call costs seconds, so the pairs are spread, not crossed).
SHAPES = [(c, 128, "float32") for c in sorted(CASES)] + [
    ("causal", 256, "float32"), ("window", 256, "float32"),
    ("non_causal", 256, "float32"), ("kv_mask", 256, "bfloat16"),
    ("fully_masked_rows", 256, "bfloat16")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores: keep torch's
    intra-op pool to one thread so these small ops do not oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case,S,dtype", SHAPES)
def test_flash_backward_matches_jax_kernels(case, S, dtype):
    c = CASES[case]
    B, H, D = 2, 2, 32
    q, k, v, g, mask = _inputs(B, S, H, D, seed=S, case=c)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v, g)]
    jmask = None if mask is None else jnp.asarray(mask)
    o, lse = jfa._flash_forward(*jx[:3], jmask, causal=c["causal"],
                                window=c["window"])
    want = jfa._flash_backward(*jx[:3], jmask, o, lse, jx[3],
                               causal=c["causal"], window=c["window"])
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tdt = getattr(torch, dtype)

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(
            jnp.float32))).to(tdt)

    tq, tk, tv, tg = (t(a) for a in jx)
    tmask = None if mask is None else torch.from_numpy(mask)
    ref = tfa.flash_attention_backward_reference(
        tq, tk, tv, tmask, t(o), torch.from_numpy(np.array(lse)[:, 0]),
        tg, causal=c["causal"], window=c["window"])

    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    out, _ = tfa.flash_attention(*leaves, tmask, causal=c["causal"],
                                 window=c["window"])
    auto = torch.autograd.grad(out, leaves, tg)

    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, w, r, a in zip("qkv", want, ref, auto):
        assert r.dtype == tdt and a.dtype == tdt
        np.testing.assert_allclose(r.float().numpy(), w, atol=tol, rtol=tol,
                                   err_msg=f"d{name} (reference)")
        np.testing.assert_allclose(a.float().numpy(), w, atol=tol, rtol=tol,
                                   err_msg=f"d{name} (autograd)")
    if c["first_masked"]:
        # JAX's oracle (test_flash_grad_fully_masked_row_is_zero_not_nan):
        # dq of a row with no valid key is exactly 0.
        assert not auto[0][0, :c["first_masked"]].any()


def test_flash_grad_fully_masked_row_is_zero_not_nan():
    B, S, H, D = 1, 16, 1, 8
    q, k, v, g, _ = _inputs(B, S, H, D, seed=3, case=CASES["causal"])
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[0, :4] = False                     # rows 0..3 see no valid key
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = tfa.flash_attention(*leaves, mask, causal=True)
    dq, dk, dv = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert (lse[0, :4] < -1e29).all()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[0, :4].any()
    # Masked keys receive no gradient either.
    assert not dk[0, :4].any() and not dv[0, :4].any()


@pytest.mark.parametrize("window", [0, 5])
def test_pallas_backend_grads_equal_xla_backend(window):
    """Through ``dot_product_attention`` the two backends are one function:
    the pallas autograd path gives the xla path's gradients (f32, only the
    order of fp32 sums differs)."""
    B, S, H, D = 2, 20, 2, 8
    q, k, v, g, _ = _inputs(B, S, H, D, seed=5, case=CASES["causal"])
    grads = []
    for backend in ("pallas", "xla"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tattn.dot_product_attention(*leaves, causal=True,
                                          window=window, backend=backend)
        grads.append(torch.autograd.grad(out, leaves, torch.from_numpy(g)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,dtype", [((4, 16, 128), "float32"),
                                         ((2, 7, 96), "bfloat16")])
def test_layer_norm_grads_match_jax_vjp(shape, dtype):
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(shape[-1]).astype(np.float32)
                   for _ in range(2))
    g = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    out, vjp = jax.vjp(fused_layer_norm, jx, jnp.asarray(scale),
                       jnp.asarray(bias))
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g))]

    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    got_out = tln.layer_norm(tx, ts, tb)
    got = torch.autograd.grad(got_out, (tx, ts, tb), torch.from_numpy(g))
    assert got[0].dtype == tx.dtype
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    # fp32 statistics on both sides; dx in the input dtype (one bf16 ulp
    # at magnitudes up to ~2), dscale/dbias fp32 sums over the rows.
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.float().numpy(), w, atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("op", ["flash_attention", "layer_norm"])
def test_wrapper_records_a_node_only_when_a_gradient_is_wanted(op):
    """Without a gradient to record (serving runs under ``no_grad``) the
    wrappers run the forward bare; with one they go through the autograd
    Function.  Both give the same values."""
    q, k, v, _, _ = _inputs(1, 12, 2, 8, seed=7, case=CASES["causal"])
    if op == "flash_attention":
        args = [torch.from_numpy(a) for a in (q, k, v)]

        def run(*a):
            return tfa.flash_attention(*a, causal=True)[0]
    else:
        args = [torch.from_numpy(q[0, :, 0]), torch.from_numpy(k[0, 0, 0]),
                torch.from_numpy(v[0, 0, 0])]

        def run(*a):
            return tln.layer_norm(*a)
    bare = run(*args)
    with torch.no_grad():
        off = run(args[0], args[1].requires_grad_(), args[2])
    tracked = run(*args)
    assert bare.grad_fn is None and off.grad_fn is None
    assert tracked.grad_fn is not None
    torch.testing.assert_close(tracked.detach(), bare, atol=0, rtol=0)
    torch.testing.assert_close(off, bare, atol=0, rtol=0)
