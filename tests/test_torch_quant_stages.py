"""K4, K5 and K8 as two stages: the port's quantize pass (kernel A's plain
version, ``quantize_blocks_reference``) against the JAX package's
``_quant_block``, and the quantize pass composed with the block-scaled
GEMM (kernel B's plain version, ``blocked_gemm_reference``) against the
monolithic plain versions and the Pallas kernels in interpret mode.
Small shapes on the CPU, inputs from seeded numpy generators.

Tolerances.  The quantize stage and ``_quant_block`` divide by the same
IEEE scale and round half to even, so on the same fp32 input they give
the same codes and scales bit for bit.  Where the input passes through
gelu' first, XLA's CPU tanh and PyTorch's may differ by ulps: g is held
within a few fp32 ulps (one bf16 ulp in bf16), and an element whose
folded value moved across a rounding boundary may change its code by
one step.  The composition of the two stages repeats the monolithic
plain versions' operations in their order, so it equals them bit for
bit; against the Pallas kernels it keeps the tolerances of
tests/test_torch_quant_train.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.pallas import quant_matmul as jqm
from distributed_tensorflow_tpu_torch.ops import quant_matmul as tqm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROLOGUES = ("none", "fold", "dgelu_fold", "dgelu_fold_want_g")


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _quant_inputs(rng, M, K, dtype, prologue):
    """a, pre and sf as numpy fp32 (a and pre exact in ``dtype``; sf
    powers of two, so that the fold is exact).  Rows 0 and 1 land exactly
    on half-integers after the prologue and the scaling (v * sf / sx =
    127, 0.5, 1.5, ...; pre = 0 there, where gelu' is exactly 0.5); row 2
    is all zeros (its scale is 1e-8 / 127)."""
    a = rng.standard_normal((M, K)).astype(np.float32)
    pre = (2 * rng.standard_normal((M, K))).astype(np.float32)
    sf = (2.0 ** -rng.integers(4, 8, K)).astype(np.float32)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -3.5],
                    np.float32)
    unfold = 1.0 / sf if prologue != "none" else 1.0
    for r in (0, 1):
        a[r] = np.resize(ties, K) * (0.25 if r else 1.0) * unfold
        if prologue.startswith("dgelu"):
            a[r] *= 2.0
        pre[r] = 0.0
    a[2] = 0.0
    jd = DTYPES[dtype][0]
    a = np.array(jnp.asarray(a).astype(jd).astype(jnp.float32))
    pre = np.array(jnp.asarray(pre).astype(jd).astype(jnp.float32))
    return a, pre, sf


def _jax_quantize(a, pre, sf, bk, dtype, prologue):
    """JAX's side of the quantize stage: the prologue of _qmm_nt_kernel
    (or none, _qmm_kernel's) in jnp, then _quant_block per K-block."""
    jd = DTYPES[dtype][0]
    M, K = a.shape
    v = jnp.asarray(a).astype(jd).astype(jnp.float32)
    g = None
    if prologue.startswith("dgelu"):
        v = v * jqm._dgelu(jnp.asarray(pre).astype(jd).astype(jnp.float32))
        g = v.astype(jd)
    if prologue != "none":
        v = v * jnp.asarray(sf)[None, :]
    q, sx = jqm._quant_block(v.reshape(M * K // bk, bk))
    return (np.asarray(q).reshape(M, K),
            np.asarray(sx).reshape(M, K // bk).T, g)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("prologue", PROLOGUES)
def test_quantize_stage_matches_jax_quant_block(prologue, dtype):
    rng = np.random.default_rng(7)
    M, K, bk = 24, 512, 128
    a, pre, sf = _quant_inputs(rng, M, K, dtype, prologue)
    td = DTYPES[dtype][1]
    gelu = prologue.startswith("dgelu")
    want_q, want_sx, want_g = _jax_quantize(a, pre, sf, bk, dtype, prologue)
    q, sx, g = tqm.quantize_blocks_reference(
        torch.from_numpy(a).to(td), bk,
        torch.from_numpy(pre).to(td) if gelu else None,
        torch.from_numpy(sf) if prologue != "none" else None,
        want_g=prologue.endswith("want_g"))
    assert q.dtype == torch.int8 and q.shape == (M, K)
    assert sx.dtype == torch.float32 and sx.shape == (K // bk, M)
    # The tie rows and the zero row, whatever the prologue.
    assert np.array_equal(q[:3].numpy(), want_q[:3])
    assert np.array_equal(sx[:, :3].numpy(), want_sx[:, :3])
    assert float(sx[0, 2]) == np.float32(1e-8) / np.float32(127)
    assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
    if not gelu:
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(sx.numpy(), want_sx)
        assert g is None
        return
    # gelu': XLA's and PyTorch's tanh may differ by ulps.
    np.testing.assert_allclose(sx.numpy(), want_sx, rtol=1e-5, atol=0)
    assert int((q.numpy().astype(np.int32) - want_q).__abs__().max()) <= 1
    if prologue.endswith("want_g"):
        got_g = g.float().numpy()
        ref_g = np.asarray(want_g.astype(jnp.float32))
        peak = float(np.abs(ref_g).max())
        tol = 1e-5 * peak if dtype == "float32" else _bf16_ulp(peak)
        assert float(np.abs(got_g - ref_g).max()) <= tol
    else:
        assert g is None


K4_VARIANTS = {
    "plain": dict(),
    "bias": dict(bias=True),
    "bias_gelu_preact": dict(bias=True, activation="gelu",
                             want_preact=True),
    "bias_residual": dict(bias=True, residual=True),
}
K5_VARIANTS = {
    "fold": dict(),
    "dgelu_fold": dict(prologue="dgelu_fold"),
    "dgelu_fold_want_g": dict(prologue="dgelu_fold", want_g=True),
}


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,bk", [(128, 128), (200, 512)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(K4_VARIANTS))
def test_k4_stages_compose_to_the_plain_version(variant, dtype, M, bk):
    """Quantize pass, K-major weight, block-scaled GEMM with K4's
    epilogue: bit for bit the monolithic quantized_matmul_reference."""
    spec = K4_VARIANTS[variant]
    rng = np.random.default_rng(M + bk)
    K, N = 1024, 256
    td = DTYPES[dtype][1]
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(td)
    qw, sw = tqm.quantize_cols(torch.from_numpy(
        (0.05 * rng.standard_normal((K, N))).astype(np.float32)))
    bias = residual = None
    if spec.get("bias"):
        bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    if spec.get("residual"):
        residual = torch.from_numpy(
            rng.standard_normal((M, N)).astype(np.float32)).to(td)
    kw = {k: v for k, v in spec.items() if k in ("activation",
                                                 "want_preact")}
    want = tqm.quantized_matmul_reference(x, qw, sw, bias, residual,
                                          block_k=bk, **kw)
    q, sx, _ = tqm.quantize_blocks_reference(x, bk)
    got = tqm.blocked_gemm_reference(q, sx, qw.t().contiguous(), bk, sw,
                                     bias, residual, out_dtype=td, **kw)
    _equal(got, want)


@pytest.mark.parametrize("M,bk", [(128, 128), (200, 512)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(K5_VARIANTS))
def test_k5_stages_compose_to_the_plain_version(variant, dtype, M, bk):
    """Quantize pass with gelu' and the fold, then the bare GEMM: bit for
    bit the monolithic quantized_matmul_nt_reference (and its g)."""
    kw = K5_VARIANTS[variant]
    rng = np.random.default_rng(M + bk + 1)
    K, N = 1024, 256
    td = DTYPES[dtype][1]
    da = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                          ).to(td)
    qw, sw = tqm.quantize_cols(torch.from_numpy(
        (0.05 * rng.standard_normal((N, K))).astype(np.float32)))
    pre = None
    if kw:
        pre = torch.from_numpy(
            (2 * rng.standard_normal((M, K))).astype(np.float32)).to(td)
    want = tqm.quantized_matmul_nt_reference(da, qw, sw, pre, block_k=bk,
                                             **kw)
    q, sx, g = tqm.quantize_blocks_reference(da, bk, pre, sw,
                                             want_g=kw.get("want_g", False))
    got = tqm.blocked_gemm_reference(q, sx, qw, bk, out_dtype=td)
    _equal((got, g) if kw.get("want_g") else got, want)


@pytest.mark.parametrize("M,K,N,bk", [(128, 1024, 256, 128),
                                      (200, 384, 640, 512)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("want_g", [False, True])
def test_k8_stages_compose_to_the_plain_version(want_g, dtype, M, K, N, bk):
    """K8 as the card runs it: the quantize pass with gelu' and no fold,
    the weight transposed K-major, the GEMM with the bare ``* swt``
    epilogue: bit for bit the monolithic quantized_matmul_dgelu_reference
    (and its g)."""
    rng = np.random.default_rng(M + K + bk + 2)
    td = DTYPES[dtype][1]
    da = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                          ).to(td)
    pre = torch.from_numpy(
        (2 * rng.standard_normal((M, K))).astype(np.float32)).to(td)
    qwt, swt = tqm.quantize_cols(torch.from_numpy(
        (0.05 * rng.standard_normal((K, N))).astype(np.float32)))
    want = tqm.quantized_matmul_dgelu_reference(da, pre, qwt, swt,
                                                want_g=want_g, block_k=bk)
    kb = tqm._block_k(K, bk)
    q, sx, g = tqm.quantize_blocks_reference(da, kb, pre, want_g=want_g)
    got = tqm.blocked_gemm_reference(q, sx, tqm.transpose_s8(qwt), kb, swt,
                                     out_dtype=td)
    _equal((got, g) if want_g else got, want)


@pytest.mark.parametrize("kind", ["k4", "k5"])
def test_stages_match_the_pallas_kernels(kind):
    """The two stages composed against the JAX kernels in interpret mode
    (bf16, K = 512 in four K-blocks of 128): K4 with the gelu epilogue
    and its pre-activation, K5 with gelu', the fold and g."""
    rng = np.random.default_rng(11)
    M, K, N, bk = 128, 512, 256, 128
    a = rng.standard_normal((M, K)).astype(np.float32)
    ja, ta = jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)
    if kind == "k4":
        w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
        b = rng.standard_normal(N).astype(np.float32)
        jq, js = jqm.quantize_cols(jnp.asarray(w))
        tq, ts = tqm.quantize_cols(torch.from_numpy(w))
        want = jqm.quantized_matmul(ja, jq, js, jnp.asarray(b),
                                    activation="gelu", want_preact=True,
                                    block_m=128, block_n=256, block_k=bk,
                                    interpret=True)
        q, sx, _ = tqm.quantize_blocks_reference(ta, bk)
        got = tqm.blocked_gemm_reference(
            q, sx, tq.t().contiguous(), bk, ts, torch.from_numpy(b),
            activation="gelu", want_preact=True, out_dtype=torch.bfloat16)
        steps = (0.0, 0.0)
    else:
        w = (0.1 * rng.standard_normal((N, K))).astype(np.float32)
        p = (2 * rng.standard_normal((M, K))).astype(np.float32)
        jp, tp = jnp.asarray(p).astype(jnp.bfloat16), \
            torch.from_numpy(p).to(torch.bfloat16)
        jq, js = jqm.quantize_cols(jnp.asarray(w))
        tq, ts = tqm.quantize_cols(torch.from_numpy(w))
        want = jqm.quantized_matmul_nt(ja, jq, js, jp, prologue="dgelu_fold",
                                       want_g=True, block_m=128,
                                       block_n=256, block_k=bk,
                                       interpret=True)
        q, sx, g = tqm.quantize_blocks_reference(ta, bk, tp, ts,
                                                 want_g=True)
        got = (tqm.blocked_gemm_reference(q, sx, tq, bk,
                                          out_dtype=torch.bfloat16), g)
        # XLA's tanh against PyTorch's: one code step of dx (see
        # tests/test_torch_quant_train.py's K5 case).
        gf = ta.float() * tqm._dgelu(tp.float())
        steps = (float((gf * ts).abs().max()), 0.0)
    for a_, b_, step in zip(got, want, steps):
        a_ = a_.float().numpy()
        b_ = np.asarray(jnp.asarray(b_).astype(jnp.float32))
        peak = float(np.abs(b_).max())
        assert float(np.abs(a_ - b_).max()) <= step + _bf16_ulp(peak)


def test_stage_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors quantize_blocks and blocked_gemm are their plain
    versions and count no launch."""
    rng = np.random.default_rng(5)
    da = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    pre = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    qw, sw = tqm.quantize_cols(torch.from_numpy(
        rng.standard_normal((128, 256)).astype(np.float32)))
    before = (tqm.quantize_launches, tqm.gemm_launches)
    got = tqm.quantize_blocks(da, 128, pre, sw, want_g=True)
    want = tqm.quantize_blocks_reference(da, 128, pre, sw, want_g=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    q, sx, _ = got
    assert torch.equal(tqm.blocked_gemm(q, sx, qw, 128),
                       tqm.blocked_gemm_reference(q, sx, qw, 128))
    assert (tqm.quantize_launches, tqm.gemm_launches) == before
    with pytest.raises(ValueError, match="want_g needs pre"):
        tqm.quantize_blocks(da, 128, want_g=True)
