"""The port's int8 training path (distributed_tensorflow_tpu_torch/ops/
quant_matmul.py and quant_train.py, GptConfig.matmul_int8/attn_int8)
against the JAX package's: the plain versions of the quantize-matmul
kernels (K4, K5) against the Pallas kernels in interpret mode for every
epilogue and prologue, the fused MLP's value and gradients, int8_matmul,
Int8Dense and the attn_int8 projections, three train steps from the same
weights, and port-only checks (convergence against bf16, the gate, the
registry flags).  Small shapes on the CPU; inputs from seeded numpy
generators.

Tolerances.  Both sides quantize with the same IEEE divisions, round half
to even and add exact int32 K-block products into fp32 in the same order,
so the plain versions give the Pallas kernels' int8 codes.  They differ
where the two frameworks' fp32 arithmetic differs: tanh (XLA's CPU tanh
is its own approximation), the order of a few fp32 sums, a fused
multiply-add.  That is a few fp32 ulps in fp32 and at most one bf16 ulp
of the largest magnitude in bf16.  Downstream of a quantizer, an ulp that
moves a value across a rounding boundary changes one int8 code by one
step, which moves a product by about one quantization step (~1/127 of a
row's range times a weight): the gradient and train-step tolerances
below allow for that and say so."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.models import registry as jreg
from distributed_tensorflow_tpu.ops import quant_train as jqt
from distributed_tensorflow_tpu.ops.pallas import quant_matmul as jqm
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.ops import quant_matmul as tqm
from distributed_tensorflow_tpu_torch.ops import quant_train as tqt
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEQ = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores: one intra-op
    thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_fused_gate(monkeypatch):
    """Open the JAX package's fused-MLP gate on the CPU to the shape rule
    alone, as test_int8_train.py does (its TPU backend term is False
    here; the port's gate has no such term)."""
    monkeypatch.setattr(jqt, "use_fused_mlp",
                        lambda M, H, I: jqm.supported(M, H, I))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _close(got, want, dtype: str, name: str = "",
           step: float = 0.0) -> None:
    """fp32: a few ulps of the largest magnitude (1e-5 relative covers
    XLA's tanh and summation order); bf16: one bf16 ulp of it.  ``step``
    adds one int8 code step of the product, where a quantizer's input
    differs by ulps between the frameworks."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    peak = float(np.abs(want).max())
    tol = step + (1e-5 * peak if dtype == "float32" else _bf16_ulp(peak))
    err = float(np.abs(got - want).max())
    assert err <= tol, (name, err, tol, peak)


def _bf16_sum_step(want) -> float:
    """A bias gradient in bf16 is a sum of the bf16 cotangent over the
    rows.  XLA reduces it in bf16, rounding each partial sum; torch
    accumulates in fp32 and rounds once.  Over ~100 rows the two land
    within three more bf16 ulps of the result."""
    return 3 * _bf16_ulp(float(np.abs(_np(want)).max()))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _pair(rng, shape, dtype: str, scale: float = 1.0):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _weights(rng, K, N):
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    jq, js = jqm.quantize_cols(jnp.asarray(w))
    tq, ts = tqm.quantize_cols(torch.from_numpy(w))
    return (jq, js), (tq, ts)


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_cols_is_bit_exact(dtype):
    rng = np.random.default_rng(0)
    jw, tw = _pair(rng, (384, 200), dtype, 0.3)
    # Exact halves: round half to even on both sides.
    jw = jw.at[0, :4].set(jnp.asarray([0.5, 1.5, 2.5, 127.0], jw.dtype))
    tw[0, :4] = torch.tensor([0.5, 1.5, 2.5, 127.0])
    jq, js = jqm.quantize_cols(jw)
    tq, ts = tqm.quantize_cols(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_gelu_and_its_derivative_match_jax():
    y = np.linspace(-8.0, 8.0, 4001, dtype=np.float32)
    for jf, tf in ((jqm._gelu, tqm._gelu), (jqm._dgelu, tqm._dgelu)):
        # XLA's CPU tanh is its own approximation: a few fp32 ulps, and
        # up to ~4e-6 absolute in the far tails where gelu' ~ 1e-5 (the
        # bound test_int8_train.py gives the same difference).
        np.testing.assert_allclose(tf(torch.from_numpy(y)).numpy(),
                                   np.asarray(jf(jnp.asarray(y))),
                                   rtol=1e-5, atol=5e-6)


QMM_VARIANTS = {
    "plain": dict(),
    "bias": dict(bias=True),
    "bias_gelu_preact": dict(bias=True, activation="gelu",
                             want_preact=True),
    "bias_residual": dict(bias=True, residual=True),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(QMM_VARIANTS))
def test_quantized_matmul_plain_version_matches_pallas(variant, dtype):
    """K=512 in four K-blocks of 128: the blockwise rescale is held."""
    spec = QMM_VARIANTS[variant]
    rng = np.random.default_rng(1)
    M, K, N = 256, 512, 256
    jx, tx = _pair(rng, (M, K), dtype)
    (jq, js), (tq, ts) = _weights(rng, K, N)
    jb = tb = jr = tr = None
    if spec.get("bias"):
        jb, tb = _pair(rng, (N,), "float32")
    if spec.get("residual"):
        jr, tr = _pair(rng, (M, N), dtype)
    kw = {k: v for k, v in spec.items() if k in ("activation",
                                                 "want_preact")}
    want = jqm.quantized_matmul(jx, jq, js, jb, jr, block_m=128,
                                block_n=256, block_k=128, interpret=True,
                                **kw)
    got = tqm.quantized_matmul(tx, tq, ts, tb, tr, block_k=128, **kw)
    if not spec.get("want_preact"):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for name, a, b in zip(("y", "pre"), got, want):
        assert a.dtype == DTYPES[dtype][1]
        _close(a, b, dtype, name)


NT_VARIANTS = {
    "fold": dict(),
    "dgelu_fold": dict(prologue="dgelu_fold"),
    "dgelu_fold_want_g": dict(prologue="dgelu_fold", want_g=True),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(NT_VARIANTS))
def test_quantized_matmul_nt_plain_version_matches_pallas(variant, dtype):
    """da [M, K=512] against the forward's weight [N=256, K]: four
    K-blocks of 128, the scale fold, the gelu backward and g."""
    kw = NT_VARIANTS[variant]
    rng = np.random.default_rng(2)
    M, K, N = 256, 512, 256
    jda, tda = _pair(rng, (M, K), dtype)
    (jq, js), (tq, ts) = _weights(rng, N, K)
    jp = tp = None
    if kw:
        jp, tp = _pair(rng, (M, K), dtype, 2.0)
    want = jqm.quantized_matmul_nt(jda, jq, js, jp, block_m=128,
                                   block_n=256, block_k=128,
                                   interpret=True, **kw)
    got = tqm.quantized_matmul_nt(tda, tq, ts, tp, block_k=128, **kw)
    # dgelu_fold: the frameworks' tanh differ by ulps, which can move an
    # element of g * sf across a rounding boundary; one code step of dx
    # is then at most sg * 127 = max |g * sf| of the row.
    step = 0.0
    if tp is not None:
        g = tda.float() * tqm._dgelu(tp.float())
        step = float((g * ts).abs().max())
    if not kw.get("want_g"):
        want, got = (want,), (got,)
    for name, a, b in zip(("dx", "g"), got, want):
        assert a.dtype == DTYPES[dtype][1]
        _close(a, b, dtype, name, step if name == "dx" else 0.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("want_g", [False, True])
def test_quantized_matmul_dgelu_plain_version_matches_pallas(want_g, dtype):
    """K8, test_int8_train.py:124's case: da, pre [M=256, K=512] against
    an explicitly quantized w.T [K, N=256] in four K-blocks of 128, the
    gelu backward in the prologue, no fold, g out with want_g.  On the CPU
    the wrapper computes the plain version and counts no launch."""
    rng = np.random.default_rng(4)
    M, K, N = 256, 512, 256
    jda, tda = _pair(rng, (M, K), dtype)
    jp, tp = _pair(rng, (M, K), dtype, 2.0)
    (jq, js), (tq, ts) = _weights(rng, K, N)
    want = jqm.quantized_matmul_dgelu(jda, jp, jq, js, want_g=want_g,
                                      block_m=128, block_n=256, block_k=128,
                                      interpret=True)
    before = tqm.dgelu_launches
    got = tqm.quantized_matmul_dgelu(tda, tp, tq, ts, want_g=want_g,
                                     block_k=128)
    assert tqm.dgelu_launches == before
    # The frameworks' tanh differ by ulps, which can move an element of g
    # across a rounding boundary; one code step of dx is then at most
    # sg * 127 * max(swt) = max |g| of the row times max(swt).
    g = tda.float() * tqm._dgelu(tp.float())
    step = float(g.abs().max() * ts.max())
    if not want_g:
        want, got = (want,), (got,)
    for name, a, b in zip(("dx", "g"), got, want):
        assert a.dtype == DTYPES[dtype][1]
        _close(a, b, dtype, name, step if name == "dx" else 0.0)


def test_quantized_matmul_rejects_what_jax_rejects():
    x = torch.zeros(128, 128)
    qw, sw = tqm.quantize_cols(torch.ones(128, 256))
    with pytest.raises(ValueError, match="shape mismatch"):
        tqm.quantized_matmul(x, qw, sw[:, :128])
    with pytest.raises(ValueError, match="want_preact"):
        tqm.quantized_matmul(x, qw, sw, want_preact=True)
    with pytest.raises(ValueError, match="residual shape"):
        tqm.quantized_matmul(x, qw, sw, residual=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="pre must be given"):
        tqm.quantized_matmul_nt(x, qw.t(), torch.ones(1, 128),
                                prologue="dgelu_fold")
    with pytest.raises(ValueError, match="want_g"):
        tqm.quantized_matmul_nt(x, qw.t(), torch.ones(1, 128), want_g=True)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers compute the plain versions and count no
    kernel launch."""
    rng = np.random.default_rng(3)
    _, tx = _pair(rng, (128, 256), "bfloat16")
    _, (tq, ts) = _weights(rng, 256, 128)
    before = (tqm.launches, tqm.nt_launches)
    torch.testing.assert_close(
        tqm.quantized_matmul(tx, tq, ts),
        tqm.quantized_matmul_reference(tx, tq, ts), atol=0, rtol=0)
    torch.testing.assert_close(
        tqm.quantized_matmul_nt(tx[:, :128], tq, ts),
        tqm.quantized_matmul_nt_reference(tx[:, :128], tq, ts),
        atol=0, rtol=0)
    assert (tqm.launches, tqm.nt_launches) == before


# ------------------------------------------------------------ quant_train


def _mlp_inputs(rng, M, H, I, dtype):
    jx, tx = _pair(rng, (M, H), dtype)
    params = [_pair(rng, s, "float32", 0.1)
              for s in ((H, I), (I,), (I, H), (H,))]
    return jx, tx, [p[0] for p in params], [p[1] for p in params]


# The fused MLP's output and gradients, max abs error over the largest
# magnitude.  The second forward product and both dgrads quantize inputs
# that went through tanh (gelu, gelu'), where the frameworks differ by
# ulps: a code can flip by one step (~1/127 of a row's range in one
# element of one product).  dx crosses two such dgrads; the weight and
# bias gradients are fp32 reductions of the emitted g and of the
# forward's activations, which carry the same flips.  Measured at these
# shapes: below 1e-5 in fp32 and 5e-3 in bf16.
MLP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("residual", [False, True])
def test_int8_gelu_mlp_value_and_grads_match_jax(dtype, residual):
    rng = np.random.default_rng(4)
    M, H, I = 256, 128, 512
    jx, tx, jp, tp = _mlp_inputs(rng, M, H, I, dtype)
    jct, tct = _pair(rng, (M, H), "float32")
    args_j, args_t = [jx, *jp], [tx, *tp]
    if residual:
        jr, tr = _pair(rng, (M, H), dtype)
        args_j.append(jr)
        args_t.append(tr)
    jfn = jqt.int8_gelu_mlp_res if residual else jqt.int8_gelu_mlp
    tfn = tqt.int8_gelu_mlp_res if residual else tqt.int8_gelu_mlp

    def jloss(*a):
        return jnp.sum(jfn(*a).astype(jnp.float32) * jct)

    want_y = jfn(*args_j)
    want_g = jax.grad(jloss, argnums=tuple(range(len(args_j))))(*args_j)
    leaves = [t.clone().requires_grad_() for t in args_t]
    y = tfn(*leaves)
    assert y.dtype == DTYPES[dtype][1]
    assert _rel(y, want_y) <= MLP_TOL[dtype], _rel(y, want_y)
    (y.float() * tct).sum().backward()
    names = ("dx", "dw_in", "db_in", "dw_out", "db_out", "dres")
    for name, leaf, w in zip(names, leaves, want_g):
        assert leaf.grad.dtype == leaf.dtype, name
        assert _rel(leaf.grad, w) <= MLP_TOL[dtype], (
            name, _rel(leaf.grad, w))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_matmul_value_and_grads_match_jax(dtype):
    """The per-row formulation (Int8Dense's): x in ``dtype``, w fp32.
    Forward and dgrad are int8 with exact products; the wgrad is fp32."""
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, (96, 128), dtype)
    jw, tw = _pair(rng, (128, 80), "float32", 0.1)
    jct, tct = _pair(rng, (96, 80), "float32")
    want = jqt.int8_matmul(jx, jw)
    gj = jax.grad(lambda x, w: jnp.sum(jqt.int8_matmul(x, w).astype(
        jnp.float32) * jct), argnums=(0, 1))(jx, jw)
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    y = tqt.int8_matmul(x, w)
    _close(y, want, dtype, "y")
    (y.float() * tct).sum().backward()
    _close(x.grad, gj[0], dtype, "dx")
    assert w.grad.dtype == torch.float32
    _close(w.grad, gj[1], "float32", "dw")


def test_int8_dense_matches_jax_and_keeps_dense_parameters():
    from flax import linen as nn
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng, (4, 24, 64), "bfloat16")
    jct, tct = _pair(rng, (4, 24, 48), "float32")
    jparams = jqt.Int8Dense(48).init(jax.random.PRNGKey(0), jx)["params"]
    flax_dense = nn.Dense(48).init(jax.random.PRNGKey(0), jx)["params"]
    layer = tqt.Int8Dense((64,), (48,), dtype=torch.bfloat16,
                          param_dtype=torch.float32)
    assert isinstance(layer, tgpt.Dense)
    assert sorted(layer.state_dict()) == sorted(flax_dense) == ["bias",
                                                               "kernel"]
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in jparams.items()})
    want = jqt.Int8Dense(48).apply({"params": jparams}, jx)
    gj = jax.grad(lambda p: jnp.sum(jqt.Int8Dense(48).apply(
        {"params": p}, jx).astype(jnp.float32) * jct))(jparams)
    y = layer(tx)
    assert y.dtype == torch.bfloat16 and y.shape == (4, 24, 48)
    _close(y, want, "bfloat16", "y")
    (y.float() * tct).sum().backward()
    # The kernel's gradient is an fp32 product of bf16 operands (exact
    # products, fp32 sums in another order); the bias is added in the
    # compute dtype, so its gradient is a bf16 sum (_bf16_sum_step).
    assert layer.kernel.grad.dtype == torch.float32
    _close(layer.kernel.grad, gj["kernel"], "float32", "kernel")
    _close(layer.bias.grad, gj["bias"], "bfloat16", "bias",
           _bf16_sum_step(gj["bias"]))


def test_attn_int8_dense_matches_jax_int8_dot_general():
    """The attention projections' int8 route: flax's DenseGeneral with
    ``dot_general=int8_dot_general`` against the port's Dense(int8=True),
    on the qkv layout [H, 3, heads, D] and the out layout [heads, D, H]."""
    from flax import linen as nn
    rng = np.random.default_rng(7)
    H, nh, hd = 64, 4, 16
    jx, tx = _pair(rng, (2, 32, H), "bfloat16")
    for feats, axis, in_shape, out_shape in (
            ((3, nh, hd), -1, (H,), (3, nh, hd)),
            (H, (-2, -1), (nh, hd), (H,))):
        x_j = jx if in_shape == (H,) else jx.reshape(2, 32, nh, hd)
        x_t = tx if in_shape == (H,) else tx.reshape(2, 32, nh, hd)
        mod = nn.DenseGeneral(feats, axis=axis, dtype=jnp.bfloat16,
                              dot_general=jqt.int8_dot_general)
        params = mod.init(jax.random.PRNGKey(1), x_j)["params"]
        layer = tgpt.Dense(in_shape, out_shape, dtype=torch.bfloat16,
                           param_dtype=torch.float32, int8=True)
        layer.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in params.items()})
        want = mod.apply({"params": params}, x_j)
        jct, tct = _pair(rng, want.shape, "float32")
        gj = jax.grad(lambda p: jnp.sum(mod.apply(
            {"params": p}, x_j).astype(jnp.float32) * jct))(params)
        y = layer(x_t)
        _close(y, want, "bfloat16", f"{out_shape} y")
        (y.float() * tct).sum().backward()
        # The kernel's gradient lands in bf16 (the compute dtype) before
        # the cast to the fp32 master, on both sides: one bf16 ulp; the
        # bias gradient is a bf16 sum (_bf16_sum_step).
        _close(layer.kernel.grad, gj["kernel"], "bfloat16",
               f"{out_shape} dkernel")
        _close(layer.bias.grad, gj["bias"], "bfloat16", f"{out_shape} dbias",
               _bf16_sum_step(gj["bias"]))


# ------------------------------------------------------------- the model


@functools.lru_cache(maxsize=None)
def _jax_bundle(attn_int8: bool = False):
    """The JAX fp32 int8 bundle, built once: its eager init runs the
    Pallas kernels in interpret mode."""
    return jreg.build_gpt_mini(1e-3, seq_len=SEQ, dtype="float32",
                               attention_backend="pallas", fused_ln=True,
                               matmul_int8=True, attn_int8=attn_int8,
                               tx=optax.sgd(0.5))


def _port_bundle(dtype, **kw):
    return treg.build_gpt_mini(1e-3, tx=topt.make_optimizer("sgd", 0.5),
                               seq_len=SEQ, dtype=dtype,
                               attention_backend="pallas", fused_ln=True,
                               matmul_int8=True, device="cpu", **kw)


def test_int8_model_keeps_the_bf16_state_dict():
    plain = tgpt.GptLM(tgpt.mini(), device="cpu")
    for kw in (dict(matmul_int8=True), dict(attn_int8=True)):
        model = tgpt.GptLM(dataclasses.replace(tgpt.mini(), **kw),
                           device="cpu")
        assert {k: v.shape for k, v in model.state_dict().items()} == {
            k: v.shape for k, v in plain.state_dict().items()}
    jtree = jax.device_get(_jax_bundle().state.params)
    assert sorted(tgpt.params_from_jax(jtree)) == sorted(
        plain.state_dict())


def test_attn_int8_model_logits_match_jax(jax_fused_gate):
    """fp32 model with both int8 flags, B=8, S=32 (M=256 rows: the fused
    MLP's gate passes).  matmul_int8 alone is held by the train steps
    below, whose first loss comes from the same weights."""
    attn_int8 = True
    jb = _jax_bundle(attn_int8)
    params = jax.device_get(jb.state.params)
    cfg = dataclasses.replace(
        jgpt.mini(), dtype="float32", attention_backend="pallas",
        fused_ln=True, matmul_int8=True, attn_int8=attn_int8)
    tokens = jgpt.synthetic_lm_batch(0, 8, SEQ, cfg)["tokens"]
    want = jgpt.GptLM(cfg).apply({"params": params}, jnp.asarray(tokens))
    model = tgpt.GptLM(tgpt.GptConfig(**dataclasses.asdict(cfg)),
                       device="cpu", param_dtype=torch.float32)
    model.load_state_dict(tgpt.params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    # attn_int8 quantizes the projections' inputs per row (the LayerNorm
    # outputs and the attention context) with one scale per row, so an ulp
    # of difference in any element can flip codes across a whole row, and
    # its logits move far more per ulp of input than the fused MLP's:
    # measured 1.05e-2 against JAX.
    assert _rel(got, want) <= 3e-2, _rel(got, want)


# Three SGD steps (lr 0.5) of the int8 model against the JAX sync step
# from the same weights.  The parameters move by lr * gradient, so they
# show the gradients' agreement.  fp32: the quantizers see inputs that
# differ by ulps, and a flipped code moves one product by a quantization
# step; bf16 adds the bf16 activations' rounding at other places in the
# two frameworks (measured 8.3e-4 for the bf16 model without int8).
# Measured: fp32 losses 2.4e-7 (step 1, same weights), then 9.2e-5
# relative (the updates of step 1 carry the dgrads' code flips), params
# 2.0e-4; bf16 losses 2.2e-4, params 7.9e-4, update cosine 0.99988.
INT8_TRAIN_CASES = {
    "float32": dict(loss_tol=5e-4, param_atol=1e-3, min_cos=0.9999),
    "bfloat16": dict(loss_tol=3e-3, param_atol=3e-3, min_cos=0.999),
}


def _jax_loss_fn(dtype):
    if dtype == "float32":
        return _jax_bundle().loss_fn
    model = jgpt.GptLM(dataclasses.replace(
        jgpt.mini(), dtype=dtype, attention_backend="pallas",
        fused_ln=True, matmul_int8=True))

    def loss_fn(params, batch):
        logits = model.apply({"params": params}, batch["tokens"])
        loss, acc = jgpt.lm_loss(logits, batch["tokens"])
        return loss, {"accuracy": acc}
    return loss_fn


def _flat(state_dict):
    return torch.cat([v.detach().float().flatten()
                      for _, v in sorted(state_dict.items())])


@pytest.mark.parametrize("dtype", sorted(INT8_TRAIN_CASES))
def test_three_int8_train_steps_match_jax_sync_step(jax_fused_gate, dtype):
    tol = INT8_TRAIN_CASES[dtype]
    jb = _jax_bundle()
    js = jb.state
    tb = _port_bundle(dtype)
    model = tb.state.model
    assert isinstance(model.layers[0].mlp_in, tqt.Int8Dense)
    model.load_state_dict(tgpt.params_from_jax(jax.device_get(js.params)))
    jstep = jsync.build_sync_train_step(None, _jax_loss_fn(dtype),
                                        donate=False, log_grad_norm=True)
    tstep = tsync.build_sync_train_step(tb.loss_fn, log_grad_norm=True)
    ts = tb.state
    jdata, tdata = jb.load_datasets(None).train, tb.load_datasets(None).train
    before = _flat(model.state_dict())
    fused0 = tqm.launches + tqm.nt_launches
    for i in range(3):
        jbatch, tbatch = jdata.next_batch(8), tdata.next_batch(8)
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=tol["loss_tol"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
        want = tgpt.params_from_jax(jax.device_get(js.params))
        got = model.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].float().numpy(), w.numpy(),
                                       atol=tol["param_atol"], rtol=0,
                                       err_msg=f"step {i}: {name}")
        cos = torch.nn.functional.cosine_similarity(
            _flat(got) - before, _flat(want) - before, dim=0)
        assert cos >= tol["min_cos"], (i, float(cos))
    # CPU tensors: the plain versions ran, no kernel was counted.
    assert tqm.launches + tqm.nt_launches == fused0


def test_port_int8_learns_and_stays_near_bf16():
    """Port-only copy of test_gpt_int8_convergence_delta: the int8-MLP
    model learns the synthetic stream and ends within its bound of the
    bf16 model's loss (Adam 3e-3, B=16, S=32, 120 steps, same init)."""
    cfg = dataclasses.replace(tgpt.mini(), dtype="bfloat16")

    def train(matmul_int8, steps=120):
        c = dataclasses.replace(cfg, matmul_int8=matmul_int8)
        model = tgpt.GptLM(c, device="cpu", param_dtype=torch.float32)
        opt = torch.optim.Adam(model.parameters(), lr=3e-3)
        first = last = None
        for i in range(steps):
            tokens = torch.from_numpy(
                tgpt.synthetic_lm_batch(i, 16, 32, c)["tokens"]).long()
            loss, _ = tgpt.lm_loss(model(tokens), tokens)
            opt.zero_grad()
            loss.backward()
            opt.step()
            last = loss.item()
            first = last if first is None else first
        return first, last

    f_first, f_last = train(False)
    q_first, q_last = train(True)
    assert q_last < 0.55 * q_first, (q_first, q_last)
    assert q_last < f_last * 1.10 + 0.1, (f_last, q_last)


def test_gate_takes_int8_dense_for_rows_it_does_not_admit(monkeypatch):
    """48 rows have no power-of-two divisor >= 128: the MLP takes the
    per-row Int8Dense formulation (as a decode step does), never the
    fused MLP; 256 rows take the fused MLP."""
    calls = []
    orig = tqt.int8_gelu_mlp
    monkeypatch.setattr(tqt, "int8_gelu_mlp",
                        lambda *a: calls.append(1) or orig(*a))
    cfg = dataclasses.replace(tgpt.mini(), num_layers=1, dtype="float32",
                              matmul_int8=True)
    model = tgpt.GptLM(cfg, device="cpu", param_dtype=torch.float32)
    block = model.layers[0]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 48, cfg.hidden_size)).astype(np.float32))
    assert not tqt.use_fused_mlp(48, cfg.hidden_size, cfg.intermediate_size)
    got = block._mlp(x)
    assert not calls
    h = block.ln_mlp(x)
    want = x + block.mlp_out(torch.nn.functional.gelu(
        block.mlp_in(h), approximate="tanh"))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    block._mlp(x.repeat(1, 16, 1)[:, :256])
    assert calls == [1]


def test_fused_residual_flag_gives_the_default_outputs(monkeypatch):
    cfg = dataclasses.replace(tgpt.mini(), num_layers=1, dtype="float32",
                              matmul_int8=True)
    model = tgpt.GptLM(cfg, device="cpu", param_dtype=torch.float32)
    tokens = torch.from_numpy(
        tgpt.synthetic_lm_batch(0, 8, SEQ, cfg)["tokens"]).long()
    base = model(tokens)
    calls = []
    orig = tqt.int8_gelu_mlp_res
    monkeypatch.setattr(tqt, "int8_gelu_mlp_res",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(tqt, "FUSED_MLP_RESIDUAL", True)
    fused = model(tokens)
    assert calls
    # The fused add rounds once in fp32 where the default adds after the
    # cast: fp32 rounding only.
    torch.testing.assert_close(fused, base, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flag", ["matmul_int8", "attn_int8"])
def test_build_gpt_mini_int8_flags_train_a_step(flag):
    bundle = treg.build_gpt_mini(1e-3, seq_len=SEQ, device="cpu",
                                 **{flag: True})
    assert getattr(bundle.state.model.cfg, flag)
    step = tsync.build_sync_train_step(bundle.loss_fn, log_grad_norm=True)
    split = bundle.load_datasets(None).train
    state, metrics = step(bundle.state, split.next_batch(8))
    assert state.global_step == 2
    assert 4.0 < float(metrics["loss"]) < 7.0
    assert math.isfinite(float(metrics["grad_norm"]))
