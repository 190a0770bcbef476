"""Int8 quantized training matmuls (the SwitchBack recipe): int8 forward
and input-gradient products, full-precision weight gradients.

Counterpart of ``distributed_tensorflow_tpu/ops/quant_train.py``:

- :func:`int8_matmul`: ``x [M, K] @ w [K, N]`` with the activations
  quantized per row and the weight per output column (both scale vectors
  index non-contracted axes, so the int32 product rescales exactly), the
  dgrad against ``w.T`` re-quantized per column, the wgrad an fp32 product.
  The drop-in for :class:`Int8Dense` and for the ``attn_int8``
  projections (:meth:`..models.gpt.Dense.forward` with ``int8``);
- :func:`int8_gelu_mlp` (and :func:`int8_gelu_mlp_res`, the block's
  residual fused in): the whole gelu MLP through the quantize-matmul
  kernels of :mod:`.quant_matmul`, K4 with bias + gelu + pre-activation in
  the forward, K5 with the scale fold (and the gelu backward) in the
  dgrad, the forward's quantized weights reused by the backward as they
  are.  Taken when :func:`use_fused_mlp` admits the shapes;
- :class:`Int8Dense`: the port's ``Dense`` with its matmul routed through
  :func:`int8_matmul`; same parameters, so checkpoints are shared.

Around the kernels everything is plain PyTorch, as it is XLA in the JAX
package: the weight quantization, the per-row quantization and int8
product of :func:`int8_matmul`, the weight and bias gradients.
"""

from __future__ import annotations

import torch

from ..models.gpt import Dense
from . import quant_matmul as qmm
from .quant_matmul import (quantize_cols, quantized_matmul,
                           quantized_matmul_nt, supported)

#: Route :func:`int8_matmul`'s forward and dgrad through the fused
#: quantize-matmul kernel (K4).  Off, as in the JAX package, where the
#: kernel lost its epilogue fusions in the full step.
FUSED_KERNEL_IN_STEP = False

#: Route the whole gelu MLP through the fused kernels
#: (:func:`int8_gelu_mlp`).  On, as in the JAX package.
FUSED_MLP_IN_STEP = True

#: Also fold the block's residual add into the second forward kernel's
#: epilogue (:func:`int8_gelu_mlp_res`).  Off, as in the JAX package.
FUSED_MLP_RESIDUAL = False


def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per ROW (last axis reduced): returns (q, scale)."""
    x32 = x.to(torch.float32)
    s = qmm._scale(x32.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s


def _i8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> the exact int32 product: the library's
    int8 GEMM (``torch._int_mm``) where its shape rules hold on the card,
    else fp32 products over exact K-chunks (:func:`.quant_matmul.int_dot`).
    The JAX package leaves this product to XLA."""
    M, K = a.shape
    N = b.shape[1]
    if a.is_cuda and M > 16 and K % 8 == 0 and N % 8 == 0:
        # b K-contiguous: the library's fast int8 layout.
        return torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return qmm.int_dot(a, b)


def _wgrad(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``a.T @ g`` [K, N] in fp32 from (bf16) operands, unrounded: the
    JAX code's ``preferred_element_type=f32``.  On the card bf16 operands
    go through the bf16 tensor cores with an fp32 output; on the CPU the
    operands are widened (bf16 products are exact in fp32)."""
    if a.is_cuda and a.dtype == g.dtype and a.dtype != torch.float32:
        return torch.mm(a.t(), g, out_dtype=torch.float32)
    return a.t().to(torch.float32) @ g.to(torch.float32)


def _use_fused_kernel(M: int, K: int, N: int) -> bool:
    return FUSED_KERNEL_IN_STEP and supported(M, K, N)


def _int8_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    M, K = x.shape
    N = w.shape[1]
    qw, sw = quantize_cols(w)
    if _use_fused_kernel(M, K, N):
        return quantized_matmul(x, qw, sw)
    qx, sx = _quant_rows(x)
    y = _i8_dot(qx, qw).to(torch.float32) * sx * sw
    return y.to(x.dtype)


class _Int8Matmul(torch.autograd.Function):
    """``jax.custom_vjp`` of ``int8_matmul``: saves (x, w)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        M, N = g.shape
        K = w.shape[0]
        qwt, swt = quantize_cols(w.t())
        if _use_fused_kernel(M, N, K):
            dx = quantized_matmul(g, qwt, swt).to(x.dtype)
        else:
            qg, sg = _quant_rows(g)
            dx = (_i8_dot(qg, qwt).to(torch.float32) * sg * swt).to(x.dtype)
        return dx, _wgrad(x, g).to(w.dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in x.dtype with int8 forward/dgrad, fp32
    wgrad (cast to w.dtype).  Without a gradient to record the forward
    runs bare, without the autograd node."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Int8Matmul.apply(x, w)
    return _int8_fwd(x, w)


def use_fused_mlp(M: int, H: int, I: int) -> bool:
    """Gate for the whole gelu MLP through the fused kernels: the flag and
    tileable shapes for every matmul of the pair (one dim set covers the
    forwards and the NT dgrads).  The gate decides which function is
    computed (per-(row, K-block) scales in the kernels, per-row scales in
    :class:`Int8Dense`), so the port keeps the JAX package's shape rule;
    the TPU-only terms (backend, GSPMD hazard) do not apply."""
    return FUSED_MLP_IN_STEP and supported(M, H, I)


def _mlp_fwd(x, w_in, b_in, w_out, b_out, res=None):
    """Forward of the fused MLP: (y, saved tensors).  ``block_k`` 1024 on
    the single-output calls and 512 on the two-output ones, as in the JAX
    code: the K-block is part of the function."""
    qwi, swi = quantize_cols(w_in)
    a, pre = quantized_matmul(x, qwi, swi, b_in, activation="gelu",
                              want_preact=True)
    qwo, swo = quantize_cols(w_out)
    y = quantized_matmul(a, qwo, swo, b_out, res, block_k=1024)
    return y, (x, pre, a, qwi, swi, qwo, swo)


def _mlp_bwd(saved, gy):
    """The MLP's backward: (dx, dw_in, db_in, dw_out, db_out).  Both
    dgrads reuse the forward's quantized weights in their forward layout
    (K5); the wgrads are fp32 products, the bias gradients fp32 sums."""
    x, pre, a, qwi, swi, qwo, swo = saved
    da = quantized_matmul_nt(gy, qwo, swo, block_k=1024)
    dw_out = _wgrad(a, gy)
    db_out = gy.to(torch.float32).sum(dim=0)
    dx, g = quantized_matmul_nt(da, qwi, swi, pre, prologue="dgelu_fold",
                                want_g=True)
    dw_in = _wgrad(x, g)
    db_in = g.to(torch.float32).sum(dim=0)
    return dx, dw_in, db_in, dw_out, db_out


class _Int8GeluMlp(torch.autograd.Function):
    """``jax.custom_vjp`` of ``int8_gelu_mlp`` (and, with ``res``, of
    ``int8_gelu_mlp_res``): saves (x, pre, a, qwi, swi, qwo, swo)."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, w_out, b_out, res):
        y, saved = _mlp_fwd(x, w_in, b_in, w_out, b_out, res)
        ctx.save_for_backward(*saved)
        ctx.param_dtypes = (w_in.dtype, b_in.dtype, w_out.dtype,
                            b_out.dtype)
        ctx.has_res = res is not None
        return y

    @staticmethod
    def backward(ctx, gy):
        dx, *dparams = _mlp_bwd(ctx.saved_tensors, gy)
        dparams = [d.to(dt) for d, dt in zip(dparams, ctx.param_dtypes)]
        return (dx, *dparams, gy if ctx.has_res else None)


def _fused(x, w_in, b_in, w_out, b_out, res):
    args = (x, w_in, b_in, w_out, b_out, res)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return _Int8GeluMlp.apply(*args)
    return _mlp_fwd(*args)[0]


def int8_gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
                  w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """The whole gelu MLP, ``gelu(x @ w_in + b_in) @ w_out + b_out``
    (x [M, H], w_in [H, I], w_out [I, H]), through K4 and K5: int8
    forward and dgrads with per-(row, K-block) activation scales, fp32
    wgrads.  The caller gates on :func:`use_fused_mlp`."""
    return _fused(x, w_in, b_in, w_out, b_out, None)


def int8_gelu_mlp_res(x: torch.Tensor, w_in: torch.Tensor,
                      b_in: torch.Tensor, w_out: torch.Tensor,
                      b_out: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """:func:`int8_gelu_mlp` plus ``res`` [M, H], added after the
    activation in fp32 inside the second kernel's epilogue and rounded
    once.  The residual's gradient is the incoming one."""
    return _fused(x, w_in, b_in, w_out, b_out, res)


class Int8Dense(Dense):
    """:class:`..models.gpt.Dense` with the matmul routed through
    :func:`int8_matmul`: the same parameters (``kernel`` [in, features],
    ``bias``), initializers and state_dict keys, so bf16 and int8 runs
    share checkpoints.  The kernel goes to :func:`int8_matmul` in its
    stored dtype (fp32 masters when training), re-quantized at every call;
    the input is cast to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = int8_matmul(x.reshape(-1, self.fan_in).to(self.dtype),
                        self.kernel.reshape(self.fan_in, -1))
        y = y.reshape(*lead, *self.out_shape)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
