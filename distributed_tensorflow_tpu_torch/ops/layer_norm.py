"""LayerNorm over the last axis: fp32 statistics and fp32 output.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas/layer_norm.py``.
:func:`layer_norm` is one wrapper around two implementations of the same
function:

- on a CUDA tensor, the hand-written kernel ``csrc/layer_norm.cu``
  (one block per row; the row is read once and written once);
- on a CPU tensor, :func:`layer_norm_reference`, the plain PyTorch
  version (the port of ``_dense_reference``).

A CUDA tensor never takes the plain version: the kernel launches or the
call raises.  The output is fp32 for any input dtype, as the models'
``nn.LayerNorm(dtype=jnp.float32)`` convention has it.

:func:`layer_norm` is differentiable through a
:class:`torch.autograd.Function` whose backward recomputes the gradients
through :func:`layer_norm_reference`, as the JAX package's
``_fused_ln_bwd`` does through ``_dense_reference``: the JAX package has
no LayerNorm backward kernel, so neither does the port.
"""

from __future__ import annotations

import torch
from torch import nn

from . import kernels

# Kernel launches since the last reset (the serving smoke run resets it,
# drives the main path, and reads it back).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_H = 56 * 1024   # the kernel keeps one fp32 row in shared memory


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """fp32 LayerNorm: mean, biased variance, ``rsqrt(var + eps)``."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return (centered * torch.rsqrt(var + eps) * scale.to(torch.float32)
            + bias.to(torch.float32))


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu, got {x.device}")
    H = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm takes fp32/bf16/fp16, got {x.dtype}")
    if scale.shape != (H,) or bias.shape != (H,):
        raise ValueError(f"scale/bias must be [{H}], got "
                         f"{tuple(scale.shape)} / {tuple(bias.shape)}")
    if not 0 < H <= _MAX_H:
        raise ValueError(f"layer_norm takes 0 < H <= {_MAX_H}, got {H}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    x = x.contiguous()
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rows = x.numel() // H
    if rows == 0:
        return out
    kernels.launch(
        "layer_norm_fwd", x.device, x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), rows, H, float(eps),
        _DTYPE_CODE[x.dtype])
    global launches
    launches += 1
    return out


class _LayerNorm(torch.autograd.Function):
    """``jax.custom_vjp`` of ``_fused_ln``: the kernel forward, and a
    backward that differentiates the plain version at the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = layer_norm_reference(*saved, ctx.eps)
        grads = torch.autograd.grad(y, saved, g)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of ``x`` [..., H] with ``scale``/``bias`` [H]; fp32 out;
    differentiable in all three.  Without a gradient to record (the
    serving path runs under ``no_grad``) the forward runs bare, without
    the autograd node's host cost."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _forward(x, scale, bias, eps)


class LayerNorm(nn.Module):
    """fp32 LayerNorm with flax's parameter names (``scale``, ``bias``),
    so the JAX package's ``ln_*`` subtrees load onto it unchanged.
    ``fused`` routes through :func:`layer_norm` (the kernel); otherwise
    the plain version runs on every device."""

    def __init__(self, features: int, *, fused: bool = False,
                 eps: float = 1e-6, device=None):
        super().__init__()
        self.fused = fused
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return layer_norm(x, self.scale, self.bias, self.eps)
        return layer_norm_reference(x, self.scale, self.bias, self.eps)
