"""ResNet-20 for CIFAR-10 (``BASELINE.json`` config #4, sync replicas);
the counterpart of ``distributed_tensorflow_tpu/models/resnet.py``.

The classic CIFAR ResNet: 3 stages x 3 basic blocks, widths 16/32/64.
The convolutions run on NCHW (:class:`.image_input.Conv`, kernels in
flax's HWIO layout, XLA's ``SAME`` pads: the strided 3x3 ``conv1`` of a
stage's first block pads (0, 1), the 1x1 ``proj`` nothing).

:class:`BatchNorm` is flax's ``nn.BatchNorm`` written out, not
``nn.BatchNorm2d``: ``scale`` and ``bias`` are parameters, ``mean`` and
``var`` buffers (the JAX ``batch_stats``); epsilon 1e-5; in ``train()``
mode the batch's mean and BIASED variance (``E[x^2] - E[x]^2``, clipped at
0, flax's fast variance) normalise, and the running statistics move as
``0.9 * running + 0.1 * batch`` (``nn.BatchNorm2d`` would keep an unbiased
running variance); in ``eval()`` mode the running statistics normalise.

Synchronised statistics: JAX takes a training step's statistics over the
global batch (the ``data`` axis under GSPMD).  The port's data axis is
the sync trainer's worker processes, each holding its share of the
rows, so in training the per-channel sum and sum of squares (with the
row count) are all-reduced over the process group of the step's
``parallel.sync.GradientAllReduce`` (:func:`_moments`), and autograd
all-reduces their gradients in the backward.  Every worker then
normalises with the same statistics and its running statistics stay
bit-equal to the others'.  Without a group (or with one worker) it is
plain BatchNorm.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..training.state import flat_names, nested_tree
from ..utils.device import resolve_device
from .gpt import Dense
from .image_input import Conv, lecun_normal_, nhwc_images

EPSILON = 1e-5
MOMENTUM = 0.9


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` (SUM) over a process group, differentiable: every
    rank's copy of the sum takes every rank's rows, so its gradient is the
    sum of the ranks' incoming gradients.  (The same as
    ``torch.distributed.nn.functional.all_reduce``, which is deprecated.)"""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _moments(x: torch.Tensor, reduce) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(E[x], E[x^2])`` of NCHW ``x`` over every worker's
    rows: one all-reduce of ``[sum, sum of squares, count]``."""
    if reduce is None or reduce.world_size == 1:
        return x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
    C = x.shape[1]
    count = x.new_tensor([x.numel() / C])
    buf = _SumOverRanks.apply(torch.cat([x.sum(dim=(0, 2, 3)),
                                         (x * x).sum(dim=(0, 2, 3)), count]),
                              reduce.group)
    return buf[:C] / buf[2 * C], buf[C:2 * C] / buf[2 * C]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of NCHW activations (see the module doc)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                             device=device))
        self.register_buffer("mean", torch.zeros(features,
                                                 dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32,
                                               device=device))

    def forward(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        # flax's statistics dtype: at least fp32 (a float64 input stays).
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, mean2 = _moments(x, reduce)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(MOMENTUM).add_((1.0 - MOMENTUM)
                                              * mean.detach())
                self.var.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * var.detach())
        else:
            mean, var = self.mean, self.var
        C = x.shape[1]
        mul = torch.rsqrt(var + EPSILON) * self.scale
        return ((x - mean.view(1, C, 1, 1)) * mul.view(1, C, 1, 1)
                + self.bias.view(1, C, 1, 1))


class BasicBlock(nn.Module):
    def __init__(self, features_in: int, filters: int,
                 strides: tuple[int, int] = (1, 1), device=None):
        super().__init__()
        self.conv1 = Conv(features_in, filters, (3, 3), strides,
                          use_bias=False, device=device)
        self.bn1 = BatchNorm(filters, device)
        self.conv2 = Conv(filters, filters, (3, 3), use_bias=False,
                          device=device)
        self.bn2 = BatchNorm(filters, device)
        if features_in != filters or tuple(strides) != (1, 1):
            self.proj = Conv(features_in, filters, (1, 1), strides,
                             padding="VALID", use_bias=False, device=device)
            self.bn_proj = BatchNorm(filters, device)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), reduce))
        y = self.bn2(self.conv2(y), reduce)
        residual = x
        if self.proj is not None:
            residual = self.bn_proj(self.proj(x), reduce)
        return torch.relu(y + residual)


STAGES = ((16, (1, 1)), (32, (2, 2)), (64, (2, 2)))


class ResNet20(nn.Module):
    """The module's attribute names are flax's (``conv0``, ``bn0``,
    ``stage{s}_block{b}``, ``head``), so its ``state_dict`` names join the
    JAX tree's paths with dots.  ``forward(x, reduce)``: ``reduce`` (a
    ``parallel.sync.GradientAllReduce``) synchronises the training-mode
    statistics over its workers."""

    def __init__(self, num_classes: int = 10, *, seed: int = 0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv0 = Conv(3, 16, (3, 3), use_bias=False, device=device)
        self.bn0 = BatchNorm(16, device)
        features = 16
        self.blocks = []
        for stage, (filters, first_stride) in enumerate(STAGES):
            for block in range(3):
                strides = first_stride if block == 0 else (1, 1)
                name = f"stage{stage}_block{block}"
                setattr(self, name, BasicBlock(features, filters, strides,
                                               device))
                self.blocks.append(name)
                features = filters
        self.head = Dense((64,), (num_classes,), dtype=None,
                          param_dtype=torch.float32, device=device)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """flax's defaults: LeCun-normal kernels, zero biases, BatchNorm
        scale 1 / bias 0 and running statistics 0 / 1, drawn from a
        generator on the model's device seeded by ``seed``."""
        device = self.conv0.kernel.device
        g = torch.Generator(device=device).manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, (Conv, Dense)):
                lecun_normal_(module.kernel, module.fan_in, g)

    def forward(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        x = nhwc_images(x, 32, 3).permute(0, 3, 1, 2)       # NCHW
        x = torch.relu(self.bn0(self.conv0(x), reduce))
        for name in self.blocks:
            x = getattr(self, name)(x, reduce)
        return self.head(x.mean(dim=(2, 3)))


def batch_stats(model: nn.Module) -> dict:
    """The model's running statistics, ``{buffer name: tensor}`` (the
    tensors themselves: ``TrainState.model_state``)."""
    return dict(model.named_buffers())


def params_from_jax(params: dict, batch_stats: dict | None = None) -> dict:
    """The JAX ResNet-20's ``params`` (and ``batch_stats``) trees, arrays
    or a restored checkpoint's tensors -> a ``state_dict`` of this module
    (parameters and, with ``batch_stats``, the running-statistics
    buffers), fp32 CPU tensors."""
    out = flat_names(params)
    if batch_stats is not None:
        out.update(flat_names(batch_stats))
    return out


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_jax` for either part (fp32 numpy
    leaves under flax's names)."""
    return nested_tree(state_dict)
