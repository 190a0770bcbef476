"""Shared image-input handling for the vision models; the counterpart of
``distributed_tensorflow_tpu/models/image_input.py``, with the pieces the
convolutional models share: flax's ``nn.Conv`` (:class:`Conv`) and its
default initializer (:func:`lecun_normal_`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """Normalize an image batch to unit-scale float32.

    Float inputs are already unit-scaled by the data pipeline; integer
    inputs are the uint8 feed path (``--feed_dtype=uint8`` ships raw bytes
    host→device, 4x fewer feed bytes) and divide by 255 on the device.
    """
    if not torch.is_floating_point(x):
        return x.to(torch.float32) * (1.0 / 255.0)
    return x.to(torch.float32)


def nhwc_images(x: torch.Tensor, size: int, channels: int) -> torch.Tensor:
    """A batch of flat ``size * size * channels`` vectors (the pipelines'
    HWC rows) or images as [B, size, size, channels] unit-scale fp32, the
    JAX models' NHWC input."""
    if x.dim() == 2:
        x = x.reshape(-1, size, size, channels)
    return to_unit_float(x)


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel initializer in place: truncated normal (+-2
    sigma) with variance ``1 / fan_in``, drawn in fp32 on ``t``'s device
    from ``generator`` (a generator on that device)."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return t.copy_(w)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis (``lax.padtype_to_pads``):
    the output is ``ceil(size / stride)`` and the padding, low then high,
    puts the odd element on the high side, so a stride-2 3x3 conv on 32
    pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC images: ``kernel`` [kh, kw, in, out]
    (HWIO, flax's layout, so a checkpoint tree loads unchanged) and
    ``bias`` [out].  The computation is ``F.conv2d`` (cuDNN on the card)
    on NCHW: :meth:`forward` takes and gives NCHW tensors, the kernel
    permuted to OIHW at each call; ``padding`` is ``"SAME"`` (XLA's
    pads, asymmetric where the total is odd) or ``"VALID"``."""

    def __init__(self, features_in: int, features_out: int,
                 kernel_size: tuple[int, int], strides: tuple[int, int] = (1, 1),
                 padding: str = "SAME", use_bias: bool = True, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding = padding
        self.kernel = nn.Parameter(torch.zeros(
            *self.kernel_size, features_in, features_out, dtype=torch.float32,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(features_out,
                                              dtype=torch.float32,
                                              device=device))
                     if use_bias else None)

    @property
    def fan_in(self) -> int:
        return math.prod(self.kernel.shape[:3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (kh, kw), (sh, sw) = self.kernel_size, self.strides
            top, bottom = same_pads(x.shape[2], kh, sh)
            left, right = same_pads(x.shape[3], kw, sw)
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        stride=self.strides)
