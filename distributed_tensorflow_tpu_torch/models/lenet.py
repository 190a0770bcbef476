"""LeNet-5 for MNIST (``BASELINE.json`` config #3, async-replica mode);
the counterpart of ``distributed_tensorflow_tpu/models/lenet.py``.

conv(6, 5x5, SAME) -> tanh -> avgpool 2 -> conv(16, 5x5, VALID) -> tanh
-> avgpool 2 -> 120 -> 84 -> 10.  The JAX model is NHWC; here the
convolutions run on NCHW (:class:`.image_input.Conv`, its kernel kept in
flax's HWIO layout) and the activations are put back in NHWC order
before the flatten, so ``fc1``'s 400 inputs come in flax's (h, w, c)
order and every kernel of the JAX tree loads unchanged
(:func:`params_from_jax` only renames).  The convolutions and products
are plain PyTorch: the JAX model reaches no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..training.state import flat_names, nested_tree
from ..utils.device import resolve_device
from .gpt import Dense
from .image_input import Conv, lecun_normal_, nhwc_images


class LeNet5(nn.Module):
    """Weights from flax's default initializers (LeCun-normal kernels,
    zero biases) drawn from a generator on ``device`` seeded by ``seed``;
    not the JAX package's draw, whose PRNG differs."""

    def __init__(self, num_classes: int = 10, *, seed: int = 0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = Conv(1, 6, (5, 5), padding="SAME", device=device)
        self.conv2 = Conv(6, 16, (5, 5), padding="VALID", device=device)
        kw = dict(dtype=None, param_dtype=torch.float32, device=device)
        self.fc1 = Dense((400,), (120,), **kw)
        self.fc2 = Dense((120,), (84,), **kw)
        self.out = Dense((84,), (num_classes,), **kw)
        g = torch.Generator(device=device).manual_seed(int(seed))
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2, self.out):
            lecun_normal_(layer.kernel, layer.fan_in, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_images(x, 28, 1).permute(0, 3, 1, 2)       # NCHW
        x = F.avg_pool2d(torch.tanh(self.conv1(x)), 2, 2)
        x = F.avg_pool2d(torch.tanh(self.conv2(x)), 2, 2)
        # flax flattens NHWC: (h, w, c) order.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.tanh(self.fc1(x))
        x = torch.tanh(self.fc2(x))
        return self.out(x)


def params_from_jax(tree: dict) -> dict:
    """The JAX LeNet-5's parameter tree (``conv1``/``conv2``/``fc1``/
    ``fc2``/``out``, arrays or a restored checkpoint's tensors) -> this
    module's ``state_dict`` (fp32 CPU tensors): the names joined."""
    return flat_names(tree)


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_jax` (fp32 numpy leaves)."""
    return nested_tree(state_dict)
