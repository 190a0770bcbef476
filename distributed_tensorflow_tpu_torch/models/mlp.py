"""MNIST 2-layer MLP, the reference model; the counterpart of
``distributed_tensorflow_tpu/models/mlp.py`` (reference
``distributed.py:65-87``).

Parity notes, as in the JAX module:
- ``hid`` kernel [784, hidden], truncated normal (±2 stddev) with stddev
  1/28, bias zeros (``distributed.py:67-69``);
- ``sm`` kernel [hidden, 10], truncated normal with stddev
  1/sqrt(hidden), bias zeros (``distributed.py:71-73``);
- forward: relu(x·W+b) → logits (``distributed.py:78-81``);
- the reference softmaxes the output and then feeds it to a softmax cross
  entropy (``:81``, ``:86``); :func:`cross_entropy_loss` takes raw logits
  unless ``double_softmax=True`` reproduces that.

The kernels keep flax's ``[in, out]`` layout and names (``hid.kernel``,
``hid.bias``, ``sm.kernel``, ``sm.bias``), so :func:`params_from_jax`
and :func:`params_to_jax` are renames, and a checkpoint of either package
restores into the other.  The two products are plain ``torch`` matmuls:
the JAX model's ``nn.Dense`` is plain XLA, no Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .image_input import to_unit_float

IMAGE_PIXELS = 28
NUM_CLASSES = 10


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with kernel ``[in, out]``."""

    def __init__(self, features_in: int, features_out: int, stddev: float,
                 generator: torch.Generator, device=None):
        super().__init__()
        kernel = torch.empty(features_in, features_out, dtype=torch.float32)
        nn.init.trunc_normal_(kernel, std=stddev, a=-2.0 * stddev,
                              b=2.0 * stddev, generator=generator)
        self.kernel = nn.Parameter(kernel.to(device))
        self.bias = nn.Parameter(torch.zeros(features_out,
                                             dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.bias, x, self.kernel)


class MnistMLP(nn.Module):
    """784 → hidden (relu) → 10, with the reference's initializers drawn
    from ``torch.Generator().manual_seed(seed)`` on the CPU (so a seed gives
    the same weights on every device and in every worker; not the JAX
    package's init, whose PRNG differs)."""

    def __init__(self, hidden_units: int = 100, *, seed: int = 0,
                 device=None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.hidden_units = hidden_units
        self.hid = Dense(IMAGE_PIXELS * IMAGE_PIXELS, hidden_units,
                         1.0 / IMAGE_PIXELS, g, device)
        self.sm = Dense(hidden_units, NUM_CLASSES,
                        1.0 / math.sqrt(float(hidden_units)), g, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_unit_float(x.reshape(x.shape[0], -1))
        return self.sm(torch.relu(self.hid(x)))


def cross_entropy_loss(logits: torch.Tensor, labels_onehot: torch.Tensor,
                       double_softmax: bool = False,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy (``distributed.py:86-87``).

    ``double_softmax=True`` reproduces the reference's quirk of softmaxing
    the network output before the softmax-cross-entropy op.
    ``label_smoothing`` mixes the one-hot targets with the uniform
    distribution (``(1-a)*onehot + a/K``)."""
    if double_softmax:
        logits = torch.softmax(logits, dim=-1)
    if label_smoothing > 0.0:
        k = labels_onehot.shape[-1]
        labels_onehot = ((1.0 - label_smoothing) * labels_onehot
                         + label_smoothing / k)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels_onehot * logp, dim=-1))


def accuracy(logits: torch.Tensor, labels_onehot: torch.Tensor
             ) -> torch.Tensor:
    """argmax-equal-mean accuracy (``distributed.py:83-84``)."""
    correct = logits.argmax(-1) == labels_onehot.argmax(-1)
    return correct.to(torch.float32).mean()


def params_from_jax(tree: dict) -> dict:
    """The JAX package's MLP parameter tree (``{"hid": {"kernel", "bias"},
    "sm": {...}}``, arrays or a restored checkpoint's tensors) -> this
    module's ``state_dict`` (fp32 CPU tensors)."""
    out = {}
    for layer, leaves in tree.items():
        for name, leaf in leaves.items():
            t = (leaf.detach() if isinstance(leaf, torch.Tensor)
                 else torch.from_numpy(np.array(leaf, np.float32)))
            out[f"{layer}.{name}"] = t.to("cpu", torch.float32)
    return out


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_jax`: nested dicts of fp32 numpy
    arrays with the JAX package's names."""
    tree: dict = {}
    for name, t in state_dict.items():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = (
            t.detach().to("cpu", torch.float32).numpy())
    return tree
