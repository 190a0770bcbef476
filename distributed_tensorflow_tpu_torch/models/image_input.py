"""Shared image-input handling for the vision models; the counterpart of
``distributed_tensorflow_tpu/models/image_input.py``."""

from __future__ import annotations

import torch


def to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """Normalize an image batch to unit-scale float32.

    Float inputs are already unit-scaled by the data pipeline; integer
    inputs are the uint8 feed path (``--feed_dtype=uint8`` ships raw bytes
    host→device, 4x fewer feed bytes) and divide by 255 on the device.
    """
    if not torch.is_floating_point(x):
        return x.to(torch.float32) * (1.0 / 255.0)
    return x.to(torch.float32)
