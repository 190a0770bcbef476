"""Where the port's entry points run: the GPU unless the caller asks for
the CPU.  There is no silent fallback: without CUDA and without an
explicit ``device``, the entry point raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
