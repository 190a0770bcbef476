"""Attention entry point: the ``xla`` formula in plain PyTorch, or the
flash-attention kernel.

Counterpart of ``distributed_tensorflow_tpu/ops/attention.py``, with the
same functional entry point and backends:

- ``"xla"`` (default): dense attention in plain tensor code; logits and
  softmax in fp32 whatever the activation dtype.  The name is kept so a
  config written for the JAX package means the same here.
- ``"pallas"``: the blockwise flash-attention kernels
  (:mod:`.flash_attention`, hand-written CUDA on the GPU), differentiable:
  the backward runs the FlashAttention-2 dq and dk/dv kernels.  It takes
  every sequence length; there is no dense fallback for odd shapes.
- ``"ring"`` / ``"ulysses"``: sequence parallelism has not been ported
  yet and raises.

Masks: ``kv_mask`` is the key-padding form [B, S] (nonzero = attend)
accepted by every backend; the general ``mask`` (broadcastable to
[B, H, S, S]) is ``xla``-only.  ``causal`` composes with either.
"""

from __future__ import annotations

import torch

from .flash_attention import (attention_valid, dense_attention,
                              flash_attention)


def dot_product_attention(
    q: torch.Tensor,                    # [B, S, H, D]
    k: torch.Tensor,                    # [B, S, H, D]
    v: torch.Tensor,                    # [B, S, H, D]
    mask: torch.Tensor | None = None,   # broadcastable to [B, H, S, S]
    kv_mask: torch.Tensor | None = None,   # [B, S]; nonzero = attend
    *,
    causal: bool = False,
    window: int = 0,
    backend: str = "xla",
) -> torch.Tensor:
    """Multi-head scaled dot-product attention, batch-major BSHD layout.

    ``window`` > 0 (requires ``causal``) is sliding-window attention: each
    query sees its ``window`` most recent keys only."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if backend == "pallas":
        if mask is not None:
            raise ValueError("pallas backend supports kv_mask/causal, not a "
                             "full [B,H,S,S] mask")
        out, _ = flash_attention(q, k, v, kv_mask, causal=causal,
                                 window=window)
        return out
    if backend in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention backend {backend!r} (sequence parallelism) is not "
            "ported yet; see ROADMAP.md, PyTorch port")
    if backend != "xla":
        raise ValueError(f"Unknown attention backend: {backend!r}")

    B, S = q.shape[0], q.shape[1]
    valid = attention_valid(B, S, kv_mask, causal=causal, window=window,
                            device=q.device)
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    return dense_attention(q, k, v, valid)[0]
