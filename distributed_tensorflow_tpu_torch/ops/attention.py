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
- ``"ring"``: sequence-parallel exact attention over the ``seq`` axis of
  a mesh (:mod:`..parallel.ring`), passed as ``mesh=`` or made the default
  by :func:`attention_mesh`; each hop runs the ring's chunk kernels.
- ``"ulysses"``: not ported yet (it runs the K1/K2 kernels behind an
  all-to-all and ports no kernel of its own); raises.

Masks: ``kv_mask`` is the key-padding form [B, S] (nonzero = attend)
accepted by every backend; the general ``mask`` (broadcastable to
[B, H, S, S]) is ``xla``-only.  ``causal`` composes with either.
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from ..parallel.ring import make_ring_attention
from .flash_attention import (attention_valid, dense_attention,
                              flash_attention)

# Mesh used by the ring backend when callers cannot thread one through (the
# model configures attention by string).  Set by attention_mesh().
_DEFAULT_MESH = None


@contextlib.contextmanager
def attention_mesh(mesh):
    """Make ``mesh`` the default for the ``ring`` backend.  A GPT block
    captures the mesh at its first call (``GptBlock.forward``), as a jitted
    JAX program captures it when traced, so later calls (and the backward's
    recomputation under remat) need no context."""
    global _DEFAULT_MESH
    prev = _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    try:
        yield
    finally:
        _DEFAULT_MESH = prev


def default_mesh():
    """The mesh of the innermost :func:`attention_mesh`, or None."""
    return _DEFAULT_MESH


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
    mesh=None,
) -> torch.Tensor:
    """Multi-head scaled dot-product attention, batch-major BSHD layout.

    ``window`` > 0 (requires ``causal``) is sliding-window attention: each
    query sees its ``window`` most recent keys only.  ``mesh`` (``ring``
    only; default: :func:`attention_mesh`'s) is a ``parallel.mesh.Mesh``
    with a ``seq`` axis."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if backend == "pallas":
        if mask is not None:
            raise ValueError("pallas backend supports kv_mask/causal, not a "
                             "full [B,H,S,S] mask")
        out, _ = flash_attention(q, k, v, kv_mask, causal=causal,
                                 window=window)
        return out
    if backend == "ulysses":
        raise NotImplementedError(
            "attention backend 'ulysses' (sequence parallelism by "
            "all-to-all) is not ported yet; see ROADMAP.md, PyTorch port")
    if backend == "ring":
        if mask is not None:
            raise ValueError("ring backend supports kv_mask/causal, not a "
                             "full [B,H,S,S] mask")
        if mesh is None:
            mesh = _DEFAULT_MESH
        if mesh is None:
            raise ValueError("ring backend needs mesh= (with a 'seq' axis), "
                             "passed directly or via attention_mesh(...)")
        n_model = mesh.shape.get(MODEL_AXIS, 1)
        if (q.shape[0] % mesh.shape.get(DATA_AXIS, 1)
                or q.shape[1] % mesh.shape.get(SEQ_AXIS, 1)):
            # Shapes that do not tile the mesh (ragged eval tails) take the
            # dense path: both are exact attention, so this changes layout,
            # never math.
            backend = "xla"
        else:
            return make_ring_attention(
                mesh, causal=causal, window=window,
                heads_sharded=n_model > 1 and q.shape[2] % n_model == 0)(
                    q, k, v, kv_mask)
    if backend != "xla":
        raise ValueError(f"Unknown attention backend: {backend!r}")

    B, S = q.shape[0], q.shape[1]
    valid = attention_valid(B, S, kv_mask, causal=causal, window=window,
                            device=q.device)
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    return dense_attention(q, k, v, valid)[0]
