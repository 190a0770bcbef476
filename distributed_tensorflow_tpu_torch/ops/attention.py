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
- ``"ulysses"``: sequence-parallel exact attention by head/sequence
  all-to-all (:mod:`..parallel.ulysses`); needs a mesh as ``ring`` does;
  the gathered sequence runs through the flash kernels K1 and K2a/K2b.

With ``seq`` across worker processes (``parallel/mesh.global_mesh``) the
inputs are this rank's sequence block and ``ring`` runs over the seq
group's ranks; ``ulysses``' all-to-all across them is ROADMAP.md's 8f.

``ring`` and ``ulysses`` take shapes that do not tile the mesh as the JAX
package does, by the dense path, on the CPU only.  On the card a ragged
batch or sequence runs the flash kernels over the whole sequence, and
local heads that the ``seq`` axis does not divide go to the ring.

Masks: ``kv_mask`` is the key-padding form [B, S] (nonzero = attend)
accepted by every backend; the general ``mask`` (broadcastable to
[B, H, S, S]) is ``xla``-only.  ``causal`` composes with either.
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                             cross_process_error)
from ..parallel.ring import make_ring_attention
from ..parallel.ulysses import make_ulysses_attention
from .flash_attention import (attention_valid, dense_attention,
                              flash_attention)

# Mesh used by the ring and ulysses backends when callers cannot thread one through (the
# model configures attention by string).  Set by attention_mesh().
_DEFAULT_MESH = None


@contextlib.contextmanager
def attention_mesh(mesh):
    """Make ``mesh`` the default for the ``ring`` and ``ulysses``
    backends.  A GPT block captures the mesh at its first call
    (``GptBlock.forward``), as a jitted JAX program captures it when
    traced, so later calls (and the backward's recomputation under remat)
    need no context."""
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


def _heads_sharded(mesh, q: torch.Tensor) -> bool:
    n_model = mesh.shape.get(MODEL_AXIS, 1)
    return n_model > 1 and q.shape[2] % n_model == 0


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
    and ``ulysses``; default: :func:`attention_mesh`'s) is a
    ``parallel.mesh.Mesh`` with a ``seq`` axis; with a ``model`` axis
    that divides the heads, each model column attends over its own heads
    (``heads_sharded``)."""
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
        if mask is not None:
            raise ValueError(f"{backend} backend supports kv_mask/causal, "
                             "not a full [B,H,S,S] mask")
        if mesh is None:
            mesh = _DEFAULT_MESH
        if mesh is None:
            raise ValueError(f"{backend} backend needs mesh= (with a 'seq' "
                             "axis), passed directly or via attention_mesh(...)")
        if mesh.crosses(SEQ_AXIS):
            if backend == "ulysses":
                raise cross_process_error("ulysses' all-to-all over seq")
            return make_ring_attention(
                mesh, causal=causal, window=window,
                heads_sharded=_heads_sharded(mesh, q))(q, k, v, kv_mask)
        n_data = mesh.shape.get(DATA_AXIS, 1)
        n_seq = mesh.shape.get(SEQ_AXIS, 1)
        # Compose with tensor parallelism: when the heads divide the model
        # axis, each model column runs its own attention over its heads.
        n_model = mesh.shape.get(MODEL_AXIS, 1)
        heads_sharded = _heads_sharded(mesh, q)
        local_heads = q.shape[2] // (n_model if heads_sharded else 1)
        ragged = q.shape[0] % n_data or q.shape[1] % n_seq
        if q.is_cuda and not ragged and backend == "ulysses" and (
                local_heads % n_seq):
            # Head counts the all-to-all cannot split: on the card the
            # ring takes them (it has no head constraint), so the work
            # stays on the chunk kernels and sequence-parallel.
            backend = "ring"
        if ragged or (backend == "ulysses" and local_heads % n_seq):
            # Shapes that do not tile the mesh (ragged eval tails, and on
            # the CPU head counts the all-to-all cannot split) are exact
            # attention over the whole sequence, so this changes layout,
            # never math: the flash kernels on the card, the dense path
            # (the JAX package's dispatch) on the CPU.
            if q.is_cuda:
                out, _ = flash_attention(q, k, v, kv_mask, causal=causal,
                                         window=window)
                return out
            backend = "xla"
        elif backend == "ring":
            return make_ring_attention(mesh, causal=causal, window=window,
                                       heads_sharded=heads_sharded)(
                                           q, k, v, kv_mask)
        else:
            return make_ulysses_attention(mesh, causal=causal, window=window,
                                          heads_sharded=heads_sharded)(
                                              q, k, v, kv_mask)
    if backend != "xla":
        raise ValueError(f"Unknown attention backend: {backend!r}")

    B, S = q.shape[0], q.shape[1]
    valid = attention_valid(B, S, kv_mask, causal=causal, window=window,
                            device=q.device)
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    return dense_attention(q, k, v, valid)[0]
