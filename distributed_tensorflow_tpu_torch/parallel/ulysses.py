"""Ulysses attention: sequence (context) parallelism over the ``seq`` mesh
axis by two all-to-alls.

Counterpart of ``distributed_tensorflow_tpu/parallel/ulysses.py`` (the
DeepSpeed-Ulysses layout), single-controller as :mod:`.ring` is: one
process drives every shard, and an all-to-all is a re-indexing of head
and sequence blocks with a copy to the device that receives each block
(none where both shards share a device).

- Activations arrive sequence-sharded: shard ``i`` holds [B, S/n, H, D].
  The first all-to-all sends head block ``j`` of every shard to seq
  device ``j``, which then holds the FULL sequence for H/n heads
  ([B, S, H/n, D]; the key mask is all-gathered).
- Attention over the full sequence runs there with no collective:
  :func:`..ops.flash_attention.flash_attention` (the flash kernels K1
  forward and K2a/K2b backward on the card, their plain versions for a
  CPU tensor), or the dense formulation with ``use_flash=False``.
- The inverse all-to-all sends sequence block ``i`` of every head block
  back to shard ``i``, [B, S/n, H, D].

Heads (per model shard under tensor parallelism) must divide by the
``seq`` size.  Autograd differentiates the re-indexing; the flash
function brings its own backward.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.flash_attention import (attention_valid, dense_attention,
                                   flash_attention)
from .mesh import MODEL_AXIS, SEQ_AXIS, Mesh
from .ring import over_mesh


def ulysses_attention_local(q: list, k: list, v: list,
                            kv_mask: list | None = None, *, devices: list,
                            axis_name: str = SEQ_AXIS, causal: bool = False,
                            window: int = 0,
                            use_flash: bool | None = None) -> list:
    """Exact attention over one column of sequence shards by head/sequence
    all-to-all.  ``q``, ``k``, ``v``: the n shards [B, S/n, H, D], shard
    i on ``devices[i]`` holding global positions [i S/n, (i + 1) S/n);
    ``kv_mask``: the n mask shards [B, S/n] (nonzero = attend) or None.
    Returns the n output shards in q's dtype.  ``use_flash`` (default
    True) runs the gathered-sequence attention through the flash
    function; ``False`` keeps the dense formulation."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    n = len(q)
    H = q[0].shape[2]
    if H % n:
        raise ValueError(
            f"ulysses attention needs heads ({H}) divisible by the "
            f"'{axis_name}' axis size ({n}); use the ring backend otherwise")
    hb, s_loc = H // n, q[0].shape[1]

    def seq_to_heads(xs):
        # Head block j of every shard -> device j; the sequence blocks
        # concatenate in shard order, which is global order.
        return [torch.cat([x[:, :, j * hb:(j + 1) * hb].to(devices[j])
                           for x in xs], dim=1) for j in range(n)]

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    masks = [None] * n
    if kv_mask is not None:
        masks = [torch.cat([m.to(devices[j]) for m in kv_mask], dim=1)
                 for j in range(n)]
    outs = []
    for j in range(n):
        if use_flash is None or use_flash:
            out = flash_attention(qh[j], kh[j], vh[j], masks[j],
                                  causal=causal, window=window)[0]
        else:
            out = _dense_local(qh[j], kh[j], vh[j], masks[j], causal, window)
        outs.append(out)
    # The inverse: sequence block i of every head block -> shard i.
    return [torch.cat([o[:, i * s_loc:(i + 1) * s_loc].to(devices[i])
                       for o in outs], dim=2) for i in range(n)]


def _dense_local(q, k, v, kv_mask, causal, window=0):
    """Dense softmax attention with fp32 logits and normalizer, the xla
    backend's semantics (fully masked rows give 0)."""
    B, S = q.shape[0], q.shape[1]
    valid = attention_valid(B, S, kv_mask, causal=causal, window=window,
                            device=q.device)
    return dense_attention(q, k, v, valid)[0]


def make_ulysses_attention(
    mesh: Mesh,
    *,
    causal: bool = False,
    window: int = 0,
    heads_sharded: bool = False,
    use_flash: bool | None = None,
) -> Callable[..., torch.Tensor]:
    """Build ``fn(q, k, v, kv_mask=None) -> out`` over a (data, seq[,
    model]) mesh.  Inputs are global [B, S, H, D] tensors: batch splits
    over ``data``, sequence over ``seq`` and, with ``heads_sharded``,
    heads over ``model``, so the all-to-all runs per model column (its
    local heads must still divide by the ``seq`` size)."""
    n_seq = mesh.shape[SEQ_AXIS]
    n_model = mesh.shape.get(MODEL_AXIS, 1) if heads_sharded else 1

    def local(qs, ks, vs, masks, devices):
        return ulysses_attention_local(qs, ks, vs, masks, devices=devices,
                                       causal=causal, window=window,
                                       use_flash=use_flash)

    def attention(q, k, v, kv_mask=None):
        S, H = q.shape[1], q.shape[2]
        if S % n_seq:
            raise ValueError(
                f"sequence length {S} not divisible by seq axis {n_seq}")
        if (H // n_model) % n_seq:
            raise ValueError(
                f"ulysses attention needs heads per shard ({H}//{n_model}) "
                f"divisible by the seq axis size ({n_seq})")
        return over_mesh(mesh, local, heads_sharded=heads_sharded, q=q, k=k,
                         v=v, kv_mask=kv_mask)

    return attention

