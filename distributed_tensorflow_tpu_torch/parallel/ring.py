"""Ring attention: sequence (context) parallelism over the ``seq`` mesh
axis.

Counterpart of ``distributed_tensorflow_tpu/parallel/ring.py``.  There
the ring is a ``shard_map`` over a mesh of devices in one process and a
hop is ``jax.lax.ppermute``; here one process drives every shard of the
mesh as well (single controller), and a hop is a copy of each shard's
K/V chunk to the device that receives it (a re-indexing where both
shards live on one device, as in ``create_mesh(seq=4, devices=[cuda0] *
4)``).  The design is the JAX package's:

- The sequence dimension is split over ``seq``: shard ``i`` holds the
  contiguous block ``i`` of queries, keys and values (and of the
  key-padding mask).  Batch is split over ``data``; each data shard runs
  its own ring.
- Queries stay put; K/V chunks travel the ring one hop per step, each
  hop issued before the step's compute.  An online-softmax carry
  ``(m, l, acc)`` folds each visiting chunk in, so attention is exact.
- On the flash path (the default) each hop is the chunk kernel K6
  (:func:`..ops.flash_attention.flash_attention_chunk`), and the
  backward is hand-rolled as in JAX: ``delta = sum(dO * out)`` once, then
  per hop the dq kernel K7a (dq accumulates locally) and the dk/dv kernel
  K7b, whose partials travel the ring with their chunk and arrive home
  summed.  CPU tensors take the chunk functions' plain versions.
- A causal sliding window truncates the ring to the hops whose chunks can
  meet the band and runs it reversed; the dk/dv partials then take one
  shift home instead of finishing the loop.  Forward and backward share
  one :func:`_ring_schedule`.

The multi-process transport (one rank per card over ``torch.distributed``)
and tensor parallelism (heads over ``model``) are later work (ROADMAP.md,
PyTorch port).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.flash_attention import (flash_attention_chunk,
                                   flash_attention_chunk_dkv,
                                   flash_attention_chunk_dq)
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh

# Finite large-negative instead of -inf: keeps exp()/max() NaN-free for rows
# whose every key is masked (their output is defined as 0).
_MASK_VALUE = -1e30


def _ring_hops(axis_size: int, sk_local: int, causal: bool,
               window: int) -> int:
    """Hops the ring needs.  Full attention: all ``n``.  Causal sliding
    window: query block d only attends chunks [d - h0, d]; the windowed
    ring runs reversed (hop t delivers chunk d - t), so hops ``0..h0``
    cover the band and the ring stops there."""
    if not (causal and window):
        return axis_size
    h0 = (window - 1 + sk_local - 1) // sk_local
    return min(axis_size, h0 + 1)


def _ring_schedule(axis_size: int, sk_local: int, causal: bool, window: int):
    """One definition of the ring schedule, shared by the forward and the
    backward (they must agree exactly on hop count, direction and
    permutation, or the gradients silently diverge): returns ``(n_hops,
    perm, src_fn)``.  ``perm`` lists ``(source, destination)`` shard pairs
    of one hop, and ``src_fn(my_block, t)`` is the chunk shard ``my_block``
    holds at hop ``t``."""
    n = axis_size
    n_hops = _ring_hops(n, sk_local, causal, window)
    if n_hops < n:
        perm = [(j, (j + 1) % n) for j in range(n)]
        src_fn = lambda my, t: (my - t) % n
    else:
        perm = [((j + 1) % n, j) for j in range(n)]
        src_fn = lambda my, t: (my + t) % n
    return n_hops, perm, src_fn


def _hop(held: list, perm, devices: list) -> list:
    """One ppermute of ``held`` (one entry per shard): ``out[dst] =
    held[src]`` on ``devices[dst]`` for every pair of ``perm``.  A shard
    on the same device is handed over as it is."""
    out = [None] * len(held)
    for src, dst in perm:
        x = held[src]
        out[dst] = None if x is None else x.to(devices[dst],
                                               non_blocking=True)
    return out


def _ring_einsum(qs, ks, vs, masks, devices, *, causal: bool, window: int):
    """``ring_attention_local``'s einsum formulation: fp32 logits and
    carries, the weights cast to v's dtype for the V product (exact
    products, fp32 sums); differentiable by autograd."""
    n = len(qs)
    B, Sq, H, D = qs[0].shape
    Sk = ks[0].shape[1]
    n_hops, perm, src_fn = _ring_schedule(n, Sk, causal, window)
    if masks[0] is None:
        masks = [torch.ones((B, Sk), dtype=torch.bool, device=d)
                 for d in devices]
    q32 = [q.float() * (1.0 / math.sqrt(D)) for q in qs]
    o = [torch.zeros((B, H, Sq, D), device=d) for d in devices]
    m = [torch.full((B, H, Sq), _MASK_VALUE, device=d) for d in devices]
    l = [torch.zeros((B, H, Sq), device=d) for d in devices]
    held = (ks, vs, [mk != 0 for mk in masks])
    for t in range(n_hops):
        nxt = ([_hop(x, perm, devices) for x in held] if t + 1 < n_hops
               else None)
        for my in range(n):
            k_blk, v_blk, mask_blk = (x[my] for x in held)
            valid = mask_blk[:, None, None, :]            # [B,1,1,Sk]
            if causal:
                q_pos = my * Sq + torch.arange(Sq, device=devices[my])
                k_pos = src_fn(my, t) * Sk + torch.arange(
                    Sk, device=devices[my])
                band = q_pos[:, None] >= k_pos[None, :]
                if window:
                    band = band & (q_pos[:, None] - k_pos[None, :] < window)
                valid = valid & band[None, None]
            logits = torch.einsum("bqhd,bkhd->bhqk", q32[my], k_blk.float())
            logits = torch.where(valid, logits, _MASK_VALUE)
            m_new = torch.maximum(m[my], logits.amax(dim=-1))
            # The valid multiply kills the exp(0) = 1 of rows whose every
            # key so far is masked (m_new still at the mask floor).
            p = torch.exp(logits - m_new[..., None]) * valid
            corr = torch.exp(m[my] - m_new)
            l[my] = l[my] * corr + p.sum(dim=-1)
            o[my] = o[my] * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(),
                v_blk.float())
            m[my] = m_new
        held = nxt
    return [(o[i] / l[i].clamp_min(1e-30)[..., None]).transpose(1, 2)
            .to(qs[i].dtype) for i in range(n)]


class _RingPlan:
    """What a ring's autograd node needs besides its tensors: the shards'
    devices, the key masks (not differentiable), ``causal`` and
    ``window``."""

    def __init__(self, devices, masks, causal: bool, window: int):
        self.devices = devices
        self.masks = masks
        self.causal = causal
        self.window = window


def _ring_flash_forward(plan: _RingPlan, qs, ks, vs):
    """Each shard's output [B, Sq, H, D] in q's dtype and its logsumexp
    [B, H, Sq] fp32, folding every visiting chunk through K6."""
    n, devices = len(qs), plan.devices
    B, Sq, H, D = qs[0].shape
    Sk = ks[0].shape[1]
    n_hops, perm, src_fn = _ring_schedule(n, Sk, plan.causal, plan.window)
    m = [torch.full((B, H, Sq), _MASK_VALUE, device=d) for d in devices]
    l = [torch.zeros((B, H, Sq), device=d) for d in devices]
    acc = [torch.zeros((B, H, Sq, D), device=d) for d in devices]
    held = (ks, vs, plan.masks)
    for t in range(n_hops):
        # Issue the next hop first, as the JAX ring does.
        nxt = ([_hop(x, perm, devices) for x in held] if t + 1 < n_hops
               else None)
        for my in range(n):
            m[my], l[my], acc[my] = flash_attention_chunk(
                qs[my], held[0][my], held[1][my], held[2][my], m[my], l[my],
                acc[my], q_offset=my * Sq, k_offset=src_fn(my, t) * Sk,
                causal=plan.causal, window=plan.window)
        held = nxt
    outs, lses = [], []
    for i in range(n):
        l_safe = l[i].clamp_min(1e-30)          # fully masked rows -> 0
        outs.append((acc[i] / l_safe[..., None]).transpose(1, 2)
                    .to(qs[i].dtype))
        lses.append(m[i] + torch.log(l_safe))
    return outs, lses


def _ring_flash_backward(plan: _RingPlan, qs, ks, vs, outs, lses, douts):
    """(dqs, dks, dvs) per shard: K7a and K7b per hop on the forward's
    schedule; dq accumulates on its shard, the dk/dv partials travel with
    their chunk (one shift home after a truncated ring)."""
    n, devices = len(qs), plan.devices
    Sq, Sk = qs[0].shape[1], ks[0].shape[1]
    n_hops, perm, src_fn = _ring_schedule(n, Sk, plan.causal, plan.window)
    # Softmax-jacobian row term, in the kernels' [B, H, Sq] layout.
    delta = [(do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
             for do, o in zip(douts, outs)]
    dq = [None] * n
    dk, dv = [None] * n, [None] * n
    held = (ks, vs, plan.masks)
    kw = dict(causal=plan.causal, window=plan.window)
    for t in range(n_hops):
        # k/v/mask hops do not depend on this hop's kernels: issue them
        # first (the dk/dv partials do, and hop after).
        nxt = ([_hop(x, perm, devices) for x in held] if t + 1 < n_hops
               else None)
        for my in range(n):
            args = (qs[my], held[0][my], held[1][my], held[2][my],
                    douts[my], lses[my], delta[my])
            offs = dict(q_offset=my * Sq, k_offset=src_fn(my, t) * Sk)
            part = flash_attention_chunk_dq(*args, **offs, **kw)
            dq[my] = part if dq[my] is None else dq[my].add_(part)
            dkc, dvc = flash_attention_chunk_dkv(*args, **offs, **kw)
            dk[my] = dkc if dk[my] is None else dk[my].add_(dkc)
            dv[my] = dvc if dv[my] is None else dv[my].add_(dvc)
        dk, dv = _hop(dk, perm, devices), _hop(dv, perm, devices)
        held = nxt
    if n_hops < n:
        # Truncated (reversed) ring: chunk c stops at shard (c + n_hops) mod
        # n with every in-window contribution summed; one shift sends it
        # home.
        home = [(s, (s - n_hops) % n) for s in range(n)]
        dk, dv = _hop(dk, home, devices), _hop(dv, home, devices)
    return ([g.transpose(1, 2).to(x.dtype) for g, x in zip(dq, qs)],
            [g.transpose(1, 2).to(x.dtype) for g, x in zip(dk, ks)],
            [g.transpose(1, 2).to(x.dtype) for g, x in zip(dv, vs)])


class _RingFlash(torch.autograd.Function):
    """``_make_ring_flash``'s ``custom_vjp``: the ring's n query, key and
    value shards in, its n output shards out.  The forward saves the
    shards, outputs and logsumexps; the backward runs the hand-rolled ring
    backward (the chunk kernels are not differentiable)."""

    @staticmethod
    def forward(ctx, plan, *shards):
        n = len(plan.devices)
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        outs, lses = _ring_flash_forward(plan, qs, ks, vs)
        ctx.plan = plan
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        n = len(ctx.plan.devices)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dqs, dks, dvs = _ring_flash_backward(ctx.plan, qs, ks, vs, outs,
                                             lses, douts)
        return (None, *dqs, *dks, *dvs)


def ring_attention_local(q: list, k: list, v: list, kv_mask: list | None,
                         *, devices: list, causal: bool = False,
                         window: int = 0,
                         use_flash: bool | None = None) -> list:
    """Exact attention over one ring of sequence shards.  ``q``, ``k``,
    ``v``: the ring's n shards [B, S_local, H, D], shard i on
    ``devices[i]`` and holding global positions [i S_local, (i + 1)
    S_local); ``kv_mask``: the n mask shards [B, S_local] (nonzero =
    attend) or None.  Returns the n output shards in q's dtype.

    ``use_flash`` (default True) folds each hop through the chunk kernels
    (their plain versions for CPU tensors), with the ring backward;
    ``False`` takes the einsum formulation, differentiated by autograd.
    ``window`` > 0 (requires ``causal``) truncates the ring to the hops
    whose chunks can meet the band."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    masks = list(kv_mask) if kv_mask is not None else [None] * len(q)
    if use_flash is None or use_flash:
        plan = _RingPlan(list(devices), masks, causal, window)
        return list(_RingFlash.apply(plan, *q, *k, *v))
    return _ring_einsum(list(q), list(k), list(v), masks, list(devices),
                        causal=causal, window=window)


def make_ring_attention(
    mesh: Mesh,
    *,
    causal: bool = False,
    window: int = 0,
    heads_sharded: bool = False,
    use_flash: bool | None = None,
) -> Callable[..., torch.Tensor]:
    """Build ``fn(q, k, v, kv_mask=None) -> out`` over a (data, seq[,
    model]) mesh.

    Inputs are global [B, S, H, D] tensors: batch splits over ``data``,
    sequence over ``seq``, each block is placed on its mesh device (no
    copy where it already lies there), every data shard runs its ring, and
    the output comes back as one global tensor on q's device.  With a
    ``model`` axis (heads not sharded) the rings run on its first
    devices."""
    if heads_sharded:
        raise NotImplementedError(
            "ring attention with heads sharded over the model axis (tensor "
            "parallelism) is not ported yet; see ROADMAP.md, PyTorch port")
    n_data, n_seq = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
    model_index = mesh.axis_names.index(MODEL_AXIS)
    grid = mesh.devices.take(0, axis=model_index)     # [data, seq]

    def attention(q, k, v, kv_mask=None):
        B, S = q.shape[0], q.shape[1]
        if S % n_seq:
            raise ValueError(
                f"sequence length {S} not divisible by seq axis {n_seq}")
        if B % n_data:
            raise ValueError(
                f"batch {B} not divisible by data axis {n_data}")
        b_loc, s_loc = B // n_data, S // n_seq

        def split(t, d):
            # Views of the global tensor (split's backward is one cat), each
            # on its shard's device.
            return [x.to(dev) for x, dev in zip(
                t.split(b_loc)[d].split(s_loc, dim=1), grid[d])]

        outs = []
        for d in range(n_data):
            shards = ring_attention_local(
                split(q, d), split(k, d), split(v, d),
                None if kv_mask is None else split(kv_mask, d),
                devices=list(grid[d]), causal=causal, window=window,
                use_flash=use_flash)
            outs.append(torch.cat([o.to(q.device) for o in shards], dim=1))
        return torch.cat(outs, dim=0)

    return attention
