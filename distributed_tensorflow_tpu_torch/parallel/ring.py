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
  (:func:`..ops.flash_attention.flash_attention_chunk`, updating the
  shard's carries in place), and the
  backward is hand-rolled as in JAX: ``delta = sum(dO * out)`` once and
  zeroed fp32 sums, then per hop the dq kernel K7a (adding into the
  shard's dq in place) and the dk/dv kernel K7b (adding into the dk/dv
  sums that travel the ring with their chunk and arrive home complete).
  CPU tensors take the chunk functions' plain versions.
- A causal sliding window truncates the ring to the hops whose chunks can
  meet the band and runs it reversed; the dk/dv partials then take one
  shift home instead of finishing the loop.  Forward and backward share
  one :func:`_ring_schedule`.

With ``heads_sharded`` (tensor parallelism) each model column runs its
own ring over its heads, as JAX's ``shard_map`` with ``P(data, seq,
model, None)`` does.

**The ring over ranks** (``seq`` across processes,
``parallel/mesh.global_mesh``): each rank holds one shard, its own
sequence block, and runs the same loops over that shard alone; a hop is
one permutation over the seq group (:mod:`.transport`: every rank's send
and receive posted together, K/V and mask issued before the hop's
kernels and waited for after them), the dk/dv sums travel with their
chunk and take their shift home over the same group.  The schedule is a
function of the ring's size and shapes only, so every rank runs the same
one.  K6/K7a/K7b run on each rank's shard as they run in one process.
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
    """What a ring's autograd node needs besides its tensors: the ring's
    size ``n``, the shards this process holds (``mine``: every one in one
    process, its own over ranks), the shards' devices and key masks
    (length-``n`` lists, None where another rank holds the shard; the
    masks are not differentiable), ``causal``, ``window`` and, over
    ranks, the seq axis's :class:`.transport.AxisLink`."""

    def __init__(self, devices, masks, causal: bool, window: int,
                 link=None):
        self.link = link
        self.n = link.size if link is not None else len(devices)
        self.mine = [link.coord] if link is not None \
            else list(range(self.n))
        self.devices = self.full(devices)
        self.masks = self.full(masks)
        self.causal = causal
        self.window = window

    def full(self, xs) -> list:
        """This process's shards as a length-``n`` list."""
        if self.link is None:
            return list(xs)
        out = [None] * self.n
        for i, x in zip(self.mine, xs):
            out[i] = x
        return out

    def start(self, held: list, perm):
        """Issue one hop of ``held`` (a length-``n`` list); returns the
        function that waits for it and gives the held list after it."""
        if self.link is None:
            out = _hop(held, perm, self.devices)
            return lambda: out
        from .transport import start_hop
        my = self.mine[0]
        if held[my] is None:
            return lambda: [None] * self.n
        pending = start_hop(self.link, held[my], perm)

        def done():
            out = [None] * self.n
            out[my] = pending.wait()[0]
            return out
        return done

    def hop(self, held: list, perm) -> list:
        return self.start(held, perm)()

    def empty(self, fn) -> list:
        """``fn(device)`` for each shard this process holds."""
        return [fn(d) if d is not None else None for d in self.devices]


def _ring_flash_forward(plan: _RingPlan, qs, ks, vs):
    """Each shard's output [B, Sq, H, D] in q's dtype and its logsumexp
    [B, H, Sq] fp32, folding every visiting chunk through K6."""
    n, mine = plan.n, plan.mine
    B, Sq, H, D = qs[mine[0]].shape
    Sk = ks[mine[0]].shape[1]
    n_hops, perm, src_fn = _ring_schedule(n, Sk, plan.causal, plan.window)
    m = plan.empty(lambda d: torch.full((B, H, Sq), _MASK_VALUE, device=d))
    l = plan.empty(lambda d: torch.zeros((B, H, Sq), device=d))
    acc = plan.empty(lambda d: torch.zeros((B, H, Sq, D), device=d))
    held = (ks, vs, plan.masks)
    for t in range(n_hops):
        # Issue the next hop first, as the JAX ring does.
        nxt = ([plan.start(x, perm) for x in held] if t + 1 < n_hops
               else None)
        for my in mine:
            # The carries are this ring's own: updated in place, so a
            # chunk in the future of every query costs a launch and no
            # memory traffic.
            m[my], l[my], acc[my] = flash_attention_chunk(
                qs[my], held[0][my], held[1][my], held[2][my], m[my], l[my],
                acc[my], q_offset=my * Sq, k_offset=src_fn(my, t) * Sk,
                causal=plan.causal, window=plan.window, in_place=True)
        held = None if nxt is None else [wait() for wait in nxt]
    outs, lses = [], []
    for i in mine:
        l_safe = l[i].clamp_min(1e-30)          # fully masked rows -> 0
        outs.append((acc[i] / l_safe[..., None]).transpose(1, 2)
                    .to(qs[i].dtype))
        lses.append(m[i] + torch.log(l_safe))
    return outs, lses


def _ring_flash_backward(plan: _RingPlan, qs, ks, vs, outs, lses, douts):
    """(dqs, dks, dvs) per shard: K7a and K7b per hop on the forward's
    schedule, each adding its partial into fp32 sums zeroed once, as the
    JAX ring's ``dq``, ``dk0`` and ``dv0``: dq stays on its shard, the dk/dv
    sums travel with their chunk (one shift home after a truncated ring).
    A hop whose chunk no query sees then touches no memory."""
    n, mine = plan.n, plan.mine
    B, Sq, H, D = qs[mine[0]].shape
    Sk = ks[mine[0]].shape[1]
    n_hops, perm, src_fn = _ring_schedule(n, Sk, plan.causal, plan.window)
    # Softmax-jacobian row term, in the kernels' [B, H, Sq] layout.
    delta = [None if do is None else
             (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
             for do, o in zip(douts, outs)]
    dq = plan.empty(lambda d: torch.zeros((B, H, Sq, D), device=d))
    dk = plan.empty(lambda d: torch.zeros((B, H, Sk, D), device=d))
    dv = plan.empty(lambda d: torch.zeros((B, H, Sk, D), device=d))
    held = (ks, vs, plan.masks)
    kw = dict(causal=plan.causal, window=plan.window)
    for t in range(n_hops):
        # k/v/mask hops do not depend on this hop's kernels: issue them
        # first (the dk/dv partials do, and hop after).
        nxt = ([plan.start(x, perm) for x in held] if t + 1 < n_hops
               else None)
        for my in mine:
            args = (qs[my], held[0][my], held[1][my], held[2][my],
                    douts[my], lses[my], delta[my])
            offs = dict(q_offset=my * Sq, k_offset=src_fn(my, t) * Sk)
            flash_attention_chunk_dq(*args, **offs, **kw, out=dq[my])
            flash_attention_chunk_dkv(*args, **offs, **kw,
                                      out=(dk[my], dv[my]))
        dk, dv = plan.hop(dk, perm), plan.hop(dv, perm)
        held = None if nxt is None else [wait() for wait in nxt]
    if n_hops < n:
        # Truncated (reversed) ring: chunk c stops at shard (c + n_hops) mod
        # n with every in-window contribution summed; one shift sends it
        # home.
        home = [(s, (s - n_hops) % n) for s in range(n)]
        dk, dv = plan.hop(dk, home), plan.hop(dv, home)
    return ([dq[i].transpose(1, 2).to(qs[i].dtype) for i in mine],
            [dk[i].transpose(1, 2).to(ks[i].dtype) for i in mine],
            [dv[i].transpose(1, 2).to(vs[i].dtype) for i in mine])


class _RingFlash(torch.autograd.Function):
    """``_make_ring_flash``'s ``custom_vjp``: the ring's n query, key and
    value shards in, its n output shards out.  The forward saves the
    shards, outputs and logsumexps; the backward runs the hand-rolled ring
    backward (the chunk kernels are not differentiable)."""

    @staticmethod
    def forward(ctx, plan, *shards):
        n = len(plan.mine)
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        outs, lses = _ring_flash_forward(plan, plan.full(qs), plan.full(ks),
                                         plan.full(vs))
        ctx.plan = plan
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        plan = ctx.plan
        n = len(plan.mine)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dqs, dks, dvs = _ring_flash_backward(
            plan, *(plan.full(x) for x in (qs, ks, vs, outs, lses, douts)))
        return (None, *dqs, *dks, *dvs)


def ring_attention_local(q: list, k: list, v: list, kv_mask: list | None,
                         *, devices: list, causal: bool = False,
                         window: int = 0,
                         use_flash: bool | None = None, link=None) -> list:
    """Exact attention over one ring of sequence shards.  ``q``, ``k``,
    ``v``: the ring's n shards [B, S_local, H, D], shard i on
    ``devices[i]`` and holding global positions [i S_local, (i + 1)
    S_local); ``kv_mask``: the n mask shards [B, S_local] (nonzero =
    attend) or None.  Returns the n output shards in q's dtype.

    ``use_flash`` (default True) folds each hop through the chunk kernels
    (their plain versions for CPU tensors), with the ring backward;
    ``False`` takes the einsum formulation, differentiated by autograd.
    ``window`` > 0 (requires ``causal``) truncates the ring to the hops
    whose chunks can meet the band.  ``link`` (the seq axis across
    processes, :mod:`.transport`): the lists hold this rank's one shard,
    shard ``link.coord`` of a ring of ``link.size``."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    masks = list(kv_mask) if kv_mask is not None else [None] * len(q)
    if use_flash is None or use_flash:
        plan = _RingPlan(list(devices), masks, causal, window, link)
        return list(_RingFlash.apply(plan, *q, *k, *v))
    if link is not None:
        raise ValueError("the ring over ranks runs the chunk kernels "
                         "(use_flash); the einsum formulation is one "
                         "process's")
    return _ring_einsum(list(q), list(k), list(v), masks, list(devices),
                        causal=causal, window=window)


def over_mesh(mesh: Mesh, local: Callable, *, heads_sharded: bool,
              q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: torch.Tensor | None) -> torch.Tensor:
    """Run a sequence-parallel ``local(qs, ks, vs, masks, devices)`` over
    ``mesh`` on global [B, S, H, D] tensors, as ``shard_map`` with
    ``P(data, seq, model or None, None)`` does: the batch splits over
    ``data``, the sequence over ``seq`` and, with ``heads_sharded``, the
    heads over ``model``; each (data, model) block's seq shards are views
    of the global tensors placed on its column's devices (no copy where
    they already lie there), and the output comes back as one global
    tensor on q's device.  Without ``heads_sharded`` the blocks run on the
    first model column."""
    n_data, n_seq = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
    n_model = mesh.shape[MODEL_AXIS] if heads_sharded else 1
    B, S, H = q.shape[0], q.shape[1], q.shape[2]
    if S % n_seq:
        raise ValueError(
            f"sequence length {S} not divisible by seq axis {n_seq}")
    if B % n_data:
        raise ValueError(f"batch {B} not divisible by data axis {n_data}")
    if H % n_model:
        raise ValueError(f"heads {H} not divisible by model axis {n_model}")
    b_loc, s_loc, h_loc = B // n_data, S // n_seq, H // n_model
    rows = []
    for d in range(n_data):
        cols = []
        for j in range(n_model):
            grid = mesh.grid(j)[d]

            def split(t, heads=True):
                t = t[d * b_loc:(d + 1) * b_loc]
                if heads:
                    t = t[:, :, j * h_loc:(j + 1) * h_loc]
                # Views of the global tensor (split's backward is one cat).
                return [x.to(dev) for x, dev in zip(t.split(s_loc, dim=1),
                                                    grid)]
            shards = local(split(q), split(k), split(v),
                           None if kv_mask is None else split(kv_mask, False),
                           list(grid))
            cols.append(torch.cat([o.to(q.device) for o in shards], dim=1))
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=0)


def over_ranks(mesh: Mesh, local: Callable, *, heads_sharded: bool,
               q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_mask: torch.Tensor | None) -> torch.Tensor:
    """:func:`over_mesh` where ``seq`` crosses processes: ``q``, ``k``,
    ``v`` [B, S / seq, H, D] are this rank's sequence block and each model
    column (with ``heads_sharded``; else the first) runs its ring over the
    seq group on its heads, ``local(qs, ks, vs, masks, devices, link)``
    with this rank's one shard."""
    from .transport import link
    ring = link(mesh, SEQ_AXIS)
    n_model = mesh.shape[MODEL_AXIS] if heads_sharded else 1
    if q.shape[2] % n_model:
        raise ValueError(f"heads {q.shape[2]} not divisible by model axis "
                         f"{n_model}")
    h_loc = q.shape[2] // n_model
    cols = []
    for j in range(n_model):
        dev = mesh.grid(j)[0][0]

        def part(t, heads=True):
            if heads:
                t = t[:, :, j * h_loc:(j + 1) * h_loc]
            return [t.to(dev)]
        out = local(part(q), part(k), part(v),
                    None if kv_mask is None else part(kv_mask, False), [dev],
                    ring)
        cols.append(out[0].to(q.device))
    return torch.cat(cols, dim=2)


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
    sequence over ``seq``, and with ``heads_sharded`` heads over
    ``model``, so that each model column runs its own ring over its heads
    (tensor parallelism; :func:`over_mesh`).  Without it the rings run on
    the first model column.  With ``seq`` across processes the inputs are
    this rank's sequence block (:func:`over_ranks`)."""
    def local(qs, ks, vs, masks, devices, link=None):
        return ring_attention_local(qs, ks, vs, masks, devices=devices,
                                    causal=causal, window=window,
                                    use_flash=use_flash, link=link)

    spread = over_ranks if mesh.crosses(SEQ_AXIS) else over_mesh

    def attention(q, k, v, kv_mask=None):
        return spread(mesh, local, heads_sharded=heads_sharded, q=q, k=k,
                      v=v, kv_mask=kv_mask)

    return attention
