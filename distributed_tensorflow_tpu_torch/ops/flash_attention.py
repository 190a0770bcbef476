"""Flash attention on [B, S, H, D]: forward (output plus per-row
logsumexp) and its FlashAttention-2 backward; and the chunk functions
that ring attention (``parallel/ring.py``) runs per hop.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas/flash_attention.py``
(``_flash_forward``, ``_flash_backward`` and the ``custom_vjp`` around
them).  :func:`flash_attention` is differentiable: a
:class:`torch.autograd.Function` whose forward saves q, k, v, the output
and the logsumexp, and whose backward is :func:`flash_attention_backward`.
Each direction is one wrapper around two implementations of the same
function:

- on CUDA tensors, hand-written Hopper kernels: the forward
  ``csrc/flash_attention.cu`` (one block per (batch*head, 128-row Q tile):
  a TMA producer warpgroup streams K/V tiles through two mbarrier stages,
  two consumer warpgroups run QK^T and PV on wgmma with the fp32 online
  softmax and output in registers), the backward
  ``csrc/flash_attention_bwd.cu`` (the same structure: dq with delta,
  then dk/dv, no atomics); fp32 inputs take scalar kernels;
- on CPU tensors, the plain PyTorch versions
  :func:`flash_attention_reference` (the dense masked softmax of
  ``ops/attention.py``'s ``xla`` branch, the port of ``_dense_reference``,
  plus the logsumexp) and :func:`flash_attention_backward_reference` (the
  FA-2 formulas of ``_bwd_block`` evaluated densely).

The ring's chunk functions (counterparts of ``flash_attention_chunk``,
``flash_attention_chunk_dq`` and ``flash_attention_chunk_dkv``) fold one
K/V chunk into the carried online-softmax state ``(m, l, acc)`` (in new
tensors, or in place) and give the per-hop gradient partials, with the
chunk's global position as two run-time offsets: on CUDA tensors the
kernels of ``csrc/flash_attention_chunk.cu`` (K6 on K1's Hopper design
with the carries in registers, K7a and K7b on K2's, adding their
partials into the ring's buffers in place), on CPU tensors
:func:`flash_attention_chunk_reference` and its two backward partners.

Head dims 32, 64 and 128 on the card (the plain versions take any).

A CUDA tensor never takes a plain version.  The kernels take every S (the
ragged last tile is masked) and read q/k/v/o/dO through their strides.
"""

from __future__ import annotations

import math

import torch

from . import kernels

# Kernel launches since the last reset (a smoke run resets them, drives
# the main path, and reads them back): the forward, and the backward's dq
# and dk/dv kernels.
launches = 0
dq_launches = 0
dkv_launches = 0
# The ring's chunk kernels: K6 (forward fold), K7a (dq), K7b (dk, dv).
chunk_launches = 0
chunk_dq_launches = 0
chunk_dkv_launches = 0

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def attention_valid(B: int, S: int, kv_mask: torch.Tensor | None, *,
                    causal: bool, window: int,
                    device) -> torch.Tensor:
    """[B, 1, S, S] boolean: query i may attend key j (padding, causal
    and sliding-window band), the dense form of the kernel's tile mask."""
    valid = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=device)
    if kv_mask is not None:
        valid = valid & (kv_mask[:, None, None, :] != 0)
    if causal:
        i = torch.arange(S, device=device)
        band = i[:, None] >= i[None, :]
        if window:
            band = band & (i[:, None] - i[None, :] < window)
        valid = valid & band[None, None]
    return valid.expand(B, 1, S, S)


def dense_attention(q, k, v, valid: torch.Tensor):
    """The ``xla`` backend's formula: fp32 logits (exact products, fp32
    sums) and softmax, fully masked rows zeroed, weights cast to v.dtype
    before the V product.  ``valid`` broadcasts to [B, H, S, S].  Returns
    (out [B, S, H, D] in v.dtype, fp32 logits [B, H, S, S])."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = valid.expand(logits.shape)
    masked = torch.where(valid, logits, torch.finfo(torch.float32).min)
    # Fully-masked rows: softmax of all-min logits is uniform; define as 0.
    weights = (torch.softmax(masked, dim=-1)
               * valid.any(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
    return out, logits


def flash_attention_reference(q, k, v, kv_mask=None, *, causal: bool,
                              window: int = 0):
    """Plain PyTorch version: (out [B,S,H,D] in q.dtype, lse [B*H,S] fp32).

    ``out`` is :func:`dense_attention`; ``lse`` follows the kernel: masked
    scores at -1e30, so a fully masked row's lse is ~-1e30."""
    B, S, H, _ = q.shape
    valid = attention_valid(B, S, kv_mask, causal=causal, window=window,
                            device=q.device)
    out, logits = dense_attention(q, k, v, valid)
    neg = torch.where(valid, logits, _NEG)
    m = neg.amax(dim=-1, keepdim=True)
    ell = (torch.exp(neg - m) * valid).sum(dim=-1, keepdim=True)
    lse = (m + torch.log(ell.clamp_min(1e-30)))[..., 0]
    return out.to(q.dtype), lse.reshape(B * H, S)


def flash_attention_backward_reference(q, k, v, kv_mask, o, lse, dout, *,
                                       causal: bool, window: int = 0):
    """Plain PyTorch version of the backward: (dq, dk, dv) in the inputs'
    dtypes, from the forward's output ``o`` and logsumexp ``lse``
    [B*H, S].  The FA-2 formulas of ``_bwd_block``, dense and in fp32:
    ``delta = rowsum(dO * o)``; ``P = exp(scale * q k^T - lse)``, masked
    before the exp (a fully masked row gives exact zeros, never inf * 0);
    ``dS = P (dO v^T - delta)``; ``dq = scale dS k``,
    ``dk = dS^T (scale q)``, ``dv = P^T dO``."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    valid = attention_valid(B, S, kv_mask, causal=causal, window=window,
                            device=q.device)
    qs = q.float() * scale
    kf, vf, df = k.float(), v.float(), dout.float()
    delta = (df * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B,H,S,1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    logits = torch.where(valid, logits, _NEG)
    p = torch.where(valid, torch.exp(logits - lse.reshape(B, H, S, 1)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", df, vf)
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, df)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(t: torch.Tensor) -> bool:
    """Last dim contiguous, base and every stride on a 16-byte boundary,
    as the kernels' 16-byte loads and TMA tensor maps need."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1]))


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if t.shape != q.shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                         f"{tuple(q.shape)}")
    if t.dtype != q.dtype or t.device != q.device:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                         f"{q.dtype} on {q.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dim must be contiguous")
    if not _aligned(t):
        raise ValueError(f"{name} rows must start on 16-byte boundaries "
                         f"(strides {t.stride()})")


def _check_cuda_call(q, kv_mask, *, name: str):
    """Shared CUDA-side checks; returns the int32 mask (or None)."""
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes fp32/bf16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {_HEAD_DIMS}, got {D}")
    if kv_mask is None:
        return None
    if kv_mask.shape != (B, S) or kv_mask.device != q.device:
        raise ValueError(f"kv_mask must be [{B}, {S}] on {q.device}")
    return (kv_mask != 0).to(torch.int32).contiguous()


def _forward(q, k, v, kv_mask, *, causal: bool, window: int):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    B, S, H, D = q.shape
    mask = _check_cuda_call(q, kv_mask, name="flash_attention")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    kernels.launch(
        "flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, S, H, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], int(causal), int(window),
        1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype])
    global launches
    launches += 1
    return out, lse


def _backward_operands(q, k, v, kv_mask, lse, dout, o=None):
    """CUDA-side checks shared by the backward kernels; returns the int32
    mask, dO (copied only when the kernels' 16-byte row loads cannot read
    it where it lies: autograd hands it over in any layout) and lse."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels run on cuda, got "
                         f"{q.device}")
    B, S, H, _ = q.shape
    mask = _check_cuda_call(q, kv_mask, name="flash_attention_backward")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t is not None:
            _check_operand(name, t, q)
    if dout.dtype != q.dtype:
        dout = dout.to(q.dtype)
    if not _aligned(dout):
        dout = dout.contiguous()
    _check_operand("dout", dout, q)
    if lse.shape != (B * H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [{B * H}, {S}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    return mask, dout, lse.contiguous()


def _launch_backward(entry: str, q, k, v, mask, o, dout, lse, delta,
                     out_a, out_b, *, causal: bool, window: int) -> None:
    B, S, H, D = q.shape
    o_strides = o.stride()[:3] if o is not None else (0, 0, 0)
    kernels.launch(
        entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if o is None else o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), out_a.data_ptr(),
        None if out_b is None else out_b.data_ptr(), B, S, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o_strides,
        *dout.stride()[:3], int(causal), int(window), 1.0 / math.sqrt(D),
        _DTYPE_CODE[q.dtype])


def flash_attention_backward_dq(q, k, v, kv_mask, o, lse, dout, *,
                                causal: bool, window: int = 0):
    """The dq kernel (K2b) on CUDA tensors: ``(dq [B, S, H, D] in q.dtype,
    delta [B*H, S] fp32)``, delta = rowsum(dO * o) for the dk/dv kernel."""
    mask, dout, lse = _backward_operands(q, k, v, kv_mask, lse, dout, o)
    B, S, H, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if dq.numel():
        _launch_backward("flash_attention_bwd_dq", q, k, v, mask, o, dout,
                         lse, delta, dq, None, causal=causal, window=window)
        global dq_launches
        dq_launches += 1
    return dq, delta


def flash_attention_backward_dkv(q, k, v, kv_mask, lse, delta, dout, *,
                                 causal: bool, window: int = 0):
    """The dk/dv kernel (K2a) on CUDA tensors, given the dq kernel's
    ``delta``: ``(dk, dv)`` [B, S, H, D] in the inputs' dtype."""
    mask, dout, lse = _backward_operands(q, k, v, kv_mask, lse, dout)
    if delta.shape != lse.shape or delta.dtype != torch.float32:
        raise ValueError(f"delta must be fp32 {tuple(lse.shape)}")
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel():
        _launch_backward("flash_attention_bwd_dkv", q, k, v, mask, None,
                         dout, lse, delta.contiguous(), dk, dv,
                         causal=causal, window=window)
        global dkv_launches
        dkv_launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, kv_mask, o, lse, dout, *,
                             causal: bool, window: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention`'s output, in the
    inputs' dtypes, given the forward's output ``o`` and logsumexp ``lse``
    [B*H, S] and the output gradient ``dout``.  CPU tensors take
    :func:`flash_attention_backward_reference`; CUDA tensors launch the dq
    kernel (which also writes delta) and then the dk/dv kernel."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, kv_mask, o, lse, dout, causal=causal, window=window)
    dq, delta = flash_attention_backward_dq(q, k, v, kv_mask, o, lse, dout,
                                            causal=causal, window=window)
    dk, dv = flash_attention_backward_dkv(q, k, v, kv_mask, lse, delta,
                                          dout, causal=causal, window=window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of ``_flash``: the forward saves q, k, v, the
    output and the logsumexp; the backward runs the FA-2 kernels (or the
    plain version on the CPU).  The logsumexp is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, window):
        out, lse = _forward(q, k, v, kv_mask, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, kv_mask, out, lse, dout, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None, *, causal: bool,
                    window: int = 0):
    """Blockwise attention, differentiable in q, k and v.  q, k, v:
    [B, S, H, D] (same shape and dtype); ``kv_mask`` [B, S], nonzero =
    attend; ``window`` > 0 (causal only) keeps each query's ``window``
    most recent keys.  Returns ``(out [B, S, H, D] in q.dtype, lse
    [B*H, S] fp32)``.  Without a gradient to record the forward runs
    bare, without the autograd node's host cost."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, causal, window)
    return _forward(q, k, v, kv_mask, causal=causal, window=window)


# ------------------------------------------------------------------ chunks
#
# One K/V chunk of a sequence-sharded ring against the local queries.
# Layouts follow the JAX ring's: q [B, Sq, H, D], k, v [B, Sk, H, D]; the
# carries m, l [B, H, Sq] and acc [B, H, Sq, D], lse and delta [B, H, Sq]
# and every gradient partial are fp32.  ``q_offset``/``k_offset`` are the
# global positions of q[:, 0] and k[:, 0]: causal and window masks compare
# q_offset + i with k_offset + j.  ``window`` applies with ``causal`` only.


def chunk_valid(B: int, Sq: int, Sk: int, kv_mask, *, q_offset: int,
                k_offset: int, causal: bool, window: int,
                device) -> torch.Tensor:
    """[B, 1, Sq, Sk] boolean: query q_offset + i may attend key
    k_offset + j (padding, causal and window band in global positions)."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    valid = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=device)
    if kv_mask is not None:
        valid = valid & (kv_mask[:, None, None, :] != 0)
    if causal:
        qp = q_offset + torch.arange(Sq, device=device)
        kp = k_offset + torch.arange(Sk, device=device)
        band = qp[:, None] >= kp[None, :]
        if window:
            band = band & (qp[:, None] - kp[None, :] < window)
        valid = valid & band[None, None]
    return valid.expand(B, 1, Sq, Sk)


def _chunk_logits(q, k, valid):
    """fp32 logits of (q / sqrt(D)) k^T, [B, H, Sq, Sk], masked to -1e30."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    return torch.where(valid, logits, _NEG), scale


def flash_attention_chunk_reference(q, k, v, kv_mask, m, l, acc, *,
                                    q_offset: int, k_offset: int,
                                    causal: bool = False, window: int = 0):
    """Plain version of :func:`flash_attention_chunk` (``_chunk_kernel``),
    in fp32: the online-softmax step of the whole chunk at once.  Masked
    probabilities are multiplied by the validity, so a row whose keys so
    far are all masked (m still -1e30) adds nothing."""
    B, Sq = q.shape[:2]
    valid = chunk_valid(B, Sq, k.shape[1], kv_mask, q_offset=q_offset,
                        k_offset=k_offset, causal=causal, window=window,
                        device=q.device)
    logits, _ = _chunk_logits(q, k, valid)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None]) * valid
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   v.float())
    return m_new, l_new, acc_new


def _chunk_bwd_reference(q, k, v, kv_mask, do, lse, delta, *, q_offset,
                         k_offset, causal, window):
    """The FA-2 block terms of ``_bwd_block`` for one chunk, dense and in
    fp32: (P, dS, scale) with P masked before the exp (a fully masked row,
    lse ~ -1e30, gives exact zeros, never inf * 0)."""
    B, Sq = q.shape[:2]
    valid = chunk_valid(B, Sq, k.shape[1], kv_mask, q_offset=q_offset,
                        k_offset=k_offset, causal=causal, window=window,
                        device=q.device)
    logits, scale = _chunk_logits(q, k, valid)
    p = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]), scale


def _chunk_outs(dkv: bool, out, shape: tuple, like) -> tuple:
    """The sums a backward partial is added into, checked, as a tuple
    (dq,) or (dk, dv): fp32 of the partial's shape on the operands'
    device, contiguous and 16-byte aligned (the kernels read and write
    their rows in place)."""
    if dkv != isinstance(out, (tuple, list)) or (dkv and len(out) != 2):
        raise ValueError("out is one tensor for the dq partial and the "
                         "pair (dk, dv) for the dk/dv partials")
    outs = tuple(out) if dkv else (out,)
    for name, t in zip(("dk", "dv") if dkv else ("dq",), outs):
        _f32_rows(f"out {name}", t, shape, like)
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"out {name} must be contiguous and start on "
                             "a 16-byte boundary")
    return outs


def flash_attention_chunk_dq_reference(q, k, v, kv_mask, do, lse, delta, *,
                                       q_offset: int, k_offset: int,
                                       causal: bool = False,
                                       window: int = 0, out=None):
    """Plain version of :func:`flash_attention_chunk_dq`: the fp32 dq
    partial [B, H, Sq, D] of the local queries against one chunk,
    ``scale dS k``; with ``out``, added into it (``out.add_(partial)``)
    and ``out`` returned."""
    B, Sq, H, D = q.shape
    if out is not None:
        _chunk_outs(False, out, (B, H, Sq, D), q)
    _, ds, scale = _chunk_bwd_reference(
        q, k, v, kv_mask, do, lse, delta, q_offset=q_offset,
        k_offset=k_offset, causal=causal, window=window)
    dq = scale * torch.einsum("bhqk,bkhd->bhqd", ds, k.float())
    return dq if out is None else out.add_(dq)


def flash_attention_chunk_dkv_reference(q, k, v, kv_mask, do, lse, delta,
                                        *, q_offset: int, k_offset: int,
                                        causal: bool = False,
                                        window: int = 0, out=None):
    """Plain version of :func:`flash_attention_chunk_dkv`: the fp32
    partials (dk, dv) [B, H, Sk, D] of one chunk from the local queries,
    ``dS^T (scale q)`` and ``P^T dO``; with ``out`` = (dk, dv), added
    into them and ``out`` returned."""
    B, Sk, H, D = k.shape
    if out is not None:
        out = _chunk_outs(True, out, (B, H, Sk, D), q)
    p, ds, scale = _chunk_bwd_reference(
        q, k, v, kv_mask, do, lse, delta, q_offset=q_offset,
        k_offset=k_offset, causal=causal, window=window)
    dk = torch.einsum("bhqk,bqhd->bhkd", ds, q.float() * scale)
    dv = torch.einsum("bhqk,bqhd->bhkd", p, do.float())
    if out is None:
        return dk, dv
    return out[0].add_(dk), out[1].add_(dv)


def _chunk_operands(q, k, v, kv_mask, *, causal: bool, window: int,
                    name: str):
    """CUDA-side checks shared by the chunk wrappers; returns the int32
    mask (or None)."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, _, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes fp32/bf16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {_HEAD_DIMS}, got {D}")
    for tname, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{tname} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(f"{tname}'s last dim must be contiguous and "
                             f"its rows start on 16-byte boundaries "
                             f"(strides {t.stride()})")
    if kv_mask is None:
        return None
    if kv_mask.shape != (B, Sk) or kv_mask.device != q.device:
        raise ValueError(f"kv_mask must be [{B}, {Sk}] on {q.device}")
    return (kv_mask != 0).to(torch.int32).contiguous()


def _f32_rows(name: str, t: torch.Tensor, shape: tuple, like) -> torch.Tensor:
    if tuple(t.shape) != shape or t.dtype != torch.float32 \
            or t.device != like.device:
        raise ValueError(f"{name} must be fp32 {shape} on {like.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def flash_attention_chunk(q, k, v, kv_mask, m, l, acc, *, q_offset: int,
                          k_offset: int, causal: bool = False,
                          window: int = 0, in_place: bool = False):
    """Fold one K/V chunk into the running state ``(m, l, acc)`` and return
    the updated state.  By default, as the JAX function, in new tensors
    (the inputs are not written); ``in_place=True`` writes the update into
    ``m``, ``l`` and ``acc`` themselves (contiguous fp32) and returns them,
    so a chunk that no query can see costs no memory traffic.  Finalise
    with ``acc / max(l, 1e-30)`` after the last chunk.  K6 on CUDA
    tensors, :func:`flash_attention_chunk_reference` on CPU tensors."""
    if q.device.type == "cpu":
        new = flash_attention_chunk_reference(
            q, k, v, kv_mask, m, l, acc, q_offset=q_offset,
            k_offset=k_offset, causal=causal, window=window)
        if not in_place:
            return new
        for t, n in zip((m, l, acc), new):
            t.copy_(n)
        return m, l, acc
    mask = _chunk_operands(q, k, v, kv_mask, causal=causal, window=window,
                           name="flash_attention_chunk")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if in_place and not all(t.is_contiguous() for t in (m, l, acc)):
        raise ValueError("in_place needs contiguous m, l and acc")
    m = _f32_rows("m", m, (B, H, Sq), q)
    l = _f32_rows("l", l, (B, H, Sq), q)
    acc = _f32_rows("acc", acc, (B, H, Sq, D), q)
    if acc.data_ptr() % 16:
        raise ValueError("acc must start on a 16-byte boundary")
    m_out, l_out, acc_out = ((m, l, acc) if in_place else
                             (torch.empty_like(t) for t in (m, l, acc)))
    if m_out.numel() == 0:
        return m_out, l_out, acc_out
    kernels.launch(
        "flash_attention_chunk", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if mask is None else mask.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
        acc_out.data_ptr(), B, Sq, Sk, H, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], int(q_offset), int(k_offset),
        int(causal), int(window), 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype])
    global chunk_launches
    chunk_launches += 1
    return m_out, l_out, acc_out


def _chunk_bwd(dkv: bool, q, k, v, kv_mask, do, lse, delta, *, q_offset,
               k_offset, causal, window, out):
    """Launch K7a (``dkv`` False: dq) or K7b (dk, dv) on CUDA tensors,
    into new tensors or, with ``out``, adding into it."""
    name = "flash_attention_chunk_dkv" if dkv else "flash_attention_chunk_dq"
    mask = _chunk_operands(q, k, v, kv_mask, causal=causal, window=window,
                           name=name)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != q shape "
                         f"{tuple(q.shape)}")
    do = do.to(q.dtype)
    if not _aligned(do):        # autograd hands it over in any layout
        do = do.contiguous()
    lse = _f32_rows("lse", lse, (B, H, Sq), q)
    delta = _f32_rows("delta", delta, (B, H, Sq), q)
    shape = (B, H, Sk if dkv else Sq, D)
    if out is None:
        out_a = torch.empty(shape, dtype=torch.float32, device=q.device)
        out_b = torch.empty_like(out_a) if dkv else None
    else:
        outs = _chunk_outs(dkv, out, shape, q)
        out_a, out_b = outs[0], outs[1] if dkv else None
    if out_a.numel():
        kernels.launch(
            "flash_attention_chunk_bwd", q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out_a.data_ptr(),
            None if out_b is None else out_b.data_ptr(), B, Sq, Sk, H, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], int(q_offset), int(k_offset), int(causal),
            int(window), 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], int(dkv),
            int(out is not None))
        global chunk_dq_launches, chunk_dkv_launches
        if dkv:
            chunk_dkv_launches += 1
        else:
            chunk_dq_launches += 1
    return (out_a, out_b) if dkv else out_a


def flash_attention_chunk_dq(q, k, v, kv_mask, do, lse, delta, *,
                             q_offset: int, k_offset: int,
                             causal: bool = False, window: int = 0,
                             out=None):
    """The fp32 dq partial [B, H, Sq, D] of the local queries against one
    K/V chunk, from the ring's saved ``lse`` and its ``delta`` (both
    [B, H, Sq] fp32).  Without ``out``, in a new tensor; with ``out`` (the
    ring's fp32 dq, contiguous, of the partial's shape) the partial is
    added into it, ``out + partial`` with one fp32 rounding as ``add_``
    gives, and ``out`` is returned: a chunk no query sees leaves it
    untouched.  K7a on CUDA tensors,
    :func:`flash_attention_chunk_dq_reference` on CPU tensors."""
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=causal,
              window=window, out=out)
    if q.device.type == "cpu":
        return flash_attention_chunk_dq_reference(q, k, v, kv_mask, do, lse,
                                                  delta, **kw)
    return _chunk_bwd(False, q, k, v, kv_mask, do, lse, delta, **kw)


def flash_attention_chunk_dkv(q, k, v, kv_mask, do, lse, delta, *,
                              q_offset: int, k_offset: int,
                              causal: bool = False, window: int = 0,
                              out=None):
    """The fp32 partials (dk, dv) [B, H, Sk, D] of one K/V chunk from the
    local queries; they travel the ring with their chunk.  ``out``, the
    pair (dk, dv), takes them added in place, as for
    :func:`flash_attention_chunk_dq`.  K7b on CUDA tensors,
    :func:`flash_attention_chunk_dkv_reference` on CPU tensors."""
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=causal,
              window=window, out=out)
    if q.device.type == "cpu":
        return flash_attention_chunk_dkv_reference(q, k, v, kv_mask, do,
                                                   lse, delta, **kw)
    return _chunk_bwd(True, q, k, v, kv_mask, do, lse, delta, **kw)
