"""Flash attention forward on [B, S, H, D]: output plus per-row logsumexp.

Counterpart of the forward half of
``distributed_tensorflow_tpu/ops/pallas/flash_attention.py``
(``_flash_forward``).  :func:`flash_attention` is one wrapper around two
implementations of the same function:

- on CUDA tensors, the hand-written kernel ``csrc/flash_attention.cu``
  (one thread block per (batch*head, 64-row Q tile), K/V tiles looped
  inside the block, fp32 online softmax, WMMA bf16 fragments);
- on CPU tensors, :func:`flash_attention_reference`, the plain PyTorch
  version: the dense masked softmax of ``ops/attention.py``'s ``xla``
  branch (the port of ``_dense_reference``), plus the same logsumexp.

A CUDA tensor never takes the plain version.  The kernel takes every S
(the ragged last tile is masked) and reads q/k/v through their strides.
The backward kernels have not been ported: a call that would need a
gradient raises instead of differentiating through the plain version.
"""

from __future__ import annotations

import math

import torch

from . import kernels

# Kernel launches since the last reset (the serving smoke run resets it,
# drives the main path, and reads it back).
launches = 0

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_BACKWARD_TODO = ("flash_attention has no backward kernel yet (ROADMAP.md, "
                  "PyTorch port: K2 flash-attention backward); call it "
                  "under torch.no_grad()")


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


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if t.shape != q.shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                         f"{tuple(q.shape)}")
    if t.dtype != q.dtype or t.device != q.device:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                         f"{q.dtype} on {q.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dim must be contiguous")
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
        raise ValueError(f"{name} rows must start on 16-byte boundaries "
                         f"(strides {t.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None, *, causal: bool,
                    window: int = 0):
    """Blockwise attention forward.  q, k, v: [B, S, H, D] (same shape and
    dtype); ``kv_mask`` [B, S], nonzero = attend; ``window`` > 0 (causal
    only) keeps each query's ``window`` most recent keys.  Returns
    ``(out [B, S, H, D] in q.dtype, lse [B*H, S] fp32)``."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(_BACKWARD_TODO)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention takes fp32/bf16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    mask_ptr = None
    if kv_mask is not None:
        if kv_mask.shape != (B, S) or kv_mask.device != q.device:
            raise ValueError(f"kv_mask must be [{B}, {S}] on {q.device}")
        kv_mask = (kv_mask != 0).to(torch.int32).contiguous()
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = kernels.load()
    rc = lib.dtt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
        out.data_ptr(), lse.data_ptr(), B, S, H, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
        kernels.stream_handle(q.device))
    kernels.check(rc, "flash_attention_fwd")
    global launches
    launches += 1
    return out, lse
