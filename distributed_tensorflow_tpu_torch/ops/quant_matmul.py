"""Fused quantize-and-matmul: int8 products with the activations quantized
per (row, K-block) inside the matmul.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas/quant_matmul.py``
(``quantize_cols``, ``quantized_matmul``, ``quantized_matmul_nt``,
``quantized_matmul_dgelu``).
Weights are quantized per output column outside the kernels
(:func:`quantize_cols`, once per step); activations get one scale per row
and per K-block of width ``bk = _pick(K, block_k)``, computed in the
kernel's prologue.  The K-block is part of the function: each block's
int32 product is rescaled by its own scale into an fp32 accumulator,
``acc += float(part) * sx``, block after block.

Each function is one wrapper around two implementations:

- on CUDA tensors, the hand-written kernels of ``csrc/quant_matmul.cu``
  (K4 :func:`quantized_matmul`, the forward with its bias / gelu /
  pre-activation / residual epilogue; K5 :func:`quantized_matmul_nt`, the
  dgrad against the forward's quantized weight with the scale fold and the
  gelu backward in its prologue; K8 :func:`quantized_matmul_dgelu`, the
  dgrad against an explicitly re-quantized ``w.T`` with the gelu backward
  in its prologue and no fold, on no training path), on the int8 tensor
  cores;
- on CPU tensors, the plain versions :func:`quantized_matmul_reference`,
  :func:`quantized_matmul_nt_reference` and
  :func:`quantized_matmul_dgelu_reference`.

A CUDA tensor never takes a plain version: the kernel launches or the call
raises.  The kernels take every M; K must have a power-of-two K-block of
128 to 1024 and N must be a multiple of 128, which every shape that
:func:`supported` admits gives.
"""

from __future__ import annotations

import torch

from . import kernels

# Kernel launches since the last reset (a smoke run resets them, drives
# the main path, and reads them back).
launches = 0
nt_launches = 0
dgelu_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE_N = 128          # the kernels' output-column tile
_MAX_BK = 1024         # one K-block of int8 rows fits in shared memory

# Tanh-approximation gelu and its derivative in fp32, jax.nn.gelu(
# approximate=True)'s form, written op by op in the JAX code's order (the
# kernels repeat that order with unfused roundings).
_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715


def _gelu(y: torch.Tensor) -> torch.Tensor:
    return 0.5 * y * (1.0 + torch.tanh(_GELU_C * (y + _GELU_A * y * y * y)))


def _dgelu(y: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_GELU_C * (y + _GELU_A * y * y * y))
    dt = (1.0 - t * t) * _GELU_C * (1.0 + 3.0 * _GELU_A * y * y)
    return 0.5 * (1.0 + t) + 0.5 * y * dt


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as an IEEE division on every device
    (a CUDA tensor divided by a Python number is multiplied by its
    reciprocal instead, one ulp off; dividing by a tensor is not)."""
    return amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per COLUMN (axis 0 reduced): ``w ~ q * s``, ``q``
    int8 [K, N], ``s`` fp32 [1, N].  Rounds half to even, as
    ``jnp.round``."""
    w32 = w.to(torch.float32)
    s = _scale(w32.abs().amax(dim=0, keepdim=True))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q, s


def _quant_block(xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, K-block) symmetric int8 of an fp32 block: (q, scale)."""
    sx = _scale(xb.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xb / sx), -127, 127)
    return q, sx


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a [M, K] @ b [K, N]`` of integer-valued tensors
    (|values| <= 127) through fp32 products over K-chunks of at most 1024:
    each chunk's sum stays below 127^2 * 1024 < 2^24, so fp32 holds it
    exactly, and the chunks add in int32.  (CUDA has no integer GEMM in
    torch.matmul; fp32 on both devices gives one code path.)"""
    K = a.shape[1]
    out = None
    for k0 in range(0, K, _MAX_BK):
        part = (a[:, k0:k0 + _MAX_BK].to(torch.float32)
                @ b[k0:k0 + _MAX_BK].to(torch.float32)).to(torch.int32)
        out = part if out is None else out + part
    return out


def _pick(dim: int, preferred: int) -> int:
    """Largest power-of-two divisor of ``dim`` capped at ``preferred``."""
    b = 1
    while dim % (b * 2) == 0 and b * 2 <= preferred:
        b *= 2
    return b


def supported(M: int, K: int, N: int) -> bool:
    """True when every dim splits into >= 128-wide power-of-two blocks:
    the shapes on which the JAX package runs the fused kernels (the gate
    decides which function is computed, so the port keeps it)."""
    return all(_pick(d, 512) >= 128 for d in (M, K, N))


def _blocked_product(q: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                     bk: int, nt: bool) -> torch.Tensor:
    """``sum_kb float(q_kb @ qw_kb) * sx_kb`` in fp32, block by block in
    the kernels' order.  ``q`` [M, K/bk, bk] (integer-valued fp32), ``sx``
    [M, K/bk, 1]; ``qw`` [K, N] (or [N, K] when ``nt``)."""
    M, nkb, _ = q.shape
    N = qw.shape[0] if nt else qw.shape[1]
    acc = torch.zeros(M, N, dtype=torch.float32, device=q.device)
    for kb in range(nkb):
        cols = slice(kb * bk, (kb + 1) * bk)
        wb = qw[:, cols].t() if nt else qw[cols]
        # One K-block: exact in fp32 because bk <= 1024 (see int_dot).
        part = q[:, kb].to(torch.float32) @ wb.to(torch.float32)
        acc = acc + part * sx[:, kb]
    return acc


def _block_k(K: int, block_k: int) -> int:
    bk = _pick(K, block_k)
    if bk > _MAX_BK:
        raise ValueError(f"block_k {bk} > {_MAX_BK}: one K-block's int32 "
                         "sum must stay exact in fp32")
    return bk


def _check_qmm(x, qw, sw, bias, residual, activation, want_preact):
    M, K = x.shape
    K2, N = qw.shape
    if K != K2 or tuple(sw.shape) != (1, N):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, qw "
                         f"{tuple(qw.shape)}, sw {tuple(sw.shape)}")
    if activation not in (None, "gelu"):
        raise ValueError(f"unsupported activation {activation!r}")
    if want_preact and activation is None:
        raise ValueError("want_preact without an activation is just the "
                         "plain output; drop the flag")
    if bias is not None:
        bias = bias.reshape(1, -1).to(torch.float32)
        if tuple(bias.shape) != (1, N):
            raise ValueError(f"bias shape {tuple(bias.shape)} != (1, {N})")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"residual shape {tuple(residual.shape)} != "
                         f"({M}, {N})")
    return M, K, N, bias


def quantized_matmul_reference(x, qw, sw, bias=None, residual=None, *,
                               activation: str | None = None,
                               want_preact: bool = False,
                               block_k: int = 512):
    """Plain version of :func:`quantized_matmul` (``_qmm_kernel``): ``x
    [M, K] @ (qw [K, N] int8 * sw [1, N])`` in x.dtype, quantizing x per
    (row, K-block of ``_pick(K, block_k)``, at most 1024).  Epilogue, in
    order: ``* sw``, ``+ bias`` (fp32), the pre-activation rounded to
    x.dtype (returned with ``want_preact``) and re-read, gelu, ``+
    residual`` in fp32, one cast."""
    M, K, N, bias = _check_qmm(x, qw, sw, bias, residual, activation,
                               want_preact)
    bk = _block_k(K, block_k)
    q, sx = _quant_block(x.to(torch.float32).reshape(M, K // bk, bk))
    y = _blocked_product(q, sx, qw, bk, nt=False) * sw.to(torch.float32)
    if bias is not None:
        y = y + bias
    pre = None
    if want_preact:
        pre = y.to(x.dtype)
        y = pre.to(torch.float32)
    if activation == "gelu":
        y = _gelu(y)
    if residual is not None:
        y = y + residual.to(torch.float32)
    out = y.to(x.dtype)
    return (out, pre) if want_preact else out


def _check_nt(da, qw, sw, pre, prologue, want_g):
    if prologue not in ("fold", "dgelu_fold"):
        raise ValueError(f"unknown prologue {prologue!r}")
    if want_g and prologue != "dgelu_fold":
        raise ValueError("want_g only applies to the dgelu_fold prologue")
    M, K = da.shape
    N, K2 = qw.shape
    if K != K2 or tuple(sw.shape) != (1, K):
        raise ValueError(f"shape mismatch: da {tuple(da.shape)}, qw "
                         f"{tuple(qw.shape)}, sw {tuple(sw.shape)}")
    if pre is not None and pre.shape != da.shape:
        raise ValueError(f"pre shape {tuple(pre.shape)} != da shape "
                         f"{tuple(da.shape)}")
    if (pre is None) != (prologue == "fold"):
        raise ValueError("pre must be given exactly for dgelu_fold")
    return M, K, N


def quantized_matmul_nt_reference(da, qw, sw, pre=None, *,
                                  prologue: str = "fold",
                                  want_g: bool = False,
                                  block_k: int = 512):
    """Plain version of :func:`quantized_matmul_nt` (``_qmm_nt_kernel``):
    ``dx [M, N] ~ g @ (qw * sw).T`` in da.dtype, where ``g = da`` (``fold``)
    or ``da * gelu'(pre)`` (``dgelu_fold``), qw [N, K] is the forward's
    quantized weight and sw [1, K] its column scales.  The scale folds into
    g before g is quantized per (row, K-block): ``sum_k (g_k s_k) qw_nk``.
    ``want_g`` also returns the unfolded g in da.dtype."""
    M, K, N = _check_nt(da, qw, sw, pre, prologue, want_g)
    bk = _block_k(K, block_k)
    g = da.to(torch.float32)
    if prologue == "dgelu_fold":
        g = g * _dgelu(pre.to(torch.float32))
    q, sg = _quant_block((g * sw.to(torch.float32)).reshape(M, K // bk, bk))
    out = _blocked_product(q, sg, qw, bk, nt=True).to(da.dtype)
    return (out, g.to(da.dtype)) if want_g else out


def _check_dgelu(da, pre, qwt, swt):
    M, K = da.shape
    if pre.shape != da.shape:
        raise ValueError(f"pre shape {tuple(pre.shape)} != da shape "
                         f"{tuple(da.shape)}")
    K2, N = qwt.shape
    if K != K2 or tuple(swt.shape) != (1, N):
        raise ValueError(f"shape mismatch: da {tuple(da.shape)}, qwt "
                         f"{tuple(qwt.shape)}, swt {tuple(swt.shape)}")
    return M, K, N


def quantized_matmul_dgelu_reference(da, pre, qwt, swt, *,
                                     want_g: bool = False,
                                     block_k: int = 512):
    """Plain version of :func:`quantized_matmul_dgelu`
    (``_qmm_dgelu_kernel``): ``g = da * gelu'(pre)`` in fp32, quantized per
    (row, K-block), ``@ qwt [K, N]`` block by block, ``* swt [1, N]``, one
    cast to da.dtype; ``want_g`` also returns g in da.dtype."""
    M, K, N = _check_dgelu(da, pre, qwt, swt)
    bk = _block_k(K, block_k)
    g = da.to(torch.float32) * _dgelu(pre.to(torch.float32))
    q, sg = _quant_block(g.reshape(M, K // bk, bk))
    out = (_blocked_product(q, sg, qwt, bk, nt=False)
           * swt.to(torch.float32)).to(da.dtype)
    return (out, g.to(da.dtype)) if want_g else out


def _rows_ok(t: torch.Tensor) -> bool:
    """Last dim contiguous and rows on a 16-byte boundary: the kernels
    load four elements per lane (8 bytes in bf16, 16 in fp32)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and (t.stride(0) * t.element_size()) % 16 == 0)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t if _rows_ok(t) else t.contiguous()


def _check_cuda(name: str, t: torch.Tensor, like: torch.Tensor,
                dtype=None) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, the input on "
                         f"{like.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _kernel_shape(x: torch.Tensor, K: int, N: int, bk: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"quantized matmuls run on cuda or cpu, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernels take fp32/bf16 activations, got "
                         f"{x.dtype}")
    if bk < 128 or K % bk:
        raise ValueError(f"the kernels need a power-of-two K-block of 128 "
                         f"to {_MAX_BK} dividing K={K}, got {bk}")
    if N % _TILE_N:
        raise ValueError(f"the kernels need N % {_TILE_N} == 0, got {N}")


def quantized_matmul(x, qw, sw, bias=None, residual=None, *,
                     activation: str | None = None,
                     want_preact: bool = False, block_k: int = 512):
    """``x [M, K] (bf16/fp32) @ (qw [K, N] int8 * sw [1, N])`` -> x.dtype,
    with x quantized per (row, K-block) in the kernel's prologue and the
    epilogue of :func:`quantized_matmul_reference`.  Returns ``(y, pre)``
    with ``want_preact``.  K4 on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(
            x, qw, sw, bias, residual, activation=activation,
            want_preact=want_preact, block_k=block_k)
    M, K, N, bias = _check_qmm(x, qw, sw, bias, residual, activation,
                               want_preact)
    bk = _block_k(K, block_k)
    _kernel_shape(x, K, N, bk)
    _check_cuda("qw", qw, x, torch.int8)
    _check_cuda("sw", sw, x, torch.float32)
    # The kernel reads the weight K-major, as the int8 mma's B operand
    # wants: one int8 transpose per call.
    x, qwt, sw = _rows(x), qw.t().contiguous(), sw.contiguous()
    if bias is not None:
        _check_cuda("bias", bias, x)
        bias = bias.contiguous()
    if residual is not None:
        _check_cuda("residual", residual, x, x.dtype)
        residual = residual.contiguous()
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    pre = torch.empty_like(out) if want_preact else None
    if M == 0:
        return (out, pre) if want_preact else out
    lib = kernels.load()
    rc = lib.dtt_quant_matmul(
        x.data_ptr(), qwt.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), None if pre is None else pre.data_ptr(),
        M, N, K, bk, x.stride(0), int(activation == "gelu"),
        _DTYPE_CODE[x.dtype], kernels.stream_handle(x.device))
    kernels.check(rc, "quant_matmul")
    global launches
    launches += 1
    return (out, pre) if want_preact else out


def quantized_matmul_nt(da, qw, sw, pre=None, *, prologue: str = "fold",
                        want_g: bool = False, block_k: int = 512):
    """Dgrad against the forward's quantized weight: ``da [M, K]``, ``qw
    [N, K]`` / ``sw [1, K]`` (the forward's :func:`quantize_cols` output,
    contracted on its last axis) -> ``dx [M, N]`` in da.dtype, and the
    unfolded ``g`` with ``want_g``.  See
    :func:`quantized_matmul_nt_reference`.  K5 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if da.device.type == "cpu":
        return quantized_matmul_nt_reference(
            da, qw, sw, pre, prologue=prologue, want_g=want_g,
            block_k=block_k)
    M, K, N = _check_nt(da, qw, sw, pre, prologue, want_g)
    bk = _block_k(K, block_k)
    _kernel_shape(da, K, N, bk)
    _check_cuda("qw", qw, da, torch.int8)
    _check_cuda("sw", sw, da, torch.float32)
    da, qw, sw = _rows(da), qw.contiguous(), sw.contiguous()
    if sw.data_ptr() % 16:
        sw = sw.clone()            # the prologue reads sw 16 bytes a lane
    if pre is not None:
        _check_cuda("pre", pre, da, da.dtype)
        pre = _rows(pre)
    out = torch.empty(M, N, dtype=da.dtype, device=da.device)
    g = torch.empty(M, K, dtype=da.dtype, device=da.device) if want_g \
        else None
    if M == 0:
        return (out, g) if want_g else out
    lib = kernels.load()
    rc = lib.dtt_quant_matmul_nt(
        da.data_ptr(), None if pre is None else pre.data_ptr(),
        qw.data_ptr(), sw.data_ptr(), out.data_ptr(),
        None if g is None else g.data_ptr(), M, N, K, bk, da.stride(0),
        0 if pre is None else pre.stride(0), _DTYPE_CODE[da.dtype],
        kernels.stream_handle(da.device))
    kernels.check(rc, "quant_matmul_nt")
    global nt_launches
    nt_launches += 1
    return (out, g) if want_g else out


def quantized_matmul_dgelu(da, pre, qwt, swt, *, want_g: bool = False,
                           block_k: int = 512):
    """``(da * gelu'(pre)) [M, K] @ (qwt [K, N] int8 * swt [1, N])`` in
    da.dtype, the gelu backward and the per-(row, K-block) quantize in the
    kernel's prologue; ``want_g`` also returns ``g = da * gelu'(pre)``.
    The dgrad against an explicitly re-quantized ``w.T``: the JAX package
    keeps it tested but trains through :func:`quantized_matmul_nt`.  K8 on
    a CUDA tensor, :func:`quantized_matmul_dgelu_reference` on a CPU
    tensor."""
    if da.device.type == "cpu":
        return quantized_matmul_dgelu_reference(da, pre, qwt, swt,
                                                want_g=want_g,
                                                block_k=block_k)
    M, K, N = _check_dgelu(da, pre, qwt, swt)
    bk = _block_k(K, block_k)
    _kernel_shape(da, K, N, bk)
    _check_cuda("pre", pre, da, da.dtype)
    _check_cuda("qwt", qwt, da, torch.int8)
    _check_cuda("swt", swt, da, torch.float32)
    # The kernel reads the weight K-major, as the int8 mma's B operand
    # wants: one int8 transpose per call (as K4's wrapper).
    da, pre = _rows(da), _rows(pre)
    qw, swt = qwt.t().contiguous(), swt.contiguous()
    out = torch.empty(M, N, dtype=da.dtype, device=da.device)
    g = torch.empty(M, K, dtype=da.dtype, device=da.device) if want_g \
        else None
    if M == 0:
        return (out, g) if want_g else out
    rc = kernels.load().dtt_quant_matmul_dgelu(
        da.data_ptr(), pre.data_ptr(), qw.data_ptr(), swt.data_ptr(),
        out.data_ptr(), None if g is None else g.data_ptr(), M, N, K, bk,
        da.stride(0), pre.stride(0), _DTYPE_CODE[da.dtype],
        kernels.stream_handle(da.device))
    kernels.check(rc, "quant_matmul_dgelu")
    global dgelu_launches
    dgelu_launches += 1
    return (out, g) if want_g else out
