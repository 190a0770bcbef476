"""Fused quantize-and-matmul: int8 products with the activations quantized
per (row, K-block).

Counterpart of ``distributed_tensorflow_tpu/ops/pallas/quant_matmul.py``
(``quantize_cols``, ``quantized_matmul``, ``quantized_matmul_nt``,
``quantized_matmul_dgelu``).
Weights are quantized per output column outside the kernels
(:func:`quantize_cols`, once per step); activations get one scale per row
and per K-block of width ``bk = _pick(K, block_k)``.  The K-block is part
of the function: each block's int32 product is rescaled by its own scale
into an fp32 accumulator, ``acc += float(part) * sx``, block after block.

Each function is one wrapper around two implementations:

- on CUDA tensors, hand-written kernels on the int8 tensor cores.  K4
  (:func:`quantized_matmul`, the forward with its bias / gelu /
  pre-activation / residual epilogue) and K5 (:func:`quantized_matmul_nt`,
  the dgrad against the forward's quantized weight with the scale fold and
  the gelu backward in its prologue) are two kernels of
  ``csrc/quant_gemm.cu`` each: the quantize pass
  (:func:`quantize_blocks`, codes and scales once per element) and the
  block-scaled int8 GEMM (:func:`blocked_gemm`, wgmma, with K4's
  epilogue; K4's weight made K-major first by :func:`transpose_s8`).  K8
  (:func:`quantized_matmul_dgelu`, the dgrad against an explicitly
  re-quantized ``w.T``, on no training path) is the same three launches:
  kernel A with gelu' and no fold, the transpose, kernel B with the bare
  ``* sw`` epilogue;
- on CPU tensors, the plain versions :func:`quantized_matmul_reference`,
  :func:`quantized_matmul_nt_reference` and
  :func:`quantized_matmul_dgelu_reference` (the specification), and for
  the two stages :func:`quantize_blocks_reference` and
  :func:`blocked_gemm_reference`, whose composition gives all three bit
  for bit.

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
launches = 0              # K4 calls (each launches A, T, then B)
nt_launches = 0           # K5 calls (each launches A, then B)
dgelu_launches = 0        # K8 calls (each launches A, T, then B)
quantize_launches = 0     # kernel A, the quantize pass
gemm_launches = 0         # kernel B, the block-scaled int8 GEMM
transpose_launches = 0    # T, K4's and K8's weight transpose

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


def quantize_cols(w: torch.Tensor, s: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per COLUMN (axis 0 reduced): ``w ~ q * s``, ``q``
    int8 [K, N], ``s`` fp32 [1, N].  Rounds half to even, as
    ``jnp.round``.  A given ``s`` (the whole K's scales of a weight whose
    rows are split over tensor-parallel shards, :func:`col_scales`) is
    used as it is."""
    w32 = w.to(torch.float32)
    if s is None:
        s = _scale(w32.abs().amax(dim=0, keepdim=True))
    q = torch.clamp(torch.round(w32 / s.to(w32.device)),
                    -127, 127).to(torch.int8)
    return q, s


def col_scales(parts) -> torch.Tensor:
    """:func:`quantize_cols`'s scales [1, N] of the weight whose rows are
    ``parts`` (tensor-parallel shards, in order): each column's max over
    every shard, on the first shard's device."""
    home = parts[0].device
    amax = torch.stack([p.to(home, torch.float32).abs().amax(dim=0)
                        for p in parts]).amax(dim=0, keepdim=True)
    return _scale(amax)


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


def quantize_blocks_reference(a, bk: int, pre=None, sf=None, *,
                              want_g: bool = False, sx=None):
    """Plain version of :func:`quantize_blocks`, the quantize stage of K4,
    K5 and K8: ``v = a`` (fp32), times ``gelu'(pre)`` when ``pre`` is given
    (``g = v`` in a.dtype with ``want_g``), times ``sf [K]`` (the fold)
    when given; then per (row, K-block of ``bk``) ``sx = max(amax |v|,
    1e-8) / 127`` (or the given ``sx [K / bk, M]``) and ``q =
    clamp(round(v / sx), -127, 127)``.  Returns ``(q [M, K] int8, sx [K /
    bk, M] fp32, g or None)``."""
    M, K = a.shape
    if want_g and pre is None:
        raise ValueError("want_g needs pre: g is v before the fold")
    v = a.to(torch.float32)
    if pre is not None:
        v = v * _dgelu(pre.to(torch.float32))
    g = v.to(a.dtype) if want_g else None
    if sf is not None:
        v = v * sf.reshape(1, K).to(torch.float32)
    v = v.reshape(M, K // bk, bk)
    if sx is None:
        q, s = _quant_block(v)
    else:
        s = sx.to(torch.float32).t().reshape(M, K // bk, 1)
        q = torch.clamp(torch.round(v / s), -127, 127)
    return (q.reshape(M, K).to(torch.int8),
            s.reshape(M, K // bk).t().contiguous(), g)


def blocked_gemm_reference(q, sx, w, bk: int, sw=None, bias=None,
                           residual=None, *, activation: str | None = None,
                           want_preact: bool = False,
                           out_dtype=torch.float32):
    """Plain version of :func:`blocked_gemm`, the GEMM stage of K4, K5, K8:
    ``acc = sum_kb float(q_kb @ w_kb.T) * sx[kb]`` in fp32, K-blocks in
    order, for codes ``q [M, K]``, scales ``sx [K / bk, M]`` and the
    K-major weight ``w [N, K]`` (int8).  Without ``sw`` the output is
    ``acc`` in ``out_dtype`` (K5); with it K4's epilogue: ``* sw``, ``+
    bias``, the pre-activation rounded to ``out_dtype`` (returned with
    ``want_preact``) and re-read, gelu, ``+ residual``, one cast (K8:
    ``* sw`` and the cast alone)."""
    M, K = q.shape
    acc = torch.zeros(M, w.shape[0], dtype=torch.float32, device=q.device)
    for kb in range(K // bk):
        cols = slice(kb * bk, (kb + 1) * bk)
        # One K-block: exact in fp32 because bk <= 1024 (see int_dot).
        part = q[:, cols].to(torch.float32) @ w[:, cols].t().to(torch.float32)
        acc = acc + part * sx[kb].reshape(M, 1)
    if sw is None:
        return acc.to(out_dtype)
    y = acc * sw.reshape(1, -1).to(torch.float32)
    if bias is not None:
        y = y + bias.reshape(1, -1).to(torch.float32)
    pre = None
    if want_preact:
        pre = y.to(out_dtype)
        y = pre.to(torch.float32)
    if activation == "gelu":
        y = _gelu(y)
    if residual is not None:
        y = y + residual.to(torch.float32)
    out = y.to(out_dtype)
    return (out, pre) if want_preact else out


def _rows_ok(t: torch.Tensor) -> bool:
    """Last dim contiguous and rows on a 16-byte boundary: the kernels
    load 16 bytes per lane (8 in bf16 at a K-block of 128)."""
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


def _kernel_bk(K: int, bk: int) -> None:
    if bk < 128 or bk > _MAX_BK or bk & (bk - 1) or K % bk:
        raise ValueError(f"the kernels need a power-of-two K-block of 128 "
                         f"to {_MAX_BK} dividing K={K}, got {bk}")


def _kernel_n(N: int) -> None:
    if N % _TILE_N:
        raise ValueError(f"the kernels need N % {_TILE_N} == 0, got {N}")


def _kernel_input(x: torch.Tensor, K: int, bk: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"quantized matmuls run on cuda or cpu, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernels take fp32/bf16 activations, got "
                         f"{x.dtype}")
    _kernel_bk(K, bk)


def _kernel_shape(x: torch.Tensor, K: int, N: int, bk: int) -> None:
    _kernel_input(x, K, bk)
    _kernel_n(N)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary (TMA's and the vector
    loads' requirement), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def quantize_blocks(a, bk: int, pre=None, sf=None, *, want_g: bool = False,
                    sx=None):
    """Kernel A of K4/K5/K8: per-(row, K-block) int8 codes and scales of ``v =
    a [* gelu'(pre)] [* sf]`` (and ``g``, ``v`` before the fold, with
    ``want_g``); with ``sx [K / bk, M]`` the codes take those scales (a
    K-block split over tensor-parallel shards: the block's scale is the
    max over the shards, :func:`split_k_codes`).  See
    :func:`quantize_blocks_reference`; on a CPU tensor it is that plain
    version.  Returns ``(q [M, K] int8, sx [K / bk, M] fp32, g or
    None)``."""
    if a.device.type == "cpu":
        return quantize_blocks_reference(a, bk, pre, sf, want_g=want_g,
                                         sx=sx)
    M, K = a.shape
    _kernel_input(a, K, bk)
    if want_g and pre is None:
        raise ValueError("want_g needs pre: g is v before the fold")
    a = _rows(a)
    if pre is not None:
        _check_cuda("pre", pre, a, a.dtype)
        if pre.shape != a.shape:
            raise ValueError(f"pre shape {tuple(pre.shape)} != "
                             f"{tuple(a.shape)}")
        pre = _rows(pre)
    if sf is not None:
        _check_cuda("sf", sf, a, torch.float32)
        if sf.numel() != K:
            raise ValueError(f"sf has {sf.numel()} values, K is {K}")
        sf = _aligned(sf)          # read 16 bytes a lane
    sx_in = sx
    if sx_in is not None:
        _check_cuda("sx", sx_in, a, torch.float32)
        if tuple(sx_in.shape) != (K // bk, M):
            raise ValueError(f"given sx of shape {tuple(sx_in.shape)}, "
                             f"expected ({K // bk}, {M})")
        sx_in = sx_in.contiguous()
    q = torch.empty(M, K, dtype=torch.int8, device=a.device)
    sx = torch.empty(K // bk, M, dtype=torch.float32, device=a.device)
    g = torch.empty(M, K, dtype=a.dtype, device=a.device) if want_g \
        else None
    if M:
        kernels.launch(
            "quant_blocks", a.device, a.data_ptr(),
            None if pre is None else pre.data_ptr(),
            None if sf is None else sf.data_ptr(), q.data_ptr(),
            sx.data_ptr(), None if g is None else g.data_ptr(),
            None if sx_in is None else sx_in.data_ptr(), M, K, bk,
            a.stride(0), 0 if pre is None else pre.stride(0),
            _DTYPE_CODE[a.dtype])
        global quantize_launches
        quantize_launches += 1
    return q, sx, g


def blocked_gemm(q, sx, w, bk: int, sw=None, bias=None, residual=None, *,
                 activation: str | None = None, want_preact: bool = False,
                 out_dtype=torch.float32):
    """Kernel B of K4/K5/K8: the block-scaled int8 GEMM of codes ``q [M, K]``
    and scales ``sx [K / bk, M]`` (:func:`quantize_blocks`) against the
    K-major weight ``w [N, K]`` int8, with K4's epilogue when ``sw`` is
    given.  See :func:`blocked_gemm_reference`; on a CPU tensor it is that
    plain version."""
    if q.device.type == "cpu":
        return blocked_gemm_reference(
            q, sx, w, bk, sw, bias, residual, activation=activation,
            want_preact=want_preact, out_dtype=out_dtype)
    M, K = q.shape
    N = w.shape[0]
    if q.dtype != torch.int8 or tuple(w.shape) != (N, K):
        raise ValueError(f"codes {q.dtype} {tuple(q.shape)} against weight "
                         f"{w.dtype} {tuple(w.shape)}: int8 [M, K], [N, K]")
    _check_cuda("w", w, q, torch.int8)
    _check_cuda("sx", sx, q, torch.float32)
    if tuple(sx.shape) != (K // bk, M):
        raise ValueError(f"sx shape {tuple(sx.shape)} != ({K // bk}, {M})")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernels write fp32/bf16, got {out_dtype}")
    _kernel_bk(K, bk)
    _kernel_n(N)
    if sw is None and (bias is not None or residual is not None
                       or activation or want_preact):
        raise ValueError("the epilogue (bias, residual, gelu, preact) "
                         "comes with the weight scale sw")
    q, sx, w = _aligned(q), sx.contiguous(), _aligned(w)
    if sw is not None:
        _check_cuda("sw", sw, q, torch.float32)
        sw = sw.reshape(-1).contiguous()
    if bias is not None:
        _check_cuda("bias", bias, q)
        bias = bias.reshape(-1).to(torch.float32).contiguous()
    if residual is not None:
        _check_cuda("residual", residual, q, out_dtype)
        residual = residual.contiguous()
    out = torch.empty(M, N, dtype=out_dtype, device=q.device)
    pre = torch.empty_like(out) if want_preact else None
    if M:
        kernels.launch(
            "quant_gemm", q.device, q.data_ptr(), sx.data_ptr(),
            w.data_ptr(), None if sw is None else sw.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), None if pre is None else pre.data_ptr(),
            M, N, K, bk, int(activation == "gelu"), _DTYPE_CODE[out_dtype])
        global gemm_launches
        gemm_launches += 1
    return (out, pre) if want_preact else out


def split_k_codes(parts, block_k: int, pres=None, sfs=None, *,
                  want_g: bool = False):
    """The codes of an activation whose K is split over tensor-parallel
    shards (``parts[j]`` [M, K / n] in order, with ``pres[j]`` /
    ``sfs[j]`` for K5's prologue), quantized as the unsharded quantize
    pass quantizes the whole: per (row, K-block of ``_block_k(K,
    block_k)`` over the WHOLE K).  Each shard runs kernel A on its part at
    ``bk = gcd(K-block, K / n)``; where a K-block spans shards
    (``bk`` below the K-block) the block's scale is the max of its parts'
    scales (``_scale`` is monotonic, so that is the scale of the block's
    amax), and each shard runs kernel A again with those scales given.
    Returns ``([(q_j, sx_j, g_j)], bk)``: each shard's codes, scales [K /
    n / bk, M] and g, at GEMM block width ``bk``."""
    import math
    n = len(parts)
    Kj = parts[0].shape[1]
    block = _block_k(Kj * n, block_k)
    bk = math.gcd(block, Kj)
    pres = pres or [None] * n
    sfs = sfs or [None] * n
    out = [quantize_blocks(a, bk, p, f, want_g=want_g)
           for a, p, f in zip(parts, pres, sfs)]
    if bk == block:
        return out, bk
    home = parts[0].device
    r = block // bk
    scales = torch.cat([sx.to(home) for _, sx, _ in out])
    given = scales.reshape(-1, r, scales.shape[1]).amax(dim=1)
    given = given.repeat_interleave(r, dim=0).chunk(n)
    return [quantize_blocks(a, bk, p, f, want_g=want_g, sx=sx.to(a.device))
            for a, p, f, sx in zip(parts, pres, sfs, given)], bk


def quantized_matmul_split_k(parts, qws, sw, *, block_k: int = 512) -> list:
    """K4 over a K split across tensor-parallel shards (row parallel):
    ``parts[j]`` [M, K / n] and ``qws[j]`` [K / n, N], shard ``j``'s rows
    of the weight quantized with the whole K's column scales ``sw`` [1, N]
    (:func:`col_scales`).  Returns each shard's fp32 partial ``acc_j *
    sw`` [M, N] on its device, no bias: their fp32 sum, plus the bias
    once and rounded once, is the unsharded K4's output up to fp32
    re-association.  One K4 call a shard on CUDA tensors (its kernel A
    twice where a K-block spans shards, :func:`split_k_codes`)."""
    global launches
    codes, bk = split_k_codes(parts, block_k)
    out = []
    for (q, sx, _), qw in zip(codes, qws):
        out.append(blocked_gemm(q, sx, transpose_s8(qw), bk,
                                sw.to(q.device), out_dtype=torch.float32))
        if q.device.type != "cpu":
            launches += 1
    return out


def quantized_matmul_nt_split_k(das, qws, sws, pres=None, *,
                                prologue: str = "fold",
                                want_g: bool = False,
                                block_k: int = 512):
    """K5 over a K split across tensor-parallel shards (the column
    parallel layer's dgrad): ``das[j]`` [M, K / n] (and ``pres[j]`` for
    ``dgelu_fold``), ``qws[j]`` [N, K / n] / ``sws[j]`` [1, K / n] the
    forward's quantized weight of shard ``j``.  Returns ``(partials,
    gs)``: each shard's fp32 ``acc_j`` [M, N] (their sum rounded once is
    the unsharded K5's dx) and, with ``want_g``, its g in da.dtype.  One
    K5 call a shard on CUDA tensors."""
    global nt_launches
    codes, bk = split_k_codes(
        das, block_k, pres if prologue == "dgelu_fold" else None, sws,
        want_g=want_g)
    out = []
    for (q, sx, _), qw in zip(codes, qws):
        out.append(blocked_gemm(q, sx, qw, bk, out_dtype=torch.float32))
        if q.device.type != "cpu":
            nt_launches += 1
    return out, [g for _, _, g in codes]


def transpose_s8(w):
    """``w [R, C]`` int8 -> its transpose ``[C, R]``, contiguous: K4's and
    K8's weight made K-major for kernel B (wgmma takes 8-bit operands K-major
    only).  A kernel of its own on a CUDA tensor (R and C multiples of
    64), ``w.t().contiguous()`` on a CPU tensor."""
    if w.device.type == "cpu":
        return w.t().contiguous()
    R, C = w.shape
    if w.dtype != torch.int8 or R % 64 or C % 64:
        raise ValueError(f"the transpose kernel takes int8 [R, C] with R "
                         f"and C multiples of 64, got {w.dtype} "
                         f"{tuple(w.shape)}")
    w = _aligned(w)
    out = torch.empty(C, R, dtype=torch.int8, device=w.device)
    kernels.launch("transpose_s8", w.device, w.data_ptr(), out.data_ptr(),
                   R, C)
    global transpose_launches
    transpose_launches += 1
    return out


def quantized_matmul(x, qw, sw, bias=None, residual=None, *,
                     activation: str | None = None,
                     want_preact: bool = False, block_k: int = 512):
    """``x [M, K] (bf16/fp32) @ (qw [K, N] int8 * sw [1, N])`` -> x.dtype,
    with x quantized per (row, K-block) and the epilogue of
    :func:`quantized_matmul_reference`.  Returns ``(y, pre)`` with
    ``want_preact``.  K4 on a CUDA tensor (kernel A, the quantize pass,
    the weight's transpose, then kernel B, the GEMM with the epilogue),
    the plain version on a CPU tensor."""
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
    if M == 0:
        out = torch.empty(0, N, dtype=x.dtype, device=x.device)
        return (out, torch.empty_like(out)) if want_preact else out
    q, sx, _ = quantize_blocks(x, bk)
    # wgmma takes 8-bit operands K-major only: one int8 transpose of the
    # weight per call (N * K bytes each way).
    out = blocked_gemm(q, sx, transpose_s8(qw), bk, sw, bias, residual,
                       activation=activation, want_preact=want_preact,
                       out_dtype=x.dtype)
    global launches
    launches += 1
    return out


def quantized_matmul_nt(da, qw, sw, pre=None, *, prologue: str = "fold",
                        want_g: bool = False, block_k: int = 512):
    """Dgrad against the forward's quantized weight: ``da [M, K]``, ``qw
    [N, K]`` / ``sw [1, K]`` (the forward's :func:`quantize_cols` output,
    contracted on its last axis) -> ``dx [M, N]`` in da.dtype, and the
    unfolded ``g`` with ``want_g``.  See
    :func:`quantized_matmul_nt_reference`.  K5 on a CUDA tensor (kernel A
    with the gelu' and fold prologue, then kernel B), the plain version on
    a CPU tensor."""
    if da.device.type == "cpu":
        return quantized_matmul_nt_reference(
            da, qw, sw, pre, prologue=prologue, want_g=want_g,
            block_k=block_k)
    M, K, N = _check_nt(da, qw, sw, pre, prologue, want_g)
    bk = _block_k(K, block_k)
    _kernel_shape(da, K, N, bk)
    _check_cuda("qw", qw, da, torch.int8)
    _check_cuda("sw", sw, da, torch.float32)
    if M == 0:
        out = torch.empty(0, N, dtype=da.dtype, device=da.device)
        return (out, torch.empty_like(da)) if want_g else out
    q, sx, g = quantize_blocks(da, bk, pre, sw, want_g=want_g)
    out = blocked_gemm(q, sx, qw, bk, out_dtype=da.dtype)
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
    a CUDA tensor (kernel A with the gelu' prologue, the weight's
    transpose, then kernel B with the ``* swt`` epilogue),
    :func:`quantized_matmul_dgelu_reference` on a CPU tensor."""
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
    if M == 0:
        out = torch.empty(0, N, dtype=da.dtype, device=da.device)
        return (out, torch.empty_like(da)) if want_g else out
    # Kernel A with gelu' and g but no fold, the weight made K-major, then
    # kernel B with the bare ``* swt`` epilogue.
    q, sx, g = quantize_blocks(da, bk, pre, want_g=want_g)
    out = blocked_gemm(q, sx, transpose_s8(qwt), bk, swt, out_dtype=da.dtype)
    global dgelu_launches
    dgelu_launches += 1
    return (out, g) if want_g else out
