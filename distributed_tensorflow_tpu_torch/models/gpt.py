"""GPT decoder-only LM, the training and serving subset of
``distributed_tensorflow_tpu/models/gpt.py`` in PyTorch.

Pre-LayerNorm decoder: activations in ``cfg.dtype`` (bf16 by default)
with fp32 LayerNorm and softmax, causal attention through
:func:`..ops.attention.dot_product_attention` (``attention_backend``
``"xla"`` is plain tensor code, ``"pallas"`` the flash-attention kernels,
forward and backward, ``"ring"`` sequence-parallel ring attention over a
mesh's ``seq`` axis through the ring's chunk kernels), LayerNorms through
the LayerNorm kernel when ``fused_ln``.

A ``ring`` model's blocks hold their mesh: given to :class:`GptLM` (or
``build_gpt_mini``) as ``mesh=``, or captured from
:func:`..ops.attention.attention_mesh` at a block's first call, as a
jitted JAX program captures it when traced.  The backward's recomputation
under remat then finds it outside any ``with attention_mesh(...)``.

Parameters keep the JAX package's names and kernel layouts (flax
``Dense`` kernels are [in, out], ``DenseGeneral`` kernels e.g.
[hidden, 3, heads, head_dim]), so :func:`params_from_jax` only renames
and converts, and the int8 per-channel rule of :mod:`..ops.quant` groups
the same values as in JAX.  Projection and MLP weights are stored in
``param_dtype`` and cast to ``cfg.dtype`` at each call, as flax does.
A model built for training passes ``param_dtype=torch.float32``: fp32
master weights, as flax keeps them (bf16 parameters would round small
optimizer updates away).  Serving leaves the default, ``cfg.dtype``
storage: the same values reach the matmuls in half the memory.
Embeddings, norms and the LM head are fp32 either way, as flax leaves
them.

Training (:meth:`GptLM.forward` in ``train()`` mode with a generator):
dropout on the embedding, the attention output and the MLP output, as in
the JAX model, drawn from explicit generators; ``cfg.remat`` recomputes
each block in the backward (``torch.utils.checkpoint``), as
``nn.remat(GptBlock)`` does.

Serving entry points (:meth:`GptLM.prefill`, :meth:`GptLM.decode_paged`,
:meth:`GptLM.decode_chunk_paged`, :meth:`GptLM.prefill_chunk_paged`)
run under ``torch.no_grad()`` and update the KV caches and pools IN
PLACE, where the JAX code returns new arrays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import default_mesh, dot_product_attention
from ..ops.layer_norm import LayerNorm
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GptConfig:
    vocab_size: int = 256           # byte-level
    hidden_size: int = 128
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 512
    max_position: int = 512
    dropout_rate: float = 0.0
    dtype: str = "bfloat16"
    attention_backend: str = "xla"
    remat: bool = False
    # Route LayerNorms through the LayerNorm kernel; same math and
    # parameters as the plain version.
    fused_ln: bool = False
    # "learned" (absolute position table) or "rope" (rotary, no table).
    pos_encoding: str = "learned"
    # Grouped-query attention: K/V heads (0 = num_heads, plain MHA).
    kv_heads: int = 0
    # Sliding-window attention (0 = full causal).
    attention_window: int = 0
    # "gelu" (GPT-2 style) or "swiglu" (gated SiLU, bias-free MLP).
    activation: str = "gelu"
    # "layernorm" or "rmsnorm" (no centring, no bias).
    norm: str = "layernorm"
    # Train-time int8 matmuls (ops/quant_train.py): the MLP's Dense layers
    # (the whole gelu MLP through the int8 kernels where the shapes allow),
    # and the attention projections.
    matmul_int8: bool = False
    attn_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.kv_heads or self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def __post_init__(self):
        if self.pos_encoding not in ("learned", "rope"):
            raise ValueError(f"Unknown pos_encoding {self.pos_encoding!r}; "
                             "one of ('learned', 'rope')")
        if self.activation not in ("gelu", "swiglu"):
            raise ValueError(f"Unknown activation {self.activation!r}; "
                             "one of ('gelu', 'swiglu')")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"Unknown norm {self.norm!r}; "
                             "one of ('layernorm', 'rmsnorm')")
        if self.norm == "rmsnorm" and self.fused_ln:
            raise ValueError("fused_ln is the LayerNorm kernel; "
                             "it does not apply to norm='rmsnorm'")
        if self.kv_heads < 0 or (self.kv_heads
                                 and self.num_heads % self.kv_heads):
            raise ValueError(
                f"num_heads={self.num_heads} must be divisible by "
                f"kv_heads={self.kv_heads} (and kv_heads must be >= 0)")


def mini() -> GptConfig:
    return GptConfig()


def infer_arch_from_layer0(layer0: dict) -> dict:
    """Architecture knobs a checkpoint's first decoder block reveals:
    swiglu adds a gate matrix, rmsnorm's norm carries no bias, GQA's kv
    projection is [in, 2, G, D]."""
    arch = {
        "activation": "swiglu" if "mlp_gate" in layer0 else "gelu",
        "norm": ("layernorm" if "bias" in layer0.get("ln_attn", {})
                 else "rmsnorm"),
    }
    if "kv_proj" in layer0:
        arch["kv_heads"] = int(layer0["kv_proj"]["kernel"].shape[-2])
    return arch


# ---------------------------------------------------------------- layers


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``nn.DenseGeneral``: ``kernel`` [*in, *out]
    contracts the last ``len(in_shape)`` axes of the input; ``bias``
    [*out].  With ``dtype`` set, input, kernel and bias are cast to it
    (flax's compute dtype); without, to their promoted dtype.  ``int8``
    routes the contraction through ``ops.quant_train.int8_matmul`` on the
    cast operands (the JAX package's ``int8_dot_general`` injection: the
    flattened 2-D product, its weight gradient in the compute dtype)."""

    def __init__(self, in_shape: tuple, out_shape: tuple, *,
                 dtype: torch.dtype | None, param_dtype: torch.dtype,
                 use_bias: bool = True, int8: bool = False, device=None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.int8 = int8
        self.kernel = nn.Parameter(torch.empty(
            *self.in_shape, *self.out_shape, dtype=param_dtype,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(
            self.out_shape, dtype=param_dtype, device=device))
            if use_bias else None)

    @property
    def fan_in(self) -> int:
        return math.prod(self.in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.kernel, self.bias
        dt = self.dtype or torch.promote_types(x.dtype, kernel.dtype)
        n_out = math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        matmul = torch.matmul
        if self.int8:
            from ..ops.quant_train import int8_matmul as matmul
        y = matmul(x.reshape(-1, self.fan_in).to(dt),
                   kernel.reshape(self.fan_in, n_out).to(dt))
        if bias is not None:
            y = y + bias.reshape(n_out).to(dt)
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` [num, features], fp32."""

    def __init__(self, num: int, features: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(
            num, features, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows of ``ids``; ids outside the table give NaN rows, as
        ``jnp.take``'s default mode (and so flax's ``Embed``) does, where
        indexing would raise (on a card, a device-side assert): a
        speculative chunk's drafts may run past ``max_position``."""
        num = self.embedding.shape[0]
        rows = self.embedding[ids.clamp(0, num - 1)]
        inside = ((ids >= 0) & (ids < num))[..., None]
        return torch.where(inside, rows, torch.nan)


class RMSNorm(nn.Module):
    """Root-mean-square norm (no centring, no bias), fp32 compute; the
    output keeps the input dtype.  Parameters: ``scale`` only."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        rms = torch.sqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return ((x32 / rms) * self.scale).to(x.dtype)


def _norm(cfg: GptConfig, device) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.hidden_size, device=device)
    return LayerNorm(cfg.hidden_size, fused=cfg.fused_ln, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on [B, S, H, D] (D even): rotate each
    (x[..i], x[..i + D/2]) pair by position * base^(-2i/D).
    ``positions``: [S] or [B, S]."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"rope needs an even head_dim, got {D}")
    half = D // 2
    inv_freq = base ** (-torch.arange(half, dtype=torch.float32,
                                      device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * inv_freq  # [B,S,half]
    sin = torch.sin(angles)[:, :, None, :]                     # [B,S,1,half]
    cos = torch.cos(angles)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A uint8 view of a float8 tensor (indexing kernels are not built for
    every float8 dtype on every device); other tensors unchanged."""
    if t.element_size() == 1 and t.is_floating_point():
        return t.view(torch.uint8)
    return t


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - rate`` and scale what is kept by ``1 / (1 - rate)``.  The mask is
    drawn on ``x``'s device from ``generator``."""
    keep_prob = 1.0 - rate
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _generator(seed: int | None, device) -> torch.Generator | None:
    """A generator on ``device`` seeded by ``seed`` (None: no dropout)."""
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Each row's pages of ``pool`` [num_pages, page, G, D] as one
    contiguous [B, MP * page, G, D] in ``dtype``; sentinel table entries
    (``num_pages``) read as zeros, as ``jnp.take(..., mode="fill")``.
    The whole table is gathered: the paged decode step and the paged
    chunk share this copy."""
    num_pages, page = pool.shape[0], pool.shape[1]
    B, MP = page_table.shape
    allocated = page_table < num_pages
    safe = page_table.clamp(max=num_pages - 1).long()
    rows = _bits(pool)[safe].view(pool.dtype).to(dtype)
    rows = torch.where(allocated[:, :, None, None, None], rows, 0)
    return rows.reshape(B, MP * page, *pool.shape[2:])


def paged_allocated(page_table: torch.Tensor, num_pages: int,
                    page: int) -> torch.Tensor:
    """[B, MP * page]: whether each logical slot's page is allocated."""
    return (page_table < num_pages).repeat_interleave(page, dim=1)


def chunk_write_index(page_table: torch.Tensor, positions: torch.Tensor,
                      K: int, num_pages: int, page: int):
    """Where a K-token chunk's K/V land in a paged pool: ``(rows, cols,
    phys, off)`` for the chunk tokens (row b, column i at logical position
    ``positions[b] + i``) whose page is allocated.  A token whose logical
    page falls outside the table goes to the sentinel ``num_pages``, as a
    sentinel table entry does, and both are left out: the write is
    dropped, never clamped onto the last real page (the JAX code scatters
    through the sentinel with ``mode="drop"``).  One host sync."""
    MP = page_table.shape[1]
    pos = positions[:, None] + torch.arange(K, device=positions.device)
    lpage = pos // page
    phys = torch.gather(page_table, 1, lpage.clamp(0, MP - 1).long())
    phys = torch.where(lpage < MP, phys, num_pages)
    rows, cols = torch.nonzero(phys < num_pages, as_tuple=True)
    return rows, cols, phys[rows, cols].long(), (pos[rows, cols]
                                                 % page).long()


def paged_write_index(page_table: torch.Tensor, positions: torch.Tensor,
                      num_pages: int, page: int):
    """Where each row's new token lands in a paged pool: ``(rows, phys,
    off)`` for the rows whose page is allocated.  Rows whose table entry
    is the sentinel ``num_pages`` (idle lanes) are left out, so they
    write nowhere; the JAX code instead scatters through the out-of-bounds
    sentinel with ``mode="drop"``.  One host sync, taken once per step."""
    MP = page_table.shape[1]
    lpage = (positions // page).clamp(0, MP - 1)
    phys = torch.gather(page_table, 1, lpage[:, None].long())[:, 0]
    rows = torch.nonzero(phys < num_pages).flatten()
    return rows, phys[rows].long(), (positions[rows] % page).long()


class GptBlock(nn.Module):
    """One pre-LN decoder block."""

    def __init__(self, cfg: GptConfig, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = None              # the ring backend's (see the module doc)
        dtype = cfg.torch_dtype
        H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype,
                  device=device)
        # attn_int8: the same projections, their contraction in int8.
        proj = dict(kw, int8=cfg.attn_int8)
        self.ln_attn = _norm(cfg, device)
        if cfg.num_kv_heads == cfg.num_heads:
            self.qkv = Dense((H,), (3, nh, hd), **proj)
        else:
            self.q_proj = Dense((H,), (nh, hd), **proj)
            self.kv_proj = Dense((H,), (2, cfg.num_kv_heads, hd), **proj)
        self.out = Dense((nh, hd), (H,), **proj)
        self.ln_mlp = _norm(cfg, device)
        I = cfg.intermediate_size
        dense = Dense
        if cfg.matmul_int8:
            from ..ops.quant_train import Int8Dense as dense
        if cfg.activation == "swiglu":
            self.mlp_in = dense((H,), (I,), use_bias=False, **kw)
            self.mlp_gate = dense((H,), (I,), use_bias=False, **kw)
            self.mlp_out = dense((I,), (H,), use_bias=False, **kw)
        else:
            self.mlp_in = dense((H,), (I,), **kw)
            self.mlp_out = dense((I,), (H,), **kw)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor | None = None):
        """q [B,S,H,D] and k/v [B,S,G,D] (views into the fused
        projection's output in plain MHA)."""
        cfg = self.cfg
        h = self.ln_attn(x).to(cfg.torch_dtype)
        if cfg.num_kv_heads == cfg.num_heads:
            qkv = self.qkv(h)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self.q_proj(h)
            kv = self.kv_proj(h)
            k, v = kv[:, :, 0], kv[:, :, 1]
        if cfg.pos_encoding == "rope":
            if positions is None:
                positions = torch.arange(x.shape[1], device=x.device)
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        return q, k, v

    def _expand_kv(self, kv: torch.Tensor) -> torch.Tensor:
        """Repeat G kv heads up to the H query heads."""
        groups = self.cfg.num_heads // self.cfg.num_kv_heads
        if groups == 1:
            return kv
        return torch.repeat_interleave(kv, groups, dim=2)

    def _drop(self, y: torch.Tensor,
              g: torch.Generator | None) -> torch.Tensor:
        return y if g is None else dropout(y, self.cfg.dropout_rate, g)

    def _mlp(self, x: torch.Tensor,
             g: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        h = self.ln_mlp(x).to(cfg.torch_dtype)
        if cfg.matmul_int8 and cfg.activation == "gelu":
            from ..ops import quant_train
            H = cfg.hidden_size
            M = h.numel() // H
            # Per call, on this call's rows: a decode step's few rows take
            # the Int8Dense formulation, as in the JAX package.
            if quant_train.use_fused_mlp(M, H, cfg.intermediate_size):
                params = (h.reshape(M, H), self.mlp_in.kernel,
                          self.mlp_in.bias, self.mlp_out.kernel,
                          self.mlp_out.bias)
                # The fused residual add cannot see a dropout mask.
                if quant_train.FUSED_MLP_RESIDUAL and g is None:
                    return quant_train.int8_gelu_mlp_res(
                        *params, x.reshape(M, H)).reshape(x.shape)
                y = quant_train.int8_gelu_mlp(*params)
                return x + self._drop(y.reshape(x.shape), g)
        if cfg.activation == "swiglu":
            h = F.silu(self.mlp_gate(h)) * self.mlp_in(h)
        else:
            h = F.gelu(self.mlp_in(h), approximate="tanh")   # flax nn.gelu
        return x + self._drop(self.mlp_out(h), g)

    def forward(self, x: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        """``seed`` (training with dropout) seeds the block's own generator,
        so a recomputation under remat draws the same masks; None runs
        without dropout."""
        g = _generator(seed, x.device)
        q, k, v = self._qkv(x)
        if self.cfg.attention_backend == "ring" and self.mesh is None:
            self.mesh = default_mesh()
        ctx = dot_product_attention(q, self._expand_kv(k),
                                    self._expand_kv(v), causal=True,
                                    window=self.cfg.attention_window,
                                    backend=self.cfg.attention_backend,
                                    mesh=self.mesh)
        x = x + self._drop(self.out(ctx), g)
        return self._mlp(x, g)

    @staticmethod
    def _write_prefill(cache: torch.Tensor, fresh: torch.Tensor) -> None:
        """Write the prompt's K or V rows into ``cache`` in place.  Plain
        cache (M >= P): positions [0, P) at slots [0, P).  Ring cache
        (sliding window, M < P): the last M positions, position p at slot
        p % M."""
        P, M = fresh.shape[1], cache.shape[1]
        fresh = fresh.to(cache.dtype)
        if P <= M:
            _bits(cache)[:, :P] = _bits(fresh)
        else:
            _bits(cache).copy_(torch.roll(_bits(fresh[:, P - M:]),
                                          (P - M) % M, dims=1))

    @staticmethod
    def _write_prefill_ragged(cache: torch.Tensor, fresh: torch.Tensor,
                              lengths: torch.Tensor) -> None:
        """Ragged-prompt cache write in place: row b contributes only its
        ``lengths[b]`` real positions.  Gather formulation: slot s takes
        the LAST real position p < lengths[b] with p = s (mod M); slots
        no real position reaches keep their content."""
        B, P = fresh.shape[0], fresh.shape[1]
        M = cache.shape[1]
        lb1 = (lengths - 1).long()
        s = torch.arange(M, device=cache.device)
        p_star = lb1[:, None] - torch.remainder(lb1[:, None] - s[None, :], M)
        idx = p_star.clamp(0, P - 1)[..., None, None].expand(
            B, M, *fresh.shape[2:])
        src = _bits(torch.gather(fresh, 1, idx).to(cache.dtype))
        keep = (p_star >= 0)[..., None, None]
        _bits(cache).copy_(torch.where(keep, src, _bits(cache)))

    def prefill(self, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor | None = None):
        """The prompt's P tokens through the block in one causal pass,
        writing positions [0, P) into the caches (in place).  ``lengths``
        ([B], optional) marks right-padded ragged prompts: pad positions
        are then not written."""
        q, k, v = self._qkv(x)
        if lengths is None:
            self._write_prefill(k_cache, k)
            self._write_prefill(v_cache, v)
        else:
            self._write_prefill_ragged(k_cache, k, lengths)
            self._write_prefill_ragged(v_cache, v, lengths)
        # Sequence-parallel backends have no mesh when serving: dense.
        backend = ("xla" if self.cfg.attention_backend in ("ring", "ulysses")
                   else self.cfg.attention_backend)
        ctx = dot_product_attention(q, self._expand_kv(k),
                                    self._expand_kv(v), causal=True,
                                    window=self.cfg.attention_window,
                                    backend=backend)
        x = x + self.out(ctx)
        return self._mlp(x), k_cache, v_cache

    def _attend_cache(self, q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
        """Grouped attention of ``q`` [B, Q, H, D] against a cache
        [B, M, G, D]; ``valid`` broadcasts to [B, G, R, Q, M].  Narrow
        caches (float8) are upcast to the compute dtype on read; logits and
        softmax are fp32 and the weights go back to the compute dtype for
        the V product."""
        cfg = self.cfg
        depth = q.shape[-1]
        scale = 1.0 / math.sqrt(depth)
        compute = q.dtype
        B, Q = q.shape[0], q.shape[1]
        G, R = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        qg = q.reshape(B, Q, G, R, depth)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                              k_cache.to(compute).float()) * scale
        logits = torch.where(valid, logits, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bgrqk,bkgd->bqgrd", weights.to(compute),
                           v_cache.to(compute))
        return ctx.reshape(B, Q, cfg.num_heads, depth)

    def decode_step_paged(self, x: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          positions: torch.Tensor, write_index=None):
        """One token per row against a paged KV pool.

        ``k_pool``/``v_pool``: [num_pages, page_size, G, D]; row b's
        position p lives at page ``page_table[b, p // page_size]``, offset
        ``p % page_size``; ``num_pages`` in the table is the not-allocated
        sentinel.  The new K/V are written IN PLACE (``index_put_``); a
        sentinel row writes nowhere (see :func:`paged_write_index`, which
        the LM computes once per step and passes as ``write_index``), and
        sentinel pages read as zeros that the validity mask keeps unread.
        """
        if self.cfg.attention_window:
            raise ValueError(
                "paged decode needs full-cache addressing (position == "
                "logical slot); the windowed ring cache is not pageable")
        num_pages, page = k_pool.shape[0], k_pool.shape[1]
        MP = page_table.shape[1]
        q, k, v = self._qkv(x, positions=positions[:, None])   # [B,1,*,D]
        if write_index is None:
            write_index = paged_write_index(page_table, positions,
                                            num_pages, page)
        rows, phys, off = write_index
        _bits(k_pool).index_put_((phys, off),
                                 _bits(k[rows, 0].to(k_pool.dtype)))
        _bits(v_pool).index_put_((phys, off),
                                 _bits(v[rows, 0].to(v_pool.dtype)))
        s = torch.arange(MP * page, device=x.device)
        valid = ((s[None, :] <= positions[:, None])
                 & paged_allocated(page_table, num_pages, page))  # [B, S]
        ctx = self._attend_cache(q, paged_gather(k_pool, page_table, q.dtype),
                                 paged_gather(v_pool, page_table, q.dtype),
                                 valid[:, None, None, None, :])
        x = x + self.out(ctx)
        return self._mlp(x), k_pool, v_pool

    def _attend_cache_chunk(self, q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, prefix_valid: torch.Tensor,
                            chunk_valid: torch.Tensor) -> torch.Tensor:
        """A K-token chunk's attention in one softmax over ``[prefix |
        chunk]`` logits: the K queries [B, K, H, D] attend the committed
        cache [B, M, G, D] through one shared ``prefix_valid`` [B, M] mask,
        and the chunk's own ``k_new`` / ``v_new`` [B, K, G, D] through the
        ``chunk_valid`` [K, K] intra-chunk mask.  Logits in fp32, masked
        with fp32's lowest value; the weights go back to the compute dtype
        for the two V products."""
        cfg = self.cfg
        depth = q.shape[-1]
        scale = 1.0 / math.sqrt(depth)
        compute = q.dtype
        B, K, M = q.shape[0], q.shape[1], k_cache.shape[1]
        G, R = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        qg = q.reshape(B, K, G, R, depth).float()
        neg = torch.finfo(torch.float32).min
        lp = torch.einsum("bqgrd,bkgd->bgrqk", qg,
                          k_cache.to(compute).float()) * scale
        lp = torch.where(prefix_valid[:, None, None, None, :], lp, neg)
        lc = torch.einsum("bqgrd,bjgd->bgrqj", qg,
                          k_new.to(compute).float()) * scale
        lc = torch.where(chunk_valid, lc, neg)
        w = torch.softmax(torch.cat([lp, lc], dim=-1), dim=-1)
        ctx = (torch.einsum("bgrqk,bkgd->bqgrd", w[..., :M].to(compute),
                            v_cache.to(compute))
               + torch.einsum("bgrqj,bjgd->bqgrd", w[..., M:].to(compute),
                              v_new.to(compute)))
        return ctx.reshape(B, K, cfg.num_heads, depth)

    def decode_chunk_paged(self, x: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           positions: torch.Tensor, write_index=None):
        """K tokens per row against a paged KV pool in one pass: row b's
        chunk token i sits at logical position ``positions[b] + i``.  The
        chunk's K/V are cast to the pool's dtype (the values a later step
        reads back from the pool, float8 included), written IN PLACE
        (see :func:`chunk_write_index`: a token past the page table is
        dropped), and attended fresh through the causal intra-chunk mask;
        the committed prefix is the slots before ``positions[b]`` on
        allocated pages (:meth:`_attend_cache_chunk`).  Slots at or past
        the frontier hold this chunk or junk from rejected drafts, masked
        until real tokens overwrite them."""
        if self.cfg.attention_window:
            raise ValueError(
                "paged decode needs full-cache addressing (position == "
                "logical slot); the windowed ring cache is not pageable")
        num_pages, page = k_pool.shape[0], k_pool.shape[1]
        MP = page_table.shape[1]
        K = x.shape[1]
        ar = torch.arange(K, device=x.device)
        q, k, v = self._qkv(x, positions=positions[:, None] + ar[None, :])
        if write_index is None:
            write_index = chunk_write_index(page_table, positions, K,
                                            num_pages, page)
        rows, cols, phys, off = write_index
        # The cache-dtype round trip before attending.
        k, v = k.to(k_pool.dtype), v.to(v_pool.dtype)
        _bits(k_pool).index_put_((phys, off), _bits(k)[rows, cols])
        _bits(v_pool).index_put_((phys, off), _bits(v)[rows, cols])
        s = torch.arange(MP * page, device=x.device)
        prefix_valid = ((s[None, :] < positions[:, None])
                        & paged_allocated(page_table, num_pages, page))
        chunk_valid = ar[:, None] >= ar[None, :]                  # causal
        ctx = self._attend_cache_chunk(
            q, paged_gather(k_pool, page_table, q.dtype),
            paged_gather(v_pool, page_table, q.dtype), k, v, prefix_valid,
            chunk_valid)
        x = x + self.out(ctx)
        return self._mlp(x), k_pool, v_pool


class GptLM(nn.Module):
    """Token + position embeddings -> pre-LN decoder stack -> LM head.

    ``device`` defaults to ``cuda`` (raises without CUDA: pass
    ``device="cpu"`` for the CPU).  Weights are drawn from flax's default
    initializers with a generator seeded by ``seed``.  ``param_dtype``
    stores the projection and MLP weights (default ``cfg.dtype``, the
    serving storage; training passes ``torch.float32`` masters).
    ``mesh``: the ``ring`` backend's mesh (else captured at first call)."""

    def __init__(self, cfg: GptConfig, *, device=None, seed: int = 0,
                 param_dtype: torch.dtype | None = None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        H = cfg.hidden_size
        self.word_emb = Embed(cfg.vocab_size, H, device=device)
        if cfg.pos_encoding != "rope":
            # flax creates pos_emb's parameters only when it is used.
            self.pos_emb = Embed(cfg.max_position, H, device=device)
        self.layers = nn.ModuleList(
            GptBlock(cfg, device=device, param_dtype=param_dtype)
            for _ in range(cfg.num_layers))
        for layer in self.layers:
            layer.mesh = mesh
        self.ln_final = _norm(cfg, device)
        self.lm_head = Dense((H,), (cfg.vocab_size,), dtype=None,
                             param_dtype=torch.float32, device=device)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """flax's defaults: Dense kernels truncated normal (+-2 sigma) with
        variance 1/fan_in, biases 0; embeddings normal with variance
        1/features; norms scale 1, bias 0.  Sampled in fp32 on the
        model's device from a generator seeded by ``seed``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, Dense):
                w = torch.empty(module.kernel.shape, dtype=torch.float32,
                                device=self.device)
                std = math.sqrt(1.0 / module.fan_in) / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                module.kernel.copy_(w)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, Embed):
                module.embedding.normal_(
                    0.0, 1.0 / math.sqrt(module.embedding.shape[1]),
                    generator=g)
            elif isinstance(module, (LayerNorm, RMSNorm)):
                module.scale.fill_(1.0)
                if isinstance(module, LayerNorm):
                    module.bias.zero_()

    def _embed(self, input_ids: torch.Tensor, positions: torch.Tensor,
               g: torch.Generator | None = None) -> torch.Tensor:
        x = self.word_emb(input_ids)
        if self.cfg.pos_encoding != "rope":
            x = x + self.pos_emb(positions)
        if g is not None:
            x = dropout(x, self.cfg.dropout_rate, g)
        return x.to(self.cfg.torch_dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_final(x))

    def forward(self, input_ids: torch.Tensor,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Logits [B, S, vocab].  Dropout runs in ``train()`` mode when
        ``cfg.dropout_rate > 0`` and then needs ``rng``: one seed per
        block (and one for the embedding) is drawn from it, the JAX
        model's per-call dropout key split."""
        cfg = self.cfg
        S = input_ids.shape[1]
        seeds = [None] * (cfg.num_layers + 1)
        if self.training and cfg.dropout_rate > 0.0:
            if rng is None:
                raise ValueError("dropout in training mode needs rng (a "
                                 "torch.Generator)")
            seeds = torch.randint(0, 2 ** 62, (cfg.num_layers + 1,),
                                  generator=rng, device=rng.device).tolist()
        x = self._embed(input_ids,
                        torch.arange(S, device=input_ids.device)[None, :],
                        _generator(seeds[0], input_ids.device))
        for layer, seed in zip(self.layers, seeds[1:]):
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, seed, use_reentrant=False)
            else:
                x = layer(x, seed)
        return self._head(x)  # [B, S, vocab]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, caches,
                lengths: torch.Tensor | None = None):
        """Parallel cache fill: the whole prompt [B, P] in one forward,
        K/V written (in place) to cache positions [0, P).  Returns
        (logits for the next position [B, vocab], caches)."""
        P = tokens.shape[1]
        x = self._embed(tokens, torch.arange(P, device=tokens.device)[None])
        for layer, (k_cache, v_cache) in zip(self.layers, caches):
            x, _, _ = layer.prefill(x, k_cache, v_cache, lengths)
        # Only the last position's logits matter: slice before the head.
        return self._head(x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_paged(self, token: torch.Tensor, pools,
                     page_tables: torch.Tensor, positions: torch.Tensor):
        """One token per row against per-layer paged KV pools (see
        :meth:`GptBlock.decode_step_paged`).  ``token`` [B]; ``pools``:
        [(k_pool, v_pool)] per layer, updated in place; ``page_tables``
        [B, MP]; ``positions`` [B].  Returns (logits [B, vocab], pools)."""
        x = self._embed(token[:, None], positions[:, None])
        num_pages, page = pools[0][0].shape[0], pools[0][0].shape[1]
        write_index = paged_write_index(page_tables, positions, num_pages,
                                        page)
        for layer, (k_pool, v_pool) in zip(self.layers, pools):
            x, _, _ = layer.decode_step_paged(x, k_pool, v_pool, page_tables,
                                              positions, write_index)
        return self._head(x)[:, 0], pools

    def _chunk_paged_body(self, tokens: torch.Tensor, pools,
                          page_tables: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
        """K tokens per row through the layer stack's paged chunk
        attention (:meth:`GptBlock.decode_chunk_paged`), the pools updated
        in place.  One body for the speculative verify and the chunked
        prefill, so that neither can drift from the other.  Returns the
        last block's output [B, K, hidden]."""
        K = tokens.shape[1]
        pos = positions[:, None] + torch.arange(K, device=tokens.device)
        x = self._embed(tokens, pos)
        num_pages, page = pools[0][0].shape[0], pools[0][0].shape[1]
        write_index = chunk_write_index(page_tables, positions, K,
                                        num_pages, page)
        for layer, (k_pool, v_pool) in zip(self.layers, pools):
            x, _, _ = layer.decode_chunk_paged(x, k_pool, v_pool,
                                               page_tables, positions,
                                               write_index)
        return x

    @torch.no_grad()
    def decode_chunk_paged(self, tokens: torch.Tensor, pools,
                           page_tables: torch.Tensor,
                           positions: torch.Tensor):
        """K tokens per row against per-layer paged pools, the serving
        engine's speculative verify: ``tokens`` [B, K] at positions
        ``positions[b] .. positions[b] + K - 1``.  Returns (logits [B, K,
        vocab], one next-token distribution per fed token; pools)."""
        x = self._chunk_paged_body(tokens, pools, page_tables, positions)
        return self._head(x), pools

    @torch.no_grad()
    def prefill_chunk_paged(self, tokens: torch.Tensor, pools,
                            page_tables: torch.Tensor,
                            positions: torch.Tensor):
        """The chunked prefill's per-step advance: :meth:`decode_chunk_paged`
        without the LM head (only the K/V writes are wanted).  Rows that
        are not prefilling ride along with sentinel tables: their writes
        drop and their outputs are ignored.  Returns the pools."""
        self._chunk_paged_body(tokens, pools, page_tables, positions)
        return pools


def _cache_dtype(cfg: GptConfig, dtype) -> torch.dtype:
    return cfg.torch_dtype if dtype is None else dtype


def init_kv_cache(cfg: GptConfig, batch_size: int, max_len: int,
                  dtype: torch.dtype | None = None, device=None):
    """Per-layer (k, v) caches [B, max_len, G, D] of zeros; a sliding
    window clamps ``max_len`` to the window (a ring cache)."""
    if cfg.attention_window:
        max_len = min(max_len, cfg.attention_window)
    shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    kw = dict(dtype=_cache_dtype(cfg, dtype), device=resolve_device(device))
    return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
            for _ in range(cfg.num_layers)]


def init_kv_pool(cfg: GptConfig, num_pages: int, page_size: int,
                 dtype: torch.dtype | None = None, device=None):
    """Per-layer (k, v) paged pools [num_pages, page_size, G, D] of
    zeros, the serving tier's shared KV memory."""
    if cfg.attention_window:
        raise ValueError("paged KV pools need full-cache addressing; "
                         "sliding-window checkpoints are not pageable")
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    kw = dict(dtype=_cache_dtype(cfg, dtype), device=resolve_device(device))
    return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
            for _ in range(cfg.num_layers)]


# ------------------------------------------------------- loss and data


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            label_smoothing: float = 0.0):
    """Next-token cross-entropy over positions 0..S-2 predicting 1..S-1.

    ``logits``: [B, S, vocab] from ``GptLM(tokens)``; targets are the same
    token stream shifted left.  Returns (loss, next-token accuracy), both
    0-dim tensors.  ``label_smoothing`` mixes the targets with uniform."""
    pred = logits[:, :-1]
    targets = tokens[:, 1:].long()
    logp = F.log_softmax(pred, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        ll = ((1.0 - label_smoothing) * ll
              + label_smoothing * logp.mean(dim=-1))
    loss = -ll.mean()
    acc = (pred.argmax(-1) == targets).float().mean()
    return loss, acc


def synthetic_lm_batch(seed: int, batch_size: int, seq_len: int,
                       cfg: GptConfig) -> dict:
    """Deterministic learnable byte stream: position-dependent affine bigram
    (numpy int32, the JAX package's stream bit for bit).

    ``x[t+1] = (3 * x[t] + t) % vocab`` with a random start and occasional
    noise tokens: a model must use both the previous token and its
    position, so a decoder learns it quickly while a unigram baseline
    cannot."""
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    toks = np.empty((batch_size, seq_len), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch_size)
    for t in range(seq_len - 1):
        toks[:, t + 1] = (3 * toks[:, t] + t) % vocab
    noise = rng.random((batch_size, seq_len)) < 0.02
    toks = np.where(noise, rng.integers(0, vocab, toks.shape), toks)
    return {"tokens": toks.astype(np.int32)}


# -------------------------------------------------------------- sampling


def _row_seed(seed: int, position: int) -> int:
    """(seed, position) -> one 32-bit generator seed.  The CPU generator
    keeps only 32 bits of its seed, so the pair is mixed (splitmix64's
    finaliser) and folded rather than concatenated."""
    x = ((int(seed) << 32) | int(position)) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return (x ^ (x >> 32)) & 0xFFFFFFFF


def row_uniforms(seeds, positions, vocab: int, rows=None) -> torch.Tensor:
    """[B, vocab] uniforms in [1e-20, 1), row b drawn from a CPU
    ``torch.Generator`` seeded by ``(seeds[b], positions[b])`` only, so a
    row's noise never depends on which other rows share the batch.  Rows
    not in ``rows`` (default: all) get 0.5, a finite placeholder for
    greedy lanes."""
    B = len(seeds)
    u = torch.full((B, vocab), 0.5, dtype=torch.float32)
    for b in (range(B) if rows is None else rows):
        g = torch.Generator()
        g.manual_seed(_row_seed(seeds[b], positions[b]))
        u[b] = torch.rand(vocab, generator=g).clamp_min_(1e-20)
    return u


def sample_logits_dynamic(step_logits: torch.Tensor, uniforms: torch.Tensor,
                          temperature: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-k / top-p sampling from [B, V] logits.

    ``top_k[b] > 0`` keeps the k highest logits, ``0 < top_p[b] < 1`` the
    smallest nucleus reaching that mass (the top token always survives);
    filters compose.  Rows with ``temperature[b] <= 0`` take the argmax.
    Selection is Gumbel-max over the filtered scaled logits in sorted
    space, with the noise given as ``uniforms`` [B, V] (see
    :func:`row_uniforms`) where the JAX code takes per-row PRNG keys: the
    same seed gives other bits than JAX's threefry."""
    V = step_logits.shape[-1]
    t = temperature.clamp_min(1e-6)[:, None]
    order = torch.argsort(-step_logits, dim=-1, stable=True)        # [B, V]
    sl = torch.gather(step_logits, -1, order) / t
    probs = torch.softmax(sl, dim=-1)
    idx = torch.arange(V, device=step_logits.device)[None, :]
    keep_k = (top_k[:, None] <= 0) | (idx < top_k[:, None])
    p = top_p[:, None]
    excl = torch.cumsum(probs, dim=-1) - probs     # exclusive mass
    keep_p = ~((p > 0.0) & (p < 1.0)) | (excl < p)
    filt = torch.where(keep_k & keep_p, sl, torch.finfo(sl.dtype).min)
    gumbel = -torch.log(-torch.log(uniforms))
    samp_sorted = torch.argmax(filt + gumbel, dim=-1)
    sampled = torch.gather(order, -1, samp_sorted[:, None])[:, 0]
    greedy = torch.argmax(step_logits, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)


# ------------------------------------------------- weights from the JAX tree


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaves(value, name + ".")
        else:
            yield name, value


def params_from_jax(tree: dict) -> dict:
    """The JAX package's GPT parameter tree (nested dicts of arrays, as
    ``model.init(...)["params"]`` gives after ``jax.device_get``) -> this
    module's ``state_dict`` (fp32 tensors; ``load_state_dict`` casts to
    each parameter's dtype).  Names map ``layer{i}`` -> ``layers.{i}``;
    every kernel keeps its flax layout: ``qkv`` [H, 3, heads, D],
    ``q_proj`` [H, heads, D], ``kv_proj`` [H, 2, G, D], ``out``
    [heads, D, H], Dense [in, out], Embed [V, H], norm ``scale``/``bias``
    [H]."""
    out = {}
    for name, leaf in _leaves(tree):
        head, _, rest = name.partition(".")
        if head.startswith("layer") and head[5:].isdigit():
            name = f"layers.{int(head[5:])}.{rest}"
        out[name] = torch.from_numpy(
            np.array(np.asarray(leaf), dtype=np.float32))
    return out


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_jax`: nested dicts of fp32 numpy
    arrays with the JAX package's names."""
    tree: dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{parts[1]}"] + parts[2:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().to("cpu", torch.float32).numpy()
    return tree
