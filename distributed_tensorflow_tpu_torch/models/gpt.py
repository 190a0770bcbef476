"""GPT decoder-only LM, the training, serving and decoding subset of
``distributed_tensorflow_tpu/models/gpt.py`` in PyTorch.

Pre-LayerNorm decoder: activations in ``cfg.dtype`` (bf16 by default)
with fp32 LayerNorm and softmax, causal attention through
:func:`..ops.attention.dot_product_attention` (``attention_backend``
``"xla"`` is plain tensor code, ``"pallas"`` the flash-attention kernels,
forward and backward, ``"ring"`` sequence-parallel ring attention over a
mesh's ``seq`` axis through the ring's chunk kernels), LayerNorms through
the LayerNorm kernel when ``fused_ln``.

A ``ring`` or ``ulysses`` model's blocks hold their mesh: given to
:class:`GptLM` (or ``build_gpt_mini``) as ``mesh=``, or captured from
:func:`..ops.attention.attention_mesh` at a block's first call, as a
jitted JAX program captures it when traced.  The backward's recomputation
under remat then finds it outside any ``with attention_mesh(...)``.

Tensor parallelism: :func:`gpt_sharding_rules` are the JAX package's
Megatron rules over the ``model`` axis, and a model placed by
``parallel/sharding.shard_state`` computes Megatron's way: ``qkv`` /
``q_proj`` / ``mlp_in`` / ``mlp_gate`` column parallel
(:meth:`Dense.column`), attention on each shard's heads (over its own
column of the mesh with a sequence-parallel backend), ``out`` /
``mlp_out`` row parallel (:meth:`Dense.row`: the partial products summed,
the bias added once), the embeddings vocab parallel and the LM head
column parallel, its logits gathered over the vocabulary.  LayerNorms,
residuals and dropout stay replicated, so the dropout masks are the
unsharded model's.

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
:meth:`GptLM.decode_chunk_paged`, :meth:`GptLM.prefill_chunk_paged`) and
the cached decode bodies (:meth:`GptLM.decode_step`,
:meth:`GptLM.decode_ragged`, :meth:`GptLM.decode_chunk`) run under
``torch.no_grad()`` and update the KV caches and pools IN PLACE, where the
JAX code returns new arrays.

The decode family (:func:`generate`, :func:`generate_cached`,
:func:`beam_search_cached`, :func:`generate_cached_speculative`,
:func:`generate_cached_speculative_device`) keeps the JAX functions'
names and arguments, with a ``torch.Generator`` for the JAX PRNG key and
``params`` a parameter mapping (None: the model's own weights), run as
the serving engine runs it (:class:`MethodCall`).  Sampled streams are
reproducible from the generator's seed but are not JAX's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.attention import default_mesh, dot_product_attention
from ..ops.layer_norm import LayerNorm
from ..ops.quant import (load_inference_tree, prepare_inference_tree,
                         resolve_kv_dtype)
from ..parallel.sharding import P, ShardingRules, full, shard_dim, shards
from ..utils.device import resolve_device
from . import drafting


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


def infer_widths(tree: dict) -> dict:
    """The widths a plain-layout checkpoint tree reveals: hidden size and
    vocabulary from ``word_emb``, depth from the ``layer{i}`` blocks, heads
    from ``qkv`` [H, 3, heads, D] (or GQA's ``q_proj`` [H, heads, D]), the
    MLP width from ``mlp_in``, and with learned positions ``max_position``
    from ``pos_emb``.  (The JAX package's restore takes all but the
    vocabulary from :func:`mini`, so it serves only checkpoints of
    ``mini()``'s widths; at those widths the two agree.)"""
    vocab, hidden = tree["word_emb"]["embedding"].shape
    layer0 = tree["layer0"]
    q = layer0["qkv"] if "qkv" in layer0 else layer0["q_proj"]
    widths = dict(vocab_size=int(vocab), hidden_size=int(hidden),
                  num_layers=sum(1 for k in tree if k.startswith("layer")
                                 and k[5:].isdigit()),
                  num_heads=int(q["kernel"].shape[-2]),
                  intermediate_size=int(layer0["mlp_in"]["kernel"].shape[1]))
    if "pos_emb" in tree:
        widths["max_position"] = int(tree["pos_emb"]["embedding"].shape[0])
    return widths


def merge_pipeline_params(pp_params, num_layers: int, n_virtual: int = 1):
    """Inverse of the JAX package's ``split_params_for_pipeline``: rebuild
    the plain tree (``word_emb``/``pos_emb``/``layer{i}``/``ln_final``/
    ``lm_head``) from a stage-stacked pipeline tree (``{"embed", "stages",
    "head"}``, every ``stages`` leaf [n_pipe, per, ...]), e.g. to decode
    from a checkpoint written by a ``--pipeline_parallel`` run.
    ``n_virtual`` > 1: an interleaved run's tree ([n_virtual, n_pipe, per,
    ...] leaves, chunk ``i * n_pipe + s`` at [i, s]); flattening the two
    chunk dims recovers the natural chunk-major stack.  Leaves may be
    tensors or numpy arrays."""
    def tree_map(fn, tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        return fn(tree)

    stages = pp_params["stages"]
    if n_virtual > 1:
        stages = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                          stages)
    flat = tree_map(lambda x: x.reshape((num_layers,) + tuple(x.shape[2:])),
                    stages)
    params = dict(pp_params["embed"])
    params.update(pp_params["head"])
    for i in range(num_layers):
        params[f"layer{i}"] = tree_map(lambda x: x[i], flat)
    return params


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
        dim = shard_dim(self, "kernel")
        if dim is not None:
            # Tensor parallel (parallel/sharding.py): the shards' products,
            # gathered along the output or summed over the input.
            if dim >= len(self.in_shape):
                return torch.cat(self.column(x), dim=x.dim() - len(
                    self.in_shape) + dim - len(self.in_shape))
            return self.row(list(x.chunk(len(shards(self, "kernel")),
                                         dim=x.dim() - len(self.in_shape)
                                         + dim)))
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

    #: Int8 matmuls beside tensor parallelism (``Int8Dense`` always;
    #: a ``Dense`` with ``int8``, the ``attn_int8`` projections).
    int8_tp = False

    def int8_weight(self, kernel: torch.Tensor, dtype) -> torch.Tensor:
        """The weight as the unsharded int8 path quantizes it: cast to
        the compute dtype first (``Int8Dense``: as stored)."""
        return kernel.to(dtype)

    def column(self, x: torch.Tensor) -> list:
        """Column parallel (the kernel split along an output dim): each
        shard's output [*lead, *out shard] on its shard's device, from the
        replicated ``x``; the bias is split the same way.  Int8: the
        unsharded int8 function's columns
        (``ops/quant_train.int8_matmul_column``)."""
        kernels = shards(self, "kernel")
        dim = shard_dim(self, "kernel") - len(self.in_shape)
        biases = shards(self, "bias")
        if biases is None:
            biases = ([None] * len(kernels) if self.bias is None
                      else list(self.bias.chunk(len(kernels), dim=dim)))
        lead = x.shape[:x.dim() - len(self.in_shape)]
        if self.int8 or self.int8_tp:
            from ..ops.quant_train import int8_matmul_column
            dt = self.dtype or torch.promote_types(x.dtype,
                                                   kernels[0].dtype)
            ys = int8_matmul_column(
                x.reshape(-1, self.fan_in).to(dt),
                [self.int8_weight(k, dt).reshape(self.fan_in, -1)
                 for k in kernels])
            outs = []
            for y, kernel, b in zip(ys, kernels, biases):
                if b is not None:
                    y = y + b.to(kernel.device).reshape(-1).to(y.dtype)
                outs.append(y.reshape(*lead, *kernel.shape[len(
                    self.in_shape):]))
            return outs
        outs = []
        for kernel, b in zip(kernels, biases):
            dt = self.dtype or torch.promote_types(x.dtype, kernel.dtype)
            out_shape = kernel.shape[len(self.in_shape):]
            n_out = math.prod(out_shape)
            h = x.to(kernel.device).reshape(-1, self.fan_in).to(dt)
            y = h @ kernel.reshape(self.fan_in, n_out).to(dt)
            if b is not None:
                y = y + b.to(kernel.device).reshape(n_out).to(dt)
            outs.append(y.reshape(*lead, *out_shape))
        return outs

    def row(self, parts: list) -> torch.Tensor:
        """Row parallel (the kernel split along an input dim): each
        shard's partial product of its input part, summed in fp32 on
        shard 0's device (the all-reduce), then the bias, once.  Int8: the
        shards' int32 products summed and rescaled once with the whole
        K's scales (``ops/quant_train.int8_matmul_row``)."""
        kernels = shards(self, "kernel")
        home = kernels[0].device
        n_out = math.prod(self.out_shape)
        lead = parts[0].shape[:parts[0].dim() - len(self.in_shape)]
        if self.int8 or self.int8_tp:
            from ..ops.quant_train import int8_matmul_row
            dt = self.dtype or torch.promote_types(parts[0].dtype,
                                                   kernels[0].dtype)
            xs, ws = [], []
            for x, kernel in zip(parts, kernels):
                fan_in = math.prod(kernel.shape[:len(self.in_shape)])
                xs.append(x.to(kernel.device).reshape(-1, fan_in).to(dt))
                ws.append(self.int8_weight(kernel, dt).reshape(fan_in,
                                                               n_out))
            y = int8_matmul_row(xs, ws)
            bias = full(self, "bias")
            if bias is not None:
                y = y + bias.to(home).reshape(n_out).to(dt)
            return y.reshape(*lead, *self.out_shape)
        total, dt = None, None
        for x, kernel in zip(parts, kernels):
            dt = self.dtype or torch.promote_types(x.dtype, kernel.dtype)
            fan_in = math.prod(kernel.shape[:len(self.in_shape)])
            y = (x.to(kernel.device).reshape(-1, fan_in).to(dt)
                 @ kernel.reshape(fan_in, n_out).to(dt))
            y = y.to(home, torch.float32)
            total = y if total is None else total + y
        y = total.to(dt)
        bias = full(self, "bias")
        if bias is not None:
            y = y + bias.to(home).reshape(n_out).to(dt)
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
        speculative chunk's drafts may run past ``max_position``.

        A table split over the model axis on its rows (vocab parallel):
        each shard looks up the ids in its own range, the others give
        zero rows, and the shards' rows are summed on shard 0's device."""
        tables = shards(self, "embedding")
        if tables is None or shard_dim(self, "embedding") != 0:
            table = full(self, "embedding")
            num = table.shape[0]
            rows = table[ids.clamp(0, num - 1)]
            inside = ((ids >= 0) & (ids < num))[..., None]
            return torch.where(inside, rows, torch.nan)
        home = tables[0].device
        rows, start = None, 0
        for table in tables:
            n = table.shape[0]
            local = ids.to(table.device) - start
            inside = ((local >= 0) & (local < n))[..., None]
            part = torch.where(inside, table[local.clamp(0, n - 1)], 0.0)
            rows = part.to(home) if rows is None else rows + part.to(home)
            start += n
        inside = ((ids >= 0) & (ids < start))[..., None].to(home)
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


def write_rows(dst: torch.Tensor, start: torch.Tensor, src: torch.Tensor,
               mask: torch.Tensor | None = None) -> None:
    """``dst[b, start[b] + i] = src[b, i]`` in place for ``mask[b, i]``
    (default all) where the slot lies inside ``dst`` [B, M, ...]; a write
    past the end is dropped, as the JAX code's ``mode="drop"`` scatter
    drops it, never clamped onto the last slot.  ``start`` >= 0.

    Each row reads and rewrites one window of min(K, M) distinct slots
    that holds all of its in-range writes, ``[min(start[b], M - Kw),
    +Kw)``: slots the row does not write keep their value.  No index
    repeats (a repeated index in one ``scatter_`` is undefined on CUDA)
    and no host read (dropping the rows would need ``nonzero``)."""
    B, M = dst.shape[0], dst.shape[1]
    K = src.shape[1]
    Kw = min(K, M)
    ar = torch.arange(Kw, device=dst.device)
    first = torch.clamp(start, max=M - Kw)
    slots = first[:, None] + ar[None, :]                     # [B, Kw]
    i = slots - start[:, None]                               # src column
    take = (i >= 0) & (i < K)
    i = i.clamp(0, K - 1)
    if mask is not None:
        take = take & torch.gather(mask, 1, i)
    tail = (1,) * (dst.dim() - 2)
    idx = slots.view(B, Kw, *tail).expand(B, Kw, *dst.shape[2:]).long()
    d, s = _bits(dst), _bits(src)
    new = torch.gather(s, 1, i.view(B, Kw, *tail).expand(
        B, Kw, *src.shape[2:]).long())
    d.scatter_(1, idx, torch.where(take.view(B, Kw, *tail), new,
                                   torch.gather(d, 1, idx)))


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


def fused_head_attention(qkv: Dense, out: Dense, h: torch.Tensor, *,
                         mesh=None, kv_mask: torch.Tensor | None = None,
                         **attend) -> torch.Tensor:
    """Attention through a fused ``qkv`` projection ([in, 3, heads, D])
    and its ``out`` projection ([heads, D, out]), the encoders' (BERT's,
    ViT's) MHA.  Where ``parallel/sharding.py`` split ``qkv`` over its
    heads (Megatron), each heads shard's q/k/v (:meth:`Dense.column`)
    attends on its own, over its own column of ``mesh`` with a
    sequence-parallel backend, and :meth:`Dense.row` sums the shards'
    ``out`` products, as :meth:`GptBlock.forward` does; otherwise one
    attention over every head.  ``attend``: ``dot_product_attention``'s
    ``causal``/``window``/``backend``."""
    if shard_dim(qkv, "kernel") == len(qkv.in_shape) + 1:
        ctxs = []
        for j, t in enumerate(qkv.column(h)):
            mask = None if kv_mask is None else kv_mask.to(t.device)
            ctxs.append(dot_product_attention(
                t[:, :, 0], t[:, :, 1], t[:, :, 2], kv_mask=mask,
                mesh=None if mesh is None else mesh.column(j), **attend))
        return out.row(ctxs)
    t = qkv(h)
    return out(dot_product_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                                     kv_mask=kv_mask, mesh=mesh, **attend))


def gelu_mlp(mlp_in: Dense, mlp_out: Dense, h: torch.Tensor) -> torch.Tensor:
    """``mlp_out(gelu(mlp_in(h)))`` with flax's tanh gelu; Megatron's
    column-then-row form where the rules split ``mlp_in`` over its
    output (and ``mlp_out`` over its input)."""
    if shard_dim(mlp_in, "kernel") == 1:
        return mlp_out.row([F.gelu(a, approximate="tanh")
                            for a in mlp_in.column(h)])
    return mlp_out(F.gelu(mlp_in(h), approximate="tanh"))


def _seq_link(mesh):
    """The seq axis's link where it crosses processes, else None."""
    from ..parallel.mesh import SEQ_AXIS
    if mesh is None or not mesh.crosses(SEQ_AXIS):
        return None
    from ..parallel.transport import link
    return link(mesh, SEQ_AXIS)


def _seq_offset(mesh, s_local: int) -> int:
    """This rank's first sequence position where ``seq`` crosses
    processes (its block of ``s_local``), else 0."""
    ring = _seq_link(mesh)
    return 0 if ring is None else ring.coord * s_local


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
                positions = torch.arange(x.shape[1], device=x.device) \
                    + _seq_offset(self.mesh, x.shape[1])
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

    def _head_parts(self, x: torch.Tensor) -> list | None:
        """Tensor parallel (the head projection's kernel split over its
        heads by ``parallel/sharding.py``): each shard's (q, k, v) for its
        heads [B, S, heads / model, D], on its shard's device; None for an
        unsharded block.  GQA's ``kv_proj`` stays replicated: each shard
        takes the kv heads of its own query heads."""
        cfg = self.cfg
        mha = cfg.num_kv_heads == cfg.num_heads
        proj = self.qkv if mha else self.q_proj
        if shard_dim(proj, "kernel") != len(proj.in_shape) + int(mha):
            return None
        h = self.ln_attn(x).to(cfg.torch_dtype)
        rope = cfg.pos_encoding == "rope"
        positions = torch.arange(x.shape[1], device=x.device)
        if mha:
            parts = [(t[:, :, 0], t[:, :, 1], t[:, :, 2])
                     for t in self.qkv.column(h)]
            if rope:
                parts = [(apply_rope(q, positions.to(q.device)),
                          apply_rope(k, positions.to(q.device)), v)
                         for q, k, v in parts]
            return parts
        kv = self.kv_proj(h)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if rope:
            k = apply_rope(k, positions)
        groups = cfg.num_heads // cfg.num_kv_heads
        parts, first = [], 0
        for q in self.q_proj.column(h):
            if rope:
                q = apply_rope(q, positions.to(q.device))
            n = q.shape[2]
            lo, hi = first // groups, (first + n - 1) // groups + 1
            skip = first - lo * groups

            def heads(t):
                t = torch.repeat_interleave(t[:, :, lo:hi], groups, dim=2)
                return t[:, :, skip:skip + n].to(q.device)
            parts.append((q, heads(k), heads(v)))
            first += n
        return parts

    def _mlp_tp(self, x: torch.Tensor, g) -> torch.Tensor:
        """Megatron's MLP: ``mlp_in`` (and ``mlp_gate``) column parallel,
        the activation per shard, ``mlp_out`` row parallel (the rules
        split all three over the MLP width, so they are split together).
        ``matmul_int8``: the fused int8 MLP per shard where its gate admits
        the global shapes (K4/K5 a shard), else ``Int8Dense``'s column and
        row forms."""
        cfg = self.cfg
        h = self.ln_mlp(x).to(cfg.torch_dtype)
        if cfg.matmul_int8 and cfg.activation == "gelu":
            from ..ops import quant_train
            H = cfg.hidden_size
            M = h.numel() // H
            # The gate on the global (M, H, I), as the unsharded program
            # that JAX's GSPMD partitions sees them.
            if quant_train.use_fused_mlp(M, H, cfg.intermediate_size):
                n = len(shards(self.mlp_in, "kernel"))
                b_in = shards(self.mlp_in, "bias") or list(
                    self.mlp_in.bias.chunk(n))
                res = (x.reshape(M, H) if quant_train.FUSED_MLP_RESIDUAL
                       and g is None else None)
                y = quant_train.int8_gelu_mlp_tp(
                    h.reshape(M, H), shards(self.mlp_in, "kernel"), b_in,
                    shards(self.mlp_out, "kernel"),
                    full(self.mlp_out, "bias"), res)
                if res is not None:
                    return y.reshape(x.shape)
                return x + self._drop(y.reshape(x.shape), g)
        hidden = self.mlp_in.column(h)
        if cfg.activation == "swiglu":
            hidden = [F.silu(gt) * a for gt, a in zip(
                self.mlp_gate.column(h), hidden)]
        else:
            hidden = [F.gelu(a, approximate="tanh") for a in hidden]
        return x + self._drop(self.mlp_out.row(hidden), g)

    def _mlp(self, x: torch.Tensor,
             g: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        if shard_dim(self.mlp_in, "kernel") == 1:
            return self._mlp_tp(x, g)
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
        cfg = self.cfg
        if cfg.attention_backend in ("ring", "ulysses") and self.mesh is None:
            self.mesh = default_mesh()
        attend = dict(causal=True, window=cfg.attention_window,
                      backend=cfg.attention_backend)
        parts = self._head_parts(x)
        if parts is None:
            q, k, v = self._qkv(x)
            ctx = dot_product_attention(q, self._expand_kv(k),
                                        self._expand_kv(v), mesh=self.mesh,
                                        **attend)
            x = x + self._drop(self.out(ctx), g)
            return self._mlp(x, g)
        # Each heads shard attends on its own: with a sequence-parallel
        # backend over its own column of the mesh (its ring or ulysses).
        # ``out`` is split over the heads as the head projection is.
        ctxs = [dot_product_attention(
            q, k, v, mesh=None if self.mesh is None else self.mesh.column(j),
            **attend) for j, (q, k, v) in enumerate(parts)]
        x = x + self._drop(self.out.row(ctxs), g)
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

    def _check_ring(self, M: int) -> None:
        """Ring addressing is the window mask: a cache longer than the
        window would keep out-of-band keys resident and attend them."""
        if self.cfg.attention_window and M > self.cfg.attention_window:
            raise ValueError(
                f"windowed decode cache has {M} rows > attention_window="
                f"{self.cfg.attention_window}; allocate via init_kv_cache")

    def decode_step(self, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, position: int):
        """One token per row at the absolute ``position`` (an int, the
        same for every row) against a [B, M, G, D] cache addressed as a
        ring: position p at slot p % M (the identity for a full-length
        cache; the last ``attention_window`` positions for a windowed
        one, see :func:`init_kv_cache`).  The new K/V are written in
        place.  A written slot holds a position in [position - M + 1,
        position], inside the band, so the only invalid slots are those
        of a ring not yet full."""
        M = k_cache.shape[1]
        self._check_ring(M)
        position = int(position)
        slot = position % M
        # A fill on the device, not a copy from the host (which would
        # wait for the card at every layer).
        q, k, v = self._qkv(x, positions=torch.full(
            (1,), position, dtype=torch.long, device=x.device))
        _bits(k_cache)[:, slot] = _bits(k[:, 0].to(k_cache.dtype))
        _bits(v_cache)[:, slot] = _bits(v[:, 0].to(v_cache.dtype))
        s = torch.arange(M, device=x.device)
        valid = (s <= position) | (position >= M)
        ctx = self._attend_cache(q, k_cache, v_cache, valid)
        x = x + self.out(ctx)
        return self._mlp(x), k_cache, v_cache

    def decode_step_ragged(self, x: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, positions: torch.Tensor):
        """:meth:`decode_step` with a position per row (``positions``
        [B]), ring-safe: row b's slot s is valid iff ``s <= positions[b]``
        or the ring is full (``positions[b] >= M``), provided every
        position before it was written (ragged prefill and sequential
        decode see to that).  One write per row, so no index repeats."""
        M = k_cache.shape[1]
        self._check_ring(M)
        B = x.shape[0]
        slot = torch.remainder(positions, M).long()
        q, k, v = self._qkv(x, positions=positions[:, None])   # [B,1,*,D]
        rows = torch.arange(B, device=x.device)
        _bits(k_cache)[rows, slot] = _bits(k[:, 0].to(k_cache.dtype))
        _bits(v_cache)[rows, slot] = _bits(v[:, 0].to(v_cache.dtype))
        s = torch.arange(M, device=x.device)
        valid = ((s[None, :] <= positions[:, None])
                 | (positions[:, None] >= M))                    # [B, M]
        ctx = self._attend_cache(q, k_cache, v_cache,
                                 valid[:, None, None, None, :])
        x = x + self.out(ctx)
        return self._mlp(x), k_cache, v_cache

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

    def decode_chunk(self, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor,
                     depths: torch.Tensor | None = None,
                     anc: torch.Tensor | None = None):
        """K tokens per row against a full-length [B, M, G, D] cache in one
        pass: row b's chunk fills slots ``positions[b] .. positions[b] +
        K - 1`` (rows may sit at different frontiers).

        Linear (``depths`` and ``anc`` None): token i is the row's next
        token at depth i, position ``positions[b] + i``, and the
        intra-chunk mask is causal.  Tree (a speculative draft tree, see
        :func:`spec_tree`): node i embeds and ropes at ``positions[b] +
        depths[i]``, writes its K/V at slot ``positions[b] + i`` and
        attends the committed prefix and its ancestors (``anc`` [K, K]);
        :func:`fixup_tree_caches` moves an accepted path down to slot ==
        position afterwards.

        The chunk's K/V are cast to the cache dtype before they are
        attended (the values a later step reads back, float8 included),
        then written in place; a slot past the cache end is dropped, never
        clamped onto the last slot (:func:`write_rows`, which needs no
        host read).  The committed prefix is the slots before
        ``positions[b]``; slots at or past it hold this chunk or junk from
        rejected drafts, masked until real tokens overwrite them."""
        if self.cfg.attention_window:
            raise ValueError(
                "decode_chunk needs the full-length cache (slot == absolute "
                "position); the windowed ring cache would attend stale "
                "entries: use sequential decode_step instead")
        K, M = x.shape[1], k_cache.shape[1]
        ar = torch.arange(K, device=x.device)
        if depths is None:
            pos = positions[:, None] + ar[None, :]
            chunk_valid = ar[:, None] >= ar[None, :]              # causal
        else:
            pos = positions[:, None] + depths[None, :]
            chunk_valid = anc
        q, k, v = self._qkv(x, positions=pos)
        # The cache-dtype round trip before attending.
        k, v = k.to(k_cache.dtype), v.to(v_cache.dtype)
        write_rows(k_cache, positions, k)
        write_rows(v_cache, positions, v)
        prefix_valid = (torch.arange(M, device=x.device)[None, :]
                        < positions[:, None])
        ctx = self._attend_cache_chunk(q, k_cache, v_cache, k, v,
                                       prefix_valid, chunk_valid)
        x = x + self.out(ctx)
        return self._mlp(x), k_cache, v_cache

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
                rng: torch.Generator | None = None,
                deterministic: bool = False) -> torch.Tensor:
        """Logits [B, S, vocab].  Dropout runs in ``train()`` mode when
        ``cfg.dropout_rate > 0`` and then needs ``rng``: one seed per
        block (and one for the embedding) is drawn from it, the JAX
        model's per-call dropout key split.  ``deterministic`` turns
        dropout off in either mode (the uncached decode's forward).

        With the ring's ``seq`` axis across processes
        (``parallel/mesh.global_mesh``) every rank takes the whole
        ``input_ids``, runs its own sequence block (its positions) through
        the blocks, and the logits' blocks are joined on every rank
        (``parallel/transport.gather_seq``), so the loss is the global
        token mean on every rank and each rank's backward is its block's
        part of the gradient (the sum over the seq ranks is the whole)."""
        cfg = self.cfg
        mesh = self.layers[0].mesh
        if mesh is None and cfg.attention_backend in ("ring", "ulysses"):
            mesh = default_mesh()
        ring = _seq_link(mesh)
        first = 0
        if ring is not None:
            S = input_ids.shape[1]
            if S % ring.size:
                raise ValueError(f"sequence length {S} not divisible by "
                                 f"the seq axis {ring.size}")
            per = S // ring.size
            first = ring.coord * per
            input_ids = input_ids[:, first:first + per]
        S = input_ids.shape[1]
        seeds = [None] * (cfg.num_layers + 1)
        if self.training and cfg.dropout_rate > 0.0 and not deterministic:
            if rng is None:
                raise ValueError("dropout in training mode needs rng (a "
                                 "torch.Generator)")
            seeds = torch.randint(0, 2 ** 62, (cfg.num_layers + 1,),
                                  generator=rng, device=rng.device).tolist()
        x = self._embed(input_ids,
                        first + torch.arange(S, device=input_ids.device)
                        [None, :], _generator(seeds[0], input_ids.device))
        for layer, seed in zip(self.layers, seeds[1:]):
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, seed, use_reentrant=False)
            else:
                x = layer(x, seed)
        logits = self._head(x)  # [B, S, vocab]
        if ring is not None:
            from ..parallel.transport import gather_seq
            logits = gather_seq(logits, ring, dim=1)
        return logits

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
    def decode_step(self, token: torch.Tensor, caches, position: int):
        """One generation step: ``token`` [B] at ``position`` (an int)
        against per-layer caches (:func:`init_kv_cache`), updated in
        place.  Returns (logits [B, vocab], caches)."""
        position = int(position)
        x = self._embed(token[:, None], torch.full(
            (1, 1), position, dtype=torch.long, device=token.device))
        for layer, (k_cache, v_cache) in zip(self.layers, caches):
            x, _, _ = layer.decode_step(x, k_cache, v_cache, position)
        return self._head(x)[:, 0], caches

    @torch.no_grad()
    def decode_ragged(self, token: torch.Tensor, caches,
                      positions: torch.Tensor):
        """One token per row at per-row ``positions`` [B], ring-cache safe
        (:meth:`GptBlock.decode_step_ragged`).  Returns (logits [B,
        vocab], caches)."""
        x = self._embed(token[:, None], positions[:, None])
        for layer, (k_cache, v_cache) in zip(self.layers, caches):
            x, _, _ = layer.decode_step_ragged(x, k_cache, v_cache,
                                               positions)
        return self._head(x)[:, 0], caches

    @torch.no_grad()
    def decode_chunk(self, tokens: torch.Tensor, caches,
                     positions: torch.Tensor,
                     depths: torch.Tensor | None = None,
                     anc: torch.Tensor | None = None):
        """K tokens per row against full-length caches in one pass (the
        speculative verify, :meth:`GptBlock.decode_chunk`): ``tokens``
        [B, K] from per-row ``positions`` [B]; ``depths`` / ``anc`` select
        tree verification.  Returns (logits [B, K, vocab], one next-token
        distribution per fed token; caches)."""
        K = tokens.shape[1]
        offsets = (torch.arange(K, device=tokens.device) if depths is None
                   else depths)
        x = self._embed(tokens, positions[:, None] + offsets[None, :])
        for layer, (k_cache, v_cache) in zip(self.layers, caches):
            x, _, _ = layer.decode_chunk(x, k_cache, v_cache, positions,
                                         depths, anc)
        return self._head(x), caches

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


def sample_logits(step_logits: torch.Tensor,
                  generator: torch.Generator, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Sample next tokens [B] from [B, V] logits with temperature / top-k
    / top-p.  ``top_k > 0`` keeps the k highest logits (and any tied with
    the k-th); ``top_p`` in (0, 1) keeps the smallest nucleus whose mass
    reaches it (the most likely token always survives); filters compose,
    k first.  The draw is Gumbel-max over one [B, V] block of uniforms
    from ``generator`` (JAX's ``categorical``): reproducible from its
    seed, other bits than JAX's threefry."""
    logits = step_logits / max(temperature, 1e-6)
    neg = torch.finfo(logits.dtype).min
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, neg, logits)
    if 0.0 < top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
        # Exclusive cumulative mass: the first token is always kept.
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep = torch.zeros_like(keep_sorted).scatter_(-1, order,
                                                      keep_sorted)
        logits = torch.where(keep, logits, neg)
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).clamp_min_(1e-20)
    gumbel = -torch.log(-torch.log(u.to(logits.device)))
    return torch.argmax(logits + gumbel, dim=-1)


# ------------------------------------------------------------ decoding


class MethodCall(nn.Module):
    """Calls one method of ``model``, so :func:`torch.func.functional_call`
    can run it with a substituted parameter mapping (JAX's
    ``model.apply({"params": tree}, ..., method=...)``)."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, *args):
        return getattr(self.model, self.name)(*args)


def cast_params(params: dict, reference: dict, device) -> dict:
    """``params`` (``state_dict`` names, e.g. from :func:`params_from_jax`)
    checked against ``reference`` (name -> (shape, dtype)) and each tensor
    cast to its parameter's dtype on ``device``."""
    missing = set(reference) ^ set(params)
    if missing:
        raise ValueError(f"params do not match the model's parameters: "
                         f"{sorted(missing)[:6]}")
    tree = {}
    for name, t in params.items():
        shape, dtype = reference[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        tree[name] = t.detach().to(device=device, dtype=dtype)
    return tree


def _decode_setup(model: GptLM, params: dict | None, quantize: str,
                  kv_dtype: str):
    """The decode family's weights and cache dtype: ``(run, cache_dtype)``
    where ``run(name, *args)`` calls ``model.<name>`` with ``params``
    (None: the model's own) as the serving engine does, stored int8 under
    ``quantize="int8"`` and dequantized at each call."""
    cache_dtype = resolve_kv_dtype(kv_dtype)
    if params is None and not quantize:
        # The model's own weights as they are: no substitution, which
        # swaps every parameter in and out of the module at each call.
        return (lambda name, *args: getattr(model, name)(*args),
                cache_dtype)
    reference = {k: (v.shape, v.dtype)
                 for k, v in model.state_dict().items()}
    tree = prepare_inference_tree(cast_params(
        model.state_dict() if params is None else params, reference,
        model.device), quantize)
    compute = model.cfg.torch_dtype
    methods: dict = {}

    def run(name, *args):
        method = methods.setdefault(name, MethodCall(model, name))
        weights = load_inference_tree(tree, quantize, compute)
        return functional_call(method, {f"model.{k}": v
                                        for k, v in weights.items()}, args)
    return run, cache_dtype


def _prompt(model: GptLM, prompt) -> torch.Tensor:
    return torch.as_tensor(prompt, device=model.device).long()


def _next_token(step_logits, generator, temperature, top_k, top_p):
    """Greedy or sampled selection, shared by both decode loops: a sampled
    step draws from ``generator`` once."""
    if temperature > 0.0:
        return sample_logits(step_logits, generator,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p)
    return torch.argmax(step_logits, dim=-1)


def _validate_sampling(model, total, temperature, top_p, generator):
    if total > model.cfg.max_position:
        raise ValueError(f"prompt + num_tokens = {total} exceeds "
                         f"max_position {model.cfg.max_position}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")


def _validate_eos(model, eos_id):
    if eos_id is not None and not 0 <= eos_id < model.cfg.vocab_size:
        raise ValueError(f"eos_id must be in [0, {model.cfg.vocab_size}), "
                         f"got {eos_id}")


def _output(prompt: torch.Tensor, total: int, eos_id):
    """[B, total] tokens holding the prompt; the generated region is eos
    padding when there is an eos (a row that stops early reads as
    stopped), else zeros."""
    B, P = prompt.shape
    toks = torch.full((B, total), 0 if eos_id is None else eos_id,
                      dtype=torch.long, device=prompt.device)
    toks[:, :P] = prompt
    return toks


def _stop(nxt, done, eos_id):
    """Apply eos to one step's tokens: stopped rows emit eos.  Returns
    (tokens, done, whether every row has stopped; one host read)."""
    if eos_id is None:
        return nxt, done, False
    nxt = torch.where(done, eos_id, nxt)
    done = done | (nxt == eos_id)
    return nxt, done, bool(done.all())


@torch.no_grad()
def generate(model: GptLM, params: dict | None, prompt, num_tokens: int,
             *, temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: torch.Generator | None = None,
             eos_id: int | None = None) -> torch.Tensor:
    """Uncached autoregressive decoding, greedy (``temperature=0``) or
    sampled (temperature with optional top-k / nucleus filtering, drawn
    from ``generator``).  Each step runs the whole forward over the
    tokens so far (O(S^2) a token; K1 at every step on the pallas
    backend) and takes the last position's logits.

    ``prompt`` [B, P]; returns [B, P + num_tokens] on the model's device.
    ``eos_id``: a row that emits it stops (later positions are eos) and
    the loop ends once every row has stopped."""
    prompt = _prompt(model, prompt)
    B, P = prompt.shape
    total = P + num_tokens
    _validate_sampling(model, total, temperature, top_p, generator)
    _validate_eos(model, eos_id)
    run, _ = _decode_setup(model, params, "", "")
    toks = _output(prompt, total, eos_id)
    done = torch.zeros(B, dtype=torch.bool, device=prompt.device)
    for t in range(P, total):
        logits = run("forward", toks[:, :t], None, True)[:, -1]
        nxt = _next_token(logits, generator, temperature, top_k, top_p)
        nxt, done, stopped = _stop(nxt, done, eos_id)
        toks[:, t] = nxt
        if stopped:
            break
    return toks


@torch.no_grad()
def generate_cached(model: GptLM, params: dict | None, prompt,
                    num_tokens: int, *, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 0.0,
                    generator: torch.Generator | None = None,
                    quantize: str = "", kv_dtype: str = "",
                    eos_id: int | None = None) -> torch.Tensor:
    """KV-cached decoding, the same contract as :func:`generate` (the
    same draws from ``generator`` in the same order, so a sampled run
    equals the uncached one from the same seed): the prompt fills the
    caches in one causal pass (:meth:`GptLM.prefill`, K1), then each new
    token goes through :meth:`GptLM.decode_step` (O(total) a token).

    ``quantize="int8"`` stores the weights as per-channel int8 and
    dequantizes them at each call; ``kv_dtype="float8"`` keeps the caches
    in ``float8_e4m3fn`` (upcast on read).  ``eos_id`` as in
    :func:`generate`."""
    prompt = _prompt(model, prompt)
    B, P = prompt.shape
    total = P + num_tokens
    _validate_sampling(model, total, temperature, top_p, generator)
    _validate_eos(model, eos_id)
    run, cache_dtype = _decode_setup(model, params, quantize, kv_dtype)
    caches = init_kv_cache(model.cfg, B, total, dtype=cache_dtype,
                           device=model.device)
    logits, _ = run("prefill", prompt, caches)
    toks = _output(prompt, total, eos_id)
    done = torch.zeros(B, dtype=torch.bool, device=prompt.device)
    for t in range(P, total):
        nxt = _next_token(logits, generator, temperature, top_k, top_p)
        nxt, done, stopped = _stop(nxt, done, eos_id)
        toks[:, t] = nxt
        if stopped or t + 1 == total:
            break
        logits, _ = run("decode_step", nxt, caches, t)
    return toks


def _top_k(x: torch.Tensor, k: int):
    """The k largest of each row, ties to the lower index (as
    ``jax.lax.top_k``)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


@torch.no_grad()
def beam_search_cached(model: GptLM, params: dict | None, prompt,
                       num_tokens: int, *, beam_size: int,
                       quantize: str = "", kv_dtype: str = "",
                       eos_id: int | None = None,
                       length_penalty: float = 1.0):
    """Beam search over the cached decode path: each step extends every
    live beam by every token, keeps the ``beam_size`` best cumulative
    log-probabilities per row and reorders the caches (in place) to the
    surviving beams' parents.  ``beam_size=1`` is greedy decoding.

    ``eos_id``: a beam that emits it is frozen (its only continuation is
    eos at logp 0, so its score stops changing) and keeps competing; the
    loop ends once every beam has stopped.  The final pick divides each
    score by the GNMT length penalty ``((5 + gen_len) / 6) **
    length_penalty``.  Returns (tokens [B, P + num_tokens], the picked
    beam's cumulative log-probability [B])."""
    prompt = _prompt(model, prompt)
    B, P = prompt.shape
    K = beam_size
    total = P + num_tokens
    _validate_sampling(model, total, 0.0, 0.0, None)
    _validate_eos(model, eos_id)
    if K < 1:
        raise ValueError(f"beam_size must be >= 1, got {K}")
    if K > model.cfg.vocab_size:
        raise ValueError(
            f"beam_size must be <= vocab_size ({model.cfg.vocab_size}), "
            f"got {K}: the first top-k over the vocabulary cannot seed "
            f"more beams than there are tokens")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    if length_penalty <= 0.0:
        raise ValueError(f"length_penalty must be > 0, got {length_penalty}")
    run, cache_dtype = _decode_setup(model, params, quantize, kv_dtype)
    dev = model.device
    V = model.cfg.vocab_size

    # Prefill at batch B, then tile each cache K-fold: row b's beams sit
    # at b*K .. b*K + K - 1.
    caches = init_kv_cache(model.cfg, B, total, dtype=cache_dtype,
                           device=dev)
    logits, _ = run("prefill", prompt, caches)
    tile = torch.arange(B, device=dev).repeat_interleave(K)
    caches = [tuple(_bits(c)[tile].view(c.dtype) for c in pair)
              for pair in caches]

    # The first step seeds the beams with the top-K first tokens.
    scores, first = _top_k(torch.log_softmax(logits.float(), dim=-1), K)
    toks = _output(prompt, total, eos_id)[tile]
    toks[:, P] = first.reshape(B * K)
    done = (first == eos_id if eos_id is not None
            else torch.zeros_like(first, dtype=torch.bool))
    stopped = eos_id is not None and bool(done.all())
    gen_len = torch.ones((B, K), dtype=torch.long, device=dev)
    if eos_id is not None:
        frozen = torch.full((V,), -1e9, device=dev)
        frozen[eos_id] = 0.0
    base = torch.arange(B, device=dev)[:, None] * K
    token = toks[:, P]
    for t in range(P + 1, total):
        if stopped:
            break
        logits, _ = run("decode_step", token, caches, t - 1)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        if eos_id is not None:
            logp = torch.where(done[..., None], frozen, logp)
        # [B, K*V] joint scores; the top K pick (parent beam, token).
        scores, idx = _top_k((scores[..., None] + logp).reshape(B, K * V),
                             K)
        parent, token = idx // V, idx % V
        flat_parent = (base + parent).reshape(B * K)
        toks = toks[flat_parent]
        for cache in (c for pair in caches for c in pair):
            _bits(cache).copy_(_bits(cache)[flat_parent])
        gen_len = torch.gather(gen_len, 1, parent)
        if eos_id is not None:
            done = torch.gather(done, 1, parent)
            gen_len = torch.where(done, gen_len, gen_len + 1)
            done = done | (token == eos_id)
            stopped = bool(done.all())
        else:
            gen_len = gen_len + 1
        token = token.reshape(B * K)
        toks[:, t] = token
    # GNMT length penalty: neutral when every beam has the same length.
    lp = ((5.0 + gen_len.float()) / 6.0) ** length_penalty
    best = torch.argmax(scores / lp, dim=-1)                     # [B]
    return (toks[torch.arange(B, device=dev) * K + best],
            torch.gather(scores, 1, best[:, None])[:, 0])


def spec_tree(spec_k: int, branch_len: int = 0):
    """Static draft-tree arrays for tree-verified speculation: a main
    chain of ``spec_k - branch_len`` nodes (node 0 the known-correct
    pending token, node i extending node i-1) and, when ``branch_len >
    0``, one alternate branch forking at the root (the continuation after
    the tail gram's second most recent occurrence).

    Returns numpy ``(depths [K], anc [K, K], parent [K], path [K, K])``:
    each node's depth below the frontier, the ancestor-or-self matrix
    (the tree attention mask), each node's parent (-1 for the root), and
    ``path[i, d]``, node i's ancestor at depth d (-1 past its depth)."""
    K = int(spec_k)
    branch_len = int(branch_len)
    main = K - branch_len
    if main < 2 and K >= 2:
        raise ValueError(f"spec_tree needs a main chain of >= 2 nodes; "
                         f"spec_k={K} branch_len={branch_len}")
    parent = [-1] + list(range(main - 1))
    if branch_len:
        parent += [0] + list(range(main, K - 1))
    depth = np.zeros(K, np.int32)
    anc = np.zeros((K, K), bool)
    path = np.full((K, K), -1, np.int32)
    for i in range(K):
        chain = []
        j = i
        while j >= 0:
            chain.append(j)
            j = parent[j]
        depth[i] = len(chain) - 1
        for j in chain:
            anc[i, j] = True
            path[i, depth[j]] = j
    return depth, anc, np.asarray(parent, np.int32), path


def fixup_tree_caches(caches, positions: torch.Tensor, sel: torch.Tensor,
                      accept: torch.Tensor):
    """Move the accepted root path's K/V down to slot == position, in
    place: tree verification stores node i at slot ``positions[b] + i``
    while its position is ``positions[b] + depth(i)``; ``sel`` [B, K]
    holds the accepted node per depth, and rows ``positions[b] ..
    positions[b] + accept[b] - 1`` take those nodes' rows (read before
    any is written).  Writes past ``accept`` or the cache end drop.
    Returns the caches."""
    K = sel.shape[1]
    write = torch.arange(K, device=sel.device)[None, :] < accept[:, None]
    for cache in (c for pair in caches for c in pair):
        bits = _bits(cache)
        src = (positions[:, None] + sel).clamp(0, cache.shape[1] - 1)
        tail = (1,) * (cache.dim() - 2)
        rows = torch.gather(bits, 1, src.view(*src.shape, *tail).expand(
            *src.shape, *cache.shape[2:]).long())
        write_rows(bits, positions, rows, write)
    return caches


@torch.no_grad()
def generate_cached_speculative(model: GptLM, params: dict | None, prompt,
                                num_tokens: int, *, spec_k: int = 8,
                                ngram: int = 3, eos_id: int | None = None,
                                quantize: str = "", kv_dtype: str = "",
                                fallback_rounds: int = 8,
                                fallback_accept: float = 1.5):
    """Greedy decoding with speculative verification, the host loop: the
    same tokens as greedy :func:`generate_cached` (up to floating-point
    ties between the chunk and step programs), often in fewer passes.

    Each round feeds one ``spec_k``-wide chunk per row through
    :meth:`GptLM.decode_chunk`: the row's known-correct next token and
    ``spec_k - 1`` prompt-lookup drafts from the row's
    :class:`..models.drafting.NGramIndex` (updated with the tokens
    committed since the last round).  The longest draft prefix matching
    the chunk's greedy argmaxes is accepted, plus the free correction.
    After ``fallback_rounds`` rounds with fewer than ``fallback_accept``
    tokens a round a row, the rest is plain sequential decode of the same
    caches on the device (``fallback_rounds=0`` never falls back).

    Returns (tokens [B, P + num_tokens], stats ``{"rounds",
    "tokens_generated", "mean_accepted_per_round",
    "fallback_at_round"}``)."""
    prompt = _prompt(model, prompt)
    B, P = prompt.shape
    total = P + num_tokens
    _validate_sampling(model, total, 0.0, 0.0, None)
    _validate_eos(model, eos_id)
    if model.cfg.attention_window:
        raise ValueError(
            "speculative decoding needs the full-length cache; the windowed "
            "ring cache cannot mask rejected speculative writes")
    if spec_k < 2:
        raise ValueError(f"spec_k must be >= 2, got {spec_k}")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    run, cache_dtype = _decode_setup(model, params, quantize, kv_dtype)
    dev = model.device
    caches = init_kv_cache(model.cfg, B, total, dtype=cache_dtype,
                           device=dev)
    last_logits, _ = run("prefill", prompt, caches)

    def on_device(a):
        return torch.from_numpy(np.asarray(a)).to(dev).long()

    K = spec_k
    toks = np.zeros((B, total), np.int32)
    toks[:, :P] = prompt.cpu().numpy()
    lens = np.full(B, P)                      # per-row frontier
    pending = torch.argmax(last_logits, dim=-1).cpu().numpy()
    done = np.zeros(B, bool)
    indexes = [drafting.NGramIndex(ngram) for _ in range(B)]
    rounds = 0
    fallback_at = None
    while not np.all(done | (lens >= total)):
        if (fallback_rounds and rounds >= fallback_rounds
                and (np.sum(lens - P) / rounds / B) < fallback_accept):
            fallback_at = rounds
            break
        chunk = np.zeros((B, K), np.int32)
        for b in range(B):
            chunk[b, 0] = pending[b]
            # Index the tokens committed since the last round, then draft
            # for the tail ending in the pending token.
            indexes[b].update(toks[b], int(lens[b]))
            row = np.concatenate([toks[b, :lens[b]], pending[b:b + 1]])
            chunk[b, 1:] = indexes[b].draft(row, int(lens[b]) + 1, K - 1)
        # Rows already done still ride the batch: their writes land past
        # their frontier and are never accepted.
        logits, _ = run("decode_chunk", on_device(chunk), caches,
                        on_device(lens))
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()       # [B, K]
        rounds += 1
        for b in range(B):
            if done[b] or lens[b] >= total:
                continue
            budget = total - lens[b]
            # chunk[b, 0] is known-correct; draft i is accepted while it
            # is the greedy continuation of the token before it.
            accept = 1
            while (accept < min(K, budget)
                   and chunk[b, accept] == greedy[b, accept - 1]
                   and not (eos_id is not None
                            and chunk[b, accept - 1] == eos_id)):
                accept += 1
            wrote = chunk[b, :accept]
            toks[b, lens[b]:lens[b] + accept] = wrote
            lens[b] += accept
            pending[b] = greedy[b, accept - 1]
            if eos_id is not None and eos_id in wrote:
                hit = int(np.flatnonzero(wrote == eos_id)[0])
                lens[b] = lens[b] - accept + hit + 1
                done[b] = True
        done |= lens >= total
    spec_generated = int(np.sum(lens - P))

    if fallback_at is not None and not np.all(done | (lens >= total)):
        # Plain sequential finish over the same caches: place the
        # known-correct pending token, then decode the rest on the device.
        for b in range(B):
            if done[b] or lens[b] >= total:
                continue
            toks[b, lens[b]] = pending[b]
            lens[b] += 1
            if eos_id is not None and pending[b] == eos_id:
                done[b] = True
        live = ~(done | (lens >= total))
        if np.any(live):
            steps = int(np.max(np.where(live, total - lens, 0)))
            token = on_device(toks[np.arange(B), np.maximum(lens - 1, 0)])
            pos = on_device(lens - 1)
            stopped = on_device(done).bool()
            out = torch.zeros((B, steps), dtype=torch.long, device=dev)
            for i in range(steps):
                logits, _ = run("decode_chunk", token[:, None], caches, pos)
                token = torch.argmax(logits[:, 0], dim=-1)
                if eos_id is not None:
                    token = torch.where(stopped, eos_id, token)
                    stopped = stopped | (token == eos_id)
                out[:, i] = token
                pos = pos + 1
            out = out.cpu().numpy()
            for b in np.flatnonzero(live):
                wrote = out[b, :total - lens[b]]
                if eos_id is not None and eos_id in wrote:
                    hit = int(np.flatnonzero(wrote == eos_id)[0])
                    wrote = wrote[:hit + 1]
                    done[b] = True
                toks[b, lens[b]:lens[b] + len(wrote)] = wrote
                lens[b] += len(wrote)

    if eos_id is not None:
        for b in range(B):
            toks[b, lens[b]:] = eos_id
    generated = int(np.sum(lens - P))
    stats = {"rounds": rounds, "tokens_generated": generated,
             "mean_accepted_per_round": round(
                 spec_generated / max(rounds, 1), 2),
             "fallback_at_round": fallback_at}
    return on_device(toks), stats


#: Chunk width of the adaptive loop's small round: the pending token and
#: one draft, barely more than a decode step.
_SPEC_K_SMALL = 2


@torch.no_grad()
def generate_cached_speculative_device(model: GptLM, params: dict | None,
                                       prompt, num_tokens: int, *,
                                       spec_k: int = 8, ngram: int = 3,
                                       eos_id: int | None = None,
                                       quantize: str = "",
                                       kv_dtype: str = "",
                                       spec_branch: int = 2,
                                       adaptive: bool = True,
                                       adapt_threshold: float = 1.5,
                                       probe_every: int = 8):
    """Speculative greedy decoding with drafting, verification and
    acceptance on the device: the round's state lives in device tensors
    and the host reads one pair of flags a round (is a row still live,
    and is the acceptance EMA above ``adapt_threshold``).  The same
    tokens as greedy :func:`generate_cached`.

    - Drafts come from a device n-gram index (:mod:`.drafting`'s
      ``index_build2`` over the prompt, then ``index_update2`` with each
      round's accepted tokens), the host drafter's table and hash.
    - Tree verification (``spec_branch > 0``): the chunk is a main drafted
      chain and one branch, the continuation of the tail gram's second
      most recent occurrence; one :meth:`GptLM.decode_chunk` verifies the
      tree through its ancestor mask, the longest accepted root path wins
      and :func:`fixup_tree_caches` compacts it.
    - Adaptive K: while the acceptance EMA is below ``adapt_threshold``
      a round is a 2-wide linear chunk, with a full round every
      ``probe_every`` rounds.

    Returns (tokens [B, P + num_tokens], stats ``{"rounds",
    "rounds_full", "rounds_small", "branch_hits", "tokens_generated",
    "mean_accepted_per_round"}``; ``branch_hits`` counts rows whose
    winning leaf sat on the branch)."""
    prompt = _prompt(model, prompt)
    B, P = prompt.shape
    total = P + num_tokens
    _validate_sampling(model, total, 0.0, 0.0, None)
    _validate_eos(model, eos_id)
    if model.cfg.attention_window:
        raise ValueError(
            "speculative decoding needs the full-length cache; the windowed "
            "ring cache cannot mask rejected speculative writes")
    if spec_k < 2:
        raise ValueError(f"spec_k must be >= 2, got {spec_k}")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    if probe_every < 1:
        raise ValueError(f"probe_every must be >= 1, got {probe_every}")
    branch_len = int(spec_branch)
    if branch_len < 0:
        raise ValueError(f"spec_branch must be >= 0, got {spec_branch}")
    if branch_len and spec_k - branch_len < 2:
        # No room for a branch beside a 2-node main chain: run linear.
        branch_len = max(0, spec_k - 2)
    run, cache_dtype = _decode_setup(model, params, quantize, kv_dtype)
    dev = model.device
    K, n = spec_k, ngram
    main = K - branch_len
    depths, anc, parent, path = (torch.from_numpy(a).to(dev)
                                 for a in spec_tree(K, branch_len))
    depths, parent, path = depths.long(), parent.long(), path.long()
    pidx = parent.clamp(min=0)[None, :].expand(B, K)
    nodes = torch.arange(K, device=dev)
    eos = -1 if eos_id is None else eos_id

    caches = init_kv_cache(model.cfg, B, total, dtype=cache_dtype,
                           device=dev)
    logits, _ = run("prefill", prompt, caches)
    toks = _output(prompt, total, None)
    lens = torch.full((B,), P, dtype=torch.long, device=dev)
    pending = torch.argmax(logits, dim=-1)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    last, prev = drafting.index_build2(toks, lens, n=n, max_len=P)
    ema = torch.tensor(float(K), device=dev)
    branch_hits = torch.zeros((), dtype=torch.long, device=dev)
    rounds = rounds_full = 0
    while True:
        live, high = torch.stack([torch.any(~done & (lens < total)),
                                  ema >= adapt_threshold]).tolist()
        if not live:
            break
        full = not adaptive or high or rounds % probe_every == 0
        # Commit the known-correct pending token at each live frontier.
        keep = ~done & (lens < total)
        write_rows(toks, lens, pending[:, None], keep[:, None])
        eff = lens + keep.long()
        tail = drafting.tail_gram(toks, eff, n=n)
        budget = total - lens
        if full:
            parts = [pending[:, None]]
            if main > 1:
                parts.append(drafting.index_draft(last, toks, tail, eff,
                                                  n=n, k=main - 1))
            if branch_len:
                parts.append(drafting.index_draft(prev, toks, tail, eff,
                                                  n=n, k=branch_len))
            chunk = torch.cat(parts, dim=1)                       # [B, K]
            logits, _ = run("decode_chunk", chunk, caches, lens, depths,
                            anc)
            greedy = torch.argmax(logits, dim=-1)
            # A node matches when it is the greedy continuation of its
            # parent and no eos precedes it; the root always matches.  A
            # node is accepted when all of its ancestors match.
            match = ((chunk == torch.gather(greedy, 1, pidx))
                     & (torch.gather(chunk, 1, pidx) != eos))
            match[:, 0] = True
            chain = torch.where(anc[None], match[:, None, :], True).all(-1)
            # Depth and slot inside the budget: a node's K/V sit at slot
            # lens + i, and a write past the cache end was dropped.
            eligible = (chain & (depths[None, :] < budget[:, None])
                        & (nodes[None, :] < budget[:, None]))
            score = torch.where(eligible, depths[None, :], -1)
            # The deepest accepted node; ties to the main chain.
            best = torch.argmax(score, dim=1)
            accept = torch.gather(score, 1, best[:, None])[:, 0] + 1
            accept = torch.where(keep, accept, 0)
            sel = path[best].clamp(min=0)                         # [B, K]
            accepted = torch.gather(chunk, 1, sel)
            fixup_tree_caches(caches, lens, sel, accept)
            branch_hits += ((best >= main) & keep).sum()
            rounds_full += 1
        else:
            drafts = drafting.index_draft(last, toks, tail, eff, n=n,
                                          k=_SPEC_K_SMALL - 1)
            accepted = torch.cat([pending[:, None], drafts], dim=1)
            logits, _ = run("decode_chunk", accepted, caches, lens)
            greedy = torch.argmax(logits, dim=-1)
            i_idx = torch.arange(1, _SPEC_K_SMALL, device=dev)[None, :]
            ok = ((accepted[:, 1:] == greedy[:, :-1])
                  & (i_idx < budget[:, None]) & (accepted[:, :-1] != eos))
            accept = 1 + torch.cumprod(ok.long(), dim=1).sum(dim=1)
            accept = torch.where(keep, torch.minimum(accept, budget), 0)
            best = (accept - 1).clamp(min=0)
        # The round's tail: token writes, the pending hand-off, eos, the
        # index update with the committed tokens, the acceptance EMA.
        width = accepted.shape[1]
        write = torch.arange(width, device=dev)[None, :] < accept[:, None]
        write_rows(toks, lens, accepted, write)
        pending = torch.gather(greedy, 1, best[:, None])[:, 0]
        hit_eos = (write & (accepted == eos)).any(dim=1)
        new_lens = lens + accept
        drafting.index_update2(last, prev, toks, lens, new_lens, n=n,
                               span=width)
        done = done | hit_eos | (new_lens >= total)
        n_live = keep.sum()
        acc_mean = accept.sum().float() / n_live.clamp(min=1).float()
        ema = torch.where(n_live > 0, 0.7 * ema + 0.3 * acc_mean, ema)
        lens = new_lens
        rounds += 1
    if eos_id is not None:
        tail_pos = torch.arange(total, device=dev)[None, :] >= lens[:, None]
        toks = torch.where(tail_pos, eos_id, toks)
    generated = int((lens - P).sum())
    stats = {"rounds": rounds, "rounds_full": rounds_full,
             "rounds_small": rounds - rounds_full,
             "branch_hits": int(branch_hits),
             "tokens_generated": generated,
             "mean_accepted_per_round": round(generated / max(rounds, 1),
                                              2)}
    return toks, stats


# ------------------------------------------------------------ the pipeline


def split_params_for_pipeline(params: dict, n_stages: int,
                              num_layers: int) -> dict:
    """A plain GPT tree (``word_emb``/``pos_emb``/``layer{i}``/
    ``ln_final``/``lm_head``, numpy or tensor leaves) as the pipeline's
    ``{"embed", "stages", "head"}`` tree, every ``stages`` leaf stacked
    [n_stages, layers_per_stage, ...] (stage-major), the JAX package's
    ``split_params_for_pipeline``; numpy leaves out.  The inverse is
    :func:`merge_pipeline_params`."""
    if num_layers % n_stages:
        raise ValueError(f"num_layers={num_layers} not divisible by "
                         f"pipeline stages={n_stages}")
    per = num_layers // n_stages

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        arr = np.stack([x.detach().cpu().numpy() if torch.is_tensor(x)
                        else np.asarray(x) for x in xs])
        return arr.reshape(n_stages, per, *arr.shape[1:])

    embed = {"word_emb": params["word_emb"]}
    if "pos_emb" in params:            # absent under pos_encoding="rope"
        embed["pos_emb"] = params["pos_emb"]
    return {"embed": embed,
            "stages": stack(*(params[f"layer{i}"]
                              for i in range(num_layers))),
            "head": {"ln_final": params["ln_final"],
                     "lm_head": params["lm_head"]}}


class GptStage(nn.Module):
    """One pipeline chunk: ``layers_per_stage`` consecutive decoder
    blocks, run in order."""

    def __init__(self, blocks):
        super().__init__()
        self.layers = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class GptEmbed(nn.Module):
    """The token (and learned position) embedding, outside the stages."""

    def __init__(self, cfg: GptConfig, word_emb, pos_emb):
        super().__init__()
        self.cfg = cfg
        self.word_emb = word_emb
        if pos_emb is not None:
            self.pos_emb = pos_emb

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.word_emb(tokens)
        if self.cfg.pos_encoding != "rope":
            x = x + self.pos_emb(torch.arange(tokens.shape[1],
                                              device=tokens.device)[None])
        return x.to(self.cfg.torch_dtype)


class GptHead(nn.Module):
    """The final norm and the LM head, after the stages."""

    def __init__(self, ln_final, lm_head):
        super().__init__()
        self.ln_final = ln_final
        self.lm_head = lm_head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_final(x))


class PipelinedGptLM(nn.Module):
    """A :class:`GptLM`'s modules laid out for the pipeline: ``embed``,
    ``stages`` (``n_pipe * n_virtual`` chunks of consecutive blocks in
    natural order, chunk ``c`` on pipe position ``c % n_pipe``) and
    ``head`` (on the last pipe position).  :meth:`from_gpt` takes a
    model's own modules (no copy), so a seed gives the unpipelined
    model's weights.  ``forward`` runs the layers in order, the
    schedule-agnostic apply; the train steps run the schedules
    (:func:`make_pipelined_gpt_apply`,
    :func:`make_1f1b_gpt_train_step_builder`).  The checkpoint tree is
    the JAX package's stage-stacked one (:meth:`params_to_tree`).

    With ``pipe`` across processes (``pipe_mesh``: the worker's part of
    the global mesh) a rank holds only its own chunks (every other chunk
    an empty :class:`GptStage`, so the names stay global), the embedding
    on pipe rank 0 and the head on the last (``None`` elsewhere);
    :meth:`forward` then runs the chunks over the pipe group and gives
    the last rank's logits to every rank (JAX's one-hot ``psum``)."""

    def __init__(self, cfg: GptConfig, embed: GptEmbed | None, stages,
                 head: GptHead | None, n_pipe: int, n_virtual: int = 1,
                 pipe_mesh=None):
        super().__init__()
        self.cfg = cfg
        self.n_pipe, self.n_virtual = n_pipe, n_virtual
        self.embed = embed
        self.stages = nn.ModuleList(stages)
        self.head = head
        self.pipe_mesh = pipe_mesh
        #: Where the whole batch's tokens go (the first own position).
        self.device = None

    @classmethod
    def from_gpt(cls, model: GptLM, devices, n_virtual: int = 1, *,
                 pipe_mesh=None) -> "PipelinedGptLM":
        """``model``'s modules as ``len(devices)`` pipe positions of
        ``n_virtual`` chunks each, every module moved to its position's
        device.  With ``pipe_mesh`` (``pipe`` across processes) the
        positions are the pipe group's ranks, ``devices`` this rank's one
        device, and the rank keeps its own chunks only."""
        from ..parallel.mesh import PIPE_AXIS
        cfg = model.cfg
        if pipe_mesh is not None:
            n_pipe = pipe_mesh.global_shape[PIPE_AXIS]
            me = pipe_mesh.ranks.coords[PIPE_AXIS]
            devices = [devices[0] if s == me else None
                       for s in range(n_pipe)]
        else:
            n_pipe = len(devices)
        V = n_pipe * n_virtual
        if cfg.num_layers % V:
            raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                             f"pipeline stages={V}")
        per = cfg.num_layers // V
        stages = [GptStage([]) if devices[c % n_pipe] is None else
                  GptStage(list(model.layers[c * per:(c + 1) * per])).to(
                      devices[c % n_pipe]) for c in range(V)]
        embed = head = None
        if devices[0] is not None:
            embed = GptEmbed(cfg, model.word_emb,
                             getattr(model, "pos_emb", None)).to(devices[0])
        if devices[-1] is not None:
            head = GptHead(model.ln_final, model.lm_head).to(devices[-1])
        out = cls(cfg, embed, stages, head, n_pipe, n_virtual, pipe_mesh)
        # Every chunk's parameter shapes by name, the other ranks' too.
        out.full_shapes = {}
        for name, p in model.named_parameters():
            part, _, rest = name.partition(".")
            if part == "layers":
                i, _, leaf = rest.partition(".")
                name = f"stages.{int(i) // per}.layers.{int(i) % per}.{leaf}"
            elif part in ("word_emb", "pos_emb"):
                name = f"embed.{name}"
            else:
                name = f"head.{name}"
            out.full_shapes[name] = tuple(p.shape)
        out.device = next(d for d in devices if d is not None)
        return out

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.pipe_mesh is not None:
            return self._forward_ranks(tokens)
        x = self.embed(tokens)
        for stage in self.stages:
            x = stage(x.to(stage.layers[0].ln_attn.scale.device))
        return self.head(x.to(self.head.lm_head.kernel.device))

    def _forward_ranks(self, tokens: torch.Tensor) -> torch.Tensor:
        """The chunks in order over the pipe group (each boundary one
        send from the chunk's rank to the next chunk's), the last rank's
        logits given to every rank."""
        from ..parallel.mesh import PIPE_AXIS
        from ..parallel.transport import exchange, link, psum_from
        pipe = link(self.pipe_mesh, PIPE_AXIS)
        P_, me = pipe.size, pipe.coord
        B, S = tokens.shape
        act = (B, S, self.cfg.hidden_size)
        x = self.embed(tokens.to(self.device)) if me == 0 else None
        for c, stage in enumerate(self.stages):
            if c % P_ == me:
                x = stage(x)
            if c + 1 == len(self.stages):
                break
            src, dst = c % P_, (c + 1) % P_
            if me == src:
                exchange(pipe, [(dst, x)], [])
                x = None
            elif me == dst:
                (x,) = exchange(pipe, [], [(src, act, self.cfg.torch_dtype,
                                            self.device)])
        logits = self.head(x) if me == P_ - 1 else None
        return psum_from(pipe, logits, P_ - 1,
                         (B, S, self.cfg.vocab_size), torch.float32,
                         self.device)

    def _layer(self, c: int, l: int) -> int:
        return c * (self.cfg.num_layers // len(self.stages)) + l

    def params_to_tree(self, named: dict) -> dict:
        """``{state_dict name: tensor}`` -> the JAX package's pipeline
        tree (``stages`` [n_pipe, per, ...], or [n_virtual, n_pipe, per,
        ...] interleaved; numpy leaves).  A rank's own names alone (pipe
        across processes) fill the other ranks' entries with NaN: the
        tree's layout, for its paths (``training/state.param_paths``)."""
        missing = set(self.full_shapes) - set(named) \
            if self.pipe_mesh is not None else ()
        if missing:
            # (``param_paths``' markers are scalars: so are their fills.)
            scalar = all(t.dim() == 0 for t in named.values())
            named = dict(named)
            for name in missing:
                named[name] = torch.full(
                    () if scalar else self.full_shapes[name], math.nan)
        plain = {}
        for name, t in named.items():
            part, _, rest = name.partition(".")
            if part == "stages":
                c, _, l, leaf = rest.split(".", 3)
                plain[f"layers.{self._layer(int(c), int(l))}.{leaf}"] = t
            else:
                plain[rest] = t
        L, V = self.cfg.num_layers, len(self.stages)
        tree = split_params_for_pipeline(params_to_jax(plain), V, L)
        if self.n_virtual > 1:
            tree["stages"] = _tree_map(
                lambda a: a.reshape(self.n_virtual, self.n_pipe,
                                    *a.shape[1:]), tree["stages"])
        return tree

    def params_from_tree(self, tree: dict) -> dict:
        """Inverse of :meth:`params_to_tree` (a checkpoint of either
        package): fp32 CPU tensors by ``state_dict`` name."""
        per = self.cfg.num_layers // len(self.stages)
        own = (dict(self.named_parameters()) if self.pipe_mesh is not None
               else None)
        plain = params_from_jax(merge_pipeline_params(
            tree, self.cfg.num_layers, self.n_virtual))
        out = {}
        for name, t in plain.items():
            part, _, rest = name.partition(".")
            if part == "layers":
                i, _, leaf = rest.partition(".")
                out[f"stages.{int(i) // per}.layers.{int(i) % per}."
                    f"{leaf}"] = t
            elif part in ("word_emb", "pos_emb"):
                out[f"embed.{name}"] = t
            else:
                out[f"head.{name}"] = t
        if own is not None:
            # A rank restores its own chunks (and the embedding or head).
            out = {n: t for n, t in out.items() if n in own}
        return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stage_fn(stage: GptStage, x: torch.Tensor) -> torch.Tensor:
    return stage(x)


def make_pipelined_gpt_apply(cfg: GptConfig, mesh, *, n_micro: int,
                             remat: bool = True):
    """``apply(model, tokens) -> logits`` of a :class:`PipelinedGptLM`
    with the decoder blocks run as a GPipe schedule over the mesh's
    ``pipe`` axis (:func:`..parallel.pipeline.make_pipeline_fn`); the
    embedding and the head run outside it on the whole batch.  Same math
    as ``GptLM.forward``."""
    from ..parallel.pipeline import make_pipeline_fn
    pipe_fwd = make_pipeline_fn(mesh, _stage_fn, n_micro=n_micro,
                                remat=remat)

    def apply(model, tokens):
        x = pipe_fwd(model.stages, model.embed(tokens))
        return model.head(x.to(model.head.lm_head.kernel.device))

    return apply


def make_interleaved_gpt_apply(cfg: GptConfig):
    """``apply(model, tokens) -> logits`` for the interleaved layout: the
    chunks in natural layer order (``PipelinedGptLM.forward``), for eval
    and the loss where the schedule does not matter."""
    def apply(model, tokens):
        return model(tokens)

    return apply


def make_1f1b_gpt_train_step_builder(cfg: GptConfig, *, n_micro: int,
                                     label_smoothing: float = 0.0,
                                     n_virtual: int = 1,
                                     gpipe: bool = False):
    """``builder(mesh, all_reduce=None, log_grad_norm=False) -> step``:
    the 1F1B-scheduled train step of a :class:`PipelinedGptLM`
    (:func:`..parallel.pipeline.build_1f1b_pipeline_train_step`), the
    interleaved one with ``n_virtual > 1``, or GPipe's slots with
    ``gpipe`` (the pipe axis across processes).  Same math and parameter
    layout as the GPipe path; the stash of stage inputs is bounded by the
    pipe depth, not the micro-batch count."""
    from ..parallel.pipeline import (build_1f1b_pipeline_train_step,
                                     build_gpipe_train_step,
                                     build_interleaved_1f1b_train_step)

    def act_fn(model, batch, n_micro_):
        B, S = batch["tokens"].shape
        return ((B // n_micro_, S, cfg.hidden_size), cfg.torch_dtype,
                model.device)

    def embed_fn(embed, batch):
        return embed(torch.as_tensor(batch["tokens"],
                                     device=embed.word_emb.embedding.device
                                     ).long())

    def loss_head_fn(head, y, micro_batch):
        tokens = torch.as_tensor(micro_batch["tokens"],
                                 device=y.device).long()
        loss, acc = lm_loss(head(y), tokens,
                            label_smoothing=label_smoothing)
        return loss, {"accuracy": acc}

    def builder(mesh, all_reduce=None, log_grad_norm: bool = False):
        kw = dict(n_micro=n_micro, embed_fn=embed_fn, all_reduce=all_reduce,
                  log_grad_norm=log_grad_norm, act_fn=act_fn)
        if n_virtual > 1:
            return build_interleaved_1f1b_train_step(
                mesh, _stage_fn, loss_head_fn, n_virtual=n_virtual, **kw)
        if gpipe:
            return build_gpipe_train_step(mesh, _stage_fn, loss_head_fn,
                                          **kw)
        return build_1f1b_pipeline_train_step(mesh, _stage_fn,
                                              loss_head_fn, **kw)

    return builder


def gpt_sharding_rules() -> ShardingRules:
    """Megatron pairing over the ``model`` axis (the JAX package's rules,
    against the same flax paths: :func:`params_to_jax`'s names)."""
    return ShardingRules([
        (r"qkv/kernel", P(None, None, "model", None)),
        (r"qkv/bias", P(None, "model", None)),
        (r"q_proj/kernel", P(None, "model", None)),
        (r"q_proj/bias", P("model", None)),
        # kv_proj deliberately REPLICATES under TP: its kv-head axis is
        # usually smaller than the model axis, and at heads/G compression
        # the tensor is tiny — every device holding full K/V is the
        # standard GQA tensor-parallel layout.
        (r"/out/kernel", P("model", None, None)),  # attention proj only
                                                   # (mlp_out matches below)
        (r"mlp_in/kernel", P(None, "model")),
        (r"mlp_in/bias", P("model")),
        (r"mlp_gate/kernel", P(None, "model")),   # column-parallel like mlp_in
        (r"mlp_out/kernel", P("model", None)),
        (r"(word_emb|pos_emb)/embedding", P("model", None)),
        (r"lm_head/kernel", P(None, "model")),
        (r"lm_head/bias", P("model")),
    ])


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
    [H].  Leaves may be arrays or tensors (a restored checkpoint's,
    :func:`..tools.checkpoint_io.restore_raw`)."""
    out = {}
    for name, leaf in _leaves(tree):
        head, _, rest = name.partition(".")
        if head.startswith("layer") and head[5:].isdigit():
            name = f"layers.{int(head[5:])}.{rest}"
        if isinstance(leaf, torch.Tensor):       # a restored checkpoint's
            out[name] = leaf.detach().to("cpu", torch.float32)
        else:
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
