"""ViT-tiny, a Vision Transformer image classifier; the counterpart of
``distributed_tensorflow_tpu/models/vit.py``.

- Patchify is the JAX model's pure layout transform (``vit.py:107-109``):
  a [B, 32, 32, 3] image becomes [B, 64, 48] patch vectors, then one
  Dense embeds them.
- Pre-LN encoder blocks (bidirectional attention, ``causal=False``)
  through :func:`..ops.attention.dot_product_attention`: with
  ``attention_backend="pallas"`` the flash-attention kernels (K1 forward,
  K2a/K2b backward), with ``fused_ln`` the LayerNorm kernel (K3), as for
  BERT and GPT.
- Mean-pooled (in fp32) representation -> linear head.
- Tensor parallelism: :func:`vit_sharding_rules` (the JAX rules) split
  ``qkv``/``mlp_in`` by their output and ``out``/``mlp_out`` by their
  input, and a placed block computes Megatron's way with GPT's pieces
  (:func:`.gpt.fused_head_attention`, :func:`.gpt.gelu_mlp`).

Parameters keep flax's names and layouts (``patch_embed/kernel`` [48,
128], ``pos_emb`` [64, 128], ``layer{i}/qkv/kernel`` [128, 3, heads, D],
``layer{i}/out/kernel`` [heads, D, 128], ...): the module's attribute
names are flax's, so :func:`params_from_jax` only joins the names.
Projections compute in ``cfg.dtype`` (bf16 by default) on fp32 masters.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.attention import default_mesh
from ..ops.layer_norm import LayerNorm
from ..parallel.sharding import P, ShardingRules
from ..training.state import flat_names, nested_tree
from ..utils.device import resolve_device
from .gpt import Dense, fused_head_attention, gelu_mlp
from .image_input import lecun_normal_, nhwc_images


@dataclasses.dataclass(frozen=True)
class VitConfig:
    image_size: int = 32
    channels: int = 3
    patch_size: int = 4
    hidden_size: int = 128
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 256
    num_classes: int = 10
    dtype: str = "bfloat16"
    attention_backend: str = "xla"
    fused_ln: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def tiny() -> VitConfig:
    return VitConfig()


class VitBlock(nn.Module):
    """Pre-LN encoder block (bidirectional attention: images, not
    causal).  ``mesh``: the sequence-parallel backends' (captured from
    ``attention_mesh`` at the first call, as GPT's blocks do)."""

    def __init__(self, cfg: VitConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = None
        H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        kw = dict(dtype=cfg.torch_dtype, param_dtype=torch.float32,
                  device=device)
        self.ln_attn = LayerNorm(H, fused=cfg.fused_ln, device=device)
        self.qkv = Dense((H,), (3, nh, hd), **kw)
        self.out = Dense((nh, hd), (H,), **kw)
        self.ln_mlp = LayerNorm(H, fused=cfg.fused_ln, device=device)
        self.mlp_in = Dense((H,), (cfg.intermediate_size,), **kw)
        self.mlp_out = Dense((cfg.intermediate_size,), (H,), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.attention_backend in ("ring", "ulysses") and self.mesh is None:
            self.mesh = default_mesh()
        h = self.ln_attn(x).to(cfg.torch_dtype)
        x = x + fused_head_attention(self.qkv, self.out, h, mesh=self.mesh,
                                     causal=False,
                                     backend=cfg.attention_backend)
        h = self.ln_mlp(x).to(cfg.torch_dtype)
        return x + gelu_mlp(self.mlp_in, self.mlp_out, h)


class VitClassifier(nn.Module):
    """Patchify -> embed (+pos) -> encoder stack -> mean pool -> head.
    Weights from flax's initializers (LeCun-normal kernels, zero biases,
    ``pos_emb`` normal(0.02), LayerNorm 1/0) drawn from a generator on
    ``device`` seeded by ``seed``; ``device`` defaults to ``cuda``."""

    def __init__(self, cfg: VitConfig, *, seed: int = 0, device=None,
                 mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.patch_embed = Dense((cfg.patch_dim,), (H,),
                                 dtype=cfg.torch_dtype,
                                 param_dtype=torch.float32, device=device)
        self.pos_emb = nn.Parameter(torch.zeros(
            cfg.num_patches, H, dtype=torch.float32, device=device))
        self.layers = []
        for i in range(cfg.num_layers):
            block = VitBlock(cfg, device)
            block.mesh = mesh
            setattr(self, f"layer{i}", block)
            self.layers.append(block)
        self.ln_final = LayerNorm(H, fused=cfg.fused_ln, device=device)
        self.head = Dense((H,), (cfg.num_classes,), dtype=None,
                          param_dtype=torch.float32, device=device)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.pos_emb.device)
        g.manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, Dense):
                lecun_normal_(module.kernel, module.fan_in, g)
                module.bias.zero_()
        self.pos_emb.normal_(0.0, 0.02, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = x.shape[0]
        x = nhwc_images(x, cfg.image_size, cfg.channels)
        p, n = cfg.patch_size, cfg.image_size // cfg.patch_size
        # [B, H, W, C] -> [B, n, n, p, p, C] -> [B, n*n, p*p*C]: pure layout.
        x = x.reshape(B, n, p, n, p, cfg.channels).permute(
            0, 1, 3, 2, 4, 5).reshape(B, cfg.num_patches, cfg.patch_dim)
        x = self.patch_embed(x)
        x = x + self.pos_emb[None].to(x.dtype)
        for block in self.layers:
            x = block(x)
        pooled = self.ln_final(x).to(torch.float32).mean(dim=1)
        return self.head(pooled)


def vit_sharding_rules() -> ShardingRules:
    """Megatron pairing over the ``model`` axis (the JAX package's rules;
    ``patch_embed``, ``pos_emb`` and ``head`` stay replicated)."""
    return ShardingRules([
        (r"qkv/kernel", P(None, None, "model", None)),
        (r"qkv/bias", P(None, "model", None)),
        (r"/out/kernel", P("model", None, None)),
        (r"mlp_in/kernel", P(None, "model")),
        (r"mlp_in/bias", P("model")),
        (r"mlp_out/kernel", P("model", None)),
    ])


def params_from_jax(tree: dict) -> dict:
    """The JAX ViT's parameter tree (arrays or a restored checkpoint's
    tensors) -> this module's ``state_dict`` (fp32 CPU tensors)."""
    return flat_names(tree)


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_jax` (fp32 numpy leaves)."""
    return nested_tree(state_dict)
