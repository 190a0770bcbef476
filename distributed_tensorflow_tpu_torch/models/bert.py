"""BERT-tiny for masked-language-model training (``BASELINE.json`` config
#5, sync replicas); the counterpart of
``distributed_tensorflow_tpu/models/bert.py``.

- Embeddings (word + position) and ``ln_emb`` in fp32, then the
  activations in ``cfg.dtype`` (bf16 by default) on fp32 masters.
- Post-LN encoder layers: ``ln_attn(x + attention)`` and ``ln_mlp(x +
  mlp)``, each LayerNorm returning fp32, which the next bf16 projection
  casts (as flax's ``nn.LayerNorm(dtype=float32)`` does).
- Attention through :func:`..ops.attention.dot_product_attention` with the
  key-padding mask (``kv_mask``): ``attention_backend="pallas"`` runs the
  flash-attention kernels non-causal with the mask (K1, K2a/K2b),
  ``"ring"`` the ring's chunk kernels (K6/K7), ``fused_ln`` the LayerNorm
  kernel (K3) at all six LayerNorms of BERT-tiny's forward (``ln_emb``,
  two a layer, ``mlm_ln``).
- MLM head: ``mlm_dense`` (fp32) -> tanh gelu -> ``mlm_ln`` -> ``mlm_out``.
- Dropout (``dropout_rate``) on the embeddings, the attention output and
  the MLP output in training, drawn from explicit generators (one seed a
  layer from the step's generator, so ``remat``'s recomputation draws
  the same masks); ``remat`` recomputes each layer in the backward.
- Tensor parallelism: :func:`bert_sharding_rules` (the JAX rules) and
  GPT's Megatron pieces (:func:`.gpt.fused_head_attention`,
  :func:`.gpt.gelu_mlp`, the vocab-parallel :class:`.gpt.Embed`).

Parameters keep flax's names and layouts (``bert/layer0/attention/qkv/
kernel`` [128, 3, heads, D], ``bert/word_emb/embedding`` [vocab, 128],
...): the modules' attribute names are flax's, so :func:`params_from_jax`
only joins the names.  With ``num_experts > 0`` each layer's FFN is the
top-k mixture of experts of ``ops/moe.py`` (``layer{i}/moe/router/
kernel``, ``layer{i}/moe/experts/{wi,wo}/...``), its objective
:func:`make_moe_mlm_loss_fn` and its placement
:func:`bert_moe_sharding_rules` (the experts over ``expert``, the rest
as :func:`bert_sharding_rules`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import default_mesh
from ..ops.layer_norm import LayerNorm
from ..ops.moe import MoeMlp, StackedDense
from ..parallel.sharding import P, ShardingRules
from ..training.state import flat_names, nested_tree
from ..utils.device import resolve_device
from .gpt import (Dense, Embed, _generator, dropout, fused_head_attention,
                  gelu_mlp)
from .image_input import lecun_normal_


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 128          # BERT-tiny: L=2, H=128, A=2
    num_layers: int = 2
    num_heads: int = 2
    intermediate_size: int = 512
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.0       # 0 keeps the train step deterministic
    dtype: str = "bfloat16"         # activation dtype (params stay fp32)
    attention_backend: str = "xla"
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    remat: bool = False
    fused_ln: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def tiny() -> BertConfig:
    return BertConfig()


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        kw = dict(dtype=cfg.torch_dtype, param_dtype=torch.float32,
                  device=device)
        self.qkv = Dense((H,), (3, nh, hd), **kw)
        self.out = Dense((nh, hd), (H,), **kw)


class TransformerLayer(nn.Module):
    """Post-LN encoder layer.  ``mesh``: the sequence-parallel backends'
    (captured from ``attention_mesh`` at the first call)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = None
        H, I = cfg.hidden_size, cfg.intermediate_size
        kw = dict(dtype=cfg.torch_dtype, param_dtype=torch.float32,
                  device=device)
        self.attention = SelfAttention(cfg, device)
        self.ln_attn = LayerNorm(H, fused=cfg.fused_ln, device=device)
        if cfg.num_experts > 0:
            self.moe = MoeMlp(H, cfg.num_experts, I, top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              dtype=cfg.torch_dtype, device=device)
        else:
            self.mlp_in = Dense((H,), (I,), **kw)
            self.mlp_out = Dense((I,), (H,), **kw)
        self.ln_mlp = LayerNorm(H, fused=cfg.fused_ln, device=device)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        """``seed`` (training with dropout) seeds the layer's generator;
        None runs without dropout."""
        cfg = self.cfg
        if cfg.attention_backend in ("ring", "ulysses") and self.mesh is None:
            self.mesh = default_mesh()
        g = _generator(seed, x.device)
        attn = fused_head_attention(
            self.attention.qkv, self.attention.out, x, mesh=self.mesh,
            kv_mask=attention_mask, causal=False,
            backend=cfg.attention_backend)
        if g is not None:
            attn = dropout(attn, cfg.dropout_rate, g)
        x = self.ln_attn(x + attn)
        if cfg.num_experts > 0:
            h = self.moe(x)
        else:
            h = gelu_mlp(self.mlp_in, self.mlp_out, x)
        if g is not None:
            h = dropout(h, cfg.dropout_rate, g)
        return self.ln_mlp(x + h)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_emb = Embed(cfg.vocab_size, H, device=device)
        self.pos_emb = Embed(cfg.max_position, H, device=device)
        self.ln_emb = LayerNorm(H, fused=cfg.fused_ln, device=device)
        self.layers = []
        for i in range(cfg.num_layers):
            layer = TransformerLayer(cfg, device)
            setattr(self, f"layer{i}", layer)
            self.layers.append(layer)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                seeds=None) -> torch.Tensor:
        """[B, S, hidden] fp32.  ``seeds``: one for the embedding's
        dropout and one a layer (None: no dropout)."""
        cfg = self.cfg
        S = input_ids.shape[1]
        seeds = seeds or [None] * (cfg.num_layers + 1)
        x = self.word_emb(input_ids) + self.pos_emb(
            torch.arange(S, device=input_ids.device)[None, :])
        x = self.ln_emb(x)
        g = _generator(seeds[0], x.device)
        if g is not None:
            x = dropout(x, cfg.dropout_rate, g)
        x = x.to(cfg.torch_dtype)
        for layer, seed in zip(self.layers, seeds[1:]):
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, attention_mask, seed,
                               use_reentrant=False)
            else:
                x = layer(x, attention_mask, seed)
        return x.to(torch.float32)


class BertForMLM(nn.Module):
    """Encoder + MLM head.  ``device`` defaults to ``cuda``; weights from
    flax's initializers (LeCun-normal kernels, zero biases, embeddings
    normal with variance 1/hidden, LayerNorm 1/0) drawn from a generator
    on ``device`` seeded by ``seed``.  ``mesh``: the sequence-parallel
    backends' mesh (else captured at the first call)."""

    def __init__(self, cfg: BertConfig, *, seed: int = 0, device=None,
                 mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.bert = BertModel(cfg, device)
        for layer in self.bert.layers:
            layer.mesh = mesh
        self.mlm_dense = Dense((H,), (H,), dtype=None,
                               param_dtype=torch.float32, device=device)
        self.mlm_ln = LayerNorm(H, fused=cfg.fused_ln, device=device)
        self.mlm_out = Dense((H,), (cfg.vocab_size,), dtype=None,
                             param_dtype=torch.float32, device=device)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        device = self.mlm_out.kernel.device
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, Dense):
                lecun_normal_(module.kernel, module.fan_in, g)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, StackedDense):
                lecun_normal_(module.kernel, module.kernel.shape[1], g)
                module.bias.zero_()
            elif isinstance(module, Embed):
                module.embedding.normal_(
                    0.0, 1.0 / math.sqrt(module.embedding.shape[1]),
                    generator=g)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Logits [B, S, vocab] (fp32).  Dropout runs in ``train()`` mode
        when ``cfg.dropout_rate > 0`` and then needs ``rng``: one seed for
        the embedding and one a layer are drawn from it."""
        cfg = self.cfg
        seeds = None
        if self.training and cfg.dropout_rate > 0.0:
            if rng is None:
                raise ValueError("dropout in training mode needs rng (a "
                                 "torch.Generator)")
            seeds = torch.randint(0, 2 ** 62, (cfg.num_layers + 1,),
                                  generator=rng, device=rng.device).tolist()
        hidden = self.bert(input_ids, attention_mask, seeds)
        h = self.mlm_ln(F.gelu(self.mlm_dense(hidden), approximate="tanh"))
        return self.mlm_out(h)


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_weights: torch.Tensor, label_smoothing: float = 0.0):
    """Masked-position cross-entropy (the JAX ``mlm_loss``):
    ``label_weights`` [B, S] is 1 at masked positions, 0 elsewhere.
    Returns (loss, accuracy) over the masked positions, 0-dim tensors;
    ``label_smoothing`` gives ``(1-a)*nll + a*mean_vocab_nll``."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        ll = ((1.0 - label_smoothing) * ll
              + label_smoothing * logp.mean(dim=-1))
    w = label_weights.to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)
    loss = -(ll * w).sum() / denom
    correct = (logits.argmax(-1) == labels.long()).to(torch.float32)
    return loss, (correct * w).sum() / denom


def make_moe_mlm_loss_fn(aux_weight: float | None = None,
                         label_smoothing: float = 0.0):
    """The MoE MLM objective (the JAX ``make_moe_mlm_loss_fn``): the
    masked-LM loss plus ``aux_weight`` (default ``DEFAULT_AUX_WEIGHT``)
    times the load-balance loss averaged over the layers.
    ``loss_fn(model, batch, rng=None) -> (loss, {"accuracy",
    "moe_aux"})``; ``batch`` holds numpy arrays or tensors."""
    from ..ops.moe import DEFAULT_AUX_WEIGHT, collect_aux_loss
    if aux_weight is None:
        aux_weight = DEFAULT_AUX_WEIGHT

    def loss_fn(model, batch, rng=None):
        device = next(model.parameters()).device
        t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        logits = model(t["input_ids"].long(), t["attention_mask"], rng)
        loss, acc = mlm_loss(logits, t["labels"], t["label_weights"],
                             label_smoothing=label_smoothing)
        aux = collect_aux_loss(model).to(loss.device)
        return loss + aux_weight * aux, {"accuracy": acc, "moe_aux": aux}

    return loss_fn


_TP_RULES = [
    (r"qkv/kernel", P(None, None, "model", None)),
    (r"qkv/bias", P(None, "model", None)),
    (r"attention/out/kernel", P("model", None, None)),
    (r"mlp_in/kernel", P(None, "model")),
    (r"mlp_in/bias", P("model")),
    (r"mlp_out/kernel", P("model", None)),
    (r"(word_emb|pos_emb|type_emb)/embedding", P("model", None)),
    (r"mlm_out/kernel", P(None, "model")),
    (r"mlm_out/bias", P("model")),
]


def bert_sharding_rules() -> ShardingRules:
    """Tensor-parallel placement over the ``model`` axis (the JAX
    package's rules): ``qkv``/``mlp_in`` split by their output,
    ``attention/out``/``mlp_out`` by their input, the embeddings by their
    rows (vocab parallel) and ``mlm_out`` by the vocabulary."""
    return ShardingRules(_TP_RULES)


def bert_moe_sharding_rules() -> ShardingRules:
    """The MoE's rules ahead of the tensor-parallel ones: the stacked
    experts over ``expert``, everything else as
    :func:`bert_sharding_rules` (the two axes compose on one mesh)."""
    from ..ops.moe import moe_sharding_rules
    return ShardingRules(moe_sharding_rules() + _TP_RULES)


def synthetic_mlm_batch(rng, batch_size: int, seq_len: int,
                        cfg: BertConfig, mask_fraction: float = 0.15):
    """Deterministic synthetic MLM batch (no tokenizer or corpus), the JAX
    package's draw step for step, so both packages make the same batches
    from a seed (``rng``: an int, else its first element).

    Sequences follow a learnable structure (token = f(base, position)) so
    the MLM loss decreases under training."""
    rng = np.random.default_rng(rng if isinstance(rng, int) else int(rng[0]))
    span = max(1, min(256, cfg.vocab_size - 5))
    base = rng.integers(0, 64, size=(batch_size, 1))
    offs = np.arange(seq_len)[None, :]
    input_ids = ((base + offs * 3) % span + 5).astype(np.int32)
    labels = input_ids.copy()
    n_mask = max(1, int(seq_len * mask_fraction))
    weights = np.zeros((batch_size, seq_len), np.float32)
    mask_token = 4
    for b in range(batch_size):
        pos = rng.choice(seq_len, size=n_mask, replace=False)
        weights[b, pos] = 1.0
        input_ids[b, pos] = mask_token
    attention_mask = np.ones((batch_size, seq_len), np.int32)
    return {"input_ids": input_ids, "attention_mask": attention_mask,
            "labels": labels, "label_weights": weights}


def params_from_jax(tree: dict) -> dict:
    """The JAX ``BertForMLM`` parameter tree (arrays or a restored
    checkpoint's tensors) -> this module's ``state_dict`` (fp32 CPU
    tensors)."""
    return flat_names(tree)


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_jax` (fp32 numpy leaves)."""
    return nested_tree(state_dict)
