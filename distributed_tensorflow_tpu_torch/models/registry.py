"""Model bundles: a model with its train state, loss, data and eval.

Counterpart of ``distributed_tensorflow_tpu/models/registry.py``, so far
for the GPT-mini decoder (:func:`build_gpt_mini`), the entry point that
``tests/test_gpt.py`` and ``bench.py`` train through in the JAX package,
and the pipelined GPT's checkpoint namespace
(:func:`pipeline_bundle_name`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..training.optimizers import OptimizerSpec, make_optimizer
from ..training.state import TrainState
from ..utils.device import resolve_device


@dataclasses.dataclass
class ModelBundle:
    state: TrainState
    loss_fn: Callable                   # (model, batch) -> (loss, aux)
    load_datasets: Callable             # (data_dir) -> Datasets-like splits
    make_eval_fn: Callable              # () -> eval_fn(state, split) -> float
    name: str
    # True when loss_fn takes (model, batch, rng): dropout-style stochastic
    # training; the state then carries the generator.
    needs_rng: bool = False


def _default_transformer_tx(learning_rate: float, name: str) -> OptimizerSpec:
    """Transformer default optimizer: Adam with the generic learning rate
    (0.01, tuned for SGD) capped to an Adam-appropriate scale."""
    lr = min(learning_rate, 1e-3)
    if lr != learning_rate:
        print(f"{name}: capping --learning_rate {learning_rate} to {lr} "
              "(Adam-appropriate scale; the 0.01 default is tuned for SGD)")
    return make_optimizer("adam", lr)


def build_gpt_mini(learning_rate: float, seed: int = 0, seq_len: int = 128,
                   attention_backend: str = "xla", dtype: str = "bfloat16",
                   remat: bool = False, tx: OptimizerSpec | None = None,
                   dropout_rate: float = 0.0,
                   fused_ln: bool = False,
                   label_smoothing: float = 0.0,
                   pos_encoding: str = "learned",
                   kv_heads: int = 0,
                   attention_window: int = 0,
                   activation: str = "gelu",
                   norm: str = "layernorm",
                   matmul_int8: bool = False,
                   attn_int8: bool = False,
                   tokenizer: str = "byte",
                   stream_threshold_mb: int = 256, *,
                   device=None, mesh=None) -> ModelBundle:
    """GPT-mini decoder-only causal LM with fp32 master weights, its
    optimizer (Adam by default) and the LM data streams.  ``matmul_int8``
    / ``attn_int8`` train the MLP / the attention projections through the
    int8 matmuls of ``ops/quant_train.py``.  ``attention_backend="ring"``
    trains with sequence-parallel ring attention over ``mesh``'s ``seq``
    axis (a ``parallel.mesh.Mesh``; or the one of
    ``ops.attention.attention_mesh`` around the first step).  ``device``
    defaults to ``cuda`` (pass ``"cpu"`` for the CPU); the model's
    weights come from ``seed``, the dropout generator from ``seed + 1``."""
    from . import gpt as gpt_lib
    from ..data.lm import make_lm_datasets, make_lm_eval_fn

    cfg = dataclasses.replace(
        gpt_lib.mini(), attention_backend=attention_backend, dtype=dtype,
        remat=remat, dropout_rate=dropout_rate, fused_ln=fused_ln,
        pos_encoding=pos_encoding, kv_heads=kv_heads,
        attention_window=attention_window, activation=activation, norm=norm,
        matmul_int8=matmul_int8, attn_int8=attn_int8)
    if tokenizer == "bpe":
        raise NotImplementedError("the BPE tokenizer is not ported yet; see "
                                  "ROADMAP.md, PyTorch port")
    device = resolve_device(device)
    model = gpt_lib.GptLM(cfg, device=device, seed=seed,
                          param_dtype=torch.float32, mesh=mesh)
    if tx is None:
        tx = _default_transformer_tx(learning_rate, "gpt_mini")
    needs_rng = dropout_rate > 0.0
    rng = None
    if needs_rng:
        rng = torch.Generator()
        rng.manual_seed(seed + 1)
    state = TrainState.create(model, tx, rng=rng)

    def _loss(model, batch, rng=None):
        tokens = torch.as_tensor(batch["tokens"], device=device).long()
        logits = model(tokens, rng)
        loss, acc = gpt_lib.lm_loss(logits, tokens,
                                    label_smoothing=label_smoothing)
        return loss, {"accuracy": acc}

    if needs_rng:
        loss_fn = _loss
    else:
        def loss_fn(model, batch):
            return _loss(model, batch)

    def load_datasets(data_dir):
        # Byte corpus when data_dir holds *.txt; the synthetic stream
        # otherwise.
        return make_lm_datasets(cfg, seq_len=seq_len, data_dir=data_dir,
                                tokenizer=tokenizer,
                                stream_threshold_bytes=(
                                    stream_threshold_mb << 20))

    return ModelBundle(state, loss_fn, load_datasets,
                       lambda: make_lm_eval_fn(lambda m, t: m(t)),
                       "gpt_mini", needs_rng=needs_rng)


def pipeline_bundle_name(n_pipe: int, schedule: str,
                         virtual_stages: int) -> str:
    """The pipelined GPT bundle/checkpoint namespace, as the JAX package's
    builders name it (``train.py --mode=generate`` restores from it)."""
    if schedule == "interleaved":
        return f"gpt_mini_pp{n_pipe}x{virtual_stages}"
    return f"gpt_mini_pp{n_pipe}"
