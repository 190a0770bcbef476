"""Model bundles: a model with its train state, loss, data and eval.

Counterpart of ``distributed_tensorflow_tpu/models/registry.py``, so far
for the reference MNIST MLP (:func:`build_mnist_mlp`), the GPT-mini
decoder (:func:`build_gpt_mini`), :func:`build` (the trainer's
``--model`` lookup for those two) and the pipelined GPT's checkpoint
namespace (:func:`pipeline_bundle_name`).  The other JAX models
(``lenet5``, ``resnet20``, ``vit_tiny``, ``bert_tiny``, ``bert_moe``) raise
``NotImplementedError`` (ROADMAP.md, section 1, item 7).
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
    state = TrainState.create(model, tx, rng=rng,
                              params_to_tree=gpt_lib.params_to_jax,
                              params_from_tree=gpt_lib.params_from_jax)

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


def build_mnist_mlp(hidden_units: int, learning_rate: float, seed: int = 0,
                    tx: OptimizerSpec | None = None,
                    label_smoothing: float = 0.0, *,
                    device=None) -> ModelBundle:
    """The reference model (:class:`.mlp.MnistMLP`) with plain SGD at
    ``learning_rate`` (reference ``distributed.py:89``) unless ``tx`` is
    given, the MNIST splits (:func:`..data.datasets.read_data_sets`: the
    IDX files under ``data_dir``, else the synthetic stand-in) and the
    full-split accuracy.  ``device`` defaults to ``cuda``."""
    from . import mlp
    from ..data.datasets import read_data_sets
    from ..training.loop import make_eval_fn

    device = resolve_device(device)
    model = mlp.MnistMLP(hidden_units, seed=seed, device=device)
    state = TrainState.create(model, tx or make_optimizer("sgd",
                                                          learning_rate),
                              params_to_tree=mlp.params_to_jax,
                              params_from_tree=mlp.params_from_jax)

    def loss_fn(model, batch):
        images, labels = batch
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        logits = model(images)
        return mlp.cross_entropy_loss(logits, labels,
                                      label_smoothing=label_smoothing), {
            "accuracy": mlp.accuracy(logits, labels)}

    return ModelBundle(state, loss_fn, read_data_sets,
                       lambda: make_eval_fn(lambda m, x: m(x)), "mnist_mlp")


def _seed(FLAGS) -> int:
    return getattr(FLAGS, "seed", 0)


#: ``--model`` name -> ``(FLAGS, tx, device) -> ModelBundle``; the flag
#: wiring of the JAX ``BUILDERS`` table for the ported models.
BUILDERS = {
    "mnist_mlp": lambda FLAGS, tx, device: build_mnist_mlp(
        FLAGS.hidden_units, FLAGS.learning_rate, seed=_seed(FLAGS), tx=tx,
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        device=device),
    "gpt_mini": lambda FLAGS, tx, device: build_gpt_mini(
        FLAGS.learning_rate, seed=_seed(FLAGS),
        seq_len=getattr(FLAGS, "bert_seq_len", 128),
        attention_backend=getattr(FLAGS, "attention_backend", "xla"),
        dtype=getattr(FLAGS, "bert_dtype", "bfloat16"),
        remat=getattr(FLAGS, "remat", False), tx=tx,
        dropout_rate=getattr(FLAGS, "bert_dropout", 0.0),
        fused_ln=getattr(FLAGS, "fused_layer_norm", False),
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        pos_encoding=getattr(FLAGS, "gpt_positions", "learned"),
        kv_heads=getattr(FLAGS, "gpt_kv_heads", 0),
        attention_window=getattr(FLAGS, "attention_window", 0),
        activation=getattr(FLAGS, "gpt_activation", "gelu"),
        norm=getattr(FLAGS, "gpt_norm", "layernorm"),
        matmul_int8=getattr(FLAGS, "gpt_matmul_int8", False),
        attn_int8=getattr(FLAGS, "gpt_attn_int8", False),
        tokenizer=getattr(FLAGS, "gpt_tokenizer", "byte"),
        stream_threshold_mb=getattr(FLAGS, "gpt_stream_corpus_mb", 256),
        device=device),
}

#: The JAX package's other ``--model`` names.
NOT_PORTED = ("lenet5", "resnet20", "vit_tiny", "bert_tiny", "bert_moe")


def build(name: str, FLAGS, device=None) -> ModelBundle:
    """The bundle for ``--model=name`` from the flag set; an explicit
    ``--optimizer`` takes full control of the optimizer (including the
    schedule), as in the JAX package."""
    from ..training.optimizers import from_flags
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"--model={name} is not ported yet; see ROADMAP.md, section 1, "
            "item 7")
    if name not in BUILDERS:
        raise ValueError(f"Unknown model {name!r}; available: "
                         f"{sorted([*BUILDERS, *NOT_PORTED])}")
    return BUILDERS[name](FLAGS, from_flags(FLAGS), device)
