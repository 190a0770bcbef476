"""Model bundles: a model with its train state, loss, data and eval.

Counterpart of ``distributed_tensorflow_tpu/models/registry.py``: the
``BASELINE.json`` config ladder, the reference MNIST MLP
(:func:`build_mnist_mlp`, configs #1/#2), LeNet-5 (:func:`build_lenet5`,
#3), ResNet-20 with its BatchNorm state (:func:`build_resnet20`, #4) and
BERT-tiny MLM (:func:`build_bert_tiny`, #5), with ViT-tiny
(:func:`build_vit_tiny`), the GPT-mini decoder (:func:`build_gpt_mini`),
the pipelined GPT-mini (:func:`build_gpt_pipeline`,
``--pipeline_parallel``), BERT-tiny with a mixture-of-experts FFN
(:func:`build_bert_moe`, its experts over the ``expert`` axis) and
:func:`build` (the trainer's ``--model`` lookup).  GPT-mini trains on a
byte or BPE corpus (``--gpt_tokenizer=bpe``: the model's vocabulary is
``--gpt_bpe_vocab``, the run's ``tokenizer.json`` goes beside its
checkpoints).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..training.optimizers import OptimizerSpec, make_optimizer
from ..training.state import TrainState, mark_stacked_leaves
from ..utils.device import resolve_device


@dataclasses.dataclass
class ModelBundle:
    state: TrainState
    loss_fn: Callable                   # (model, batch) -> (loss, aux)
    load_datasets: Callable             # (data_dir) -> Datasets-like splits
    make_eval_fn: Callable              # () -> eval_fn(state, split) -> float
    name: str
    # ``(model, batch, all_reduce) -> (loss, aux)`` for models with
    # non-trainable state (ResNet-20's BatchNorm, its statistics over the
    # workers of ``all_reduce``); ``loss_fn`` is then None and the trainer
    # takes the stateful sync steps.
    stateful_loss_fn: Callable | None = None
    # True when loss_fn takes (model, batch, rng): dropout-style stochastic
    # training; the state then carries the generator.
    needs_rng: bool = False
    # Tensor-parallel placement rules over the mesh's ``model`` axis
    # (parallel/sharding.py); None: the model trains replicated.
    sharding_rules: object = None
    # ``(mesh, state) -> state``: a model that places its own state (the
    # pipeline's stages over the ``pipe`` axis); None: the layout's
    # ``ParallelConfig.place_state``.
    place_state: Callable | None = None
    # ``(mesh, all_reduce=None, log_grad_norm=False) -> step``: a model
    # whose step cannot be built from ``loss_fn`` alone (the 1F1B and
    # interleaved pipelines' hand-rolled backward).
    train_step_builder: Callable | None = None



def input_device(model) -> torch.device:
    """Where ``model``'s inputs go: its own device (a data row's, which
    ``parallel/sharding.py`` places on the row's first position)."""
    device = getattr(model, "device", None)
    if device is not None:
        return torch.device(device)
    return next(model.parameters()).device

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
                   bpe_vocab: int = 512,
                   stream_threshold_mb: int = 256,
                   tokenizer_path: str | None = None, *,
                   device=None, mesh=None) -> ModelBundle:
    """GPT-mini decoder-only causal LM with fp32 master weights, its
    optimizer (Adam by default) and the LM data streams.  ``matmul_int8``
    / ``attn_int8`` train the MLP / the attention projections through the
    int8 matmuls of ``ops/quant_train.py``.  ``attention_backend="ring"``
    (or ``"ulysses"``) trains with sequence-parallel attention over
    ``mesh``'s ``seq`` axis (a ``parallel.mesh.Mesh``; or the one of
    ``ops.attention.attention_mesh`` around the first step).  The bundle's
    ``sharding_rules`` are :func:`.gpt.gpt_sharding_rules`, which
    ``ParallelConfig.place_state`` applies over a ``model`` axis.
    ``tokenizer="bpe"`` sizes the vocabulary to ``bpe_vocab`` and trains
    the corpus's BPE table, saved at ``tokenizer_path``.  ``device``
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
        # The embedding and head cover the tokenizer's ids (the table is
        # trained up to bpe_vocab ids, fewer on a small corpus).
        _validate_bpe_vocab(bpe_vocab)
        cfg = dataclasses.replace(cfg, vocab_size=bpe_vocab)
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
        tokens = torch.as_tensor(batch["tokens"],
                                 device=input_device(model)).long()
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
                                tokenizer=tokenizer, bpe_vocab=bpe_vocab,
                                tokenizer_path=tokenizer_path,
                                stream_threshold_bytes=(
                                    stream_threshold_mb << 20))

    return ModelBundle(state, loss_fn, load_datasets,
                       lambda: make_lm_eval_fn(lambda m, t: m(t)),
                       "gpt_mini", needs_rng=needs_rng,
                       sharding_rules=gpt_lib.gpt_sharding_rules())


def build_gpt_pipeline(learning_rate: float, mesh, seed: int = 0,
                       seq_len: int = 128, n_micro: int = 4,
                       attention_backend: str = "xla",
                       dtype: str = "bfloat16", remat: bool = False,
                       tx: OptimizerSpec | None = None,
                       fused_ln: bool = False,
                       label_smoothing: float = 0.0,
                       pos_encoding: str = "learned",
                       schedule: str = "gpipe",
                       virtual_stages: int = 2,
                       kv_heads: int = 0,
                       attention_window: int = 0,
                       activation: str = "gelu",
                       norm: str = "layernorm",
                       tokenizer: str = "byte",
                       bpe_vocab: int = 512,
                       stream_threshold_mb: int = 256,
                       tokenizer_path: str | None = None, *,
                       width: dict | None = None) -> ModelBundle:
    """GPT-mini with its decoder blocks run as a pipeline schedule over
    ``mesh``'s ``pipe`` axis (``--pipeline_parallel``): chunk ``c`` of
    the blocks on pipe device ``c % n_pipe``
    (:class:`.gpt.PipelinedGptLM`, the weights of ``build_gpt_mini``'s
    model from the same seed).  ``schedule`` picks GPipe (autograd
    through the ticks; ``remat`` recomputes each stage), ``1f1b``
    (hand-rolled backward, the stash bounded by the pipe depth) or
    ``interleaved`` (1F1B over ``virtual_stages`` round-robin chunks a
    position).  ``width``: GptConfig fields over ``mini()``'s (a
    caller's full-width model).  The checkpoint namespace and tree are
    the JAX package's (:func:`pipeline_bundle_name`, ``{"embed",
    "stages", "head"}``).

    With ``pipe`` across processes (``mesh`` a worker's part of
    ``parallel/mesh.global_mesh``) this rank builds and keeps only its
    chunks (the embedding on pipe rank 0, the head on the last) and every
    schedule trains through the slot runner (GPipe as
    ``parallel/pipeline.build_gpipe_train_step``); with local data rows
    (``data > 1`` in the mesh) each row is a pipelined copy on its row's
    pipe positions."""
    from . import gpt as gpt_lib
    from ..data.lm import make_lm_datasets, make_lm_eval_fn
    from ..parallel.mesh import PIPE_AXIS

    if schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(
            f"--pipeline_schedule must be gpipe, 1f1b, or interleaved, "
            f"got {schedule!r}")
    n_pipe = mesh.shape[PIPE_AXIS]
    interleaved = schedule == "interleaved"
    v = virtual_stages if interleaved else 1
    if interleaved and v < 2:
        raise ValueError(
            f"--pipeline_schedule=interleaved needs "
            f"--pipeline_virtual_stages >= 2, got {v}")
    cfg = dataclasses.replace(
        gpt_lib.mini(), attention_backend=attention_backend, dtype=dtype,
        fused_ln=fused_ln, pos_encoding=pos_encoding, kv_heads=kv_heads,
        attention_window=attention_window, activation=activation,
        norm=norm, **(width or {}))
    if tokenizer == "bpe":
        _validate_bpe_vocab(bpe_vocab)
        cfg = dataclasses.replace(cfg, vocab_size=bpe_vocab)
    ranked = mesh.crosses(PIPE_AXIS)
    if ranked and tx is not None and tx.name in ("lamb", "adafactor"):
        from ..parallel.mesh import cross_process_error
        raise cross_process_error(
            f"--optimizer={tx.name}'s whole-leaf statistics of a "
            "stage stack split over the pipe axis")
    n_pipe = mesh.global_shape[PIPE_AXIS]
    devices = mesh.pipe_devices()
    plain = gpt_lib.GptLM(cfg, device=devices[0], seed=seed,
                          param_dtype=torch.float32)
    model = gpt_lib.PipelinedGptLM.from_gpt(
        plain, devices, v, pipe_mesh=mesh if ranked else None)
    del plain
    mark_stacked_leaves(model, model.params_to_tree)
    if ranked:
        # The global norm sums its squares over the pipe group too.
        for p in model.parameters():
            p.pipe_mesh = mesh
    if tx is None:
        tx = _default_transformer_tx(learning_rate, "gpt_mini(pipelined)")
    state = TrainState.create(model, tx,
                              params_to_tree=model.params_to_tree,
                              params_from_tree=model.params_from_tree)
    if interleaved or ranked:
        apply_fn = gpt_lib.make_interleaved_gpt_apply(cfg)
    else:
        apply_fn = gpt_lib.make_pipelined_gpt_apply(cfg, mesh,
                                                    n_micro=n_micro,
                                                    remat=remat)

    def loss_fn(model, batch):
        tokens = torch.as_tensor(batch["tokens"], device=model.device).long()
        logits = apply_fn(model, tokens)
        loss, acc = gpt_lib.lm_loss(logits, tokens.to(logits.device),
                                    label_smoothing=label_smoothing)
        return loss, {"accuracy": acc}

    def place_row(row_mesh, st):
        """Each chunk this process holds on its pipe device (the
        embedding on the first, the head on the last); the optimizer's
        slots follow in place."""
        devs = row_mesh.pipe_devices()
        m = st.model
        if ranked:
            devs = [devs[0]] * n_pipe
        for c, stage in enumerate(m.stages):
            _move_module(st, stage, devs[c % len(devs)])
        if m.embed is not None:
            _move_module(st, m.embed, devs[0])
        if m.head is not None:
            _move_module(st, m.head, devs[-1])
        m.device = devs[0] if m.embed is not None else next(
            m.parameters()).device
        return st

    def place_state(mesh_, state_):
        """:func:`place_row` for every local data row (a pipelined copy a
        row, ``parallel/sharding._place_rows``)."""
        from ..parallel.sharding import _place_rows
        return _place_rows(mesh_, state_, place_row)

    def load_datasets(data_dir):
        return make_lm_datasets(cfg, seq_len=seq_len, data_dir=data_dir,
                                tokenizer=tokenizer, bpe_vocab=bpe_vocab,
                                tokenizer_path=tokenizer_path,
                                stream_threshold_bytes=(
                                    stream_threshold_mb << 20))

    step_builder = None
    if schedule in ("1f1b", "interleaved") or ranked:
        # Training runs the hand-rolled schedules; the loss, eval and
        # generate keep a schedule-agnostic apply.
        step_builder = gpt_lib.make_1f1b_gpt_train_step_builder(
            cfg, n_micro=n_micro, label_smoothing=label_smoothing,
            n_virtual=v, gpipe=schedule == "gpipe")
    return ModelBundle(state, loss_fn, load_datasets,
                       lambda: make_lm_eval_fn(apply_fn),
                       pipeline_bundle_name(n_pipe, schedule, v),
                       place_state=place_state,
                       train_step_builder=step_builder)


def _validate_bpe_vocab(bpe_vocab: int) -> None:
    """257 = 256 byte ids + 1 merge at least: the BPE stream falls back
    to raw bytes (ids 0..255), so a smaller table would put ids past the
    embedding (the CLI's ``--gpt_bpe_vocab`` check)."""
    if bpe_vocab < 257:
        raise ValueError(
            f"bpe_vocab must be >= 257 (256 byte ids + at least one merge), "
            f"got {bpe_vocab}")


def _move_module(state, module, device) -> None:
    """``module``'s parameters (and their optimizer slots) onto
    ``device``, in place."""
    with torch.no_grad():
        for p in module.parameters():
            if p.device != device:
                p.data = p.data.to(device)
                for key, v in state.optimizer.base.state.get(p, {}).items():
                    if torch.is_tensor(v) and v.dim():
                        state.optimizer.base.state[p][key] = v.to(device)


def pipeline_bundle_name(n_pipe: int, schedule: str,
                         virtual_stages: int) -> str:
    """The pipelined GPT bundle/checkpoint namespace, as the JAX package's
    builders name it (``train.py --mode=generate`` restores from it)."""
    if schedule == "interleaved":
        return f"gpt_mini_pp{n_pipe}x{virtual_stages}"
    return f"gpt_mini_pp{n_pipe}"


def _image_classifier_bundle(model, tx: OptimizerSpec, name: str,
                             load_datasets, *, params_to_tree,
                             params_from_tree, label_smoothing: float = 0.0,
                             sharding_rules=None) -> ModelBundle:
    """Shared recipe for the stateless image classifiers (MLP, LeNet,
    ViT): ``(images, one-hot labels)`` batches, mean softmax
    cross-entropy, the full-split accuracy."""
    from .mlp import accuracy, cross_entropy_loss
    from ..training.loop import make_eval_fn

    device = next(model.parameters()).device
    state = TrainState.create(model, tx, params_to_tree=params_to_tree,
                              params_from_tree=params_from_tree)

    def loss_fn(model, batch):
        images, labels = batch
        images = torch.as_tensor(images, device=input_device(model))
        labels = torch.as_tensor(labels, device=input_device(model))
        logits = model(images)
        return cross_entropy_loss(logits, labels,
                                  label_smoothing=label_smoothing), {
            "accuracy": accuracy(logits, labels)}

    return ModelBundle(state, loss_fn, load_datasets,
                       lambda: make_eval_fn(lambda m, x: m(x)), name,
                       sharding_rules=sharding_rules)


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
    model = mlp.MnistMLP(hidden_units, seed=seed,
                         device=resolve_device(device))
    return _image_classifier_bundle(
        model, tx or make_optimizer("sgd", learning_rate), "mnist_mlp",
        read_data_sets, params_to_tree=mlp.params_to_jax,
        params_from_tree=mlp.params_from_jax,
        label_smoothing=label_smoothing)


def build_lenet5(learning_rate: float, seed: int = 0,
                 tx: OptimizerSpec | None = None,
                 label_smoothing: float = 0.0, *,
                 device=None) -> ModelBundle:
    """LeNet-5 on MNIST (``BASELINE.json`` config #3), SGD unless ``tx``
    is given."""
    from . import lenet
    from ..data.datasets import read_data_sets
    model = lenet.LeNet5(seed=seed, device=resolve_device(device))
    return _image_classifier_bundle(
        model, tx or make_optimizer("sgd", learning_rate), "lenet5",
        read_data_sets, params_to_tree=lenet.params_to_jax,
        params_from_tree=lenet.params_from_jax,
        label_smoothing=label_smoothing)


def build_vit_tiny(learning_rate: float, seed: int = 0,
                   tx: OptimizerSpec | None = None, augment: bool = False,
                   label_smoothing: float = 0.0,
                   attention_backend: str = "xla", dtype: str = "bfloat16",
                   fused_ln: bool = False, *, device=None,
                   mesh=None) -> ModelBundle:
    """ViT-tiny on CIFAR-10 (``models/vit.py``), Adam by default like the
    other transformers; with ``attention_backend="pallas"`` and
    ``fused_ln`` on the K1/K2/K3 kernels."""
    import functools

    from . import vit
    from ..data.datasets import read_cifar10
    cfg = dataclasses.replace(vit.tiny(), attention_backend=attention_backend,
                              dtype=dtype, fused_ln=fused_ln)
    model = vit.VitClassifier(cfg, seed=seed, device=resolve_device(device),
                              mesh=mesh)
    if tx is None:
        tx = _default_transformer_tx(learning_rate, "vit_tiny")
    return _image_classifier_bundle(
        model, tx, "vit_tiny", functools.partial(read_cifar10,
                                                 augment=augment),
        params_to_tree=vit.params_to_jax, params_from_tree=vit.params_from_jax,
        label_smoothing=label_smoothing,
        sharding_rules=vit.vit_sharding_rules())


def build_resnet20(learning_rate: float, seed: int = 0,
                   tx: OptimizerSpec | None = None, augment: bool = False,
                   label_smoothing: float = 0.0, *,
                   device=None) -> ModelBundle:
    """ResNet-20 on CIFAR-10 (``BASELINE.json`` config #4), SGD unless
    ``tx`` is given.  Its state carries the BatchNorm running statistics
    (``model_state``); the bundle has a ``stateful_loss_fn`` (statistics
    over the workers of the step's all-reduce) and no ``loss_fn``, and its
    eval normalises with the running statistics."""
    import functools

    from . import resnet
    from .mlp import accuracy, cross_entropy_loss
    from ..data.datasets import read_cifar10
    from ..training.loop import make_stateful_eval_fn

    device = resolve_device(device)
    model = resnet.ResNet20(seed=seed, device=device)
    state = TrainState.create(
        model, tx or make_optimizer("sgd", learning_rate),
        model_state=resnet.batch_stats(model),
        params_to_tree=resnet.params_to_jax,
        params_from_tree=resnet.params_from_jax)

    def stateful_loss_fn(model, batch, all_reduce=None):
        images, labels = batch
        images = torch.as_tensor(images, device=input_device(model))
        labels = torch.as_tensor(labels, device=input_device(model))
        logits = model(images, all_reduce)
        return cross_entropy_loss(logits, labels,
                                  label_smoothing=label_smoothing), {
            "accuracy": accuracy(logits, labels)}

    return ModelBundle(
        state, None, functools.partial(read_cifar10, augment=augment),
        lambda: make_stateful_eval_fn(lambda m, ms, x: m(x)), "resnet20",
        stateful_loss_fn=stateful_loss_fn)


def _build_bert(learning_rate: float, seed: int, seq_len: int,
                attention_backend: str, num_experts: int, name: str,
                dtype: str = "bfloat16", remat: bool = False,
                tx: OptimizerSpec | None = None, dropout_rate: float = 0.0,
                fused_ln: bool = False, label_smoothing: float = 0.0, *,
                device=None, mesh=None) -> ModelBundle:
    """The BERT bundle: dict batches of the synthetic MLM streams
    (``data/mlm.py``), the masked-position loss and accuracy, Adam by
    default.  ``num_experts > 0`` swaps each layer's FFN for the top-k
    MoE (``ops/moe.py``): the objective adds the weighted load-balance
    loss (``moe_aux`` in the metrics) and the rules put the stacked
    experts on the ``expert`` axis.  The dropout generator comes from
    ``seed + 1``."""
    from . import bert
    from ..data.mlm import make_mlm_datasets, make_mlm_eval_fn

    cfg = dataclasses.replace(bert.tiny(), attention_backend=attention_backend,
                              num_experts=num_experts, dtype=dtype,
                              remat=remat, fused_ln=fused_ln,
                              dropout_rate=dropout_rate)
    device = resolve_device(device)
    model = bert.BertForMLM(cfg, seed=seed, device=device, mesh=mesh)
    if tx is None:
        tx = _default_transformer_tx(learning_rate, name)
    needs_rng = dropout_rate > 0.0
    rng = None
    if needs_rng:
        rng = torch.Generator()
        rng.manual_seed(seed + 1)
    state = TrainState.create(model, tx, rng=rng,
                              params_to_tree=bert.params_to_jax,
                              params_from_tree=bert.params_from_jax)

    if num_experts > 0:
        _loss = bert.make_moe_mlm_loss_fn(label_smoothing=label_smoothing)
    else:
        def _loss(model, batch, rng=None):
            t = {k: torch.as_tensor(v, device=input_device(model))
                 for k, v in batch.items()}
            logits = model(t["input_ids"].long(), t["attention_mask"], rng)
            loss, acc = bert.mlm_loss(logits, t["labels"],
                                      t["label_weights"],
                                      label_smoothing=label_smoothing)
            return loss, {"accuracy": acc}

    if needs_rng:
        loss_fn = _loss
    else:
        def loss_fn(model, batch):
            return _loss(model, batch)

    def load_datasets(data_dir):
        # No tokenizer or corpus ships with the repo: the MLM splits are
        # synthetic streams whatever data_dir holds.
        return make_mlm_datasets(cfg, seq_len=seq_len)

    return ModelBundle(state, loss_fn, load_datasets,
                       lambda: make_mlm_eval_fn(
                           lambda m, ids, mask: m(ids.long(), mask)),
                       name, needs_rng=needs_rng,
                       sharding_rules=(bert.bert_moe_sharding_rules()
                                       if num_experts > 0
                                       else bert.bert_sharding_rules()))


def build_bert_tiny(learning_rate: float, seed: int = 0, seq_len: int = 128,
                    attention_backend: str = "xla", dtype: str = "bfloat16",
                    remat: bool = False, tx: OptimizerSpec | None = None,
                    dropout_rate: float = 0.0, fused_ln: bool = False,
                    label_smoothing: float = 0.0, *, device=None,
                    mesh=None) -> ModelBundle:
    """BERT-tiny MLM on synthetic sequences (dict batches instead of
    ``(x, y)``)."""
    return _build_bert(learning_rate, seed, seq_len, attention_backend,
                       num_experts=0, name="bert_tiny", dtype=dtype,
                       remat=remat, tx=tx, dropout_rate=dropout_rate,
                       fused_ln=fused_ln, label_smoothing=label_smoothing,
                       device=device, mesh=mesh)


def build_bert_moe(learning_rate: float, seed: int = 0, seq_len: int = 128,
                   attention_backend: str = "xla", num_experts: int = 4,
                   dtype: str = "bfloat16", remat: bool = False,
                   tx: OptimizerSpec | None = None,
                   dropout_rate: float = 0.0, fused_ln: bool = False,
                   label_smoothing: float = 0.0, *, device=None,
                   mesh=None) -> ModelBundle:
    """BERT-tiny with a mixture-of-experts FFN (top-2, capacity factor
    2), the expert-parallel workload."""
    return _build_bert(learning_rate, seed, seq_len, attention_backend,
                       num_experts=num_experts, name="bert_moe", dtype=dtype,
                       remat=remat, tx=tx, dropout_rate=dropout_rate,
                       fused_ln=fused_ln, label_smoothing=label_smoothing,
                       device=device, mesh=mesh)


def _seed(FLAGS) -> int:
    return getattr(FLAGS, "seed", 0)


def _tokenizer_path(FLAGS, bundle_name: str) -> str | None:
    """The run's corpus tokenizer beside its checkpoints (the
    supervisor's namespace), so eval and generate decode its ids."""
    import os
    logdir = getattr(FLAGS, "logdir", "")
    return os.path.join(logdir, bundle_name, "tokenizer.json") if logdir \
        else None


#: ``--model`` name -> ``(FLAGS, tx, device, mesh) -> ModelBundle``; the
#: flag wiring of the JAX ``BUILDERS`` table for the ported models.
BUILDERS = {
    "mnist_mlp": lambda FLAGS, tx, device, mesh: build_mnist_mlp(
        FLAGS.hidden_units, FLAGS.learning_rate, seed=_seed(FLAGS), tx=tx,
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        device=device),
    "lenet5": lambda FLAGS, tx, device, mesh: build_lenet5(
        FLAGS.learning_rate, seed=_seed(FLAGS), tx=tx,
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        device=device),
    "resnet20": lambda FLAGS, tx, device, mesh: build_resnet20(
        FLAGS.learning_rate, seed=_seed(FLAGS), tx=tx,
        augment=getattr(FLAGS, "data_augmentation", False),
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        device=device),
    "vit_tiny": lambda FLAGS, tx, device, mesh: build_vit_tiny(
        FLAGS.learning_rate, seed=_seed(FLAGS), tx=tx,
        augment=getattr(FLAGS, "data_augmentation", False),
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        attention_backend=getattr(FLAGS, "attention_backend", "xla"),
        dtype=getattr(FLAGS, "bert_dtype", "bfloat16"),
        fused_ln=getattr(FLAGS, "fused_layer_norm", False),
        device=device, mesh=mesh),
    "bert_tiny": lambda FLAGS, tx, device, mesh: build_bert_tiny(
        FLAGS.learning_rate, seed=_seed(FLAGS),
        seq_len=getattr(FLAGS, "bert_seq_len", 128),
        attention_backend=getattr(FLAGS, "attention_backend", "xla"),
        dtype=getattr(FLAGS, "bert_dtype", "bfloat16"),
        remat=getattr(FLAGS, "remat", False), tx=tx,
        dropout_rate=getattr(FLAGS, "bert_dropout", 0.0),
        fused_ln=getattr(FLAGS, "fused_layer_norm", False),
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        device=device, mesh=mesh),
    "bert_moe": lambda FLAGS, tx, device, mesh: build_bert_moe(
        FLAGS.learning_rate, seed=_seed(FLAGS),
        seq_len=getattr(FLAGS, "bert_seq_len", 128),
        attention_backend=getattr(FLAGS, "attention_backend", "xla"),
        num_experts=getattr(FLAGS, "num_experts", 4),
        dtype=getattr(FLAGS, "bert_dtype", "bfloat16"),
        remat=getattr(FLAGS, "remat", False), tx=tx,
        dropout_rate=getattr(FLAGS, "bert_dropout", 0.0),
        fused_ln=getattr(FLAGS, "fused_layer_norm", False),
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        device=device, mesh=mesh),
    "gpt_mini": lambda FLAGS, tx, device, mesh: (build_gpt_pipeline(
        FLAGS.learning_rate, mesh, seed=_seed(FLAGS),
        seq_len=getattr(FLAGS, "bert_seq_len", 128),
        n_micro=getattr(FLAGS, "pipeline_microbatches", 4),
        attention_backend=getattr(FLAGS, "attention_backend", "xla"),
        dtype=getattr(FLAGS, "bert_dtype", "bfloat16"),
        remat=getattr(FLAGS, "remat", False), tx=tx,
        fused_ln=getattr(FLAGS, "fused_layer_norm", False),
        label_smoothing=getattr(FLAGS, "label_smoothing", 0.0),
        pos_encoding=getattr(FLAGS, "gpt_positions", "learned"),
        schedule=getattr(FLAGS, "pipeline_schedule", "gpipe"),
        virtual_stages=getattr(FLAGS, "pipeline_virtual_stages", 2),
        kv_heads=getattr(FLAGS, "gpt_kv_heads", 0),
        attention_window=getattr(FLAGS, "attention_window", 0),
        activation=getattr(FLAGS, "gpt_activation", "gelu"),
        norm=getattr(FLAGS, "gpt_norm", "layernorm"),
        tokenizer=getattr(FLAGS, "gpt_tokenizer", "byte"),
        bpe_vocab=getattr(FLAGS, "gpt_bpe_vocab", 512),
        stream_threshold_mb=getattr(FLAGS, "gpt_stream_corpus_mb", 256),
        tokenizer_path=_tokenizer_path(FLAGS, pipeline_bundle_name(
            FLAGS.pipeline_parallel,
            getattr(FLAGS, "pipeline_schedule", "gpipe"),
            getattr(FLAGS, "pipeline_virtual_stages", 2))))
        if getattr(FLAGS, "pipeline_parallel", 1) > 1 else build_gpt_mini(
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
        bpe_vocab=getattr(FLAGS, "gpt_bpe_vocab", 512),
        stream_threshold_mb=getattr(FLAGS, "gpt_stream_corpus_mb", 256),
        tokenizer_path=_tokenizer_path(FLAGS, "gpt_mini"),
        device=device, mesh=mesh)),
}


def build(name: str, FLAGS, device=None, mesh=None) -> ModelBundle:
    """The bundle for ``--model=name`` from the flag set; an explicit
    ``--optimizer`` takes full control of the optimizer (including the
    schedule), as in the JAX package.  ``mesh`` (the trainer's
    ``ParallelConfig.build_mesh``) goes to the model's blocks: the
    sequence-parallel backends' and the tensor-parallel heads' mesh."""
    from ..training.optimizers import from_flags
    if name not in BUILDERS:
        raise ValueError(f"Unknown model {name!r}; available: "
                         f"{sorted(BUILDERS)}")
    return BUILDERS[name](FLAGS, from_flags(FLAGS), device, mesh)
