"""CLI training driver, the counterpart of ``distributed_tensorflow_tpu/train.py``.

The reference's launch shape (``README.md:7-15``), one process per worker
and one parameter-server process::

    python -m distributed_tensorflow_tpu_torch.train --job_name=ps \
        --task_index=0 --ps_hosts=h0:2222 --worker_hosts=h1:2223,h2:2224
    python -m distributed_tensorflow_tpu_torch.train --job_name=worker \
        --task_index=0 --ps_hosts=h0:2222 --worker_hosts=h1:2223,h2:2224 \
        --sync_replicas=true

A ``--job_name=ps`` process hosts the coordination service and blocks
(``server.join()`` parity, reference ``distributed.py:55-56``).  Sync
workers form a ``torch.distributed`` process group (rank = task index; the
backend rule is :mod:`.cluster.server`'s and each worker prints it) and
average their gradients with one all-reduce a step
(:mod:`.parallel.sync`).  Async workers (``--sync_replicas=false``, the
reference's default mode) join no group: each trains its own replica
(:mod:`.parallel.async_replicas`) and every ``--async_sync_period`` local
steps averages its parameters with its peers' through the coordination
service (:mod:`.cluster.param_sync`: full-state, compressed, hierarchical,
or overlapped with training).  The chief initializes or restores the state and
signals the others through the coordination service
(:mod:`.training.supervisor`), and :mod:`.training.loop` prints the
reference's lines (``Initailizing session...``, ``traing step``,
``Training elapsed time:``, ``test accuracy``, typos kept).

Modes: ``train`` (default), ``eval`` (restore the newest checkpoint, print
validation and test accuracy) and ``generate`` (gpt_mini decode from a
checkpoint: the newest one under ``<logdir>/<namespace>/checkpoints``, on
the hand-written kernels, printing the JAX CLI's lines).  ``--model`` is
the JAX CLI's config ladder: ``mnist_mlp`` (the reference model),
``lenet5``, ``resnet20`` (BatchNorm: non-trainable state, so sync mode
whatever ``--sync_replicas`` says, its statistics over every worker's
rows; eval with the running statistics), ``vit_tiny``, ``bert_tiny``,
``bert_moe`` (BERT-tiny with a top-2 mixture-of-experts FFN, its
load-balance loss in the objective) and ``gpt_mini`` (on the synthetic
stream, or a ``*.txt`` corpus under ``--data_dir``: bytes, or BPE with
``--gpt_tokenizer=bpe --gpt_bpe_vocab``, streamed a chunk at a time past
``--gpt_stream_corpus_mb`` with its cursor saved beside the checkpoints
and restored on resume; ``--mode=generate --gen_prompt_text
--gen_stop_text`` go through the run's ``tokenizer.json``).  Every
``--optimizer`` of the JAX CLI runs, with optax's constants.  With
``--attention_backend=pallas --fused_layer_norm`` the transformers'
trainers run the flash-attention (K1, K2a/K2b) and LayerNorm (K3)
kernels.

Parallelism: the data axis is ``worker processes x local positions``.
Each worker's mesh is ``data x seq x pipe x expert x model``
(``--sequence_parallel``, ``--pipeline_parallel``, ``--expert_parallel``,
``--tensor_parallel``; ``data`` the rest of the devices the worker
drives: its share of the visible cards, or ``$DTF_TORCH_CPU_DEVICES``
with ``--device=cpu``), its positions laid round robin over the
worker's cards (all on one card where there is one; the CLI prints the
layout), one process driving them all, one copy of the model a local
data row; ``--dcn_data_parallel`` orders the data axis slice-major and
``--sharded_feed`` has each worker load its share of the batch.  ``--tensor_parallel`` places gpt_mini by its Megatron rules,
``bert_tiny`` and ``vit_tiny`` theirs, ``--expert_parallel`` splits
``bert_moe``'s stacked experts (``--log_sharding`` prints each
parameter's spec); ``--fsdp`` shards the state over the whole data axis and
``--pipeline_parallel`` runs gpt_mini's blocks as GPipe, 1F1B or
interleaved stages;
``--attention_backend=ring|ulysses`` runs sequence-parallel attention
over the seq axis.  A model without rules (``mnist_mlp``, ``lenet5``,
``resnet20``) trains replicated.  Local data rows sit beside every axis
(a pipelined copy of the model a row beside ``--pipeline_parallel``), and
``--fsdp`` beside ``--tensor_parallel`` shards each model shard over the
workers and their rows (JAX's ``P("data", "model")``).

The sync workers of a process group share one global mesh over every
worker's positions (``parallel/mesh.global_mesh``): where the non-data
axes do not fit in a worker, the outer ones cross the workers, one rank
a card: ``--pipeline_parallel`` (each rank its own stages, activations
and cotangents over the pipe group) and ``--sequence_parallel`` with the
ring (each rank its own sequence block, the hops over the seq group);
the layout line names the axes across the workers.  So two one-card
workers with ``--pipeline_parallel=2`` are one two-stage pipeline.

Every flag of the JAX ``train.py`` is declared, so a JAX command line
parses; the port adds ``--device`` (default ``cuda``, which raises without
a card) in place of ``--platform``.  Not ported yet (each raises
``NotImplementedError`` naming ROADMAP.md's entry): ``--tensor_parallel``
or ``--expert_parallel`` across the workers and ulysses' all-to-all across
them (item 6, 8f), and ``--profile`` run profiles (item 8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import time

import torch

from .config import app, define_training_flags, flags, validate_role_flags

FLAGS = define_training_flags()
flags.DEFINE_string("mode", "train",
                    "train (default), eval or generate. eval: restore the "
                    "latest checkpoint from --logdir and report validation "
                    "+ test accuracy, no training. generate: decode "
                    "--gen_tokens tokens from a seed prompt (gpt_mini only)")
flags.DEFINE_integer("gen_tokens", 32, "Tokens to generate in --mode=generate")
flags.DEFINE_string("gen_prompt", "",
                    "Comma-separated token ids to seed --mode=generate "
                    "(default: a stream-sampled prompt)")
flags.DEFINE_string("gen_prompt_text", "",
                    "Text prompt for --mode=generate, encoded with the "
                    "run's saved tokenizer (<logdir>/<namespace>/"
                    "tokenizer.json, written by corpus-trained runs); the "
                    "output is decoded to text too")
flags.DEFINE_float("gen_temperature", 0.0,
                   "Sampling temperature in --mode=generate (0 = greedy)")
flags.DEFINE_integer("gen_beams", 1,
                     "Beam width in --mode=generate (1 = greedy/sampled "
                     "decode; >1 runs beam search over the KV-cached path "
                     "— exclusive with --gen_temperature)")
flags.DEFINE_integer("gen_eos_id", -1,
                     "Stop token for --mode=generate (-1 = none): each "
                     "sequence stops at its own terminator, the decode "
                     "loop exits early when all have stopped, and beam "
                     "search freezes finished beams (GNMT length penalty "
                     "at selection)")
flags.DEFINE_float("gen_length_penalty", 1.0,
                   "Beam-search length penalty exponent (used with "
                   "--gen_eos_id; 1.0 = GNMT default, larger favors "
                   "longer continuations)")
flags.DEFINE_string("gen_stop_text", "",
                    "Stop STRING for --mode=generate text output: the "
                    "decoded text is cut at its first occurrence (needs "
                    "the run's tokenizer like --gen_prompt_text)")
flags.DEFINE_integer("gen_speculative", 0,
                     "Speculative greedy decoding in --mode=generate: "
                     "chunk size for prompt-lookup drafting + one-pass "
                     "verification (0 = off; >= 2 = chunk size; the plain "
                     "greedy tokens; exclusive with sampling/beams)")
flags.DEFINE_integer("gen_top_k", 0, "top-k filter in --mode=generate")
flags.DEFINE_float("gen_top_p", 0.0, "nucleus top-p filter in --mode=generate")
flags.DEFINE_string("gen_quantize", "",
                    "--mode=generate weight quantization: '' (off) | int8 "
                    "(per-channel weight-only, dequantized at each call)")
flags.DEFINE_string("gen_kv_dtype", "",
                    "--mode=generate KV-cache dtype: '' (compute dtype) | "
                    "bfloat16 | float8 (float8_e4m3fn, upcast on read)")
flags.DEFINE_boolean("gen_speculative_device", True,
                     "Run --gen_speculative's drafting, verification and "
                     "acceptance on the device, reading the host once a "
                     "round (default); false runs the host loop")
flags.DEFINE_string("model", "mnist_mlp",
                    "Model/workload: mnist_mlp | lenet5 | resnet20 | "
                    "vit_tiny | bert_tiny | bert_moe | gpt_mini; "
                    "--mode=generate needs gpt_mini")
flags.DEFINE_string("logdir", "/tmp/dtf_tpu_train",
                    "Checkpoint/recovery directory: checkpoints under "
                    "<logdir>/<model namespace>/checkpoints")
flags.DEFINE_integer("bert_seq_len", 128,
                     "Sequence length of gpt_mini's training windows (and "
                     "of --mode=generate's stream-sampled prompt, half of "
                     "it)")
flags.DEFINE_string("bert_dtype", "bfloat16",
                    "Activation dtype: bfloat16 | float32")
flags.DEFINE_integer("pipeline_parallel", 1,
                     "Size of the 'pipe' mesh axis (gpt_mini's decoder "
                     "blocks as pipeline stages over the worker's "
                     "positions; also a pipelined run's checkpoint "
                     "namespace)")
flags.DEFINE_integer("pipeline_virtual_stages", 2,
                     "Model chunks per pipe position with "
                     "--pipeline_schedule=interleaved (Megatron virtual "
                     "pipeline stages; needs --pipeline_microbatches "
                     "divisible by --pipeline_parallel)")
flags.DEFINE_integer("pipeline_microbatches", 4,
                     "Microbatches per pipeline step (the batch must "
                     "divide into them)")
flags.DEFINE_string("pipeline_schedule", "gpipe",
                    "Pipeline schedule: gpipe (autograd through the "
                    "ticks) | 1f1b (hand-rolled backward, activation "
                    "stash bounded by the pipe depth) | interleaved "
                    "(1F1B over --pipeline_virtual_stages chunks a "
                    "position)")
flags.DEFINE_string("gpt_positions", "learned",
                    "Position encoding: learned | rope")
flags.DEFINE_string("gpt_activation", "gelu",
                    "MLP activation: gelu | swiglu (the checkpoint's wins)")
flags.DEFINE_string("gpt_norm", "layernorm",
                    "Normalization: layernorm | rmsnorm (the checkpoint's "
                    "wins)")
flags.DEFINE_integer("attention_window", 0,
                     "Sliding-window attention (0 = full causal); not "
                     "inferable from a checkpoint, so re-pass the run's")
flags.DEFINE_integer("gpt_kv_heads", 0,
                     "Grouped-query K/V heads (0 = the checkpoint's, or "
                     "plain multi-head attention)")
flags.DEFINE_integer("seed", 0,
                     "Model-initialization seed (all workers must agree: "
                     "identical initial state everywhere); also the "
                     "default prompt's and sampling's in --mode=generate")
flags.DEFINE_string("device", "cuda",
                    "torch device: cuda (a worker drives its share of the "
                    "visible cards, card count // workers, at least one; "
                    "raises without a card), cuda:N, or cpu for a CPU run; "
                    "the port's --platform")


# The trainer's flags (the JAX train.py's, with shorter help).
flags.DEFINE_integer("save_interval_steps", 1000,
                     "Checkpoint every N global steps")
flags.DEFINE_integer("max_checkpoints_to_keep", 3,
                     "Keep the last K checkpoints plus, always, the newest "
                     "one that passes integrity verification; 0 keeps all")
flags.DEFINE_integer("log_every", 1, "Print metrics every N local steps")
flags.DEFINE_integer("validation_every", 10000,
                     "Evaluate the validation split every N local steps "
                     "(reference distributed.py:140); 0 disables")
flags.DEFINE_float("bert_dropout", 0.0,
                   "Dropout rate for gpt_mini (0 keeps training "
                   "deterministic)")
flags.DEFINE_boolean("remat", False,
                     "Recompute transformer layers in the backward pass")
flags.DEFINE_string("attention_backend", "xla",
                    "Attention backend for gpt_mini: xla (PyTorch) | pallas "
                    "(the hand-written flash-attention kernels) | ring "
                    "(K/V hops over --sequence_parallel shards) | ulysses "
                    "(head/sequence all-to-all, heads divisible by "
                    "--sequence_parallel)")
flags.DEFINE_boolean("gpt_matmul_int8", False,
                     "Train gpt_mini's MLP through the int8 matmul kernels")
flags.DEFINE_boolean("gpt_attn_int8", False,
                     "Also route gpt_mini's attention projections through "
                     "the int8 path")
flags.DEFINE_boolean("fused_layer_norm", False,
                     "Route transformer LayerNorms through the LayerNorm "
                     "kernel")
flags.DEFINE_string("gpt_tokenizer", "byte",
                    "Text tokenizer for the gpt_mini *.txt corpus: byte "
                    "(ids = raw bytes, vocab 256) | bpe (byte-level BPE "
                    "trained on the corpus train split by the C++ core in "
                    "csrc/tokenizer/bpe.cc; model vocab = --gpt_bpe_vocab)")
flags.DEFINE_integer("gpt_bpe_vocab", 512,
                     "Model vocab size with --gpt_tokenizer=bpe (includes "
                     "the 256 base bytes; the merge table is trained up to "
                     "this many tokens)")
flags.DEFINE_integer("gpt_stream_corpus_mb", 256,
                     "Corpus size (MB of *.txt under --data_dir) above "
                     "which the LM corpus streams in chunks instead of "
                     "loading into RAM: per-process disjoint chunk sets, "
                     "deterministic cursor resume (saved at checkpoints); "
                     "BPE then trains on a bounded train-region sample")
flags.DEFINE_float("label_smoothing", 0.0,
                   "Mix one-hot targets with the uniform distribution")
flags.DEFINE_boolean("log_grad_norm", False,
                     "Add the global gradient L2 norm to each step's "
                     "metrics (sync plain/scanned/accumulating steps)")
flags.DEFINE_string("optimizer", "",
                    "Override the model's optimizer: sgd | momentum | "
                    "nesterov | adam | adamw (lamb, adagrad, rmsprop and "
                    "adafactor are not ported yet); empty keeps the model's "
                    "own (SGD for mnist_mlp, Adam for gpt_mini)")
flags.DEFINE_float("momentum", 0.9, "Momentum for momentum/nesterov")
flags.DEFINE_float("weight_decay", 0.0,
                   "Weight decay with --optimizer: decoupled for adamw, "
                   "L2 for the others")
flags.DEFINE_string("lr_schedule", "constant",
                    "Learning-rate schedule with --optimizer: constant | "
                    "cosine | linear | rsqrt")
flags.DEFINE_integer("warmup_steps", 0, "Linear lr warmup steps")
flags.DEFINE_integer("decay_steps", 0,
                     "Schedule horizon; 0 means --train_steps")
flags.DEFINE_float("end_lr_factor", 0.0,
                   "Final lr as a fraction of the peak (cosine/linear)")
flags.DEFINE_float("grad_clip_norm", 0.0,
                   "Clip gradients to this global norm (needs --optimizer)")
flags.DEFINE_float("heartbeat_timeout", 10.0,
                   "Seconds without a heartbeat before the coordination "
                   "service marks a worker dead (drives the R<N mask)")
flags.DEFINE_string("inject_step_delay", "",
                    "Fault injection: comma-separated 'SECS:N' (sleep SECS "
                    "after each of the first N local steps) or "
                    "'SECS:START:END' windows")
flags.DEFINE_integer("steps_per_call", 1,
                     "Optimizer steps per train-step call; logging, "
                     "validation and checkpoints move to chunk boundaries")
flags.DEFINE_integer("grad_accum_steps", 1,
                     "Accumulate gradients over N microbatches per "
                     "optimizer step (sync only; exclusive with "
                     "--steps_per_call)")
flags.DEFINE_float("ema_decay", 0.0,
                   "Keep an exponential moving average of the weights; "
                   "evaluation and the final test use it (sync only)")
flags.DEFINE_boolean("log_sharding", False,
                     "Print each parameter's placement at startup")
flags.DEFINE_boolean("fsdp", False,
                     "ZeRO-3/FSDP: shard each large parameter, its "
                     "optimizer slots and moving average over the sync "
                     "workers (the data axis), gathered for each step")
flags.DEFINE_integer("fsdp_min_size", 65536,
                     "FSDP: leaves smaller than this many elements stay "
                     "replicated")
flags.DEFINE_boolean("graceful_shutdown", True,
                     "On SIGTERM/SIGINT: finish the step, checkpoint, exit")
flags.DEFINE_integer("prefetch", 2,
                     "Host->device input prefetch depth (background thread, "
                     "pinned non-blocking copies; 0 feeds synchronously)")
flags.DEFINE_string("feed_dtype", "float32",
                    "Training-feed image dtype: float32 | uint8 (raw bytes "
                    "host->device, normalized on the device; image models)")
flags.DEFINE_string("metrics_file", None,
                    "Append structured JSONL metric records here")
flags.DEFINE_boolean("telemetry", True,
                     "With --metrics_file: the per-step data-wait/compute "
                     "breakdown (the step synchronised each step), MFU, "
                     "device-memory watermarks and a final run_summary")
flags.DEFINE_float("peak_tflops", 0.0,
                   "Per-device peak TFLOP/s for the telemetry MFU (0 = "
                   "the card's table entry; none on the CPU)")
flags.DEFINE_float("health_report_every", 10.0,
                   "Seconds between cluster-health telemetry snapshots; "
                   "0 disables")
flags.DEFINE_string("summary_dir", None,
                    "Write TensorBoard scalar summaries here (chief only)")
flags.DEFINE_boolean("summary_histograms", False,
                     "Also write per-parameter weight histograms at the "
                     "validation cadence (requires --summary_dir)")
flags.DEFINE_string("async_mode", "local_sgd",
                    "Async flavour with --sync_replicas=false: local_sgd "
                    "(periodic parameter averaging)")
flags.DEFINE_integer("async_sync_period", 16,
                     "Local steps between parameter averages in async mode")
flags.DEFINE_boolean("async_overlap_exchange", False,
                     "Run the async parameter exchange in a background "
                     "thread; its consensus lands one period late as a "
                     "delta against its snapshot")
flags.DEFINE_string("async_compress", "off",
                    "Compressed sharded parameter exchange: int8 | bf16 "
                    "deltas with error feedback, or off (full state)")
flags.DEFINE_integer("async_anchor_every", 8,
                     "Full-state anchor cadence (consensus rounds) of the "
                     "compressed exchange")
flags.DEFINE_integer("async_quant_block", 1024,
                     "Elements per scale block of the int8 exchange format")
flags.DEFINE_integer("slice_size", 0,
                     "Hierarchical compressed exchange: workers per slice "
                     "(0 = auto from the topology, 1 = flat)")
flags.DEFINE_string("coord_standbys", "",
                    "Coordinator HA: warm-standby endpoints, 'h:p,...' for "
                    "the control shard or '0:h:p;1:h:p' an instance")
flags.DEFINE_integer("coord_instances", 1,
                     "Sharded coordination plane: coordinator instances "
                     "(instance i on the coordinator port + i)")
flags.DEFINE_string("trainable_params", "",
                    "Selective fine-tuning: regex over flax parameter paths "
                    "(hid/kernel); only matching parameters train, the "
                    "rest are frozen with no optimizer slots")
flags.DEFINE_string("elastic_mode", "auto",
                    "Elastic membership: auto | off | in_place (masked sync "
                    "flips its mask; an evicted worker rejoins and "
                    "restores) | reshard (checkpoint at a negotiated stop "
                    "step and exit for relaunch)")
flags.DEFINE_integer("elastic_reshard_margin", 20,
                     "reshard mode: steps between the chief's announcement "
                     "and the collective stop-and-checkpoint")
flags.DEFINE_integer("straggler_lag", 0,
                     "R<N masked sync: drop a live worker whose heartbeat "
                     "step falls more than this many steps behind the "
                     "front-runner (0 drops only on heartbeat death)")
flags.DEFINE_string("profile_dir", None,
                    "Profile the training loop with torch.profiler into "
                    "this directory (trace.json and summary.json with the "
                    "card's busy share; task<i>/ with several workers)")

# The JAX train.py's flags of paths not ported yet: declared so its command
# lines parse; a value other than the default raises NotImplementedError
# naming ROADMAP.md's entry.
flags.DEFINE_integer("tensor_parallel", 1,
                     "Size of the 'model' mesh axis (tensor parallelism: "
                     "Megatron's split of gpt_mini over the worker's "
                     "positions)")
flags.DEFINE_integer("expert_parallel", 1,
                     "Size of the 'expert' mesh axis (expert parallelism: "
                     "--model=bert_moe's stacked experts split over the "
                     "worker's positions)")
flags.DEFINE_integer("num_experts", 4,
                     "Number of MoE experts for --model=bert_moe")
flags.DEFINE_integer("sequence_parallel", 1,
                     "Size of the 'seq' mesh axis (sequence/context "
                     "parallelism; pairs with --attention_backend=ring "
                     "or ulysses)")
flags.DEFINE_boolean("data_augmentation", False,
                     "Train-time data augmentation where the pipeline "
                     "defines one (resnet20/vit_tiny on CIFAR: "
                     "reflect-pad-4 random crop + horizontal flip)")
flags.DEFINE_boolean("sharded_feed", True,
                     "Multi-process runs: each process loads only its "
                     "slice of the global batch (disjoint per-process data "
                     "streams) instead of every host materializing the "
                     "full batch. Auto-falls back (with a log line) for "
                     "seq-sharded layouts, indivisible batch sizes, or "
                     "splits without shard()")
flags.DEFINE_integer("dcn_data_parallel", 1,
                     "Multi-slice pods: outer factor of the 'data' axis that "
                     "crosses slice boundaries over DCN (positions ordered "
                     "slice-major; the gradient mean runs within a slice, "
                     "then across the slices). 1 = single slice")
_UNPORTED_FLAGS = (
    ("string", "platform", None, "item 8; --device is the port's switch"),
    ("string", "profile", "", "item 8"),
)
for _kind, _name, _default, _where in _UNPORTED_FLAGS:
    getattr(flags, f"DEFINE_{_kind}")(
        _name, _default, f"JAX train.py flag, not ported yet ({_where}); "
        "parsed, and a non-default value raises")


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md, "
                               f"section 1, {where}")


def run_generate():
    """Inference entry point: restore the newest checkpoint and decode.

    Restores *raw arrays* (no state template), so it works with any
    training configuration: optimizer slots are ignored, EMA weights are
    preferred when present, and a ``--pipeline_parallel`` run's
    stage-stacked tree is merged back into the plain layout.  Widths,
    vocabulary and architecture come from the tree (the JAX CLI takes the
    widths from ``mini()``).  Without a checkpoint it decodes from a
    random init seeded by ``--seed``, drawn by torch: not the JAX CLI's
    init, so those tokens differ from it."""
    from .models import gpt as gpt_lib
    from .models.registry import pipeline_bundle_name
    from .tools.checkpoint_io import list_step_dirs, restore_raw
    from .tools.export_model import kernel_config, merge_if_pipelined
    from .utils.device import cli_device

    if FLAGS.model != "gpt_mini":
        raise ValueError(
            f"--mode=generate needs an autoregressive model "
            f"(--model=gpt_mini), got --model={FLAGS.model}")
    device = cli_device(FLAGS.device)

    # Mirror the training run's checkpoint namespace (registry bundles).
    if FLAGS.pipeline_parallel > 1:
        name = pipeline_bundle_name(FLAGS.pipeline_parallel,
                                    FLAGS.pipeline_schedule,
                                    FLAGS.pipeline_virtual_stages)
    else:
        name = "gpt_mini"
    cfg = dataclasses.replace(gpt_lib.mini(), dtype=FLAGS.bert_dtype,
                              pos_encoding=FLAGS.gpt_positions,
                              kv_heads=FLAGS.gpt_kv_heads,
                              attention_window=FLAGS.attention_window,
                              activation=FLAGS.gpt_activation,
                              norm=FLAGS.gpt_norm)

    run_dir = os.path.join(FLAGS.logdir, name)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    restored_step, tree = 1, None
    if list_step_dirs(ckpt_dir):
        restored, _, _ = restore_raw(run_dir)
        restored_step = int(restored["global_step"])
        tree = merge_if_pipelined(
            restored.get("ema_params") or restored["params"],
            FLAGS.pipeline_virtual_stages
            if FLAGS.pipeline_schedule == "interleaved" else 1)
        cfg = dataclasses.replace(cfg, **gpt_lib.infer_widths(tree))
        layer0 = tree.get("layer0", {})
        if layer0:
            # Architecture knobs the checkpoint itself reveals: the tree
            # is ground truth — a mismatched cfg could not apply these
            # params — so explicit flags that disagree are overridden with
            # a warning.
            arch = gpt_lib.infer_arch_from_layer0(layer0)
            kv_inferred = arch.pop("kv_heads", 0)
            if kv_inferred and not FLAGS.gpt_kv_heads:
                cfg = dataclasses.replace(cfg, kv_heads=kv_inferred)
            for flag, knob in (("gpt_activation", "activation"),
                               ("gpt_norm", "norm")):
                passed = getattr(FLAGS, flag)
                if passed != arch[knob] and passed != getattr(
                        gpt_lib.mini(), knob):
                    print(f"WARNING: --{flag}={passed} does not match "
                          f"the checkpoint ({arch[knob]}); using the "
                          "checkpoint's architecture")
            cfg = dataclasses.replace(cfg, **arch)
    model = gpt_lib.GptLM(kernel_config(cfg), device=device, seed=FLAGS.seed)
    if tree is None:
        print(f"WARNING: no checkpoint found under {ckpt_dir}; "
              "generating from random init")
    else:
        model.load_state_dict(gpt_lib.params_from_jax(tree))
        del tree

    # A corpus-trained run keeps its tokenizer beside its checkpoints;
    # --gen_prompt_text encodes through it, and the output is decoded to
    # text too.
    tok = None
    tok_path = os.path.join(run_dir, "tokenizer.json")
    if os.path.exists(tok_path):
        from .data.tokenizer import BpeTokenizer
        tok = BpeTokenizer.load(tok_path)
    if FLAGS.gen_prompt_text:
        if tok is None:
            raise ValueError(
                f"--gen_prompt_text needs the run's tokenizer at {tok_path} "
                "(saved by corpus-trained runs); use --gen_prompt ids instead")
        ids = tok.encode(FLAGS.gen_prompt_text.encode("utf-8")).tolist()
        if not ids:
            raise ValueError("--gen_prompt_text encoded to zero tokens")
        bad = [t for t in ids if not 0 <= t < cfg.vocab_size]
        if bad:
            raise ValueError(
                f"--gen_prompt_text encoded to ids {bad} outside the "
                f"model's vocab [0, {cfg.vocab_size}); the saved tokenizer "
                "does not match this checkpoint")
        prompt = torch.tensor([ids], dtype=torch.int32)
    elif FLAGS.gen_prompt:
        ids = [int(t) for t in FLAGS.gen_prompt.split(",")]
        bad = [t for t in ids if not 0 <= t < cfg.vocab_size]
        if bad:
            raise ValueError(f"--gen_prompt ids {bad} outside vocab "
                             f"[0, {cfg.vocab_size})")
        prompt = torch.tensor([ids], dtype=torch.int32)
    else:
        seq = min(FLAGS.bert_seq_len, cfg.max_position - FLAGS.gen_tokens)
        prompt = torch.from_numpy(gpt_lib.synthetic_lm_batch(
            FLAGS.seed, 1, max(seq, 2), cfg)["tokens"][:, :max(seq // 2, 1)])
    eos_id = None if FLAGS.gen_eos_id < 0 else FLAGS.gen_eos_id
    if eos_id is not None and eos_id >= cfg.vocab_size:
        raise ValueError(f"--gen_eos_id {eos_id} outside vocab "
                         f"[0, {cfg.vocab_size})")
    if FLAGS.gen_stop_text and tok is None:
        raise ValueError(
            f"--gen_stop_text needs the run's tokenizer at {tok_path} "
            "(saved by corpus-trained runs) to decode the output")
    if FLAGS.gen_speculative and FLAGS.gen_beams > 1:
        raise ValueError("--gen_speculative is exclusive with --gen_beams")
    if FLAGS.gen_speculative == 1 or FLAGS.gen_speculative < 0:
        raise ValueError(f"--gen_speculative must be 0 (off) or >= 2, got "
                         f"{FLAGS.gen_speculative}")
    sampling = FLAGS.gen_temperature > 0 or FLAGS.gen_top_k or FLAGS.gen_top_p
    if FLAGS.gen_beams > 1:
        if sampling:
            raise ValueError(
                "--gen_beams > 1 is exact-search decoding; it is exclusive "
                "with the sampling flags (--gen_temperature/--gen_top_k/"
                "--gen_top_p)")
        out, logprob = gpt_lib.beam_search_cached(
            model, None, prompt, FLAGS.gen_tokens,
            beam_size=FLAGS.gen_beams, quantize=FLAGS.gen_quantize,
            kv_dtype=FLAGS.gen_kv_dtype, eos_id=eos_id,
            length_penalty=FLAGS.gen_length_penalty)
        print(f"Beam search (width {FLAGS.gen_beams}) best logprob: "
              f"{float(logprob[0]):.4f}")
    elif FLAGS.gen_speculative:
        if sampling:
            raise ValueError(
                "--gen_speculative is greedy-only (verification compares "
                "against argmax); it is exclusive with the sampling flags")
        decode = (gpt_lib.generate_cached_speculative_device
                  if FLAGS.gen_speculative_device
                  else gpt_lib.generate_cached_speculative)
        out, spec_stats = decode(
            model, None, prompt, FLAGS.gen_tokens,
            spec_k=FLAGS.gen_speculative, eos_id=eos_id,
            quantize=FLAGS.gen_quantize, kv_dtype=FLAGS.gen_kv_dtype)
        fb = spec_stats.get("fallback_at_round")
        small = spec_stats.get("rounds_small", 0)
        print(f"Speculative decode: {spec_stats['tokens_generated']} tokens "
              f"in {spec_stats['rounds']} rounds "
              f"({spec_stats['mean_accepted_per_round']} tokens/round)"
              + (f"; low acceptance — fell back to plain cached decode "
                 f"after round {fb}" if fb is not None else "")
              + (f"; adaptive K ran {small} small round(s)"
                 if small else ""))
    else:
        generator = (torch.Generator().manual_seed(FLAGS.seed)
                     if FLAGS.gen_temperature > 0 else None)
        out = gpt_lib.generate_cached(
            model, None, prompt, FLAGS.gen_tokens,
            temperature=FLAGS.gen_temperature, top_k=FLAGS.gen_top_k,
            top_p=FLAGS.gen_top_p, generator=generator,
            quantize=FLAGS.gen_quantize, kv_dtype=FLAGS.gen_kv_dtype,
            eos_id=eos_id)
    toks = out[0].cpu().numpy()
    split = prompt.shape[1]
    gen = toks[split:]
    if eos_id is not None:
        # Report up to and including the first terminator; the tail past
        # it is eos padding by construction.
        hits = (gen == eos_id).nonzero()[0]
        if hits.size:
            gen = gen[:hits[0] + 1]
            print(f"Stopped at eos id {eos_id} after {hits[0] + 1} tokens")
    # The decode's kernel launches, ahead of the JAX CLI's closing lines.
    print(f"Kernel launches: {json.dumps(_kernel_launches())}")
    print(f"Restored global step: {restored_step}")
    print(f"Prompt tokens:    {' '.join(map(str, toks[:split]))}")
    print(f"Generated tokens: {' '.join(map(str, gen))}")
    if tok is not None:
        drop = 1 if (eos_id is not None and gen.size and
                     gen[-1] == eos_id) else 0
        text = tok.decode(gen[:gen.size - drop]).decode("utf-8",
                                                        errors="replace")
        if FLAGS.gen_stop_text and FLAGS.gen_stop_text in text:
            text = text.split(FLAGS.gen_stop_text, 1)[0]
            print(f"Stopped at stop text {FLAGS.gen_stop_text!r}")
        print(f"Generated text:   {text!r}")
    return toks


def _parameter_digest(model: torch.nn.Module) -> str:
    """sha256 over every parameter's bytes in name order, a parameter
    split over the model axis taken whole: equal digests mean bit-equal
    parameters."""
    from .parallel.sharding import gather_named
    return _digest(gather_named(model, dict(model.named_parameters())))


def _digest(named: dict) -> str:
    """sha256 over the bytes of ``{name: tensor}`` in name order."""
    h = hashlib.sha256()
    for name, p in sorted(named.items()):
        h.update(name.encode())
        h.update(p.detach().to("cpu").contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def _kernel_launches() -> dict:
    """The hand-written kernels' launch counters in this process (each
    wrapper adds one where it launches its kernel)."""
    from .ops import flash_attention as fa
    from .ops import layer_norm as ln
    from .ops import quant_matmul as qmm
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "layer_norm_fwd": ln.launches,
            "quant_matmul": qmm.launches,
            "quant_matmul_nt": qmm.nt_launches,
            "flash_attention_chunk": fa.chunk_launches,
            "flash_attention_chunk_dq": fa.chunk_dq_launches,
            "flash_attention_chunk_dkv": fa.chunk_dkv_launches}


def _validate_parallel_flags() -> None:
    """The JAX CLI's checks of the pipeline and expert flags (JAX
    ``train.py:834-882``), with its messages."""
    if FLAGS.pipeline_parallel > 1:
        if FLAGS.model != "gpt_mini":
            raise ValueError(
                f"--pipeline_parallel needs a homogeneous-block model "
                f"(--model=gpt_mini), got --model={FLAGS.model}")
        if FLAGS.pipeline_schedule == "interleaved":
            if FLAGS.pipeline_virtual_stages < 2:
                raise ValueError(
                    f"--pipeline_schedule=interleaved needs "
                    f"--pipeline_virtual_stages >= 2, got "
                    f"{FLAGS.pipeline_virtual_stages}")
            if FLAGS.pipeline_microbatches % FLAGS.pipeline_parallel:
                raise ValueError(
                    f"--pipeline_schedule=interleaved needs "
                    f"--pipeline_microbatches "
                    f"({FLAGS.pipeline_microbatches}) divisible by "
                    f"--pipeline_parallel ({FLAGS.pipeline_parallel})")
        if FLAGS.tensor_parallel > 1:
            raise ValueError(
                "--pipeline_parallel with --tensor_parallel is not supported")
        if FLAGS.steps_per_call > 1 or FLAGS.grad_accum_steps > 1:
            raise ValueError(
                "--pipeline_parallel already microbatches internally; it is "
                "exclusive with --steps_per_call/--grad_accum_steps")
        if FLAGS.bert_dropout > 0:
            raise ValueError(
                "--bert_dropout with --pipeline_parallel is unsupported "
                "(the pipelined stage schedule is rng-free)")
        if FLAGS.sequence_parallel > 1 or FLAGS.attention_backend in (
                "ring", "ulysses"):
            raise ValueError(
                "--pipeline_parallel cannot nest sequence-parallel attention "
                "(--sequence_parallel/--attention_backend=ring|ulysses): "
                "shard_map inside shard_map is unsupported")
        if FLAGS.gpt_matmul_int8:
            raise ValueError(
                "--gpt_matmul_int8 with --pipeline_parallel is not wired "
                "up; drop one of the two flags")
    if FLAGS.expert_parallel > 1:
        if FLAGS.model != "bert_moe":
            raise ValueError(
                f"--expert_parallel={FLAGS.expert_parallel} needs an MoE "
                f"model (--model=bert_moe), got --model={FLAGS.model}")
        if FLAGS.num_experts % FLAGS.expert_parallel:
            raise ValueError(
                f"--num_experts={FLAGS.num_experts} must be divisible by "
                f"--expert_parallel={FLAGS.expert_parallel}")


def _worker_mesh(pcfg, positions: list, local_data: int, num_workers: int,
                 task: int | None = None):
    """The worker's mesh: ``local_data`` data rows over ``positions``.
    The DCN factor splits the whole data axis (``num_workers x
    local_data``, JAX's message where it does not divide); the slices
    that lie inside this worker order its rows (``Mesh.row_slices``),
    the rest are worker groups (:mod:`.cluster.server`).  ``task`` (a
    worker of a process group): its part of the global mesh over every
    worker's positions (``parallel/mesh.global_mesh``), whose outer
    axes cross the workers where the non-data axes do not fit in one;
    where every axis fits, the worker's own mesh (no ``ranks``)."""
    from .parallel.mesh import create_mesh, global_mesh
    dcn, total = pcfg.dcn_data, num_workers * local_data
    if total % dcn:
        raise ValueError(
            f"data axis {total} not divisible by dcn_data={dcn} (the DCN "
            "factor is the data axis's outer segment)")
    per_slice = total // dcn
    if per_slice % local_data and local_data % per_slice:
        raise ValueError(
            f"--dcn_data_parallel={dcn} puts {per_slice} data position(s) in "
            f"a slice, which splits a worker's {local_data} local rows")
    sizes = dict(model=pcfg.model, seq=pcfg.seq, pipe=pcfg.pipe,
                 expert=pcfg.expert)
    local_dcn = max(1, local_data // per_slice)
    if task is None:
        return create_mesh(data=local_data, devices=positions,
                           dcn_data=local_dcn, **sizes)
    mesh = global_mesh(num_workers=num_workers, rank=task,
                       positions=positions, local_dcn=local_dcn, **sizes)
    if not mesh.ranks.cross:
        mesh.ranks = None
    elif dcn > 1:
        from .parallel.mesh import cross_process_error
        raise cross_process_error(
            f"--dcn_data_parallel beside the {'/'.join(mesh.ranks.cross)} "
            "axis")
    return mesh


def _check_unported_flags() -> None:
    for _, name, default, where in _UNPORTED_FLAGS:
        if getattr(FLAGS, name) != default:
            raise _not_ported(f"--{name}", where)


def _log_placement(task: int, state) -> None:
    """``--log_sharding``: each parameter's placement, in the JAX CLI's
    format (its flax path, whole shape and spec), with its devices."""
    from .parallel.sharding import (P, _sharded_entries, fsdp_entries,
                                    row_models)
    from .training.state import param_paths
    from .utils.pytree import tree_paths
    model = state.model
    if hasattr(model, "stages"):
        # A pipeline: the stage-stacked tree, its stages over ``pipe``.
        spec = P(None, "pipe") if model.n_virtual > 1 else P("pipe")
        devices = ", ".join(str(s.layers[0].ln_attn.scale.device)
                            for s in model.stages[:model.n_pipe])
        tree = model.params_to_tree(dict(model.named_parameters()))
        for path, leaf in tree_paths(tree):
            staged = path.startswith("stages/")
            print(f"Worker {task}: param {path} {tuple(leaf.shape)} -> "
                  f"{spec if staged else P()} on "
                  f"{devices if staged else model.device}")
        return
    # An FSDP slice prints its whole shape and the composed spec (JAX's
    # P('data', ...)); a tensor-parallel split its whole parameter; each
    # with the devices of every local data row's copy.
    rows = row_models(state)

    def devices_of(names):
        return [m.get_parameter(n).device for m in rows for n in names]
    fsdp = {name: info for name, _, _, info in fsdp_entries(model)}
    shapes = {n: fsdp[n].shape if n in fsdp else tuple(p.shape)
              for n, p in model.named_parameters()}
    split = {n: (info.spec, devices_of([n])) for n, info in fsdp.items()}
    for name, info, names in _sharded_entries(model):
        shape = list(shapes.pop(names[0]))
        shape[info.dim] *= len(names)
        shapes[name] = tuple(shape)
        for n in names:
            shapes.pop(n, None)
            split.pop(n, None)
        split[name] = (fsdp[names[0]].spec if names[0] in fsdp else
                       info.spec, devices_of(names))
    for name, path in param_paths(shapes, state.params_to_tree).items():
        spec, devices = split[name] if name in split else (
            P(), devices_of([name]))
        print(f"Worker {task}: param {path} {shapes[name]} -> "
              f"{spec} on {', '.join(map(str, devices))}")


def _step_delay(spec: str, step_fn):
    """``--inject_step_delay``: sleep after the local steps of its
    windows."""
    windows = []
    try:
        for part in spec.split(","):
            bits = part.split(":")
            if len(bits) == 2:
                windows.append((float(bits[0]), 0, int(bits[1])))
            elif len(bits) == 3:
                windows.append((float(bits[0]), int(bits[1]), int(bits[2])))
            else:
                raise ValueError(bits)
    except ValueError:
        raise ValueError(
            f"--inject_step_delay windows must be 'SECS:N' or "
            f"'SECS:START:END', got {spec!r}") from None
    count = {"n": 0}

    def step(*args):
        out = step_fn(*args)
        i = count["n"]
        count["n"] += 1
        delay = sum(d for d, lo, hi in windows if lo <= i < hi)
        if delay > 0:
            time.sleep(delay)
        return out

    return step


def _elastic_controller(coord, sv, elastic_ctx: dict, num_workers: int,
                        chief: bool, *, masked_single: bool,
                        multi_process_sync: bool):
    """Resolve ``--elastic_mode`` and build its controller (None when
    off).  ``auto`` is ``in_place`` on a masked (R<N) sync worker outside
    a process group (the mask flips), ``reshard`` for the sync workers of
    a process group (a fixed world size: save and relaunch), else off."""
    mode = FLAGS.elastic_mode
    if mode not in ("auto", "off", "in_place", "reshard"):
        raise ValueError(f"--elastic_mode must be auto, off, in_place or "
                         f"reshard, got {mode!r}")
    if mode == "auto":
        if masked_single and coord is not None:
            mode = "in_place"
        elif multi_process_sync and coord is not None:
            mode = "reshard"
        else:
            mode = "off"
    if mode == "off":
        return None
    if coord is None:
        raise ValueError(
            f"--elastic_mode={FLAGS.elastic_mode} needs a coordination "
            "service (standalone runs have no membership to watch)")
    from .cluster.coordination import MembershipWatcher
    from .training.elastic import ElasticController
    watcher = MembershipWatcher(coord, num_workers, interval=1.0)
    watcher.start()
    elastic_ctx["watcher"] = watcher
    controller = ElasticController(
        watcher=watcher, client=coord, task_index=FLAGS.task_index,
        num_workers=num_workers, supervisor=sv, mode=mode, is_chief=chief,
        reshard_margin_steps=FLAGS.elastic_reshard_margin)
    print(f"Worker {FLAGS.task_index}: elastic membership active "
          f"(mode={mode})")
    return controller


def _async_exchange(state, train_step, coord, num_workers: int):
    """The cross-process exchange of async mode (the reference PS's role,
    SURVEY N2/N4): choose the averager from ``--async_compress`` and
    ``--slice_size``, adopt the collective's published parameters, and
    wrap ``train_step`` to exchange every period, in the foreground or
    (``--async_overlap_exchange``) in a background thread.  Returns
    ``(train_step, averager, finalize)``; ``finalize(state)`` drains an
    overlapped exchange at the end (None otherwise)."""
    from .cluster.coordination import CoordinationError
    from .cluster.param_sync import (CompressedShardedAverager,
                                     HierarchicalCompressedAverager,
                                     OverlappedAverager, ParamAverager,
                                     run_namespace)
    from .parallel.async_replicas import (adopt_consensus,
                                          adopt_consensus_delta, host_tree)
    from .parallel.sync import auto_slice_size

    task = FLAGS.task_index
    # The binary side-channel lives next to the checkpoints (the same
    # shared-FS assumption), so transformer-scale trees exchange at disk
    # bandwidth instead of base64 through one socket.
    kwargs = dict(namespace=run_namespace(FLAGS.logdir),
                  exchange_dir=os.path.join(FLAGS.logdir, "async_exchange"))
    if FLAGS.async_compress not in ("off", "int8", "bf16"):
        raise ValueError(f"--async_compress must be off, int8 or bf16, "
                         f"got {FLAGS.async_compress!r}")
    if FLAGS.async_compress != "off":
        # Shard ownership is keyed on the membership epoch, so every worker
        # derives the same owner map; the auto slice size follows the
        # --dcn_data_parallel slices.
        slice_size = (FLAGS.slice_size if FLAGS.slice_size > 0
                      else auto_slice_size(num_workers,
                                           FLAGS.dcn_data_parallel))
        common = dict(quant=FLAGS.async_compress,
                      block=FLAGS.async_quant_block,
                      anchor_every=FLAGS.async_anchor_every,
                      epoch_fn=coord.members, **kwargs)
        if slice_size > 1:
            averager = HierarchicalCompressedAverager(
                coord, task, num_workers, slice_size=slice_size, **common)
            print(f"Worker {task}: hierarchical compressed exchange on "
                  f"(slice_size={slice_size}, delta+{FLAGS.async_compress} "
                  f"inter-slice shard reduce, anchor every "
                  f"{FLAGS.async_anchor_every} rounds)")
        else:
            averager = CompressedShardedAverager(coord, task, num_workers,
                                                 **common)
            print(f"Worker {task}: compressed parameter exchange on "
                  f"(delta+{FLAGS.async_compress} sharded reduce, anchor "
                  f"every {FLAGS.async_anchor_every} rounds)")
    else:
        averager = ParamAverager(coord, task, num_workers, **kwargs)
    coord.start_health_polling(interval=1.0, num_tasks=num_workers)

    # Restart-and-rejoin: adopt the collective's published state instead
    # of starting from scratch (the PS-durability behaviour).
    try:
        latest = averager.pull_latest(host_tree(state))
    except (CoordinationError, OSError):
        latest = None
    if latest is not None:
        adopt_consensus(state, latest)
        print(f"Worker {task}: adopted published collective parameters "
              "from the coordination service")

    base_step = train_step
    # A scanned async step covers a full sync period a call.
    period = (1 if FLAGS.steps_per_call > 1
              else max(FLAGS.async_sync_period, 1))
    calls = {"n": 0}
    finalize = None

    if FLAGS.async_overlap_exchange:
        overlapped = OverlappedAverager(averager,
                                        alive_fn=coord.cached_health)

        def apply_ready(s, result):
            avg, snap, peers = result
            if peers:
                adopt_consensus_delta(s, avg, snap)
                secs = overlapped.last_exchange_seconds
                print(f"Worker {task}: applied overlapped average with "
                      f"{peers} peer(s) at local step {calls['n']} "
                      f"(exchange ran {secs:.1f}s in background, "
                      f"{averager.last_publish_transport} publish)")
            return s

        def exchange(s):
            result = overlapped.poll()
            if result is not None:
                s = apply_ready(s, result)
            if not overlapped.busy:
                # Snapshot only when the thread can take it: the device-
                # to-host copy is itself the stall being hidden.  The
                # thread touches host arrays only, never a device tensor.
                overlapped.submit(host_tree(s))
            return s

        def finalize(s):
            """End of training: collect the in-flight exchange so the
            final parameters carry the last consensus pull, then stop the
            thread."""
            result = overlapped.drain(timeout=60.0)
            if result is not None:
                s = apply_ready(s, result)
            overlapped.close()
            return s
    else:
        def exchange(s):
            try:
                avg, peers = averager.exchange(host_tree(s),
                                               alive=coord.cached_health())
            except (CoordinationError, OSError):
                # Async workers must not depend on peers: skip this
                # exchange and keep stepping.
                print(f"Worker {task}: parameter exchange failed "
                      "(coordination unreachable); continuing")
                return s
            if peers:
                adopt_consensus(s, avg)
                print(f"Worker {task}: averaged parameters with {peers} "
                      f"peer(s) at local step {calls['n']} "
                      f"({averager.last_publish_transport} publish, "
                      f"{averager.last_publish_mb_per_sec:.0f} MB/s)")
            return s

    def train_step(s, batch, _base=base_step):
        s, m = _base(s, batch)
        calls["n"] += 1
        if calls["n"] % period == 0:
            s = exchange(s)
        return s, m

    return train_step, averager, finalize


def main(unused_argv):
    from .cluster.server import DISABLE_ENV, Server
    from .cluster.spec import ClusterSpec, is_chief
    from .models import registry
    from .parallel import sync as sync_lib
    from .parallel import mesh as mesh_lib
    from .parallel.mesh import ParallelConfig, worker_positions
    from .parallel.sharding import fsdp_gathered, is_fsdp
    from .training.loop import parameters_swapped, run_training_loop
    from .training.optimizers import schedule_from_flags
    from .training.preemption import ShutdownSignal
    from .training.supervisor import Supervisor
    from .utils import faults, profiling
    from .utils.metrics import MetricsLogger
    from .utils.summary import SummaryWriter

    # Chaos harness: arm any DTF_CHAOS-specified faults before bring-up (a
    # no-op when the variable is unset).
    faults.install_from_env()

    if FLAGS.mode == "generate":
        return run_generate()
    if FLAGS.mode not in ("train", "eval"):
        raise ValueError(
            f"--mode must be train, eval or generate, got {FLAGS.mode}")

    validate_role_flags(FLAGS)
    _validate_parallel_flags()
    _check_unported_flags()
    if FLAGS.feed_dtype not in ("float32", "uint8"):
        raise ValueError(
            f"--feed_dtype must be float32 or uint8, got {FLAGS.feed_dtype}")
    if FLAGS.ema_decay != 0 and not (0 < FLAGS.ema_decay < 1):
        raise ValueError(f"--ema_decay must be in (0, 1), got {FLAGS.ema_decay}")
    if not 0 <= FLAGS.label_smoothing < 1:
        raise ValueError(f"--label_smoothing must be in [0, 1), got "
                         f"{FLAGS.label_smoothing}")
    if FLAGS.attention_window < 0:
        raise ValueError(f"--attention_window must be >= 0, got "
                         f"{FLAGS.attention_window}")
    if FLAGS.gpt_tokenizer not in ("byte", "bpe"):
        raise ValueError(f"--gpt_tokenizer must be byte or bpe, got "
                         f"{FLAGS.gpt_tokenizer!r}")
    if FLAGS.gpt_tokenizer == "bpe":
        from .models.registry import _validate_bpe_vocab
        try:
            _validate_bpe_vocab(FLAGS.gpt_bpe_vocab)
        except ValueError as e:
            raise ValueError(f"--gpt_bpe_vocab: {e}") from None
    if FLAGS.async_mode != "local_sgd":
        raise ValueError(f"--async_mode must be local_sgd, got "
                         f"{FLAGS.async_mode!r}")
    # One declarative layout.  Its data axis is the worker processes times
    # each worker's local rows: a worker's mesh is data x seq x pipe x
    # expert x model over the devices it drives, laid round robin.
    pcfg = ParallelConfig.from_flags(FLAGS)

    cluster = ClusterSpec({"ps": FLAGS.ps_hosts, "worker": FLAGS.worker_hosts})
    num_workers = cluster.num_workers
    device = positions = bundle = None
    local_data = 1
    # The sync trainer's workers form a process group and one global
    # mesh (its outer axes across them where the others do not fit in a
    # worker); an async worker, or one that trains alone, keeps a mesh
    # of its own devices.
    global_layout = (FLAGS.job_name == "worker" and num_workers > 1
                     and FLAGS.mode == "train" and FLAGS.sync_replicas
                     and os.environ.get(DISABLE_ENV, "0") != "1")
    if FLAGS.job_name == "worker":
        fixed = pcfg.pipe * pcfg.seq * pcfg.expert * pcfg.model
        count = mesh_lib.local_data_size(FLAGS.device, 1, num_workers)
        local_data = max(1, count // fixed)
        n_positions = local_data * fixed
        if global_layout and fixed > count:
            # The outer non-data axes cross the workers.
            local_data, n_positions = 1, count
        positions = worker_positions(FLAGS.device, FLAGS.task_index,
                                     n_positions)
        device = positions[0]
        mesh = _worker_mesh(pcfg, positions, local_data, num_workers,
                            FLAGS.task_index if global_layout else None)
        if mesh.crosses(mesh_lib.SEQ_AXIS) and \
                pcfg.resolved_attention() == "ulysses":
            raise mesh_lib.cross_process_error(
                "ulysses' all-to-all over seq")
        bundle = registry.build(FLAGS.model, FLAGS, device, mesh=mesh)
    stateful = bundle is not None and bundle.stateful_loss_fn is not None
    # Async workers meet only at the coordination service, never in a
    # collective (reference distributed.py:102,145): a process group would
    # tie their independent cadences together.  A stateful model trains
    # sync whatever --sync_replicas says.
    server = Server(cluster, FLAGS.job_name, FLAGS.task_index, device=device,
                    positions=len(positions or [device]),
                    dcn_data=FLAGS.dcn_data_parallel,
                    mesh=mesh if global_layout else None,
                    initialize_distributed=(
                        None if FLAGS.mode == "train" and (
                            FLAGS.sync_replicas or stateful)
                        else False),
                    heartbeat_timeout=FLAGS.heartbeat_timeout,
                    kv_persist_path=os.path.join(
                        FLAGS.logdir, "coordination_kv.journal"),
                    coord_instances=FLAGS.coord_instances,
                    coord_standbys=FLAGS.coord_standbys or None)
    if FLAGS.job_name == "ps":
        server.join()
        return

    task = FLAGS.task_index
    chief = is_chief(task)
    world = server.world_size
    if server.process_group:
        print(f"Worker {task}: process group rank {task} of {world} over "
              f"{server.backend} ({server.backend_reason}) on {device}, "
              f"layout {pcfg.describe()}")
    else:
        print(f"Worker {task}: no process group; training alone on {device}")

    cross = mesh.ranks.cross if mesh.ranks is not None else ()
    if len(positions) > 1 or cross:
        pipe = f"pipe={pcfg.pipe}, " if pcfg.pipe > 1 else ""
        expert = f"expert={pcfg.expert}, " if pcfg.expert > 1 else ""
        data = f"data={local_data}, " if local_data > 1 else ""
        across = ""
        if cross:
            ranks = mesh.ranks
            across = "; across the workers: " + ", ".join(
                f"{a}={ranks.shape[a]} (this worker {a} "
                f"{ranks.coords[a]}, ranks {ranks.axis_ranks(a)})"
                for a in cross) + f", data={ranks.shape['data']}"
        print(f"Worker {task}: mesh {pcfg.describe()} ({data}{pipe}{expert}"
              f"seq={pcfg.seq}, model={pcfg.model}): "
              f"{len(positions)} positions on "
              f"{len(set(positions))} distinct device(s) "
              f"{', '.join(map(str, positions))}{across}")
        from .parallel.transport import link
        for axis in cross:
            print(f"Worker {task}: {axis} hops {link(mesh, axis).describe()}")
    state = bundle.state
    # Rules engage only when the mesh has a model or expert axis (JAX's
    # use_tp), so mnist_mlp with --tensor_parallel trains replicated.
    use_tp = (bundle.sharding_rules is not None
              and (mesh.shape[mesh_lib.MODEL_AXIS] > 1
                   or mesh.shape[mesh_lib.EXPERT_AXIS] > 1))
    if FLAGS.trainable_params:
        # Selective fine-tuning: only matching parameters train, and the
        # optimizer is re-initialized so frozen ones carry no slots.
        from .training.optimizers import freeze_except
        from .training.state import apply_freeze, checkpoint_tree
        tx, n_train, n_total = freeze_except(
            state.optimizer.spec, checkpoint_tree(state)["params"],
            FLAGS.trainable_params)
        apply_freeze(state, tx)
        print(f"Worker {task}: --trainable_params="
              f"{FLAGS.trainable_params!r} trains {n_train:,} of "
              f"{n_total:,} parameters")
    use_pipe = FLAGS.pipeline_parallel > 1
    if FLAGS.ema_decay > 0:
        if stateful or use_pipe:
            raise ValueError(
                "--ema_decay supports the plain/scanned/accumulating sync "
                "steps only (not stateful models or pipeline mode)")
        # Seed the average at a copy of the initial weights.
        state.ema_params = {n: p.detach().clone()
                            for n, p in state.model.named_parameters()}
    if FLAGS.fsdp:
        if cross:
            raise mesh_lib.cross_process_error(
                f"--fsdp beside the {'/'.join(cross)} axis")
        if bundle.place_state is not None or use_pipe:
            raise ValueError(
                "--fsdp is incompatible with models that own their placement "
                "(--pipeline_parallel stages shard over the 'pipe' axis)")
        # Only a genuinely async TRAINING run is rejected (eval mode only
        # restores the placed state; TP forces the sync path).
        if (FLAGS.mode == "train" and not FLAGS.sync_replicas and not use_tp
                and not stateful):
            raise ValueError(
                "--fsdp requires sync mode: async replicas hold independent "
                "full parameter copies by design")
    # Async replicas are the local data rows themselves (R of them, each
    # on its row's device): the state is placed on row 0 and converted.
    async_training = FLAGS.mode == "train" and not (
        FLAGS.sync_replicas or use_tp or use_pipe or stateful)
    row_devices = [mesh.row(r).model_devices()[0] for r in range(local_data)]
    place_mesh = mesh.row(0) if async_training else mesh
    if bundle.place_state is not None:
        state = bundle.place_state(place_mesh, state)
    else:
        # The layout's placement: FSDP over the data axis (the workers'
        # process group times the local rows), else the bundle's rules
        # over the model axis, else replicated (one set of tensors a data
        # row, on its first position).
        state = pcfg.place_state(place_mesh, state, bundle.sharding_rules)
    if FLAGS.log_sharding:
        _log_placement(task, state)

    datasets = bundle.load_datasets(FLAGS.data_dir)
    if FLAGS.feed_dtype == "uint8":
        import numpy as np
        images = getattr(datasets.train, "images", None)
        if not (isinstance(images, np.ndarray)
                and images.dtype == np.float32):
            raise ValueError(
                f"--feed_dtype=uint8 applies to the image models "
                f"(float image pipelines); --model={FLAGS.model} feeds "
                f"{type(datasets.train).__name__} batches")
        from .data.datasets import uint8_feed
        datasets = uint8_feed(datasets)
    eval_fn = bundle.make_eval_fn()
    if is_fsdp(state.model):
        # The split parameters gathered whole for an evaluation (every
        # worker evaluates at the same steps: a collective).
        sharded_eval = eval_fn

        def eval_fn(st, split, _base=sharded_eval):
            with fsdp_gathered(st):
                return _base(st, split)
    if FLAGS.ema_decay > 0:
        # Evaluate the averaged weights (validation AND the final test).
        raw_eval = eval_fn

        def eval_fn(st, split, _base=raw_eval):
            with parameters_swapped(st.model, st.ema_params):
                return _base(st, split)

    if FLAGS.mode == "eval":
        # Restore the newest checkpoint into the state this run's flags
        # build, then report validation + test accuracy in the reference's
        # output shape.
        sv = Supervisor(is_chief=True,
                        logdir=os.path.join(FLAGS.logdir, bundle.name),
                        init_fn=lambda: state)
        try:
            if sv.latest_step() is None:
                print(f"WARNING: no checkpoint found under "
                      f"{os.path.join(sv.logdir, 'checkpoints')}; "
                      "evaluating the fresh initialization")
            try:
                state = sv.prepare_or_wait_for_state()
            except ValueError as e:
                raise ValueError(
                    "--mode=eval could not restore the checkpoint: its "
                    "structure does not match the state this run's flags "
                    "build. Common causes: flags differing from the "
                    "training run (--optimizer, --ema_decay, model-size "
                    "flags), or an async run's per-replica checkpoint") from e
            validation_accuracy = eval_fn(state, datasets.validation)
            test_accuracy = eval_fn(state, datasets.test)
        finally:
            sv.close()
            server.shutdown()
        restored_step = int(state.global_step)
        print(f"Worker {task}: restored global step {restored_step}")
        print(f"Worker {task}: validation accuracy {validation_accuracy:g}")
        print(f"Worker {task}: test accuracy {test_accuracy:g}")
        print(f"Worker {task}: kernel launches "
              f"{json.dumps(_kernel_launches())}")
        return {"global_step": restored_step,
                "validation_accuracy": validation_accuracy,
                "test_accuracy": test_accuracy}

    # R is counted in worker tasks (reference distributed.py:92-99): a
    # worker's local data rows are its replicas, held by its process under
    # a process group, or every task's by a worker that trains alone (its
    # batch split into one shard a replica, as the JAX single-controller
    # worker shards its batch over its devices).
    ranks = mesh.ranks
    all_reduce = (sync_lib.GradientAllReduce(
        group=ranks.group("grad") if ranks is not None else None,
        slice_groups=server.slice_groups,
        partials=ranks.seq_parts if ranks is not None else 1)
                  if server.process_group else None)
    if ranks is not None and server.mesh_groups["grad"] == [task]:
        # A pipe rank alone on its data line: nothing to sum.
        all_reduce = None
    # The feed's processes are the data coordinates: ranks that share one
    # (the seq and pipe ranks of a data row) load the same rows.
    data_ranks = (ranks.shape[mesh_lib.DATA_AXIS] // local_data
                  if ranks is not None else world)
    data_rank = (ranks.coords[mesh_lib.DATA_AXIS] // local_data
                 if ranks is not None else task)
    coord = server.coordination_client
    # Late-bound elastic-membership context: the masked-sync replica mask
    # reads the watcher from here once it exists (built after the
    # supervisor, the mask function before it).
    elastic_ctx: dict = {"watcher": None}
    replicas_to_aggregate = sync_lib.resolve_replicas_to_aggregate(
        FLAGS.replicas_to_aggregate, num_workers)
    if use_pipe and not FLAGS.sync_replicas:
        print(f"Worker {task}: pipeline parallelism requires lockstep "
              "replicas; async mode unsupported — using sync.")
    if use_tp and not FLAGS.sync_replicas:
        print(f"Worker {task}: tensor parallelism requires lockstep "
              "replicas; async mode unsupported — using sync.")
    # Models with non-trainable state (BatchNorm) train sync, as in JAX.
    sync_mode = FLAGS.sync_replicas or use_tp or use_pipe or stateful
    use_masked = (sync_mode and not use_tp and not use_pipe and not stateful
                  and replicas_to_aggregate < num_workers and coord is not None)
    if use_masked and cross:
        raise mesh_lib.cross_process_error(
            f"R<N masked sync beside the {'/'.join(cross)} axis")
    if use_masked and FLAGS.ema_decay > 0:
        raise ValueError("--ema_decay with R<N masked sync is unsupported")
    if use_masked and FLAGS.fsdp:
        raise ValueError(
            "--fsdp with R<N masked sync is unsupported (the masked "
            "step's shard_map expects replicated parameters); use "
            "--replicas_to_aggregate equal to the worker count")
    if use_masked and FLAGS.steps_per_call > 1:
        raise ValueError(
            "--steps_per_call > 1 is incompatible with R<N masked sync "
            "(the replica mask is sampled per step)")
    if use_masked and bundle.needs_rng:
        raise ValueError(
            "--bert_dropout with R<N masked sync is unsupported; use "
            "--replicas_to_aggregate equal to the worker count")
    if FLAGS.steps_per_call > 1 and FLAGS.grad_accum_steps > 1:
        raise ValueError("--steps_per_call and --grad_accum_steps are "
                         "exclusive")
    if FLAGS.log_grad_norm and (use_masked or stateful):
        print(f"Worker {task}: --log_grad_norm is not available on the "
              + ("masked (R<N)" if use_masked else "stateful (BatchNorm)")
              + " sync path — ignoring")
    replica_mask_fn = None
    async_mode_active = False
    if not sync_mode:
        if FLAGS.ema_decay > 0:
            raise ValueError("--ema_decay requires sync mode")
        if (FLAGS.steps_per_call > 1
                and FLAGS.steps_per_call != FLAGS.async_sync_period):
            raise ValueError(
                f"--steps_per_call={FLAGS.steps_per_call} in async mode must "
                f"equal --async_sync_period={FLAGS.async_sync_period}: each "
                "dispatch scans one full sync period (local steps + merge)")
        if FLAGS.grad_accum_steps > 1:
            raise ValueError("--grad_accum_steps > 1 requires sync mode")
        if bundle.needs_rng:
            raise ValueError(
                "--bert_dropout requires sync mode (async replica steps "
                "are rng-free)")
        if FLAGS.log_grad_norm:
            raise ValueError(
                "--log_grad_norm requires sync mode (async replicas step "
                "independently; there is no single global gradient)")
        from .parallel.async_replicas import (
            build_async_train_step, build_scanned_async_train_step,
            consensus_model)
        async_mode_active = True
        # One replica a local data row, on the row's device: the workers
        # average across processes through the coordination service
        # below.
        if FLAGS.steps_per_call > 1:
            train_step, state = build_scanned_async_train_step(
                bundle.loss_fn, state, num_replicas=local_data,
                sync_period=FLAGS.async_sync_period, devices=row_devices)
        else:
            train_step, state = build_async_train_step(
                bundle.loss_fn, state, num_replicas=local_data,
                sync_period=FLAGS.async_sync_period, devices=row_devices)
        # Evaluate the consensus mean of the replicas.
        base_eval = eval_fn

        def eval_fn(astate, split, _base=base_eval):
            with consensus_model(astate):
                return _base(astate, split)
    elif use_masked:
        # Per-task health bits (cached by a background poller: no TCP on
        # the hot path), each task's bit for its local data rows' replicas.
        # Health drops dead workers
        # and, with --straggler_lag, slow-but-alive ones behind the
        # front-runner; with elastic membership the mask is ANDed with the
        # membership watcher's active set.
        import numpy as np
        coord.start_health_polling(interval=1.0, num_tasks=num_workers,
                                   straggler_lag=FLAGS.straggler_lag)
        train_step = sync_lib.build_masked_sync_train_step(
            bundle.loss_fn, num_workers * local_data, all_reduce=all_reduce,
            rank=task if server.process_group else 0)
        last_mask = [None]
        mask_progress = {"base": 0, "n": 0}

        def replica_mask_fn():
            mask_progress["n"] += 1
            coord.set_progress(mask_progress["base"] + mask_progress["n"])
            watcher = elastic_ctx.get("watcher")
            mask = sync_lib.replica_mask_from_tasks(
                coord.cached_health(), num_workers, local_data,
                members=(watcher.active_mask(num_workers)
                         if watcher is not None else None))
            if last_mask[0] is None or not np.array_equal(mask, last_mask[0]):
                print(f"Worker {task}: live replica mask "
                      f"{mask.astype(int).tolist()}")
                last_mask[0] = mask.copy()
            return mask
    elif stateful:
        if not FLAGS.sync_replicas:
            print(f"Worker {task}: model {FLAGS.model} has non-trainable "
                  "state; async mode unsupported — using sync.")
        if FLAGS.steps_per_call > 1:
            train_step = sync_lib.build_scanned_stateful_sync_train_step(
                bundle.stateful_loss_fn, num_steps=FLAGS.steps_per_call,
                all_reduce=all_reduce)
        else:
            train_step = sync_lib.build_stateful_sync_train_step(
                bundle.stateful_loss_fn, all_reduce=all_reduce)
    elif FLAGS.steps_per_call > 1:
        train_step = sync_lib.build_scanned_sync_train_step(
            bundle.loss_fn, num_steps=FLAGS.steps_per_call,
            needs_rng=bundle.needs_rng, ema_decay=FLAGS.ema_decay,
            log_grad_norm=FLAGS.log_grad_norm, all_reduce=all_reduce)
    elif FLAGS.grad_accum_steps > 1:
        train_step = sync_lib.build_accumulating_sync_train_step(
            bundle.loss_fn, accum_steps=FLAGS.grad_accum_steps,
            needs_rng=bundle.needs_rng, ema_decay=FLAGS.ema_decay,
            log_grad_norm=FLAGS.log_grad_norm, all_reduce=all_reduce)
    elif bundle.train_step_builder is not None:
        # The model supplies its own step (the 1F1B and interleaved
        # pipelines' hand-rolled backward).
        train_step = bundle.train_step_builder(
            mesh, all_reduce=all_reduce, log_grad_norm=FLAGS.log_grad_norm)
    else:
        train_step = sync_lib.build_sync_train_step(
            bundle.loss_fn, needs_rng=bundle.needs_rng,
            ema_decay=FLAGS.ema_decay, log_grad_norm=FLAGS.log_grad_norm,
            all_reduce=all_reduce)

    if coord is not None:
        from .cluster.coordination import CoordinationError
        try:
            # A single worker must not hang on an absent coordinator (the
            # reference's config #1, "1 host, no PS").
            coord.register(timeout=5.0 if num_workers == 1 else 120.0)
            coord.start_heartbeats()
            if coord.restarts:
                print(f"Worker {task}: rejoined coordination service "
                      f"(restart #{coord.restarts}); restoring from the last "
                      "good checkpoint")
        except CoordinationError:
            if num_workers > 1:
                raise
            print(f"Worker {task}: no coordination service at "
                  f"{cluster.coordinator_address}; running standalone.")
            coord.close()
            coord = None

    if chief:
        print(f"Worker {task}: Initailizing session...")
    else:
        print(f"Worker {task}: Waiting for session to be initaialized...")

    init_state = state
    # Namespace checkpoints per model: a shared logdir must never restore
    # one model's tree into another's.
    sv = Supervisor(
        is_chief=chief, logdir=os.path.join(FLAGS.logdir, bundle.name),
        init_fn=lambda: init_state, recovery_wait_secs=1,
        save_interval_steps=FLAGS.save_interval_steps,
        coordination_client=coord,
        max_to_keep=FLAGS.max_checkpoints_to_keep)
    state = sv.prepare_or_wait_for_state()
    print(f"Worker {task}: Session initialization  complete.")
    if replica_mask_fn is not None:
        # Progress heartbeats count from the restored step, so a rejoining
        # worker is not taken for a straggler while it resumes.
        mask_progress["base"] = int(state.global_step)

    elastic_controller = _elastic_controller(
        coord, sv, elastic_ctx, num_workers, chief,
        masked_single=(replica_mask_fn is not None
                       and not server.process_group),
        multi_process_sync=server.process_group and FLAGS.sync_replicas)

    finalize_async = averager = None
    if async_mode_active and num_workers > 1 and coord is not None:
        train_step, averager, finalize_async = _async_exchange(
            state, train_step, coord, num_workers)

    step_cache = getattr(train_step, "cache", {})   # an FSDP step's
    if FLAGS.inject_step_delay:
        train_step = _step_delay(FLAGS.inject_step_delay, train_step)

    log_every, validation_every = FLAGS.log_every, FLAGS.validation_every
    if FLAGS.steps_per_call > 1:
        # Chunked stepping can only log/validate at chunk boundaries.
        k = FLAGS.steps_per_call
        rounded = tuple(((n + k - 1) // k) * k if n else 0
                        for n in (log_every, validation_every))
        if rounded != (log_every, validation_every):
            print(f"Worker {task}: rounding log_every {log_every}->"
                  f"{rounded[0]}, validation_every {validation_every}->"
                  f"{rounded[1]} to --steps_per_call={k} chunk boundaries")
            log_every, validation_every = rounded

    if server.process_group and FLAGS.batch_size % data_ranks:
        # --batch_size is global: each data coordinate trains on its share.
        raise ValueError(f"--batch_size={FLAGS.batch_size} must divide "
                         f"over the {data_ranks} workers of the process "
                         "group")

    metrics_path = FLAGS.metrics_file
    if metrics_path and num_workers > 1:
        # One file per process: concurrent appends would interleave.
        metrics_path = f"{metrics_path}.task{task}"
    metrics_logger = MetricsLogger(metrics_path,
                                   static_fields={"worker": task})
    telemetry = None
    health_reporter = None
    if metrics_path and FLAGS.telemetry:
        from .utils import tracing as tracing_lib
        from .utils.telemetry import SCHEMA_VERSION, Telemetry
        n_params = sum(p.numel() for p in state.model.parameters())
        seq_tokens = FLAGS.model == "gpt_mini"
        tokens = FLAGS.batch_size * (FLAGS.bert_seq_len if seq_tokens else 1)
        if seq_tokens:
            cfg = state.model.cfg
            flops_per_step = profiling.train_step_flops(
                n_params, tokens, num_layers=cfg.num_layers,
                hidden_size=cfg.hidden_size, seq_len=FLAGS.bert_seq_len,
                window=FLAGS.attention_window)
        else:
            flops_per_step = profiling.train_step_flops(n_params, tokens)
        if FLAGS.grad_accum_steps > 1:
            flops_per_step *= FLAGS.grad_accum_steps
        per_device = (FLAGS.peak_tflops * 1e12 if FLAGS.peak_tflops > 0
                      else profiling.peak_flops_per_device(device))
        peak = (None if per_device is None
                else per_device * world * len(set(positions)))
        telemetry = Telemetry(metrics_logger, flops_per_step=flops_per_step,
                              peak_flops_per_sec=peak)
        telemetry.enable_flight_recorder(metrics_path + ".flight")
        run_id = os.path.basename(os.path.normpath(FLAGS.logdir)) or "run"
        tracing_lib.install(tracing_lib.Tracer(telemetry, run_id=run_id))
        sv.attach_telemetry(telemetry)
        if averager is not None:
            # Per-period kind="param_exchange" records (bytes on the wire,
            # compression ratio, residual) and the exchange gauges.
            averager.attach_telemetry(telemetry)
        if elastic_controller is not None:
            elastic_controller.attach_telemetry(telemetry)
            elastic_ctx["watcher"].set_step_fn(
                lambda: max(coord._progress_step, 0))
        if faults.active() is not None:
            faults.active().attach_telemetry(telemetry)
        if coord is not None and coord.restarts:
            telemetry.emit("recovery", step=int(state.global_step),
                           action="rejoin", restarts=coord.restarts)
        telemetry.emit(
            "run_meta", schema_version=SCHEMA_VERSION, model=FLAGS.model,
            n_params=n_params, batch_size=FLAGS.batch_size,
            tokens_per_step=tokens, flops_per_step=flops_per_step,
            peak_flops_per_sec=peak,
            device_kind=(torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
            n_devices=world, process_index=task if server.process_group else 0,
            process_count=world, steps_per_call=FLAGS.steps_per_call,
            grad_accum_steps=FLAGS.grad_accum_steps,
            backend=server.backend)
        if coord is not None:
            from .cluster.coordination import (ClusterHealthReporter,
                                               CoordinationError)
            coord.attach_telemetry(telemetry)
            try:
                offset_s, rtt_s = coord.clock_offset()
                telemetry.emit(
                    "clock_sync", step=0,
                    offset_ms=round(offset_s * 1000.0, 3),
                    rtt_ms=round(rtt_s * 1000.0, 3),
                    t_unix=round(time.time(), 6), source="coord_time")
            except CoordinationError:
                pass  # no alignment beats no run
            if FLAGS.health_report_every > 0:
                health_reporter = ClusterHealthReporter(
                    coord, telemetry, num_tasks=num_workers,
                    interval=FLAGS.health_report_every)
                health_reporter.set_step_fn(
                    lambda: max(coord._progress_step, 0))
                health_reporter.start()
    stat_publish_fn = None
    if telemetry is not None and coord is not None:
        from .cluster.coordination import CoordinationError as _CoordErr

        def stat_publish_fn(payload, _coord=coord):
            try:
                _coord.stat_put(payload)
            except (_CoordErr, ValueError):
                pass

    summary_writer = (SummaryWriter(FLAGS.summary_dir)
                      if FLAGS.summary_dir and chief else None)
    summary_ctx = summary_writer or contextlib.nullcontext()
    profile_ctx = contextlib.nullcontext()
    if FLAGS.profile_dir:
        profile_dir = (os.path.join(FLAGS.profile_dir, f"task{task}")
                       if num_workers > 1 else FLAGS.profile_dir)
        profile_ctx = profiling.trace(profile_dir, device)
    shutdown_ctx = (ShutdownSignal() if FLAGS.graceful_shutdown
                    else contextlib.nullcontext())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        with profile_ctx, metrics_logger, summary_ctx, \
                shutdown_ctx as shutdown:
            if shutdown is not None and telemetry is not None:
                shutdown.add_callback(lambda: telemetry.dump_flight(
                    reason=f"signal:{shutdown.signal_name}"))
            state, result = run_training_loop(
                state=state, train_step=train_step, datasets=datasets,
                batch_size=FLAGS.batch_size, train_steps=FLAGS.train_steps,
                eval_fn=eval_fn, device=device, task_index=task,
                sharded_feed=FLAGS.sharded_feed, mesh=mesh,
                process_count=data_ranks if server.process_group else 1,
                process_index=data_rank if server.process_group else 0,
                devices=row_devices,
                validation_every=validation_every, log_every=log_every,
                supervisor=sv, replica_mask_fn=replica_mask_fn,
                metrics_logger=metrics_logger, telemetry=telemetry,
                summary_writer=summary_writer,
                summary_histograms=FLAGS.summary_histograms,
                lr_fn=schedule_from_flags(FLAGS),
                steps_per_call=FLAGS.steps_per_call,
                accum_steps=FLAGS.grad_accum_steps,
                prefetch=FLAGS.prefetch, shutdown=shutdown,
                stat_publish_fn=stat_publish_fn, elastic=elastic_controller)
    except BaseException as e:
        if telemetry is not None:
            telemetry.dump_flight(reason=f"fatal:{type(e).__name__}")
        raise
    finally:
        if health_reporter is not None:
            health_reporter.close()
        if elastic_ctx["watcher"] is not None:
            elastic_ctx["watcher"].close()
        if telemetry is not None:
            from .utils import tracing as _tracing
            _tracing.clear()
    if finalize_async is not None:
        # Collect the in-flight background exchange, so the saved
        # parameters carry the last consensus pull, and save it.
        state = finalize_async(state)
        sv.maybe_save(state, force=True)
    if all_reduce is not None and all_reduce.calls:
        ms = all_reduce.seconds * 1e3 / all_reduce.calls
        print(f"Worker {task}: all-reduce {ms:.4f} ms a call over "
              f"{server.backend}, {all_reduce.calls} calls after the first "
              f"({all_reduce.first_seconds * 1e3:.1f} ms), "
              f"{all_reduce.seconds / max(result.train_time, 1e-9):.4f} of "
              "the training time")
    fsdp_step = step_cache.get("fsdp")
    if fsdp_step is not None and fsdp_step.exchange.calls:
        ex = fsdp_step.exchange
        print(f"Worker {task}: fsdp all-gather "
              f"{ex.gather_s * 1e3 / ex.calls:.4f} ms, reduce-scatter "
              f"{ex.scatter_s * 1e3 / ex.calls:.4f} ms a step over "
              f"{server.backend or 'this process'} ({len(ex.entries)} "
              "split parameters)")
    if device.type == "cuda":
        print(f"Worker {task}: peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} GiB")
    print(f"Worker {task}: kernel launches {json.dumps(_kernel_launches())}")
    if async_mode_active:
        with consensus_model(state) as model:
            digest = _parameter_digest(model)
    else:
        with fsdp_gathered(state):
            digest = _parameter_digest(state.model)
    print(f"Worker {task}: parameter digest {digest}")
    if getattr(state, "model_state", None) is not None:
        # BatchNorm's running statistics: bit-equal across sync workers.
        print(f"Worker {task}: model state digest "
              f"{_digest(state.model_state)}")
    sv.close()
    server.shutdown()
    return result


if __name__ == "__main__":
    app.run(main)
