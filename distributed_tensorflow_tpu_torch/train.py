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
``mnist_mlp`` (the reference model) or ``gpt_mini``; with
``--attention_backend=pallas --fused_layer_norm`` the gpt_mini trainer
runs the flash-attention (K1, K2a/K2b) and LayerNorm (K3) kernels.

Every flag of the JAX ``train.py`` is declared, so a JAX command line
parses; the port adds ``--device`` (default ``cuda``, which raises without
a card) in place of ``--platform``.  Not ported yet (each raises
``NotImplementedError`` naming ROADMAP.md's entry): the parallelism flags
(item 6); the other models, the BPE tokenizer, ``--gen_prompt_text`` and
``--gen_stop_text`` (item 7); ``--profile`` run profiles (item 8).
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
                    "run's saved tokenizer (not ported yet)")
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
                    "Stop STRING for --mode=generate text output (needs "
                    "the run's tokenizer; not ported yet)")
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
                    "Model/workload: mnist_mlp | gpt_mini (lenet5, "
                    "resnet20, vit_tiny, bert_tiny and bert_moe are not "
                    "ported yet); --mode=generate needs gpt_mini")
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
                     "A pipelined run's pipe size (its checkpoint "
                     "namespace)")
flags.DEFINE_integer("pipeline_virtual_stages", 2,
                     "An interleaved run's virtual stages (its namespace "
                     "and tree layout)")
flags.DEFINE_string("pipeline_schedule", "gpipe",
                    "A pipelined run's schedule: gpipe | 1f1b | interleaved")
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
                    "torch device: cuda (worker i takes card i modulo the "
                    "card count; raises without a card), cuda:N, or cpu "
                    "for a CPU run; the port's --platform")


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
                    "(needs --sequence_parallel, not ported in the CLI)")
flags.DEFINE_boolean("gpt_matmul_int8", False,
                     "Train gpt_mini's MLP through the int8 matmul kernels")
flags.DEFINE_boolean("gpt_attn_int8", False,
                     "Also route gpt_mini's attention projections through "
                     "the int8 path")
flags.DEFINE_boolean("fused_layer_norm", False,
                     "Route transformer LayerNorms through the LayerNorm "
                     "kernel")
flags.DEFINE_string("gpt_tokenizer", "byte",
                    "gpt_mini corpus tokenizer: byte | bpe (not ported yet)")
flags.DEFINE_integer("gpt_stream_corpus_mb", 256,
                     "Corpus size (MB) above which the LM corpus streams "
                     "(not ported yet)")
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
_UNPORTED_FLAGS = (
    ("integer", "tensor_parallel", 1, "item 6"),
    ("integer", "sequence_parallel", 1, "item 6"),
    ("integer", "pipeline_microbatches", 4, "item 6"),
    ("boolean", "sharded_feed", True, "item 6"),
    ("boolean", "fsdp", False, "item 6"),
    ("integer", "fsdp_min_size", 65536, "item 6"),
    ("integer", "dcn_data_parallel", 1, "item 6"),
    ("integer", "expert_parallel", 1, "item 6"),
    ("integer", "num_experts", 4, "item 7"),
    ("boolean", "data_augmentation", False, "item 7"),
    ("integer", "gpt_bpe_vocab", 512, "item 7"),
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
    for flag in ("gen_prompt_text", "gen_stop_text"):
        if getattr(FLAGS, flag):
            raise _not_ported(f"--{flag} (the run's BPE tokenizer, "
                              "data/tokenizer.py)", "item 7")
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

    if FLAGS.gen_prompt:
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
    print(f"Restored global step: {restored_step}")
    print(f"Prompt tokens:    {' '.join(map(str, toks[:split]))}")
    print(f"Generated tokens: {' '.join(map(str, gen))}")
    return toks


def _parameter_digest(model: torch.nn.Module) -> str:
    """sha256 over every parameter's bytes in name order: equal digests
    mean bit-equal parameters."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
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
            "quant_matmul_nt": qmm.nt_launches}


def _check_unported_flags() -> None:
    for _, name, default, where in _UNPORTED_FLAGS:
        if getattr(FLAGS, name) != default:
            raise _not_ported(f"--{name}", where)


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
        # derives the same owner map.  --dcn_data_parallel is not ported,
        # so the auto slice size sees one DCN slice.
        slice_size = (FLAGS.slice_size if FLAGS.slice_size > 0
                      else auto_slice_size(num_workers, 1))
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
    from .cluster.server import Server, worker_device
    from .cluster.spec import ClusterSpec, is_chief
    from .models import registry
    from .parallel import sync as sync_lib
    from .parallel.mesh import ParallelConfig
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
    if FLAGS.async_mode != "local_sgd":
        raise ValueError(f"--async_mode must be local_sgd, got "
                         f"{FLAGS.async_mode!r}")
    # One declarative layout; only the data axis is ported.
    pcfg = ParallelConfig.from_flags(FLAGS)

    cluster = ClusterSpec({"ps": FLAGS.ps_hosts, "worker": FLAGS.worker_hosts})
    num_workers = cluster.num_workers
    device = (worker_device(FLAGS.device, FLAGS.task_index)
              if FLAGS.job_name == "worker" else None)
    # Async workers meet only at the coordination service, never in a
    # collective (reference distributed.py:102,145): a process group would
    # tie their independent cadences together.
    server = Server(cluster, FLAGS.job_name, FLAGS.task_index, device=device,
                    initialize_distributed=(
                        None if FLAGS.mode == "train" and FLAGS.sync_replicas
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

    bundle = registry.build(FLAGS.model, FLAGS, device)
    state = bundle.state
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
    if FLAGS.log_sharding:
        for name, p in state.model.named_parameters():
            print(f"Worker {task}: param {name.replace('.', '/')} "
                  f"{tuple(p.shape)} -> replicated on {p.device}")
    if FLAGS.ema_decay > 0:
        # Seed the average at a copy of the initial weights.
        state.ema_params = {n: p.detach().clone()
                            for n, p in state.model.named_parameters()}

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

    # R is counted in worker tasks (reference distributed.py:92-99): one
    # data replica a worker, held by its process under a process group, or
    # all of them by a worker that trains alone (its batch split into one
    # shard a task, as the JAX single-controller worker shards its batch
    # over its devices).
    all_reduce = (sync_lib.GradientAllReduce() if server.process_group
                  else None)
    coord = server.coordination_client
    # Late-bound elastic-membership context: the masked-sync replica mask
    # reads the watcher from here once it exists (built after the
    # supervisor, the mask function before it).
    elastic_ctx: dict = {"watcher": None}
    replicas_to_aggregate = sync_lib.resolve_replicas_to_aggregate(
        FLAGS.replicas_to_aggregate, num_workers)
    use_masked = (FLAGS.sync_replicas
                  and replicas_to_aggregate < num_workers and coord is not None)
    if use_masked and FLAGS.ema_decay > 0:
        raise ValueError("--ema_decay with R<N masked sync is unsupported")
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
    if FLAGS.log_grad_norm and use_masked:
        print(f"Worker {task}: --log_grad_norm is not available on the "
              "masked (R<N) sync path — ignoring")
    replica_mask_fn = None
    async_mode_active = False
    if not FLAGS.sync_replicas:
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
        # One replica a task (the port's rule): the workers average across
        # processes through the coordination service below.
        if FLAGS.steps_per_call > 1:
            train_step, state = build_scanned_async_train_step(
                bundle.loss_fn, state, num_replicas=1,
                sync_period=FLAGS.async_sync_period)
        else:
            train_step, state = build_async_train_step(
                bundle.loss_fn, state, num_replicas=1,
                sync_period=FLAGS.async_sync_period)
        # Evaluate the consensus mean of the replicas.
        base_eval = eval_fn

        def eval_fn(astate, split, _base=base_eval):
            with consensus_model(astate):
                return _base(astate, split)
    elif use_masked:
        # Per-task health bits (cached by a background poller: no TCP on
        # the hot path), one replica a task.  Health drops dead workers
        # and, with --straggler_lag, slow-but-alive ones behind the
        # front-runner; with elastic membership the mask is ANDed with the
        # membership watcher's active set.
        import numpy as np
        coord.start_health_polling(interval=1.0, num_tasks=num_workers,
                                   straggler_lag=FLAGS.straggler_lag)
        train_step = sync_lib.build_masked_sync_train_step(
            bundle.loss_fn, num_workers, all_reduce=all_reduce,
            rank=task if server.process_group else 0)
        last_mask = [None]
        mask_progress = {"base": 0, "n": 0}

        def replica_mask_fn():
            mask_progress["n"] += 1
            coord.set_progress(mask_progress["base"] + mask_progress["n"])
            watcher = elastic_ctx.get("watcher")
            mask = sync_lib.replica_mask_from_tasks(
                coord.cached_health(), num_workers, 1,
                members=(watcher.active_mask(num_workers)
                         if watcher is not None else None))
            if last_mask[0] is None or not np.array_equal(mask, last_mask[0]):
                print(f"Worker {task}: live replica mask "
                      f"{mask.astype(int).tolist()}")
                last_mask[0] = mask.copy()
            return mask
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

    feed_split, feed_batch_size = datasets.train, FLAGS.batch_size
    if server.process_group:
        # --batch_size is global: each rank feeds its share from its own
        # strided shard of the train split.
        if FLAGS.batch_size % world:
            raise ValueError(f"--batch_size={FLAGS.batch_size} must divide "
                             f"over the {world} workers of the process group")
        feed_split = feed_split.shard(task, world)
        feed_batch_size = FLAGS.batch_size // world
        print(f"Worker {task}: sharded feed — this process loads "
              f"{feed_batch_size}/{FLAGS.batch_size} examples per step")

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
        peak = None if per_device is None else per_device * world
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
                feed_split=feed_split, feed_batch_size=feed_batch_size,
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
    if device.type == "cuda":
        print(f"Worker {task}: peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} GiB")
    print(f"Worker {task}: kernel launches {json.dumps(_kernel_launches())}")
    if async_mode_active:
        with consensus_model(state) as model:
            digest = _parameter_digest(model)
    else:
        digest = _parameter_digest(state.model)
    print(f"Worker {task}: parameter digest {digest}")
    sv.close()
    server.shutdown()
    return result


if __name__ == "__main__":
    app.run(main)
