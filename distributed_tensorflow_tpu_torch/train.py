"""The command-line entry point, the counterpart of
``distributed_tensorflow_tpu/train.py``; so far ``--mode=generate`` only::

    python -m distributed_tensorflow_tpu_torch.train --mode=generate \\
        --logdir <run> [--gen_prompt 1,2,3] [--gen_tokens 32] \\
        [--gen_beams N | --gen_speculative K] [--device cpu]

It restores the newest checkpoint under ``<logdir>/<namespace>/
checkpoints`` (one the JAX trainer or :func:`.tools.checkpoint_io.
save_raw` wrote) and decodes with the port's decode family
(:mod:`.models.gpt`) on the hand-written kernels: flash attention (K1)
over the prompt and the LayerNorm kernel (K3) in every LayerNorm.  It
prints the JAX CLI's lines (``Restored global step:``, ``Prompt
tokens:``, ``Generated tokens:``, and the beam or speculative line).

Every flag of the JAX ``train.py`` is declared, so a JAX command line
parses; the port adds ``--device`` (default ``cuda``, which raises without
a card) in place of ``--platform``.  Not ported yet (each raises
``NotImplementedError``, see ROADMAP.md, section 1): ``--mode=train`` and
``--mode=eval`` (the PS/worker trainer, slice 7), and
``--gen_prompt_text`` / ``--gen_stop_text`` (the run's BPE tokenizer,
item 7; a run's ``tokenizer.json`` is not read, so no ``Generated text:``
line is printed).  The flags of the modes not ported yet are parsed and
unused.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .config import app, define_training_flags, flags

FLAGS = define_training_flags()
flags.DEFINE_string("mode", "train",
                    "train, eval or generate; only generate is ported: "
                    "decode --gen_tokens tokens from a seed prompt "
                    "(gpt_mini only)")
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
                    "Model/workload; --mode=generate needs gpt_mini")
flags.DEFINE_string("logdir", "/tmp/dtf_tpu_train",
                    "Run directory: checkpoints under "
                    "<logdir>/<model namespace>/checkpoints")
flags.DEFINE_integer("bert_seq_len", 128,
                     "Sequence length of the stream-sampled default prompt "
                     "(half of it)")
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
                     "Seed of the random init without a checkpoint, of the "
                     "default prompt and of sampling")
flags.DEFINE_string("device", "cuda",
                    "torch device (cuda raises without a card; cpu for a "
                    "CPU run); the port's --platform")

# The JAX train.py's other flags (train and eval modes, not ported yet):
# declared so its command lines parse, and unused.
_UNPORTED_FLAGS = (
    ("integer", "save_interval_steps", 1000),
    ("integer", "max_checkpoints_to_keep", 3),
    ("integer", "log_every", 1),
    ("integer", "validation_every", 10000),
    ("string", "async_mode", "local_sgd"),
    ("integer", "async_sync_period", 16),
    ("boolean", "async_overlap_exchange", False),
    ("string", "async_compress", "off"),
    ("integer", "async_anchor_every", 8),
    ("integer", "async_quant_block", 1024),
    ("integer", "slice_size", 0),
    ("string", "coord_standbys", ""),
    ("integer", "coord_instances", 1),
    ("float", "bert_dropout", 0.0),
    ("boolean", "remat", False),
    ("integer", "tensor_parallel", 1),
    ("integer", "sequence_parallel", 1),
    ("integer", "pipeline_microbatches", 4),
    ("boolean", "sharded_feed", True),
    ("boolean", "fsdp", False),
    ("integer", "fsdp_min_size", 65536),
    ("integer", "dcn_data_parallel", 1),
    ("integer", "expert_parallel", 1),
    ("integer", "num_experts", 4),
    ("string", "attention_backend", "xla"),
    ("string", "gpt_tokenizer", "byte"),
    ("integer", "gpt_bpe_vocab", 512),
    ("integer", "gpt_stream_corpus_mb", 256),
    ("boolean", "gpt_matmul_int8", False),
    ("boolean", "gpt_attn_int8", False),
    ("float", "label_smoothing", 0.0),
    ("boolean", "data_augmentation", False),
    ("boolean", "log_grad_norm", False),
    ("boolean", "fused_layer_norm", False),
    ("string", "optimizer", ""),
    ("string", "trainable_params", ""),
    ("float", "momentum", 0.9),
    ("float", "weight_decay", 0.0),
    ("string", "lr_schedule", "constant"),
    ("integer", "warmup_steps", 0),
    ("integer", "decay_steps", 0),
    ("float", "end_lr_factor", 0.0),
    ("float", "grad_clip_norm", 0.0),
    ("float", "heartbeat_timeout", 10.0),
    ("string", "elastic_mode", "auto"),
    ("integer", "elastic_reshard_margin", 20),
    ("integer", "straggler_lag", 0),
    ("string", "inject_step_delay", ""),
    ("integer", "steps_per_call", 1),
    ("integer", "grad_accum_steps", 1),
    ("float", "ema_decay", 0.0),
    ("boolean", "log_sharding", False),
    ("boolean", "graceful_shutdown", True),
    ("integer", "prefetch", 2),
    ("string", "feed_dtype", "float32"),
    ("string", "metrics_file", None),
    ("boolean", "telemetry", True),
    ("float", "peak_tflops", 0.0),
    ("float", "health_report_every", 10.0),
    ("string", "summary_dir", None),
    ("boolean", "summary_histograms", False),
    ("string", "profile_dir", None),
    ("string", "platform", None),
    ("string", "profile", ""),
)
for _kind, _name, _default in _UNPORTED_FLAGS:
    getattr(flags, f"DEFINE_{_kind}")(
        _name, _default, "JAX train.py flag of a mode not ported yet "
        "(parsed, unused)")


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


def main(unused_argv):
    if FLAGS.mode == "generate":
        return run_generate()
    raise _not_ported(f"--mode={FLAGS.mode} (the PS/worker trainer, its "
                      "eval and supervision)", "slice 7")


if __name__ == "__main__":
    app.run(main)
