#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: the hand-written CUDA kernels, compiled from ``csrc/``.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   in bf16 at the shapes each path gives it (K1 and K3 at the serving
   path's and the train step's, K2a and K2b at the train step's, K4 and
   K5 at the int8 MLP's four call sites of the int8 train step, every
   epilogue and prologue variant, and one small non-square case; K6, K7a
   and K7b at the ring train step's per-hop shape, q/k/v shards [8, 256,
   16, 128], for a chunk wholly visible, on the diagonal and wholly in the
   future, a padding mask with fully masked rows, a window, non-causal
   and D = 64, then the 4-shard ring over them against K1/K2 on the whole
   sequence; K8, on no path, at the int8 MLP's mlp_in dgrad shape), with
   the tolerance stated below, its time, the plain version's time, one
   library call's time (used only here, never by the port; K4/K5/K8 have
   two labelled yardsticks) and the least time the card could take.
4. ``serve``: a GPT at the widths of the repo's GPT-406M (hidden 2048,
   8 layers, 16 heads, MLP 8192, vocab 256, bf16, random weights from a
   seeded generator) behind ``ServingServer``; 8 concurrent HTTP requests
   from two tenants (prompts of 100-777 tokens, 64 new tokens each, greedy
   and seeded-sampled) through ``ServeClient``.  The kernels' launch
   counters are set to 0 just before and read just after.  Before it, the
   ``profile`` line: ``torch.profiler`` over one more request, the card's
   busy share of it and the kernels that took its device time.
5. ``train``: the flagship GPT train step (``bench.py``'s: the same
   widths, fp32 master weights, bf16 compute, ``attention_backend=
   "pallas"``, plus ``fused_ln=True``; Adam 3e-4, B=8, S=1024, the
   synthetic LM stream) through ``TrainState`` and
   ``build_sync_train_step``.  First one step's loss and gradients through
   the kernels against the plain path with the same weights and batch;
   then 30 steps with the launch counters set to 0 just before and read
   just after (the loss must stay finite and fall); then the
   ``train_profile`` line, ``torch.profiler`` over one more step.
6. ``train_int8``: the same step with ``matmul_int8=True`` (bench.py's
   int8 arm, :2271): each block's gelu MLP through K4 and K5.  The same
   kernel-vs-plain check (the plain path also takes the plain versions of
   K4/K5), 30 steps with exact launch counts (K4 and K5 twice per layer),
   the loss held to the bf16 phase's, the ``train_int8_profile`` line,
   then a short arm with ``attn_int8=True`` as well (bench.py :2287).
7. ``train_ring``: the same step with ``attention_backend="ring"``
   (``train.py --sequence_parallel=4 --attention_backend=ring``) on a mesh
   of four sequence shards of 256 on the card: each block's attention is
   a 4-hop ring through K6 forward and K7a/K7b backward.  One step's loss
   and gradients against the same ring through the plain chunk versions
   and against the pallas step (K1/K2), then 30 steps with exact launch
   counts (K6, K7a, K7b each 4 shards x 4 hops x 8 layers = 128 per step,
   K3 17, K1/K2 none), a falling loss, and the ``train_ring_profile``
   line.

Then the card's name and power limit, the kernels' summary object, and
last ``{"ok": true, "device": {...}}``.  A summary row's numbers and
launches are those of its main path (``main``: the train step for
K1/K2/K3, the int8 train step for K4/K5, the ring train step for K6/K7,
whose numbers are the mean per launch over a step's hops, and the
``kernels`` phase itself for K8, which no path launches); its ``paths``
hold each path's own shape, numbers and launches, and K4/K5/K8 rows list
their call sites or variants under ``sites``.
Any failing phase raises: the script exits non-zero and prints no
result.  Without CUDA it exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

# Tolerances, kernel against its plain version on the same inputs.
# K1 output, bf16: both accumulate in fp32, but the kernel feeds the V
# product unnormalised probabilities rounded to bf16 and divides at the
# end, where the plain version rounds normalised weights; outputs of
# magnitude ~1 then differ by a few bf16 ulps (2^-8 each).
K1_OUT_TOL = 2e-2
# K1 logsumexp: fp32 on both sides from the same bf16 inputs; only the
# order of the fp32 sums differs.
K1_LSE_TOL = 1e-3
# K3: fp32 statistics and output on both sides; only summation order
# differs (~1e-6 relative on values of magnitude <= ~5).
K3_TOL = 1e-4
# K2a, K2b (bf16), max abs error over the largest gradient magnitude:
# the kernels round P and dS to bf16 as tensor-core operands and each
# gradient to bf16 once; the plain version computes in fp32 and rounds
# once, so the two land within about one bf16 ulp (2^-8) of the largest
# gradient.
K2_REL_TOL = 1e-2
# Whole model, bf16: prefill logits through both kernels against the
# plain path (dense attention, plain LayerNorm) with the same weights.
# Per-layer differences of a bf16 ulp in the attention output carry
# through 8 residual layers to logits of magnitude ~1.
MODEL_LOGIT_TOL = 0.1
# One train step, kernel path against plain path (same fp32 masters and
# batch, bf16 compute): the attention output differs by a bf16 ulp per
# layer (as for the logits above), which the loss, a mean over ~8000
# next-token terms, averages down; the gradients go through 8 layers of
# bf16 matmuls on both sides, so they agree in direction and norm closely
# but not bit for bit.  (Measured on an H100 at B=8: loss 8.5e-5 apart,
# norms 2.3e-4 relative, cosine 0.999996; the limits leave ~9x room.)
TRAIN_LOSS_TOL = 1e-3          # absolute, on a loss of ~6
TRAIN_GRAD_NORM_RTOL = 2e-3    # relative difference of the global norms
TRAIN_GRAD_MIN_COS = 0.999     # cosine of the flattened gradients
# K4 and K5 against their plain versions (same inputs, bf16): both
# quantize with the same IEEE division and round half to even, add the
# exact int32 K-block products into fp32 in the same order with every
# step rounded, and take tanh from the same tanhf, so the int8 codes are
# the same unless an ulp of tanh or of an FMA moves a value across a
# rounding boundary.  K4: every output within one bf16 ulp of the
# largest magnitude.  K5: max abs error over the largest magnitude at
# most 1e-2 (one flipped code moves one product by ~1/127 of a row's
# range); its g output (elementwise, no quantizer) within one bf16 ulp of
# each element.
K5_REL_TOL = 1e-2
# One int8 train step, kernel path against plain path (plain attention,
# LayerNorm and K4/K5 versions, same fp32 masters and batch): on top of
# the bf16 step's differences (see above), a bf16 ulp of difference in an
# activation can flip one int8 code, which moves a product by ~1/127 of a
# row's range; the loss averages ~8000 next-token terms and the
# gradients 406M entries, so flips stay far inside these limits.
TRAIN_INT8_LOSS_TOL = 1e-2
TRAIN_INT8_GRAD_NORM_RTOL = 2e-2
TRAIN_INT8_GRAD_MIN_COS = 0.99
# tests/test_int8_train.py:366: the int8 loss within 10% (+0.1) of bf16.
INT8_LOSS_RATIO, INT8_LOSS_SLACK = 1.10, 0.1
# K6, K7a and K7b against their plain versions (fp32 math) at the ring
# path's per-hop shape, bf16: the kernels round P (and dS) to bf16 as
# tensor-core operands, as K1/K2 do, so the acc carry and the gradient
# partials land within about one bf16 ulp (2^-8) of their largest
# magnitude (max abs error over the largest magnitude); m and l sum
# unrounded fp32 probabilities and differ only in where the 1/sqrt(D)
# scale is applied (after the product in the kernel, before it in the
# plain version).
K67_REL_TOL = 1e-2
K6_M_ATOL = 1e-4               # on running maxima of magnitude ~3
K6_L_REL_TOL = 1e-4
# The 4-shard ring over K6/K7 against K1/K2 on the whole sequence (same q,
# k, v, dO) is held to K1's output and K2's gradient tolerances: both
# round P and dS to bf16, grouped per hop in the ring.  One ring train
# step, against the plain chunk versions and against the pallas step, is
# held to the TRAIN_* tolerances above, for the reason given there.

# Published H100 SXM peaks (dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

WIDTH = dict(vocab_size=256, hidden_size=2048, num_layers=8, num_heads=16,
             intermediate_size=8192, max_position=1024, dtype="bfloat16",
             attention_backend="pallas", fused_ln=True)
ENGINE = dict(num_slots=8, page_size=16, num_pages=512,
              max_pages_per_seq=64)
PROMPT_LENS = (100, 777, 250, 512, 640, 333, 700, 128)
NEW_TOKENS = 64
SEED = 0
# The flagship train step (bench.py:456-531, :694): B=8, S=1024, Adam 3e-4.
TRAIN = dict(batch=8, seq_len=1024, lr=3e-4, steps=30)
ATTN_INT8_STEPS = 5
# The ring train step's mesh: four sequence shards of 256 on the one card
# (data=1, seq=4).
RING_SEQ = 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_ms: float = 25.0) -> float:
    """Mean milliseconds per call over back-to-back calls, with enough
    calls (20 to 2000) that the timed window spans ``min_ms``: a short
    window would time the card before its clocks come up."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def window(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    est = window(5) / 5                      # warm-up and first estimate
    reps = int(min(2000, max(20, min_ms / max(est, 1e-3))))
    return window(reps) / reps


def bound(bytes_moved: float, flops: float,
          peak_ops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(name, q, k, v, mask, out, lse, *, causal, window):
    """K1's output and logsumexp against the plain version on the same
    inputs; returns (max_abs_err of the output, of the live lse rows)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    ref, ref_lse = fa.flash_attention_reference(q, k, v, mask, causal=causal,
                                                window=window)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    live = ref_lse > -1e29
    lse_err = (lse - ref_lse)[live].abs().max().item()
    if not (torch.isfinite(out).all() and err <= K1_OUT_TOL
            and lse_err <= K1_LSE_TOL
            and bool(((lse > -1e29) == live).all())):
        raise AssertionError(f"K1 {name}: max_abs_err {err} (tol "
                             f"{K1_OUT_TOL}), lse err {lse_err} (tol "
                             f"{K1_LSE_TOL})")
    if name == "masked_rows" and out[0, :10].abs().max().item() != 0:
        raise AssertionError("K1: fully masked rows must be 0")
    return err, lse_err


def k1_timings(q, k, v, mask, valid, *, causal, window) -> dict:
    """K1's time, the plain version's, SDPA's and the bound, on [B, S, H,
    D] bf16 inputs whose query/key pairs ``valid`` allows."""
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    B, S, H, D = q.shape
    pairs = valid.sum().item() * H
    bytes_moved = 4 * B * S * H * D * 2 + B * H * S * 4 + (
        0 if mask is None else B * S * 4)
    b_ms, b_by = bound(bytes_moved, 4 * D * pairs)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if mask is None and causal and not window:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=valid)
    kw = dict(causal=causal, window=window)
    return dict(ms=cuda_ms(lambda: fa.flash_attention(q, k, v, mask, **kw)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                    q, k, v, mask, **kw)),
                library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by)


def check_k3(name, x, scale, bias) -> dict:
    """K3 against the plain version on [rows, H] ``x``, with its times."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    rows, Hd = x.shape
    out = ln.layer_norm(x, scale, bias)
    ref = ln.layer_norm_reference(x, scale, bias)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not (out.dtype == torch.float32 and err <= K3_TOL):
        raise AssertionError(f"K3 {name}: max_abs_err {err} (tol "
                             f"{K3_TOL}), dtype {out.dtype}")
    s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    b_ms, b_by = bound(rows * Hd * (x.element_size() + 4) + 2 * Hd * 4,
                       8 * rows * Hd)
    return dict(
        case=name, rows=rows, H=Hd, max_abs_err=err, tol=K3_TOL,
        ms=cuda_ms(lambda: ln.layer_norm(x, scale, bias)),
        plain_ms=cuda_ms(lambda: ln.layer_norm_reference(x, scale, bias)),
        # bf16 weights: F.layer_norm's one-call form writes bf16.
        library_ms=cuda_ms(lambda: F.layer_norm(x, (Hd,), s16, b16, 1e-6)),
        bound_ms=b_ms, bound_by=b_by)


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the paths'
    shapes; returns the summary rows (launches filled in later)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        attention_valid)

    g = torch.Generator(device=dev).manual_seed(SEED)
    H, D = WIDTH["num_heads"], WIDTH["hidden_size"] // WIDTH["num_heads"]
    S = 784                       # the longest prompt's prefill bucket

    def qkv(B):
        # Views into one fused [B, S, 3, H, D] projection, as on the path.
        t = torch.randn(B, S, 3, H, D, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        return t[:, :, 0], t[:, :, 1], t[:, :, 2]

    masked_tail = torch.ones(2, S, dtype=torch.int32, device=dev)
    masked_tail[1, S - 300:] = 0
    masked_head = torch.ones(1, S, dtype=torch.int32, device=dev)
    masked_head[0, :10] = 0        # causal rows 0..9 see no valid key
    cases = [("causal", 1, None, 0), ("kv_mask", 2, masked_tail, 0),
             ("window", 1, None, 256), ("masked_rows", 1, masked_head, 0)]
    k1_cases = []
    for name, B, mask, window in cases:
        q, k, v = qkv(B)
        out, lse = fa.flash_attention(q, k, v, mask, causal=True,
                                      window=window)
        err, lse_err = check_k1(name, q, k, v, mask, out, lse, causal=True,
                                window=window)
        valid = attention_valid(B, S, mask, causal=True, window=window,
                                device=dev)
        k1_cases.append(dict(
            case=name, B=B, S=S, H=H, D=D, window=window, max_abs_err=err,
            tol=K1_OUT_TOL, lse_err=lse_err, lse_tol=K1_LSE_TOL,
            **k1_timings(q, k, v, mask, valid, causal=True, window=window)))

    k3_cases = []
    Hd = WIDTH["hidden_size"]
    # The serving path's prefill and decode rows, and the train step's
    # B*S rows of the bf16 residual stream.
    for name, rows in (("prefill", S), ("decode", ENGINE["num_slots"]),
                       ("train", TRAIN["batch"] * TRAIN["seq_len"])):
        x = torch.randn(rows, Hd, generator=g, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(Hd, generator=g, device=dev)
        bias = 0.1 * torch.randn(Hd, generator=g, device=dev)
        k3_cases.append(check_k3(name, x, scale, bias))
    k2 = check_backward_kernels(dev, g, H, D)
    k45 = check_int8_kernels(dev, g)
    k67 = check_ring_kernels(dev, g)
    k1_all = k1_cases + [k2["fwd"]]
    emit("kernels", flash_attention_fwd=k1_all,
         layer_norm_fwd=k3_cases, flash_attention_bwd_dq=k2["dq"],
         flash_attention_bwd_dkv=k2["dkv"], quant_matmul=k45["k4"],
         quant_matmul_nt=k45["k5"], flash_attention_chunk=k67["k6"],
         flash_attention_chunk_dq=k67["k7a"],
         flash_attention_chunk_dkv=k67["k7b"],
         ring_vs_flash=k67["ring_vs_flash"],
         quant_matmul_dgelu=k45["k8"])

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def summary(name, file, replaces, main, by_path, cases, sites=()):
        """One row per kernel.  Its numbers are those of its main path's
        case, the path whose launches it reports; ``paths`` holds each
        path's own case (launches filled in after the paths ran) and
        ``sites`` a path's other call sites."""
        row = dict(
            name=name, route="cuda",
            source=f"distributed_tensorflow_tpu_torch/csrc/{file}",
            replaces=f"distributed_tensorflow_tpu/ops/pallas/{replaces}",
            main=main, launches=0,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            **{k: by_path[main][k] for k in keys},
            paths={path: dict(case=c["case"], launches=0,
                              max_abs_err=c["max_abs_err"],
                              **{k: c[k] for k in keys})
                   for path, c in by_path.items()})
        if sites:
            row["library_bf16_ms"] = by_path[main]["library_bf16_ms"]
            row["sites"] = [dict(case=c["case"], variant=c["variant"],
                                 M=c["M"], K=c["K"], N=c["N"],
                                 max_abs_err=c["max_abs_err"],
                                 library_bf16_ms=c["library_bf16_ms"],
                                 **{k: c[k] for k in keys}) for c in sites]
        return row
    k4, k5, k8 = k45["k4"], k45["k5"], k45["k8"]
    return [
        summary("flash_attention_fwd", "flash_attention.cu",
                "flash_attention.py:119", "train",
                {"serve": k1_cases[0], "train": k2["fwd"]}, k1_all),
        summary("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:38",
                "train", {"serve": k3_cases[0], "train": k3_cases[2],
                          "train_ring": k3_cases[2]}, k3_cases),
        summary("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
                "flash_attention.py:425", "train", {"train": k2["dkv"][0]},
                k2["dkv"]),
        summary("flash_attention_bwd_dq", "flash_attention_bwd.cu",
                "flash_attention.py:465", "train", {"train": k2["dq"][0]},
                k2["dq"]),
        # Each runs at two call sites per layer of the int8 step: the
        # row's numbers are the mlp_in site's (K4 its forward, K5 its
        # dgrad with g), ``sites`` has both.
        summary("quant_matmul", "quant_matmul.cu", "quant_matmul.py:93",
                "train_int8", {"train_int8": k4[0]}, k4, sites=k4[:2]),
        summary("quant_matmul_nt", "quant_matmul.cu", "quant_matmul.py:185",
                "train_int8", {"train_int8": k5[1]}, k5, sites=k5[:2]),
        # The ring's per-hop kernels: the row's numbers are the mean per
        # launch over one train step's hops (visible, diagonal, future).
        summary("flash_attention_chunk", "flash_attention_chunk.cu",
                "flash_attention.py:624", "train_ring",
                {"train_ring": k67["k6"][0]}, k67["k6"]),
        summary("flash_attention_chunk_dq", "flash_attention_chunk.cu",
                "flash_attention.py:767", "train_ring",
                {"train_ring": k67["k7a"][0]}, k67["k7a"]),
        summary("flash_attention_chunk_dkv", "flash_attention_chunk.cu",
                "flash_attention.py:796", "train_ring",
                {"train_ring": k67["k7b"][0]}, k67["k7b"]),
        # On no path of the port (nor of the JAX package): its main is this
        # phase, and its launches are this phase's.
        summary("quant_matmul_dgelu", "quant_matmul.cu",
                "quant_matmul.py:146", "kernels", {"kernels": k8[0]}, k8,
                sites=k8),
    ]


def check_backward_kernels(dev, g, H, D):
    """K2b (dq, with delta) and K2a (dk, dv) against the plain backward at
    the train step's shape (S=1024, H=16, D=128, bf16; B=8 for the causal
    case the step runs, B=2 for the others), on the forward kernel's own
    output and logsumexp, which are first held against the plain forward
    (K1 at the train shape; its times in the causal case are the ``fwd``
    row).  The library time is ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention``, which computes dq, dk and dv in one
    call: the same number stands in both rows."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        attention_valid)

    S = TRAIN["seq_len"]
    tail = torch.ones(2, S, dtype=torch.int32, device=dev)
    tail[1, S - 300:] = 0
    head = torch.ones(2, S, dtype=torch.int32, device=dev)
    head[0, :10] = 0               # causal rows 0..9 see no valid key
    # (name, B, kv_mask, causal, window, head_dim)
    cases = [("causal", TRAIN["batch"], None, True, 0, D),
             ("kv_mask", 2, tail, True, 0, D),
             ("window", 2, None, True, 256, D),
             ("masked_rows", 2, head, True, 0, D),
             ("non_causal", 2, tail, False, 0, D),
             ("head_dim_64", 2, None, True, 0, 64)]
    rows = {"dq": [], "dkv": [], "fwd": None}
    for name, B, mask, causal, window, d in cases:
        t = torch.randn(B, S, 3, H, d, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                          window=window)
        fwd_err, fwd_lse_err = check_k1(name, q, k, v, mask, out, lse,
                                        causal=causal, window=window)
        dout = torch.randn(B, S, H, d, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
        kw = dict(causal=causal, window=window)

        def run_dq():
            return fa.flash_attention_backward_dq(q, k, v, mask, out, lse,
                                                  dout, **kw)
        dq, delta = run_dq()

        def run_dkv():
            return fa.flash_attention_backward_dkv(q, k, v, mask, lse,
                                                   delta, dout, **kw)
        dk, dv = run_dkv()

        def plain():
            return fa.flash_attention_backward_reference(
                q, k, v, mask, out, lse, dout, **kw)
        ref = plain()
        torch.cuda.synchronize()
        errs = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            abs_err = (got.float() - want.float()).abs().max().item()
            rel = abs_err / max(want.float().abs().max().item(), 1e-6)
            if not (torch.isfinite(got).all() and rel <= K2_REL_TOL):
                raise AssertionError(f"K2 {name} {gname}: max_abs_err "
                                     f"{abs_err}, relative {rel} (tol "
                                     f"{K2_REL_TOL})")
            errs[gname] = (abs_err, rel)
        if name == "masked_rows" and dq[0, :10].abs().max().item() != 0:
            raise AssertionError("K2: dq of fully masked rows must be 0")

        valid = attention_valid(B, S, mask, causal=causal, window=window,
                                device=dev)
        if name == "causal":
            rows["fwd"] = dict(
                case="train", B=B, S=S, H=H, D=d, window=window,
                max_abs_err=fwd_err, tol=K1_OUT_TOL, lse_err=fwd_lse_err,
                lse_tol=K1_LSE_TOL, **k1_timings(q, k, v, mask, valid,
                                                 causal=causal,
                                                 window=window))
        pairs = valid.sum().item() * H
        one = B * S * H * d * 2                  # one bf16 [B, S, H, D]
        stats = B * H * S * 4                    # lse or delta, fp32
        extra = 0 if mask is None else B * S * 4
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        if mask is None and causal and not window:
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
        else:
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=valid)
        lib_dout = dout.transpose(1, 2)

        def lib():
            return torch.autograd.grad(lib_out, (qt, kt, vt), lib_dout,
                                       retain_graph=True)
        plain_ms, lib_ms = cuda_ms(plain), cuda_ms(lib)
        base = dict(case=name, B=B, S=S, H=H, D=d, causal=causal,
                    window=window, tol_rel=K2_REL_TOL, plain_ms=plain_ms,
                    library_ms=lib_ms)
        # dq: reads q, k, v, o, dO and lse, writes dq and delta; S, dP, dQ.
        b_ms, b_by = bound(6 * one + 2 * stats + extra, 3 * 2 * pairs * d)
        rows["dq"].append(dict(base, max_abs_err=errs["dq"][0],
                               rel_err=errs["dq"][1], ms=cuda_ms(run_dq),
                               bound_ms=b_ms, bound_by=b_by))
        # dkv: reads q, k, v, dO, lse and delta, writes dk and dv; S, dP,
        # dV, dK.
        b_ms, b_by = bound(6 * one + 2 * stats + extra, 4 * 2 * pairs * d)
        rows["dkv"].append(dict(
            base, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
            rel_err=max(errs["dk"][1], errs["dv"][1]), ms=cuda_ms(run_dkv),
            bound_ms=b_ms, bound_by=b_by))
        del t, ref, lib_out, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def ring_chunk_case(dev, g, fused, name, q_off, k_off, *, causal=True,
                    window=0, masked=False) -> dict:
    """K6, K7a and K7b on one (query shard, key chunk) pair of the ring
    path against their plain versions: q the shard of ``fused`` [B, S, 3,
    H, D] at ``q_off``, k and v the chunk at ``k_off`` (views, as the ring
    hands them over), an fp32 carry in flight.  Returns the three rows
    with times, the library yardsticks and the bounds."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    B, S, _, H, D = fused.shape
    n = S // RING_SEQ
    q = fused[:, q_off:q_off + n, 0]
    k, v = fused[:, k_off:k_off + n, 1], fused[:, k_off:k_off + n, 2]
    mask = None
    m = torch.randn(B, H, n, generator=g, device=dev)
    l = 1 + torch.rand(B, H, n, generator=g, device=dev)
    acc = torch.randn(B, H, n, D, generator=g, device=dev)
    # Keys 0..9 of batch 0 masked: on the causal diagonal its rows 0..9
    # then see no key; their carries say that none was seen before.
    dead = masked and causal and q_off == k_off
    if masked:
        mask = torch.ones(B, n, dtype=torch.int32, device=dev)
        mask[0, :10] = 0
        m[0, :, :10], l[0, :, :10], acc[0, :, :10] = -1e30, 0.0, 0.0
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, window=window)
    valid = fa.chunk_valid(B, n, n, mask, device=dev, **kw)
    pairs = valid.sum().item() * H
    one = B * n * H * D * 2                  # one bf16 [B, n, H, D]
    stats = B * H * n * 4                    # m, l, lse or delta, fp32
    carry = 2 * stats + stats * D            # m, l and acc
    extra = 0 if mask is None else B * n * 4
    base = dict(case=name, B=B, S_local=n, H=H, D=D, q_offset=q_off,
                k_offset=k_off, causal=causal, window=window,
                masked=masked, pairs=pairs)

    def rel(got, want):
        err = (got - want).abs().max().item()
        return err, err / max(want.abs().max().item(), 1e-6)

    # K6.
    def run_fwd():
        return fa.flash_attention_chunk(q, k, v, mask, m, l, acc, **kw)

    def plain_fwd():
        return fa.flash_attention_chunk_reference(q, k, v, mask, m, l, acc,
                                                  **kw)
    got, want = run_fwd(), plain_fwd()
    torch.cuda.synchronize()
    m_err = (got[0] - want[0]).abs().max().item()
    l_err, l_rel = rel(got[1], want[1])
    acc_err, acc_rel = rel(got[2], want[2])
    if not (all(torch.isfinite(t).all() for t in got)
            and m_err <= K6_M_ATOL and l_rel <= K6_L_REL_TOL
            and acc_rel <= K67_REL_TOL):
        raise AssertionError(f"K6 {name}: m err {m_err}, l rel {l_rel}, "
                             f"acc rel {acc_rel}")
    if not pairs and not all(torch.equal(a, b)
                             for a, b in zip(got, (m, l, acc))):
        raise AssertionError(f"K6 {name}: a skipped chunk must write its "
                             "carries unchanged")
    if dead and not (torch.equal(got[0][0, :, :10], m[0, :, :10])
                       and not got[2][0, :, :10].any()):
        raise AssertionError(f"K6 {name}: fully masked rows moved")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_mask = None if (mask is None and not causal) else valid
    # Operands and carries are needed only where some pair is visible.
    b_ms, b_by = bound((3 * one + extra if pairs else 0) + 2 * carry,
                       2 * 2 * pairs * D)
    k6 = dict(base, max_abs_err=max(m_err, l_err, acc_err), m_err=m_err,
              l_rel_err=l_rel, acc_rel_err=acc_rel, tol_rel=K67_REL_TOL,
              ms=cuda_ms(run_fwd), plain_ms=cuda_ms(plain_fwd),
              library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=lib_mask)),
              library="SDPA forward on the chunk pair, same boolean mask "
                      "(returns no carry)",
              bound_ms=b_ms, bound_by=b_by)

    # K7a and K7b from the finished state's lse.
    lse = want[0] + torch.log(want[1].clamp_min(1e-30))
    do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    delta = torch.randn(B, H, n, generator=g, device=dev)
    args = (q, k, v, mask, do, lse, delta)

    def run_dq():
        return fa.flash_attention_chunk_dq(*args, **kw)

    def run_dkv():
        return fa.flash_attention_chunk_dkv(*args, **kw)

    def plain_dq():
        return fa.flash_attention_chunk_dq_reference(*args, **kw)

    def plain_dkv():
        return fa.flash_attention_chunk_dkv_reference(*args, **kw)
    errs = {}
    for gname, a, b in zip(("dq", "dk", "dv"), (run_dq(), *run_dkv()),
                           (plain_dq(), *plain_dkv())):
        torch.cuda.synchronize()
        err, r = rel(a, b)
        zero_ok = bool(b.abs().max() > 0) or not a.any()
        if not (torch.isfinite(a).all() and zero_ok
                and (r <= K67_REL_TOL or b.abs().max() == 0)):
            raise AssertionError(f"K7 {name} {gname}: max_abs_err {err}, "
                                 f"relative {r}")
        if dead and gname == "dq" and a[0, :, :10].any():
            raise AssertionError("K7: dq of fully masked rows must be 0")
        errs[gname] = (err, r)
    ql, kl, vl = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask)
    lib_do = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), lib_do, retain_graph=True))
    lib = dict(library_ms=lib_ms,
               library="autograd.grad through SDPA on the chunk pair, "
                       "dq, dk and dv in one call (same number both rows)")
    ops_bytes = 4 * one + 2 * stats + extra if pairs else 0
    # dq: S, dP, dQ; writes the fp32 dq partial.
    b_ms, b_by = bound(ops_bytes + stats * D, 3 * 2 * pairs * D)
    k7a = dict(base, max_abs_err=errs["dq"][0], rel_err=errs["dq"][1],
               tol_rel=K67_REL_TOL, ms=cuda_ms(run_dq),
               plain_ms=cuda_ms(plain_dq), bound_ms=b_ms, bound_by=b_by,
               **lib)
    # dkv: S, dP, dV, dK; writes the fp32 dk and dv partials.
    b_ms, b_by = bound(ops_bytes + 2 * stats * D, 4 * 2 * pairs * D)
    k7b = dict(base, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
               rel_err=max(errs["dk"][1], errs["dv"][1]),
               tol_rel=K67_REL_TOL, ms=cuda_ms(run_dkv),
               plain_ms=cuda_ms(plain_dkv), bound_ms=b_ms, bound_by=b_by,
               **lib)
    del got, want, lib_out, ql, kl, vl
    return dict(k6=k6, k7a=k7a, k7b=k7b)


def ring_vs_flash(dev, g) -> dict:
    """The 4-shard ring over K6/K7 against K1/K2 over the whole train
    sequence (B=8, S=1024, H=16, D=128, causal, bf16), same q, k, v, dO:
    output and gradients."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.ring import (
        make_ring_attention)
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    H, D = WIDTH["num_heads"], WIDTH["hidden_size"] // WIDTH["num_heads"]
    fused = torch.randn(B, S, 3, H, D, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
    q, k, v = (fused[:, :, i].detach().requires_grad_() for i in range(3))
    dout = torch.randn(B, S, H, D, generator=g, device=dev).to(q.dtype)
    ring = make_ring_attention(
        create_mesh(data=1, seq=RING_SEQ, devices=[dev] * RING_SEQ),
        causal=True)
    out = ring(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = fa.flash_attention(q, k, v, causal=True)[0]
    want = torch.autograd.grad(ref, (q, k, v), dout)
    torch.cuda.synchronize()
    row = dict(B=B, S=S, H=H, D=D, shards=RING_SEQ, causal=True,
               out_max_abs_err=(out.float() - ref.float()).abs().max().item(),
               out_tol=K1_OUT_TOL, grad_tol_rel=K2_REL_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        row[f"{name}_rel_err"] = ((a.float() - b.float()).abs().max()
                                  / b.float().abs().max()).item()
    if not (torch.isfinite(out).all() and row["out_max_abs_err"]
            <= K1_OUT_TOL and all(row[f"{x}_rel_err"] <= K2_REL_TOL
                                  for x in ("dq", "dk", "dv"))):
        raise AssertionError(f"ring over K6/K7 against K1/K2: {row}")
    del fused, q, k, v, out, got, ref, want
    torch.cuda.empty_cache()
    return row


def check_ring_kernels(dev, g) -> dict:
    """K6, K7a and K7b at the ring path's per-hop shape (q, k, v shards
    [8, 256, 16, 128] of the fused projection, bf16, fp32 carries) for
    the three hop kinds of the causal ring (a chunk wholly visible, on the
    diagonal, wholly in the future) and a padding mask with fully masked
    rows, a window, non-causal and D = 64; then the ring against K1/K2.
    The path's row is the per-launch mean over one step's hops: of the 16
    (shard, chunk) pairs of a 4-shard causal ring 6 are visible, 4
    diagonal, 6 in the future."""
    import torch
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    H, D = WIDTH["num_heads"], WIDTH["hidden_size"] // WIDTH["num_heads"]
    n = S // RING_SEQ
    cases = [("visible", 3 * n, 0, {}), ("diagonal", 2 * n, 2 * n, {}),
             ("future", 0, 3 * n, {}),
             ("masked_rows", 2 * n, 2 * n, dict(masked=True)),
             ("window", 3 * n, 2 * n, dict(window=n)),
             ("non_causal", 0, 3 * n, dict(causal=False, masked=True))]
    rows = {"k6": [], "k7a": [], "k7b": []}
    for d in (D, 64):
        fused = torch.randn(B, S, 3, H, d, generator=g, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
        for name, q_off, k_off, kw in (cases if d == D else cases[1:2]):
            label = name if d == D else f"head_dim_{d}"
            for key, row in ring_chunk_case(dev, g, fused, label, q_off,
                                            k_off, **kw).items():
                rows[key].append(row)
        del fused
    weights = {"visible": 6, "diagonal": 4, "future": 6}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "pairs")
    for key, cs in rows.items():
        mix = [c for c in cs if c["case"] in weights]
        total = sum(weights.values())
        row = {k: sum(weights[c["case"]] * c[k] for c in mix) / total
               for k in keys}
        row.update(case="train_ring_hop_mean", hops=dict(weights),
                   max_abs_err=max(c["max_abs_err"] for c in mix),
                   bound_by=max(mix, key=lambda c: c["bound_ms"])[
                       "bound_by"], library=mix[0]["library"])
        rows[key].insert(0, row)
    rows["ring_vs_flash"] = ring_vs_flash(dev, g)
    torch.cuda.empty_cache()
    return rows


def bf16_ulp(t):
    """One bf16 ulp of each element's magnitude (8 significant bits)."""
    import torch
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def int8_case(dev, g, kind, case, M, K, N, block_k, variant):
    """K4 (``kind`` "k4": x [M, K] @ qw [K, N]), K5 ("k5": da [M, K]
    against qw [N, K]) or K8 ("k8": da * gelu'(pre) [M, K] @ qwt [K, N])
    on bf16 inputs against its plain version, with its times, the two
    yardsticks and the bound."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    bf = torch.bfloat16
    a = torch.randn(M, K, generator=g, device=dev).to(bf)
    if kind == "k4":
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(K, N, generator=g, device=dev))
        kw = dict(block_k=block_k)
        args = [a, qw, sw, None, None]
        if variant != "plain":
            args[3] = 0.1 * torch.randn(N, generator=g, device=dev)
        if variant == "bias_gelu_preact":
            kw.update(activation="gelu", want_preact=True)
        if variant == "bias_residual":
            args[4] = torch.randn(M, N, generator=g, device=dev).to(bf)
        kernel, plain = qmm.quantized_matmul, qmm.quantized_matmul_reference
        extra = sum(t.numel() * t.element_size() for t in args[3:]
                    if t is not None)
        outs = 2 if kw.get("want_preact") else 1
        bytes_moved = (a.numel() * 2 + qw.numel() + 4 * N + extra
                       + outs * M * N * 2)
        # [K, N] K-contiguous: the layout the library's int8 GEMM takes
        # fast (row-major it ran ~6x slower on the H100).
        qw_lib = qw.t().contiguous().t()
    elif kind == "k8":
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(K, N, generator=g, device=dev))
        kw = dict(block_k=block_k, want_g=variant == "dgelu_want_g")
        pre = (2 * torch.randn(M, K, generator=g, device=dev)).to(bf)
        args = [a, pre, qw, sw]
        kernel = qmm.quantized_matmul_dgelu
        plain = qmm.quantized_matmul_dgelu_reference
        bytes_moved = (2 * a.numel() * 2 + qw.numel() + 4 * N + M * N * 2
                       + (M * K * 2 if kw["want_g"] else 0))
        qw_lib = qw.t().contiguous().t()         # K-contiguous, as for K4
    else:
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(N, K, generator=g, device=dev))
        kw = dict(block_k=block_k, want_g=variant == "dgelu_fold_want_g")
        args = [a, qw, sw, None]
        if variant != "fold":
            kw["prologue"] = "dgelu_fold"
            args[3] = (2 * torch.randn(M, K, generator=g, device=dev)).to(bf)
        kernel = qmm.quantized_matmul_nt
        plain = qmm.quantized_matmul_nt_reference
        bytes_moved = (a.numel() * 2 * (1 if args[3] is None else 2)
                       + qw.numel() + 4 * K + M * N * 2
                       + (M * K * 2 if kw["want_g"] else 0))
        qw_lib = qw.t()                          # [K, N], K-contiguous
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    for name, x, y in zip(("out", "second"), got, want):
        err = (x.float() - y.float()).abs().max().item()
        peak = y.float().abs().max().item()
        if kind != "k4" and name == "second":          # g: elementwise
            ok = bool(((x.float() - y.float()).abs()
                       <= bf16_ulp(y)).all())
            tol = "one bf16 ulp of each element"
        elif kind != "k4":
            ok, tol = err <= K5_REL_TOL * peak, f"{K5_REL_TOL} x peak"
        else:
            ulp = bf16_ulp(torch.tensor(peak)).item()
            ok, tol = err <= ulp, f"one bf16 ulp of the peak ({ulp})"
        if not (ok and torch.isfinite(x).all()):
            raise AssertionError(f"{kind} {case} {variant} {name}: "
                                 f"max_abs_err {err} at peak {peak}, tol "
                                 f"{tol}")
        errs.append(dict(output=name, max_abs_err=err, peak=peak, tol=tol))
    b_ms, b_by = bound(bytes_moved, 2 * M * K * N, PEAK_INT8_OPS)
    q_lib = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
    w_bf16 = torch.randn(K, N, generator=g, device=dev).to(bf)
    row = dict(case=case, variant=variant, M=M, K=K, N=N,
               block_k=qmm._pick(K, block_k),
               max_abs_err=max(e["max_abs_err"] for e in errs), errors=errs,
               ms=cuda_ms(lambda: kernel(*args, **kw)),
               plain_ms=cuda_ms(lambda: plain(*args, **kw)),
               bound_ms=b_ms, bound_by=b_by,
               # Yardsticks, never called by the port: the library's int8
               # GEMM on operands already quantized, and the bf16 GEMM of
               # the same M, K, N.
               library_ms=cuda_ms(lambda: torch._int_mm(q_lib, qw_lib)),
               library="torch._int_mm on pre-quantized int8 operands",
               library_bf16_ms=cuda_ms(lambda: torch.matmul(a, w_bf16)))
    del args, got, want, q_lib, w_bf16
    return row


def check_int8_kernels(dev, g):
    """K4 and K5 at the int8 train step's four call sites (M = B*S = 8192
    rows of GPT-406M: mlp_in H=2048 -> I=8192, mlp_out I -> H, and their
    dgrads) in the variants those sites use, the other variants at the
    same shapes, and one small non-square case (M=200, K=384 in three
    K-blocks of 128, N=640); K8 at the mlp_in dgrad's shape, with and
    without g."""
    M = TRAIN["batch"] * TRAIN["seq_len"]
    H, I = WIDTH["hidden_size"], WIDTH["intermediate_size"]
    k4 = [("mlp_in", M, H, I, 512, "bias_gelu_preact"),
          ("mlp_out", M, I, H, 1024, "bias"),
          ("mlp_out", M, I, H, 1024, "plain"),
          ("mlp_out", M, I, H, 1024, "bias_residual"),
          ("mini", 200, 384, 640, 512, "bias_gelu_preact")]
    k5 = [("mlp_out_dgrad", M, H, I, 1024, "fold"),
          ("mlp_in_dgrad", M, I, H, 512, "dgelu_fold_want_g"),
          ("mlp_in_dgrad", M, I, H, 512, "dgelu_fold"),
          ("mini", 200, 384, 640, 512, "dgelu_fold_want_g")]
    # K8 (on no path) at the mlp_in dgrad's shape: da, pre [M, I], the
    # re-quantized w_in.T [I, H].
    k8 = [("mlp_in_dgrad", M, I, H, 512, "dgelu_want_g"),
          ("mlp_in_dgrad", M, I, H, 512, "dgelu")]
    rows = {"k4": [int8_case(dev, g, "k4", *c) for c in k4],
            "k5": [int8_case(dev, g, "k5", *c) for c in k5],
            "k8": [int8_case(dev, g, "k8", *c) for c in k8]}
    import torch
    torch.cuda.empty_cache()
    return rows


def check_model(dev, model, gpt):
    """The kernel path against the plain path (dense attention, plain
    LayerNorm) with the same weights, on a 112-token prompt."""
    import torch
    plain = gpt.GptLM(dataclasses.replace(
        model.cfg, attention_backend="xla", fused_ln=False), device=dev)
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 112), generator=g,
                           device=dev)
    logits = []
    for m in (model, plain):
        caches = gpt.init_kv_cache(m.cfg, 1, 112, device=dev)
        logits.append(m.prefill(tokens, caches)[0].float())
    err = (logits[0] - logits[1]).abs().max().item()
    if not (logits[0].shape == (1, model.cfg.vocab_size)
            and torch.isfinite(logits[0]).all() and err <= MODEL_LOGIT_TOL):
        raise AssertionError(f"model logits: max_abs_err {err} (tol "
                             f"{MODEL_LOGIT_TOL})")
    del plain
    return err


def profile_request(client, prompt) -> dict:
    """``torch.profiler`` over one request (512-token prompt, 64 new
    tokens) through the HTTP tier: the card's busy share of the window
    and the kernels that take most of its device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.generate(prompt, NEW_TOKENS, tenant="profile")
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return dict(prompt_tokens=len(prompt), new_tokens=NEW_TOKENS,
                window_ms=window_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / window_ms if rows else None,
                top=[[name[:60], ms, n] for name, ms, n in rows[:8]])


def serve(dev):
    """Phase 4: the port's serving path over HTTP."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    from distributed_tensorflow_tpu_torch.serving.engine import (
        DecodeEngine, EngineConfig)
    from distributed_tensorflow_tpu_torch.serving.scheduler import (
        FairScheduler)
    from distributed_tensorflow_tpu_torch.serving.server import ServingServer
    from distributed_tensorflow_tpu_torch.utils.telemetry import Telemetry

    t0 = time.perf_counter()
    model = gpt.GptLM(gpt.GptConfig(**WIDTH), device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    logit_err = check_model(dev, model, gpt)
    telemetry = Telemetry()
    engine = DecodeEngine(model, None, EngineConfig(**ENGINE), telemetry,
                          device=dev)
    server = ServingServer(engine, FairScheduler(), port=0,
                           host="127.0.0.1", telemetry=telemetry)
    server.start()
    try:
        client = ServeClient(f"http://127.0.0.1:{server.port}",
                             timeout_s=600.0)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, WIDTH["vocab_size"], n).tolist()
                   for n in PROMPT_LENS]
        client.generate(prompts[0][:16], 4)            # warm-up
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        fa.launches = 0
        ln.launches = 0
        results: list = [None] * len(prompts)

        def send(i):
            kw = dict(tenant=("search", "ads")[i % 2])
            if i % 2:
                kw.update(temperature=0.8, top_k=40, seed=100 + i)
            results[i] = client.generate(prompts[i], NEW_TOKENS, **kw)

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(prompts))]
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t_burst
        again = client.generate(prompts[0], NEW_TOKENS, tenant="search")
        launches = {"flash_attention_fwd": fa.launches,
                    "layer_norm_fwd": ln.launches}
        stats = client.stats()
        profiled = profile_request(client, prompts[3])
    finally:
        server.shutdown()

    done = [r for r in results if r is not None]
    if len(done) != len(prompts):
        raise AssertionError(f"{len(done)}/{len(prompts)} requests done")
    for p, r in zip(prompts, done):
        if r["tokens_out"] != NEW_TOKENS or r["tokens"][:len(p)] != p \
                or len(r["tokens"]) != len(p) + NEW_TOKENS:
            raise AssertionError(f"incomplete response: {r['tokens_out']}")
        if not all(0 <= t < WIDTH["vocab_size"] for t in r["tokens"]):
            raise AssertionError("token outside the vocabulary")
    if again["tokens"] != done[0]["tokens"]:
        raise AssertionError("repeated greedy request gave other tokens")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    ttft = [r["ttft_ms"] for r in done]
    emit("profile", **profiled)
    emit("serve", model="gpt_406m_width", params=n_params,
         requests=len(done), new_tokens_each=NEW_TOKENS,
         prompt_lens=list(PROMPT_LENS), tokens_per_s=len(done) * NEW_TOKENS
         / burst_s, burst_s=burst_s, ttft_p50_ms=statistics.median(ttft),
         ttft_ms=ttft, tpot_p50_ms=statistics.median(
             r["tpot_ms"] for r in done),
         engine_steps=stats["engine"]["engine_step"],
         greedy_repeat_identical=True, launches=launches,
         model_logit_err=logit_err, model_logit_tol=MODEL_LOGIT_TOL,
         setup_s=setup_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def gpt_train_flops(cfg, B: int, S: int) -> float:
    """bench.py:523-531's analytic matmul flops of one train step (3x the
    forward: dense layers, attention scores and values, LM head)."""
    H, L, I, V = (cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                  cfg.vocab_size)
    per_layer = (2 * B * S * H * 3 * H + 2 * B * S * H * H
                 + 2 * 2 * B * S * S * H + 2 * 2 * B * S * H * I)
    return 3 * (L * per_layer + 2 * B * S * H * V)


def step_grads(model, loss_fn, batch, ctx=None):
    """One step's loss and flattened fp32 gradients of ``model`` (under
    ``ctx``), leaving no gradient behind."""
    import contextlib
    import torch
    model.train()
    model.zero_grad(set_to_none=True)
    with ctx or contextlib.nullcontext():
        loss, _ = loss_fn(model, batch)
        loss.backward()
    grads = torch.cat([p.grad.float().flatten() for p in model.parameters()])
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_steps(a, b, tols, names=("kernel", "plain")) -> dict:
    """Two steps' (loss, gradients), ``a`` the kernels' and ``b`` the one
    it is held to, within (loss, relative grad norm, min cosine)
    tolerances; the dict names them by ``names``."""
    import torch
    (la, ga), (lb, gb) = a, b
    na, nb = ga.norm().item(), gb.norm().item()
    out = {f"loss_{names[0]}": la, f"loss_{names[1]}": lb,
           "loss_diff": abs(la - lb), f"grad_norm_{names[0]}": na,
           f"grad_norm_{names[1]}": nb,
           "grad_norm_rel_diff": abs(na - nb) / nb,
           "grad_cos": torch.nn.functional.cosine_similarity(
               ga, gb, dim=0).item()}
    loss_tol, norm_rtol, min_cos = tols
    if not (math.isfinite(la) and math.isfinite(lb)
            and out["loss_diff"] <= loss_tol
            and out["grad_norm_rel_diff"] <= norm_rtol
            and out["grad_cos"] >= min_cos):
        raise AssertionError(f"train step, {names[0]} vs {names[1]}: {out}")
    return out


def check_train_step(dev, model, loss_fn, batch, tols):
    """One step's loss and gradients through the kernels against the plain
    path (dense attention, plain LayerNorm and, for ``matmul_int8``, the
    plain versions of K4/K5) with the same weights and batch.  ``tols``:
    (loss, relative grad norm, min cosine)."""
    import contextlib
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    from distributed_tensorflow_tpu_torch.ops import quant_train as qt

    @contextlib.contextmanager
    def plain_versions():
        """The int8 MLP through the plain versions of K4/K5, for this
        comparison only (the wrappers launch the kernels on the card)."""
        saved = qt.quantized_matmul, qt.quantized_matmul_nt
        qt.quantized_matmul = qmm.quantized_matmul_reference
        qt.quantized_matmul_nt = qmm.quantized_matmul_nt_reference
        try:
            yield
        finally:
            qt.quantized_matmul, qt.quantized_matmul_nt = saved

    plain = gpt.GptLM(dataclasses.replace(
        model.cfg, attention_backend="xla", fused_ln=False), device=dev,
        param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    kernel = step_grads(model, loss_fn, batch)
    plain_step = step_grads(plain, loss_fn, batch, plain_versions()
                            if plain.cfg.matmul_int8 else None)
    del plain
    loss_tol, norm_rtol, min_cos = tols
    out = dict(batch=len(batch["tokens"]),
               **compare_steps(kernel, plain_step, tols),
               loss_tol=loss_tol, grad_norm_rtol=norm_rtol,
               grad_min_cos=min_cos)
    del kernel, plain_step
    torch.cuda.empty_cache()
    return out


def profile_train_step(step, state, batch) -> dict:
    """``torch.profiler`` over one train step: the card's busy share of
    the step (the sum of its kernels' times over the step's wall time),
    the kernels that take most of it, and the operators they ran under
    (an operator's device time is that of the kernels it launched, and a
    user annotation such as the optimizer step spans kernels on the
    device's timeline too: only the kernels are summed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            row = (e.key, us / 1e3, e.count)
            kernel = (e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False))
            (kernels if kernel else ops).append(row)
    kernels.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    return dict(window_ms=window_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / window_ms if kernels else None,
                top_kernels=[[k[:60], ms, n] for k, ms, n in kernels[:10]],
                top_ops=[[k[:60], ms, n] for k, ms, n in ops[:10]])


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel name."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "layer_norm_fwd": ln.launches,
            "quant_matmul": qmm.launches,
            "quant_matmul_nt": qmm.nt_launches,
            "flash_attention_chunk": fa.chunk_launches,
            "flash_attention_chunk_dq": fa.chunk_dq_launches,
            "flash_attention_chunk_dkv": fa.chunk_dkv_launches,
            "quant_matmul_dgelu": qmm.dgelu_launches}


def reset_launch_counts() -> None:
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    fa.launches = fa.dq_launches = fa.dkv_launches = ln.launches = 0
    fa.chunk_launches = fa.chunk_dq_launches = fa.chunk_dkv_launches = 0
    qmm.launches = qmm.nt_launches = qmm.dgelu_launches = 0


def train_run(dev, cfg, steps: int, check=None, profile=True,
              mesh=None) -> dict:
    """The flagship step of ``cfg`` (fp32 masters, Adam, B=8, S=1024, the
    synthetic stream from its seed; ``mesh``: the ring backend's): the
    kernel-vs-plain ``check(model, loss_fn, batch)`` when given, then
    ``steps`` steps with the launch counters set to 0 just before and read
    just after, then one profiled step."""
    import torch
    from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    t0 = time.perf_counter()
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    model = gpt.GptLM(cfg, device=dev, seed=SEED, param_dtype=torch.float32,
                      mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    data = make_lm_datasets(cfg, seq_len=S).train

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}

    checked = None
    if check is not None:
        checked = check(model, loss_fn, data.next_batch(B))
    state = TrainState.create(model, make_optimizer("adam", TRAIN["lr"]))
    step = build_sync_train_step(loss_fn, log_grad_norm=True)
    batches = [data.next_batch(B) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    reset_launch_counts()
    losses, step_ms, grad_norms = [], [], []
    for batch in batches[:steps]:
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))      # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        grad_norms.append(float(metrics["grad_norm"]))
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profiled = profile_train_step(step, state, batches[steps]) \
        if profile else None
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if state.global_step != steps + 1 + int(profile):
        raise AssertionError(f"global_step {state.global_step}")
    del state, model
    torch.cuda.empty_cache()
    med_ms = statistics.median(step_ms[2:]) if steps > 2 else None
    flops = gpt_train_flops(cfg, B, S)
    return dict(
        params=n_params, batch=B, seq_len=S, steps=steps,
        optimizer="adam", lr=TRAIN["lr"], loss_first=losses[0],
        loss_last5_mean=statistics.mean(losses[-5:]), losses=losses,
        grad_norms=grad_norms, step_ms_median=med_ms, step_ms=step_ms,
        tokens_per_s=B * S / (med_ms / 1e3) if med_ms else None,
        model_tflops_per_step=flops / 1e12,
        mfu=flops / (med_ms / 1e3) / PEAK_BF16_FLOPS if med_ms else None,
        peak_mem_gb=peak_gb, launches=launches, kernel_vs_plain=checked,
        setup_s=setup_s, profiled=profiled)


def expect_launches(name, launches, per_step, steps) -> None:
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"{name} launches {launches}, expected "
                             f"{per_step} per step x {steps}")


def falls(name, run) -> None:
    if not run["loss_last5_mean"] < run["loss_first"]:
        raise AssertionError(f"{name}: loss did not fall: first "
                             f"{run['loss_first']}, mean of the last 5 "
                             f"{run['loss_last5_mean']}")


def train(dev, smi: str):
    """Phase 5: the port's GPT train step at GPT-406M width.  Returns the
    launches and the step's numbers the int8 phase is held to."""
    from distributed_tensorflow_tpu_torch.models import gpt
    cfg = gpt.GptConfig(**WIDTH)
    run = train_run(dev, cfg, TRAIN["steps"], check=lambda m, f, b: (
        check_train_step(dev, m, f, b, (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL,
                                        TRAIN_GRAD_MIN_COS))))
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 1}
    expect_launches("train", run["launches"], per_step, TRAIN["steps"])
    falls("train", run)
    emit("train_profile", **run.pop("profiled"))
    emit("train", model="gpt_406m_width", launches_per_step=per_step,
         card=smi, **run)
    return run["launches"], run


def train_int8(dev, smi: str, bf16: dict):
    """Phase 6: the same step with the int8 training MLP (K4, K5), then a
    short arm with the int8 attention projections as well."""
    from distributed_tensorflow_tpu_torch.models import gpt
    cfg = gpt.GptConfig(**WIDTH, matmul_int8=True)
    run = train_run(dev, cfg, TRAIN["steps"], check=lambda m, f, b: (
        check_train_step(dev, m, f, b, (TRAIN_INT8_LOSS_TOL,
                                        TRAIN_INT8_GRAD_NORM_RTOL,
                                        TRAIN_INT8_GRAD_MIN_COS))))
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 1,
                "quant_matmul": 2 * L, "quant_matmul_nt": 2 * L}
    expect_launches("train_int8", run["launches"], per_step, TRAIN["steps"])
    falls("train_int8", run)
    limit = INT8_LOSS_RATIO * bf16["loss_last5_mean"] + INT8_LOSS_SLACK
    if not run["loss_last5_mean"] <= limit:
        raise AssertionError(f"int8 loss {run['loss_last5_mean']} above "
                             f"{limit} (bf16 {bf16['loss_last5_mean']})")
    emit("train_int8_profile", **run.pop("profiled"))
    # MFU in bf16-equivalent model flops (bench.py's
    # gpt_int8_mfu_pct_bf16_equiv): the same flops over the bf16 peak.
    emit("train_int8", model="gpt_406m_width", launches_per_step=per_step,
         card=smi, loss_limit=limit, bf16_loss_last5_mean=bf16[
             "loss_last5_mean"],
         step_ms_ratio_to_bf16=run["step_ms_median"]
         / bf16["step_ms_median"], mfu_convention="bf16-equivalent", **run)
    arm = train_run(dev, gpt.GptConfig(**WIDTH, matmul_int8=True,
                                       attn_int8=True), ATTN_INT8_STEPS,
                    profile=False)
    emit("train_int8_attn", model="gpt_406m_width", card=smi,
         losses=arm["losses"], step_ms=arm["step_ms"],
         launches=arm["launches"], peak_mem_gb=arm["peak_mem_gb"])
    return run["launches"]


def check_ring_step(dev, model, loss_fn, batch) -> dict:
    """One ring step's loss and gradients through K6/K7 against the same
    ring with the plain chunk versions, and against the pallas step (K1/K2
    over the whole sequence), with the same weights and batch."""
    import contextlib
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import ring

    @contextlib.contextmanager
    def plain_chunks():
        """The ring's hops through the chunk functions' plain versions,
        for this comparison only (the wrappers launch the kernels on the
        card)."""
        names = ("flash_attention_chunk", "flash_attention_chunk_dq",
                 "flash_attention_chunk_dkv")
        saved = [getattr(ring, n) for n in names]
        for n in names:
            setattr(ring, n, getattr(fa, n + "_reference"))
        try:
            yield
        finally:
            for n, f in zip(names, saved):
                setattr(ring, n, f)

    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    kernel = step_grads(model, loss_fn, batch)
    vs_plain = compare_steps(kernel, step_grads(model, loss_fn, batch,
                                                plain_chunks()),
                             tols, ("kernel", "plain_chunks"))
    pallas = gpt.GptLM(dataclasses.replace(
        model.cfg, attention_backend="pallas"), device=dev,
        param_dtype=torch.float32)
    pallas.load_state_dict(model.state_dict())
    vs_pallas = compare_steps(kernel, step_grads(pallas, loss_fn, batch),
                              tols, ("kernel", "pallas"))
    del pallas, kernel
    out = dict(batch=len(batch["tokens"]), vs_plain_chunks=vs_plain,
               vs_pallas=vs_pallas, loss_tol=tols[0],
               grad_norm_rtol=tols[1], grad_min_cos=tols[2])
    torch.cuda.empty_cache()
    return out


def train_ring(dev, smi: str, bf16: dict):
    """Phase 7: the same step with sequence-parallel ring attention
    (``attention_backend="ring"``) over four sequence shards of 256 on the
    card: every block's attention through K6 forward and K7a/K7b backward
    per hop, K3 as before, no K1/K2."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.ring import _ring_hops
    cfg = gpt.GptConfig(**{**WIDTH, "attention_backend": "ring"})
    mesh = create_mesh(data=1, seq=RING_SEQ, devices=[dev] * RING_SEQ)
    run = train_run(dev, cfg, TRAIN["steps"], mesh=mesh,
                    check=lambda m, f, b: check_ring_step(dev, m, f, b))
    L = cfg.num_layers
    hops = _ring_hops(RING_SEQ, TRAIN["seq_len"] // RING_SEQ, True,
                      cfg.attention_window)
    per_hop = RING_SEQ * hops * L
    per_step = {"flash_attention_chunk": per_hop,
                "flash_attention_chunk_dq": per_hop,
                "flash_attention_chunk_dkv": per_hop,
                "layer_norm_fwd": 2 * L + 1}
    expect_launches("train_ring", run["launches"], per_step, TRAIN["steps"])
    falls("train_ring", run)
    emit("train_ring_profile", **run.pop("profiled"))
    emit("train_ring", model="gpt_406m_width", launches_per_step=per_step,
         card=smi, mesh=dict(data=1, seq=RING_SEQ, devices=str(dev)),
         hops=hops, step_ms_ratio_to_bf16=run["step_ms_median"]
         / bf16["step_ms_median"], bf16_loss_last5_mean=bf16[
             "loss_last5_mean"], **run)
    return run["launches"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_tensorflow_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = card()
    emit("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    kernels.load()
    emit("build", seconds=time.perf_counter() - t0,
         sources=[os.path.basename(s) for s in kernels.sources()])

    rows = check_kernels(dev)
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    # K8 is on no path: its launches are the kernels phase's own.
    by_path = {"kernels": {"quant_matmul_dgelu": qmm.dgelu_launches}}
    by_path["serve"] = serve(dev)
    torch.cuda.empty_cache()
    by_path["train"], bf16_step = train(dev, smi)
    by_path["train_int8"] = train_int8(dev, smi, bf16_step)
    torch.cuda.empty_cache()
    by_path["train_ring"] = train_ring(dev, smi, bf16_step)
    for row in rows:
        row["launches"] = by_path[row["main"]][row["name"]]
        for path, sub in row["paths"].items():
            sub["launches"] = by_path[path][row["name"]]
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
