#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: the hand-written CUDA kernels, compiled from ``csrc/``,
   with ``-Xptxas -v``'s registers, spills and static shared memory of
   the K1/K2/K6/K7 bf16 (wgmma) kernels and of K4/K5's quantize pass and
   int8 GEMM, beside the dynamic shared memory their launchers request.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   in bf16 at the shapes each path gives it (K1 and K3 at the serving
   path's and the train step's, K3 also at the decode step's 8 rows, K2a
   and K2b at the train step's, K1, K2a and K2b also at head_dim 64 and
   32, K4 and K5 at the int8 MLP's four call sites of the int8 train
   step, every epilogue and prologue variant, and one small non-square
   case, each also as its two kernels apart (the quantize pass and the
   block-scaled GEMM, each held bit for bit to its plain version, the
   GEMM's gelu output within one ulp; K4's weight transpose too); K6, K7a
   and K7b at the ring train step's per-hop shape, q/k/v
   shards [8, 256, 16, 128], for a chunk wholly visible, on the diagonal
   and wholly in the future, a padding mask with fully masked rows, a
   window, non-causal, D = 64 and D = 32, K6 in the in-place form the
   ring calls (held bit for bit to its out-of-place form, and a chunk in
   the future must leave the carries untouched), K7a and K7b adding into
   fp32 sums as the ring calls them (held bit for bit to the out-of-place
   partial + ``add_``, a chunk in the future leaving the sums untouched,
   two calls bit-equal), then the 4-shard ring
   over them against K1/K2 on the whole sequence; K8, on no path, at the
   int8 MLP's mlp_in dgrad shape, with and without g, also as its three
   launches apart, as K4's; K3 also at the chunked prefill's dispatch
   and the speculative verify's rows; K1 at the generate phase's prefill
   and K3 at its decode step's rows), with the tolerance stated below, its
   time, the plain version's time, one library call's time (used only
   here, never by the port; K4/K5/K8 have two labelled yardsticks) and
   the least time the card could take; K1, K2, K3 and K6 rows also carry
   ``ratio_to_library`` (kernel over library time; K2's and K7's library
   call computes dq, dk and dv, so their rows give ``pair_ratio_to_library``
   for K2a + K2b, K7a + K7b), K1/K2 ``tflops`` (the useful operations the bound counts,
   over the kernel's time); K1 and K3 rows add ``host_ms`` and
   ``library_host_ms``, the host time per call of each (at the serving
   shapes it exceeds the kernel's device time; K6/K7 ``host_ms`` too),
   K3, K6 and K7 rows ``device_ms`` (K3 also ``library_device_ms``), the
   device's time per call apart from the host's (calls captured in a
   CUDA graph and replayed, ``utils/cuda_timing.py``).
4. ``serve``: a GPT at the widths of the repo's GPT-406M (hidden 2048,
   8 layers, 16 heads, MLP 8192, vocab 256, bf16, random weights from a
   seeded generator) behind ``ServingServer``; 8 concurrent HTTP requests
   from two tenants (prompts of 100-777 tokens, 64 new tokens each, greedy
   and seeded-sampled) through ``ServeClient``.  The kernels' launch
   counters are set to 0 just before and read just after.  Before it, the
   ``profile`` line: ``torch.profiler`` over one more request, the card's
   busy share of it and the kernels that took its device time.
5. ``serve_chunked``: the same model and requests through an engine with
   ``prefill_chunk=128``.  Gate: in fp32 at the full width and 2 layers,
   every prompt's greedy tokens equal the whole-bucket engine's.  Then
   each prompt's first-token logits within
   ``MODEL_LOGIT_TOL`` of the whole-bucket engine's, each request's tokens
   against the serve phase's (the first divergence printed, not gated: a
   bf16 near-tie may flip an argmax), K3's launches exact (2 a layer a
   chunk dispatch, 2 a layer + 1 a decode step, no K1), and tokens/s,
   TTFT and TPOT beside the serve phase's.
6. ``serve_spec``: the speculative arm (``spec_k=4``, ``spec_ngram=3``)
   on greedy ``speculative=True`` requests whose prompts repeat a seeded
   24-token phrase to the serve phase's lengths.  Gate: in fp32 at the
   full width and 2 layers, every request's tokens equal the plain
   engine's.  Then the bf16 model over HTTP, the plain engine and the
   speculative one: the accepted share of the drafts, spec rounds,
   tokens/s and TPOT, K1 and K3 launches exact.
7. ``generate``: the library decode family on the same model
   (``generate``, ``generate_cached``, ``beam_search_cached``,
   ``generate_cached_speculative`` and ``..._device``) at B=4 prompts of
   384 tokens.  Gates, in fp32 at the full width and 2 layers: every
   greedy arm gives ``generate_cached``'s tokens, and with
   ``attention_window=256`` the ring cache gives the uncached loop's
   (K1's window band).  Then the bf16 model: ``generate_cached``'s
   tokens/s, ms a step, prefill ms and peak memory (128 new tokens), a
   width-4 beam's ms a token, both speculative loops on repeated-phrase
   prompts beside ``generate_cached``, the int8-weight / float8-cache
   arm's first divergence from bf16 (not gated), and the
   ``generate_profile`` line over 16 tokens; every arm's K1 and K3
   launches exact (the fp32 host loop's fallback finish aside).
8. ``checkpoint``: from a checkpoint on disk to tokens, on the same
   model.  ``save_raw`` writes it as the JAX trainer saves (fp32 arrays,
   ``{params, global_step}``, step 1) under a ``tempfile`` directory
   (removed afterwards); the serving CLI (``tools/serve.py --hot_swap``)
   serves it as a process and gets the serve phase's 8 requests (gate:
   the greedy ones' tokens are the serve phase's in-process engine's);
   step 2 (seed-1 weights) is saved while a 900-token request streams
   (gates: the stream runs to its budget, ``/statz`` shows the swap, a
   later request gets the tokens of an engine on the step-2 weights in
   memory); in this process, an engine on the restored tree gives the
   in-memory engine's tokens with K1 8 a prefill and K3 17 a prefill or
   step; ``train.py --mode=generate`` greedy, beam 4 and speculative 8,
   each a process, give the in-process decode family's tokens.  It
   prints the write and restore GB/s, the CLI's startup seconds, the
   time from step 2's rename into place to its adoption, and tokens/s.
9. ``train``: the flagship GPT train step (``bench.py``'s: the same
   widths, fp32 master weights, bf16 compute, ``attention_backend=
   "pallas"``, plus ``fused_ln=True``; Adam 3e-4, B=8, S=1024, the
   synthetic LM stream) through ``TrainState`` and
   ``build_sync_train_step``.  First one step's loss and gradients through
   the kernels against the plain path with the same weights and batch;
   then 30 steps with the launch counters set to 0 just before and read
   just after (the loss must stay finite and fall); then the
   ``train_profile`` line, ``torch.profiler`` over one more step.
10. ``train_int8``: the same step with ``matmul_int8=True`` (bench.py's
   int8 arm, :2271): each block's gelu MLP through K4 and K5.  The same
   kernel-vs-plain check (the plain path also takes the plain versions of
   K4/K5), 30 steps with exact launch counts (K4 and K5 twice per layer,
   each call one quantize pass and one GEMM, K4's one weight transpose),
   the loss held to the bf16 phase's, the ``train_int8_profile`` line,
   then a short arm with ``attn_int8=True`` as well (bench.py :2287).
11. ``train_ring``: the same step with ``attention_backend="ring"``
    (``train.py --sequence_parallel=4 --attention_backend=ring``) on a
    mesh of four sequence shards of 256 on the card: each block's
    attention is a 4-hop ring through K6 forward and K7a/K7b backward.
    One step's loss and gradients against the same ring through the
    plain chunk versions and against the pallas step (K1/K2), then 30
    steps with exact launch counts (K6, K7a, K7b each 4 shards x 4 hops x
    8 layers = 128 per step, K3 17, K1/K2 none), a falling loss, and the
    ``train_ring_profile`` line.

Then the card's name and power limit, the kernels' summary object, and
last ``{"ok": true, "device": {...}}``.  A summary row's numbers and
launches are those of its main path (``main``: the train step for
K1/K2/K3, the int8 train step for K4/K5, the ring train step for K6/K7,
whose numbers are the mean per launch over a step's hops, and the
``kernels`` phase itself for K8, which no path launches); its ``paths``
hold each path's own shape, numbers and launches (K1's and K3's
``generate``: the prefill of B=4 x 384 and the decode step's 4 rows,
with the bf16 ``generate_cached`` arm's launches; their ``checkpoint``:
the serve prefill's case, with the restored engine's launches), K4/K5/K8 rows list
their call sites or variants under ``sites``, and K6's ``hop_kinds``
hold its visible and diagonal hops' own times and ratios to SDPA, K7a's
and K7b's every hop kind's, with the pair's ratio to SDPA's backward.
Any failing phase raises: the script exits non-zero and prints no
result.  Without CUDA it exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
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
# The serve_chunked and serve_spec phases' engine arms.
PREFILL_CHUNK = 128
SPEC_K = 4
SEED = 0
# The generate phase: B prompts of `prompt` tokens; `new` tokens in the
# fp32 gates (`uncached` for the O(S^2) loop), `bf16_new` at full depth;
# a width-4 beam over `beam_new`; spec_k 8; the window gate's window
# (total length above it).
GEN = dict(batch=4, prompt=384, new=64, uncached=16, bf16_new=128,
           beam=4, beam_new=64, spec_k=8, window=256, window_prompt=300,
           window_new=24)
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


def host_ms(fn, reps: int = 500) -> float:
    """Host milliseconds per call of back-to-back calls (the wrapper's
    Python and launch cost; the card is left to catch up afterwards).
    Where it exceeds the device time, ``cuda_ms`` times the host."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def warm_up(dev, seconds: float = 1.0) -> None:
    """Bring the card's clocks up before the first timing (the kernels
    phase times K1 at the serving shape first): back-to-back bf16 GEMMs
    for about ``seconds``."""
    import torch
    a = torch.randn(4096, 4096, device=dev).to(torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def bound(bytes_moved: float, flops: float,
          peak_ops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_build_report(kernels, lib) -> list[dict]:
    """ptxas's registers, spills and static shared memory (``-Xptxas
    -v``) of the K1/K2/K6/K7 bf16 kernels, with the dynamic shared memory
    their launchers request."""
    import re
    rows = []
    for kind, entry in (("flash_fwd_wgmma", lib.dtt_flash_attention_fwd_smem),
                        ("flash_bwd_dq_wgmma",
                         lib.dtt_flash_attention_bwd_smem),
                        ("flash_bwd_dkv_wgmma",
                         lib.dtt_flash_attention_bwd_smem),
                        ("chunk_fwd_wgmma",
                         lib.dtt_flash_attention_chunk_smem),
                        ("chunk_dq_wgmma", lambda d: (
                            lib.dtt_flash_attention_chunk_bwd_smem(d, 0))),
                        ("chunk_dkv_wgmma", lambda d: (
                            lib.dtt_flash_attention_chunk_bwd_smem(d, 1)))):
        for r in kernels.ptxas_report(kind):
            d = int(re.search(kind + r"ILi(\d+)E", r["kernel"]).group(1))
            rows.append(dict(kernel=f"{kind}<{d}>", registers=r.get(
                "registers"), spill_stores=r["spill_stores"],
                spill_loads=r["spill_loads"], stack_bytes=r["stack_bytes"],
                smem_static=r["smem_static"], smem_dynamic=entry(d)))
    return rows


def quant_build_report(kernels, lib) -> list[dict]:
    """ptxas's registers and spills of K4/K5's kernel A (quantize_blocks,
    per dtype and K-block) and kernel B (qgemm_wgmma, per dtype, with the
    dynamic shared memory its launcher requests)."""
    import re
    rows = []
    for kind in ("quantize_blocks", "qgemm_wgmma"):
        for r in kernels.ptxas_report(kind):
            # <T, bk> or <T, BN, stages>, as the mangled name gives them.
            m = re.search(kind + r"I(13__nv_bfloat16|f)(.*?)EEEv",
                          r["kernel"])
            targs = ["bf16" if "bfloat" in m.group(1) else "f32"] + \
                re.findall(r"Li(\d+)E", m.group(2) + "E")
            rows.append(dict(
                kernel=f"{kind}<{', '.join(targs)}>",
                registers=r.get("registers"),
                spill_stores=r["spill_stores"], spill_loads=r["spill_loads"],
                stack_bytes=r["stack_bytes"],
                smem_dynamic=(lib.dtt_quant_gemm_smem()
                              if kind == "qgemm_wgmma" else 0)))
    return rows


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

    def kernel():
        return fa.flash_attention(q, k, v, mask, **kw)
    ms, library_ms = cuda_ms(kernel), cuda_ms(lib)
    return dict(ms=ms, plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                    q, k, v, mask, **kw)),
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                ratio_to_library=ms / library_ms,
                tflops=4 * D * pairs / (ms * 1e-3) / 1e12,
                host_ms=host_ms(kernel), library_host_ms=host_ms(lib))


def check_k3(name, x, scale, bias) -> dict:
    """K3 against the plain version on [rows, H] ``x``, with its times."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.utils.cuda_timing import graph_ms
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

    def kernel():
        return ln.layer_norm(x, scale, bias)

    def lib():
        # bf16 weights: F.layer_norm's one-call form writes bf16 (2 bytes
        # an element where K3 writes 4: the yardstick moves fewer bytes).
        return F.layer_norm(x, (Hd,), s16, b16, 1e-6)
    ms, library_ms = cuda_ms(kernel), cuda_ms(lib)
    return dict(
        case=name, rows=rows, H=Hd, max_abs_err=err, tol=K3_TOL, ms=ms,
        plain_ms=cuda_ms(lambda: ln.layer_norm_reference(x, scale, bias)),
        library_ms=library_ms, ratio_to_library=ms / library_ms,
        library="F.layer_norm, bf16 weights, bf16 out", bound_ms=b_ms,
        bound_by=b_by, host_ms=host_ms(kernel), library_host_ms=host_ms(lib),
        device_ms=graph_ms(kernel), library_device_ms=graph_ms(lib))


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
    warm_up(dev)

    def qkv(B, d=D, s=S):
        # Views into one fused [B, S, 3, H, D] projection, as on the path.
        t = torch.randn(B, s, 3, H, d, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        return t[:, :, 0], t[:, :, 1], t[:, :, 2]

    masked_tail = torch.ones(2, S, dtype=torch.int32, device=dev)
    masked_tail[1, S - 300:] = 0
    masked_head = torch.ones(1, S, dtype=torch.int32, device=dev)
    masked_head[0, :10] = 0        # causal rows 0..9 see no valid key
    # (name, B, kv_mask, window, head_dim, S); head_dim 32 is the JAX
    # GptConfig's default width (hidden 128, 4 heads); the generate
    # phase's prefill is B=4 prompts of 384 tokens.
    cases = [("causal", 1, None, 0, D, S),
             ("kv_mask", 2, masked_tail, 0, D, S),
             ("window", 1, None, 256, D, S),
             ("masked_rows", 1, masked_head, 0, D, S),
             ("head_dim_32", 1, None, 0, 32, S),
             ("generate_prefill", GEN["batch"], None, 0, D, GEN["prompt"])]
    k1_cases = []
    for name, B, mask, window, d, s in cases:
        q, k, v = qkv(B, d, s)
        out, lse = fa.flash_attention(q, k, v, mask, causal=True,
                                      window=window)
        err, lse_err = check_k1(name, q, k, v, mask, out, lse, causal=True,
                                window=window)
        valid = attention_valid(B, s, mask, causal=True, window=window,
                                device=dev)
        k1_cases.append(dict(
            case=name, B=B, S=s, H=H, D=d, window=window, max_abs_err=err,
            tol=K1_OUT_TOL, lse_err=lse_err, lse_tol=K1_LSE_TOL,
            **k1_timings(q, k, v, mask, valid, causal=True, window=window)))

    k3_cases = []
    Hd = WIDTH["hidden_size"]
    # The serving path's prefill and decode rows, and the train step's
    # B*S rows of the bf16 residual stream.
    # The chunked prefill's dispatch (every slot's chunk) and the
    # speculative verify (every slot's spec_k tokens) too, and the generate
    # phase's decode step (its B rows).
    for name, rows in (("prefill", S), ("decode", ENGINE["num_slots"]),
                       ("train", TRAIN["batch"] * TRAIN["seq_len"]),
                       ("chunk_prefill", ENGINE["num_slots"] * PREFILL_CHUNK),
                       ("verify", ENGINE["num_slots"] * SPEC_K),
                       ("generate_decode", GEN["batch"])):
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
    # K1, K2, K3 and K6 also carry their time over the library call's, K1
    # and K2 the useful TFLOP/s they reach (the valid pairs the bound
    # counts), K1 and K3 their host time per call.
    extra = ("ratio_to_library", "tflops", "pair_ms",
             "pair_ratio_to_library", "host_ms", "library_host_ms",
             "device_ms", "library_device_ms", "out_of_place_ms")
    # K4/K5's two kernels (A, the quantize pass; B, the GEMM) and K4's
    # weight transpose, per call site.
    stage_keys = ("a_ms", "a_bound_ms", "a_bound_by", "b_ms", "b_bound_ms",
                  "b_bound_by", "b_tops", "b_ratio_to_library",
                  "transpose_ms", "transpose_plain_ms", "stages_bit_equal",
                  "bit_equal")

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
            **{k: by_path[main][k] for k in extra if k in by_path[main]},
            paths={path: dict(case=c["case"], launches=0,
                              max_abs_err=c["max_abs_err"],
                              **{k: c[k] for k in keys},
                              **{k: c[k] for k in extra if k in c})
                   for path, c in by_path.items()})
        if sites:
            row["library_bf16_ms"] = by_path[main]["library_bf16_ms"]
            row["sites"] = [dict(case=c["case"], variant=c["variant"],
                                 M=c["M"], K=c["K"], N=c["N"],
                                 max_abs_err=c["max_abs_err"],
                                 library_bf16_ms=c["library_bf16_ms"],
                                 **{k: c[k] for k in keys},
                                 **{k: c[k] for k in stage_keys if k in c})
                            for c in sites]
            # K4/K5: kernel A's and kernel B's own numbers at the main site.
            row.update({k: by_path[main][k] for k in stage_keys
                        if k in by_path[main]})
        return row
    k4, k5, k8 = k45["k4"], k45["k5"], k45["k8"]
    # K6's hop mean counts the future hops, a bare launch in place against
    # SDPA's full masked attention: its visible and diagonal hops carry
    # their own time over SDPA's.
    k6 = summary("flash_attention_chunk", "flash_attention_chunk.cu",
                 "flash_attention.py:624", "train_ring",
                 {"train_ring": k67["k6"][0]}, k67["k6"])
    k6["hop_kinds"] = {c["case"]: {k: c[k] for k in (
        "ms", "device_ms", "library_ms", "ratio_to_library")}
        for c in k67["k6"] if c["case"] in ("visible", "diagonal")}
    # K7a and K7b: each hop kind's own times, in place and out of place,
    # and the pair's over SDPA's backward.
    k7 = {}
    for key, name, line in (("k7a", "flash_attention_chunk_dq", 767),
                            ("k7b", "flash_attention_chunk_dkv", 796)):
        k7[key] = summary(name, "flash_attention_chunk.cu",
                          f"flash_attention.py:{line}", "train_ring",
                          {"train_ring": k67[key][0]}, k67[key])
        k7[key]["hop_kinds"] = {c["case"]: {k: c[k] for k in (
            "ms", "device_ms", "out_of_place_ms", "library_ms",
            "pair_ratio_to_library")}
            for c in k67[key] if c["case"] in ("visible", "diagonal",
                                               "future")}
    return [
        summary("flash_attention_fwd", "flash_attention.cu",
                "flash_attention.py:119", "train",
                {"serve": k1_cases[0], "train": k2["fwd"],
                 "generate": k1_cases[5], "checkpoint": k1_cases[0]},
                k1_all),
        # Serving launches K3 at its prefill and its decode rows: both
        # rows carry the serving run's launches (one counter).
        summary("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:38",
                "train", {"serve": k3_cases[0], "serve_decode": k3_cases[1],
                          "train": k3_cases[2], "train_ring": k3_cases[2],
                          "serve_chunked": k3_cases[3],
                          "serve_spec": k3_cases[4],
                          "generate": k3_cases[5],
                          "checkpoint": k3_cases[0]},
                k3_cases),
        summary("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
                "flash_attention.py:425", "train", {"train": k2["dkv"][0]},
                k2["dkv"]),
        summary("flash_attention_bwd_dq", "flash_attention_bwd.cu",
                "flash_attention.py:465", "train", {"train": k2["dq"][0]},
                k2["dq"]),
        # Each runs at two call sites per layer of the int8 step: the
        # row's numbers are the mlp_in site's (K4 its forward, K5 its
        # dgrad with g), ``sites`` has both.
        summary("quant_matmul", "quant_gemm.cu", "quant_matmul.py:93",
                "train_int8", {"train_int8": k4[0]}, k4, sites=k4[:2]),
        summary("quant_matmul_nt", "quant_gemm.cu", "quant_matmul.py:185",
                "train_int8", {"train_int8": k5[1]}, k5, sites=k5[:2]),
        # The ring's per-hop kernels: the row's numbers are the mean per
        # launch over one train step's hops (visible, diagonal, future).
        k6, k7["k7a"], k7["k7b"],
        # On no path of the port (nor of the JAX package): its main is this
        # phase, and its launches are this phase's.
        summary("quant_matmul_dgelu", "quant_gemm.cu",
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
             ("head_dim_64", 2, None, True, 0, 64),
             ("head_dim_32", 2, None, True, 0, 32)]
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
        # dkv: reads q, k, v, dO, lse and delta, writes dk and dv; S, dP,
        # dV, dK.  Each row's ratio is its own time over the library's
        # (which computes all three gradients); the pair's is their sum's.
        dq_ms, dkv_ms = cuda_ms(run_dq), cuda_ms(run_dkv)
        pair = dict(pair_ms=dq_ms + dkv_ms,
                    pair_ratio_to_library=(dq_ms + dkv_ms) / lib_ms)
        b_ms, b_by = bound(6 * one + 2 * stats + extra, 3 * 2 * pairs * d)
        rows["dq"].append(dict(base, max_abs_err=errs["dq"][0],
                               rel_err=errs["dq"][1], ms=dq_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               ratio_to_library=dq_ms / lib_ms,
                               tflops=3 * 2 * pairs * d / (dq_ms * 1e-3)
                               / 1e12, **pair))
        b_ms, b_by = bound(6 * one + 2 * stats + extra, 4 * 2 * pairs * d)
        rows["dkv"].append(dict(
            base, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
            rel_err=max(errs["dk"][1], errs["dv"][1]), ms=dkv_ms,
            bound_ms=b_ms, bound_by=b_by, ratio_to_library=dkv_ms / lib_ms,
            tflops=4 * 2 * pairs * d / (dkv_ms * 1e-3) / 1e12, **pair))
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
    from distributed_tensorflow_tpu_torch.utils.cuda_timing import graph_ms
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

    # K6, in the in-place form the ring calls (on copies of the carries),
    # held bit for bit to the out-of-place form and to the plain version.
    def run_fwd():
        return fa.flash_attention_chunk(q, k, v, mask, m, l, acc, **kw)

    carries = [t.clone() for t in (m, l, acc)]

    def run_in_place():
        return fa.flash_attention_chunk(q, k, v, mask, *carries, **kw,
                                        in_place=True)

    def plain_fwd():
        return fa.flash_attention_chunk_reference(q, k, v, mask, m, l, acc,
                                                  **kw)
    got, want = run_fwd(), plain_fwd()
    in_place = run_in_place()
    torch.cuda.synchronize()
    if not all(a is b for a, b in zip(in_place, carries)) or not all(
            torch.equal(a, b) for a, b in zip(in_place, got)):
        raise AssertionError(f"K6 {name}: in place differs from out of "
                             "place")
    if not pairs and not all(torch.equal(a, b)
                             for a, b in zip(carries, (m, l, acc))):
        raise AssertionError(f"K6 {name}: a chunk in the future must leave "
                             "the carries untouched in place")
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
    # In place, operands and carries move only where some pair is visible:
    # a chunk in the future needs no byte moved.
    b_ms, b_by = bound(3 * one + extra + 2 * carry if pairs else 0,
                       2 * 2 * pairs * D)
    ms = cuda_ms(run_in_place)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=lib_mask))
    k6 = dict(base, max_abs_err=max(m_err, l_err, acc_err), m_err=m_err,
              l_rel_err=l_rel, acc_rel_err=acc_rel, tol_rel=K67_REL_TOL,
              ms=ms, device_ms=graph_ms(run_in_place),
              host_ms=host_ms(run_in_place),
              out_of_place_ms=cuda_ms(run_fwd),
              plain_ms=cuda_ms(plain_fwd), library_ms=library_ms,
              ratio_to_library=ms / library_ms,
              library="SDPA forward on the chunk pair, same boolean mask "
                      "(returns no carry)",
              bound_ms=b_ms, bound_by=b_by)

    # K7a and K7b from the finished state's lse; timed in the form the
    # ring calls, adding into fp32 sums in flight (copies), held bit for
    # bit to the out-of-place partial + add_.
    lse = want[0] + torch.log(want[1].clamp_min(1e-30))
    do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    delta = torch.randn(B, H, n, generator=g, device=dev)
    args = (q, k, v, mask, do, lse, delta)
    bufs = [torch.randn(B, H, n, D, generator=g, device=dev)
            for _ in range(3)]                   # dq, dk, dv sums
    sums = [t.clone() for t in bufs]

    def run_dq():
        return fa.flash_attention_chunk_dq(*args, **kw)

    def run_dkv():
        return fa.flash_attention_chunk_dkv(*args, **kw)

    def add_dq(out=sums[0]):
        return fa.flash_attention_chunk_dq(*args, **kw, out=out)

    def add_dkv(out=(sums[1], sums[2])):
        return fa.flash_attention_chunk_dkv(*args, **kw, out=out)

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
    parts = (run_dq(), *run_dkv())
    added = (add_dq(), *add_dkv())
    again = [t.clone() for t in bufs]
    add_dq(again[0])
    add_dkv(tuple(again[1:]))
    torch.cuda.synchronize()
    if not all(a is t for a, t in zip(added, sums)):
        raise AssertionError(f"K7 {name}: out= must return the buffers")
    if not all(torch.equal(a, b + p) for a, b, p in zip(added, bufs, parts)):
        raise AssertionError(f"K7 {name}: adding in place differs from the "
                             "out-of-place partial + add_")
    if not pairs and not all(torch.equal(a, b) for a, b in zip(added, bufs)):
        raise AssertionError(f"K7 {name}: a chunk in the future must leave "
                             "the sums untouched")
    if not all(torch.equal(a, b) for a, b in zip(again, added)) or not all(
            torch.equal(a, b) for a, b in zip(parts, (run_dq(), *run_dkv()))):
        raise AssertionError(f"K7 {name}: two calls differ")
    ql, kl, vl = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask)
    lib_do = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), lib_do, retain_graph=True))
    lib = dict(library_ms=lib_ms,
               library="autograd.grad through SDPA on the chunk pair, "
                       "dq, dk and dv in one call (same number both rows)")
    # Added in place, operands and sums move only where some pair is
    # visible: an fp32 sum's rows read and written once (a chunk in the
    # future needs no byte moved).
    ops_bytes = 4 * one + 2 * stats + extra if pairs else 0
    sum_bytes = 2 * stats * D if pairs else 0

    def times(add, run, plain):
        ms = cuda_ms(add)
        return dict(ms=ms, device_ms=graph_ms(add), host_ms=host_ms(add),
                    out_of_place_ms=cuda_ms(run), plain_ms=cuda_ms(plain))
    # dq: S, dP, dQ, into the dq sum.
    b_ms, b_by = bound(ops_bytes + sum_bytes, 3 * 2 * pairs * D)
    k7a = dict(base, max_abs_err=errs["dq"][0], rel_err=errs["dq"][1],
               tol_rel=K67_REL_TOL, **times(add_dq, run_dq, plain_dq),
               bound_ms=b_ms, bound_by=b_by, **lib)
    # dkv: S, dP, dV, dK, into the dk and dv sums.
    b_ms, b_by = bound(ops_bytes + 2 * sum_bytes, 4 * 2 * pairs * D)
    k7b = dict(base, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
               rel_err=max(errs["dk"][1], errs["dv"][1]),
               tol_rel=K67_REL_TOL, **times(add_dkv, run_dkv, plain_dkv),
               bound_ms=b_ms, bound_by=b_by, **lib)
    # The pair against SDPA's backward, which computes dq, dk and dv.
    pair = dict(pair_ms=k7a["ms"] + k7b["ms"],
                pair_ratio_to_library=(k7a["ms"] + k7b["ms"]) / lib_ms)
    k7a.update(pair)
    k7b.update(pair)
    del got, want, in_place, carries, lib_out, ql, kl, vl, bufs, sums, again
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
    rows, a window, non-causal, D = 64 and D = 32; then the ring against
    K1/K2.  The path's row is the per-launch mean over one step's hops: of
    the 16 (shard, chunk) pairs of a 4-shard causal ring 6 are visible, 4
    diagonal, 6 in the future (K6 timed in place, as the ring calls it)."""
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
    for d in (D, 64, 32):
        fused = torch.randn(B, S, 3, H, d, generator=g, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
        for name, q_off, k_off, kw in (cases if d == D else cases[1:2]):
            label = name if d == D else f"head_dim_{d}"
            for key, row in ring_chunk_case(dev, g, fused, label, q_off,
                                            k_off, **kw).items():
                rows[key].append(row)
        del fused
    weights = {"visible": 6, "diagonal": 4, "future": 6}
    for key, cs in rows.items():
        mix = [c for c in cs if c["case"] in weights]
        total = sum(weights.values())
        keys = [k for k in ("ms", "device_ms", "host_ms", "out_of_place_ms",
                            "plain_ms", "bound_ms", "library_ms", "pairs")
                if k in mix[0]]
        row = {k: sum(weights[c["case"]] * c[k] for c in mix) / total
               for k in keys}
        if key == "k6":
            row["ratio_to_library"] = row["ms"] / row["library_ms"]
        else:
            row["pair_ms"] = sum(
                sum(weights[c["case"]] * c["ms"] for c in rows[kk]
                    if c["case"] in weights) / total
                for kk in ("k7a", "k7b"))
            row["pair_ratio_to_library"] = row["pair_ms"] / row["library_ms"]
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
    # K4 without gelu and K5's fold variant hold the plain version's bits.
    no_tanh = variant in ("plain", "bias", "bias_residual", "fold")
    for name, x, y in zip(("out", "second"), got, want):
        err = (x.float() - y.float()).abs().max().item()
        peak = y.float().abs().max().item()
        if no_tanh:
            ok, tol = torch.equal(x, y), "bit-equal (no tanh enters)"
        elif kind != "k4" and name == "second":          # g: elementwise
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
    library_ms = cuda_ms(lambda: torch._int_mm(q_lib, qw_lib))
    row = dict(case=case, variant=variant, M=M, K=K, N=N,
               block_k=qmm._pick(K, block_k),
               max_abs_err=max(e["max_abs_err"] for e in errs), errors=errs,
               ms=cuda_ms(lambda: kernel(*args, **kw)),
               plain_ms=cuda_ms(lambda: plain(*args, **kw)),
               bound_ms=b_ms, bound_by=b_by,
               # Yardsticks, never called by the port: the library's int8
               # GEMM on operands already quantized, and the bf16 GEMM of
               # the same M, K, N.
               library_ms=library_ms,
               library="torch._int_mm on pre-quantized int8 operands",
               library_bf16_ms=cuda_ms(lambda: torch.matmul(a, w_bf16)))
    # Bit for bit or not (every no-tanh variant is held to it above).
    row["bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, want))
    row.update(int8_stages(kind, args, kw, library_ms))
    del args, got, want, q_lib, w_bf16
    return row


def int8_stages(kind, args, kw, library_ms) -> dict:
    """K4's, K5's or K8's two kernels one at a time on the call's inputs:
    kernel A (the quantize pass) and kernel B (the block-scaled GEMM on A's
    codes) each held bit for bit to its plain version (B within one ulp of
    the peak where gelu enters), each timed, with its bound; B's TOP/s and
    its time over ``torch._int_mm``'s (``library_ms``); for K4 and K8 the
    weight transpose kernel, held bit for bit to ``qw.t()`` and timed
    beside ``qw.t().contiguous()``."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    if kind == "k8":
        a, pre, qw, sw = args
    else:
        a, qw, sw = args[:3]
    M, K = a.shape
    bk = qmm._block_k(K, kw["block_k"])
    if kind == "k8":
        # A with gelu' and g but no fold; B with the bare ``* sw``.
        qa = dict(pre=pre, sf=None, want_g=kw["want_g"])
        w = qw.t().contiguous()
        gemm_args = (w, bk, sw)
        gemm_kw = dict(out_dtype=a.dtype)
    elif kind == "k4":
        bias, residual = args[3], args[4]
        qa = dict(pre=None, sf=None, want_g=False)
        w = qw.t().contiguous()
        gemm_args = (w, bk, sw, bias, residual)
        gemm_kw = dict(activation=kw.get("activation"),
                       want_preact=kw.get("want_preact", False),
                       out_dtype=a.dtype)
    else:
        qa = dict(pre=args[3], sf=sw, want_g=kw.get("want_g", False))
        w = qw
        gemm_args = (w, bk)
        gemm_kw = dict(out_dtype=a.dtype)
    N = w.shape[0]

    def stage_a():
        return qmm.quantize_blocks(a, bk, qa["pre"], qa["sf"],
                                   want_g=qa["want_g"])

    got_a = stage_a()
    want_a = qmm.quantize_blocks_reference(a, bk, qa["pre"], qa["sf"],
                                           want_g=qa["want_g"])
    q, sx, _ = want_a

    def stage_b():
        return qmm.blocked_gemm(q, sx, *gemm_args, **gemm_kw)

    got_b = stage_b()
    want_b = qmm.blocked_gemm_reference(q, sx, *gemm_args, **gemm_kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("q", "sx", "g"), got_a, want_a):
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            raise AssertionError(f"{kind} kernel A: {name} differs from "
                                 "its plain version")
    got_b = got_b if isinstance(got_b, tuple) else (got_b,)
    want_b = want_b if isinstance(want_b, tuple) else (want_b,)
    b_err = 0.0
    for i, (x, y) in enumerate(zip(got_b, want_b)):
        if gemm_kw.get("activation") != "gelu" or i == 1:
            if not torch.equal(x, y):
                raise AssertionError(f"{kind} kernel B: output {i} differs "
                                     "from its plain version")
            continue
        b_err = (x.float() - y.float()).abs().max().item()
        peak = y.float().abs().max().item()
        if not b_err <= bf16_ulp(torch.tensor(peak)).item():
            raise AssertionError(f"{kind} kernel B: max_abs_err {b_err} at "
                                 f"peak {peak}")
    esize = a.element_size()
    a_bytes = (a.numel() * esize * (1 if qa["pre"] is None else 2) + M * K
               + (M * K * esize if qa["want_g"] else 0) + 4 * M * (K // bk)
               + (4 * K if qa["sf"] is not None else 0))
    a_ms = cuda_ms(stage_a)
    gemm_ms = cuda_ms(stage_b)
    out = dict(a_ms=a_ms, a_bound_ms=a_bytes / PEAK_BYTES * 1e3,
               a_bound_by="bytes", b_ms=gemm_ms,
               b_bound_ms=2 * M * K * N / PEAK_INT8_OPS * 1e3,
               b_bound_by="operations",
               b_tops=2 * M * K * N / (gemm_ms * 1e-3) / 1e12,
               b_ratio_to_library=gemm_ms / library_ms,
               stages_bit_equal="A; B" + (" (gelu output: max_abs_err "
                                          f"{b_err})" if b_err else ""))
    if kind in ("k4", "k8"):
        wt = qmm.transpose_s8(qw)
        torch.cuda.synchronize()
        if not torch.equal(wt, qw.t()):
            raise AssertionError("transpose_s8 differs from qw.t()")
        out["transpose_ms"] = cuda_ms(lambda: qmm.transpose_s8(qw))
        out["transpose_plain_ms"] = cuda_ms(lambda: qw.t().contiguous())
        del wt
    del got_a, want_a, got_b, want_b, q, sx, w
    return out


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


def profile_window(fn) -> dict:
    """``torch.profiler`` over ``fn()``: the window's wall time, the
    card's busy share of it and the kernels that take most of its device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return dict(window_ms=window_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / window_ms if rows else None,
                top=[[name[:60], ms, n] for name, ms, n in rows[:8]])


def profile_request(client, prompt) -> dict:
    """One request (512-token prompt, 64 new tokens) through the HTTP
    tier under :func:`profile_window`."""
    return dict(prompt_tokens=len(prompt), new_tokens=NEW_TOKENS,
                **profile_window(lambda: client.generate(
                    prompt, NEW_TOKENS, tenant="profile")))


def burst(client, prompts, kw_for) -> tuple[list, float]:
    """Every prompt as a concurrent HTTP request (``NEW_TOKENS`` each,
    ``kw_for(i)`` its options); the responses and the wall seconds."""
    results: list = [None] * len(prompts)

    def send(i):
        results[i] = client.generate(prompts[i], NEW_TOKENS, **kw_for(i))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    burst_s = time.perf_counter() - t0
    done = [r for r in results if r is not None]
    if len(done) != len(prompts):
        raise AssertionError(f"{len(done)}/{len(prompts)} requests done")
    for p, r in zip(prompts, done):
        if r["tokens_out"] != NEW_TOKENS or r["tokens"][:len(p)] != p \
                or len(r["tokens"]) != len(p) + NEW_TOKENS:
            raise AssertionError(f"incomplete response: {r['tokens_out']}")
        if not all(0 <= t < WIDTH["vocab_size"] for t in r["tokens"]):
            raise AssertionError("token outside the vocabulary")
    return done, burst_s


def burst_numbers(results, burst_s) -> dict:
    """The end-to-end serving metrics of one burst."""
    ttft = [r["ttft_ms"] for r in results]
    return dict(tokens_per_s=len(results) * NEW_TOKENS / burst_s,
                burst_s=burst_s, ttft_p50_ms=statistics.median(ttft),
                ttft_ms=ttft,
                tpot_p50_ms=statistics.median(r["tpot_ms"]
                                              for r in results))


def mixed_kw(i) -> dict:
    """The serve phase's request mix: two tenants, the odd requests
    sampled with seeds."""
    kw = dict(tenant=("search", "ads")[i % 2])
    if i % 2:
        kw.update(temperature=0.8, top_k=40, seed=100 + i)
    return kw


class Serving:
    """An engine behind ``ServingServer`` on localhost and a client."""

    def __init__(self, dev, model, **engine_kw):
        from distributed_tensorflow_tpu_torch.serving.client import (
            ServeClient)
        from distributed_tensorflow_tpu_torch.serving.engine import (
            DecodeEngine, EngineConfig)
        from distributed_tensorflow_tpu_torch.serving.scheduler import (
            FairScheduler)
        from distributed_tensorflow_tpu_torch.serving.server import (
            ServingServer)
        from distributed_tensorflow_tpu_torch.utils.telemetry import (
            Telemetry)
        self.telemetry = Telemetry()
        self.engine = DecodeEngine(model, None,
                                   EngineConfig(**{**ENGINE, **engine_kw}),
                                   self.telemetry, device=dev)
        self.server = ServingServer(self.engine, FairScheduler(), port=0,
                                    host="127.0.0.1",
                                    telemetry=self.telemetry)
        self.server.start()
        self.client = ServeClient(f"http://127.0.0.1:{self.server.port}",
                                  timeout_s=600.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.shutdown()


def serve(dev) -> tuple[dict, object, dict]:
    """Phase 4: the port's serving path over HTTP.  Returns the launches,
    the model (the later serving phases reuse its weights) and this
    whole-bucket arm's prompts, responses and numbers."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln

    t0 = time.perf_counter()
    model = gpt.GptLM(gpt.GptConfig(**WIDTH), device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    logit_err = check_model(dev, model, gpt)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, WIDTH["vocab_size"], n).tolist()
               for n in PROMPT_LENS]
    with Serving(dev, model) as srv:
        client = srv.client
        client.generate(prompts[0][:16], 4)            # warm-up
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        fa.launches = 0
        ln.launches = 0
        done, burst_s = burst(client, prompts, mixed_kw)
        again = client.generate(prompts[0], NEW_TOKENS, tenant="search")
        launches = {"flash_attention_fwd": fa.launches,
                    "layer_norm_fwd": ln.launches}
        stats = client.stats()
        profiled = profile_request(client, prompts[3])

    if again["tokens"] != done[0]["tokens"]:
        raise AssertionError("repeated greedy request gave other tokens")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    numbers = burst_numbers(done, burst_s)
    emit("profile", **profiled)
    emit("serve", model="gpt_406m_width", params=n_params,
         requests=len(done), new_tokens_each=NEW_TOKENS,
         prompt_lens=list(PROMPT_LENS), **numbers,
         engine_steps=stats["engine"]["engine_step"],
         greedy_repeat_identical=True, launches=launches,
         model_logit_err=logit_err, model_logit_tol=MODEL_LOGIT_TOL,
         setup_s=setup_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, model, dict(prompts=prompts, results=done, **numbers)


def first_token_logits(engine, prompt):
    """Admit ``prompt`` alone (greedy, one new token) and step the engine
    until the lane emits: the fp32 logits row its token was chosen from."""
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    seen = []
    sample = engine._sample

    def spy(logits):
        seen.append(logits.float())
        return sample(logits)

    engine._sample = spy
    try:
        req = Request(prompt, 1)
        slot = engine.admit(req)
        while not req.tokens:
            engine.step()
    finally:
        del engine._sample
    return seen[-1][slot]


def first_divergence(a, b):
    """Index of the first token where two streams differ (None: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def fp32_model(dev):
    """The serving width in fp32 with 2 layers: the setting in which the
    JAX package's tests hold the engine's arms to token parity."""
    from distributed_tensorflow_tpu_torch.models import gpt
    return gpt.GptLM(gpt.GptConfig(**{**WIDTH, "num_layers": 2,
                                      "dtype": "float32"}),
                     device=dev, seed=SEED)


def engine_tokens(dev, model, prompts, **engine_kw):
    """Every prompt's ``NEW_TOKENS`` greedy tokens (and spec rounds) from
    an engine stepped in this thread, all requests admitted at once with
    ``speculative=True`` (honoured where the engine has ``spec_k``)."""
    from distributed_tensorflow_tpu_torch.serving.engine import (
        DecodeEngine, EngineConfig)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    engine = DecodeEngine(model, None,
                          EngineConfig(**{**ENGINE, **engine_kw}),
                          device=dev)
    reqs = [Request(p, NEW_TOKENS, speculative=True) for p in prompts]
    for r in reqs:
        engine.admit(r)
    while engine.active_slots:
        engine.step()
    if not all(len(r.tokens) == NEW_TOKENS for r in reqs):
        raise AssertionError("a request ended early")
    return [r.tokens for r in reqs], [r.spec_rounds for r in reqs]


def fp32_parity(dev, prompts, **engine_kw) -> list:
    """Gate: in fp32 at the full width and 2 layers, the engine arm's
    tokens equal the plain whole-bucket engine's for every prompt.
    Returns the arm's spec rounds per request."""
    f32 = fp32_model(dev)
    arm, rounds = engine_tokens(dev, f32, prompts, **engine_kw)
    plain, _ = engine_tokens(dev, f32, prompts)
    del f32
    divergence = [first_divergence(a, b) for a, b in zip(arm, plain)]
    if any(d is not None for d in divergence):
        raise AssertionError(f"fp32 {engine_kw} tokens differ from the "
                             f"plain engine's at {divergence}")
    return rounds


def serve_chunked(dev, model, whole: dict) -> dict:
    """Phase ``serve_chunked``: the serve phase's model, engine and
    requests with ``prefill_chunk=PREFILL_CHUNK``.  Gate: in fp32 at the
    full width and 2 layers, every prompt's greedy tokens equal the
    whole-bucket engine's.  Then, in bf16, each prompt's first-token
    logits against the whole-bucket engine's; each request's tokens
    against the serve phase's (reported, not gated: a bf16 near-tie may
    flip an argmax); K3's launches exact."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.serving.engine import (
        DecodeEngine, EngineConfig)

    prompts = whole["prompts"]
    fp32_parity(dev, prompts, prefill_chunk=PREFILL_CHUNK)
    # Engines of their own, stepped in this thread.
    engines = [DecodeEngine(model, None, EngineConfig(**{
        **ENGINE, "prefill_chunk": c}), device=dev) for c in
        (PREFILL_CHUNK, 0)]
    logit_errs = [(first_token_logits(engines[0], p)
                   - first_token_logits(engines[1], p)).abs().max().item()
                  for p in prompts]
    del engines
    with Serving(dev, model, prefill_chunk=PREFILL_CHUNK) as srv:
        srv.client.generate(prompts[0][:40], 4)           # warm-up
        torch.cuda.synchronize()
        fa.launches = ln.launches = 0
        chunk_ms = srv.telemetry.histogram("serve_prefill_chunk_ms")
        steps0, chunks0 = srv.engine.step_index, chunk_ms.count
        done, burst_s = burst(srv.client, prompts, mixed_kw)
        launches = {"flash_attention_fwd": fa.launches,
                    "layer_norm_fwd": ln.launches}
        steps = srv.engine.step_index - steps0
        dispatches = chunk_ms.count - chunks0
        prefill_ms = srv.engine.prefill_ms_total
    L = WIDTH["num_layers"]
    want_ln = 2 * L * dispatches + (2 * L + 1) * steps
    if launches != {"flash_attention_fwd": 0, "layer_norm_fwd": want_ln}:
        raise AssertionError(f"launches {launches}: expected K3 "
                             f"{want_ln} ({dispatches} chunk dispatches, "
                             f"{steps} decode steps) and no K1")
    if not max(logit_errs) <= MODEL_LOGIT_TOL:
        raise AssertionError(f"first-token logits {logit_errs} against the "
                             f"whole-bucket engine's (tol "
                             f"{MODEL_LOGIT_TOL})")
    divergence = [first_divergence(r["tokens"], w["tokens"])
                  for r, w in zip(done, whole["results"])]
    numbers = burst_numbers(done, burst_s)
    emit("serve_chunked", prefill_chunk=PREFILL_CHUNK, requests=len(done),
         fp32_2_layers=dict(tokens_equal_whole_bucket=len(prompts)),
         new_tokens_each=NEW_TOKENS, prompt_lens=list(PROMPT_LENS),
         **numbers, whole_bucket={k: whole[k] for k in (
             "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")},
         first_token_logit_err=logit_errs, logit_tol=MODEL_LOGIT_TOL,
         tokens_equal_whole_bucket=sum(d is None for d in divergence),
         first_divergence=divergence, chunk_dispatches=dispatches,
         decode_steps=steps, prefill_ms_total=prefill_ms,
         launches=launches)
    return launches


def phrase_prompts() -> list:
    """A seeded 24-token phrase repeated to each of ``PROMPT_LENS``: the
    n-gram drafter finds the phrase's continuation in every prompt."""
    import numpy as np
    phrase = np.random.default_rng(SEED + 2).integers(
        0, WIDTH["vocab_size"], 24)
    return [np.resize(phrase, n).tolist() for n in PROMPT_LENS]


def serve_spec(dev, model) -> dict:
    """Phase ``serve_spec``: the speculative arm (``spec_k=SPEC_K``,
    ``spec_ngram=3``) on greedy ``speculative=True`` requests for the
    repeated-phrase prompts.  Gate: in fp32 at the full width and 2
    layers, each request's tokens equal those of the same engine with
    ``spec_k=0``.  Then the bf16 model of the serve phase over HTTP, the
    plain engine beside it: the accepted share of the drafts, tokens/s,
    TPOT, and K1/K3 launches exact."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln

    prompts = phrase_prompts()
    spec_cfg = dict(spec_k=SPEC_K, spec_ngram=3)
    f32_rounds = fp32_parity(dev, prompts, **spec_cfg)

    L = WIDTH["num_layers"]
    arms = {}
    for name, kw in (("plain", {}), ("spec", spec_cfg)):
        with Serving(dev, model, **kw) as srv:
            srv.client.generate(prompts[0][:40], 4, speculative=True)
            torch.cuda.synchronize()
            fa.launches = ln.launches = 0
            steps0 = srv.engine.step_index
            done, burst_s = burst(srv.client, prompts, lambda i: dict(
                speculative=True))
            launches = {"flash_attention_fwd": fa.launches,
                        "layer_norm_fwd": ln.launches}
            steps = srv.engine.step_index - steps0
        # Whole-bucket prefills (K1 once a layer, K3 2 a layer + 1), then
        # one decode or verify dispatch a step (K3 2 a layer + 1).
        n = len(prompts)
        want = {"flash_attention_fwd": L * n,
                "layer_norm_fwd": (2 * L + 1) * (n + steps)}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want} ({steps} steps)")
        arm = dict(burst_numbers(done, burst_s), steps=steps,
                   launches=launches)
        if name == "spec":
            rounds = sum(r.get("spec_rounds", 0) for r in done)
            drafted = (SPEC_K - 1) * rounds
            accepted = sum(r["tokens_out"] for r in done) - rounds
            arm.update(spec_rounds=rounds, drafted=drafted,
                       accepted_drafts=accepted,
                       accepted_share=accepted / drafted if drafted else 0.0)
        arms[name] = arm
    emit("serve_spec", spec_k=SPEC_K, spec_ngram=3, requests=len(prompts),
         new_tokens_each=NEW_TOKENS, prompt_lens=list(PROMPT_LENS),
         fp32_2_layers=dict(tokens_equal_plain=len(prompts),
                            spec_rounds=f32_rounds), **arms)
    return arms["spec"]["launches"]


def generate_prompts(V: int):
    """The generate phase's prompts: ``GEN["batch"]`` random rows, and as
    many rows repeating a seeded 24-token phrase (each from another
    offset), all ``GEN["prompt"]`` tokens long."""
    import numpy as np
    B, P = GEN["batch"], GEN["prompt"]
    rand = np.random.default_rng(SEED + 3).integers(0, V, (B, P))
    phrase = np.random.default_rng(SEED + 2).integers(0, V, 24)
    return rand, np.stack([np.resize(np.roll(phrase, -5 * b), P)
                           for b in range(B)])


class DecodeArm:
    """One arm of the generate phase: the launch counters set to 0 just
    before ``fn()`` runs and read just after, and ``check(result,
    launches)`` (by default: equal to ``want(result)``, the exact counts)
    must hold; ``ms`` is the call's wall time, ending in a synchronise."""

    def __init__(self, name, fn, want=None, check=None):
        import torch
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.result = fn()
        torch.cuda.synchronize()
        self.ms = (time.perf_counter() - t0) * 1e3
        self.launches = {k: v for k, v in launch_counts().items() if v}
        if check is None:
            def check(result, launches):
                return launches == {k: v for k, v in want(result).items()
                                    if v}
        if not check(self.result, self.launches):
            raise AssertionError(f"generate {name}: launches "
                                 f"{self.launches}")


def generate_phase(dev, model) -> dict:
    """Phase ``generate``: the library decode family (``generate``,
    ``generate_cached``, ``beam_search_cached`` and both speculative
    loops) at the serve phase's widths.  Gates, in fp32 at the full width
    and 2 layers: every greedy arm gives ``generate_cached``'s tokens;
    with ``attention_window`` 256, the ring cache gives the uncached
    loop's (K1's window band).  Then the bf16 model of the serve phase at
    full depth: tokens/s, ms a step, prefill ms and peak memory of
    ``generate_cached``, a width-4 beam's ms a token, both speculative
    loops against ``generate_cached`` on repeated-phrase prompts, and the
    int8-weight / float8-cache arm's first divergence from bf16 (not
    gated).  Every arm's launches exact (K1 once a layer a prefill and an
    uncached step, K3 2L + 1 a prefill, step or chunk), but for the fp32
    host loop's fallback finish, whose steps its stats do not count.
    Returns the bf16 ``generate_cached`` arm's launches."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt

    t_phase = time.perf_counter()
    V = WIDTH["vocab_size"]
    rand, phrase = generate_prompts(V)
    B, P, N, K = GEN["batch"], GEN["prompt"], GEN["new"], GEN["spec_k"]

    def counts(L, passes, uncached=0):
        """K1 once a layer a prefill or uncached step, K3 2L + 1 each
        pass (the first of ``passes`` a prefill)."""
        return {"flash_attention_fwd": L * (1 if passes else 0)
                + L * uncached,
                "layer_norm_fwd": (2 * L + 1) * (passes + uncached)}

    def equal(name, got, want):
        if not torch.equal(got, want):
            where = [first_divergence(a, b)
                     for a, b in zip(got.tolist(), want.tolist())]
            raise AssertionError(f"generate {name}: tokens differ from "
                                 f"generate_cached's at {where}")

    # Gate 1: fp32, full width, 2 layers.
    f32 = fp32_model(dev)
    L = f32.cfg.num_layers
    cached = DecodeArm("fp32 cached", lambda: gpt.generate_cached(
        f32, None, rand, N), lambda r: counts(L, N)).result
    n = GEN["uncached"]
    uncached = DecodeArm("fp32 uncached", lambda: gpt.generate(
        f32, None, rand, n), lambda r: counts(L, 0, n)).result
    equal("fp32 uncached", uncached, cached[:, :P + n])
    beam1 = DecodeArm("fp32 beam 1", lambda: gpt.beam_search_cached(
        f32, None, rand, N, beam_size=1), lambda r: counts(L, N))
    equal("fp32 beam 1", beam1.result[0], cached)
    plain_phrase = gpt.generate_cached(f32, None, phrase, N)
    f_host = DecodeArm(
        "fp32 spec host", lambda: gpt.generate_cached_speculative(
            f32, None, phrase, N, spec_k=K),
        check=lambda r, got: (
            set(got) == {"flash_attention_fwd", "layer_norm_fwd"}
            and got["flash_attention_fwd"] == L
            and got["layer_norm_fwd"] % (2 * L + 1) == 0
            and got["layer_norm_fwd"] >= (2 * L + 1) * (1 + r[1]["rounds"])))
    equal("fp32 spec host", f_host.result[0], plain_phrase)
    f_dev = DecodeArm(
        "fp32 spec device", lambda: gpt.generate_cached_speculative_device(
            f32, None, phrase, N, spec_k=K),
        lambda r: counts(L, 1 + r[1]["rounds"]))
    equal("fp32 spec device", f_dev.result[0], plain_phrase)
    del f32

    # Gate 2: the window (ring cache against K1's window band).
    wmodel = gpt.GptLM(gpt.GptConfig(**{
        **WIDTH, "num_layers": 2, "dtype": "float32",
        "attention_window": GEN["window"]}), device=dev, seed=SEED)
    wp, wn = rand[:2, :GEN["window_prompt"]], GEN["window_new"]
    ring = DecodeArm("window cached", lambda: gpt.generate_cached(
        wmodel, None, wp, wn), lambda r: counts(2, wn)).result
    band = DecodeArm("window uncached", lambda: gpt.generate(
        wmodel, None, wp, wn), lambda r: counts(2, 0, wn)).result
    equal("window uncached", band, ring)
    del wmodel
    torch.cuda.empty_cache()

    # bf16 at full depth: the serve phase's model.
    L, N = model.cfg.num_layers, GEN["bf16_new"]
    gpt.generate_cached(model, None, rand[:, :32], 4)             # warm-up
    prompt = torch.as_tensor(rand, device=dev)
    caches = gpt.init_kv_cache(model.cfg, B, P + N, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(prompt, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del caches
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    main = DecodeArm("bf16 cached", lambda: gpt.generate_cached(
        model, None, rand, N), lambda r: counts(L, N))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = main.result
    if not (toks.shape == (B, P + N) and torch.equal(toks[:, :P], prompt)
            and int(toks.min()) >= 0 and int(toks.max()) < V):
        raise AssertionError("bf16 generate_cached: malformed tokens")
    nb = GEN["beam_new"]
    beam = DecodeArm("bf16 beam", lambda: gpt.beam_search_cached(
        model, None, rand[:1], nb, beam_size=GEN["beam"]),
        lambda r: counts(L, nb))
    if not torch.isfinite(beam.result[1]).all():
        raise AssertionError("bf16 beam: non-finite logprob")
    plain = DecodeArm("bf16 cached, phrase", lambda: gpt.generate_cached(
        model, None, phrase, N), lambda r: counts(L, N))
    # The host loop with the fallback off: every pass is the prefill or a
    # round's chunk, so its launches are exact.
    host = DecodeArm("bf16 spec host", lambda: gpt.generate_cached_speculative(
        model, None, phrase, N, spec_k=K, fallback_rounds=0),
        lambda r: counts(L, 1 + r[1]["rounds"]))
    dev_spec = DecodeArm(
        "bf16 spec device", lambda: gpt.generate_cached_speculative_device(
            model, None, phrase, N, spec_k=K),
        lambda r: counts(L, 1 + r[1]["rounds"]))
    spec = {name: dict(
        arm.result[1], ms=arm.ms, tokens_per_s=B * N / (arm.ms / 1e3),
        speedup_over_cached=plain.ms / arm.ms,
        rows_equal_cached=sum(a == b for a, b in zip(
            arm.result[0].tolist(), plain.result.tolist())),
        launches=arm.launches)
        for name, arm in (("host_no_fallback", host), ("device", dev_spec))}
    q8 = DecodeArm("bf16 int8 + float8", lambda: gpt.generate_cached(
        model, None, rand, N, quantize="int8", kv_dtype="float8"),
        lambda r: counts(L, N))
    emit("generate_profile", batch=B, prompt_tokens=P, new_tokens=16,
         **profile_window(lambda: gpt.generate_cached(model, None, rand,
                                                      16)))
    emit("generate", model="gpt_406m_width", batch=B, prompt_tokens=P,
         seconds=time.perf_counter() - t_phase,
         fp32_2_layers=dict(
             new_tokens=GEN["new"], uncached_new_tokens=GEN["uncached"],
             equal_to_generate_cached=[
                 "generate", "beam_search_cached(beam_size=1)",
                 "generate_cached_speculative",
                 "generate_cached_speculative_device"],
             spec_host=f_host.result[1], spec_device=f_dev.result[1]),
         window_gate=dict(attention_window=GEN["window"], batch=2,
                          prompt_tokens=GEN["window_prompt"],
                          new_tokens=wn, ring_cache_equal_to_band=True),
         new_tokens=N, generate_cached=dict(
             tokens_per_s=B * N / (main.ms / 1e3), wall_ms=main.ms,
             prefill_ms=prefill_ms,
             ms_per_step=(main.ms - prefill_ms) / (N - 1),
             peak_mem_gb=peak_gb, resident_before_gb=resident_gb,
             launches=main.launches),
         beam=dict(beam_size=GEN["beam"], batch=1, new_tokens=nb,
                   ms=beam.ms, ms_per_token=beam.ms / nb,
                   logprob=beam.result[1].tolist(), launches=beam.launches),
         phrase_generate_cached=dict(ms=plain.ms, tokens_per_s=B * N / (
             plain.ms / 1e3), launches=plain.launches),
         spec=spec, spec_k=K,
         int8_float8=dict(ms=q8.ms, tokens_per_s=B * N / (q8.ms / 1e3),
                          first_divergence_from_bf16=[
                              first_divergence(a[P:], b[P:]) for a, b in zip(
                                  q8.result.tolist(), toks.tolist())],
                          launches=q8.launches))
    return main.launches


class CliProcess:
    """A port CLI as a process of its own beside this one: its output
    drained by a thread, stopped (SIGTERM, then SIGKILL) on exit."""

    def __init__(self, module: str, *args):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        self.lines: queue.Queue = queue.Queue()
        self.seen: list = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"distributed_tensorflow_tpu_torch.{module}",
             *map(str, args)], cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, prefix: str, timeout_s: float) -> str:
        """The first output line starting with ``prefix``."""
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                line = self.lines.get(
                    timeout=max(deadline - time.perf_counter(), 0.01))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"no {prefix!r} line from the CLI: "
                                     + "".join(self.seen[-30:]))
            self.seen.append(line)
            if line.startswith(prefix):
                return line

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def generate_cli(dev, logdir, prompt, *flags) -> tuple[list, float, list]:
    """``train.py --mode=generate`` as a process: its generated tokens,
    wall seconds and output lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.train",
         "--mode=generate", "--model=gpt_mini", f"--logdir={logdir}",
         f"--device={dev}", f"--gen_tokens={NEW_TOKENS}",
         "--gen_prompt=" + ",".join(map(str, prompt)), *flags],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), text=True,
        capture_output=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    if out.returncode or "Restored global step: 2" not in lines:
        raise AssertionError(f"train --mode=generate {flags}: rc "
                             f"{out.returncode}\n{out.stdout[-3000:]}"
                             f"{out.stderr[-3000:]}")
    (gen,) = [x for x in lines if x.startswith("Generated tokens:")]
    return [int(t) for t in gen.split(":", 1)[1].split()], seconds, lines


def checkpoint_phase(dev, smi: str, model, whole: dict) -> dict:
    """Phase ``checkpoint``: from a checkpoint on disk to tokens.  The
    serve phase's model is saved as the JAX trainer saves (``save_raw`` of
    ``{params, global_step}``, fp32 arrays, step 1), served by the serving
    CLI as a process (``--hot_swap``), which gets the serve phase's 8
    requests (gate: the greedy ones' tokens equal the serve phase's
    in-process engine's); step 2 (seed-1 weights) is saved while a long
    request streams (gates: the stream runs to its budget, the swap to
    step 2 shows in ``/statz``, a request after it gets the tokens of an
    engine on the step-2 weights in memory).  In this process, the
    restore recipe (``load_gpt_serving_model``) and an engine on the
    restored tree: the in-memory engine's tokens, K1 8 a prefill, K3 17 a
    prefill or step.  Then ``train.py --mode=generate``, greedy, beam 4
    and speculative 8, each as a process: the in-process decode family's
    tokens on the step-2 weights.  Returns the in-process run's
    launches."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    from distributed_tensorflow_tpu_torch.serving.engine import (
        DecodeEngine, EngineConfig)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    from distributed_tensorflow_tpu_torch.tools import checkpoint_io
    from distributed_tensorflow_tpu_torch.tools.export_model import (
        clear_restore_memo)
    from distributed_tensorflow_tpu_torch.tools.serve import (
        load_gpt_serving_model)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    run_dir = os.path.join(tmp, "gpt_mini")
    ckpt_dir = os.path.join(run_dir, "checkpoints")

    def save(m, step) -> dict:
        """``save_raw`` of ``m``'s weights as step ``step``: the data
        written and renamed into place (``visible_unix``), then the
        manifest's CRC pass (``manifest_unix``)."""
        t0 = time.perf_counter()
        tree = {"params": gpt.params_to_jax(m.state_dict()),
                "global_step": np.asarray(step, np.int32)}
        to_host_s = time.perf_counter() - t0
        gb = 4 * sum(t.numel() for t in m.state_dict().values()) / 1e9
        started = time.time()
        step_dir = checkpoint_io.save_raw(ckpt_dir, step, tree)
        # The rename is the last change to the checkpoints directory.
        visible = os.path.getmtime(ckpt_dir)
        manifest = os.path.getmtime(os.path.join(
            step_dir, checkpoint_io.MANIFEST_NAME))
        return dict(gb=gb, to_host_s=to_host_s, write_s=visible - started,
                    write_gb_per_s=gb / (visible - started),
                    manifest_s=manifest - visible, step_dir=step_dir,
                    visible_unix=visible, manifest_unix=manifest)

    def verify(saved) -> None:
        t0 = time.perf_counter()
        verdict = checkpoint_io.verify_checkpoint(saved.pop("step_dir"))
        if verdict[0] != "valid":
            raise AssertionError(f"{verdict}")
        saved.update(verify=verdict[1],
                     verify_s=time.perf_counter() - t0)

    def engine_run(m, params, prompt) -> tuple[list, dict, int]:
        """One greedy request alone through an engine stepped here: its
        tokens, the launches and the engine steps."""
        engine = DecodeEngine(m, params, EngineConfig(**ENGINE), device=dev)
        req = Request(prompt, NEW_TOKENS)
        reset_launch_counts()
        engine.admit(req)
        while engine.active_slots:
            engine.step()
        torch.cuda.synchronize()
        return (req.tokens, {k: v for k, v in launch_counts().items() if v},
                engine.step_index)

    try:
        saved1 = save(model, 1)
        verify(saved1)
        prompts, served = whole["prompts"], whole["results"]
        metrics = os.path.join(tmp, "serve.jsonl")
        with CliProcess(
                "tools.serve", "--logdir", run_dir, "--port", 0,
                "--device", dev, "--hot_swap", "--swap_poll_s", 0.2,
                "--slots", ENGINE["num_slots"],
                "--page_size", ENGINE["page_size"],
                "--num_pages", ENGINE["num_pages"],
                "--max_pages_per_seq", ENGINE["max_pages_per_seq"],
                "--tenants", "search:1,ads:1",
                "--metrics_file", metrics) as cli:
            t0 = time.perf_counter()
            banner = cli.wait_for("serving gpt_mini ", 600)
            startup_s = time.perf_counter() - t0
            port = int(banner.split(" on :")[1].split(" ")[0])
            client = ServeClient(f"http://127.0.0.1:{port}",
                                 timeout_s=600.0)
            client.generate(prompts[0][:16], 4)             # warm-up
            done, burst_s = burst(client, prompts, mixed_kw)
            same = [a["tokens"] == b["tokens"]
                    for a, b in zip(done, served)]
            greedy = [i for i in range(len(prompts)) if "seed" not in
                      mixed_kw(i)]
            if not all(same[i] for i in greedy):
                raise AssertionError(
                    "CLI greedy tokens differ from the in-process "
                    "engine's: " + str([first_divergence(
                        done[i]["tokens"], served[i]["tokens"])
                        for i in greedy]))

            # The hot swap: step 2 saved while a long request streams.
            long_new = 900
            streamed: dict = {}
            stream = threading.Thread(target=lambda: streamed.update(
                r=client.generate(prompts[0], long_new, tenant="search")))
            stream.start()
            while client.stats()["engine"]["active_slots"] < 1:
                time.sleep(0.01)
            model2 = gpt.GptLM(gpt.GptConfig(**WIDTH), device=dev,
                               seed=SEED + 1)
            saved2 = save(model2, 2)
            deadline = time.perf_counter() + 300
            while client.stats()["engine"]["model_step"] != 2:
                if time.perf_counter() > deadline:
                    raise AssertionError("the hot swap never landed")
                time.sleep(0.01)
            seen_s = time.time() - saved2["visible_unix"]
            verify(saved2)
            stream.join(timeout=600)
            if stream.is_alive() or streamed["r"]["tokens_out"] != long_new:
                raise AssertionError("the stream across the swap did not "
                                     "run to its budget")
            after = client.generate(prompts[2], NEW_TOKENS, tenant="search")
            stats = client.stats()["engine"]
        if cli.proc.returncode != 0:
            raise AssertionError(f"serve CLI exited {cli.proc.returncode}")
        want2, _ = engine_tokens(dev, model2, [prompts[2]])
        if not (after["model_step"] == 2 and stats["swaps"] == 1
                and after["tokens"][len(prompts[2]):] == want2[0]):
            raise AssertionError("after the swap: not the step-2 tokens")
        with open(metrics) as fh:
            records = [json.loads(x) for x in fh]
        (swap,) = [r for r in records if r.get("kind") == "model_swap"]
        spans = {r["name"]: r for r in records if r.get("kind") == "span"
                 and r.get("name") in ("serve.swap", "serve.swap_load")}
        adopted = spans["serve.swap"]["t_unix"] + spans[
            "serve.swap"]["dur_ms"] / 1e3

        # In process: the restore recipe, and launches on the restored
        # model (the 777-token prompt: K1 and K3 at the serve cases'
        # 784-row prefill bucket).
        clear_restore_memo()
        t0 = time.perf_counter()
        cfg, tree, step = load_gpt_serving_model(run_dir, 1)
        restore_s = time.perf_counter() - t0
        restored = gpt.GptLM(cfg, device=dev)
        params = gpt.params_from_jax(tree)
        del tree
        clear_restore_memo()
        want, want_launches, want_steps = engine_run(model, None, prompts[1])
        got, launches, steps = engine_run(restored, params, prompts[1])
        L = cfg.num_layers
        exact = {"flash_attention_fwd": L,
                 "layer_norm_fwd": (2 * L + 1) * (1 + steps)}
        if not (step == 1 and got == want and launches == exact
                and want_launches == exact and steps == want_steps):
            raise AssertionError(f"restored engine: tokens equal "
                                 f"{got == want}, launches {launches} (want "
                                 f"{exact}), in memory {want_launches}")
        del restored, params

        # train.py --mode=generate, against the decode family in process
        # on the step-2 weights.
        rand, phrase = generate_prompts(WIDTH["vocab_size"])
        arms = {}
        for name, prompt, flags, ref in (
                ("greedy", rand[0], (), lambda p: gpt.generate_cached(
                    model2, None, p, NEW_TOKENS)),
                ("beam_4", rand[0], ("--gen_beams=4",),
                 lambda p: gpt.beam_search_cached(
                     model2, None, p, NEW_TOKENS, beam_size=4)[0]),
                ("speculative_8", phrase[0], ("--gen_speculative=8",),
                 lambda p: gpt.generate_cached_speculative_device(
                     model2, None, p, NEW_TOKENS, spec_k=8)[0])):
            toks, seconds, lines = generate_cli(dev, tmp, prompt.tolist(),
                                                *flags)
            want = ref(prompt[None]).cpu()[0, prompt.size:].tolist()
            if toks != want:
                raise AssertionError(f"train --mode=generate {name}: first "
                                     f"divergence {first_divergence(toks, want)}")
            arms[name] = dict(wall_s=seconds, tokens_equal_in_process=True,
                              line=[x for x in lines if x.startswith(
                                  ("Beam search", "Speculative decode"))])
        del model2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("checkpoint", card=smi, model="gpt_406m_width",
         seconds=time.perf_counter() - t_phase,
         save_step1=saved1, save_step2=saved2,
         restore_in_process=dict(step=1, seconds=restore_s,
                                 gb_per_s=saved1["gb"] / restore_s),
         serve_cli=dict(startup_s=startup_s, requests=len(done),
                        **burst_numbers(done, burst_s),
                        greedy_equal_in_process=len(greedy),
                        sampled_equal_in_process=sum(
                            same[i] for i in range(len(done))
                            if i not in greedy)),
         hot_swap=dict(stream_new_tokens=long_new,
                       in_flight_at_swap=swap["in_flight"],
                       visible_to_adopted_s=adopted - saved2["visible_unix"],
                       adopted_before_manifest=adopted < saved2[
                           "manifest_unix"],
                       visible_to_statz_s=seen_s,
                       load_ms=spans["serve.swap_load"]["dur_ms"],
                       adopt_ms=spans["serve.swap"]["dur_ms"],
                       after_swap_tokens_equal_step2=True),
         restored_engine=dict(prompt_tokens=len(prompts[1]),
                              new_tokens=NEW_TOKENS, steps=steps,
                              tokens_equal_in_memory=True,
                              launches=launches),
         train_generate=arms)
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


def profile_train_step(step, state, batch, named=None) -> dict:
    """``torch.profiler`` over one train step: the card's busy share of
    the step (the sum of its kernels' times over the step's wall time),
    the kernels that take most of it, and the operators they ran under
    (an operator's device time is that of the kernels it launched, and a
    user annotation such as the optimizer step spans kernels on the
    device's timeline too: only the kernels are summed).  ``named``:
    {label: substring}, each label's device ms and calls over the kernels
    and operators whose name holds the substring."""
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
    out = dict(window_ms=window_ms, device_busy_ms=busy_ms,
               busy_share=busy_ms / window_ms if kernels else None,
               top_kernels=[[k[:60], ms, n] for k, ms, n in kernels[:10]],
               top_ops=[[k[:60], ms, n] for k, ms, n in ops[:10]])
    if named:
        out["named"] = {
            label: dict(kernel_ms=sum(ms for k, ms, _ in kernels if sub in k),
                        kernel_calls=sum(n for k, _, n in kernels if sub in k),
                        op_ms=sum(ms for k, ms, _ in ops if sub in k),
                        op_calls=sum(n for k, _, n in ops if sub in k))
            for label, sub in named.items()}
    return out


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
            "quant_matmul_dgelu": qmm.dgelu_launches,
            # K4/K5's two kernels: each call of either launches both.
            "quantize_blocks": qmm.quantize_launches,
            "quant_gemm": qmm.gemm_launches,
            "transpose_s8": qmm.transpose_launches}


def reset_launch_counts() -> None:
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    fa.launches = fa.dq_launches = fa.dkv_launches = ln.launches = 0
    fa.chunk_launches = fa.chunk_dq_launches = fa.chunk_dkv_launches = 0
    qmm.launches = qmm.nt_launches = qmm.dgelu_launches = 0
    qmm.quantize_launches = qmm.gemm_launches = qmm.transpose_launches = 0


def train_run(dev, cfg, steps: int, check=None, profile=True,
              mesh=None, named=None) -> dict:
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
    profiled = profile_train_step(step, state, batches[steps], named) \
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
    # K4/K5's kernels and the weight transpose by name in the profile.
    named = {"kernel A (quantize_blocks)": "quantize_blocks",
             "kernel B (qgemm_wgmma)": "qgemm_wgmma",
             "K4 weight transpose (transpose_s8)": "transpose_s8"}
    run = train_run(dev, cfg, TRAIN["steps"], check=lambda m, f, b: (
        check_train_step(dev, m, f, b, (TRAIN_INT8_LOSS_TOL,
                                        TRAIN_INT8_GRAD_NORM_RTOL,
                                        TRAIN_INT8_GRAD_MIN_COS))),
        named=named)
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 1,
                "quant_matmul": 2 * L, "quant_matmul_nt": 2 * L,
                "quantize_blocks": 4 * L, "quant_gemm": 4 * L,
                "transpose_s8": 2 * L}
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
        # The ring asks K6 for its in-place form; the plain version returns
        # new carries, which the ring takes all the same.
        ring.flash_attention_chunk = (
            lambda *a, in_place=False, **kw:
            fa.flash_attention_chunk_reference(*a, **kw))
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
    lib = kernels.load()
    emit("build", seconds=time.perf_counter() - t0,
         sources=[os.path.basename(s) for s in kernels.sources()],
         flash_bf16_kernels=flash_build_report(kernels, lib),
         quant_kernels=quant_build_report(kernels, lib))

    rows = check_kernels(dev)
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    # K8 is on no path: its launches are the kernels phase's own.
    by_path = {"kernels": {"quant_matmul_dgelu": qmm.dgelu_launches}}
    by_path["serve"], model, whole = serve(dev)
    by_path["serve_decode"] = by_path["serve"]
    by_path["serve_chunked"] = serve_chunked(dev, model, whole)
    by_path["serve_spec"] = serve_spec(dev, model)
    by_path["generate"] = generate_phase(dev, model)
    by_path["checkpoint"] = checkpoint_phase(dev, smi, model, whole)
    del model, whole
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
