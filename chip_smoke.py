#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py            # one card
    python3 chip_smoke.py --nccl     # 2+ cards: the reference job over NCCL

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
9. ``fleet``: the serving fleet tier on the same model, saved as the
   ``checkpoint`` phase saves it.  ``tools/serve_fleet.py`` spawns two
   replicas (``tools/serve.py`` processes on the card, ``ENGINE``'s pool,
   tenants ``search:2,ads:1``) behind its router, with ``--respawn`` and
   an autoscaler armed up to three.  ``fleet_serve``: the serve phase's 8
   prompts greedy through the router (gate: each request's tokens are the
   in-process engine's; ``watch_serve --fleet --once --json`` shows 2
   healthy members).  ``fleet_kill``: 16 concurrent requests, ``r1``
   SIGKILLed once half have completed (gates: no failed request, every
   response the in-process tokens, ``r1`` dead, a respawned member
   healthy, the survivor serving both tenants).  ``fleet_autoscale``:
   requests of a tenant whose objective every request breaks until a
   third member is healthy (gate: one ``scale_up``), then the 8 prompts
   again, a tenant each, spread over the three live members (gate: the
   in-process engine's tokens).  The router's stream passes
   ``summarize_run --check`` with ``replica_dead`` and ``failed == 0``.
   ``cells_drill``: two one-replica ``tools/serve_cell.py`` cells
   (each a coordination shard, its standby, a fleet and a replica) behind
   a global router; ``tools/loadgen.py``'s ``cell_kill`` schedule (14 s,
   2 qps, seed 7, 128-token prompts, 16 new) SIGKILLs cell a at 4 s
   (gates: no failed request, no objective ever burning, ``cell_dead``
   and ``tenant_rehome`` on the global stream, ``summarize_run --check``
   green).  Every process is stopped with SIGTERM; each replica that
   served a request printed its launches on exit (gate: K1 a positive
   multiple of 8, K3 of 17, no other kernel).  It prints each replica's
   spawn-to-healthy seconds, the router's added ms a request (p50, p95),
   the fleet's tokens/s over the 8-request and the 16-request bursts
   beside the serve phase's, the kill's and the autoscaler's seconds,
   and the drill's failover gap, re-homes and 429s.
10. ``train``: the flagship GPT train step (``bench.py``'s: the same
   widths, fp32 master weights, bf16 compute, ``attention_backend=
   "pallas"``, plus ``fused_ln=True``; Adam 3e-4, B=8, S=1024, the
   synthetic LM stream) through ``TrainState`` and
   ``build_sync_train_step``.  First one step's loss and gradients through
   the kernels against the plain path with the same weights and batch;
   then 30 steps with the launch counters set to 0 just before and read
   just after (the loss must stay finite and fall); then the
   ``train_profile`` line, ``torch.profiler`` over one more step.
11. ``train_int8``: the same step with ``matmul_int8=True`` (bench.py's
   int8 arm, :2271): each block's gelu MLP through K4 and K5.  The same
   kernel-vs-plain check (the plain path also takes the plain versions of
   K4/K5), 30 steps with exact launch counts (K4 and K5 twice per layer,
   each call one quantize pass and one GEMM, K4's one weight transpose),
   the loss held to the bf16 phase's, the ``train_int8_profile`` line,
   then a short arm with ``attn_int8=True`` as well (bench.py :2287).
12. ``train_ring``: the same step with ``attention_backend="ring"``
    (``train.py --sequence_parallel=4 --attention_backend=ring``) on a
    mesh of four sequence shards of 256 on the card: each block's
    attention is a 4-hop ring through K6 forward and K7a/K7b backward.
    One step's loss and gradients against the same ring through the
    plain chunk versions and against the pallas step (K1/K2), then 30
    steps with exact launch counts (K6, K7a, K7b each 4 shards x 4 hops x
    8 layers = 128 per step, K3 17, K1/K2 none), a falling loss, and the
    ``train_ring_profile`` line.
13. ``trainer``: the port's trainer CLI (``train.py``) as processes.
    ``trainer_reference``: the reference job with
    ``examples/launch_local_cluster.sh``'s flags (one PS and two sync
    workers, MNIST MLP 784-100-10, global batch 100, 200 steps, lr 0.01,
    synthetic MNIST), both workers on the one card with a gloo all-reduce
    a step.  Gates: both workers exit 0 with the reference's lines (the
    chief's ``Initailizing session``, worker 1's ``Waiting for
    session``), the PS alive until stopped, the two workers' parameter
    digests equal (bit-equal parameters), the test accuracy within
    ``TRAINER["accuracy_tol"]`` of the JAX CLI's with the same flags.  It
    prints step ms, steps/s, the all-reduce's share of a step and each
    worker's busy share (``--profile_dir``).  ``trainer_gpt``: gpt_mini
    at ``mini()``'s width through ``--attention_backend=pallas
    --fused_layer_norm`` (B=32, S=512, 59 steps, a checkpoint every 20),
    one worker and no PS; gates: its K1, K2a, K2b and K3 launches exactly
    as its steps and eval forwards predict, a falling loss, ``--mode=eval``
    on its logdir reproducing its test accuracy, ``--mode=generate``'s
    greedy tokens equal to an in-process decode of the restored tree.
    It prints step ms, tokens/s and peak memory, and
    ``trainer_gpt_profile`` the busy share of the same bundle's step in
    this process.  The K1/K2a/K2b/K3 rows' ``trainer`` paths hold the
    kernels at this run's shapes (the ``kernels`` phase's ``trainer``
    cases) with its launches.
14. ``async_trainer``: the trainer in async mode (``--sync_replicas=
    false``, one replica a worker, the workers averaging through the
    coordination service), processes on the one card.
    ``async_reference``: the reference job with ``--async_sync_period=4``,
    steps paced and worker 1 started once worker 0 has published (as
    ``tests/test_multiprocess.py:240`` does); gates: both exit 0 with a
    test accuracy within ``TRAINER["accuracy_tol"]`` of the JAX CLI's with
    the same flags on a CPU, ``averaged parameters with 1 peer(s)`` and
    ``(kv publish`` printed, worker 1 adopting the published parameters.
    ``async_overlap``: the same job with ``--async_compress=int8
    --async_overlap_exchange=true``; gates: the compressed exchange on,
    overlapped averages applied in the background, no foreground average,
    the accuracy gate; it prints the wire bytes of a round beside the
    full state's.  Both print step ms (paced), the exchange's ms a period
    and its share of the training time, and publish MB/s.
    ``async_gpt``: gpt_mini at ``mini()``'s width through the kernels, two
    workers and no PS, a merge every 10 local steps; gates: each worker's
    K1, K2a, K2b and K3 launches exactly as its local steps and eval
    forwards predict, a falling loss, an average with the peer.  It prints
    the exchange ms a period and peak memory, and the async step's ms,
    tokens/s and busy share in this process.  ``async_exchange``: two
    ``ParamAverager``s on one in-process coordination service exchange a
    GPT-406M-width bf16 tree through the logdir side-channel (gate: the
    consensus adopted onto the card is bit-equal to the fp32 mean cast to
    bf16 on the card), then two int8 ``CompressedShardedAverager``s over
    a quarter of the tree cut by depth (the embeddings and the first two
    of the eight blocks, widths unchanged; the codec is host numpy and
    zlib) (gates: a round's wire bytes at least 4x below that part's full
    state, the consensus within the codec's error bound of the exact
    mean); it prints each leg's ms and GB/s.  The K1/K2a/K2b/K3 rows carry ``async_trainer_launches``
    (both workers of ``async_gpt``).

With ``--nccl`` the script runs ``env`` and the reference job alone,
with one worker on each visible card (the backend rule of
``cluster/server.py`` then picks NCCL), under the same gates.

Then the card's name and power limit, the kernels' summary object, and
last ``{"ok": true, "device": {...}}``.  A summary row's numbers and
launches are those of its main path (``main``: the train step for
K1/K2/K3, the int8 train step for K4/K5, the ring train step for K6/K7,
whose numbers are the mean per launch over a step's hops, and the
``kernels`` phase itself for K8, which no path launches); its ``paths``
hold each path's own shape, numbers and launches (K1's and K3's
``generate``: the prefill of B=4 x 384 and the decode step's 4 rows,
with the bf16 ``generate_cached`` arm's launches; their ``checkpoint``:
the serve prefill's case, with the restored engine's launches; their
``fleet``: the serve prefill's case, with the replicas' summed launches;
K1-K3's
``trainer``: the gpt_mini trainer CLI's shapes and launches), K4/K5/K8 rows list
their call sites or variants under ``sites``, and K6's ``hop_kinds``
hold its visible and diagonal hops' own times and ratios to SDPA, K7a's
and K7b's every hop kind's, with the pair's ratio to SDPA's backward.
Any failing phase raises: the script exits non-zero and prints no
result.  Without CUDA it exits 2.
"""

from __future__ import annotations

import contextlib
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
# The trainer phase.  The reference job: examples/launch_local_cluster.sh's
# flags (200 steps, global batch 100, hidden 100, lr 0.01, synthetic MNIST).
# The JAX CLI with the same flags on a CPU (one worker, the same global
# batch) reaches a test accuracy of 1; the port's two workers draw other
# shuffles of the same data, so the tolerance allows two hundredths (100
# of the 10000 test examples).  gpt_mini: mini()'s width (hidden 128, 4
# layers, 4 heads, head_dim 32) at S=512, B=32; generate 32 tokens.
TRAINER = dict(steps=200, batch=100, hidden=100, lr=0.01,
               jax_cpu_test_accuracy=1.0, accuracy_tol=0.02,
               gpt_batch=32, gpt_seq=512, gpt_steps=60, gpt_save=20,
               gen_tokens=32)


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
    # The trainer CLI's gpt_mini: B*S rows of its 128-wide stream.
    mini = dict(hidden=128, heads=4, head_dim=32)
    for name, rows, h in (
            ("prefill", S, Hd), ("decode", ENGINE["num_slots"], Hd),
            ("train", TRAIN["batch"] * TRAIN["seq_len"], Hd),
            ("chunk_prefill", ENGINE["num_slots"] * PREFILL_CHUNK, Hd),
            ("verify", ENGINE["num_slots"] * SPEC_K, Hd),
            ("generate_decode", GEN["batch"], Hd),
            ("trainer", TRAINER["gpt_batch"] * TRAINER["gpt_seq"],
             mini["hidden"])):
        x = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
        bias = 0.1 * torch.randn(h, generator=g, device=dev)
        k3_cases.append(check_k3(name, x, scale, bias))
    k2 = check_backward_kernels(dev, g, H, D)
    k2t = check_backward_kernels(
        dev, g, mini["heads"], mini["head_dim"], S=TRAINER["gpt_seq"],
        cases=[("trainer", TRAINER["gpt_batch"], None, True, 0,
                mini["head_dim"])])
    k45 = check_int8_kernels(dev, g)
    k67 = check_ring_kernels(dev, g)
    k1_all = k1_cases + [k2["fwd"], k2t["fwd"]]
    emit("kernels", flash_attention_fwd=k1_all,
         layer_norm_fwd=k3_cases, flash_attention_bwd_dq=k2["dq"] + k2t["dq"],
         flash_attention_bwd_dkv=k2["dkv"] + k2t["dkv"],
         quant_matmul=k45["k4"],
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
                 "generate": k1_cases[5], "checkpoint": k1_cases[0],
                 "fleet": k1_cases[0], "trainer": k2t["fwd"]},
                k1_all),
        # Serving launches K3 at its prefill and its decode rows: both
        # rows carry the serving run's launches (one counter).
        summary("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:38",
                "train", {"serve": k3_cases[0], "serve_decode": k3_cases[1],
                          "train": k3_cases[2], "train_ring": k3_cases[2],
                          "serve_chunked": k3_cases[3],
                          "serve_spec": k3_cases[4],
                          "generate": k3_cases[5],
                          "checkpoint": k3_cases[0],
                          "fleet": k3_cases[0],
                          "trainer": k3_cases[6]},
                k3_cases),
        summary("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
                "flash_attention.py:425", "train",
                {"train": k2["dkv"][0], "trainer": k2t["dkv"][0]},
                k2["dkv"] + k2t["dkv"]),
        summary("flash_attention_bwd_dq", "flash_attention_bwd.cu",
                "flash_attention.py:465", "train",
                {"train": k2["dq"][0], "trainer": k2t["dq"][0]},
                k2["dq"] + k2t["dq"]),
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


def check_backward_kernels(dev, g, H, D, S=None, cases=None):
    """K2b (dq, with delta) and K2a (dk, dv) against the plain backward at
    the train step's shape (S=1024, H=16, D=128, bf16; B=8 for the causal
    case the step runs, B=2 for the others), on the forward kernel's own
    output and logsumexp, which are first held against the plain forward
    (K1 at the train shape; its times in the first case are the ``fwd``
    row).  ``S`` and ``cases`` give another path's shape (the trainer
    CLI's gpt_mini).  The library time is ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention``, which computes dq, dk and dv in one
    call: the same number stands in both rows."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        attention_valid)

    S = S or TRAIN["seq_len"]
    tail = torch.ones(2, S, dtype=torch.int32, device=dev)
    tail[1, S - 300:] = 0
    head = torch.ones(2, S, dtype=torch.int32, device=dev)
    head[0, :10] = 0               # causal rows 0..9 see no valid key
    # (name, B, kv_mask, causal, window, head_dim)
    cases = cases or [("causal", TRAIN["batch"], None, True, 0, D),
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
        if rows["fwd"] is None:
            rows["fwd"] = dict(
                case="train" if name == "causal" else name, B=B, S=S, H=H,
                D=d, window=window,
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


# The fleet phase: the serve phase's model as a checkpoint served by
# tools/serve_fleet.py (each replica a tools/serve.py process on the
# card) and by two tools/serve_cell.py cells behind a global router.
FLEET = dict(replicas=2, poll_s=0.5, fail_after=2, tenants="search:2,ads:1",
             autoscale_max=3, burn_sustain_s=2.0, cooldown_s=5.0,
             # An objective every request of the tenant "probe" breaks, in
             # 5 s / 30 s windows: the autoscaler's burn, as
             # tests/test_router.py:749 induces it (the serving tenants
             # carry no objective, so nothing burns before the probe).
             burn_slo="probe:ttft_p95_ms<=1", slo_short_window_s=5.0,
             slo_long_window_s=30.0, slo_emit_every_s=0.5,
             kill_burst=16,
             # The two-cell drill: tests/test_cells.py:524's objectives,
             # schedule and kill, at a 128-token prompt and 16 new tokens.
             cell_slo="search:e2e_p95_ms<=60000,ads:e2e_p95_ms<=60000",
             cell_schedule=dict(duration_s=14.0, qps=2.0, seed=7,
                                prompt_len=128, gen_len=16),
             kill_at_s=4.0, rehome_bound=8, rehome_window_s=30.0)


def engine_flags() -> list:
    """``ENGINE``'s pool as the serving CLIs' flags."""
    return ["--slots", ENGINE["num_slots"], "--page_size",
            ENGINE["page_size"], "--num_pages", ENGINE["num_pages"],
            "--max_pages_per_seq", ENGINE["max_pages_per_seq"]]


class FleetWatch:
    """A router's ``/fleetz`` polled every 0.1 s from a thread: the
    newest snapshot, and the first ``time.time()`` each member was seen
    in each state."""

    def __init__(self, url: str):
        from distributed_tensorflow_tpu_torch.serving.client import (
            ServeClient)
        self.client = ServeClient(url, timeout_s=5.0, retries=0)
        self.snap: dict | None = None
        self.seen: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self):
        while not self._stop.is_set():
            try:
                snap = self.client.fleetz()
            except Exception:  # noqa: BLE001 — the next poll retries
                snap = None
            if snap is not None:
                now = time.time()
                for m in snap["members"]:
                    self.seen.setdefault((m["id"], m["state"]), now)
                self.snap = snap
            self._stop.wait(0.1)

    def wait(self, pred, timeout_s: float, what: str) -> dict:
        deadline = time.time() + timeout_s
        while True:
            snap = self.snap
            if snap is not None and pred(snap):
                return snap
            if time.time() > deadline:
                raise AssertionError(f"{what}: not within {timeout_s} s: "
                                     f"{snap and snap['router']}")
            time.sleep(0.05)

    def close(self):
        self._stop.set()
        self._thread.join()


def members(snap) -> dict:
    return {m["id"]: m for m in snap["members"]}


def replica_launches(log_dir: str) -> dict:
    """Each replica's ``kernel launches`` line (printed on its clean
    exit) from the ``replica-<id>.log`` files in ``log_dir``."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("replica-") and name.endswith(".log"):
            with open(os.path.join(log_dir, name)) as fh:
                lines = [x for x in fh if x.startswith("kernel launches ")]
            if lines:
                out[name[len("replica-"):-len(".log")]] = json.loads(
                    lines[-1][len("kernel launches "):])
    return out


def check_replica_launches(where: str, launches: dict, served: dict,
                           num_layers: int) -> None:
    """Gate: every replica that served a request exited cleanly with K1
    a positive multiple of the layers (one a layer a prefill), K3 a
    positive multiple of 2 a layer + 1 (a prefill or a decode step), and
    no other kernel."""
    k3 = 2 * num_layers + 1
    for rid, n in served.items():
        if not n:
            continue
        got = launches.get(rid)
        if got is None:
            raise AssertionError(f"{where} {rid} served {n} requests and "
                                 "printed no launch line")
        k1, ln = got["flash_attention_fwd"], got["layer_norm_fwd"]
        other = {k: v for k, v in got.items() if v and k not in (
            "flash_attention_fwd", "layer_norm_fwd")}
        if not (k1 > 0 and k1 % num_layers == 0 and ln > 0 and ln % k3 == 0
                and not other):
            raise AssertionError(f"{where} {rid}: launches {got}")


def fleet_stream(path: str) -> tuple[list, dict]:
    """A router's or global router's telemetry: its records, and the
    ``summarize_run --check`` verdict on it (gate: exit 0)."""
    from distributed_tensorflow_tpu_torch.tools import summarize_run
    if summarize_run.main([path, "--check"]) != 0:
        raise AssertionError(f"summarize_run --check failed on {path}")
    records, errors = summarize_run.load_records(path)
    return records, summarize_run.build_summary(records)


def fleet_drill(dev, run_dir: str, tmp: str, prompts, want) -> dict:
    """``fleet_serve``, ``fleet_kill`` and ``fleet_autoscale`` on one
    ``serve_fleet``, then the prompts once more from a tenant each, spread
    over the three live members: the numbers, each replica's launches and
    served requests."""
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    F = FLEET
    metrics = os.path.join(tmp, "fleet.jsonl")
    state = os.path.join(tmp, "fleet.json")
    log_dir = os.path.join(tmp, "fleet")
    root = os.path.dirname(os.path.abspath(__file__))
    seconds = {}
    t_part = time.perf_counter()
    with CliProcess(
            "tools.serve_fleet", "--logdir", run_dir, "--port", 0,
            "--device", dev, "--replicas", F["replicas"], *engine_flags(),
            "--tenants", F["tenants"], "--respawn", "--poll_s", F["poll_s"],
            "--fail_after", F["fail_after"],
            "--autoscale_min", F["replicas"],
            "--autoscale_max", F["autoscale_max"],
            "--burn_sustain_s", F["burn_sustain_s"],
            "--cooldown_s", F["cooldown_s"], "--idle_sustain_s", 1e9,
            "--slo", F["burn_slo"],
            "--slo_short_window_s", F["slo_short_window_s"],
            "--slo_long_window_s", F["slo_long_window_s"],
            "--slo_emit_every_s", F["slo_emit_every_s"],
            "--metrics_file", metrics, "--state_file", state,
            "--fleet_dir", log_dir) as cli:
        banner = cli.wait_for("routing fleet on :", 120)
        t_spawn = time.time()
        url = f"http://127.0.0.1:{int(banner.split(' on :')[1].split()[0])}"
        client = ServeClient(url, timeout_s=600.0, retries=3)
        watch = FleetWatch(url)
        try:
            # fleet_serve: the serve phase's 8 prompts, greedy, tenants
            # alternating, each traced (route.fleet spans by trace id).
            watch.wait(lambda s: s["router"]["healthy"] >= 2, 300,
                       "two healthy replicas")
            first = [watch.seen[(r, "healthy")] - t_spawn
                     for r in ("r0", "r1")]
            done, serve_s = burst(client, prompts, lambda i: dict(
                tenant=("search", "ads")[i % 2], trace=f"serve-{i}"))
            for i, r in enumerate(done):
                if r["tokens"][len(prompts[i]):] != want[i]:
                    raise AssertionError(
                        f"fleet request {i}: not the in-process engine's "
                        f"tokens (first divergence {first_divergence(r['tokens'][len(prompts[i]):], want[i])})")
            out = subprocess.run(
                [sys.executable, "-m",
                 "distributed_tensorflow_tpu_torch.tools.watch_serve",
                 "--fleet", "--url", url, "--once", "--json"], cwd=root,
                env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                text=True, timeout=60)
            watched = json.loads(out.stdout) if out.returncode == 0 else {}
            healthy = [m["id"] for m in watched.get("members", ())
                       if m["state"] == "healthy"]
            if len(healthy) != 2:
                raise AssertionError(f"watch_serve --fleet: {out.returncode}"
                                     f" {healthy} {out.stderr[-2000:]}")
            seconds["fleet_serve"] = time.perf_counter() - t_part

            # fleet_kill: 16 concurrent requests (the prompts twice), r1
            # SIGKILLed once half have completed.
            t_part = time.perf_counter()
            with open(state) as fh:
                pids = {m["id"]: m["pid"] for m in json.load(fh)["members"]}
            n = F["kill_burst"]
            results: list = [None] * n
            errors: list = []
            half = threading.Event()

            def call(i):
                try:
                    results[i] = client.generate(
                        prompts[i % len(prompts)], NEW_TOKENS,
                        tenant=("search", "ads")[i % 2], trace=f"kill-{i}")
                except Exception as e:  # noqa: BLE001 — the gate's target
                    errors.append((i, repr(e)))
                if sum(r is not None for r in results) + len(errors) \
                        >= n // 2:
                    half.set()
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(n)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            if not half.wait(600):
                raise AssertionError("half the kill burst never completed")
            t_kill = time.time()
            os.kill(pids["r1"], signal.SIGKILL)
            for t in threads:
                t.join(600)
            kill_burst_s = time.perf_counter() - t0
            if errors or any(r is None for r in results):
                raise AssertionError(f"failed requests through the kill: "
                                     f"{errors}")
            for i, r in enumerate(results):
                if r["tokens_out"] != NEW_TOKENS or r["tokens"][
                        len(prompts[i % len(prompts)]):] != want[
                        i % len(prompts)]:
                    raise AssertionError(f"kill burst request {i}: "
                                         f"{r['tokens_out']} tokens, not "
                                         "the in-process engine's")
            snap = watch.wait(lambda s: members(s)["r1"]["state"] == "dead",
                              30, "r1 marked dead")
            dead_s = watch.seen[("r1", "dead")] - t_kill
            for tenant in ("search", "ads"):     # the survivor serves both
                r = client.generate(prompts[0][:16], 4, tenant=tenant)
                if r["tokens_out"] != 4:
                    raise AssertionError(f"after the kill: {tenant} {r}")
            snap = watch.wait(lambda s: any(
                m["state"] == "healthy" and m["id"] not in ("r0", "r1")
                for m in s["members"]), 300, "a respawned member healthy")
            (respawned,) = [m for m in members(snap) if m not in ("r0", "r1")]
            respawn_s = (watch.seen[(respawned, "healthy")]
                         - watch.seen[(respawned, "starting")])
            failovers = snap["router"]["failovers"]
            if snap["router"]["failed"]:
                raise AssertionError(f"fleet failed {snap['router']}")
            seconds["fleet_kill"] = time.perf_counter() - t_part

            # fleet_autoscale: the probe tenant's burn until a third
            # member is healthy.
            t_part = time.perf_counter()
            stop_burn = threading.Event()

            def burn():
                while not stop_burn.is_set():
                    try:
                        client.generate(prompts[0][:16], 4, tenant="probe")
                    except Exception:  # noqa: BLE001 — keep burning
                        time.sleep(0.2)
            burner = threading.Thread(target=burn)
            t_burn = time.time()
            burner.start()
            try:
                snap = watch.wait(lambda s: s["router"]["healthy"] >= 3, 300,
                                  "the autoscaled member healthy")
            finally:
                stop_burn.set()
                burner.join(600)
            (scaled,) = [m for m in members(snap)
                         if m not in ("r0", "r1", respawned)]
            up_s = watch.seen[(scaled, "starting")] - t_burn
            up_healthy_s = (watch.seen[(scaled, "healthy")]
                            - watch.seen[(scaled, "starting")])
            # The prompts again, each from a tenant of its own: the
            # least-loaded choice spreads them over the three members,
            # the respawned and the autoscaled one included.
            spread, _ = burst(client, prompts,
                              lambda i: dict(tenant=f"spread{i}"))
            final = client.fleetz()
            for i, r in enumerate(spread):
                if r["tokens"][len(prompts[i]):] != want[i]:
                    raise AssertionError(f"spread request {i}: not the "
                                         "in-process engine's tokens")
            seconds["fleet_autoscale"] = time.perf_counter() - t_part
        finally:
            watch.close()
    t_part = time.perf_counter()
    if cli.proc.returncode != 0:
        raise AssertionError(f"serve_fleet exited {cli.proc.returncode}")
    records, summary = fleet_stream(metrics)
    (worker,) = summary["workers"].values()
    fleet = worker["fleet"]
    actions = fleet["actions"]
    if not (actions.get("replica_dead", 0) >= 1 and fleet["failed"] == 0
            and actions.get("scale_up", 0) == 1
            and actions.get("respawn", 0) >= 1):
        raise AssertionError(f"router stream: {fleet}")
    # The router's added latency: a request's route.fleet span (the wall
    # its kind="route" record's route_ms holds) less the replica's e2e
    # (ttft + tpot x (tokens - 1), submit to done), for the requests
    # that needed no failover.
    spans = {r["trace_id"]: r for r in records if r.get("kind") == "span"
             and r.get("name") == "route.fleet"}
    traced = [(f"serve-{i}", r) for i, r in enumerate(done)] + [
        (f"kill-{i}", r) for i, r in enumerate(results)]
    added = [spans[t]["dur_ms"] - (r["ttft_ms"] + r["tpot_ms"] * (
        r["tokens_out"] - 1)) for t, r in traced
        if t in spans and spans[t]["failovers"] == 0]
    # The replicas still in the fleet at its SIGTERM (r1 was SIGKILLed).
    served = {m["id"]: m["served"] for m in final["members"]
              if m["state"] != "dead"}
    launches = replica_launches(log_dir)
    seconds["fleet_stop"] = time.perf_counter() - t_part
    return dict(
        spawn_to_healthy_s={"r0": first[0], "r1": first[1],
                            respawned: respawn_s, scaled: up_healthy_s},
        router_added_ms=dict(p50=statistics.median(added),
                             p95=statistics.quantiles(added, n=20)[-1],
                             requests=len(added)),
        serve_burst=dict(requests=len(done), burst_s=serve_s,
                         tokens_per_s=len(done) * NEW_TOKENS / serve_s),
        kill_burst=dict(requests=n, failed=0, burst_s=kill_burst_s,
                        tokens_per_s=n * NEW_TOKENS / kill_burst_s,
                        kill_to_dead_s=dead_s, failovers=failovers,
                        respawned=respawned,
                        respawn_to_healthy_s=respawn_s),
        autoscale=dict(burn_to_up_s=up_s, up_to_healthy_s=up_healthy_s,
                       member=scaled, scale_up_actions=actions["scale_up"]),
        router=dict(routed=fleet["routed"], failed=fleet["failed"],
                    actions=actions),
        watch_serve_healthy=healthy, served=served, launches=launches,
        seconds=seconds)


def cells_drill(dev, run_dir: str, tmp: str) -> dict:
    """``cells_drill``: two one-replica cells and a global router; loadgen's
    ``cell_kill`` SIGKILLs cell a wholesale at 4 s."""
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    from distributed_tensorflow_tpu_torch.tools import loadgen, summarize_run
    from distributed_tensorflow_tpu_torch.utils import faults
    F = FLEET
    states = {c: os.path.join(tmp, f"cell_{c}.json") for c in "ab"}
    gstream = os.path.join(tmp, "global.jsonl")
    gstate = os.path.join(tmp, "global.json")
    with contextlib.ExitStack() as stack:
        t0 = time.time()
        cells = {c: stack.enter_context(CliProcess(
            "tools.serve_cell", "--cell", c, "--logdir", run_dir,
            "--replicas", 1, "--device", dev, *engine_flags(),
            "--tenants", F["tenants"], "--poll_s", F["poll_s"],
            "--fail_after", F["fail_after"], "--slo", F["cell_slo"],
            "--metrics_file", os.path.join(tmp, f"cell_{c}.jsonl"),
            "--state_file", states[c],
            "--cell_dir", os.path.join(tmp, f"cell_{c}"))) for c in "ab"}
        urls = {}
        for c, cli in cells.items():
            cli.wait_for(f"serving cell {c} on :", 120)
            with open(states[c]) as fh:
                urls[c] = json.load(fh)["router_url"]
        healthy_s = {}
        for c, url in urls.items():
            probe = ServeClient(url, timeout_s=10.0, retries=0)
            deadline = time.time() + 300
            while True:
                try:
                    if probe.fleetz()["router"]["healthy"] >= 1:
                        break
                except Exception:  # noqa: BLE001 — still booting
                    pass
                if time.time() > deadline:
                    raise AssertionError(f"cell {c} never became healthy")
                time.sleep(0.1)
            healthy_s[c] = time.time() - t0
        glob = stack.enter_context(CliProcess(
            "tools.serve_cell", "--cell_state",
            f"{states['a']},{states['b']}", "--poll_s", F["poll_s"],
            "--fail_after", F["fail_after"],
            "--rehome_bound", F["rehome_bound"],
            "--rehome_window_s", F["rehome_window_s"],
            "--metrics_file", gstream, "--state_file", gstate))
        glob.wait_for("routing 2 cell(s) on :", 120)
        with open(gstate) as fh:
            gurl = json.load(fh)["router_url"]
        probe = ServeClient(gurl, timeout_s=60.0)
        deadline = time.time() + 60
        while True:
            try:
                if probe.cellz()["global"]["healthy_cells"] == 2:
                    break
            except Exception:  # noqa: BLE001 — still adopting the cells
                pass
            if time.time() > deadline:
                raise AssertionError("the global router never saw 2 "
                                     "healthy cells")
            time.sleep(0.1)
        for tenant in ("search", "ads"):         # pin the tenants' homes
            probe.generate([1, 2, 3], 2, tenant=tenant)
        schedule = loadgen.build_schedule("cell_kill",
                                          **F["cell_schedule"])
        report = loadgen.run_schedule(
            gurl, schedule, slo=F["cell_slo"], timeout_s=60.0,
            kill_at_s=F["kill_at_s"], scenario="cell_kill",
            kill_fn=lambda: faults.kill_cell(states["a"], "a"))
        if report["failed"] or not report["ok"] \
                or report["ever_burning"] != []:
            raise AssertionError(f"cell_kill: {report}")
        snap = ServeClient(urls["b"], timeout_s=10.0).fleetz()
        for m in snap["members"]:
            slo = (m.get("statz") or {}).get("slo") or {}
            if slo.get("ever_burning", []) != []:
                raise AssertionError(f"cell b burned: {m}")
        served = {m["id"]: m["served"] for m in snap["members"]}
    records, _ = fleet_stream(gstream)
    section = summarize_run.cell_summary(records)
    if not (section.get("cell_deaths", 0) >= 1
            and section.get("rehomes", 0) >= 1):
        raise AssertionError(f"global stream: {section}")
    return dict(
        spawn_to_healthy_s=healthy_s,
        loadgen={k: report[k] for k in ("requests", "ok", "rejected",
                                        "failed", "ever_burning")
                 if k in report},
        failover_gap_ms=section.get("failover_gap_ms_max"),
        failover_gaps=section.get("failover_gaps"),
        rehomes=section["rehomes"], rejected_429=report["rejected"],
        throttle_rejects=section.get("throttle_rejects"),
        actions=section.get("actions"), served=served,
        launches=replica_launches(os.path.join(tmp, "cell_b")))


def fleet_phase(dev, smi: str, model, whole: dict) -> dict:
    """Phase ``fleet``: the serving fleet tier at the serve phase's width.
    ``save_raw`` writes the model as the ``checkpoint`` phase does; the
    fleet's two replicas give the in-process engine's greedy tokens,
    survive a replica's SIGKILL with no failed request (respawn), and
    scale up on a burning objective; two cells survive a cell's SIGKILL
    behind the global router.  Returns the replicas' summed launches."""
    import numpy as np
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.tools import checkpoint_io

    t_phase = t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    run_dir = os.path.join(tmp, "gpt_mini")
    try:
        checkpoint_io.save_raw(
            os.path.join(run_dir, "checkpoints"), 1,
            {"params": gpt.params_to_jax(model.state_dict()),
             "global_step": np.asarray(1, np.int32)})
        prompts = whole["prompts"]
        want, _ = engine_tokens(dev, model, prompts)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet = fleet_drill(dev, run_dir, tmp, prompts, want)
        t1 = time.perf_counter()
        cells = cells_drill(dev, run_dir, tmp)
        cells_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    L = WIDTH["num_layers"]
    check_replica_launches("fleet", fleet["launches"], fleet["served"], L)
    check_replica_launches("cell b", cells["launches"], cells["served"], L)
    total: dict = {}
    for counts in [*fleet["launches"].values(),
                   *cells["launches"].values()]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    emit("fleet", card=smi, model="gpt_406m_width",
         seconds=time.perf_counter() - t_phase,
         seconds_by_part=dict(setup=setup_s, **fleet.pop("seconds"),
                              cells_drill=cells_s),
         fleet_tokens_per_s=fleet["kill_burst"]["tokens_per_s"],
         serve_tokens_per_s=whole["tokens_per_s"],
         tokens_equal_in_process=len(whole["prompts"]),
         **fleet, cells=cells, launches_total=total)
    return total


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
    """Every kernel's launch counter, by kernel name (the counters a
    serving CLI prints on exit)."""
    from distributed_tensorflow_tpu_torch.ops import kernels
    return kernels.launch_counts()


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


# ------------------------------------------------------------- trainer


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def finish(proc: CliProcess, timeout_s: float) -> list:
    """Every output line of a CLI process that must exit 0 within
    ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while True:
        try:
            line = proc.lines.get(
                timeout=max(deadline - time.perf_counter(), 0.01))
        except queue.Empty:
            raise AssertionError("CLI timed out: "
                                 + "".join(proc.seen[-30:])) from None
        if line is None:
            break
        proc.seen.append(line)
    if proc.proc.wait(timeout=60) != 0:
        raise AssertionError(f"CLI exited {proc.proc.returncode}: "
                             + "".join(proc.seen[-40:]))
    return proc.seen


def line_value(lines, prefix: str) -> str:
    """The rest of the last line that starts with ``prefix``."""
    hits = [x[len(prefix):].strip() for x in lines if x.startswith(prefix)]
    if not hits:
        raise AssertionError(f"no {prefix!r} line: " + "".join(lines[-30:]))
    return hits[-1]


def run_summary(path: str) -> dict:
    """The trainer's telemetry: its ``run_summary`` record and the
    ``step_ms`` of its ``train_step`` records (``--log_every=1``)."""
    records = [json.loads(x) for x in open(path)]
    (summary,) = [r for r in records if r.get("kind") == "run_summary"]
    steps = [r["data_wait_ms"] + r["compute_ms"] for r in records
             if r.get("kind") == "train_step"]
    return dict(summary=summary, step_ms=steps)


def trainer_numbers(lines, metrics: str, task: int,
                    profile: str | None = None) -> dict:
    """A trainer process's numbers: its printed lines, its telemetry
    (``step_ms`` is data wait + compute, the step synchronised with the
    card each step) and, with ``--profile_dir``, its profile summary."""
    tele = run_summary(metrics)
    steady = tele["step_ms"][2:]
    step_ms = statistics.median(steady)
    out = dict(
        test_accuracy=float(line_value(lines, f"Worker {task}: test "
                                              "accuracy")),
        train_s=float(line_value(lines, "Training elapsed time:")
                      .rstrip(" s")),
        step_ms_median=step_ms, step_ms_mean=statistics.mean(steady),
        steps_per_s=1e3 / step_ms,
        steps=len(tele["step_ms"]),
        digest=line_value(lines, f"Worker {task}: parameter digest"),
        launches=json.loads(line_value(lines,
                                       f"Worker {task}: kernel launches")))
    if profile is not None:
        with open(os.path.join(profile, "summary.json")) as fh:
            prof = json.load(fh)
        out.update(busy_share=prof["busy_share"],
                   profile_window_ms=prof["window_ms"],
                   device_busy_ms=prof["device_busy_ms"],
                   top_kernels=prof["top_kernels"][:5])
    return out


def reference_job(device: str, tmp: str, smi: str, workers: int = 2,
                  backend: str = "gloo") -> dict:
    """The reference job, ``examples/launch_local_cluster.sh``'s flags:
    one PS and ``workers`` sync workers, MNIST MLP at the reference's
    width, one all-reduce a step over ``backend`` (the one the workers
    must print).  ``device``: ``cuda:0`` puts every worker on the one card
    (gloo), ``cuda`` gives worker i card i (NCCL with a card each)."""
    ps_port = free_port()
    ports = [free_port() for _ in range(workers)]
    T = TRAINER
    logdir = os.path.join(tmp, "reference")
    common = [f"--ps_hosts=localhost:{ps_port}",
              "--worker_hosts=" + ",".join(f"localhost:{p}" for p in ports),
              f"--data_dir={os.path.join(tmp, 'no-mnist')}",
              f"--train_steps={T['steps']}", f"--batch_size={T['batch']}",
              f"--hidden_units={T['hidden']}",
              f"--learning_rate={T['lr']}", "--sync_replicas=true",
              "--log_every=1", f"--logdir={logdir}", f"--device={device}",
              f"--metrics_file={os.path.join(tmp, 'ref.jsonl')}",
              f"--profile_dir={os.path.join(tmp, 'ref_profile')}"]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        ps = stack.enter_context(CliProcess(
            "train", "--job_name=ps", "--task_index=0", *common))
        # The non-chiefs first: they wait for the chief's init signal.
        procs = {t: stack.enter_context(CliProcess(
            "train", "--job_name=worker", f"--task_index={t}", *common))
            for t in [*range(1, workers), 0]}
        outs = {t: finish(procs[t], 300) for t in range(workers)}
        ps_alive = ps.proc.poll() is None
    wall_s = time.perf_counter() - t0
    if not ps_alive:
        raise AssertionError("the PS exited before it was stopped: "
                             + "".join(ps.seen[-20:]))
    for task, lines in outs.items():
        text = "".join(lines)
        want = "Initailizing session" if task == 0 else "Waiting for session"
        for needle in (want, f"Worker {task}: test accuracy",
                       "Training elapsed time", f" over {backend} "):
            if needle not in text:
                raise AssertionError(f"worker {task}: no {needle!r}: "
                                     + text[-3000:])
    nums = [trainer_numbers(outs[t], os.path.join(tmp, f"ref.jsonl.task{t}"),
                            t, os.path.join(tmp, "ref_profile", f"task{t}"))
            for t in range(workers)]
    digests = {n["digest"] for n in nums}
    if len(digests) != 1:
        raise AssertionError(f"worker parameters differ: digests {digests}")
    acc = nums[0]["test_accuracy"]
    if abs(acc - T["jax_cpu_test_accuracy"]) > T["accuracy_tol"]:
        raise AssertionError(
            f"test accuracy {acc}, the JAX CLI's {T['jax_cpu_test_accuracy']}"
            f" (tol {T['accuracy_tol']})")
    allreduce = line_value(outs[0], "Worker 0: all-reduce")
    ar_ms = float(allreduce.split(" ms")[0])
    emit("trainer_reference", card=smi, wall_s=wall_s, workers_n=workers,
         jax_cpu_test_accuracy=T["jax_cpu_test_accuracy"],
         accuracy_tol=T["accuracy_tol"],
         bring_up=line_value(outs[0], "Worker 0: process group"),
         allreduce=allreduce, allreduce_ms=ar_ms,
         allreduce_share_of_step=ar_ms / nums[0]["step_ms_median"],
         workers=nums)
    return nums[0]


def gpt_trainer_busy(dev) -> dict:
    """The busy share of the trainer's gpt_mini step: the bundle the CLI
    builds from its flags (``models/registry.build``) and its sync step,
    one step profiled in this process after three (the CLI's own
    ``--profile_dir`` would add the profiler's start and its trace export,
    ~45 s, to the phase)."""
    import types
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    T = TRAINER
    flags = types.SimpleNamespace(
        learning_rate=0.01, seed=0, bert_seq_len=T["gpt_seq"],
        attention_backend="pallas", fused_layer_norm=True,
        bert_dtype="bfloat16", optimizer="")
    bundle = registry.build("gpt_mini", flags, dev)
    step = build_sync_train_step(bundle.loss_fn)
    data = bundle.load_datasets(None).train
    state = bundle.state
    for _ in range(3):
        state, metrics = step(state, to_device(
            data.next_batch(T["gpt_batch"]), dev))
    float(metrics["loss"])
    out = profile_train_step(step, state, to_device(
        data.next_batch(T["gpt_batch"]), dev))
    del bundle, state
    return out


def gpt_trainer(dev, tmp: str, smi: str) -> dict:
    """gpt_mini at mini()'s full width through the trainer CLI (one
    worker, no PS: the reference's config #1, the worker hosting the
    coordination service) on the hand-written kernels, then
    ``--mode=eval`` and ``--mode=generate`` on its checkpoint."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.tools.checkpoint_io import (
        restore_raw)
    from distributed_tensorflow_tpu_torch.tools.export_model import (
        kernel_config)
    T = TRAINER
    logdir = os.path.join(tmp, "gpt")
    common = ["--model=gpt_mini", "--attention_backend=pallas",
              "--fused_layer_norm", f"--bert_seq_len={T['gpt_seq']}",
              f"--batch_size={T['gpt_batch']}", f"--logdir={logdir}",
              f"--device={dev}", "--job_name=worker", "--task_index=0",
              f"--worker_hosts=localhost:{free_port()}", "--ps_hosts=",
              "--sync_replicas=true"]
    t0 = time.perf_counter()
    with CliProcess("train", *common, f"--train_steps={T['gpt_steps']}",
                    f"--save_interval_steps={T['gpt_save']}",
                    "--log_every=1",
                    f"--metrics_file={os.path.join(tmp, 'gpt.jsonl')}"
                    ) as proc:
        lines = finish(proc, 400)
    train_wall_s = time.perf_counter() - t0
    nums = trainer_numbers(lines, os.path.join(tmp, "gpt.jsonl"), 0)
    losses = [float(x.split(" loss ")[1].split()[0]) for x in lines
              if x.startswith("Worker 0: traing step")]
    steps = nums["steps"]
    if steps != T["gpt_steps"] - 1 or len(losses) != steps:
        raise AssertionError(f"{steps} steps, {len(losses)} loss lines; "
                             f"expected {T['gpt_steps'] - 1}")
    if not (all(map(math.isfinite, losses))
            and statistics.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"gpt_mini loss did not fall: {losses}")
    L = gpt.mini().num_layers
    # Each train step: K1, K2a, K2b once a layer, K3 twice a layer and
    # once at the end; each eval forward (the validation at step 0 and the
    # final test, ``make_lm_eval_fn``'s 4 batches each) K1 and K3 as a
    # step's forward.
    forwards = steps + 2 * 4
    want = {"flash_attention_fwd": L * forwards,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "layer_norm_fwd": (2 * L + 1) * forwards,
            "quant_matmul": 0, "quant_matmul_nt": 0}
    if nums["launches"] != want:
        raise AssertionError(f"trainer launches {nums['launches']}, "
                             f"expected {want}")
    peak_gib = float(line_value(lines, "Worker 0: peak device memory")
                     .split()[0])

    t0 = time.perf_counter()
    with CliProcess("train", *common, "--mode=eval") as proc:
        eval_lines = finish(proc, 300)
    eval_s = time.perf_counter() - t0
    eval_acc = float(line_value(eval_lines, "Worker 0: test accuracy"))
    if eval_acc != nums["test_accuracy"]:
        raise AssertionError(f"--mode=eval test accuracy {eval_acc}, the "
                             f"trained process's {nums['test_accuracy']}")
    restored = int(line_value(eval_lines, "Worker 0: restored global step"))
    if restored != T["gpt_steps"]:
        raise AssertionError(f"--mode=eval restored step {restored}")

    prompt = list(range(1, 17))
    t0 = time.perf_counter()
    gen = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.train",
         "--mode=generate", "--model=gpt_mini", f"--logdir={logdir}",
         f"--device={dev}", f"--gen_tokens={T['gen_tokens']}",
         "--gen_prompt=" + ",".join(map(str, prompt))],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))),
        text=True, capture_output=True, timeout=300)
    gen_s = time.perf_counter() - t0
    if gen.returncode:
        raise AssertionError(f"--mode=generate rc {gen.returncode}: "
                             f"{gen.stdout[-2000:]}{gen.stderr[-2000:]}")
    got = [int(t) for t in line_value(gen.stdout.splitlines(True),
                                      "Generated tokens:").split()]
    tree = restore_raw(os.path.join(logdir, "gpt_mini"))[0]
    params = tree.get("ema_params") or tree["params"]
    cfg = dataclasses.replace(gpt.mini(), **gpt.infer_widths(params))
    model = gpt.GptLM(kernel_config(cfg), device=dev)
    model.load_state_dict(gpt.params_from_jax(params))
    want_toks = gpt.generate_cached(
        model, None, torch.tensor([prompt], dtype=torch.int32),
        T["gen_tokens"])[0, len(prompt):].tolist()
    if got != want_toks:
        raise AssertionError(f"--mode=generate tokens {got}, in process "
                             f"{want_toks}")
    del model
    profiled = gpt_trainer_busy(dev)
    torch.cuda.empty_cache()
    tokens = T["gpt_batch"] * T["gpt_seq"]
    emit("trainer_gpt", card=smi, train_wall_s=train_wall_s,
         eval_wall_s=eval_s, generate_wall_s=gen_s, batch=T["gpt_batch"],
         seq_len=T["gpt_seq"], loss_first=losses[0],
         loss_last5_mean=statistics.mean(losses[-5:]),
         tokens_per_s=tokens / (nums["step_ms_median"] / 1e3),
         peak_mem_gib=peak_gib, launches_expected=want,
         eval_test_accuracy=eval_acc,
         eval_validation_accuracy=float(line_value(
             eval_lines, "Worker 0: validation accuracy")),
         generated=got, busy_share=profiled["busy_share"], **nums)
    emit("trainer_gpt_profile", **profiled)
    return nums["launches"]


def trainer(dev, smi: str) -> dict:
    """Phase ``trainer``: the port's CLI trainer as processes (the
    reference job, then gpt_mini with eval and generate).  Returns the
    gpt_mini run's kernel launches."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        reference_job(str(dev), tmp, smi)
        return gpt_trainer(dev, tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trainer_nccl(smi: str) -> None:
    """``--nccl``: the reference job with one worker on each visible card
    (worker i on card i), so the workers' all-reduce goes over NCCL; the
    same gates as ``trainer_reference``.  Needs 2 or more cards whose count
    divides the global batch of 100."""
    import torch
    n = torch.cuda.device_count()
    if n < 2 or TRAINER["batch"] % n:
        raise AssertionError(f"--nccl needs 2+ cards dividing the batch of "
                             f"{TRAINER['batch']}, found {n}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        reference_job("cuda", tmp, smi, workers=n, backend="nccl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The async_trainer phase.  The reference job's flags plus a merge every 4
# local steps, the steps paced (as tests/test_multiprocess.py paces its
# async workers) so that the two workers' windows overlap: 100 ms where
# worker 1 starts after worker 0 has published (a worker takes ~10 s to
# start on the card), 60 ms where both start together; the JAX CLI with
# the same flags on a CPU (a PS and two workers, one device each) reaches
# a test accuracy of 1 on both workers, the tolerance is the sync job's.
# gpt_mini: the trainer phase's width, S=512, B=32, 40 global steps of one
# replica (39 local steps), a merge every 10, paced as well.
ASYNC = dict(period=4, pace_s=0.1, overlap_pace_s=0.06, gpt_period=10,
             gpt_steps=40,
             gpt_pace_s=0.15, jax_cpu_test_accuracy=1.0,
             # Full-state bytes over the int8 round's: the JAX package's
             # acceptance bar (tests/test_param_exchange.py:177).
             min_wire_ratio=4.0, drift_share=0.1, drift_scale=0.01,
             # The int8 leg's part of the tree: the embeddings and the
             # first two of the eight blocks (widths unchanged; ~103M of
             # the 406M parameters).  The codec is host numpy and zlib,
             # 12-40 s an exchange over the whole tree.
             int8_leaves=("word_emb", "pos_emb", "layer0", "layer1"))


def exchange_records(path: str) -> list:
    """The ``param_exchange`` telemetry records of a trainer's metrics
    file (one an exchange period; the overlapped exchange writes its own
    from its thread)."""
    out = []
    for line in open(path):
        try:
            r = json.loads(line)
        except ValueError:
            continue
        if r.get("kind") == "param_exchange":
            out.append(r)
    return out


def exchange_numbers(lines, metrics: str, task: int, train_s: float) -> dict:
    """A worker's exchange: ms a period (the averager's own clock; in the
    overlapped mode the background thread's), its share of the training
    time, the bytes on the wire a period beside the full state's, and the
    publish rate the trainer prints."""
    recs = exchange_records(metrics)
    if not recs:
        raise AssertionError(f"worker {task}: no param_exchange records")
    ms = [r["dur_ms"] for r in recs]
    rates = [float(x.split("publish, ")[1].split(" MB/s")[0])
             for x in lines if "publish, " in x and " MB/s)" in x]
    wire = [r["bytes_on_wire"] for r in recs if r["peers"]]
    full = [r["full_state_bytes"] for r in recs if r["peers"]]
    return dict(exchanges=len(recs), exchange_ms_mean=statistics.mean(ms),
                exchange_ms_median=statistics.median(ms),
                exchange_share_of_train=sum(ms) / 1e3 / train_s,
                publish_mb_per_s=statistics.mean(rates) if rates else None,
                wire_bytes_per_round=statistics.mean(wire) if wire else None,
                full_state_bytes_per_round=(statistics.mean(full)
                                            if full else None),
                compressed=any(r["compressed"] for r in recs))


def async_job(device: str, tmp: str, smi: str, label: str, *extra,
              pace_s: float, stagger: bool = True) -> dict:
    """The reference job in async mode: a PS and two workers on
    ``device``, each step paced by ``pace_s``; with ``stagger``, worker 1
    starts once worker 0 has published (its first exchange runs at local
    step 4, before the step-5 line)."""
    ps_port = free_port()
    ports = [free_port(), free_port()]
    T, A = TRAINER, ASYNC
    logdir = os.path.join(tmp, label)
    common = [f"--ps_hosts=localhost:{ps_port}",
              "--worker_hosts=" + ",".join(f"localhost:{p}" for p in ports),
              f"--data_dir={os.path.join(tmp, 'no-mnist')}",
              f"--train_steps={T['steps']}", f"--batch_size={T['batch']}",
              f"--hidden_units={T['hidden']}",
              f"--learning_rate={T['lr']}", "--sync_replicas=false",
              f"--async_sync_period={A['period']}",
              f"--inject_step_delay={pace_s}:0:1000000000",
              "--log_every=1", f"--logdir={logdir}", f"--device={device}",
              f"--metrics_file={os.path.join(tmp, label + '.jsonl')}",
              *extra]

    def worker(t):
        return CliProcess("train", "--job_name=worker", f"--task_index={t}",
                          *common)

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        ps = stack.enter_context(CliProcess(
            "train", "--job_name=ps", "--task_index=0", *common))
        w0 = stack.enter_context(worker(0))
        if stagger:
            w0.wait_for("Worker 0: traing step 5 ", 300)
        w1 = stack.enter_context(worker(1))
        outs = {1: finish(w1, 300), 0: finish(w0, 300)}
        ps_alive = ps.proc.poll() is None
    wall_s = time.perf_counter() - t0
    if not ps_alive:
        raise AssertionError("the PS exited before it was stopped: "
                             + "".join(ps.seen[-20:]))
    nums = []
    for t in (0, 1):
        metrics = os.path.join(tmp, f"{label}.jsonl.task{t}")
        try:
            n = trainer_numbers(outs[t], metrics, t)
            n.update(exchange_numbers(outs[t], metrics, t, n["train_s"]))
        except (ValueError, KeyError, AssertionError) as e:
            kinds = [json.loads(x).get("kind") for x in open(metrics)]
            raise AssertionError(
                f"{label} worker {t}: {e!r}; records "
                f"{ {k: kinds.count(k) for k in set(kinds)} }: "
                + "".join(outs[t][-40:])) from e
        acc = n["test_accuracy"]
        if abs(acc - A["jax_cpu_test_accuracy"]) > T["accuracy_tol"]:
            raise AssertionError(
                f"{label} worker {t}: test accuracy {acc}, the JAX CLI's "
                f"{A['jax_cpu_test_accuracy']} (tol {T['accuracy_tol']})")
        n["step_ms_unpaced"] = n["step_ms_median"] - pace_s * 1e3
        nums.append(n)
    text = {t: "".join(outs[t]) for t in (0, 1)}
    return dict(wall_s=wall_s, text=text, workers=nums)


def async_mlp_busy(dev, tmp: str) -> dict:
    """The busy share of the reference job's async local step (the
    trainer's MNIST bundle, one replica) in this process: one step
    profiled after three (the CLI's profiler takes ~17 s to start, longer
    than a paced run)."""
    import types
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.async_replicas import (
        build_async_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    T = TRAINER
    flags = types.SimpleNamespace(hidden_units=T["hidden"],
                                  learning_rate=T["lr"], seed=0,
                                  optimizer="")
    bundle = registry.build("mnist_mlp", flags, dev)
    step, astate = build_async_train_step(
        bundle.loss_fn, bundle.state, num_replicas=1,
        sync_period=ASYNC["period"])
    data = bundle.load_datasets(os.path.join(tmp, "no-mnist")).train
    for _ in range(3):
        astate, metrics = step(astate, to_device(data.next_batch(T["batch"]),
                                                 dev))
    float(metrics["loss"])
    return profile_train_step(step, astate, to_device(
        data.next_batch(T["batch"]), dev))


def async_reference(dev, tmp: str, smi: str) -> None:
    """``async_reference``: averaging through the KV, a late joiner's
    adoption, the accuracy gate."""
    out = async_job(str(dev), tmp, smi, "async_ref",
                    pace_s=ASYNC["pace_s"])
    both = out["text"][0] + out["text"][1]
    for needle in ("averaged parameters with 1 peer(s)", "(kv publish"):
        if needle not in both:
            raise AssertionError(f"async_reference: no {needle!r}: "
                                 + both[-3000:])
    if "adopted published collective parameters" not in out["text"][1]:
        raise AssertionError("async_reference: worker 1 did not adopt the "
                             "published parameters: "
                             + out["text"][1][-3000:])
    busy = async_mlp_busy(dev, tmp)
    emit("async_reference", card=smi, wall_s=out["wall_s"],
         pace_ms=ASYNC["pace_s"] * 1e3, period=ASYNC["period"],
         busy_share=busy["busy_share"], busy_window_ms=busy["window_ms"],
         jax_cpu_test_accuracy=ASYNC["jax_cpu_test_accuracy"],
         accuracy_tol=TRAINER["accuracy_tol"],
         averaged_lines=[both.count("averaged parameters with 1 peer(s)")],
         workers=out["workers"])


def async_overlap(dev, tmp: str, smi: str) -> None:
    """``async_overlap``: the compressed (int8) exchange overlapped with
    training, both workers started together (tests/test_multiprocess.py:
    282)."""
    out = async_job(str(dev), tmp, smi, "async_ovl",
                    "--async_compress=int8", "--async_overlap_exchange=true",
                    pace_s=ASYNC["overlap_pace_s"], stagger=False)
    both = out["text"][0] + out["text"][1]
    for needle in ("compressed parameter exchange on",
                   "applied overlapped average with 1 peer(s)",
                   "in background"):
        if needle not in both:
            raise AssertionError(f"async_overlap: no {needle!r}: "
                                 + both[-3000:])
    if "averaged parameters with" in both:
        raise AssertionError("async_overlap: a foreground average ran")
    wire = [w["wire_bytes_per_round"] for w in out["workers"]]
    full = [w["full_state_bytes_per_round"] for w in out["workers"]]
    emit("async_overlap", card=smi, wall_s=out["wall_s"],
         pace_ms=ASYNC["overlap_pace_s"] * 1e3, wire_bytes_per_round=wire,
         full_state_bytes_per_round=full,
         applied_lines=both.count("applied overlapped average"),
         workers=out["workers"])


def async_gpt_busy(dev) -> dict:
    """The async local step of the trainer's gpt_mini bundle (one replica,
    as the trainer builds it) in this process, not in the CLI: its ms a
    step over 10 (no exchange, no telemetry, no pace) and one step
    profiled, for the busy share (the CLI's profiler takes ~17 s to
    start)."""
    import types
    import torch
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.async_replicas import (
        build_async_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    T, A = TRAINER, ASYNC
    flags = types.SimpleNamespace(
        learning_rate=0.01, seed=0, bert_seq_len=T["gpt_seq"],
        attention_backend="pallas", fused_layer_norm=True,
        bert_dtype="bfloat16", optimizer="")
    bundle = registry.build("gpt_mini", flags, dev)
    step, astate = build_async_train_step(
        bundle.loss_fn, bundle.state, num_replicas=1,
        sync_period=A["gpt_period"])
    data = bundle.load_datasets(None).train
    batches = [to_device(data.next_batch(T["gpt_batch"]), dev)
               for _ in range(13)]
    for b in batches[:3]:
        astate, metrics = step(astate, b)
    float(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[3:]:
        astate, metrics = step(astate, b)
    float(metrics["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    out = profile_train_step(step, astate, batches[0])
    del bundle, astate
    return dict(in_process_step_ms=step_ms,
                in_process_tokens_per_s=(T["gpt_batch"] * T["gpt_seq"]
                                         / step_ms * 1e3),
                **out)


def async_gpt(dev, tmp: str, smi: str) -> dict:
    """``async_gpt``: gpt_mini async through the kernels, two workers on
    the card and no PS (the chief hosts the coordination service).
    Returns the two workers' summed launches."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    T, A = TRAINER, ASYNC
    ports = [free_port(), free_port()]
    logdir = os.path.join(tmp, "async_gpt")
    common = ["--model=gpt_mini", "--attention_backend=pallas",
              "--fused_layer_norm", f"--bert_seq_len={T['gpt_seq']}",
              f"--batch_size={T['gpt_batch']}", f"--logdir={logdir}",
              f"--device={dev}", "--ps_hosts=",
              "--worker_hosts=" + ",".join(f"localhost:{p}" for p in ports),
              "--sync_replicas=false",
              f"--async_sync_period={A['gpt_period']}",
              f"--train_steps={A['gpt_steps']}", "--log_every=1",
              f"--inject_step_delay={A['gpt_pace_s']}:0:1000000000"]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        procs = {t: stack.enter_context(CliProcess(
            "train", "--job_name=worker", f"--task_index={t}", *common,
            f"--metrics_file={os.path.join(tmp, 'async_gpt.jsonl')}"))
            for t in (1, 0)}
        outs = {t: finish(procs[t], 400) for t in (0, 1)}
    wall_s = time.perf_counter() - t0
    L = gpt.mini().num_layers
    local = A["gpt_steps"] - 1
    # A local step: K1, K2a, K2b once a layer, K3 twice a layer and once
    # at the end; an eval forward (the validation at step 0 and the final
    # test, 4 batches each) K1 and K3 as a step's forward.
    forwards = local + 2 * 4
    want = {"flash_attention_fwd": L * forwards,
            "flash_attention_bwd_dq": L * local,
            "flash_attention_bwd_dkv": L * local,
            "layer_norm_fwd": (2 * L + 1) * forwards,
            "quant_matmul": 0, "quant_matmul_nt": 0}
    workers, total = [], {}
    for t in (0, 1):
        lines = outs[t]
        launches = json.loads(line_value(lines,
                                         f"Worker {t}: kernel launches"))
        if launches != want:
            raise AssertionError(f"async_gpt worker {t}: launches "
                                 f"{launches}, expected {want}")
        losses = [float(x.split(" loss ")[1].split()[0]) for x in lines
                  if x.startswith(f"Worker {t}: traing step")]
        if len(losses) != local or not (
                all(map(math.isfinite, losses))
                and statistics.mean(losses[-5:]) < losses[0]):
            raise AssertionError(f"async_gpt worker {t}: losses {losses}")
        metrics = os.path.join(tmp, f"async_gpt.jsonl.task{t}")
        # The CLI worker's own telemetry step (data wait + compute, the
        # card synchronised each step), less the pace.
        nums = trainer_numbers(lines, metrics, t)
        step_ms = nums["step_ms_median"] - A["gpt_pace_s"] * 1e3
        ex = exchange_numbers(lines, metrics, t, nums["train_s"])
        workers.append(dict(
            test_accuracy=nums["test_accuracy"],
            step_ms=step_ms,
            tokens_per_s=T["gpt_batch"] * T["gpt_seq"] / step_ms * 1e3,
            loss_first=losses[0], loss_last5_mean=statistics.mean(losses[-5:]),
            peak_mem_gib=float(line_value(
                lines, f"Worker {t}: peak device memory").split()[0]),
            averaged_lines=sum("averaged parameters with 1 peer(s)" in x
                               for x in lines),
            train_s=nums["train_s"], launches=launches, **ex))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    if not any(w["averaged_lines"] for w in workers):
        raise AssertionError("async_gpt: no 'averaged parameters with 1 "
                             "peer(s)' line: " + "".join(outs[0][-20:]))
    busy = async_gpt_busy(dev)
    torch.cuda.empty_cache()
    emit("async_gpt", card=smi, wall_s=wall_s, batch=T["gpt_batch"],
         seq_len=T["gpt_seq"], local_steps=local, period=A["gpt_period"],
         pace_ms=A["gpt_pace_s"] * 1e3, launches_expected=want,
         step_ms=[w["step_ms"] for w in workers],
         tokens_per_s=[w["tokens_per_s"] for w in workers],
         busy_share_in_process=busy["busy_share"], workers=workers)
    emit("async_gpt_profile", card=smi, **busy)
    return total


def async_exchange(dev, tmp: str, smi: str) -> None:
    """``async_exchange``: the exchange at transformer scale, in this
    process, through the trainer's own functions.  A GPT-406M-width bf16
    model (seeded weights) as one async replica, and a drifted copy of its
    parameters (a tenth of the coordinates moved, as SGD moves them): the
    consensus tree off the card (``host_tree``), two ``ParamAverager``s
    over the logdir side-channel (publish, fetch, average), the consensus
    back onto the card (``adopt_consensus``); then two int8
    ``CompressedShardedAverager``s to their first assembled round, on a
    quarter of the tree cut by depth (``ASYNC["int8_leaves"]``: the
    embeddings and the first two of the eight blocks, widths unchanged),
    with the same gates: the wire cut and the codec's error bound."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.cluster import param_sync as ps
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        CoordinationClient, CoordinationServer)
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.async_replicas import (
        adopt_consensus, host_tree, make_async_state)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState
    from distributed_tensorflow_tpu_torch.utils.pytree import tree_leaves
    A = ASYNC
    torch.manual_seed(SEED)
    model = gpt.GptLM(gpt.GptConfig(**WIDTH), device=dev)
    astate = make_async_state(TrainState.create(
        model, make_optimizer("sgd", 0.0), params_to_tree=gpt.params_to_jax,
        params_from_tree=gpt.params_from_jax), 1)
    del model
    mine = {n: t[0].clone() for n, t in astate.params.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    drifted = {}
    for n, p in mine.items():
        move = torch.rand(p.shape, generator=g, device=dev) < A["drift_share"]
        step = torch.randn(p.shape, generator=g, device=dev) * A["drift_scale"]
        drifted[n] = (p.float() + step * move).to(p.dtype)
    nbytes = sum(t.numel() * t.element_size() for t in mine.values())
    host_tree(astate)          # allocates the state's pinned buffers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree_a = host_tree(astate)
    d2h_s = time.perf_counter() - t0
    tree_b = host_tree(astate, drifted)
    srv = CoordinationServer(port=0, num_tasks=2, heartbeat_timeout=60.0)
    srv.start()
    clients = [CoordinationClient("127.0.0.1", srv.port, task_id=t)
               for t in (0, 1)]
    xdir = os.path.join(tmp, "async_exchange")
    try:
        avg = [ps.ParamAverager(clients[t], t, 2, namespace="plain",
                                exchange_dir=xdir) for t in (0, 1)]
        legs = {"publish": 0.0, "fetch": 0.0}

        def timed(name, fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    legs[name] += time.perf_counter() - t0
            return call
        # Worker 1's exchange as the trainer calls it, its legs timed:
        # publish, fetch of worker 0's file, and the rest (fingerprints,
        # the bf16 mean).
        avg[0].exchange(tree_a)
        if avg[0].last_publish_transport != "binary":
            raise AssertionError("the 406M-width tree did not take the "
                                 "binary side-channel")
        avg[1]._publish = timed("publish", avg[1]._publish)
        avg[1]._fetch_peer = timed("fetch", avg[1]._fetch_peer)
        t0 = time.perf_counter()
        consensus, peers = avg[1].exchange(tree_b)
        exchange_s = time.perf_counter() - t0
        if peers != 1:
            raise AssertionError(f"plain exchange saw {peers} peers")
        publish_s, fetch_s = legs["publish"], legs["fetch"]
        average_s = exchange_s - publish_s - fetch_s
        plain_wire = avg[1].last_bytes_out + avg[1].last_bytes_in
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adopt_consensus(astate, consensus)
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        for n, t in astate.params.items():
            want = ((mine[n].float() + drifted[n].float()) / 2).to(t.dtype)
            if not torch.equal(t[0].view(torch.int16),
                               want.view(torch.int16)):
                raise AssertionError(f"{n}: the adopted consensus is not "
                                     "the fp32 mean cast to bf16 on the card")

        # The int8 compressed exchange of the same two trees' first
        # quarter by depth, to the first assembled round (worker 1's:
        # worker 0 anchors, both publish deltas, each freezes its shard,
        # worker 1 assembles).
        part_a, part_b = ({k: t[k] for k in A["int8_leaves"]}
                          for t in (tree_a, tree_b))
        comp = [ps.CompressedShardedAverager(
            clients[t], t, 2, namespace="int8", exchange_dir=xdir,
            quant="int8") for t in (0, 1)]
        params = [part_a, part_b]
        rounds = []
        t0 = time.perf_counter()
        for _ in range(4):
            for t in (0, 1):
                r0 = time.perf_counter()
                params[t], _ = comp[t].exchange(params[t])
                rounds.append(dict(
                    task=t, ms=(time.perf_counter() - r0) * 1e3,
                    bytes_on_wire=comp[t].last_bytes_out
                    + comp[t].last_bytes_in,
                    rounds_completed=comp[t].rounds_completed,
                    fallbacks=comp[t].fallback_exchanges))
                if comp[t].rounds_completed:
                    break
            if any(c.rounds_completed for c in comp):
                break
        int8_s = time.perf_counter() - t0
        done = [c for c in comp if c.rounds_completed]
        if not done:
            raise AssertionError(f"int8 exchange assembled no round: {rounds}")
        # A round after the bootstrap's anchor (full precision by design):
        # the delta publish, the frozen reduce and the assembly.
        wire = max(r["bytes_on_wire"] for r in rounds
                   if r["rounds_completed"] >= 1)
        part_bytes = sum(x.nbytes for x in tree_leaves(part_a))
        full = 2 * part_bytes           # a full-state publish and fetch
        ratio = full / wire
        if ratio < A["min_wire_ratio"]:
            raise AssertionError(f"int8 round moved {wire} bytes, full "
                                 f"state {full}: ratio {ratio:.2f}")
        # The codec's bound: an int8 quantization errs by at most half a
        # step (its block's absmax / 127 / 2), and the consensus is
        # quantized twice (the delta, then the reduced shard): it lies
        # within one step of the largest delta of the exact mean.
        fa, fb = ps._flatten_f32(part_a), ps._flatten_f32(part_b)
        exact = (fa.astype(np.float64) + fb) / 2
        c = done[0]._consensus
        bound_abs = float(np.abs(fb - fa).max()) / 127 + 1e-6
        err = float(np.abs(c - exact).max())
        if err > bound_abs:
            raise AssertionError(f"int8 consensus off the exact mean by "
                                 f"{err}, bound {bound_abs}")
        plain_err = float(np.abs(ps._flatten_f32(consensus) - (
            ps._flatten_f32(tree_a).astype(np.float64)
            + ps._flatten_f32(tree_b)) / 2).max())
        leaves = len(tree_leaves(tree_a))
    finally:
        for c in clients:
            c.close()
        srv.stop()
    del astate, mine, drifted
    torch.cuda.empty_cache()

    def gbs(seconds):
        return nbytes / seconds / 1e9
    emit("async_exchange", card=smi, tree_bytes=nbytes, leaves=leaves,
         d2h_ms=d2h_s * 1e3, d2h_gb_per_s=gbs(d2h_s),
         publish_ms=publish_s * 1e3, publish_gb_per_s=gbs(publish_s),
         fetch_ms=fetch_s * 1e3, fetch_gb_per_s=gbs(fetch_s),
         average_and_rest_ms=average_s * 1e3,
         average_and_rest_gb_per_s=gbs(average_s),
         exchange_ms=exchange_s * 1e3,
         h2d_adopt_ms=h2d_s * 1e3, h2d_adopt_gb_per_s=gbs(h2d_s),
         plain_wire_bytes=plain_wire, plain_err_vs_exact=plain_err,
         int8_leaves=list(A["int8_leaves"]), int8_tree_bytes=part_bytes,
         int8_wall_ms=int8_s * 1e3, int8_rounds=rounds,
         int8_wire_bytes_per_round=wire, full_state_bytes_per_round=full,
         int8_wire_ratio=ratio, int8_err_vs_exact=err,
         int8_err_bound=bound_abs)


def async_trainer(dev, smi: str) -> dict:
    """Phase ``async_trainer``.  Returns the gpt_mini workers' summed
    kernel launches."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn(dev, tmp, smi)
        seconds[name] = time.perf_counter() - t0
        return out
    try:
        timed("async_reference", async_reference)
        timed("async_overlap", async_overlap)
        launches = timed("async_gpt", async_gpt)
        timed("async_exchange", async_exchange)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("async_trainer", card=smi, seconds=sum(seconds.values()),
         seconds_by_part=seconds)
    return launches


def main() -> int:
    import torch
    args = sys.argv[1:]
    if args not in ([], ["--nccl"]):
        print("usage: chip_smoke.py [--nccl]", file=sys.stderr)
        return 2
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
    if args == ["--nccl"]:
        trainer_nccl(smi)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    t_start = t0 = time.perf_counter()
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
    by_path["fleet"] = fleet_phase(dev, smi, model, whole)
    del model, whole
    torch.cuda.empty_cache()
    by_path["train"], bf16_step = train(dev, smi)
    by_path["train_int8"] = train_int8(dev, smi, bf16_step)
    torch.cuda.empty_cache()
    by_path["train_ring"] = train_ring(dev, smi, bf16_step)
    torch.cuda.empty_cache()
    by_path["trainer"] = trainer(dev, smi)
    by_path["async_trainer"] = async_trainer(dev, smi)
    for row in rows:
        row["launches"] = by_path[row["main"]][row["name"]]
        if row["name"] in by_path["async_trainer"]:
            row["async_trainer_launches"] = \
                by_path["async_trainer"][row["name"]]
        for path, sub in row["paths"].items():
            sub["launches"] = by_path[path][row["name"]]
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
