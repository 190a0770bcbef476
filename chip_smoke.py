#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: the hand-written CUDA kernels, compiled from ``csrc/``.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes in bf16, with the tolerance stated below,
   its time, the plain version's time, one library call's time (used only
   here, never by the port) and the least time the card could take.
4. ``serve``: a GPT at the widths of the repo's GPT-406M (hidden 2048,
   8 layers, 16 heads, MLP 8192, vocab 256, bf16, random weights from a
   seeded generator) behind ``ServingServer``; 8 concurrent HTTP requests
   from two tenants (prompts of 100-777 tokens, 64 new tokens each, greedy
   and seeded-sampled) through ``ServeClient``.  The kernels' launch
   counters are set to 0 just before and read just after.  Before it, the
   ``profile`` line: ``torch.profiler`` over one more request, the card's
   busy share of it and the kernels that took its device time.

Then the card's name and power limit, the kernels' summary object, and
last ``{"ok": true, "device": {...}}``.  Any failing phase raises: the
script exits non-zero and prints no result.  Without CUDA it exits 2.
"""

from __future__ import annotations

import dataclasses
import json
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
# Whole model, bf16: prefill logits through both kernels against the
# plain path (dense attention, plain LayerNorm) with the same weights.
# Per-layer differences of a bf16 ulp in the attention output carry
# through 8 residual layers to logits of magnitude ~1.
MODEL_LOGIT_TOL = 0.1

# Published H100 SXM peaks (dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

WIDTH = dict(vocab_size=256, hidden_size=2048, num_layers=8, num_heads=16,
             intermediate_size=8192, max_position=1024, dtype="bfloat16",
             attention_backend="pallas", fused_ln=True)
ENGINE = dict(num_slots=8, page_size=16, num_pages=512,
              max_pages_per_seq=64)
PROMPT_LENS = (100, 777, 250, 512, 640, 333, 700, 128)
NEW_TOKENS = 64
SEED = 0


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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the path's
    shapes; returns the summary rows (launches filled in later)."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
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
    k1_cases, k1_err = [], 0.0
    for name, B, mask, window in cases:
        q, k, v = qkv(B)
        out, lse = fa.flash_attention(q, k, v, mask, causal=True,
                                      window=window)
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, mask, causal=True, window=window)
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
        valid = attention_valid(B, S, mask, causal=True, window=window,
                                device=dev)
        pairs = valid.sum().item() * H
        bytes_moved = 4 * B * S * H * D * 2 + B * H * S * 4 + (
            0 if mask is None else B * S * 4)
        b_ms, b_by = bound(bytes_moved, 4 * D * pairs)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if name == "causal":
            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
        else:
            def lib(m=valid):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=m)
        row = dict(case=name, B=B, S=S, H=H, D=D, window=window,
                   max_abs_err=err, tol=K1_OUT_TOL, lse_err=lse_err,
                   lse_tol=K1_LSE_TOL,
                   ms=cuda_ms(lambda: fa.flash_attention(
                       q, k, v, mask, causal=True, window=window)),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                       q, k, v, mask, causal=True, window=window)),
                   library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by)
        k1_cases.append(row)
        k1_err = max(k1_err, err)

    k3_cases, k3_err = [], 0.0
    Hd = WIDTH["hidden_size"]
    for name, rows in (("prefill", S), ("decode", ENGINE["num_slots"])):
        x = torch.randn(rows, Hd, generator=g, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(Hd, generator=g, device=dev)
        bias = 0.1 * torch.randn(Hd, generator=g, device=dev)
        out = ln.layer_norm(x, scale, bias)
        ref = ln.layer_norm_reference(x, scale, bias)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (out.dtype == torch.float32 and err <= K3_TOL):
            raise AssertionError(f"K3 {name}: max_abs_err {err} (tol "
                                 f"{K3_TOL}), dtype {out.dtype}")
        s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        b_ms, b_by = bound(rows * Hd * (2 + 4) + 2 * Hd * 4, 8 * rows * Hd)
        k3_cases.append(dict(
            case=name, rows=rows, H=Hd, max_abs_err=err, tol=K3_TOL,
            ms=cuda_ms(lambda: ln.layer_norm(x, scale, bias)),
            plain_ms=cuda_ms(lambda: ln.layer_norm_reference(
                x, scale, bias)),
            # bf16 weights: F.layer_norm's one-call form writes bf16.
            library_ms=cuda_ms(lambda: F.layer_norm(x, (Hd,), s16, b16,
                                                    1e-6)),
            bound_ms=b_ms, bound_by=b_by))
        k3_err = max(k3_err, err)
    emit("kernels", flash_attention_fwd=k1_cases, layer_norm_fwd=k3_cases)

    def summary(name, source, replaces, cases, err):
        main = cases[0]
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=0, max_abs_err=err,
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"])
    return [
        summary("flash_attention_fwd",
                "distributed_tensorflow_tpu_torch/csrc/flash_attention.cu",
                "distributed_tensorflow_tpu/ops/pallas/flash_attention.py"
                ":119", k1_cases, k1_err),
        summary("layer_norm_fwd",
                "distributed_tensorflow_tpu_torch/csrc/layer_norm.cu",
                "distributed_tensorflow_tpu/ops/pallas/layer_norm.py:38",
                k3_cases, k3_err),
    ]


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
    launches = serve(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
