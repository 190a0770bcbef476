"""Where K4/K5's time goes: kernel A (the quantize pass) and kernel B (the
block-scaled int8 GEMM) of ``csrc/quant_gemm.cu`` timed apart, and B
rebuilt with other tile widths and stage counts, at the int8 MLP's four
call sites.

    python -m distributed_tensorflow_tpu_torch.tools.quant_matmul_ablation

Variants of B (``bn<BN>_s<stages>``: the source's ``kGemmBN`` and
``kGemmStages`` rewritten; every block is 128 rows, two consumer
warpgroups of 64): 128 x 128 and 128 x 192 output tiles, 3 and 4 TMA
stages, each with the epilogue staged through shared memory, and
``bn128_s4_direct``, the outputs stored two columns a thread straight
from the registers (``kGemmStagedStore`` false).  Each is compiled from
the source alone into its own library (one ``nvcc`` each, in parallel)
and called through its C entry point on the same codes, scales and
weight; its output is held bit for bit to the port's B where no tanh
enters (the mlp_in forward's gelu output is not compared, its
pre-activation is).

Sites: M = 8192 rows (B=8 x S=1024) of GPT-406M's MLP, in bf16: K4 at
mlp_in (K 2048 -> N 8192, K-block 512, bias + gelu + pre-activation) and
mlp_out (8192 -> 2048, 1024, bias), K5 at the mlp_out dgrad (2048 ->
8192, 1024, fold) and the mlp_in dgrad (8192 -> 2048, 512, gelu' + fold +
g).  One JSON line per site: the whole K4/K5 call (the port's wrapper),
A alone, the weight transpose (K4: the kernel and ``w.t().contiguous()``),
each B variant, ``torch._int_mm`` on the same int8 operands
(K-major weight) and the bf16 GEMM of the same shape, in ms (CUDA events
over back-to-back calls, each variant timed twice in turns), B's TOP/s,
the bounds, and the card's name and power limit.  Needs ``nvcc`` and one
GPU; builds into a temporary directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import torch

from ..ops import kernels
from ..ops import quant_matmul as qmm

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# (BN, stages, staged epilogue): the source's kGemmBN, kGemmStages and
# kGemmStagedStore.
VARIANTS = [(128, 4, True), (128, 3, True), (192, 4, True), (192, 3, True),
            (128, 4, False)]
# (kernel, site, K, N, bk, variant): the int8 train step's four calls.
SITES = [("K4", "mlp_in", 2048, 8192, 512, "bias_gelu_preact"),
         ("K4", "mlp_out", 8192, 2048, 1024, "bias"),
         ("K5", "mlp_out_dgrad", 2048, 8192, 1024, "fold"),
         ("K5", "mlp_in_dgrad", 8192, 2048, 512, "dgelu_fold_want_g")]
M = 8192


def variants(src: str) -> dict:
    out = {}
    for bn, stages, staged in VARIANTS:
        text = src
        for old, new in (("constexpr int kGemmBN = 128;",
                          f"constexpr int kGemmBN = {bn};"),
                         ("constexpr int kGemmStages = 4;",
                          f"constexpr int kGemmStages = {stages};"),
                         ("constexpr bool kGemmStagedStore = true;",
                          "constexpr bool kGemmStagedStore = "
                          f"{'true' if staged else 'false'};")):
            if text.count(old) != 1:
                raise RuntimeError(f"the source changed: {old!r}")
            text = text.replace(old, new)
        out[f"bn{bn}_s{stages}" + ("" if staged else "_direct")] = text
    return out


def build(srcs: dict, work: str) -> dict:
    nvcc = kernels._nvcc()
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-shared",
             "-o", os.path.join(work, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(work, f"{name}.so"))
        lib.dtt_quant_gemm.argtypes = kernels.SIGNATURES["dtt_quant_gemm"]
        lib.dtt_quant_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, min_ms: float = 25.0) -> float:
    """Mean ms per call over back-to-back calls spanning ``min_ms``."""
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

    est = window(3) / 3
    reps = int(min(2000, max(10, min_ms / max(est, 1e-3))))
    return window(reps) / reps


def main() -> None:
    dev = torch.device("cuda", torch.cuda.current_device())
    # The variants' entry points launch on the current device: make it
    # the operands' one, as ``kernels.launch`` does for the port's calls.
    with torch.cuda.device(dev):
        run(dev)


def site_inputs(g, dev, kind, K, N, bk, variant):
    """The call's inputs, and kernel A's and kernel B's arguments."""
    bf = torch.bfloat16
    a = torch.randn(M, K, generator=g, device=dev).to(bf)
    if kind == "K4":
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(K, N, generator=g, device=dev))
        bias = 0.1 * torch.randn(N, generator=g, device=dev)
        gelu = variant == "bias_gelu_preact"
        call = dict(fn=qmm.quantized_matmul, args=(a, qw, sw, bias),
                    kw=dict(block_k=bk, activation="gelu" if gelu else None,
                            want_preact=gelu))
        stage_a = dict(pre=None, sf=None, want_g=False)
        w = qmm.transpose_s8(qw)
        epilogue = dict(sw=sw.reshape(-1).contiguous(), bias=bias,
                        gelu=gelu, preact=gelu)
    else:
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(N, K, generator=g, device=dev))
        pre = None
        kw = dict(block_k=bk)
        if variant != "fold":
            pre = (2 * torch.randn(M, K, generator=g, device=dev)).to(bf)
            kw.update(prologue="dgelu_fold", want_g=True)
        call = dict(fn=qmm.quantized_matmul_nt, args=(a, qw, sw, pre),
                    kw=kw)
        stage_a = dict(pre=pre, sf=sw, want_g=pre is not None)
        w = qw
        epilogue = dict(sw=None, bias=None, gelu=False, preact=False)
    return a, call, stage_a, w, epilogue


def run(dev) -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(kernels.CSRC, "quant_gemm.cu")) as f:
        src = f.read()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as work:
        libs = build(variants(src), work)
        for kind, site, K, N, bk, variant in SITES:
            a, call, sa, w, ep = site_inputs(g, dev, kind, K, N, bk, variant)
            q, sx, _ = qmm.quantize_blocks(a, bk, sa["pre"], sa["sf"],
                                           want_g=sa["want_g"])
            out = torch.empty(M, N, device=dev, dtype=a.dtype)
            pre = torch.empty_like(out) if ep["preact"] else None
            ref = qmm.blocked_gemm(q, sx, w, bk, ep["sw"], ep["bias"],
                                   activation="gelu" if ep["gelu"] else None,
                                   want_preact=ep["preact"],
                                   out_dtype=a.dtype)
            ref = ref if isinstance(ref, tuple) else (ref,)

            def gemm(lib):
                rc = lib.dtt_quant_gemm(
                    q.data_ptr(), sx.data_ptr(), w.data_ptr(),
                    None if ep["sw"] is None else ep["sw"].data_ptr(),
                    None if ep["bias"] is None else ep["bias"].data_ptr(),
                    None, out.data_ptr(),
                    None if pre is None else pre.data_ptr(), M, N, K, bk,
                    int(ep["gelu"]), 1, stream)
                if rc:
                    raise RuntimeError(f"dtt_quant_gemm: CUDA error {rc}")

            for name, lib in libs.items():
                gemm(lib)
                torch.cuda.synchronize()
                # Same bits as the port's B (the gelu output aside).
                got = pre if ep["gelu"] else out
                if not torch.equal(got, ref[1] if ep["gelu"] else ref[0]):
                    raise AssertionError(f"{site} {name}: output differs")
            ms = {f"b_{n}": [] for n in libs}
            order = list(libs) + list(reversed(libs))
            for name in order:
                ms[f"b_{name}"].append(cuda_ms(lambda: gemm(libs[name])))
            ms = {k: sum(v) / len(v) for k, v in ms.items()}
            ms["call"] = cuda_ms(lambda: call["fn"](*call["args"],
                                                    **call["kw"]))
            ms["a"] = cuda_ms(lambda: qmm.quantize_blocks(
                a, bk, sa["pre"], sa["sf"], want_g=sa["want_g"]))
            if kind == "K4":
                qw = call["args"][1]
                ms["transpose_s8"] = cuda_ms(lambda: qmm.transpose_s8(qw))
                ms["transpose_plain"] = cuda_ms(lambda: qw.t().contiguous())
            w_kn = w.t()                       # [K, N], K-contiguous
            ms["int_mm"] = cuda_ms(lambda: torch._int_mm(q, w_kn))
            w16 = torch.randn(K, N, generator=g, device=dev).to(a.dtype)
            ms["bf16_gemm"] = cuda_ms(lambda: torch.matmul(a, w16))
            ops = 2 * M * K * N
            esize = a.element_size()
            a_bytes = (M * K * esize * (1 if sa["pre"] is None else 2)
                       + M * K + (M * K * esize if sa["want_g"] else 0))
            print(json.dumps({
                "kernel": kind, "site": site, "variant": variant, "M": M,
                "K": K, "N": N, "block_k": bk, "ms": ms,
                "b_tops": {k[2:]: ops / (v * 1e-3) / 1e12
                           for k, v in ms.items() if k.startswith("b_")},
                "a_bound_ms": a_bytes / PEAK_BYTES * 1e3,
                "b_bound_ms": ops / PEAK_INT8_OPS * 1e3, "card": card}),
                flush=True)
            del a, call, q, sx, w, out, pre, ref, w16
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
