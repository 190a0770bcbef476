"""Where K4/K5's time goes: build variants of ``csrc/quant_matmul.cu``
with one part removed and time each at the int8 MLP's shapes.

    python -m distributed_tensorflow_tpu_torch.tools.quant_matmul_ablation

Variants (the outputs of all but ``full`` are meaningless; only times
are read):

- ``full``: the kernel as it is;
- ``no_mma``: without the K-block's weight stages and int8 products (the
  prologue, the cluster barriers and the epilogue remain);
- ``no_prologue``: without the activation quantize (no row is read or
  quantized, the products run on whatever the shared slab holds);
- ``cluster_<n>``: the full kernel with at most ``n`` blocks sharing a
  quantized slab (1: every block quantizes its own).

Shapes: M = 8192 rows (B=8 x S=1024) of GPT-406M's MLP, K4 at mlp_in (K
2048 -> N 8192, K-block 512) and mlp_out (8192 -> 2048, 1024), K5 "fold"
at both dgrads, each beside the bf16 GEMM of the same M, K, N.  One JSON
line per call site, times in ms (CUDA events over 10 calls after a
warm-up), plus the card's name and power limit.  Needs ``nvcc`` and one
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


def variants(src: str) -> dict:
    cuts = {"no_mma": ("for (int ks = 0; ks < steps; ++ks) {",
                       "for (int ks = 0; ks < 0; ++ks) {"),
            "no_prologue": ("for (int r = crank * rows_per + warp;",
                            "for (int r = BM + warp;")}
    out = {"full": src}
    for name, (old, new) in cuts.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source changed; update the cut")
        out[name] = src.replace(old, new)
    old = "constexpr int kMaxCluster = 8;"
    if src.count(old) != 1:
        raise RuntimeError("cluster size: the source changed")
    for n in (1, 2, 4):
        out[f"cluster_{n}"] = src.replace(
            old, f"constexpr int kMaxCluster = {n};")
    return out


def build(srcs: dict, work: str) -> dict:
    nvcc = kernels._nvcc()
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o",
             os.path.join(work, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(work, f"{name}.so"))
        for fn in ("dtt_quant_matmul", "dtt_quant_matmul_nt"):
            getattr(lib, fn).argtypes = kernels.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(kernels.CSRC, "quant_matmul.cu")) as f:
        src = f.read()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    M = 8192
    with tempfile.TemporaryDirectory() as work:
        libs = build(variants(src), work)
        for K, N, bk in ((2048, 8192, 512), (8192, 2048, 1024)):
            bf = torch.bfloat16
            x = torch.randn(M, K, generator=g, device=dev).to(bf)
            qw, sw = qmm.quantize_cols(
                0.02 * torch.randn(K, N, generator=g, device=dev))
            qwt = qw.t().contiguous()
            bias = torch.randn(N, generator=g, device=dev)
            out = torch.empty(M, N, device=dev, dtype=bf)
            pre = torch.empty_like(out)
            w16 = torch.randn(K, N, generator=g, device=dev).to(bf)
            k4 = {name: cuda_ms(lambda lib=lib: lib.dtt_quant_matmul(
                x.data_ptr(), qwt.data_ptr(), sw.data_ptr(),
                bias.data_ptr(), None, out.data_ptr(), pre.data_ptr(), M, N,
                K, bk, K, 1, 1, stream)) for name, lib in libs.items()}
            k4["bf16_gemm"] = cuda_ms(lambda: torch.matmul(x, w16))
            print(json.dumps({"kernel": "K4", "M": M, "K": K, "N": N,
                              "block_k": bk, "ms": k4, "card": card}),
                  flush=True)
            # The dgrad of the same layer: da [M, N] against qw [K, N]
            # contracted over N, the "fold" prologue.
            da = torch.randn(M, N, generator=g, device=dev).to(bf)
            dx = torch.empty(M, K, device=dev, dtype=bf)
            bk_nt = qmm._pick(N, 1024 if N == 2048 else 512)
            k5 = {name: cuda_ms(lambda lib=lib: lib.dtt_quant_matmul_nt(
                da.data_ptr(), None, qw.data_ptr(), sw.data_ptr(),
                dx.data_ptr(), None, M, K, N, bk_nt, N, 0, 1, stream))
                for name, lib in libs.items()}
            k5["bf16_gemm"] = cuda_ms(lambda: torch.matmul(da, w16.t()))
            print(json.dumps({"kernel": "K5", "M": M, "K": N, "N": K,
                              "block_k": bk_nt, "ms": k5, "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
