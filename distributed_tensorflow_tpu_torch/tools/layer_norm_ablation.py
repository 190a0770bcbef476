"""K3's access width and threads per row at the port's LayerNorm shapes:
build variants of ``csrc/layer_norm.cu`` with its register kernel's
``kVec`` (values of x an access) and ``kRowVals`` (values a thread holds
before the row takes more threads) rewritten, and time each in one
process on one card.

    python -m distributed_tensorflow_tpu_torch.tools.layer_norm_ablation

Variants are named ``vec<values an access>_tpr<threads a row>`` at H =
2048; ``vec4_tpr128`` is the kernel as it is.  ``vec8`` is a 16-byte
load of bf16, each thread then writing two 16-byte fp32 vectors 32 bytes
apart; ``vec4`` an 8-byte load and one 16-byte fp32 store, a warp's
stores contiguous.  Shapes: GPT-406M's hidden 2048, bf16, at the decode
step's 8 rows, the longest prefill's 784 and the train step's 8192.
Each variant is held to the plain version, then timed as the device sees
it (``utils.cuda_timing.graph_ms``: launches captured in a CUDA graph and
replayed; the serving shapes' back-to-back calls would time the host
instead).  ``F.layer_norm`` (bf16 weights, bf16 out) is timed the same
way beside them.  One JSON line per shape, times in ms a launch, plus the
card's name and power limit.  Needs ``nvcc`` and one GPU; builds into a
temporary directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import tempfile

import torch
import torch.nn.functional as F

from ..ops import kernels
from ..ops import layer_norm as ln
from ..utils.cuda_timing import graph_ms

H = 2048
SHAPES = {"decode": 8, "prefill": 784, "train": 8192}
# (kVec's definition, kRowVals) -> threads a row at H = 2048: 2048 /
# kRowVals, between 32 and 128.
VEC = {4: "4", 8: "16 / sizeof(T)"}      # 8 for bf16/fp16, 4 for fp32
VARIANTS = [(8, 64), (4, 64), (8, 32), (4, 32), (8, 16), (4, 16)]


def variants(src: str) -> dict:
    rules = {"kVec": r"constexpr int kVec = [^;]+;",
             "kRowVals": r"constexpr int kRowVals = \d+;"}
    for name, rx in rules.items():
        if len(re.findall(rx, src)) != 1:
            raise RuntimeError(f"{name}: the source changed; update the tool")
    out = {}
    for vec, row_vals in VARIANTS:
        text = re.sub(rules["kVec"], f"constexpr int kVec = {VEC[vec]};",
                      src)
        text = re.sub(rules["kRowVals"],
                      f"constexpr int kRowVals = {row_vals};", text)
        out[f"vec{vec}_tpr{min(128, max(32, H // row_vals))}"] = text
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
        fn = lib.dtt_layer_norm_fwd
        fn.argtypes = kernels.SIGNATURES["dtt_layer_norm_fwd"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    dev = torch.device("cuda", torch.cuda.current_device())
    # The variants' entry points launch on the current device: make it
    # the operands' one, as ``kernels.launch`` does for the port's calls.
    with torch.cuda.device(dev):
        run(dev)


def run(dev) -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(kernels.CSRC, "layer_norm.cu")) as f:
        src = f.read()
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 1 + 0.1 * torch.randn(H, generator=g, device=dev)
    bias = 0.1 * torch.randn(H, generator=g, device=dev)
    s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as work:
        libs = build(variants(src), work)
        for shape, rows in SHAPES.items():
            x = torch.randn(rows, H, generator=g, device=dev).to(
                torch.bfloat16)
            out = torch.empty(rows, H, device=dev)
            want = ln.layer_norm_reference(x, scale, bias)
            ms = {}
            for name, fn in libs.items():
                def call(fn=fn):
                    kernels.check(fn(
                        x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), rows, H, 1e-6, 1,
                        torch.cuda.current_stream().cuda_stream),
                        "layer_norm_fwd")
                out.zero_()
                call()
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                if not err <= 1e-4:
                    raise AssertionError(f"{name}: error {err}")
                ms[name] = graph_ms(call)
            ms["F.layer_norm"] = graph_ms(
                lambda: F.layer_norm(x, (H,), s16, b16, 1e-6))
            print(json.dumps({"kernel": "K3", "shape": shape, "rows": rows,
                              "H": H, "dtype": "bfloat16", "ms": ms,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
