"""K6's tiles at the ring's per-hop shape: build variants of
``csrc/flash_attention_chunk.cu`` with another Q tile (consumer
warpgroups of 64 rows), K/V tile or stage count, and time each in one
process on one card.

    python -m distributed_tensorflow_tpu_torch.tools.chunk_tile_ablation

Variants are named ``c<consumers>_bk<K/V rows>_s<stages>``;
``c2_bk64_s2`` is the kernel as it is.  Each is held to the plain
version on the visible hop before it is timed.  The shape is the ring
train step's (q, k, v shards [8, 256, 16, 128] bf16, views of one fused
projection; fp32 carries updated in place, as the ring calls K6), for a
chunk wholly visible, on the diagonal and wholly in the future, and the
mean per launch over a step's hops (6 visible, 4 diagonal, 6 future of
16).  One JSON line per variant, times in ms a launch as the device
sees it (``utils.cuda_timing.graph_ms``: launches captured in a CUDA
graph and replayed, so the host's cost of a call, the same for every
variant, does not hide the device's; variants in turn, then again in
reverse order), plus the card's name and power limit.  Needs ``nvcc``
and one GPU; builds into a temporary directory.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import tempfile

import torch

from ..ops import flash_attention as fa
from ..ops import kernels
from ..utils.cuda_timing import graph_ms

HOPS = {"visible": (768, 0, 6), "diagonal": (512, 512, 4),
        "future": (0, 768, 6)}       # q_offset, k_offset, hops a step
VARIANTS = [(2, 128, 2), (2, 64, 2), (2, 64, 3), (1, 128, 2), (1, 64, 2)]


def variants(src: str) -> dict:
    names = ("kFwdConsumers", "kFwdBK", "kFwdStages")
    for name in names:
        if len(re.findall(rf"constexpr int {name} = \d+;", src)) != 1:
            raise RuntimeError(f"{name}: the source changed; update the tool")
    out = {}
    for c, bk, st in VARIANTS:
        text = src
        for name, val in zip(names, (c, bk, st)):
            text = re.sub(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {val};", text)
        out[f"c{c}_bk{bk}_s{st}"] = text
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
        fn = lib.dtt_flash_attention_chunk
        fn.argtypes = kernels.SIGNATURES["dtt_flash_attention_chunk"]
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
    with open(os.path.join(kernels.CSRC, "flash_attention_chunk.cu")) as f:
        src = f.read()
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, H, D, n = 8, 1024, 16, 128, 256
    fused = torch.randn(B, S, 3, H, D, generator=g, device=dev).to(
        torch.bfloat16)
    m = torch.randn(B, H, n, generator=g, device=dev)
    l = 1 + torch.rand(B, H, n, generator=g, device=dev)
    acc = torch.randn(B, H, n, D, generator=g, device=dev)

    def call(fn, q_off, k_off, carries):
        q = fused[:, q_off:q_off + n, 0]
        k, v = fused[:, k_off:k_off + n, 1], fused[:, k_off:k_off + n, 2]
        mc, lc, ac = carries
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                mc.data_ptr(), lc.data_ptr(), ac.data_ptr(), mc.data_ptr(),
                lc.data_ptr(), ac.data_ptr(), B, n, n, H, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], q_off,
                k_off, 1, 0, 1.0 / math.sqrt(D), 1,
                torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "flash_attention_chunk")

    with tempfile.TemporaryDirectory() as work:
        libs = build(variants(src), work)
        q_off, k_off, _ = HOPS["visible"]
        want = fa.flash_attention_chunk_reference(
            fused[:, q_off:q_off + n, 0], fused[:, k_off:k_off + n, 1],
            fused[:, k_off:k_off + n, 2], None, m, l, acc, q_offset=q_off,
            k_offset=k_off, causal=True)
        for name, fn in libs.items():
            got = [t.clone() for t in (m, l, acc)]
            call(fn, q_off, k_off, got)
            torch.cuda.synchronize()
            err = ((got[2] - want[2]).abs().max()
                   / want[2].abs().max()).item()
            if not err <= 1e-2:
                raise AssertionError(f"{name}: acc relative error {err}")
        times = {name: {} for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                for hop, (q_off, k_off, _) in HOPS.items():
                    carries = [t.clone() for t in (m, l, acc)]
                    times[name].setdefault(hop, []).append(graph_ms(
                        lambda: call(libs[name], q_off, k_off, carries)))
        for name, by_hop in times.items():
            ms = {hop: sum(t) / len(t) for hop, t in by_hop.items()}
            mean = sum(HOPS[h][2] * ms[h] for h in HOPS) / sum(
                w for _, _, w in HOPS.values())
            print(json.dumps({"kernel": "K6", "variant": name,
                              "shape": [B, n, H, D], "ms": ms,
                              "hop_mean_ms": mean, "runs": by_hop,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
