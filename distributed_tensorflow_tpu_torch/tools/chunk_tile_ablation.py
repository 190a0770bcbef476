"""The ring chunk kernels' tiles at the ring's per-hop shape: build
variants of ``csrc/flash_attention_chunk.cu`` with other tile constants
and time each in one process on one card.

    python -m distributed_tensorflow_tpu_torch.tools.chunk_tile_ablation \\
        [--kernel k6|k7|all]

K6 variants are named ``c<consumers>_bk<K/V rows>_s<stages>`` (consumer
warpgroups of 64 Q rows, K/V tile rows, stages); ``c2_bk64_s2`` is the
kernel as it is.  K7 variants are named ``c<consumers>_s<stages>`` and set
both K7a's and K7b's own tile (consumer warpgroups of 64 own rows) and
their stages of 64-row streamed tiles (one consumer: two blocks an SM);
``c1_s2`` is the kernels as they are.  Each variant is held to the plain version on the visible hop before
it is timed.  The shape is the ring train step's (q, k, v shards
[8, 256, 16, 128] bf16, views of one fused projection), in the form the
ring calls each kernel (K6 updating fp32 carries in place, K7a and K7b
adding into fp32 sums), for a chunk wholly visible, on the diagonal and
wholly in the future, and the mean per launch over a step's hops (6
visible, 4 diagonal, 6 future of 16).  One JSON line per variant and
kernel, times in ms a launch as the device sees it
(``utils.cuda_timing.graph_ms``: launches captured in a CUDA graph and
replayed, so the host's cost of a call, the same for every variant, does
not hide the device's; variants in turn, then again in reverse order),
plus the card's name and power limit.  Needs ``nvcc`` and one GPU;
builds into a temporary directory.
"""

from __future__ import annotations

import argparse
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
K6_NAMES = ("kFwdConsumers", "kFwdBK", "kFwdStages")
K6_VARIANTS = [(2, 128, 2), (2, 64, 2), (2, 64, 3), (1, 128, 2), (1, 64, 2)]
K7_NAMES = ("kDqConsumers", "kDqStages", "kDkvConsumers", "kDkvStages")
K7_VARIANTS = [(2, 2), (2, 3), (1, 2), (1, 3)]
B, S, H, D, N = 8, 1024, 16, 128, 256


def rewrite(src: str, values: dict) -> str:
    for name, val in values.items():
        pattern = rf"constexpr int {name} = \d+;"
        if len(re.findall(pattern, src)) != 1:
            raise RuntimeError(f"{name}: the source changed; update the tool")
        src = re.sub(pattern, f"constexpr int {name} = {val};", src)
    return src


def variants(src: str, kernel: str) -> dict:
    if kernel == "k6":
        return {f"k6_c{c}_bk{bk}_s{st}": rewrite(src, dict(zip(
            K6_NAMES, (c, bk, st)))) for c, bk, st in K6_VARIANTS}
    return {f"k7_c{c}_s{st}": rewrite(src, dict(zip(K7_NAMES, (c, st) * 2)))
            for c, st in K7_VARIANTS}


def build(srcs: dict, work: str) -> dict:
    """Every variant's library, compiled in parallel: name -> CDLL."""
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
        for entry in ("dtt_flash_attention_chunk",
                      "dtt_flash_attention_chunk_bwd"):
            fn = getattr(lib, entry)
            fn.argtypes = kernels.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k6", "k7", "all"), default="all")
    kernel = ap.parse_args().kernel
    kinds = ("k6", "k7") if kernel == "all" else (kernel,)
    dev = torch.device("cuda", torch.cuda.current_device())
    # The variants' entry points launch on the current device: make it
    # the operands' one, as ``kernels.launch`` does for the port's calls.
    with torch.cuda.device(dev):
        run(dev, kinds)


def run(dev, kinds) -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(kernels.CSRC, "flash_attention_chunk.cu")) as f:
        src = f.read()
    g = torch.Generator(device=dev).manual_seed(0)
    fused = torch.randn(B, S, 3, H, D, generator=g, device=dev).to(
        torch.bfloat16)
    do_all = torch.randn(B, S, H, D, generator=g, device=dev).to(
        torch.bfloat16)
    m = torch.randn(B, H, N, generator=g, device=dev)
    l = 1 + torch.rand(B, H, N, generator=g, device=dev)
    acc = torch.randn(B, H, N, D, generator=g, device=dev)
    lse = m + torch.log(l)
    delta = torch.randn(B, H, N, generator=g, device=dev)
    sums = torch.randn(3, B, H, N, D, generator=g, device=dev)

    def stream():
        # Read at each call: a CUDA graph captures on its own stream.
        return torch.cuda.current_stream().cuda_stream

    def operands(q_off, k_off):
        return (fused[:, q_off:q_off + N, 0], fused[:, k_off:k_off + N, 1],
                fused[:, k_off:k_off + N, 2], do_all[:, q_off:q_off + N])

    def k6(lib, q_off, k_off, carries):
        q, k, v, _ = operands(q_off, k_off)
        ptrs = [t.data_ptr() for t in carries]
        kernels.check(lib.dtt_flash_attention_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, *ptrs, *ptrs,
            B, N, N, H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], q_off, k_off, 1, 0, 1.0 / math.sqrt(D), 1,
            stream()), "flash_attention_chunk")

    def k7(lib, dkv, q_off, k_off, outs):
        q, k, v, do = operands(q_off, k_off)
        kernels.check(lib.dtt_flash_attention_chunk_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), outs[0].data_ptr(),
            outs[-1].data_ptr(), B, N, N, H, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], q_off,
            k_off, 1, 0, 1.0 / math.sqrt(D), 1, int(dkv), 1, stream()),
            "flash_attention_chunk_bwd")

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    q_off, k_off, _ = HOPS["visible"]
    q, k, v, do = operands(q_off, k_off)
    want6 = fa.flash_attention_chunk_reference(q, k, v, None, m, l, acc,
                                               q_offset=q_off,
                                               k_offset=k_off, causal=True)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=True)
    want7 = (fa.flash_attention_chunk_dq_reference(q, k, v, None, do, lse,
                                                   delta, **kw),
             *fa.flash_attention_chunk_dkv_reference(q, k, v, None, do, lse,
                                                     delta, **kw))
    # The ring's calls: K6 on its carries, K7a on the dq sum, K7b on the
    # dk and dv sums.
    calls = {"k6": {"K6": lambda lib, qo, ko, t: k6(lib, qo, ko, t[:3])},
             "k7": {"K7a": lambda lib, qo, ko, t: k7(lib, False, qo, ko,
                                                     t[:1]),
                    "K7b": lambda lib, qo, ko, t: k7(lib, True, qo, ko,
                                                     t[1:])}}
    state = {"k6": (m, l, acc), "k7": tuple(sums)}

    with tempfile.TemporaryDirectory() as work:
        srcs = {}
        for kind in kinds:
            srcs.update(variants(src, kind))
        libs = build(srcs, work)
        for name, lib in libs.items():
            kind = name[:2]
            got = [t.clone() for t in state[kind]]
            for call in calls[kind].values():
                call(lib, q_off, k_off, got)
            torch.cuda.synchronize()
            if kind == "k6":
                errs = [rel(got[2], want6[2])]
            else:
                errs = [rel(a - b, w) for a, b, w in zip(got, sums, want7)]
            if not max(errs) <= 1e-2:
                raise AssertionError(f"{name}: relative errors {errs}")
        times = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                kind = name[:2]
                for kernel, call in calls[kind].items():
                    for hop, (qo, ko, _) in HOPS.items():
                        bufs = [t.clone() for t in state[kind]]
                        times.setdefault((name, kernel), {}).setdefault(
                            hop, []).append(graph_ms(
                                lambda: call(libs[name], qo, ko, bufs)))
        for (name, kernel), by_hop in times.items():
            ms = {hop: sum(t) / len(t) for hop, t in by_hop.items()}
            mean = sum(HOPS[h][2] * ms[h] for h in HOPS) / sum(
                w for _, _, w in HOPS.values())
            print(json.dumps({"kernel": kernel, "variant": name[3:],
                              "shape": [B, N, H, D], "ms": ms,
                              "hop_mean_ms": mean, "runs": by_hop,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
