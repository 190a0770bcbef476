"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
with :mod:`ctypes`.  No PyTorch header is included (those make a build
take minutes), and the sources compile in parallel (one ``nvcc`` each)
and link into ``libdtt_kernels.so``.

The build runs at first use and is keyed on a hash of the sources and
the flags: ``_build/<hash>/`` beside this package's ``csrc/`` (listed in
``.gitignore``).  A finished build is reused; a half-written one never
is, because the library is renamed into place only after it linked.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception naming the kernel.
Nothing here runs at import time: the CPU tests import every module and
take the kernels' plain versions instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libdtt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures, one per entry point (pointers and the stream as c_void_p:
# a bare Python int would be passed as a 32-bit int and cut the pointer).
SIGNATURES = {
    # q, k, v, kv_mask (int32 [B, S] or NULL), out, lse,
    # B, S, H, D, q/k/v strides (batch, seq, head) in elements,
    # causal, window, scale, dtype (0 = fp32, 1 = bf16), stream
    "dtt_flash_attention_fwd": [_P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                _I, _I, _F, _I, _P],
    # x, scale, bias, out, rows, H, eps, dtype (0 fp32, 1 bf16, 2 fp16),
    # stream
    "dtt_layer_norm_fwd": [_P, _P, _P, _P, _L, _I, _F, _I, _P],
    # Both backward entry points: q, k, v, kv_mask, o, dout, lse, delta,
    # out_a, out_b, B, S, H, D, q/k/v/o/dout strides (batch, seq, head) in
    # elements, causal, window, scale, dtype (0 = fp32, 1 = bf16), stream.
    # dq: writes delta and out_a = dq.  dkv: reads delta, writes
    # out_a = dk and out_b = dv.
    "dtt_flash_attention_bwd_dq": [_P] * 10 + [_I] * 4 + [_L] * 15
                                  + [_I, _I, _F, _I, _P],
    "dtt_flash_attention_bwd_dkv": [_P] * 10 + [_I] * 4 + [_L] * 15
                                   + [_I, _I, _F, _I, _P],
    # K6: q, k, v, kv_mask, m_in, l_in, acc_in, m_out, l_out, acc_out,
    # B, Sq, Sk, H, D, q/k/v strides (batch, seq, head), q_off, k_off,
    # causal, window, scale, dtype, stream.
    "dtt_flash_attention_chunk": [_P] * 10 + [_I] * 5 + [_L] * 9
                                 + [_I] * 4 + [_F, _I, _P],
    # K7a/K7b: q, k, v, kv_mask, dout, lse, delta, out_a, out_b, B, Sq,
    # Sk, H, D, q/k/v/dout strides, q_off, k_off, causal, window, scale,
    # dtype, dkv (0: out_a = dq; 1: out_a = dk, out_b = dv), stream.
    "dtt_flash_attention_chunk_bwd": [_P] * 9 + [_I] * 5 + [_L] * 12
                                     + [_I] * 4 + [_F, _I, _I, _P],
    # K4: x, qw, sw, bias, residual, out, pre (null where unused), M, N,
    # K, bk, x's row stride, gelu, dtype (0 = fp32, 1 = bf16), stream.
    "dtt_quant_matmul": [_P] * 7 + [_I] * 4 + [_L, _I, _I, _P],
    # K5: da, pre (null: "fold"), qw, sf, out, g (null unless want_g), M,
    # N, K, bk, da's and pre's row strides, dtype, stream.
    "dtt_quant_matmul_nt": [_P] * 6 + [_I] * 4 + [_L, _L, _I, _P],
    # K8: da, pre, qwt (K-major [N, K]), sw, out, g (null unless want_g),
    # M, N, K, bk, da's and pre's row strides, dtype, stream.
    "dtt_quant_matmul_dgelu": [_P] * 6 + [_I] * 4 + [_L, _L, _I, _P],
}

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def build() -> str:
    """Compile every ``.cu`` in parallel, link, and return the library
    path (reused when a build of the same sources exists)."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    work = tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT)
    try:
        cus = [s for s in sources() if s.endswith(".cu")]
        procs = []
        for src in cus:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(work, LIB_NAME)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def load():
    """The loaded library with every entry point's ``argtypes`` set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dtt_error_string.argtypes = [_I]
            lib.dtt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error at launch."""
    if rc != 0:
        what = _lib.dtt_error_string(rc).decode() if _lib else "?"
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({what})")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
