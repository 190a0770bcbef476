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

Every wrapper calls its C entry point through :func:`launch`, which
enters the operands' device first; every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` turns a
non-zero code into an exception naming the kernel.
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
# ptxas's per-kernel report (registers, spills, static shared memory),
# kept beside the library as ``<source>.log``: see :func:`ptxas_report`.
COMPILE_FLAGS = ["-Xptxas", "-v"]

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
    # dtype, dkv (0: out_a = dq; 1: out_a = dk, out_b = dv), accumulate
    # (0: write the partials; 1: add them to what out_a/out_b hold),
    # stream.
    "dtt_flash_attention_chunk_bwd": [_P] * 9 + [_I] * 5 + [_L] * 12
                                     + [_I] * 4 + [_F, _I, _I, _I, _P],
    # K4/K5/K8 kernel A, the quantize pass: a, pre (null: no gelu'), sf
    # (null: no fold), q, sx, g (null unless want_g), M, K, bk, a's and
    # pre's row strides, dtype (0 = fp32, 1 = bf16), stream.
    "dtt_quant_blocks": [_P] * 6 + [_I] * 3 + [_L, _L, _I, _P],
    # K4/K5/K8 kernel B, the block-scaled GEMM: q, sx, w (K-major), sw (null:
    # K5's bare cast), bias, residual, out, pre (null where unused), M, N,
    # K, bk, gelu, dtype, stream.
    "dtt_quant_gemm": [_P] * 8 + [_I] * 6 + [_P],
    # K4's and K8's weight transpose: in [R, C] int8, out [C, R], R, C,
    # stream.
    "dtt_transpose_s8": [_P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
_entries: dict = {}     # entry point name -> bound function, once loaded


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
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
            cmd = [nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-I", CSRC, "-c", src,
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, logs = [], {}
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs[os.path.basename(src) + ".log"] = out
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
        for name, text in logs.items():
            with open(os.path.join(out_dir, name), "w") as f:
                f.write(text)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def ptxas_report(pattern: str) -> list[dict]:
    """ptxas's lines for every kernel of the built library whose mangled
    name contains ``pattern``: registers, spill bytes (stores, loads),
    stack and static shared memory (dynamic shared memory is the
    launcher's and not in it)."""
    import re
    out_dir = os.path.dirname(build())
    rows, cur = [], None
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".log"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            for line in f:
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    cur = (dict(kernel=m.group(1), source=name[:-4],
                                stack_bytes=0, spill_stores=0,
                                spill_loads=0, smem_static=0)
                           if pattern in m.group(1) else None)
                    if cur:
                        rows.append(cur)
                    continue
                m = re.search(r"Function properties for (\S+)", line)
                if m and cur is not None and m.group(1) != cur["kernel"]:
                    cur = None         # a device function's properties
                if cur is None:
                    continue
                for key, rx in (("registers", r"Used (\d+) registers"),
                                ("stack_bytes", r"(\d+) bytes stack frame"),
                                ("spill_stores", r"(\d+) bytes spill stores"),
                                ("spill_loads", r"(\d+) bytes spill loads"),
                                ("smem_static", r"(\d+) bytes smem")):
                    m = re.search(rx, line)
                    if m:
                        cur[key] = int(m.group(1))
    return rows


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
                _entries[name[len("dtt_"):]] = fn
            lib.dtt_error_string.argtypes = [_I]
            lib.dtt_error_string.restype = ctypes.c_char_p
            for name, argtypes in (
                    ("dtt_flash_attention_fwd_smem", [_I]),
                    ("dtt_flash_attention_bwd_smem", [_I]),
                    ("dtt_flash_attention_chunk_smem", [_I]),
                    ("dtt_flash_attention_chunk_bwd_smem", [_I, _I]),
                    ("dtt_quant_gemm_smem", [])):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_longlong
            _lib = lib
    return _lib


def launch_counts() -> dict:
    """Every wrapper's launch counter in this process, by kernel name
    (each wrapper adds one where it launches its kernel, and nowhere
    else; a CPU tensor takes the plain version and counts nothing)."""
    from .. import flash_attention as fa
    from .. import layer_norm as ln
    from .. import quant_matmul as qmm
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


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error at launch."""
    if rc != 0:
        what = _lib.dtt_error_string(rc).decode() if _lib else "?"
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({what})")


def launch(entry: str, device, *args) -> None:
    """Call the C entry point ``dtt_<entry>(*args, stream)`` on
    ``device``, the operands' card, so that the launch, its per-device
    shared-memory opt-in and the stream (``device``'s current one) all
    belong to that card, whichever card is current outside: when
    ``device`` is not the current card the call runs inside
    ``torch.cuda.device(device)``.  Raises on a launch error.  The bound
    function is looked up once per entry point and the stream read as a
    raw handle: at the serving shapes this host path is the kernels'
    whole cost."""
    import torch
    fn = _entries.get(entry) or getattr(load(), f"dtt_{entry}")
    idx = device.index
    # torch._C's bindings behind torch.cuda.current_device() and
    # torch.cuda.current_stream(idx).cuda_stream, without the public
    # calls' lazy-init check and Stream object (PyTorch 2.11 on the H100;
    # tests/test_torch_kernels_cuda.py holds them to the public calls).
    if torch._C._cuda_getDevice() == idx:          # the current card
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        check(rc, entry)
