"""Shared build-and-load for the port's in-tree C++ components.

Copied from ``distributed_tensorflow_tpu/utils/native.py``.  The port's
native library (the coordination service,
``distributed_tensorflow_tpu_torch/csrc/coordination/coord.cc``) follows
the JAX package's pattern: compile the
single-file source with ``g++`` on first use (or when the source is newer
than the cached .so) and load it over ctypes — no pybind11 in the image.

The compile is multi-process safe: every builder writes to a per-pid temp
path and ``os.replace``s it into place (atomic on POSIX), so concurrent
workers starting on a fresh checkout never observe a partially linked
library; the last finished build wins with identical bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DEFAULT_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")


def _writable_lib_path(lib_path: str, src: str) -> str:
    """``lib_path`` itself when its directory is writable (the editable/
    checkout layout), else a SOURCE-CONTENT-keyed file under a per-user
    cache dir — a wheel installed into read-only site-packages still builds
    and runs, and two environments holding different package versions never
    share (or clobber) one cached binary."""
    d = os.path.dirname(lib_path)
    if os.access(d, os.W_OK):
        return lib_path
    if os.path.exists(lib_path) and not os.path.exists(src):
        # Prebuilt .so shipped without its source (e.g. a stripped wheel in
        # read-only site-packages): nothing to CRC and nothing to rebuild.
        return lib_path
    import zlib
    with open(src, "rb") as fh:
        tag = format(zlib.crc32(fh.read()), "08x")
    cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.join(os.path.expanduser("~"), ".cache")),
        "distributed_tensorflow_tpu_torch")
    os.makedirs(cache, exist_ok=True)
    base, ext = os.path.splitext(os.path.basename(lib_path))
    return os.path.join(cache, f"{base}.{tag}{ext}")


def build_and_load(lib_path: str, src: str,
                   extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``src`` to ``lib_path`` if missing/stale, then CDLL it.

    Raises OSError/CalledProcessError on build or load failure — callers
    decide whether that is fatal (coordination) or falls back (tokenizer).
    """
    lib_path = _writable_lib_path(lib_path, src)
    if (not os.path.exists(lib_path)
            or (os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(lib_path))):
        tmp = f"{lib_path}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                ["g++", *(_DEFAULT_FLAGS + tuple(extra_flags)),
                 "-o", tmp, src],
                check=True, capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(lib_path)
