"""Byte-pair-encoding tokenizer for the LM corpus path.

Host-only copy of ``distributed_tensorflow_tpu/data/tokenizer.py``:
``--gpt_tokenizer=bpe`` trains a byte-level BPE vocabulary on the
corpus's train split, so a fixed ``--bert_seq_len`` window covers more
text than raw bytes do.

The hot loops (pair counting and merge compaction for training,
rank-by-rank merge application for encoding) run in C++, the port's own
copy ``distributed_tensorflow_tpu_torch/csrc/tokenizer/bpe.cc``, built
with ``g++`` into the package's ignored ``_build/`` on first use and
reached over a ctypes C ABI (the coordination service's pattern).  Where
the JAX module falls back quietly to NumPy when the build fails, this one
raises and names ``g++``: a card run must not time a NumPy tokenizer
without saying so.  ``_train_np`` and ``_encode_np`` stay as the plain
reference the tests hold the native core to; :func:`native_library`
says whether the native core loaded.

Determinism: training is a pure function of (corpus bytes, vocab_size),
ties broken toward the numerically smallest pair, so every process
derives the same vocabulary; the merges and ids equal the JAX
package's.  ``save``/``load`` write and read the same ``tokenizer.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import threading

import numpy as np

from ..utils.native import build_and_load

_LIB_NAME = "libdtfbpe.so"
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.normpath(
    os.path.join(_HERE, "..", "csrc", "tokenizer", "bpe.cc"))
# Beside the coordination library, in the package's ignored ``_build/``.
_BUILD = os.path.normpath(os.path.join(_HERE, "..", "_build"))

_lib = None
_lib_lock = threading.Lock()


def _load_library() -> ctypes.CDLL:
    """Build (if stale) and load the native library.  Raises
    ``RuntimeError`` naming ``g++`` when it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            os.makedirs(_BUILD, exist_ok=True)
            lib = build_and_load(os.path.join(_BUILD, _LIB_NAME), _SRC)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise RuntimeError(
                f"the BPE tokenizer's native core ({_SRC}) could not be "
                f"built with g++ or loaded: {e} "
                f"{detail.decode(errors='replace').strip()}") from e
        lib.dtf_bpe_train.restype = ctypes.c_int
        lib.dtf_bpe_train.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.dtf_bpe_encode.restype = ctypes.c_int64
        lib.dtf_bpe_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def native_library() -> bool:
    """True once the native core is built and loaded (this call builds
    it if no train or encode has); raises naming ``g++`` when it cannot
    be.  Every train and encode runs on it."""
    return _load_library() is not None


def _as_u8(data) -> np.ndarray:
    arr = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8)
                               if isinstance(data, (bytes, bytearray))
                               else np.asarray(data, np.uint8))
    return arr


# ---------------------------------------------- NumPy reference


def _merge_pass_np(seq: np.ndarray, a: int, b: int, new_id: int) -> np.ndarray:
    """Non-overlapping left-to-right replacement of (a, b) -> new_id.

    Vectorized: candidate positions are pair starts; overlapping runs
    (e.g. 'aaa' for rule (a, a)) keep alternating members only, matching the
    C++ scan's greedy semantics.
    """
    if len(seq) < 2:
        return seq
    hits = np.flatnonzero((seq[:-1] == a) & (seq[1:] == b))
    if len(hits) == 0:
        return seq
    if a == b:
        # Greedy left-to-right within each run of consecutive hits: keep
        # every other hit (runs of equal tokens are the only overlap case).
        keep = []
        prev = -2
        for h in hits:
            if h == prev + 1:
                continue        # overlaps the pair we just merged
            keep.append(h)
            prev = h
        hits = np.asarray(keep, hits.dtype)
    out = seq.copy()
    out[hits] = new_id
    mask = np.ones(len(seq), bool)
    mask[hits + 1] = False
    return out[mask]


def _train_np(data: np.ndarray, max_merges: int,
              min_pair_count: int) -> list[tuple[int, int]]:
    seq = data.astype(np.int32)
    merges: list[tuple[int, int]] = []
    min_pair_count = max(min_pair_count, 2)
    for rank in range(max_merges):
        if len(seq) < 2:
            break
        keys = seq[:-1].astype(np.int64) * (1 << 32) + seq[1:]
        uniq, counts = np.unique(keys, return_counts=True)
        best = counts.max()
        if best < min_pair_count:
            break
        cand = uniq[counts == best].min()      # smallest pair wins ties
        a, b = int(cand >> 32), int(cand & 0xFFFFFFFF)
        merges.append((a, b))
        seq = _merge_pass_np(seq, a, b, 256 + rank)
    return merges


def _encode_np(data: np.ndarray, merges: list[tuple[int, int]]) -> np.ndarray:
    seq = data.astype(np.int32)
    for rank, (a, b) in enumerate(merges):
        if len(seq) < 2:
            break
        seq = _merge_pass_np(seq, a, b, 256 + rank)
    return seq


# ------------------------------------------------------------ tokenizer


class BpeTokenizer:
    """Byte-level BPE: base vocab = 256 bytes, merge rank r = token 256+r."""

    def __init__(self, merges: list[tuple[int, int]]):
        self.merges = [(int(a), int(b)) for a, b in merges]
        # token id -> bytes, built by replaying the merge table.
        table = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            table.append(table[a] + table[b])
        self._bytes = table

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    # -- training ---------------------------------------------------------

    @classmethod
    def train(cls, data, vocab_size: int, *, min_pair_count: int = 2,
              max_train_bytes: int = 8 << 20) -> "BpeTokenizer":
        """Train on a byte corpus; ``vocab_size`` includes the 256 bytes.

        Training runs on at most ``max_train_bytes`` (the corpus prefix) —
        merge statistics saturate long before that; encoding always covers
        the full corpus.
        """
        if vocab_size < 256:
            raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
        arr = _as_u8(data)[:max_train_bytes]
        max_merges = vocab_size - 256
        lib = _load_library()
        out = np.empty((max(max_merges, 1), 2), np.int32)
        n = lib.dtf_bpe_train(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr),
            max_merges, min_pair_count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return cls([tuple(p) for p in out[:n]])

    # -- encode / decode --------------------------------------------------

    def encode(self, data) -> np.ndarray:
        """bytes -> int32 token ids."""
        arr = _as_u8(data)
        if not self.merges or len(arr) == 0:
            return arr.astype(np.int32)
        lib = _load_library()
        merges = np.ascontiguousarray(np.asarray(self.merges, np.int32))
        out = np.empty(len(arr), np.int32)
        n = lib.dtf_bpe_encode(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr),
            merges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self.merges),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out[:n].copy()

    def decode(self, ids) -> bytes:
        """int ids -> bytes.  Ids beyond the trained vocabulary decode to
        U+FFFD: the model's embedding is padded up to ``--gpt_bpe_vocab``
        even when the corpus yields fewer merges, so sampling can legally
        emit ids the merge table never produced."""
        table = self._bytes
        rep = "�".encode("utf-8")
        return b"".join(
            table[i] if 0 <= i < len(table) else rep
            for i in (int(i) for i in np.asarray(ids).ravel()))

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # Per-pid temp name: in multi-process runs every worker derives (and
        # may save) the identical table; os.replace keeps the write atomic.
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"version": 1, "kind": "byte_bpe",
                       "merges": self.merges}, fh)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        with open(path) as fh:
            blob = json.load(fh)
        if blob.get("kind") != "byte_bpe":
            raise ValueError(f"{path} is not a byte_bpe tokenizer file")
        return cls([tuple(m) for m in blob["merges"]])
