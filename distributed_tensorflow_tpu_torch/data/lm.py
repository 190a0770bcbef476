"""Causal-LM data streams for the GPT-mini workload: a byte-level text
corpus or the synthetic stream.

Host-only copy of ``distributed_tensorflow_tpu/data/lm.py`` (numpy; the
batches are bit for bit the JAX package's): when ``data_dir`` holds
``*.txt`` files they become a byte-level corpus (vocab 256) split 90/5/5
into contiguous train/validation/test regions; otherwise the streams are
the deterministic position-dependent-bigram sequences of
:func:`..models.gpt.synthetic_lm_batch`, behind the reference's
``next_batch`` API.  The BPE tokenizer and the streaming (larger than RAM)
corpus are not ported yet and raise (ROADMAP.md, section 1, item 7a).

:func:`make_lm_eval_fn` is the torch counterpart of the JAX eval
function: next-token accuracy over fixed batches.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..models.gpt import synthetic_lm_batch


class LmStream:
    """Batch stream with ``next_batch``; each call advances the sample seed."""

    def __init__(self, cfg, seq_len: int, seed: int):
        self.cfg = cfg
        self.seq_len = seq_len
        self._seed0 = seed
        self._seed = seed

    def next_batch(self, batch_size: int) -> dict:
        batch = synthetic_lm_batch(self._seed, batch_size, self.seq_len,
                                   self.cfg)
        self._seed += 1
        return batch

    def shard(self, index: int, count: int) -> "LmStream":
        """Disjoint per-process stream (multi-controller sharded feed)."""
        del count
        return LmStream(self.cfg, self.seq_len,
                        self._seed + (index + 1) * 1_000_003)

    def fixed_batches(self, batch_size: int, num_batches: int) -> list[dict]:
        return [synthetic_lm_batch(20_000_000 + self._seed0 + i,
                                   batch_size, self.seq_len, self.cfg)
                for i in range(num_batches)]


def _sample_windows(data: np.ndarray, rng: np.random.Generator,
                    batch_size: int, seq_len: int) -> dict:
    """Seeded random fixed-length windows over ``data``.  +1: the high
    bound is exclusive, and the last start ``len(data) - seq_len`` must
    stay drawable."""
    starts = rng.integers(0, len(data) - seq_len + 1, size=batch_size)
    toks = np.stack([data[s:s + seq_len] for s in starts])
    return {"tokens": toks.astype(np.int32)}


class ByteLmStream:
    """Random fixed-length byte windows over a corpus region; same
    ``next_batch``/``fixed_batches`` API as :class:`LmStream`."""

    def __init__(self, data: np.ndarray, seq_len: int, seed: int):
        if len(data) <= seq_len:
            raise ValueError(f"corpus region of {len(data)} bytes is too "
                             f"short for seq_len={seq_len}")
        self.data = data
        self.seq_len = seq_len
        self._seed0 = seed
        self._seed = seed

    def _windows(self, rng: np.random.Generator, batch_size: int) -> dict:
        return _sample_windows(self.data, rng, batch_size, self.seq_len)

    def next_batch(self, batch_size: int) -> dict:
        batch = self._windows(np.random.default_rng(self._seed), batch_size)
        self._seed += 1
        return batch

    def shard(self, index: int, count: int) -> "ByteLmStream":
        """Disjoint per-process stream (multi-controller sharded feed)."""
        del count
        return ByteLmStream(self.data, self.seq_len,
                            self._seed + (index + 1) * 1_000_003)

    def fixed_batches(self, batch_size: int, num_batches: int) -> list[dict]:
        return [self._windows(
                    np.random.default_rng(20_000_000 + self._seed0 + i),
                    batch_size)
                for i in range(num_batches)]


def load_byte_corpus(data_dir: str | None) -> np.ndarray | None:
    """Concatenated bytes of ``<data_dir>/*.txt`` (sorted), or None.
    ``*.txt`` only: a data directory of other files must not silently
    become an LM corpus."""
    if not data_dir or not os.path.isdir(data_dir):
        return None
    paths = sorted(glob.glob(os.path.join(data_dir, "*.txt")))
    if not paths:
        return None

    def read_bytes(path):
        with open(path, "rb") as fh:
            return np.frombuffer(fh.read(), np.uint8)

    return np.concatenate([read_bytes(p) for p in paths])


@dataclass
class LmDatasets:
    train: LmStream
    validation: LmStream
    test: LmStream
    synthetic: bool = True


#: corpora above this would stream in chunks in the JAX package
STREAM_THRESHOLD_BYTES = 256 << 20


def _todo(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md, "
                               "section 1, item 7a")


def make_lm_datasets(cfg, seq_len: int = 128,
                     data_dir: str | None = None,
                     tokenizer: str = "byte",
                     stream_threshold_bytes: int = STREAM_THRESHOLD_BYTES
                     ) -> LmDatasets:
    """Train/validation/test streams: the byte corpus under ``data_dir``
    when it holds ``*.txt`` files, the synthetic stream otherwise.
    ``tokenizer="bpe"`` and corpora above ``stream_threshold_bytes`` (the
    streaming reader) raise ``NotImplementedError``."""
    if tokenizer not in ("byte", "bpe"):
        raise ValueError(
            f"tokenizer must be 'byte' or 'bpe', got {tokenizer!r}")
    if tokenizer == "bpe":
        raise _todo("the BPE tokenizer (data/tokenizer.py and its C++ core)")
    if data_dir and os.path.isdir(data_dir):
        paths = sorted(glob.glob(os.path.join(data_dir, "*.txt")))
        if paths and sum(os.path.getsize(p)
                         for p in paths) > stream_threshold_bytes:
            raise _todo("the streaming corpus (StreamingByteLmStream)")
    corpus = load_byte_corpus(data_dir)
    if corpus is not None:
        n = len(corpus)
        train_end, val_end = int(n * 0.9), int(n * 0.95)
        # Every 90/5/5 region must fit at least one window; below that the
        # source decision stays graceful: warn and use the synthetic stream.
        min_bytes = int((seq_len + 1) / 0.05) + 1
        if n - val_end <= seq_len or val_end - train_end <= seq_len:
            print(f"WARNING: byte corpus under {data_dir} has {n:,} bytes; "
                  f"need > {min_bytes:,} for seq_len={seq_len} "
                  "(each 5% validation/test split must exceed one window) — "
                  "falling back to the synthetic stream")
        else:
            print(f"gpt byte corpus: {n:,} bytes from {data_dir}/*.txt "
                  f"(train {train_end:,} / validation "
                  f"{val_end - train_end:,} / test {n - val_end:,})")
            return LmDatasets(
                train=ByteLmStream(corpus[:train_end], seq_len, seed=0),
                validation=ByteLmStream(corpus[train_end:val_end], seq_len,
                                        seed=7_000_000),
                test=ByteLmStream(corpus[val_end:], seq_len,
                                  seed=8_000_000),
                synthetic=False,
            )
    return LmDatasets(
        train=LmStream(cfg, seq_len, seed=0),
        validation=LmStream(cfg, seq_len, seed=7_000_000),
        test=LmStream(cfg, seq_len, seed=8_000_000),
    )


def make_lm_eval_fn(apply_fn, batch_size: int = 32, num_batches: int = 4):
    """Next-token accuracy over fixed batches: ``eval_fn(state, split) ->
    float``.  ``apply_fn(model, tokens) -> logits`` runs in ``eval()``
    mode without gradients; the model's mode is restored after."""

    def evaluate(state, split) -> float:
        model = state.model
        was_training = model.training
        model.eval()
        num, den = 0.0, 0.0
        try:
            with torch.no_grad():
                for batch in split.fixed_batches(batch_size, num_batches):
                    tokens = torch.as_tensor(batch["tokens"],
                                             device=model.device).long()
                    logits = apply_fn(model, tokens)
                    correct = (logits[:, :-1].argmax(-1) == tokens[:, 1:])
                    num += float(correct.sum())
                    den += correct.numel()
        finally:
            model.train(was_training)
        return num / max(den, 1.0)

    return evaluate
