"""Causal-LM data streams for the GPT-mini workload: a byte-level text
corpus or the synthetic stream.

Host-only copy of ``distributed_tensorflow_tpu/data/lm.py`` (numpy; the
batches are bit for bit the JAX package's): when ``data_dir`` holds
``*.txt`` files they become the corpus, byte-level (vocab 256) or
subword-tokenized with ``tokenizer="bpe"`` (:mod:`.tokenizer`, trained on
the train region only), split 90/5/5 into contiguous
train/validation/test regions; otherwise the streams are the
deterministic position-dependent-bigram sequences of
:func:`..models.gpt.synthetic_lm_batch`, behind the reference's
``next_batch`` API.  A corpus larger than ``stream_threshold_bytes``
never loads whole: :class:`StreamingByteLmStream` reads it a chunk at a
time (disjoint chunk sets per shard, ``cursor()``/``restore_cursor()``
for resume; the cursor JSON is the JAX package's, so either package
resumes the other's).

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


class CorpusFiles:
    """Logical concatenation of on-disk files with range reads — the
    random-access view a streaming corpus needs without loading anything."""

    def __init__(self, paths: list[str]):
        self.paths = list(paths)
        self.sizes = [os.path.getsize(p) for p in self.paths]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.total = int(self.offsets[-1])

    def read(self, start: int, length: int) -> np.ndarray:
        """Bytes ``[start, start+length)`` of the logical corpus (clamped to
        the end), spanning file boundaries as needed."""
        end = min(start + length, self.total)
        out = np.empty(max(end - start, 0), np.uint8)
        pos = start
        while pos < end:
            fi = int(np.searchsorted(self.offsets, pos, side="right")) - 1
            local = pos - int(self.offsets[fi])
            n = min(end - pos, self.sizes[fi] - local)
            with open(self.paths[fi], "rb") as fh:
                fh.seek(local)
                out[pos - start:pos - start + n] = np.frombuffer(
                    fh.read(n), np.uint8)
            pos += n
        return out


class StreamingByteLmStream:
    """Chunked random-window stream over a corpus REGION that never holds
    more than one chunk in memory — corpora larger than RAM train.

    The region ``[lo, hi)`` of the logical corpus is cut into fixed
    ``chunk_bytes`` chunks (read with a ``seq_len`` overlap so windows
    crossing a chunk boundary exist).  Per epoch the chunk order is a
    seeded permutation; within a chunk, ``next_batch`` draws seeded random
    windows until the chunk's token budget (its own length) is consumed,
    then the next chunk loads — one epoch ≈ one pass over the region's
    tokens.  Everything is a pure function of ``(seed, epoch, chunk,
    draw)``, which buys the two distribution properties:

    - ``shard(index, count)``: processes take disjoint chunk subsets
      (``chunk % count == index``) — a per-process disjoint window over the
      files, nothing read twice across the fleet;
    - ``cursor()``/``restore_cursor()``: resume is deterministic — a
      restored stream continues with exactly the batches that followed
      the saved cursor.  (The training loop samples the cursor from the
      live stream, which its prefetcher has advanced past the
      checkpointed step, so end-to-end resume skips up to prefetch-depth
      batches — see ``training/loop.py``.)

    ``encode`` (optional) maps raw chunk bytes to token ids at load time
    (the BPE path); window sampling runs over the encoded ids.
    """

    def __init__(self, files: CorpusFiles, lo: int, hi: int, seq_len: int,
                 seed: int, chunk_bytes: int = 64 << 20, encode=None,
                 shard_index: int = 0, shard_count: int = 1):
        if hi - lo <= seq_len:
            raise ValueError(f"corpus region of {hi - lo} bytes is too "
                             f"short for seq_len={seq_len}")
        self.files = files
        self.lo, self.hi = lo, hi
        self.seq_len = seq_len
        self.chunk_bytes = chunk_bytes
        self.encode = encode
        self._seed0 = seed
        self._shard = (shard_index, shard_count)
        self.num_chunks = max(1, -(-(hi - lo) // chunk_bytes))
        self._epoch = 0
        self._perm_pos = 0
        self._draw = 0
        self._budget = 0
        self._chunk_data = None

    # ------------------------------------------------------------ internals

    def _my_chunks(self, epoch: int) -> np.ndarray:
        index, count = self._shard
        mine = np.arange(self.num_chunks)[index::count] if count > 1 else \
            np.arange(self.num_chunks)
        if mine.size == 0:
            # More processes than chunks: wrap so every process streams
            # SOMETHING (coverage beats strict disjointness here).
            mine = np.asarray([index % self.num_chunks])
        perm = np.random.default_rng(
            (self._seed0, 11, epoch)).permutation(mine.size)
        return mine[perm]

    def _read_encoded(self, start: int, end: int) -> np.ndarray:
        """Read+encode ``[start, end)``; on a degenerate result (tiny tail
        remainder, or a highly compressible region whose ENCODED length
        fell under a window) widen the read backward geometrically until
        one window exists."""
        data = self.files.read(start, end - start)
        if self.encode is not None:
            data = self.encode(data)
        width = end - start
        while len(data) <= self.seq_len:
            if start <= self.lo:
                raise ValueError(
                    f"corpus region [{self.lo}, {self.hi}) encodes to "
                    f"{len(data)} tokens <= seq_len={self.seq_len}")
            width *= 2
            start = max(self.lo, end - width)
            data = self.files.read(start, end - start)
            if self.encode is not None:
                data = self.encode(data)
        return np.asarray(data)

    def _load_chunk(self) -> None:
        order = self._my_chunks(self._epoch)
        c = int(order[self._perm_pos % order.size])
        start = self.lo + c * self.chunk_bytes
        end = min(start + self.chunk_bytes + self.seq_len, self.hi)
        self._chunk_data = self._read_encoded(start, end)
        self._budget = len(self._chunk_data)

    def _advance(self) -> None:
        self._perm_pos += 1
        if self._perm_pos >= self._my_chunks(self._epoch).size:
            self._perm_pos = 0
            self._epoch += 1
        self._chunk_data = None
        self._draw = 0

    # ------------------------------------------------------------ stream API

    def next_batch(self, batch_size: int) -> dict:
        if self._chunk_data is None:
            self._load_chunk()
        rng = np.random.default_rng(
            (self._seed0, self._epoch, self._perm_pos, self._draw))
        batch = _sample_windows(self._chunk_data, rng, batch_size,
                                self.seq_len)
        self._draw += 1
        self._budget -= batch_size * self.seq_len
        if self._budget <= 0:
            self._advance()
        return batch

    def shard(self, index: int, count: int) -> "StreamingByteLmStream":
        """Disjoint per-process stream (multi-controller sharded feed)."""
        return StreamingByteLmStream(
            self.files, self.lo, self.hi, self.seq_len, self._seed0,
            chunk_bytes=self.chunk_bytes, encode=self.encode,
            shard_index=index, shard_count=count)

    def fixed_batches(self, batch_size: int, num_batches: int) -> list[dict]:
        """Deterministic eval batches from the region's FIRST chunk (a
        bounded prefix — eval never walks the whole streaming corpus)."""
        end = min(self.lo + self.chunk_bytes + self.seq_len, self.hi)
        data = self._read_encoded(self.lo, end)
        return [_sample_windows(data,
                                np.random.default_rng((self._seed0, 13, i)),
                                batch_size, self.seq_len)
                for i in range(num_batches)]

    # ------------------------------------------------------------- resume

    def _geometry(self) -> list:
        # Everything the chunk ordering and window sampling depend on: a
        # cursor from a different fleet size / region / chunking must be
        # rejected, not silently reinterpreted over a different chunk set.
        return [self._seed0, self.lo, self.hi, self.seq_len,
                self.chunk_bytes, list(self._shard)]

    def cursor(self) -> dict:
        """Serializable position; feed to :meth:`restore_cursor` to resume
        the exact batch sequence."""
        return {"epoch": self._epoch, "perm_pos": self._perm_pos,
                "draw": self._draw, "budget": self._budget,
                "loaded": self._chunk_data is not None,
                "geometry": self._geometry()}

    def restore_cursor(self, cur: dict) -> bool:
        """Returns False (and restores nothing) for a cursor written under
        a different stream geometry."""
        if cur.get("geometry") != self._geometry():
            return False
        self._epoch = int(cur["epoch"])
        self._perm_pos = int(cur["perm_pos"])
        if cur.get("loaded", True):
            self._load_chunk()
            self._draw = int(cur["draw"])
            self._budget = int(cur["budget"])
        else:
            # Cursor taken right after a chunk advance: the next chunk was
            # never loaded — restoring its stale budget would advance twice.
            self._chunk_data = None
            self._draw = 0
        return True


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


#: corpora above this switch to the chunked streaming reader (override via
#: make_lm_datasets(stream_threshold_bytes=...) / --gpt_stream_corpus_mb)
STREAM_THRESHOLD_BYTES = 256 << 20
#: bytes of the train region the BPE tokenizer trains on when streaming
#: (the merge table converges on a few MB; the full corpus never loads)
BPE_SAMPLE_BYTES = 8 << 20


def _make_streaming_datasets(paths, seq_len, tokenizer, bpe_vocab,
                             tokenizer_path, chunk_bytes, data_dir):
    files = CorpusFiles(paths)
    n = files.total
    train_end, val_end = int(n * 0.9), int(n * 0.95)
    encode = None
    if tokenizer == "bpe":
        from .tokenizer import BpeTokenizer
        sample = files.read(0, min(train_end, BPE_SAMPLE_BYTES))
        tok = BpeTokenizer.train(sample, bpe_vocab)
        if tokenizer_path:
            tok.save(tokenizer_path)
        encode = tok.encode
        print(f"gpt bpe streaming corpus: {n:,} bytes from {data_dir}/*.txt "
              f"(vocab {tok.vocab_size} trained on a {len(sample):,}-byte "
              f"sample; chunks of {chunk_bytes:,} bytes encoded at load)")
    else:
        if tokenizer_path:
            from .tokenizer import BpeTokenizer
            BpeTokenizer([]).save(tokenizer_path)  # identity: ids = bytes
        print(f"gpt byte streaming corpus: {n:,} bytes from {data_dir}/*.txt "
              f"(train {train_end:,} / validation {val_end - train_end:,} / "
              f"test {n - val_end:,}; chunks of {chunk_bytes:,} bytes)")
    mk = lambda lo, hi, seed: StreamingByteLmStream(
        files, lo, hi, seq_len, seed, chunk_bytes=chunk_bytes, encode=encode)
    return LmDatasets(
        train=mk(0, train_end, 0),
        validation=mk(train_end, val_end, 7_000_000),
        test=mk(val_end, n, 8_000_000),
        synthetic=False,
    )


def make_lm_datasets(cfg, seq_len: int = 128,
                     data_dir: str | None = None,
                     tokenizer: str = "byte",
                     bpe_vocab: int = 512,
                     tokenizer_path: str | None = None,
                     stream_threshold_bytes: int = STREAM_THRESHOLD_BYTES,
                     stream_chunk_bytes: int = 64 << 20) -> LmDatasets:
    """``tokenizer``: "byte" (ids = bytes, vocab 256) or "bpe" (byte-level
    BPE trained on the train region up to ``bpe_vocab`` tokens — the model's
    vocab must be >= that).  ``tokenizer_path`` persists the trained merge
    table (and an identity table for "byte") so eval/generate can decode
    ids back to text; every process derives the identical vocabulary
    deterministically, no broadcast needed.

    Corpora whose on-disk size exceeds ``stream_threshold_bytes`` never
    load into RAM: they stream through :class:`StreamingByteLmStream`
    (chunked reads, sharded disjoint chunk sets, cursor resume).  The BPE
    tokenizer then trains on a bounded train-region sample."""
    if tokenizer not in ("byte", "bpe"):
        raise ValueError(f"tokenizer must be 'byte' or 'bpe', got {tokenizer!r}")
    if data_dir and os.path.isdir(data_dir):
        paths = sorted(glob.glob(os.path.join(data_dir, "*.txt")))
        total = sum(os.path.getsize(p) for p in paths)
        if paths and total > stream_threshold_bytes:
            return _make_streaming_datasets(
                paths, seq_len, tokenizer, bpe_vocab, tokenizer_path,
                stream_chunk_bytes, data_dir)
    corpus = load_byte_corpus(data_dir)
    if corpus is not None:
        n = len(corpus)
        train_end, val_end = int(n * 0.9), int(n * 0.95)
        # Every 90/5/5 region must fit at least one window; below that the
        # source decision stays graceful — warn and use the synthetic stream.
        min_bytes = int((seq_len + 1) / 0.05) + 1
        if n - val_end <= seq_len or val_end - train_end <= seq_len:
            print(f"WARNING: byte corpus under {data_dir} has {n:,} bytes; "
                  f"need > {min_bytes:,} for seq_len={seq_len} "
                  "(each 5% validation/test split must exceed one window) — "
                  "falling back to the synthetic stream")
            corpus = None
    if corpus is not None and tokenizer == "bpe":
        from .tokenizer import BpeTokenizer
        tok = BpeTokenizer.train(corpus[:train_end], bpe_vocab)
        regions = [corpus[:train_end], corpus[train_end:val_end],
                   corpus[val_end:]]
        ids = [tok.encode(r) for r in regions]
        if any(len(r) <= seq_len for r in ids[1:]):
            print(f"WARNING: BPE-encoded corpus regions "
                  f"{[len(r) for r in ids]} tokens; each validation/test "
                  f"region must exceed seq_len={seq_len} — falling back to "
                  "the synthetic stream")
            corpus = None
        else:
            if tokenizer_path:
                tok.save(tokenizer_path)
            n_ids = sum(len(r) for r in ids)
            print(f"gpt bpe corpus: {n:,} bytes -> {n_ids:,} tokens "
                  f"(vocab {tok.vocab_size}, {n / max(n_ids, 1):.2f} "
                  f"bytes/token) from {data_dir}/*.txt (train {len(ids[0]):,}"
                  f" / validation {len(ids[1]):,} / test {len(ids[2]):,})")
            return LmDatasets(
                train=ByteLmStream(ids[0], seq_len, seed=0),
                validation=ByteLmStream(ids[1], seq_len, seed=7_000_000),
                test=ByteLmStream(ids[2], seq_len, seed=8_000_000),
                synthetic=False,
            )
    if corpus is not None:
        if tokenizer_path:
            from .tokenizer import BpeTokenizer
            BpeTokenizer([]).save(tokenizer_path)  # identity: ids = bytes
        print(f"gpt byte corpus: {n:,} bytes from {data_dir}/*.txt "
              f"(train {train_end:,} / validation {val_end - train_end:,} / "
              f"test {n - val_end:,})")
        return LmDatasets(
            train=ByteLmStream(corpus[:train_end], seq_len, seed=0),
            validation=ByteLmStream(corpus[train_end:val_end], seq_len,
                                    seed=7_000_000),
            test=ByteLmStream(corpus[val_end:], seq_len, seed=8_000_000),
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
