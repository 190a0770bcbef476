"""Prompt-lookup drafting, host and device.

Counterpart of ``distributed_tensorflow_tpu/models/drafting.py``: the
host index (:class:`NGramIndex`, numpy), which the serving engine's
speculative arm and :func:`..models.gpt.generate_cached_speculative` use
to draft each row's continuation, and the device index
(:func:`index_build2`, :func:`index_update2`, :func:`index_draft`,
:func:`tail_gram`, on torch tensors), which
:func:`..models.gpt.generate_cached_speculative_device` keeps on the
device.  Both use the same hash, table geometry and last-wins order, so
they propose the same drafts from the same stream.

The drafter proposes the tokens that followed the most recent earlier
occurrence of the sequence's current ``n``-gram tail, from an
incrementally maintained index:

- a bounded hash table mapping ``hash(n-gram) -> last start position + 1``
  (0 = empty), updated last-wins in position order, so it answers "where
  did this n-gram most recently start?", with a second table of the
  start before it (``prev``);
- per decode round only the positions committed last round are inserted;
- a lookup checks that the stored position's gram matches the queried
  one token for token before proposing, so a hash collision proposes
  nothing instead of a wrong draft.

Drafts affect only speed, never the output: the verify pass accepts
exactly the greedy continuation.
"""

from __future__ import annotations

import numpy as np
import torch

#: Hash table buckets per sequence.  4096 entries hold every distinct
#: n-gram of a few-hundred-token context with few collisions in a
#: 16 KiB int32 table per sequence.
TABLE_SIZE = 4096

#: Polynomial rolling-hash multiplier (odd, large enough to spread
#: byte-level vocabularies across the table).
_MUL = 1000003


def ngram_hash(gram, table_size: int = TABLE_SIZE):
    """Polynomial hash of ``gram`` tokens over its LAST axis, mod 2^32 and
    then mod ``table_size``: int32 buckets of a numpy array, int64 of a
    tensor, equal bucket for bucket (and to the JAX package's).  A tensor
    hashes in int64 masked to 32 bits after each multiply-add (the
    product of a 32-bit value and the multiplier stays below 2^53, so
    this is the uint32 wraparound exactly)."""
    if isinstance(gram, torch.Tensor):
        h = torch.zeros(gram.shape[:-1], dtype=torch.long,
                        device=gram.device)
        g = gram.long()
        for i in range(gram.shape[-1]):
            h = (h * _MUL + g[..., i]) & 0xFFFFFFFF
        return h % table_size
    gram = np.asarray(gram)
    h = np.zeros(gram.shape[:-1], np.uint32)
    g = gram.astype(np.uint32)
    with np.errstate(over="ignore"):      # mod-2^32 wraparound is the hash
        for i in range(gram.shape[-1]):
            h = np.add(np.multiply(h, np.uint32(_MUL), dtype=np.uint32),
                       g[..., i], dtype=np.uint32)
    return (h % np.uint32(table_size)).astype(np.int32)


def ngram_draft_scan(row: np.ndarray, length: int, n: int,
                     k: int) -> np.ndarray:
    """Reference drafter: exact most-recent-match linear scan (the
    pre-index host implementation, kept as the semantics oracle for the
    property tests).  Finds the most recent earlier occurrence of the
    row's last ``n``-gram strictly before the tail and proposes the ``k``
    tokens that followed it; zero-filled when no match exists."""
    out = np.zeros(k, np.int32)
    if length <= n:
        return out
    tail = row[length - n:length]
    hay = row[:length - 1]
    for start in range(length - n - 1, -1, -1):
        if np.array_equal(hay[start:start + n], tail):
            src = row[start + n:min(start + n + k, length)]
            out[:len(src)] = src
            return out
    return out


class NGramIndex:
    """Host-side incremental index for ONE sequence (numpy).

    ``update(tokens, upto)`` inserts every n-gram whose window ends at or
    before ``upto`` and that was not inserted yet (the committed region);
    ``draft(tokens, eff_len, k)`` proposes ``k`` continuation tokens for
    the n-gram ending at ``eff_len``.  Same table, same hash, same
    last-wins order as the JAX package's device implementation.

    Contract: index the COMMITTED region only and
    query for a tail ending at least one token past it (``eff_len >
    indexed_len``) — otherwise the tail's own gram is its most recent
    occurrence and every lookup degenerates to a self-match."""

    def __init__(self, n: int, table_size: int = TABLE_SIZE):
        if n < 1:
            raise ValueError(f"ngram order must be >= 1, got {n}")
        self.n = int(n)
        self.table_size = int(table_size)
        self.table = np.zeros(table_size, np.int32)  # pos + 1; 0 = empty
        # Second-most-recent start per bucket — the tree drafter's branch
        # source (the "other" continuation at an ambiguous n-gram).
        self.prev = np.zeros(table_size, np.int32)
        self.indexed_len = 0        # tokens whose grams are in the table

    def update(self, tokens: np.ndarray, upto: int) -> None:
        """Index grams of ``tokens[:upto]`` not yet indexed (incremental:
        O(upto - indexed_len), not O(upto)).

        Vectorized (the serving engine calls this on its single engine
        thread, over the WHOLE prompt at admission): all hashes in one
        numpy pass, then a grouped last/second-last reduction — exactly
        equivalent to inserting each position in ascending order with
        last-wins (``table``) and displaced-last (``prev``)."""
        n = self.n
        upto = int(upto)
        start = max(0, self.indexed_len - n + 1)
        count = upto - n + 1 - start
        if count > 0:
            windows = np.lib.stride_tricks.sliding_window_view(
                np.asarray(tokens[start:upto], np.int32), n)  # [count, n]
            h = ngram_hash(windows, self.table_size)
            ps = np.arange(start, upto - n + 1, dtype=np.int32)
            order = np.argsort(h, kind="stable")   # ps ascending per bucket
            hs, pss = h[order], ps[order]
            first = np.ones(len(hs), bool)
            first[1:] = hs[1:] != hs[:-1]
            last = np.ones(len(hs), bool)
            last[:-1] = hs[1:] != hs[:-1]
            # Each insert's displaced-prev: the bucket's previous insert
            # in this batch, or the pre-batch table entry for the first.
            prev_val = np.empty(len(hs), np.int32)
            prev_val[first] = self.table[hs[first]]
            notfirst = ~first
            prev_val[notfirst] = pss[np.flatnonzero(notfirst) - 1] + 1
            self.prev[hs[last]] = prev_val[last]
            self.table[hs[last]] = pss[last] + 1
        self.indexed_len = max(self.indexed_len, upto)

    def draft(self, tokens: np.ndarray, eff_len: int, k: int,
              tail: np.ndarray | None = None,
              which: str = "last") -> np.ndarray:
        """``k`` proposed continuation tokens for the gram ending at
        ``eff_len`` (or an explicit ``tail`` of ``n`` tokens — the tree
        drafter's virtual tails).  ``which="prev"`` proposes from the
        SECOND-most-recent occurrence instead (the tree branch).
        Collision-checked: a stored position whose gram does not match
        proposes nothing."""
        n = self.n
        out = np.zeros(k, np.int32)
        if tail is None:
            if eff_len < n:
                return out
            tail = tokens[eff_len - n:eff_len]
        table = self.table if which == "last" else self.prev
        j = int(table[int(ngram_hash(tail, self.table_size))]) - 1
        if j < 0 or not np.array_equal(tokens[j:j + n], np.asarray(tail)):
            return out
        src = tokens[j + n:min(j + n + k, eff_len)]
        out[:len(src)] = src
        return out


# ------------------------------------------------------------- device
# Tables are int32 [B, table_size] (start position + 1; 0 = empty), token
# buffers int64 [B, total]; every function is [B]-batched tensor code with
# no host read.


def _grams(toks: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n]: row b's tokens from ``start[b]`` (reads clamped into the
    buffer)."""
    idx = start[:, None] + torch.arange(n, device=toks.device)[None, :]
    return torch.gather(toks, 1, idx.clamp(0, toks.shape[1] - 1))


def index_draft(index: torch.Tensor, toks: torch.Tensor, tail: torch.Tensor,
                eff_len: torch.Tensor, *, n: int, k: int) -> torch.Tensor:
    """[B, k] proposed continuations of ``tail`` ([B, n]) from ``index``
    (the ``last`` or the ``prev`` table).  Collision-checked as the host's:
    the stored position's gram must equal ``tail`` token for token, or
    the row proposes zeros; ``eff_len`` [B] bounds the source reads."""
    total = toks.shape[1]
    h = ngram_hash(tail, index.shape[1])
    j = torch.gather(index, 1, h[:, None])[:, 0].long() - 1
    stored = _grams(toks, j.clamp(0, max(total - n, 0)), n)
    hit = (j >= 0) & (eff_len >= n) & (stored == tail).all(dim=-1)
    didx = j[:, None] + n + torch.arange(k, device=toks.device)[None, :]
    valid = hit[:, None] & (didx < eff_len[:, None])
    drafts = torch.gather(toks, 1, didx.clamp(0, total - 1))
    return torch.where(valid, drafts, 0)


def index_update2(last: torch.Tensor, prev: torch.Tensor, toks: torch.Tensor,
                  old_len: torch.Tensor, new_len: torch.Tensor, *, n: int,
                  span: int):
    """Fold the grams created by the tokens committed since ``old_len``
    (start positions ``old_len - n + 1 .. new_len - n``, at most ``span``
    of them) into ``last`` and ``prev`` (each bucket's second most recent
    start, the tree drafter's branch source), in place.  ``prev`` is the
    displaced ``last``, so the order of inserts matters: the ``span``
    positions go in one at a time, ascending, each a [B]-sized write (one
    per row, so no index repeats), as the host inserts them.  Returns
    ``(last, prev)``."""
    total = toks.shape[1]
    rows = torch.arange(toks.shape[0], device=toks.device)
    for i in range(span):
        p = old_len - n + 1 + i                                  # [B]
        ok = (p >= 0) & (p + n <= new_len)
        h = ngram_hash(_grams(toks, p.clamp(0, max(total - n, 0)), n),
                       last.shape[1])
        cur_last, cur_prev = last[rows, h], prev[rows, h]
        prev[rows, h] = torch.where(ok, cur_last, cur_prev)
        last[rows, h] = torch.where(ok, (p + 1).to(last.dtype), cur_last)
    return last, prev


def index_build2(toks: torch.Tensor, lens: torch.Tensor, *, n: int,
                 table_size: int = TABLE_SIZE, max_len: int | None = None):
    """``(last, prev)`` tables of each row's first ``lens[b]`` tokens, one
    sequential pass (``prev`` needs the insertion order); ``max_len``, a
    bound on ``lens`` (e.g. the prompt length), caps the pass."""
    B, total = toks.shape
    span = total if max_len is None else min(int(max_len), total)
    last = torch.zeros((B, table_size), dtype=torch.int32,
                       device=toks.device)
    prev = torch.zeros_like(last)
    if total < n or span < n:
        return last, prev
    return index_update2(last, prev, toks, torch.zeros_like(lens), lens,
                         n=n, span=span)


def tail_gram(toks: torch.Tensor, eff_len: torch.Tensor, *,
              n: int) -> torch.Tensor:
    """[B, n]: each row's last ``n`` tokens before ``eff_len`` (clamped
    reads for rows shorter than ``n``, which never pass the collision
    check)."""
    return _grams(toks, eff_len - n, n)
