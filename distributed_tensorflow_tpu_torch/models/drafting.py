"""Prompt-lookup drafting, the host half: numpy only.

Counterpart of ``distributed_tensorflow_tpu/models/drafting.py``'s host
parts (``TABLE_SIZE``, ``ngram_hash``, ``ngram_draft_scan``,
``NGramIndex``), which the serving engine's speculative arm uses to draft
each lane's continuation.  The drafter proposes the tokens that followed
the most recent earlier occurrence of the sequence's current ``n``-gram
tail, from an incrementally maintained index:

- a bounded hash table mapping ``hash(n-gram) -> last start position + 1``
  (0 = empty), updated last-wins in position order, so it answers "where
  did this n-gram most recently start?", with a second table of the
  start before it (``prev``);
- per decode round only the positions committed last round are inserted;
- a lookup checks that the stored position's gram matches the queried
  one token for token before proposing, so a hash collision proposes
  nothing instead of a wrong draft.

Drafts affect only speed, never the output: the verify pass accepts
exactly the greedy continuation.  The JAX package's device drafter
(``index_draft``, ``index_update2``, ``index_build2``, ``tail_gram``)
serves ``generate_cached_speculative_device`` and is not ported yet.
"""

from __future__ import annotations

import numpy as np

#: Hash table buckets per sequence.  4096 entries hold every distinct
#: n-gram of a few-hundred-token context with few collisions in a
#: 16 KiB int32 table per sequence.
TABLE_SIZE = 4096

#: Polynomial rolling-hash multiplier (odd, large enough to spread
#: byte-level vocabularies across the table).
_MUL = 1000003


def ngram_hash(gram, table_size: int = TABLE_SIZE):
    """Polynomial hash of ``gram`` tokens over its LAST axis, mod 2^32 and
    then mod ``table_size`` (the JAX package's device drafter hashes the
    same way, bucket for bucket)."""
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
