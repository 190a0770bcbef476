"""The port's host drafter (distributed_tensorflow_tpu_torch/models/
drafting.py) against the JAX package's on the same seeded streams: the
hash, the index's tables after incremental updates, its drafts (the most
recent and the second most recent match), collisions, virtual tails and
short rows, and the exact-scan oracle.  The two are numpy code on both
sides, so they agree exactly."""

import numpy as np
import pytest

from distributed_tensorflow_tpu.models import drafting as jd
from distributed_tensorflow_tpu_torch.models import drafting as td


def _stream(seed, length, vocab=24, period=None):
    rng = np.random.default_rng(seed)
    if period:
        base = rng.integers(0, vocab, period)
        row = np.tile(base, -(-length // period))[:length]
        noise = rng.random(length) < 0.05
        row = np.where(noise, rng.integers(0, vocab, length), row)
    else:
        row = rng.integers(0, vocab, length)
    return row.astype(np.int32)


def test_constants_and_hash_match():
    assert td.TABLE_SIZE == jd.TABLE_SIZE
    grams = np.random.default_rng(0).integers(0, 50000, (64, 5))
    for size in (td.TABLE_SIZE, 2, 97):
        np.testing.assert_array_equal(td.ngram_hash(grams, size),
                                      jd.ngram_hash(grams, size))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("seed,period", [(0, 13), (1, 7), (2, None)])
def test_incremental_index_and_drafts_match_jax(n, seed, period):
    """The same stream fed in the same uneven increments (the engine's
    commit pattern): identical tables and identical drafts at every
    step, from the newest and from the previous match."""
    row = _stream(seed, 160, vocab=8 if period else 24, period=period)
    ti, ji = td.NGramIndex(n), jd.NGramIndex(n)
    rng = np.random.default_rng(seed + 10)
    at = 20
    ti.update(row, at - 1)
    ji.update(row, at - 1)
    while at < len(row):
        for which in ("last", "prev"):
            np.testing.assert_array_equal(ti.draft(row, at, 5, which=which),
                                          ji.draft(row, at, 5, which=which))
        step = int(rng.integers(1, 6))
        at = min(at + step, len(row))
        ti.update(row, at - 1)
        ji.update(row, at - 1)
        np.testing.assert_array_equal(ti.table, ji.table)
        np.testing.assert_array_equal(ti.prev, ji.prev)
        assert ti.indexed_len == ji.indexed_len


def test_index_hit_is_a_true_continuation():
    """Whenever the index proposes a draft, it equals the exact scan's."""
    n, k = 3, 5
    hits = 0
    for seed in range(8):
        row = _stream(seed, 140, vocab=8, period=13)
        host = td.NGramIndex(n)
        host.update(row, 139)
        got = host.draft(row, 140, k)
        np.testing.assert_array_equal(
            td.ngram_draft_scan(row, 140, n, k),
            jd.ngram_draft_scan(row, 140, n, k))
        if not got.any():
            continue
        hits += 1
        np.testing.assert_array_equal(got, td.ngram_draft_scan(row, 140, n,
                                                               k))
    assert hits >= 4


def test_collisions_propose_nothing_wrong():
    """A two-bucket table: a stored gram that no longer matches the
    queried tail proposes nothing, on both sides alike."""
    n = 2
    row = np.asarray([1, 2, 9, 9, 3, 4, 9, 9, 5], np.int32)
    ti, ji = td.NGramIndex(n, table_size=2), jd.NGramIndex(n, table_size=2)
    ti.update(row, len(row))
    ji.update(row, len(row))
    for tail in ([1, 2], [3, 4], [5, 6], [9, 9]):
        tail = np.asarray(tail, np.int32)
        got = ti.draft(row, len(row), 3, tail=tail)
        np.testing.assert_array_equal(got, ji.draft(row, len(row), 3,
                                                    tail=tail))
        stored = int(ti.table[int(td.ngram_hash(tail, 2))]) - 1
        if stored < 0 or not np.array_equal(row[stored:stored + n], tail):
            assert not got.any()


def test_virtual_tail_and_prev_branch():
    row = np.asarray(list(range(10)) * 3, np.int32)
    ti, ji = td.NGramIndex(3), jd.NGramIndex(3)
    ti.update(row, 28)
    ji.update(row, 28)
    tail = np.asarray([7, 8, 9], np.int32)
    got = ti.draft(row, len(row), 4, tail=tail)
    np.testing.assert_array_equal(got, [0, 1, 2, 3])
    np.testing.assert_array_equal(got, ji.draft(row, len(row), 4,
                                                tail=tail))
    row = np.asarray([7, 8, 1, 7, 8, 2, 7, 8], np.int32)
    ti = td.NGramIndex(2)
    ti.update(row, 6)
    tail = np.asarray([7, 8], np.int32)
    np.testing.assert_array_equal(ti.draft(row, 8, 3, tail=tail), [2, 7, 8])
    np.testing.assert_array_equal(
        ti.draft(row, 8, 3, tail=tail, which="prev"), [1, 7, 8])


def test_short_rows_propose_nothing():
    row = np.asarray([1, 2], np.int32)
    for mod in (td, jd):
        host = mod.NGramIndex(4)
        host.update(row, 2)
        assert not host.draft(row, 2, 3).any()
    assert not td.ngram_draft_scan(row, 2, 4, 3).any()
    with pytest.raises(ValueError, match="ngram order"):
        td.NGramIndex(0)
