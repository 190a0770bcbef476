"""Synthetic MLM data streams for the BERT-tiny config (``BASELINE.json``
#5); the counterpart of ``distributed_tensorflow_tpu/data/mlm.py``.

No tokenizer or corpus ships with the repo, so the streams generate
deterministic position-dependent sequences
(:func:`..models.bert.synthetic_mlm_batch`, the JAX package's draw) that
an MLM objective can learn.  A stream has the ``DataSet`` batch API
(``next_batch``, ``shard``), so the training loop treats it like any
split, and the JAX package's seeds, so both packages feed the same
batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class MlmStream:
    """Batch stream with ``next_batch``; each call advances the sample
    seed."""

    def __init__(self, cfg, seq_len: int, seed: int):
        self.cfg = cfg
        self.seq_len = seq_len
        self._seed0 = seed
        self._seed = seed

    def next_batch(self, batch_size: int) -> dict:
        from ..models.bert import synthetic_mlm_batch
        batch = synthetic_mlm_batch(self._seed, batch_size, self.seq_len,
                                    self.cfg)
        self._seed += 1
        return batch

    def shard(self, index: int, count: int) -> "MlmStream":
        """Disjoint per-process stream (a sync worker's share of the
        global batch)."""
        del count
        return MlmStream(self.cfg, self.seq_len,
                         self._seed + (index + 1) * 1_000_003)

    def fixed_batches(self, batch_size: int, num_batches: int) -> list[dict]:
        """Deterministic eval batches, stable per split (keyed off the
        split's base seed, so validation and test evaluate different
        sequences)."""
        from ..models.bert import synthetic_mlm_batch
        return [synthetic_mlm_batch(10_000_000 + self._seed0 + i,
                                    batch_size, self.seq_len, self.cfg)
                for i in range(num_batches)]


@dataclass
class MlmDatasets:
    train: MlmStream
    validation: MlmStream
    test: MlmStream
    synthetic: bool = True


def make_mlm_datasets(cfg, seq_len: int = 128) -> MlmDatasets:
    return MlmDatasets(
        train=MlmStream(cfg, seq_len, seed=0),
        validation=MlmStream(cfg, seq_len, seed=5_000_000),
        test=MlmStream(cfg, seq_len, seed=6_000_000),
    )


def make_mlm_eval_fn(logits_fn, batch_size: int = 32, num_batches: int = 4):
    """Masked-position accuracy over fixed batches of a stream split.

    ``logits_fn(model, input_ids, attention_mask) -> logits``.  Returns
    ``evaluate(state, split) -> float``, the loop's ``eval_fn``; the model
    runs in ``eval()`` mode without gradients on its own device."""

    @torch.no_grad()
    def evaluate(state, split) -> float:
        model = state.model
        device = next(model.parameters()).device
        was_training = model.training
        model.eval()
        num, den = 0.0, 0.0
        try:
            for batch in split.fixed_batches(batch_size, num_batches):
                ids = torch.from_numpy(np.asarray(batch["input_ids"])).to(
                    device)
                mask = torch.from_numpy(np.asarray(
                    batch["attention_mask"])).to(device)
                labels = torch.from_numpy(np.asarray(batch["labels"])).to(
                    device)
                w = torch.from_numpy(np.asarray(batch["label_weights"])).to(
                    device)
                logits = logits_fn(model, ids, mask)
                correct = (logits.argmax(-1) == labels.long()).float()
                num += float((correct * w).sum())
                den += float(w.sum())
        finally:
            model.train(was_training)
        return num / max(den, 1.0)

    return evaluate
