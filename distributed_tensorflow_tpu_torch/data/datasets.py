"""Data pipeline (C3) — the ``input_data.read_data_sets`` equivalent.

Copied from ``distributed_tensorflow_tpu/data/datasets.py`` (numpy and the standard library
only; the port's imports).

The reference loads MNIST into host memory and batches with a shuffled
``next_batch`` (reference ``distributed.py:6,38,137``).  Same API here:
:func:`read_data_sets` returns ``Datasets(train, validation, test)`` where each
split is a :class:`DataSet` with ``.images``, ``.labels``, ``.next_batch(n)``.

Loaders read the standard IDX files from ``data_dir`` when present; with no
files (this image has zero network egress) they fall back to a deterministic
synthetic dataset whose class structure is learnable, so convergence tests and
benchmarks behave like the real thing.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field

import numpy as np

MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


class DataSet:
    """In-memory split with shuffled ``next_batch`` (reference ``distributed.py:137``).

    ``augment_fn(images, rng) -> images`` (optional) is applied to every
    training batch after selection — host-side numpy, overlapped with device
    compute by the input prefetcher.  Eval paths read ``.images`` directly
    and stay un-augmented."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 seed: int = 0, augment_fn=None):
        assert images.shape[0] == labels.shape[0]
        self.images = images
        self.labels = labels
        self._num = images.shape[0]
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(self._num)
        self._pos = 0
        self._augment_fn = augment_fn
        self.epochs_completed = 0

    def shard(self, index: int, count: int) -> "DataSet":
        """Per-process slice for the multi-controller sharded feed: every
        ``count``-th example starting at ``index`` (strided — preserves class
        balance), with its own shuffle stream.  Processes then feed disjoint
        data; the global batch is their concatenation."""
        return DataSet(self.images[index::count], self.labels[index::count],
                       seed=self._seed * 1000 + index + 1,
                       augment_fn=self._augment_fn)

    @property
    def num_examples(self) -> int:
        return self._num

    def next_batch(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """Sequential batches over a shuffled order; reshuffles each epoch."""
        if self._pos + batch_size > self._num:
            self.epochs_completed += 1
            self._perm = self._rng.permutation(self._num)
            self._pos = 0
        idx = self._perm[self._pos:self._pos + batch_size]
        self._pos += batch_size
        images = self.images[idx]
        if self._augment_fn is not None:
            images = self._augment_fn(images, self._rng)
        return images, self.labels[idx]


@dataclass
class Datasets:
    train: DataSet
    validation: DataSet
    test: DataSet
    synthetic: bool = field(default=False)


class Uint8FeedSplit:
    """Train-feed adapter: ships images host→device as uint8 (4x fewer feed
    bytes than float32 — the production input-pipeline convention), with the
    models dividing by 255 on device (their integer-input path).

    Pixel sources here are 8-bit to begin with (MNIST IDX / CIFAR pickles,
    loaded as ``uint8/255``), so ``round(x*255)`` recovers the original
    bytes exactly; the synthetic streams lose at most 1/510 per pixel.
    Wraps ``next_batch`` only — eval paths read ``.images`` (float) directly.
    """

    def __init__(self, split: DataSet):
        self._split = split

    def next_batch(self, batch_size: int):
        images, labels = self._split.next_batch(batch_size)
        if images.dtype == np.float32:
            images = np.rint(np.clip(images, 0.0, 1.0) * 255.0).astype(
                np.uint8)
        return images, labels

    def shard(self, index: int, count: int) -> "Uint8FeedSplit":
        return Uint8FeedSplit(self._split.shard(index, count))

    def __getattr__(self, name):
        return getattr(self._split, name)


def uint8_feed(datasets: Datasets) -> Datasets:
    """Wrap the training split for uint8 host→device feeding."""
    return Datasets(train=Uint8FeedSplit(datasets.train),
                    validation=datasets.validation, test=datasets.test,
                    synthetic=datasets.synthetic)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(data_dir: str, base: str) -> str | None:
    for cand in (base, base + ".gz"):
        p = os.path.join(data_dir, cand)
        if os.path.exists(p):
            return p
    return None


def _one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], num_classes), np.float32)
    out[np.arange(labels.shape[0]), labels.astype(np.int64)] = 1.0
    return out


def synthetic_classification(num: int, dim: int, num_classes: int, *,
                             seed: int, noise: float = 0.35,
                             centers_seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable dataset: class-dependent means + gaussian noise.

    A linear/MLP model trained on this converges quickly, which is what the
    reference's convergence-as-test strategy needs (SURVEY §4).  ``centers_seed``
    fixes the class structure so differently-seeded splits (train vs test) are
    drawn from the *same* distribution.
    """
    rng = np.random.default_rng(seed)
    centers_rng = np.random.default_rng(centers_seed)
    centers = centers_rng.normal(0.5, 0.25, size=(num_classes, dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num)
    images = centers[labels] + rng.normal(0.0, noise, size=(num, dim)).astype(np.float32)
    images = np.clip(images, 0.0, 1.0).astype(np.float32)
    return images, labels


def read_data_sets(data_dir: str, one_hot: bool = True, *,
                   validation_size: int = 5000,
                   synthetic_train_size: int = 20000) -> Datasets:
    """MNIST with the reference's split shape: train/validation/test.

    Real IDX files in ``data_dir`` are used when present (images scaled to
    [0,1], labels one-hot, 5000-example validation split carved from train —
    matching the TF tutorial loader the reference calls).  Otherwise a
    deterministic synthetic stand-in with the same shapes is returned.
    """
    paths = {k: _find(data_dir, v) for k, v in MNIST_FILES.items()}
    if all(paths.values()):
        train_images = _read_idx(paths["train_images"]).reshape(-1, 784).astype(np.float32) / 255.0
        train_labels = _read_idx(paths["train_labels"])
        test_images = _read_idx(paths["test_images"]).reshape(-1, 784).astype(np.float32) / 255.0
        test_labels = _read_idx(paths["test_labels"])
        synthetic = False
    else:
        train_images, train_labels = synthetic_classification(
            synthetic_train_size + validation_size, 784, 10, seed=1234)
        test_images, test_labels = synthetic_classification(5000, 784, 10, seed=5678)
        synthetic = True

    if one_hot:
        train_labels_e = _one_hot(train_labels, 10)
        test_labels_e = _one_hot(test_labels, 10)
    else:
        train_labels_e = train_labels.astype(np.int32)
        test_labels_e = test_labels.astype(np.int32)

    val_images = train_images[:validation_size]
    val_labels = train_labels_e[:validation_size]
    trn_images = train_images[validation_size:]
    trn_labels = train_labels_e[validation_size:]

    return Datasets(
        train=DataSet(trn_images, trn_labels, seed=0),
        validation=DataSet(val_images, val_labels, seed=1),
        test=DataSet(test_images, test_labels_e, seed=2),
        synthetic=synthetic,
    )


CIFAR10_TRAIN_BATCHES = [f"data_batch_{i}" for i in range(1, 6)]
CIFAR10_TEST_BATCH = "test_batch"


def cifar_augment(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Standard CIFAR train-time augmentation: reflect-pad 4, random 32x32
    crop, random horizontal flip.  Flat [B, 3072] HWC in, same out.
    Vectorized (one gather + one flip) — this can sit on the step critical
    path when prefetch is off (multi-controller runs)."""
    B = images.shape[0]
    x = images.reshape(B, 32, 32, 3)
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    offsets = rng.integers(0, 9, size=(B, 2))
    flips = rng.random(B) < 0.5
    # windows: [B, 9, 9, 3, 32, 32] — all crop positions; one fancy-index
    # gather picks each sample's (dy, dx).
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, (32, 32), axis=(1, 2))
    out = windows[np.arange(B), offsets[:, 0], offsets[:, 1]]  # [B, 3, 32, 32]
    out = out.transpose(0, 2, 3, 1).copy()                     # [B, 32, 32, 3]
    out[flips] = out[flips, :, ::-1]
    return out.reshape(B, 3072)


def read_cifar10(data_dir: str, one_hot: bool = True, *,
                 validation_size: int = 5000,
                 synthetic_train_size: int = 20000,
                 augment: bool = False) -> Datasets:
    """CIFAR-10 (for the ResNet-20 config in BASELINE.json), pickle or synthetic.

    Images are returned flattened HWC float32 in [0,1]; models reshape to
    (32, 32, 3).
    """
    import pickle

    def find_batch(name):
        for sub in ("", "cifar-10-batches-py"):
            p = os.path.join(data_dir, sub, name)
            if os.path.exists(p):
                return p
        return None

    train_paths = [find_batch(b) for b in CIFAR10_TRAIN_BATCHES]
    test_path = find_batch(CIFAR10_TEST_BATCH)
    if all(train_paths) and test_path:
        imgs, labels = [], []
        for p in train_paths:
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(d[b"data"])
            labels.append(np.asarray(d[b"labels"]))
        train_images = np.concatenate(imgs).astype(np.float32) / 255.0
        train_labels = np.concatenate(labels)
        with open(test_path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        test_images = d[b"data"].astype(np.float32) / 255.0
        test_labels = np.asarray(d[b"labels"])
        # CHW -> HWC flat
        train_images = train_images.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).reshape(-1, 3072)
        test_images = test_images.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).reshape(-1, 3072)
        synthetic = False
    else:
        train_images, train_labels = synthetic_classification(
            synthetic_train_size + validation_size, 3072, 10, seed=4321, noise=0.25)
        test_images, test_labels = synthetic_classification(5000, 3072, 10, seed=8765, noise=0.25)
        synthetic = True

    if one_hot:
        train_labels_e = _one_hot(train_labels, 10)
        test_labels_e = _one_hot(test_labels, 10)
    else:
        train_labels_e = train_labels.astype(np.int32)
        test_labels_e = test_labels.astype(np.int32)

    if augment and synthetic:
        # The synthetic fallback's classes are iid per-pixel gaussians with
        # no spatial structure — crops/flips would just destroy the signal.
        print("WARNING: --data_augmentation disabled: no CIFAR batches under "
              f"{data_dir}; the synthetic fallback has no spatial structure "
              "to augment")
        augment = False
    return Datasets(
        train=DataSet(train_images[validation_size:],
                      train_labels_e[validation_size:], seed=0,
                      augment_fn=cifar_augment if augment else None),
        validation=DataSet(train_images[:validation_size], train_labels_e[:validation_size], seed=1),
        test=DataSet(test_images, test_labels_e, seed=2),
        synthetic=synthetic,
    )
