"""Synthetic datasets — counterpart of ``paddle_tpu/data/datasets.py``.

The port has the reference's deterministic synthetic streams only, sample
for sample the same as the JAX package's for the same split and size
(``tests/test_torch_data.py``): ``imdb`` and ``sentiment`` (both through
``_imdb_synth``), ``mnist``, ``cifar10`` and ``uci_housing``.  Each stream's
``RandomState`` is seeded by the crc32 of its name and split, so it does
not depend on the process.

Not ported here: loading real files under a data home (``data_home``,
``data/formats.py``) and the other datasets (wmt14, movielens, imikolov,
conll05) wait for the rest of ROADMAP.md Queue 1 item 4.  So
these loaders always give the synthetic stream, where the reference's
would read real files when they are present; ``_capped``, which caps
those real-file readers, comes with them.
"""

from __future__ import annotations

import zlib
from typing import Callable, Optional

import numpy as np

__all__ = ["mnist", "cifar10", "imdb", "sentiment", "uci_housing"]


def _synth_rng(name: str, split: str) -> np.random.RandomState:
    # stable across processes (Python's hash() is randomized per process)
    return np.random.RandomState(
        zlib.crc32(f"{name}/{split}".encode()) % (2**31))


def mnist(split: str = "train", *, n: Optional[int] = None) -> Callable:
    """Yields (image [28,28,1] float in [0,1], label int): a
    class-dependent blob on noise, so the task is learnable."""

    def synth_reader():
        n_ = n if n is not None else 2048
        rng = _synth_rng("mnist", split)
        for _ in range(n_):
            label = rng.randint(0, 10)
            img = rng.rand(28, 28, 1).astype(np.float32) * 0.1
            cx, cy = 4 + 2 * (label % 5), 6 + 3 * (label // 5)
            img[cx: cx + 6, cy: cy + 6] += 0.8
            yield np.clip(img, 0, 1), label

    return synth_reader


def cifar10(split: str = "train", *, n: Optional[int] = None) -> Callable:
    """Yields (image [32,32,3] float in [0,1), label int): noise with a
    label-dependent offset on one colour channel, so the task is
    learnable."""

    def synth_reader():
        n_ = n if n is not None else 2048
        rng = _synth_rng("cifar10", split)
        for _ in range(n_):
            label = rng.randint(0, 10)
            img = rng.rand(32, 32, 3).astype(np.float32) * 0.2
            img[:, :, label % 3] += 0.3 + 0.05 * label
            yield img, label

    return synth_reader


def imdb(split: str = "train", *, vocab_size: int = 5000,
         n: Optional[int] = None) -> Callable:
    """Yields (word_ids list, label 0/1; 1 = positive) with
    sentiment-classification shapes."""
    return _imdb_synth(split, vocab_size, n if n is not None else 1024)


def _imdb_synth(split: str, vocab_size: int, n: int) -> Callable:
    """Synthetic sentiment stream shared by imdb() and sentiment()
    (label-disjoint vocab halves -> separable)."""

    def synth_reader():
        rng = _synth_rng("imdb", split)
        pos = np.arange(10, vocab_size // 2)
        neg = np.arange(vocab_size // 2, vocab_size - 10)
        for _ in range(n):
            label = rng.randint(0, 2)
            L = rng.randint(8, 120)
            vocab = pos if label else neg
            ids = rng.choice(vocab, L).tolist()
            yield ids, label

    return synth_reader


def sentiment(split: str = "train", *, vocab_size: int = 5000,
              n: Optional[int] = None) -> Callable:
    """Yields (word_ids, label 0/1): imdb's synthetic stream, as the
    reference's fallback gives."""
    return _imdb_synth(split, vocab_size, n if n is not None else 1024)


def uci_housing(split: str = "train", *, n: Optional[int] = None
                ) -> Callable:
    """Yields (features [13], price float) from a fixed random linear
    model plus noise."""

    def synth_reader():
        n_ = n if n is not None else 404
        rng = _synth_rng("uci_housing", split)
        w = rng.randn(13)
        for _ in range(n_):
            x = rng.randn(13).astype(np.float32)
            y = float(x @ w + rng.randn() * 0.1 + 22.0)
            yield x, y

    return synth_reader
