"""Synthetic datasets — counterpart of ``paddle_tpu/data/datasets.py``.

The port has the reference's deterministic synthetic streams only, sample
for sample the same as the JAX package's for the same split and size
(``tests/test_torch_data.py``, ``tests/test_torch_recommender.py``):
``imdb`` and ``sentiment`` (both through ``_imdb_synth``), ``mnist``,
``cifar10``, ``uci_housing``, ``conll05``/``conll05_features``,
``movielens``/``movielens_features`` (with ``ML_SCHEMA``, ml-1m's
cardinalities), ``imikolov`` and ``wmt14`` (the seqToseq demo's
stream).  Each stream's ``RandomState`` is seeded
by the crc32 of its name and split, so it does not depend on the process.

Not ported here: loading real files under a data home (``data_home``,
``data/formats.py``, wmt14's ``wmt14.tgz`` among them) waits for the rest
of ROADMAP.md Queue 1 item 4.  So
these loaders always give the synthetic stream, where the reference's
would read real files when they are present; ``_capped``, which caps
those real-file readers, comes with them.
"""

from __future__ import annotations

import zlib
from typing import Callable, Optional

import numpy as np

__all__ = ["mnist", "cifar10", "imdb", "sentiment", "uci_housing",
           "conll05", "conll05_features", "movielens", "ML_SCHEMA",
           "movielens_features", "imikolov", "wmt14"]


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


def wmt14(split: str = "train", *, dict_size: int = 30000,
          n: Optional[int] = None) -> Callable:
    """Yields (src_ids, trg_ids, trg_next_ids), the seqToseq feed format
    (wmt14 with <s>=0, <e>=1, <unk>=2): sources of 4..29 ids in
    3..dict_size-1, the target the reversed source shifted by 7 (mod
    dict_size-3), ``trg_ids`` after <s>, ``trg_next_ids`` ending in <e>."""

    def synth_reader():
        n_ = n if n is not None else 2048
        rng = _synth_rng("wmt14", split)
        for _ in range(n_):
            L = rng.randint(4, 30)
            src = rng.randint(3, dict_size, L).tolist()
            trg_core = [3 + ((s + 7) % (dict_size - 3))
                        for s in reversed(src)]
            yield src, [0] + trg_core, trg_core + [1]

    return synth_reader


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


def conll05(split: str = "train", *, vocab_size: int = 5000,
            n_labels: int = 67, n: Optional[int] = None) -> Callable:
    """Yields (word_ids, predicate_id, label_ids): semantic-role-labeling
    sequence-tagging shapes, labels of the reference's BIO scheme size (67
    classes) correlated with the distance from the predicate."""

    def synth_reader():
        n_ = n if n is not None else 1024
        rng = _synth_rng("conll05", split)
        for _ in range(n_):
            L = rng.randint(5, 40)
            words = rng.randint(2, vocab_size, L).tolist()
            pred_pos = rng.randint(0, L)
            labels = [min(n_labels - 1, abs(i - pred_pos) % n_labels)
                      for i in range(L)]
            yield words, words[pred_pos], labels

    return synth_reader


def conll05_features(split: str = "train", *, vocab_size: int = 5000,
                     n_labels: int = 67, n: Optional[int] = None
                     ) -> Callable:
    """Yields the reference's 9-slot SRL rows: words, the predicate
    window's five words (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2) each
    repeated per token, the predicate repeated, the mark (1 at the
    predicate) and the labels."""

    def synth_reader():
        n_ = n if n is not None else 1024
        rng = _synth_rng("conll05_features", split)
        for _ in range(n_):
            L = rng.randint(5, 40)
            words = rng.randint(2, vocab_size, L).tolist()
            p = rng.randint(0, L)

            def at(i):
                return words[min(max(i, 0), L - 1)]

            ctx = {d: [at(p + d)] * L for d in (-2, -1, 0, 1, 2)}
            verb = [words[p]] * L
            mark = [1 if i == p else 0 for i in range(L)]
            labels = [min(n_labels - 1, abs(i - p) % n_labels)
                      for i in range(L)]
            yield (words, ctx[-2], ctx[-1], ctx[0], ctx[1], ctx[2], verb,
                   mark, labels)

    return synth_reader


def movielens(split: str = "train", *, n_users: int = 6040,
              n_movies: int = 3952, n: Optional[int] = None) -> Callable:
    """Yields (user_id, movie_id, rating float in [1, 5]) with 0-based ids:
    a rating from user and movie biases and latent vectors, plus noise."""

    def synth_reader():
        n_ = n if n is not None else 4096
        rng = _synth_rng("movielens", split)
        u_bias = rng.randn(n_users) * 0.5
        m_bias = rng.randn(n_movies) * 0.5
        u_vec = rng.randn(n_users, 8)
        m_vec = rng.randn(n_movies, 8)
        for _ in range(n_):
            u = rng.randint(0, n_users)
            m = rng.randint(0, n_movies)
            r = 3.0 + u_bias[u] + m_bias[m] + 0.3 * float(u_vec[u] @ m_vec[m])
            yield u, m, float(np.clip(r + rng.randn() * 0.2, 1.0, 5.0))

    return synth_reader


#: ml-1m's cardinalities (the reference's movielens.py: 6040 users, 3952
#: movie-id slots, 7 age buckets, 21 jobs, 18 categories, ~5175 title words)
ML_SCHEMA = dict(n_users=6040, n_movies=3952, n_genders=2, n_ages=7,
                 n_jobs=21, n_categories=18, title_dict=5175)


def movielens_features(split: str = "train", *, n: Optional[int] = None
                       ) -> Callable:
    """Yields the reference MovieLens demo's 8-slot rows: (user_id,
    gender_id, age_id, job_id, movie_id, category_ids list, title_ids list,
    [score]), at ``ML_SCHEMA``'s cardinalities; the rating follows latent
    user/movie vectors and a genre affinity, so every feature informs."""
    S = ML_SCHEMA

    def synth_reader():
        n_ = n if n is not None else 4096
        rng = _synth_rng("movielens_features", split)
        nu, nm = S["n_users"], S["n_movies"]
        u_vec = rng.randn(nu, 8)
        m_vec = rng.randn(nm, 8)
        u_meta = np.stack([rng.randint(0, S["n_genders"], nu),
                           rng.randint(0, S["n_ages"], nu),
                           rng.randint(0, S["n_jobs"], nu)], 1)
        genre_aff = rng.randn(S["n_genders"], S["n_categories"]) * 0.3
        for _ in range(n_):
            u = rng.randint(0, nu)
            m = rng.randint(0, nm)
            cats = sorted(rng.choice(S["n_categories"],
                                     size=rng.randint(1, 4), replace=False))
            title = rng.randint(3, S["title_dict"],
                                rng.randint(2, 9)).tolist()
            g = u_meta[u, 0]
            r = (3.0 + 0.4 * float(u_vec[u] @ m_vec[m])
                 + float(np.mean(genre_aff[g, cats])))
            score = float(np.clip(r + rng.randn() * 0.2, 1.0, 5.0))
            yield (int(u), int(g), int(u_meta[u, 1]), int(u_meta[u, 2]),
                   int(m), [int(c) for c in cats], title, [score])

    return synth_reader


def imikolov(split: str = "train", *, vocab_size: int = 2000, ngram: int = 5,
             n: Optional[int] = None) -> Callable:
    """Yields n-gram tuples (w0, ..., w{n-2}, next_word), the word2vec /
    n-gram LM feed: a bigram chain in which each word prefers four
    successors, so the embeddings have co-occurrence to learn."""

    def synth_reader():
        n_ = n if n is not None else 4096
        rng = _synth_rng("imikolov", split)
        succ = rng.randint(0, vocab_size, (vocab_size, 4))
        w = rng.randint(0, vocab_size)
        for _ in range(n_):
            ctx = []
            for _ in range(ngram):
                w = (int(succ[w, rng.randint(0, 4)]) if rng.rand() < 0.8
                     else rng.randint(0, vocab_size))
                ctx.append(w)
            yield tuple(ctx[:-1]) + (ctx[-1],)

    return synth_reader
