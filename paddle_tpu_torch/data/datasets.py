"""Dataset loaders — counterpart of ``paddle_tpu/data/datasets.py``.

Each loader (a) parses a local copy of the REAL files under
``data_home()`` (``$PADDLE_TPU_DATA_HOME``, read on each call, default
``~/.cache/paddle_tpu``) when they are present, through the format parsers
of ``data/formats.py`` (expected paths in each loader's docstring), else
(b) gives the reference's deterministic synthetic stream, sample for
sample the same as the JAX package's for the same split and size
(``tests/test_torch_data.py``, ``tests/test_torch_recommender.py``):
``imdb`` and ``sentiment`` (both through ``_imdb_synth``), ``mnist``,
``cifar10``, ``uci_housing``, ``conll05``/``conll05_features``,
``movielens``/``movielens_features`` (with ``ML_SCHEMA``, ml-1m's
cardinalities), ``imikolov`` and ``wmt14`` (the seqToseq demo's stream).
Each synthetic stream's ``RandomState`` is seeded by the crc32 of its name
and split, so it does not depend on the process.  The same real file gives
the same rows through either package (``tests/test_torch_real_data.py``).
An explicit ``n=`` caps a real stream too (``_capped``).
"""

from __future__ import annotations

import itertools
import os
import struct
import zlib
from typing import Callable, Optional

import numpy as np

from paddle_tpu_torch.data import formats

__all__ = ["mnist", "cifar10", "imdb", "sentiment", "uci_housing",
           "conll05", "conll05_features", "movielens", "ML_SCHEMA",
           "movielens_features", "imikolov", "wmt14", "data_home"]


def data_home() -> str:
    """``$PADDLE_TPU_DATA_HOME``, read on each call (tests repoint it)."""
    return os.environ.get("PADDLE_TPU_DATA_HOME",
                          os.path.expanduser("~/.cache/paddle_tpu"))


def _real(*parts: str) -> Optional[str]:
    """Path under ``data_home()`` if it exists, else None."""
    p = os.path.join(data_home(), *parts)
    return p if os.path.exists(p) else None


_DICT_CACHE: dict = {}


def _cached(key, build):
    """Per-process cache for parsed dicts and metadata.  Each path element
    of the key that names a file is keyed with its (mtime, size) too, so a
    dataset file replaced in the process is parsed again."""
    key = tuple(
        (k, os.path.getmtime(k), os.path.getsize(k))
        if isinstance(k, str) and os.path.isfile(k) else k
        for k in (key if isinstance(key, tuple) else (key,)))
    if key not in _DICT_CACHE:
        _DICT_CACHE[key] = build()
    return _DICT_CACHE[key]


def _capped(reader_fn: Callable, n: Optional[int]) -> Callable:
    """Cap a real-data reader at ``n`` samples when a size was asked for
    (``n=None``: the whole dataset), so n-bounded callers stay bounded
    when real files are present."""
    if n is None:
        return reader_fn

    def capped():
        return itertools.islice(reader_fn(), n)

    return capped


def _synth_rng(name: str, split: str) -> np.random.RandomState:
    # stable across processes (Python's hash() is randomized per process)
    return np.random.RandomState(
        zlib.crc32(f"{name}/{split}".encode()) % (2**31))


def mnist(split: str = "train", *, n: Optional[int] = None) -> Callable:
    """Yields (image [28,28,1] float in [0,1], label int).  Real data: the
    idx files under ``data_home()/mnist/`` (``t10k-*`` for the test
    split); else a class-dependent blob on noise, so the task is
    learnable."""
    d = os.path.join(data_home(), "mnist")
    stem = "t10k" if split == "test" else split
    img_f = os.path.join(d, f"{stem}-images-idx3-ubyte")
    lab_f = os.path.join(d, f"{stem}-labels-idx1-ubyte")
    if os.path.exists(img_f) and os.path.exists(lab_f):

        def real_reader():
            with open(img_f, "rb") as f:
                _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                imgs = np.frombuffer(f.read(), np.uint8).reshape(
                    num, rows, cols, 1)
            with open(lab_f, "rb") as f:
                f.read(8)
                labs = np.frombuffer(f.read(), np.uint8)
            for i in range(num):
                yield imgs[i].astype(np.float32) / 255.0, int(labs[i])

        return _capped(real_reader, n)

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
    """Yields (image [32,32,3] float in [0,1), label int).  Real data:
    ``data_home()/cifar/cifar-10-python.tar.gz`` (the pickle tarball,
    reference cifar.py:46-64); else noise with a label-dependent offset on
    one colour channel, so the task is learnable."""
    tar = _real("cifar", "cifar-10-python.tar.gz")
    if tar:
        sub = "data_batch" if split == "train" else "test_batch"
        return _capped(lambda: formats.iter_cifar_tar(tar, sub), n)

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
    sentiment-classification shapes.  Real data:
    ``data_home()/imdb/aclImdb_v1.tar.gz`` (reference imdb.py:37-75); the
    word dict is built from the train split, the top ``vocab_size - 1``
    words and ``<unk>``."""
    tar = _real("imdb", "aclImdb_v1.tar.gz")
    if tar:
        word_idx = _cached(("imdb", tar, vocab_size),
                           lambda: formats.imdb_word_dict(tar, vocab_size))
        return _capped(lambda: formats.iter_imdb(tar, split, word_idx), n)
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
    """Yields (word_ids, label 0/1; 1 = positive), the demo/sentiment feed.
    Real data: ``data_home()/sentiment/movie_reviews/{pos,neg}/*.txt`` (the
    unpacked NLTK corpus); else imdb's SYNTHETIC stream, as the reference's
    fallback gives (never real aclImdb, a different corpus)."""
    d = _real("sentiment", "movie_reviews")
    if d:
        word_idx = _cached(("sentiment", d, vocab_size),
                           lambda: formats.movie_reviews_word_dict(
                               d, vocab_size))
        return _capped(
            lambda: formats.iter_movie_reviews(d, split, word_idx), n)
    return _imdb_synth(split, vocab_size, n if n is not None else 1024)


def wmt14(split: str = "train", *, dict_size: int = 30000,
          n: Optional[int] = None) -> Callable:
    """Yields (src_ids, trg_ids, trg_next_ids), the seqToseq feed format
    (wmt14 with <s>=0, <e>=1, <unk>=2): sources of 4..29 ids in
    3..dict_size-1, the target the reversed source shifted by 7 (mod
    dict_size-3), ``trg_ids`` after <s>, ``trg_next_ids`` ending in <e>.
    Real data: ``data_home()/wmt14/wmt14.tgz`` (src.dict/trg.dict and the
    tab-separated pairs of train/train and test/test, reference
    wmt14.py:45-102; sides over 80 tokens dropped)."""
    tgz = _real("wmt14", "wmt14.tgz")
    if tgz:
        suffix = "train/train" if split == "train" else "test/test"
        dicts = _cached(("wmt14", tgz, dict_size),
                        lambda: formats.wmt14_dicts(tgz, dict_size))
        return _capped(lambda: formats.iter_wmt14(tgz, suffix, dict_size,
                                                  dicts=dicts), n)

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
    """Yields (features [13], price float).  Real data:
    ``data_home()/uci_housing/housing.data`` (whitespace table, features
    normalised by (x - mean) / (max - min), an 80/20 head/tail split,
    reference uci_housing.py:57-71); else a fixed random linear model plus
    noise."""
    f = _real("uci_housing", "housing.data")
    if f:

        def real_reader():
            train, test = _cached(("uci_housing", f),
                                  lambda: formats.load_uci_housing(f))
            for row in (train if split == "train" else test):
                yield row[:13].astype(np.float32), float(row[13])

        return _capped(real_reader, n)

    def synth_reader():
        n_ = n if n is not None else 404
        rng = _synth_rng("uci_housing", split)
        w = rng.randn(13)
        for _ in range(n_):
            x = rng.randn(13).astype(np.float32)
            y = float(x @ w + rng.randn() * 0.1 + 22.0)
            yield x, y

    return synth_reader


def _conll05_real(vocab_size: int, n_labels: int, *, features: bool):
    """The real-file reader of conll05/conll05_features, or None.  The
    public CoNLL-05 release is the WSJ test set only (reference
    conll05.py:17-20), so every split serves it."""
    tar = _real("conll05st", "conll05st-tests.tar.gz")
    dicts = [_real("conll05st", f) for f in
             ("wordDict.txt", "verbDict.txt", "targetDict.txt")]
    if not tar or not all(dicts):
        return None
    wd, vd, ld = (_cached(("conll05", p),
                          lambda p=p: formats.load_dict_file(p))
                  for p in dicts)
    if len(ld) > n_labels:
        raise ValueError(
            f"conll05: targetDict.txt has {len(ld)} labels but the model is "
            f"sized for n_labels={n_labels}; pass n_labels={len(ld)}")

    def clamp(ids):  # keep ids valid for vocab_size-sized embeddings
        return [i if i < vocab_size else 0 for i in ids]

    def reader():
        for row in formats.iter_conll05(tar, wd, vd, ld, features=features):
            if features:
                w, c2, c1, c0, p1, p2, verb, mark, lab = row
                yield (clamp(w), clamp(c2), clamp(c1), clamp(c0), clamp(p1),
                       clamp(p2), clamp(verb), mark, lab)
            else:
                w, verb, lab = row
                yield clamp(w), (verb if verb < vocab_size else 0), lab

    return reader


def conll05(split: str = "train", *, vocab_size: int = 5000,
            n_labels: int = 67, n: Optional[int] = None) -> Callable:
    """Yields (word_ids, predicate_id, label_ids): semantic-role-labeling
    sequence-tagging shapes, labels of the reference's BIO scheme size (67
    classes) correlated with the distance from the predicate.  Real data
    under ``data_home()/conll05st/``: conll05st-tests.tar.gz and
    wordDict.txt/verbDict.txt/targetDict.txt; ids at or past
    ``vocab_size`` clamp to UNK (0)."""
    r = _conll05_real(vocab_size, n_labels, features=False)
    if r:
        return _capped(r, n)

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
    predicate) and the labels.  Real data: the files of ``conll05``."""
    r = _conll05_real(vocab_size, n_labels, features=True)
    if r:
        return _capped(r, n)

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
    """Yields (user_id, movie_id, rating float in [1, 5]) with 0-based ids.
    Real data: ``data_home()/movielens/ml-1m.zip`` (reference
    movielens.py:60-160, ids made 0-based, the raw 1-5 rating); real rows
    whose ids reach ``n_users``/``n_movies`` are left out, as an
    out-of-range id would reach an embedding gather.  Else a rating from
    user and movie biases and latent vectors, plus noise."""
    z = _real("movielens", "ml-1m.zip")
    if z:

        def real_reader():
            for u, m, r in formats.iter_movielens(z, split, features=False):
                if u < n_users and m < n_movies:
                    yield u, m, r

        return _capped(real_reader, n)

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
    user/movie vectors and a genre affinity, so every feature informs.
    Real data: ``data_home()/movielens/ml-1m.zip``, title ids capped at
    ``ML_SCHEMA['title_dict']`` (see ``movielens``)."""
    S = ML_SCHEMA
    z = _real("movielens", "ml-1m.zip")
    if z:
        meta = _cached(("movielens", z, S["title_dict"]),
                       lambda: formats.movielens_meta(
                           z, title_vocab_cap=S["title_dict"]))
        return _capped(lambda: formats.iter_movielens(
            z, split, features=True, title_vocab_cap=S["title_dict"],
            meta=meta), n)

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
    successors, so the embeddings have co-occurrence to learn.  Real data:
    ``data_home()/imikolov/simple-examples.tgz`` (PTB, reference
    imikolov.py:30-88; 'test' reads ptb.valid.txt as the reference does)."""
    tgz = _real("imikolov", "simple-examples.tgz")
    if tgz:
        word_idx = _cached(("imikolov", tgz, vocab_size),
                           lambda: formats.imikolov_word_dict(tgz,
                                                              vocab_size))
        return _capped(
            lambda: formats.iter_imikolov(tgz, split, word_idx, ngram), n)

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
