"""Real dataset file-format parsers behind ``$PADDLE_TPU_DATA_HOME`` — the
port's own copy of the framework-free ``paddle_tpu/data/formats.py``,
parser for parser, so the same file gives the same rows through either
package (``tests/test_torch_real_data.py``).

Each function parses the on-disk format the reference's auto-downloading
loaders consume (python/paddle/v2/dataset/*.py); `datasets.py` dispatches to
these when the files are present and falls back to synthetic generators
otherwise.  Formats covered:

- CIFAR python pickle tarballs (reference cifar.py:46-64)
- aclImdb review tarball + ad-hoc tokenization (reference imdb.py:37-75)
- WMT14 shrunk tgz with src/trg dicts (reference wmt14.py:45-102)
- MovieLens ml-1m zip: users/movies/ratings .dat (reference
  movielens.py:60-160)
- UCI housing.data whitespace table + normalization (reference
  uci_housing.py:57-71)
- PTB (imikolov) simple-examples tgz (reference imikolov.py:30-88)
- CoNLL-05 words/props gz pair inside the test tarball, bracket tags
  expanded to BIO (reference conll05.py:52-178)
- NLTK movie_reviews corpus directory (reference sentiment.py:36-110)

All readers are plain Python generators over host data — batching/padding
happens downstream in DataFeeder, and the copy to the card in the trainer.
"""

from __future__ import annotations

import gzip
import os
import pickle
import random
import re
import string
import tarfile
import zipfile
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "iter_cifar_tar", "imdb_word_dict", "iter_imdb", "wmt14_dicts",
    "iter_wmt14", "movielens_meta", "iter_movielens", "load_uci_housing",
    "imikolov_word_dict", "iter_imikolov", "load_dict_file", "iter_conll05",
    "movie_reviews_word_dict", "iter_movie_reviews",
]


# ---------------------------------------------------------------------------
# CIFAR (reference cifar.py:46-64: pickled batches inside a tarball, rows are
# 3072 uint8 in CHW plane order, labels under 'labels' or 'fine_labels')
# ---------------------------------------------------------------------------


def iter_cifar_tar(path: str, sub_name: str) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (image [32,32,3] float32 in [0,1], label) from every member of
    the pickle tarball whose name contains ``sub_name`` ('data_batch' for
    cifar-10 train, 'test_batch' for test, 'train'/'test' for cifar-100)."""
    with tarfile.open(path, mode="r") as tf:
        for member in tf:
            if sub_name not in member.name or not member.isfile():
                continue
            batch = pickle.load(tf.extractfile(member), encoding="bytes")
            data = batch[b"data"]
            labels = batch.get(b"labels", batch.get(b"fine_labels"))
            for row, lab in zip(data, labels):
                img = np.asarray(row, np.uint8).reshape(3, 32, 32)
                yield img.transpose(1, 2, 0).astype(np.float32) / 255.0, int(lab)


# ---------------------------------------------------------------------------
# IMDB (reference imdb.py:37-75: aclImdb_v1.tar.gz members
# aclImdb/<split>/<pos|neg>/*.txt; tokenization = strip punctuation, lower,
# whitespace split; dict sorted by (-freq, word), <unk> last)
# ---------------------------------------------------------------------------

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def _iter_imdb_docs(tar_path: str, pattern: re.Pattern):
    """Yield (match, tokens) for members matching ``pattern`` — ONE
    sequential decompress scan; tokenization lives here and only here."""
    with tarfile.open(tar_path, mode="r") as tf:
        member = tf.next()  # sequential scan: the tarball is ~80k tiny files
        while member is not None:
            m = pattern.match(member.name) if member.isfile() else None
            if m:
                raw = tf.extractfile(member).read().decode("utf-8", "replace")
                yield m, raw.rstrip("\n\r").translate(_PUNCT_TABLE).lower().split()
            member = tf.next()


def imdb_word_dict(tar_path: str, vocab_size: int) -> Dict[str, int]:
    """Frequency dict over the train split (pos+neg), top ``vocab_size - 1``
    words by (-freq, word), '<unk>' last — the build_dict shape with the
    cutoff expressed as a vocab cap."""
    freq: Dict[str, int] = defaultdict(int)
    pat = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
    for _, doc in _iter_imdb_docs(tar_path, pat):
        for w in doc:
            freq[w] += 1
    ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ranked[: vocab_size - 1])}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def iter_imdb(tar_path: str, split: str,
              word_idx: Dict[str, int]) -> Iterator[Tuple[List[int], int]]:
    """Yield (word_ids, label) with label 1 = positive, ALTERNATING classes
    like the reference's queue-based cross-read (imdb.py:77-110) — vital
    because the tarball stores each class contiguously, so a head-slice of
    archive order (e.g. an ``n=`` cap) would otherwise be single-label.
    One sequential decompress scan; the leading class buffers in memory
    until the other starts (~12.5k docs worst case)."""
    from collections import deque

    unk = word_idx["<unk>"]
    pat = re.compile(rf"aclImdb/{split}/(pos|neg)/.*\.txt$")
    queues = {0: deque(), 1: deque()}
    want = 1  # pos first, then strict alternation while both classes flow
    for m, doc in _iter_imdb_docs(tar_path, pat):
        queues[1 if m.group(1) == "pos" else 0].append(
            [word_idx.get(w, unk) for w in doc])
        while queues[want]:
            yield queues[want].popleft(), want
            want = 1 - want
    while queues[0] or queues[1]:  # unbalanced tail drains every other turn
        if queues[want]:
            yield queues[want].popleft(), want
        want = 1 - want


# ---------------------------------------------------------------------------
# WMT14 (reference wmt14.py:45-102: tgz holding *src.dict / *trg.dict —
# one token per line, id = line number — and train/train, test/test files of
# 'src sentence<TAB>trg sentence' lines; <s>=0 <e>=1 <unk>=2; pairs longer
# than 80 tokens are dropped)
# ---------------------------------------------------------------------------

WMT_START, WMT_END, WMT_UNK_IDX = "<s>", "<e>", 2


def _dict_from_lines(fd, size: int) -> Dict[str, int]:
    d: Dict[str, int] = {}
    for i, line in enumerate(fd):
        if i >= size:
            break
        d[line.decode("utf-8", "replace").strip()] = i
    return d


def wmt14_dicts(tgz_path: str, dict_size: int):
    """(src_dict, trg_dict): first ``dict_size`` lines of the *.dict members."""
    src_dict = trg_dict = None
    with tarfile.open(tgz_path, mode="r") as tf:
        for member in tf:
            if member.name.endswith("src.dict"):
                src_dict = _dict_from_lines(tf.extractfile(member), dict_size)
            elif member.name.endswith("trg.dict"):
                trg_dict = _dict_from_lines(tf.extractfile(member), dict_size)
    if src_dict is None or trg_dict is None:
        raise ValueError(f"{tgz_path}: no src.dict/trg.dict members")
    return src_dict, trg_dict


def iter_wmt14(tgz_path: str, member_suffix: str, dict_size: int,
               dicts=None) -> Iterator[Tuple[List[int], List[int], List[int]]]:
    """Yield (src_ids, trg_in, trg_next): src wrapped in <s>..</e>, target
    teacher-forced pair ([<s>]+trg, trg+[<e>]); >80-token sides dropped.
    Pass pre-parsed ``dicts`` to avoid re-scanning the tgz every epoch."""
    src_dict, trg_dict = dicts or wmt14_dicts(tgz_path, dict_size)
    with tarfile.open(tgz_path, mode="r") as tf:
        for member in tf:
            if not member.name.endswith(member_suffix) or not member.isfile():
                continue
            for raw in tf.extractfile(member):
                parts = raw.decode("utf-8", "replace").strip().split("\t")
                if len(parts) != 2:
                    continue
                src_ids = [src_dict.get(w, WMT_UNK_IDX)
                           for w in [WMT_START] + parts[0].split() + [WMT_END]]
                trg_core = [trg_dict.get(w, WMT_UNK_IDX)
                            for w in parts[1].split()]
                if len(src_ids) > 80 or len(trg_core) > 80:
                    continue
                yield (src_ids, [trg_dict[WMT_START]] + trg_core,
                       trg_core + [trg_dict[WMT_END]])


# ---------------------------------------------------------------------------
# MovieLens ml-1m (reference movielens.py:60-160: zip with '::'-separated
# users.dat / movies.dat / ratings.dat; ages bucketed by age_table; title
# year suffix '(1995)' stripped; deterministic 10% test split via
# random.Random(0) over rating lines)
# ---------------------------------------------------------------------------

ML_AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]


def movielens_meta(zip_path: str, *, title_vocab_cap: Optional[int] = None):
    """Parse users.dat + movies.dat.  Returns (users, movies) where
    ``users[uid] = (gender_id, age_bucket, job_id)`` and ``movies[mid] =
    (category_ids, title_word_ids)``.  Category/title vocabularies are
    SORTED for determinism (the reference relies on set iteration order);
    title ids beyond ``title_vocab_cap - 1`` clamp to the last id (unk)."""
    year_pat = re.compile(r"^(.*)\((\d+)\)$")
    users: Dict[int, Tuple[int, int, int]] = {}
    raw_movies: Dict[int, Tuple[List[str], List[str]]] = {}
    cat_set, title_set = set(), set()
    with zipfile.ZipFile(zip_path) as z:
        with z.open("ml-1m/users.dat") as f:
            for raw in f:
                uid, gender, age, job, _zip = (
                    raw.decode("latin-1").strip().split("::"))
                users[int(uid)] = (0 if gender == "M" else 1,
                                   ML_AGE_TABLE.index(int(age)), int(job))
        with z.open("ml-1m/movies.dat") as f:
            for raw in f:
                mid, title, cats = raw.decode("latin-1").strip().split("::")
                cat_list = cats.split("|")
                m = year_pat.match(title)
                title_words = (m.group(1) if m else title).lower().split()
                raw_movies[int(mid)] = (cat_list, title_words)
                cat_set.update(cat_list)
                title_set.update(title_words)
    cat_dict = {c: i for i, c in enumerate(sorted(cat_set))}
    title_dict = {w: i for i, w in enumerate(sorted(title_set))}
    cap = title_vocab_cap
    movies = {}
    for mid, (cat_list, title_words) in raw_movies.items():
        tids = [title_dict[w] for w in title_words]
        if cap is not None:
            tids = [min(t, cap - 1) for t in tids]
        movies[mid] = ([cat_dict[c] for c in cat_list], tids)
    return users, movies


def iter_movielens(zip_path: str, split: str, *, features: bool,
                   title_vocab_cap: Optional[int] = None,
                   test_ratio: float = 0.1, rand_seed: int = 0, meta=None):
    """Yield rating rows with the reference's deterministic split (one
    random.Random(rand_seed) draw per ratings.dat line; draw < ratio selects
    test).  ``features=False``: (uid0, mid0, rating) with 0-BASED ids and the
    raw 1-5 rating (this repo's convention — the reference keeps 1-based ids
    and rescales rating to 2r-5).  ``features=True``: the 8-slot demo row
    (uid0, gender, age_bucket, job, mid0, category_ids, title_ids,
    [rating]).  ``meta`` = pre-parsed (users, movies) to skip re-reading
    users.dat/movies.dat every epoch; not read at all when features=False."""
    if features:
        users, movies = meta or movielens_meta(
            zip_path, title_vocab_cap=title_vocab_cap)
    rand = random.Random(rand_seed)
    is_test = split != "train"
    with zipfile.ZipFile(zip_path) as z:
        with z.open("ml-1m/ratings.dat") as f:
            for raw in f:
                take = rand.random() < test_ratio
                if take != is_test:
                    continue
                uid, mid, rating, _ts = raw.decode("latin-1").strip().split("::")
                uid, mid, rating = int(uid), int(mid), float(rating)
                if features:
                    g, a, j = users[uid]
                    cat_ids, title_ids = movies[mid]
                    yield (uid - 1, g, a, j, mid - 1, cat_ids, title_ids,
                           [rating])
                else:
                    yield uid - 1, mid - 1, rating


# ---------------------------------------------------------------------------
# UCI housing (reference uci_housing.py:57-71: whitespace-separated floats,
# 14 per row; first 13 columns normalized by (x - mean) / (max - min);
# 80/20 head/tail split)
# ---------------------------------------------------------------------------


def load_uci_housing(path: str, *, feature_num: int = 14, ratio: float = 0.8):
    """(train [N,14], test [M,14]) — 13 normalized features + raw price."""
    data = np.fromfile(path, sep=" ", dtype=np.float64)
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maxs, mins, avgs = data.max(0), data.min(0), data.mean(0)
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
    offset = int(data.shape[0] * ratio)
    return data[:offset], data[offset:]


# ---------------------------------------------------------------------------
# PTB / imikolov (reference imikolov.py:30-88: simple-examples.tgz with
# data/ptb.{train,valid}.txt; dict over train+valid sorted by (-freq, word)
# with <unk> last; n-gram sliding windows over <s> words... <e>)
# ---------------------------------------------------------------------------


def _ptb_member(tf: tarfile.TarFile, split: str):
    fname = {"train": "ptb.train.txt", "test": "ptb.valid.txt"}[split]
    for member in tf:
        if member.name.endswith(f"data/{fname}"):
            return tf.extractfile(member)
    raise ValueError(f"no data/{fname} member in the PTB tarball")


def imikolov_word_dict(tgz_path: str, vocab_size: int) -> Dict[str, int]:
    """Top ``vocab_size - 1`` words by (-freq, word) over train+valid
    (counting one <s>/<e> per line, excluding the corpus '<unk>'), then
    '<unk>' last — the reference's cutoff-based dict with a size cap."""
    freq: Dict[str, int] = defaultdict(int)
    with tarfile.open(tgz_path, mode="r") as tf:
        for split in ("train", "test"):
            for raw in _ptb_member(tf, split):
                for w in raw.decode("utf-8", "replace").strip().split():
                    freq[w] += 1
                freq["<s>"] += 1
                freq["<e>"] += 1
    freq.pop("<unk>", None)
    ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ranked[: vocab_size - 1])}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def iter_imikolov(tgz_path: str, split: str, word_idx: Dict[str, int],
                  n: int) -> Iterator[Tuple[int, ...]]:
    """Yield n-gram id tuples from sliding windows over <s> w1..wk <e>."""
    unk = word_idx["<unk>"]
    with tarfile.open(tgz_path, mode="r") as tf:
        for raw in _ptb_member(tf, split):
            toks = ["<s>"] + raw.decode("utf-8", "replace").strip().split() + ["<e>"]
            if len(toks) < n:
                continue
            ids = [word_idx.get(w, unk) for w in toks]
            for i in range(n, len(ids) + 1):
                yield tuple(ids[i - n: i])


# ---------------------------------------------------------------------------
# CoNLL-05 (reference conll05.py:52-178: tarball with
# .../words/test.wsj.words.gz (one token per line, blank line = sentence
# break) and .../props/test.wsj.props.gz (lemma column + one bracket-tag
# column per predicate); bracket tags expand to BIO; dicts are plain
# token-per-line files)
# ---------------------------------------------------------------------------


def load_dict_file(path: str) -> Dict[str, int]:
    """token -> line number (wordDict/verbDict/targetDict format)."""
    d: Dict[str, int] = {}
    with open(path, "r") as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _bio_from_brackets(tags: List[str]) -> List[str]:
    """'(A0*', '*', '*)' bracket spans -> B-A0/I-A0/O (reference
    conll05.py:90-108 semantics)."""
    out, cur, inside = [], "O", False
    for t in tags:
        if t == "*":
            out.append("I-" + cur if inside else "O")
        elif t == "*)":
            out.append("I-" + cur)
            inside = False
        elif "(" in t and ")" in t:
            cur = t[1: t.find("*")]
            out.append("B-" + cur)
            inside = False
        elif "(" in t:
            cur = t[1: t.find("*")]
            out.append("B-" + cur)
            inside = True
        else:
            raise ValueError(f"unexpected props tag {t!r}")
    return out


def _iter_conll05_sentences(tar_path: str):
    """Yield (words, verb_lemma, bio_tags) per predicate per sentence."""
    with tarfile.open(tar_path, mode="r") as tf:
        words_m = props_m = None
        for member in tf:
            if member.name.endswith(".words.gz"):
                words_m = member
            elif member.name.endswith(".props.gz"):
                props_m = member
        if words_m is None or props_m is None:
            raise ValueError(f"{tar_path}: missing words/props members")
        with gzip.GzipFile(fileobj=tf.extractfile(words_m)) as wf, \
                gzip.GzipFile(fileobj=tf.extractfile(props_m)) as pf:
            import itertools

            words: List[str] = []
            rows: List[List[str]] = []

            def flush():
                lemmas = [r[0] for r in rows]
                verbs = [l for l in lemmas if l != "-"]
                n_pred = len(rows[0]) - 1
                for p in range(n_pred):
                    tags = [r[1 + p] for r in rows]
                    yield words, verbs[p], _bio_from_brackets(tags)

            for wraw, praw in itertools.zip_longest(wf, pf):
                if wraw is None or praw is None:
                    raise ValueError(
                        f"{tar_path}: words/props line counts differ — "
                        "corrupt or mismatched corpus files")
                word = wraw.decode("utf-8", "replace").strip()
                cols = praw.decode("utf-8", "replace").strip().split()
                if not cols:  # sentence boundary
                    if rows:
                        yield from flush()
                    words, rows = [], []
                else:
                    words.append(word)
                    rows.append(cols)
            if rows:  # final sentence without a trailing blank line
                yield from flush()


def iter_conll05(tar_path: str, word_dict: Dict[str, int],
                 verb_dict: Dict[str, int], label_dict: Dict[str, int],
                 *, features: bool, unk_idx: int = 0):
    """``features=False``: (word_ids, predicate_id, label_ids).
    ``features=True``: the reference 9-slot row — word_ids, ctx-2/-1/0/+1/+2
    (predicate-window words broadcast over the sentence), predicate id
    (broadcast), mark (1 on the 5-token predicate window), label_ids."""
    for words, verb, bio in _iter_conll05_sentences(tar_path):
        word_ids = [word_dict.get(w, unk_idx) for w in words]
        label_ids = [label_dict[t] for t in bio]
        v = bio.index("B-V")
        if not features:
            yield word_ids, verb_dict.get(verb, unk_idx), label_ids
            continue
        L = len(words)
        mark = [0] * L
        ctx = {}
        for d in (-2, -1, 0, 1, 2):
            i = v + d
            if 0 <= i < L:
                mark[i] = 1
                ctx[d] = words[i]
            else:
                ctx[d] = "bos" if i < 0 else "eos"
        yield (word_ids,
               [word_dict.get(ctx[-2], unk_idx)] * L,
               [word_dict.get(ctx[-1], unk_idx)] * L,
               [word_dict.get(ctx[0], unk_idx)] * L,
               [word_dict.get(ctx[1], unk_idx)] * L,
               [word_dict.get(ctx[2], unk_idx)] * L,
               [verb_dict.get(verb, unk_idx)] * L,
               mark, label_ids)


# ---------------------------------------------------------------------------
# NLTK movie_reviews (reference sentiment.py:36-110: corpus directory with
# pos/*.txt and neg/*.txt; neg/pos files interleaved, head of the interleave
# is train; dict sorted by frequency)
# ---------------------------------------------------------------------------


def _movie_review_files(corpus_dir: str) -> List[Tuple[str, int]]:
    """Interleaved [(path, label)] — neg, pos, neg, pos... (label 1 = pos),
    mirroring the reference's sort_files() cross-reading order."""
    def listing(sense):
        d = os.path.join(corpus_dir, sense)
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".txt")]

    negs, poss = listing("neg"), listing("pos")
    if len(negs) != len(poss):
        raise ValueError(
            f"movie_reviews corpus is unbalanced ({len(negs)} neg / "
            f"{len(poss)} pos) — a partial copy would silently truncate")
    out: List[Tuple[str, int]] = []
    for neg, pos in zip(negs, poss):
        out.append((neg, 0))
        out.append((pos, 1))
    return out


def _tokenize_review(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return f.read().lower().split()


def movie_reviews_word_dict(corpus_dir: str, vocab_size: int) -> Dict[str, int]:
    freq: Dict[str, int] = defaultdict(int)
    for path, _ in _movie_review_files(corpus_dir):
        for w in _tokenize_review(path):
            freq[w] += 1
    ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ranked[: vocab_size - 1])}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def iter_movie_reviews(corpus_dir: str, split: str,
                       word_idx: Dict[str, int], *,
                       train_ratio: float = 0.8) -> Iterator[Tuple[List[int], int]]:
    """Yield (word_ids, label); the head ``train_ratio`` of the interleaved
    file list is train (the reference fixes 1600/2000 — expressed as a ratio
    so any corpus size splits the same way)."""
    files = _movie_review_files(corpus_dir)
    cut = int(len(files) * train_ratio)
    part = files[:cut] if split == "train" else files[cut:]
    unk = word_idx["<unk>"]
    for path, label in part:
        yield [word_idx.get(w, unk) for w in _tokenize_review(path)], label
