"""The port's real-data loaders (``paddle_tpu_torch/data/datasets.py`` over
``paddle_tpu_torch/data/formats.py``) on the CPU: every test of
``tests/test_real_data.py`` on the port, each opening with the reference
test it mirrors (the format tier writes miniature files in each real
on-disk format under a temporary ``$PADDLE_TPU_DATA_HOME``; the three
convergence tests skip unless the real datasets are there, as in the
reference); then the same fixture files read through both packages'
loaders, every format and split, row for row (ids, labels and arrays
exactly equal), and the data home's, cache's and cap's behaviour.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_real_data.py -q
"""

import gzip
import io
import itertools
import os
import pickle
import struct
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu.data.datasets as J

import paddle_tpu_torch.data.datasets as D


@pytest.fixture
def data_home(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    D._DICT_CACHE.clear()
    J._DICT_CACHE.clear()
    yield tmp_path
    D._DICT_CACHE.clear()
    J._DICT_CACHE.clear()


def _add_bytes(tf, name, payload):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


def _gz(payload):
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb") as g:
        g.write(payload)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the reference's format tier, on the port
# ---------------------------------------------------------------------------


def test_cifar10_pickle_tarball(data_home):
    """tests/test_real_data.py::test_cifar10_pickle_tarball"""
    d = data_home / "cifar"
    d.mkdir()
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (4, 3072), np.uint8)  # CHW plane order rows
    with tarfile.open(d / "cifar-10-python.tar.gz", "w:gz") as tf:
        _add_bytes(tf, "cifar-10-batches-py/data_batch_1",
                   pickle.dumps({b"data": imgs[:2], b"labels": [3, 7]}, 2))
        _add_bytes(tf, "cifar-10-batches-py/test_batch",
                   pickle.dumps({b"data": imgs[2:], b"labels": [1, 9]}, 2))
    train = list(D.cifar10("train")())
    test = list(D.cifar10("test")())
    assert [l for _, l in train] == [3, 7] and [l for _, l in test] == [1, 9]
    img0, _ = train[0]
    assert img0.shape == (32, 32, 3) and img0.dtype == np.float32
    # CHW plane -> HWC pixel: red channel of pixel (0,0) is row byte 0
    np.testing.assert_allclose(img0[0, 0, 0], imgs[0, 0] / 255.0)
    np.testing.assert_allclose(img0[0, 0, 1], imgs[0, 1024] / 255.0)


def test_imdb_aclimdb_tarball(data_home):
    """tests/test_real_data.py::test_imdb_aclimdb_tarball"""
    d = data_home / "imdb"
    d.mkdir()
    docs = {
        "aclImdb/train/pos/0_9.txt": b"Great movie, great acting!",
        "aclImdb/train/neg/0_2.txt": b"terrible terrible plot...",
        "aclImdb/test/pos/0_8.txt": b"great plot",
        "aclImdb/test/neg/0_3.txt": b"awful",
    }
    with tarfile.open(d / "aclImdb_v1.tar.gz", "w:gz") as tf:
        for name, payload in docs.items():
            _add_bytes(tf, name, payload)
    r = list(D.imdb("train", vocab_size=4)())
    assert len(r) == 2
    (pos_ids, pos_lab), (neg_ids, neg_lab) = sorted(r, key=lambda x: -x[1])
    assert pos_lab == 1 and neg_lab == 0
    # dict from train: great(2)=0, terrible(2)=1, acting(1)=2, <unk>=3
    assert pos_ids == [0, 3, 0, 2]           # great movie<unk> great acting
    assert neg_ids == [1, 1, 3]              # terrible terrible plot<unk>
    test_rows = list(D.imdb("test", vocab_size=4)())
    assert {lab for _, lab in test_rows} == {0, 1}


def test_wmt14_tgz(data_home):
    """tests/test_real_data.py::test_wmt14_tgz"""
    d = data_home / "wmt14"
    d.mkdir()
    src_dict = b"<s>\n<e>\n<unk>\nle\nchat\n"
    trg_dict = b"<s>\n<e>\n<unk>\nthe\ncat\n"
    train = b"le chat\tthe cat\nle " + b"x " * 90 + b"\tthe cat\n"
    test = b"chat\tcat\n"
    with tarfile.open(d / "wmt14.tgz", "w:gz") as tf:
        _add_bytes(tf, "wmt14/src.dict", src_dict)
        _add_bytes(tf, "wmt14/trg.dict", trg_dict)
        _add_bytes(tf, "wmt14/train/train", train)
        _add_bytes(tf, "wmt14/test/test", test)
    rows = list(D.wmt14("train", dict_size=5)())
    assert rows == [([0, 3, 4, 1], [0, 3, 4], [3, 4, 1])]  # >80 dropped
    rows = list(D.wmt14("test", dict_size=5)())
    assert rows == [([0, 4, 1], [0, 4], [4, 1])]
    # unknown words map to UNK_IDX=2 (a rewritten file is parsed again)
    with tarfile.open(d / "wmt14.tgz", "w:gz") as tf:
        _add_bytes(tf, "wmt14/src.dict", src_dict)
        _add_bytes(tf, "wmt14/trg.dict", trg_dict)
        _add_bytes(tf, "wmt14/train/train", b"mystery chat\tthe dog\n")
    assert list(D.wmt14("train", dict_size=5)()) == [
        ([0, 2, 4, 1], [0, 3, 2], [3, 2, 1])]


def test_movielens_ml1m_zip(data_home):
    """tests/test_real_data.py::test_movielens_ml1m_zip"""
    d = data_home / "movielens"
    d.mkdir()
    with zipfile.ZipFile(d / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/users.dat",
                   "1::F::1::10::48067\n2::M::56::16::70072\n")
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Jumanji (1995)::Adventure\n")
        ratings = "".join(f"{1 + i % 2}::{1 + i % 2}::{1 + i % 5}::0\n"
                          for i in range(200))
        z.writestr("ml-1m/ratings.dat", ratings)
    plain = list(D.movielens("train")())
    plain_test = list(D.movielens("test")())
    assert 0 < len(plain_test) < len(plain)  # ~10% test split
    u, m, r = plain[0]
    assert u in (0, 1) and m in (0, 1) and 1.0 <= r <= 5.0  # 0-based ids
    feats = list(D.movielens_features("train")())
    # user 1 is F (gender 1), age bucket index of 1 -> 0, job 10
    row_u1 = [f for f in feats if f[0] == 0][0]
    assert row_u1[1] == 1 and row_u1[2] == 0 and row_u1[3] == 10
    # categories sorted alphabetically: Adventure=0, Animation=1, Comedy=2
    row_m1 = [f for f in feats if f[4] == 0][0]
    assert row_m1[5] == [1, 2]
    assert len(row_m1[6]) == 2  # 'toy story' title words
    assert 1.0 <= row_m1[7][0] <= 5.0


def test_uci_housing_table(data_home):
    """tests/test_real_data.py::test_uci_housing_table"""
    d = data_home / "uci_housing"
    d.mkdir()
    rng = np.random.RandomState(1)
    rows = rng.rand(10, 14) * 10
    with open(d / "housing.data", "w") as f:
        for row in rows:
            f.write(" ".join(f"{v:.4f}" for v in row) + "\n")
    train = list(D.uci_housing("train")())
    test = list(D.uci_housing("test")())
    assert len(train) == 8 and len(test) == 2  # 80/20 head/tail
    x, y = train[0]
    assert x.shape == (13,) and x.dtype == np.float32
    col0 = np.round(rows[:, 0], 4)  # the file stores 4 decimals
    expect = (col0[0] - col0.mean()) / (col0.max() - col0.min())
    np.testing.assert_allclose(x[0], expect, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, rows[0, 13], rtol=1e-4)


def test_imikolov_ptb_tgz(data_home):
    """tests/test_real_data.py::test_imikolov_ptb_tgz"""
    d = data_home / "imikolov"
    d.mkdir()
    with tarfile.open(d / "simple-examples.tgz", "w:gz") as tf:
        _add_bytes(tf, "./simple-examples/data/ptb.train.txt",
                   b"a b a\na b c <unk>\n")
        _add_bytes(tf, "./simple-examples/data/ptb.valid.txt", b"b a\n")
    rows = list(D.imikolov("train", vocab_size=6, ngram=3)())
    wd = D.formats.imikolov_word_dict(str(d / "simple-examples.tgz"), 6)
    assert wd["<unk>"] == 5 and len(wd) == 6
    s, e, a, b = wd["<s>"], wd["<e>"], wd["a"], wd["b"]
    # line 1: <s> a b a <e> -> 3 trigrams
    assert rows[0] == (s, a, b) and rows[1] == (a, b, a) and rows[2] == (b, a, e)
    # line 2 contains the corpus literal '<unk>' -> maps to the unk id
    assert any(wd["<unk>"] in r for r in rows[3:])
    valid = list(D.imikolov("test", vocab_size=6, ngram=3)())
    assert valid[0] == (s, b, a)


def test_conll05_tarball(data_home):
    """tests/test_real_data.py::test_conll05_tarball"""
    d = data_home / "conll05st"
    d.mkdir()
    words = b"The\ncat\nsat\n\n"
    props = b"-\t(A0*\n-\t*)\nsit\t(V*)\n\n"
    with tarfile.open(d / "conll05st-tests.tar.gz", "w:gz") as tf:
        _add_bytes(tf, "conll05st-release/test.wsj/words/test.wsj.words.gz",
                   _gz(words))
        _add_bytes(tf, "conll05st-release/test.wsj/props/test.wsj.props.gz",
                   _gz(props))
    (d / "wordDict.txt").write_text("The\ncat\nsat\n")
    (d / "verbDict.txt").write_text("-\nsit\n")
    (d / "targetDict.txt").write_text("O\nB-A0\nI-A0\nB-V\n")
    rows = list(D.conll05("train")())
    assert rows == [([0, 1, 2], 1, [1, 2, 3])]  # words, verb 'sit', BIO ids
    frows = list(D.conll05_features("train")())
    w, c2, c1, c0, p1, p2, verb, mark, lab = frows[0]
    assert w == [0, 1, 2] and lab == [1, 2, 3]
    assert c0 == [2, 2, 2]          # predicate word 'sat' broadcast
    assert c1 == [1, 1, 1]          # ctx-1 'cat'
    assert c2 == [0, 0, 0]          # ctx-2 'The'
    assert mark == [1, 1, 1]        # 5-window clipped to the 3-token sentence
    assert verb == [1, 1, 1]


def test_sentiment_movie_reviews_dir(data_home):
    """tests/test_real_data.py::test_sentiment_movie_reviews_dir"""
    d = data_home / "sentiment" / "movie_reviews"
    for sense, texts in (("pos", ["good good fun", "good story"]),
                         ("neg", ["bad bad boring", "bad end"])):
        (d / sense).mkdir(parents=True)
        for i, t in enumerate(texts):
            (d / sense / f"cv{i}.txt").write_text(t)
    train = list(D.sentiment("train", vocab_size=4)())
    test = list(D.sentiment("test", vocab_size=4)())
    # 4 files interleaved neg,pos,neg,pos; head 80% (3 files) = train
    assert len(train) == 3 and len(test) == 1
    assert [lab for _, lab in train] == [0, 1, 0]
    wd = D.formats.movie_reviews_word_dict(str(d), 4)
    assert wd["bad"] == 0 and wd["good"] == 1 and len(wd) == 4
    for ids, _ in train + test:
        assert all(0 <= i < 4 for i in ids)


def test_mnist_idx_files(data_home):
    """tests/test_real_data.py::test_mnist_idx_files"""
    d = data_home / "mnist"
    d.mkdir()
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (3, 28, 28), np.uint8)
    labs = np.array([4, 0, 9], np.uint8)
    with open(d / "train-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28))
        f.write(imgs.tobytes())
    with open(d / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, 3))
        f.write(labs.tobytes())
    rows = list(D.mnist("train")())
    assert [l for _, l in rows] == [4, 0, 9]
    np.testing.assert_allclose(rows[0][0][:, :, 0], imgs[0] / 255.0)


def test_synthetic_fallback_when_absent(data_home):
    """tests/test_real_data.py::test_synthetic_fallback_when_absent"""
    for maker in (D.mnist, D.cifar10, D.imdb, D.wmt14, D.movielens,
                  D.movielens_features, D.uci_housing, D.imikolov,
                  D.conll05, D.conll05_features, D.sentiment):
        rows = list(itertools.islice(maker("train")(), 3))
        assert len(rows) == 3, maker.__name__


# ---------------------------------------------------------------------------
# the reference's convergence tier, on the port (gated on real datasets)
# ---------------------------------------------------------------------------


def _have(*parts):
    return os.path.exists(os.path.join(D.data_home(), *parts))


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.skipif(not _have("mnist", "train-images-idx3-ubyte"),
                    reason="real MNIST not under $PADDLE_TPU_DATA_HOME")
def test_real_mnist_lenet_converges():
    """tests/test_real_data.py::test_real_mnist_lenet_converges: LeNet-5
    to >=97% test accuracy on real MNIST."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import lenet5
    from paddle_tpu_torch.param.optimizers import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    nn.reset_naming()
    cost, logits = lenet5()
    trainer = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=0,
                         device=_device())
    B = 128

    def batches(split):
        xs, ys = [], []
        for img, lab in D.mnist(split)():
            xs.append(img)
            ys.append(lab)
            if len(xs) == B:
                yield {"pixel": np.stack(xs),
                       "label": np.asarray(ys, np.int32)[:, None]}
                xs, ys = [], []

    for _ in range(2):
        for feed in batches("train"):
            trainer.train_batch(feed)
    correct = total = 0
    for feed in batches("test"):
        outs = trainer.infer(logits, feed)
        pred = np.argmax(outs[logits.name], -1)
        correct += int((pred == feed["label"][:, 0]).sum())
        total += len(pred)
    acc = correct / total
    assert acc >= 0.97, f"LeNet test accuracy {acc:.4f} < 0.97"


@pytest.mark.skipif(not _have("imdb", "aclImdb_v1.tar.gz"),
                    reason="real IMDB not under $PADDLE_TPU_DATA_HOME")
def test_real_imdb_stacked_lstm_converges():
    """tests/test_real_data.py::test_real_imdb_stacked_lstm_converges:
    the stacked LSTM to >=85% test accuracy on real IMDB."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import stacked_lstm_net
    from paddle_tpu_torch.param.optimizers import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    V, B, T = 5000, 64, 200
    nn.reset_naming()
    cost, logits = stacked_lstm_net(V, hid_dim=128, stacked_num=3)
    trainer = SGDTrainer(cost, Adam(learning_rate=2e-3), seed=0,
                         device=_device())
    feeder = DataFeeder({"words": "ids_seq", "label": "int"}, max_len=T,
                        buckets=(T,))

    def batches(split):
        rows = []
        for ids, lab in D.imdb(split, vocab_size=V)():
            rows.append((ids, lab))
            if len(rows) == B:
                yield feeder(rows)
                rows = []

    for feed in batches("train"):
        trainer.train_batch(feed)
    correct = total = 0
    for feed in batches("test"):
        pred = np.argmax(trainer.infer(logits, feed)[logits.name], -1)
        correct += int((pred == np.asarray(feed["label"])[:, 0]).sum())
        total += len(pred)
    acc = correct / total
    assert acc >= 0.85, f"IMDB test accuracy {acc:.4f} < 0.85"


@pytest.mark.skipif(not _have("wmt14", "wmt14.tgz"),
                    reason="real WMT14 not under $PADDLE_TPU_DATA_HOME")
def test_real_wmt14_seq2seq_loss_decreases():
    """tests/test_real_data.py::test_real_wmt14_seq2seq_loss_decreases:
    the flagship's teacher-forced loss well below the uniform floor
    (ln 30000 ~ 10.3) within ~300 batches of real WMT14 pairs."""
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.param.optimizers import Adam

    V, B, S, T = 30000, 64, 32, 32
    m = Seq2SeqAttention(src_vocab=V, trg_vocab=V, device=_device())
    params = {k: v.requires_grad_() for k, v in m.init(seed=0).items()}
    opt = Adam(learning_rate=5e-4)
    state = opt.init_state(params)

    def batches():
        rows = []
        for src, trg_in, trg_next in D.wmt14("train")():
            if len(src) > S or len(trg_in) > T:
                continue
            rows.append((src, trg_in, trg_next))
            if len(rows) == B:
                def pad(seqs, L):
                    out = np.zeros((B, L), np.int32)
                    for i, q in enumerate(seqs):
                        out[i, :len(q)] = q
                    return out
                yield {
                    "src_ids": pad([r[0] for r in rows], S),
                    "src_len": np.array([len(r[0]) for r in rows], np.int32),
                    "trg_in": pad([r[1] for r in rows], T),
                    "trg_next": pad([r[2] for r in rows], T),
                    "trg_len": np.array([len(r[1]) for r in rows], np.int32),
                }
                rows = []

    losses = []
    for i, feed in enumerate(batches()):
        loss = m.loss(params, feed)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), state)
        losses.append(float(loss))
        if i >= 300:
            break
    assert np.isfinite(losses[-1])
    assert np.mean(losses[-20:]) < 7.0, np.mean(losses[-20:])


# ---------------------------------------------------------------------------
# the port against the JAX package on the same files
# ---------------------------------------------------------------------------


def _words(rng, vocab, lo, hi):
    return [vocab[i] for i in rng.randint(0, len(vocab), rng.randint(lo, hi))]


def _write_every_format(home, seed=0):
    """One seeded fixture of every real on-disk format under ``home``
    (larger than the format tier's, with ties, unknown words, long pairs
    and punctuation)."""
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(40)] + ["The", "cat", "a", "b", "<unk>"]

    d = home / "cifar"
    d.mkdir()
    imgs = rng.randint(0, 256, (7, 3072), np.uint8)
    with tarfile.open(d / "cifar-10-python.tar.gz", "w:gz") as tf:
        _add_bytes(tf, "cifar-10-batches-py/data_batch_1", pickle.dumps(
            {b"data": imgs[:3], b"labels": [3, 7, 0]}, 2))
        _add_bytes(tf, "cifar-10-batches-py/data_batch_2", pickle.dumps(
            {b"data": imgs[3:5], b"labels": [9, 9]}, 2))
        _add_bytes(tf, "cifar-10-batches-py/test_batch", pickle.dumps(
            {b"data": imgs[5:], b"labels": [1, 4]}, 2))

    d = home / "imdb"
    d.mkdir()
    with tarfile.open(d / "aclImdb_v1.tar.gz", "w:gz") as tf:
        for split, n in (("train", 9), ("test", 5)):
            for sense in ("pos", "neg", "pos") if split == "test" else \
                    ("neg", "pos"):
                for i in range(n):
                    text = " ".join(_words(rng, vocab, 1, 30)) + ", ok!\n"
                    _add_bytes(tf, f"aclImdb/{split}/{sense}/{i}_{sense}"
                               f"{split}.txt", text.encode())

    d = home / "wmt14"
    d.mkdir()
    src_dict = "\n".join(["<s>", "<e>", "<unk>"] + vocab[:30]) + "\n"
    trg_dict = "\n".join(["<s>", "<e>", "<unk>"] + vocab[10:40]) + "\n"
    pairs = []
    for i in range(40):
        hi = 100 if i % 9 == 0 else 20
        pairs.append(" ".join(_words(rng, vocab, 1, hi)) + "\t"
                     + " ".join(_words(rng, vocab, 1, hi)))
    pairs.append("no tab here")
    with tarfile.open(d / "wmt14.tgz", "w:gz") as tf:
        _add_bytes(tf, "wmt14/src.dict", src_dict.encode())
        _add_bytes(tf, "wmt14/trg.dict", trg_dict.encode())
        _add_bytes(tf, "wmt14/train/train",
                   ("\n".join(pairs[:30]) + "\n").encode())
        _add_bytes(tf, "wmt14/test/test",
                   ("\n".join(pairs[30:]) + "\n").encode())

    d = home / "movielens"
    d.mkdir()
    genres = ["Action", "Comedy", "Drama", "Horror", "Animation"]
    with zipfile.ZipFile(d / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/users.dat", "".join(
            f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35, 45, 50, 56][u % 7]}::"
            f"{u % 21}::{10000 + u}\n" for u in range(1, 13)))
        z.writestr("ml-1m/movies.dat", "".join(
            f"{m}::{' '.join(_words(rng, vocab, 1, 4))} ({1990 + m})::"
            f"{'|'.join(sorted(set(rng.choice(genres, 2))))}\n"
            for m in range(1, 9)))
        z.writestr("ml-1m/ratings.dat", "".join(
            f"{rng.randint(1, 13)}::{rng.randint(1, 9)}::"
            f"{rng.randint(1, 6)}::0\n" for _ in range(300)))

    d = home / "uci_housing"
    d.mkdir()
    with open(d / "housing.data", "w") as f:
        for row in rng.rand(23, 14) * 10:
            f.write(" ".join(f"{v:.4f}" for v in row) + "\n")

    d = home / "imikolov"
    d.mkdir()
    lines = lambda n: ("\n".join(" ".join(_words(rng, vocab, 1, 12))
                                 for _ in range(n)) + "\n").encode()
    with tarfile.open(d / "simple-examples.tgz", "w:gz") as tf:
        _add_bytes(tf, "./simple-examples/data/ptb.train.txt", lines(20))
        _add_bytes(tf, "./simple-examples/data/ptb.valid.txt", lines(6))

    d = home / "conll05st"
    d.mkdir()
    words = b"The\ncat\nsat\non\nit\n\nA\ndog\nran\n\n"
    props = (b"-\t(A0*\t*\n-\t*)\t*\nsit\t(V*)\t*\n-\t*\t(AM*\n"
             b"rest\t*\t(V*))\n\n-\t(A0*\nrun\t*)\n-\t(V*)\n\n")
    with tarfile.open(d / "conll05st-tests.tar.gz", "w:gz") as tf:
        _add_bytes(tf, "conll05st-release/test.wsj/words/test.wsj.words.gz",
                   _gz(words))
        _add_bytes(tf, "conll05st-release/test.wsj/props/test.wsj.props.gz",
                   _gz(props))
    (d / "wordDict.txt").write_text("The\ncat\nsat\non\nit\nA\ndog\nran\n")
    (d / "verbDict.txt").write_text("-\nsit\nrest\nrun\n")
    (d / "targetDict.txt").write_text(
        "O\nB-A0\nI-A0\nB-V\nI-V\nB-AM\nI-AM\n")

    d = home / "sentiment" / "movie_reviews"
    for sense in ("pos", "neg"):
        (d / sense).mkdir(parents=True)
        for i in range(6):
            (d / sense / f"cv{i:03d}.txt").write_text(
                " ".join(_words(rng, vocab, 2, 25)))

    d = home / "mnist"
    d.mkdir()
    for stem, n in (("train", 5), ("t10k", 3)):
        with open(d / f"{stem}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(rng.randint(0, 256, (n, 28, 28), np.uint8).tobytes())
        with open(d / f"{stem}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(rng.randint(0, 10, n).astype(np.uint8).tobytes())


#: every loader, with the keyword arguments each is read at
LOADERS = [
    ("mnist", {}), ("cifar10", {}), ("imdb", {"vocab_size": 12}),
    ("imdb", {"vocab_size": 5000}), ("wmt14", {"dict_size": 20}),
    ("wmt14", {"dict_size": 33}), ("movielens", {}),
    ("movielens", {"n_users": 6, "n_movies": 5}), ("movielens_features", {}),
    ("uci_housing", {}), ("imikolov", {"vocab_size": 9, "ngram": 3}),
    ("imikolov", {"vocab_size": 2000, "ngram": 5}), ("conll05", {}),
    ("conll05", {"vocab_size": 4}), ("conll05_features", {}),
    ("conll05_features", {"vocab_size": 6}), ("sentiment", {"vocab_size": 7}),
]


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray) and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("name,kw", LOADERS,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 0}"
                              for n, k in LOADERS])
def test_same_file_gives_the_same_rows_through_both_packages(
        data_home, name, kw):
    _write_every_format(data_home)
    for split in ("train", "test"):
        want = list(getattr(J, name)(split, **kw)())
        got = list(getattr(D, name)(split, **kw)())
        assert want or split == "test", (name, split)
        _same_rows(got, want)
        # an explicit n caps the real stream in both
        _same_rows(list(getattr(D, name)(split, n=3, **kw)()), want[:3])


def test_each_loader_reads_its_real_file(data_home):
    """With every format present, no loader falls back to its synthetic
    stream (the same call on an empty home gives other rows)."""
    def head(n, kw):
        return list(itertools.islice(getattr(D, n)("train", **kw)(), 2))

    synth = []
    for n, kw in LOADERS:
        try:
            synth.append(head(n, kw))
        except ValueError:   # a synthetic stream needs a wider vocabulary
            synth.append(None)
    _write_every_format(data_home)
    for (n, kw), s in zip(LOADERS, synth):
        real = head(n, kw)
        assert len(real) == 2, n
        if s is not None:
            with pytest.raises(AssertionError):
                _same_rows(real, s)


def test_data_home_is_read_on_each_call(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DATA_HOME", raising=False)
    assert D.data_home() == os.path.expanduser("~/.cache/paddle_tpu") \
        == J.data_home()
    for sub in ("a", "b"):
        monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path / sub))
        assert D.data_home() == J.data_home() == str(tmp_path / sub)
    assert "data_home" in D.__all__ and "data_home" in J.__all__


def test_the_cache_keys_a_file_by_path_mtime_and_size(data_home):
    builds = []
    f = data_home / "x.txt"
    f.write_text("one\n")

    def build():
        builds.append(1)
        return len(builds)

    assert D._cached(("k", str(f), 3), build) == 1
    assert D._cached(("k", str(f), 3), build) == 1        # cached
    assert D._cached(("k", str(f), 4), build) == 2        # another key
    f.write_text("a longer one\n")                          # size moves
    assert D._cached(("k", str(f), 3), build) == 3
    os.utime(f, (1, 1))                                     # mtime moves
    assert D._cached(("k", str(f), 3), build) == 4
    assert D._cached("plain", build) == 5 and D._cached("plain", build) == 5


def test_capped_caps_only_when_asked():
    gen = lambda: iter(range(10))
    assert D._capped(gen, None) is gen
    assert list(D._capped(gen, 4)()) == [0, 1, 2, 3]
    assert list(D._capped(gen, 40)()) == list(range(10))
