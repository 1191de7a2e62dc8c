"""The MovieLens recommender and the word2vec n-gram nets of the port
against the JAX package, trained through both packages' ``SGDTrainer`` on
the CPU, and the synthetic ``movielens``, ``movielens_features`` and
``imikolov`` streams.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_recommender.py -q

Each net takes 3 steps through each package's trainer from the JAX
trainer's initial checkpoint (Adam for the recommender, AdaGrad for
word2vec, as ``demo/recommendation`` and ``demo/word2vec`` train them) at
narrow widths (the ids keep ml-1m's cardinalities); the losses and every
parameter agree at rtol 1e-5 / atol 1e-6.  NCE's noise classes come from
one numpy draw keyed by the shape in both packages (``share_draws``).
One exception: word2vec with NCE holds its parameters at atol 2e-5.  A
class drawn as noise in several rows of a batch sums gradients that nearly
cancel, in another order in each package (``F.embedding``'s backward
against XLA's scatter-add), and AdaGrad's step ``lr * g / (sqrt(g^2) +
1e-6)`` turns a 1e-10 difference in such a g ~ 1e-6 into ~1e-5 of the
update (2 entries of 768 move by up to 7.7e-6 here); the losses still
agree at rtol 1e-5.  The streams yield the reference's rows exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.data as jdata
import paddle_tpu.models as jmodels
import paddle_tpu.nn as jnn
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.models as tmodels
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.flags import FLAGS

import torch_sparse_nets as N
from torch_compare import close, share_draws

B, STEPS = 8, 3


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
    share_draws(monkeypatch)
    with compute_dtype_scope("float32"):
        yield


def _batches(reader, feeder, n=STEPS):
    rows = list(reader())
    return [feeder(rows[i * B:(i + 1) * B]) for i in range(n)]


def _movielens_feeds():
    feeder = tdata.DataFeeder({"user_id": "int", "movie_id": "int",
                               "score": "dense"})
    reader = tdata.map_readers(lambda r: (r[0], r[1], [r[2]]),
                               tdata.datasets.movielens("train",
                                                        n=B * STEPS))
    return _batches(reader, feeder)


def _feature_feeds():
    feeder = tdata.DataFeeder(N.MOVIELENS_FEATURE_TYPES)
    return _batches(tdata.datasets.movielens_features("train", n=B * STEPS),
                    feeder)


def _ngram_feeds(vocab=64):
    feeder = tdata.DataFeeder(N.ngram_feeder_types(5))
    return _batches(tdata.datasets.imikolov("train", vocab_size=vocab,
                                            n=B * STEPS), feeder)


#: name -> (builder over (nn, models) -> cost, optimizer class and its
#: arguments, feeds)
NETS = {
    "movielens_net": (
        lambda nn, m: m.movielens_net(emb_dim=8, hid_dim=6)[0],
        ("Adam", {"learning_rate": 1e-2}), _movielens_feeds),
    "movielens_net_sparse_grad": (
        lambda nn, m: m.movielens_net(emb_dim=8, hid_dim=6,
                                      sparse_grad=True)[0],
        ("Adam", {"learning_rate": 1e-2}), _movielens_feeds),
    "movielens_feature_net": (
        lambda nn, m: m.movielens_feature_net(emb_dim=8, fusion_dim=12)[0],
        ("Adam", {"learning_rate": 1e-2}), _feature_feeds),
    "word2vec_hsigmoid": (
        lambda nn, m: N.ngram_net(nn, 64, 8, 12, 5, "hsigmoid"),
        ("AdaGrad", {"learning_rate": 0.1}), _ngram_feeds),
    "word2vec_nce": (
        lambda nn, m: N.ngram_net(nn, 64, 8, 12, 5, "nce"),
        ("AdaGrad", {"learning_rate": 0.1}), _ngram_feeds),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_trains_like_reference(name, tmp_path):
    build, (opt, kw), feeds_fn = NETS[name]
    jnn.reset_naming()
    jc = build(jnn, jmodels)
    tnn.reset_naming()
    tc = build(tnn, tmodels)
    jtr = JaxTrainer(jc, getattr(jopt, opt)(**kw), seed=3)
    jtr.save(str(tmp_path), 0)
    ttr = SGDTrainer(tc, getattr(topt, opt)(**kw), seed=3, device="cpu")
    ttr.load(str(tmp_path), 0)
    assert ttr.sparse_rows == jtr.sparse_rows
    if name.endswith("sparse_grad"):
        assert ttr.sparse_rows == {"_user_emb.w0": True,
                                   "_movie_emb.w0": True}
    feeds = feeds_fn()
    jl = [float(jtr.train_batch(f)) for f in feeds]
    tl = [ttr.train_batch(f).item() for f in feeds]
    assert all(np.isfinite(jl)) and int(ttr.opt_state["step"]) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert set(ttr.params) == set(jtr.params)
    atol = 2e-5 if name == "word2vec_nce" else 1e-6
    for k, v in ttr.params.items():
        close(v, np.asarray(jtr.params[k]), atol=atol, what=k)


def test_sparse_grad_tables_hold_their_untouched_rows(tmp_path):
    """``movielens_net(sparse_grad=True)``: after the steps, every
    ``user_emb``/``movie_emb`` row no batch looked up keeps its initial
    value and its zero Adam slots, bit for bit, and the looked-up rows
    moved."""
    tnn.reset_naming()
    cost, _ = tmodels.movielens_net(emb_dim=8, hid_dim=6, sparse_grad=True)
    tr = SGDTrainer(cost, topt.Adam(learning_rate=1e-2), seed=3,
                    device="cpu")
    before = {k: v.detach().clone() for k, v in tr.params.items()}
    feeds = _movielens_feeds()
    for f in feeds:
        tr.train_batch(f)
    for key, table in (("user_id", "_user_emb.w0"),
                       ("movie_id", "_movie_emb.w0")):
        seen = np.zeros(tr.params[table].shape[0], bool)
        for f in feeds:
            seen[f[key].reshape(-1)] = True
        untouched = torch.from_numpy(~seen)
        assert untouched.sum() > 3000
        assert torch.equal(tr.params[table].detach()[untouched],
                           before[table][untouched])
        m, v = tr.opt_state["slots"][table]
        assert not m[untouched].any() and not v[untouched].any()
        assert not torch.equal(tr.params[table].detach()[~untouched],
                               before[table][~untouched])


@pytest.mark.parametrize("name,kw", [
    ("movielens", {"n": 40}), ("movielens", {"n": 7, "n_users": 50,
                                             "n_movies": 30}),
    ("movielens_features", {"n": 40}),
    ("imikolov", {"n": 40}), ("imikolov", {"n": 9, "vocab_size": 64,
                                           "ngram": 3})])
@pytest.mark.parametrize("split", ["train", "test"])
def test_streams_match_reference(name, kw, split, monkeypatch):
    # no real files: the reference reads ml-1m/PTB under its data home
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", "/nonexistent")
    got = list(getattr(tdata.datasets, name)(split, **kw)())
    want = list(getattr(jdata.datasets, name)(split, **kw)())
    assert len(got) == len(want) == kw["n"]
    for g, w in zip(got, want):
        assert repr(g) == repr(w)
    assert tdata.datasets.ML_SCHEMA == jdata.datasets.ML_SCHEMA
