"""The sparse tier of the port against the JAX package, on the CPU: the
sparse products and CSR/CSC containers (``ops/sparse.py``), the sparse
feeds through ``Topology.apply``, ``fc`` over sparse input, the row-sparse
optimizer update (``sparse_rows``) and the quick_start demo's sparse LR
trained through both packages' ``SGDTrainer``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sparse.py -q

Tolerance: rtol 1e-5 / atol 1e-6 of the larger of 1 and the reference's
largest entry (``tests/torch_compare.py``); the containers and the feeds
exactly; an untouched row of a ``sparse_grad`` table bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.data as jdata
import paddle_tpu.nn as jnn
import paddle_tpu.ops as JO
from paddle_tpu.nn.graph import _coerce_feed as j_coerce_feed
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.utils.error import ConfigError as JConfigError
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.nn.graph import _coerce_feed as t_coerce_feed
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.flags import FLAGS

import torch_sparse_nets as N
from torch_compare import close, fwd_grad, randn

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
    with compute_dtype_scope("float32"):
        yield


def _padded(seed=0, B=4, N=5, V=9, lead=()):
    """Padded COO rows with duplicate ids and an all-padding row: (ids,
    weights, mask); padding slots carry arbitrary in-range ids."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (*lead, B, N)).astype(np.int32)
    ids[..., 0, 1] = ids[..., 0, 0]                 # a duplicate id
    nnz = rs.randint(1, N + 1, (*lead, B))
    nnz[..., 1] = 0                                 # an all-padding row
    mask = (np.arange(N) < nnz[..., None]).astype(np.float32)
    weights = rs.randn(*lead, B, N).astype(np.float32)
    return ids, weights, mask


def _rand_sparse(rs, R, C, density=0.3):
    a = rs.randn(R, C).astype(np.float32)
    a[rs.rand(R, C) >= density] = 0.0
    return a


# ---------------------------------------------------------------------------
# ops/sparse.py against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (3,)])
def test_sparse_gather_matmul_and_its_gradients(lead):
    ids, weights, mask = _padded(lead=lead)
    w, b = randn(9, 6, seed=1), randn(6, seed=2)
    fwd_grad(lambda i, wt, m, w_, b_: JO.sparse_gather_matmul(i, wt, m, w_,
                                                              b_),
             TO.sparse_gather_matmul, ids, weights, mask, w, b,
             argnums=(1, 3, 4))


def test_sparse_gather_matmul_gradient_touches_only_gathered_rows():
    ids, weights, mask = _padded()
    w = torch.tensor(randn(9, 6, seed=1), requires_grad=True)
    out = TO.sparse_gather_matmul(torch.from_numpy(ids),
                                  torch.from_numpy(weights),
                                  torch.from_numpy(mask), w)
    (g,) = torch.autograd.grad(out.sum(), w)
    live = set(ids[mask > 0].tolist())
    for r in range(9):
        assert bool(g[r].abs().sum() > 0) == (r in live), r


def test_sparse_to_dense_adds_duplicates():
    ids, weights, mask = _padded()
    fwd_grad(lambda i, wt, m: JO.sparse_to_dense(i, wt, m, 9),
             lambda i, wt, m: TO.sparse_to_dense(i, wt, m, 9),
             ids, weights, mask, argnums=(1,))
    got = TO.sparse_to_dense(*(torch.from_numpy(a) for a in
                               (ids, weights, mask)), 9).numpy()
    assert got[0, ids[0, 0]] == pytest.approx(
        float((weights[0] * mask[0])[ids[0] == ids[0, 0]].sum()), rel=1e-6)
    assert not got[1].any()


def test_selective_columns_matmul_with_bias_and_mask():
    rs = np.random.RandomState(3)
    x, w, b = randn(4, 5, seed=4), randn(5, 11, seed=5), randn(11, seed=6)
    sel = rs.randint(0, 11, (4, 3)).astype(np.int32)
    sm = (rs.rand(4, 3) > 0.3).astype(np.float32)
    fwd_grad(lambda x_, s, w_, b_, m: JO.selective_columns_matmul(
                 x_, s, w_, b_, m),
             lambda x_, s, w_, b_, m: TO.selective_columns_matmul(
                 x_, s, w_, b_, m),
             x, sel, w, b, sm, argnums=(0, 2, 3))


def test_csr_and_csc_containers_match_reference():
    """The behaviour list of ``tests/test_sparse_matrix.py``: round
    trips, binary and float rows, duplicates, the padded re-layout and its
    width check, the CSR/CSC duality."""
    rs = np.random.RandomState(0)
    a = _rand_sparse(rs, 7, 11)
    for cls in ("CsrMatrix", "CscMatrix"):
        t, j = getattr(TO, cls).from_dense(a), getattr(JO, cls).from_dense(a)
        assert t.shape == j.shape and t.nnz == j.nnz == int((a != 0).sum())
        for k in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        np.testing.assert_array_equal(t.to_dense(), a)
        np.testing.assert_array_equal(t.T.to_dense(), a.T)
    rows = [[(0, 0.5), (3, 2.0)], [(1, -1.0)], [], [(2, 1.0), (2, 3.0)]]
    for binary, rs_ in ((False, rows), (True, [[0, 2], [1], [], [3, 3]])):
        t = TO.CsrMatrix.from_rows(rs_, 4, binary=binary)
        j = JO.CsrMatrix.from_rows(rs_, 4, binary=binary)
        np.testing.assert_array_equal(t.to_dense(), j.to_dense())
        for got, want in zip(t.to_padded(), j.to_padded()):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(t.to_padded(6), j.to_padded(6)):
            np.testing.assert_array_equal(got, want)
    assert TO.CsrMatrix.from_rows(rows, 4).to_dense()[3, 2] == 4.0
    with pytest.raises(ValueError, match="would drop entries"):
        TO.CsrMatrix.from_rows(rows, 4).to_padded(1)


def test_csr_matmul_and_matmul_dense_csc_match_reference():
    rs = np.random.RandomState(1)
    a = _rand_sparse(rs, 6, 9)
    a[2] = 0.0                                      # an empty row
    m = TO.CsrMatrix.from_dense(a)
    jm = JO.CsrMatrix.from_dense(a)
    w, b = randn(9, 4, seed=7), randn(4, seed=8)
    fwd_grad(lambda w_, b_: JO.csr_matmul(jm, w_, b_),
             lambda w_, b_: TO.csr_matmul(m, w_, b_), w, b)
    close(TO.csr_matmul(m, torch.from_numpy(w)), a @ w)
    x = randn(5, 6, seed=9)
    c, jc = TO.CscMatrix.from_dense(a), JO.CscMatrix.from_dense(a)
    fwd_grad(lambda x_, b_: JO.matmul_dense_csc(x_, jc, b_),
             lambda x_, b_: TO.matmul_dense_csc(x_, c, b_), x,
             randn(9, seed=10))
    close(TO.matmul_dense_csc(torch.from_numpy(x), c), x @ a)


# ---------------------------------------------------------------------------
# the sparse feeds and fc over sparse input
# ---------------------------------------------------------------------------


def _feed_cases():
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 20, (3, 4)).astype(np.int32)
    nnz = np.array([4, 0, 2], np.int32)
    w = rs.randn(3, 4).astype(np.float32)
    sids = rs.randint(0, 20, (3, 5, 4)).astype(np.int32)
    snnz = rs.randint(0, 5, (3, 5)).astype(np.int32)
    sw = rs.randn(3, 5, 4).astype(np.float32)
    lens = np.array([5, 3, 1], np.int32)
    return {"binary": (False, "binary", (ids, nnz)),
            "float": (False, "float", (ids, w, nnz)),
            "binary_seq": (True, "binary", (sids, snnz, lens)),
            "float_seq": (True, "float", (sids, sw, snnz, lens))}


@pytest.mark.parametrize("case", sorted(_feed_cases()))
def test_sparse_feeds_coerce_as_the_reference(case):
    is_seq, kind, v = _feed_cases()[case]
    jl = jnn.data("s", size=20, is_seq=is_seq, sparse=kind)
    tl = tnn.data("s", size=20, is_seq=is_seq, sparse=kind)
    # both packages record the constructor call (config serialization)
    assert {k: v for k, v in tl.meta.items() if k != "config"} \
        == {"sparse": kind} == {
        k: v for k, v in jl.meta.items() if k != "config"}
    assert tl.meta["config"]["kwargs"] == jl.meta["config"]["kwargs"]
    assert tl.data_spec == jl.data_spec
    j = j_coerce_feed(jl, {"s": v})
    t = t_coerce_feed(tl, {"s": v}, CPU)
    for field in ("value", "lengths", "mask"):
        jv, tv = getattr(j, field), getattr(t, field)
        assert (jv is None) == (tv is None), field
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert set(t.state) == set(j.state)
    for k in j.state:
        np.testing.assert_array_equal(t.state[k].numpy(),
                                      np.asarray(j.state[k]))
    with pytest.raises(ConfigError, match="sparse"):
        t_coerce_feed(tl, {"s": v[:1]}, CPU)


def _fc_net(nn, kind, is_seq=False):
    s = nn.data("s", size=20, is_seq=is_seq, sparse=kind)
    x = nn.data("x", size=3, is_seq=is_seq)
    return nn.fc([s, x], 5, act="tanh", name="f")


@pytest.mark.parametrize("case", sorted(_feed_cases()))
def test_fc_over_sparse_input_matches_reference(case):
    """``fc`` over each sparse feed shape (with a dense second input),
    forward and every gradient, against the JAX package."""
    from torch_compare import (assert_grads_close, loss_and_grads,
                               nonzero_params)

    is_seq, kind, v = _feed_cases()[case]
    rs = np.random.RandomState(4)
    x = rs.randn(*v[0].shape[:-1], 3).astype(np.float32)
    feed = {"s": v, "x": (x, v[-1]) if is_seq else x}
    jnn.reset_naming()
    jt = jnn.Topology(_fc_net(jnn, kind, is_seq))
    tnn.reset_naming()
    tt = tnn.Topology(_fc_net(tnn, kind, is_seq), device="cpu")
    jp, js = jt.init(jax.random.PRNGKey(0))
    weight = rs.randn(*v[0].shape[:-1], 5).astype(np.float32)
    jv, jg, tv, tg = loss_and_grads(jt, tt, "f", nonzero_params(jp), js,
                                    feed, train=False, weight=weight)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    assert_grads_close(tg, jg, 1e-5, 1e-6)


@pytest.mark.parametrize("kind", ["binary", "float"])
def test_fc_over_sparse_equals_fc_over_densified(kind):
    """The sparse fc equals the same fc over ``sparse_to_dense`` of its
    input (``tests/test_sparse_input.py:100-153``), weights' gradient
    included."""
    _, _, v = _feed_cases()[kind]
    ids = torch.from_numpy(v[0])
    valid = (torch.arange(4)[None, :] < torch.from_numpy(v[-1])[:, None]
             ).float()
    weights = torch.from_numpy(v[1]) if kind == "float" else valid
    dense = TO.sparse_to_dense(ids, weights, valid, 20)
    tnn.reset_naming()
    sparse_out = tnn.fc(tnn.data("s", size=20, sparse=kind), 5, name="f")
    tnn.reset_naming()
    dense_out = tnn.fc(tnn.data("s", size=20), 5, name="f")
    st = tnn.Topology(sparse_out, device="cpu")
    dt = tnn.Topology(dense_out, device="cpu")
    params, _ = st.init(3)
    params = {k: p.requires_grad_() for k, p in params.items()}
    got = st.apply(params, {}, {"s": v})[0]["f"].value
    want = dt.apply(params, {}, {"s": dense})[0]["f"].value
    close(got, want.detach().numpy())
    gw = torch.autograd.grad(got.sum(), params["_f.w0"])[0]
    dw = torch.autograd.grad(want.sum(), params["_f.w0"])[0]
    close(gw, dw.numpy())


def test_sparse_input_into_an_unaware_layer_raises_as_the_reference():
    msgs = []
    for nn, err, kw in ((jnn, JConfigError, {}),
                        (tnn, ConfigError, {"device": "cpu"})):
        nn.reset_naming()
        s = nn.data("s", size=20, sparse="binary")
        with pytest.raises(err) as info:
            nn.Topology(nn.embedding(s, 4, name="e"), **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert "sparse-aware layers: ['fc', 'selective_fc']" in msgs[1]
    tnn.reset_naming()
    with pytest.raises(ConfigError, match="sparse must be"):
        tnn.data("s", size=20, sparse="csr")


# ---------------------------------------------------------------------------
# the row-sparse optimizer update
# ---------------------------------------------------------------------------

OPTS = {"sgd": dict(learning_rate=0.1),
        "momentum": dict(learning_rate=0.1, momentum=0.9),
        "adam": dict(learning_rate=0.05),
        "adagrad": dict(learning_rate=0.1)}
CLASSES = {"sgd": "SGD", "momentum": "Momentum", "adam": "Adam",
           "adagrad": "AdaGrad"}


def _sparse_grads(step, V=10, D=3):
    """A table gradient touching a few rows (one of them looked up with an
    exactly zero gradient: it counts as untouched), and a dense bias's."""
    rs = np.random.RandomState(10 + step)
    g = np.zeros((V, D), np.float32)
    rows = rs.choice(V, 3 + step, replace=False)
    g[rows] = rs.randn(len(rows), D)
    g[rows[0]] = 0.0
    return {"t": g, "b": rs.randn(D).astype(np.float32)}


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("kind", [True, 2, 5, 20])
def test_sparse_rows_update_matches_reference(opt, kind):
    """Three steps of ``update(sparse_rows={"t": kind})`` against the JAX
    optimizer on the same gradients: ``True`` the masked path, K = 2
    (below every step's touched count: the overflow takes the masked
    path), K = 5 (above the first step's), K = 20 (past the table: the
    masked path); the untouched rows and their slots keep their bits."""
    rs = np.random.RandomState(0)
    params = {"t": rs.randn(10, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32)}
    jo = getattr(jopt, CLASSES[opt])(**OPTS[opt])
    to = getattr(topt, CLASSES[opt])(**OPTS[opt])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    for step in range(3):
        grads = _sparse_grads(step)
        before = {k: v.clone() for k, v in tp.items()}
        slots_before = [s.clone() for s in topt.slot_leaves(
            ts["slots"]["t"])]
        jp, js = jo.update(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                           js, sparse_rows={"t": kind}, fused=False)
        to.update(tp, {k: torch.from_numpy(v) for k, v in grads.items()},
                  ts, sparse_rows={"t": kind})
        for k in params:
            close(tp[k], np.asarray(jp[k]), what=f"{opt} {k} step {step}")
        untouched = ~grads["t"].any(axis=1)
        assert untouched.sum() >= 7 - step
        assert torch.equal(tp["t"][untouched], before["t"][untouched])
        for new, old in zip(topt.slot_leaves(ts["slots"]["t"]),
                            slots_before):
            assert torch.equal(new[untouched], old[untouched])
    assert int(ts["step"]) == 3 == int(js["step"])


def test_row_apply_matches_reference():
    rs = np.random.RandomState(1)
    p = rs.randn(8, 3).astype(np.float32)
    rows = np.array([5, 1, 6], np.int32)
    g_rows = rs.randn(3, 3).astype(np.float32)
    live = np.array([True, False, True])
    jo, to = jopt.Adam(learning_rate=0.1), topt.Adam(learning_rate=0.1)
    jslots = jo.init_leaf(jnp.asarray(p))
    tslots = to.init_leaf(torch.from_numpy(p))
    step = 1
    jp2, js2 = jo.row_apply(jnp.asarray(p), jnp.asarray(rows),
                            jnp.asarray(g_rows), jslots, jnp.asarray(live),
                            0.1, jnp.asarray(step), decay=0.01)
    tp2, ts2 = to.row_apply(torch.from_numpy(p), torch.from_numpy(rows).long(),
                            torch.from_numpy(g_rows), tslots,
                            torch.from_numpy(live), 0.1,
                            torch.tensor(step, dtype=torch.int32),
                            decay=0.01)
    close(tp2, np.asarray(jp2))
    for t, j in zip(ts2, js2):
        close(t, np.asarray(j))
    assert torch.equal(tp2[[0, 1, 2, 3, 4, 7]],
                       torch.from_numpy(p)[[0, 1, 2, 3, 4, 7]])


# ---------------------------------------------------------------------------
# the quick_start demo's sparse LR through both trainers
# ---------------------------------------------------------------------------

VOCAB, LR_B = 1000, 8


def _lr_feeds():
    feeder = tdata.DataFeeder({"words": "sparse_ids", "label": "int"})
    rows = list(tdata.datasets.imdb("train", vocab_size=VOCAB,
                                    n=3 * LR_B)())
    jrows = list(jdata.datasets.imdb("train", vocab_size=VOCAB,
                                     n=3 * LR_B)())
    assert [r[0] for r in rows] == [list(r[0]) for r in jrows]
    return [feeder(rows[i * LR_B:(i + 1) * LR_B]) for i in range(3)]


def test_sparse_lr_trains_like_reference(tmp_path):
    """``sparse_lr_net`` (a ``sparse_grad`` table ``lr_w``) at VOCAB 1000
    on the synthetic imdb stream, words as ``sparse_ids``: 3 Adam steps
    through each package's ``SGDTrainer`` from the JAX trainer's initial
    checkpoint.  The losses and every parameter agree, and the rows of
    ``lr_w`` no batch touched keep their bits in both packages."""
    jnn.reset_naming()
    jc, _ = N.sparse_lr_net(jnn, VOCAB)
    tnn.reset_naming()
    tc, _ = N.sparse_lr_net(tnn, VOCAB)
    jtr = JaxTrainer(jc, jopt.Adam(learning_rate=0.05), seed=3)
    assert jtr.sparse_rows == {"lr_w": True}
    jtr.save(str(tmp_path), 0)
    ttr = SGDTrainer(tc, topt.Adam(learning_rate=0.05), seed=3,
                     device="cpu")
    assert ttr.sparse_rows == {"lr_w": True}
    ttr.load(str(tmp_path), 0)
    w0 = ttr.params["lr_w"].detach().clone()
    feeds = _lr_feeds()
    jl = [float(jtr.train_batch(f)) for f in feeds]
    tl = [ttr.train_batch(f).item() for f in feeds]
    assert all(np.isfinite(jl)) and int(ttr.opt_state["step"]) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for k, v in ttr.params.items():
        close(v, np.asarray(jtr.params[k]), what=k)
    seen = np.zeros(VOCAB, bool)
    for f in feeds:
        ids, nnz = f["words"]
        for row, n in zip(ids, nnz):
            seen[row[:n]] = True
    assert 0 < seen.sum() < VOCAB - 20
    untouched = torch.from_numpy(~seen)
    assert torch.equal(ttr.params["lr_w"].detach()[untouched],
                       w0[untouched])
    np.testing.assert_array_equal(np.asarray(jtr.params["lr_w"])[~seen],
                                  w0.numpy()[~seen])
    for slot in topt.slot_leaves(ttr.opt_state["slots"]["lr_w"]):
        assert not slot[untouched].any()
        assert slot[~untouched].abs().sum() > 0
