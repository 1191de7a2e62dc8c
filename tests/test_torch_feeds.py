"""The port's synthetic feeds (``paddle_tpu_torch.nn.feeds``, re-exported
as ``paddle_tpu_torch.serving.feeds``) against the JAX package's
``paddle_tpu.nn.feeds`` on the CPU: ``example_feed`` for every data-layer
kind (dense, int, image, sequences, nested, sparse COO, sparse sequences)
gives the reference's arrays, shapes and dtypes, all-zeros and seeded;
``zero_batch_like`` the reference's one-row feed; ``empty_outputs`` the
reference's zero-row outputs, and each feed runs through the port's
``Topology``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_feeds.py -q

Tolerance: none (arrays equal, dtypes equal).
"""

import jax
import numpy as np
import pytest

import paddle_tpu.nn as jnn
from paddle_tpu.nn import feeds as jfeeds

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn import feeds
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.serving import feeds as serving_feeds


def _net(nn):
    """One data layer of every kind, each reaching a cost-free output."""
    dense = nn.data("dense", size=5)
    ids = nn.data("ids", size=30, dtype="int32")
    img = nn.data("img", size=2, height=4, width=3)
    seq = nn.data("seq", size=4, is_seq=True)
    ids_seq = nn.data("ids_seq", size=30, is_seq=True, dtype="int32")
    nested = nn.data("nested", size=30, is_seq=True, dtype="int32",
                     nested=True)
    dnested = nn.data("dnested", size=3, is_seq=True, nested=True)
    sp = nn.data("sp", size=40, sparse="binary")
    spf = nn.data("spf", size=40, sparse="float")
    spseq = nn.data("spseq", size=40, is_seq=True, sparse="float")
    outs = [nn.fc(dense, 2, name="o_dense"),
            nn.embedding(ids, 3, name="o_ids"),
            nn.fc(img, 2, name="o_img"),
            nn.pooling(nn.fc(seq, 2, name="f_seq"), name="o_seq"),
            nn.pooling(nn.embedding(ids_seq, 3, name="e_seq"),
                       name="o_ids_seq"),
            nn.fc(sp, 2, name="o_sp"), nn.fc(spf, 2, name="o_spf"),
            nn.pooling(nn.fc(spseq, 2, name="f_spseq"), name="o_spseq")]

    def step(frame, mem):
        e = nn.embedding(frame, 3, vocab_size=30, name="g_emb")
        s = nn.fc([nn.last_seq(e, name="g_last"), mem], 3, name="g_fc")
        return [s, s]

    outs.append(nn.last_seq(nn.recurrent_group(
        step, [nested], [nn.Memory("m", 3)], name="o_nested")))

    def dstep(frame, mem):
        s = nn.fc([nn.pooling(frame, name="d_pool"), mem], 3, name="d_fc")
        return [s, s]

    outs.append(nn.last_seq(nn.recurrent_group(
        dstep, [dnested], [nn.Memory("dm", 3)], name="o_dnested")))
    return outs


def _topos():
    jnn.reset_naming()
    jt = jnn.Topology(_net(jnn))
    tnn.reset_naming()
    tt = tnn.Topology(_net(tnn), device="cpu")
    return jt, tt


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, tuple):
            assert isinstance(g, tuple) and len(g) == len(w), k
        else:
            g, w = (g,), (w,)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("seeded", [False, True])
def test_example_feed_of_every_kind_equals_the_reference(seeded):
    jt, tt = _topos()
    kw = dict(batch=3, seq_len=5, nnz=2)
    got = feeds.example_feed(
        tt, rng=np.random.RandomState(4) if seeded else None, **kw)
    want = jfeeds.example_feed(
        jt, rng=np.random.RandomState(4) if seeded else None, **kw)
    _assert_same(got, want)
    assert serving_feeds.example_feed is feeds.example_feed
    with compute_dtype_scope("float32"):
        outs, _ = tt.apply(tt.init(0)[0], {}, got)
    assert all(np.isfinite(a.value.detach().numpy()).all()
               for a in outs.values() if a.value.is_floating_point())


def test_zero_batch_like_and_empty_outputs_equal_the_reference():
    jt, tt = _topos()
    feed = feeds.example_feed(tt, batch=2)
    empty = {k: (tuple(a[:0] for a in v) if isinstance(v, tuple) else v[:0])
             for k, v in feed.items()}
    one = feeds.zero_batch_like(empty)
    _assert_same(one, jfeeds.zero_batch_like(empty))
    names = [l.name for l in tt.outputs]
    jp, js = jt.init(jax.random.PRNGKey(0))

    def jrun(p, s, f):
        o, _ = jt.apply(p, s, f)
        return {n: o[n].value for n in names}

    with compute_dtype_scope("float32"):
        tp, ts = tt.init(0)

        def trun(p, s, f):
            o, _ = tt.apply(p, s, f)
            return {n: o[n].value for n in names}

        got = feeds.empty_outputs(trun, tp, ts, one)
    want = jfeeds.empty_outputs(jrun, jp, js, one)
    assert set(got) == set(want)
    for n in names:
        assert got[n].shape == want[n].shape and got[n].shape[0] == 0, n
        assert got[n].dtype == want[n].dtype, n
