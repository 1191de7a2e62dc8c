"""The port's text-tier ops against the JAX package's, on the CPU: the
sequence ops (``ops/sequence.py``: expand, reverse, concat, the context
window with zero and trainable padding, the window slice),
``sequence_softmax``, the cost family (``ops/losses.py``),
``dot_product_attention``, ``one_hot`` and the linear-chain CRF
(``ops/crf.py``), forward and gradient; the CRF also against brute force
over every tag path, as ``tests/test_crf_ctc.py`` holds the reference.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sequence.py -q

Inputs come from numpy with a seed, with ragged lengths and a length-1
row.  Tolerance: rtol 1e-5 and an absolute 1e-6 of the larger of 1 and
the reference's largest entry (``close``, the one ``tests/test_rnn_fused.py``
pins): float32 sums taken in another order; gathers and shifts are exact.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
import paddle_tpu.ops.sequence as JS

import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.ops import compute_dtype_scope

from torch_compare import close, fwd_grad, randn

B, T, D = 4, 6, 3
#: ragged lengths with a length-1 row and a full one
LENS = np.array([6, 1, 4, 3], np.int32)


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


def mask(lens=LENS, t=T):
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/sequence.py
# ---------------------------------------------------------------------------


def test_seq_expand():
    fwd_grad(JO.seq_expand, TO.seq_expand, randn(B, D), mask())


def test_seq_reverse_keeps_the_padding_and_routes_gradients():
    x = randn(B, T, D, seed=1)
    fwd_grad(JO.seq_reverse, TO.seq_reverse, x, LENS)
    got = TO.seq_reverse(torch.tensor(x), torch.tensor(LENS)).numpy()
    # the padded positions keep their own values, unzeroed
    np.testing.assert_array_equal(got[1, 1:], x[1, 1:])
    np.testing.assert_array_equal(got[0], x[0, ::-1])


@pytest.mark.parametrize("tb", [6, 2])
def test_seq_concat(tb):
    a, b = randn(B, T, D, seed=2), randn(B, tb, D, seed=3)
    lb = np.minimum(np.array([2, 1, 2, 1], np.int32), tb)
    fwd_grad(lambda a_, b_: JO.seq_concat(a_, jnp.asarray(LENS), b_,
                                          jnp.asarray(lb))[0],
             lambda a_, b_: TO.seq_concat(a_, torch.tensor(LENS), b_,
                                          torch.tensor(lb))[0], a, b)
    v, l = TO.seq_concat(torch.tensor(a), torch.tensor(LENS), torch.tensor(b),
                         torch.tensor(lb))
    assert v.shape == (B, T + tb, D) and l.tolist() == (LENS + lb).tolist()
    # b's gradient reaches its real rows only
    bt = torch.tensor(b, requires_grad=True)
    TO.seq_concat(torch.tensor(a), torch.tensor(LENS), bt,
                  torch.tensor(lb))[0].sum().backward()
    assert not bt.grad.numpy()[np.arange(tb)[None] >= lb[:, None]].any()


@pytest.mark.parametrize("ctx_len,start", [(3, -1), (3, -2), (2, 1),
                                           (5, -2), (4, 0), (1, 0),
                                           (3, -7)])
def test_context_projection_zero_padding(ctx_len, start):
    x = randn(B, T, D, seed=4)
    fwd_grad(lambda v, m: JO.context_projection(v, m, ctx_len, start),
             lambda v, m: TO.context_projection(v, m, ctx_len, start),
             x, mask(), argnums=(0,))


def test_context_projection_reads_zeros_past_a_rows_end():
    """The input is masked before the shift: a window crossing a row's end
    reads zeros, not the padded values."""
    x = randn(B, T, D, seed=5)
    out = TO.context_projection(torch.tensor(x), torch.tensor(mask()), 3,
                                -1).numpy()
    L = LENS[2]
    np.testing.assert_array_equal(out[2, L - 1, 2 * D:], 0.0)
    np.testing.assert_array_equal(out[2, L - 1, D:2 * D], x[2, L - 1])
    np.testing.assert_array_equal(out[2, L:], 0.0)


@pytest.mark.parametrize("ctx_len,start", [(3, -1), (3, -2), (4, 0),
                                           (5, -2), (2, 1)])
def test_context_projection_trainable_padding(ctx_len, start):
    begin, end = max(0, -start), max(0, start + ctx_len - 1)
    x = randn(B, T, D, seed=6)
    pad = randn(begin + end, D, seed=7)
    fwd_grad(lambda v, p: JO.context_projection_trainable(
                 v, jnp.asarray(LENS), jnp.asarray(mask()), ctx_len, start,
                 p),
             lambda v, p: TO.context_projection_trainable(
                 v, torch.tensor(LENS), torch.tensor(mask()), ctx_len,
                 start, p), x, pad)


def test_trainable_padding_gradient_reaches_the_used_rows_only():
    """With start 0 and length 4 only end rows exist; a row of length 6 at
    T = 6 never reaches position length + 2, but a row of length 1 does:
    the end rows stand in for positions >= the row's length."""
    x = torch.tensor(randn(B, T, D, seed=8))
    pad = torch.tensor(randn(3, D, seed=9), requires_grad=True)
    one = np.array([6, 6, 6, 6], np.int32)
    TO.context_projection_trainable(
        x, torch.tensor(one), torch.tensor(mask(one)), 4, 0,
        pad).sum().backward()
    g_full = pad.grad.clone()
    pad.grad = None
    TO.context_projection_trainable(
        x, torch.tensor(LENS), torch.tensor(mask()), 4, 0,
        pad).sum().backward()
    assert (pad.grad.abs().sum(1) > 0).all()
    assert (g_full.abs().sum(1) > 0).tolist() == [True, True, True]
    # rows of length 6 at T = 6 use end row q at positions 6 + q only from
    # t = 3 + q: 3, 2 and 1 uses (times 4 rows) of rows 0, 1, 2
    np.testing.assert_allclose(g_full.sum(1).numpy(), [4 * 3 * D, 4 * 2 * D,
                                                       4 * 1 * D])


def test_seq_slice_window():
    x = randn(B, T, D, seed=10)
    starts = np.array([0, 3, 5, -1], np.int32)
    fwd_grad(lambda v: JS.seq_slice_window(v, jnp.asarray(starts), 3),
             lambda v: TO.seq_slice_window(v, torch.tensor(starts), 3), x)


# ---------------------------------------------------------------------------
# activations, losses, attention, one_hot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(B, T, 1), (B, T)])
def test_sequence_softmax(shape):
    x = randn(*shape, seed=11, scale=3.0)
    fwd_grad(lambda v, m: JO.sequence_softmax(v, m),
             lambda v, m: TO.sequence_softmax(v, m), x, mask(),
             argnums=(0,))
    fwd_grad(JO.sequence_softmax, TO.sequence_softmax, x)
    if len(shape) == 3:  # the time axis: each row's real steps sum to 1
        p = TO.sequence_softmax(torch.tensor(x), torch.tensor(mask()))
        np.testing.assert_allclose(p.numpy()[..., 0].sum(1), 1.0, rtol=1e-6)
    assert TO.get_activation("sequence_softmax") is TO.sequence_softmax


LOSSES = {
    "soft_cross_entropy": lambda m, x, y: m.soft_cross_entropy(x, y),
    "binary_cross_entropy": lambda m, x, y: m.binary_cross_entropy(x, y),
    "multi_binary_label_cross_entropy":
        lambda m, x, y: m.multi_binary_label_cross_entropy(x, y),
    "mse": lambda m, x, y: m.mse(x, y),
    "huber": lambda m, x, y: m.huber(x, y),
    "huber_delta_0.5": lambda m, x, y: m.huber(x, y, 0.5),
    "smooth_l1": lambda m, x, y: m.smooth_l1(x, y),
    "rank_cost": lambda m, x, y: m.rank_cost(x[:, :1], x[:, 1:2], y[:, :1]),
    "rank_cost_weighted": lambda m, x, y: m.rank_cost(
        x[:, :1], x[:, 1:2], y[:, :1], weight=y[:, 1:2] + 0.5),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_reference(name):
    x = randn(5, 4, seed=12, scale=3.0)
    if name == "soft_cross_entropy":
        y = np.abs(randn(5, 4, seed=13)) + 0.1
        y = (y / y.sum(1, keepdims=True)).astype(np.float32)
    elif "binary" in name or "rank" in name:
        y = (randn(5, 4, seed=13) > 0).astype(np.float32)
    else:
        y = randn(5, 4, seed=13, scale=2.0)  # both sides of delta
    fwd_grad(lambda a, b: LOSSES[name](JO, a, b),
             lambda a, b: LOSSES[name](TO, a, b), x, y)


@pytest.mark.parametrize("with_mask", [False, True])
def test_dot_product_attention(with_mask):
    q, k, v = (randn(2, 3, 4, 5, seed=s) for s in (14, 15, 16))
    k, v = k[:, :, :3], v[:, :, :3]
    m = (np.arange(3)[None, None, None] < np.array([3, 1])[:, None, None,
                                                            None]).astype(
        np.float32) if with_mask else None
    fwd_grad(lambda a, b, c: JO.dot_product_attention(
                 a, b, c, None if m is None else jnp.asarray(m)),
             lambda a, b, c: TO.dot_product_attention(
                 a, b, c, None if m is None else torch.tensor(m)), q, k, v)


def test_one_hot():
    ids = np.array([[0, 3], [2, 1]], np.int32)
    np.testing.assert_array_equal(TO.one_hot(torch.tensor(ids), 4).numpy(),
                                  np.asarray(JO.one_hot(jnp.asarray(ids), 4)))


# ---------------------------------------------------------------------------
# ops/crf.py
# ---------------------------------------------------------------------------

C = 3


def _crf_inputs(seed=0):
    rs = np.random.RandomState(seed)
    emis = rs.randn(B, T, C).astype(np.float32)
    start, end = (0.5 * rs.randn(C)).astype(np.float32), \
        (0.5 * rs.randn(C)).astype(np.float32)
    trans = (0.5 * rs.randn(C, C)).astype(np.float32)
    tags = rs.randint(0, C, (B, T)).astype(np.int32)
    return emis, tags, start, end, trans


def _brute_force_crf(emis, start, end, trans, L):
    """Every tag path of length L -> (logZ, best path, best score)."""
    scores = {}
    for path in itertools.product(range(C), repeat=L):
        s = start[path[0]] + emis[0, path[0]]
        for t in range(1, L):
            s += trans[path[t - 1], path[t]] + emis[t, path[t]]
        scores[path] = s + end[path[-1]]
    logz = np.logaddexp.reduce(np.array(list(scores.values()), np.float64))
    best = max(scores, key=scores.get)
    return logz, best, scores[best]


def test_crf_log_likelihood_and_nll_match_reference():
    emis, tags, start, end, trans = _crf_inputs()
    m = mask()
    for jf, tf in ((JO.crf_log_likelihood, TO.crf_log_likelihood),
                   (JO.crf_nll, TO.crf_nll)):
        fwd_grad(lambda e, s, n, w: jf(e, jnp.asarray(tags), jnp.asarray(m),
                                       s, n, w),
                 lambda e, s, n, w: tf(e, torch.tensor(tags),
                                       torch.tensor(m), s, n, w),
                 emis, start, end, trans)


def test_crf_log_likelihood_against_brute_force():
    emis, tags, start, end, trans = _crf_inputs(1)
    ll = TO.crf_log_likelihood(*(torch.tensor(a) for a in (
        emis, tags, mask(), start, end, trans))).numpy()
    for b in range(B):
        L = int(LENS[b])
        logz, _, _ = _brute_force_crf(emis[b], start, end, trans, L)
        path = tuple(tags[b, :L])
        s = start[path[0]] + emis[b, 0, path[0]]
        for t in range(1, L):
            s += trans[path[t - 1], path[t]] + emis[b, t, path[t]]
        np.testing.assert_allclose(ll[b], s + end[path[-1]] - logz,
                                   rtol=1e-5, atol=1e-5)


def test_crf_decode_matches_reference_and_brute_force():
    emis, _, start, end, trans = _crf_inputs(2)
    args = (emis, mask(), start, end, trans)
    tags, score = TO.crf_decode(*(torch.tensor(a) for a in args))
    jtags, jscore = JO.crf_decode(*(jnp.asarray(a) for a in args))
    assert tags.dtype == torch.int32
    np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
    close(score, jscore)
    for b in range(B):
        L = int(LENS[b])
        _, best, best_score = _brute_force_crf(emis[b], start, end, trans, L)
        np.testing.assert_array_equal(tags[b, :L].numpy(), best)
        np.testing.assert_array_equal(tags[b, L:].numpy(), 0)
        np.testing.assert_allclose(score[b].item(), best_score, rtol=1e-5)


def test_crf_decode_breaks_ties_as_the_reference():
    """Zero parameters and tied emissions: every path ties, and both
    packages take the first maximal index at every step."""
    emis = np.zeros((B, T, C), np.float32)
    emis[:, :, 1:] = 0.25  # tags 1 and 2 tie everywhere
    z, zz = np.zeros(C, np.float32), np.zeros((C, C), np.float32)
    args = (emis, mask(), z, z, zz)
    tags, _ = TO.crf_decode(*(torch.tensor(a) for a in args))
    jtags, _ = JO.crf_decode(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
    assert set(np.unique(tags.numpy()[mask() > 0])) == {1}
