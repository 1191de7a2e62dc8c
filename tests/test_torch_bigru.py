"""The port's fused bidirectional GRU — K11's plain versions
(``paddle_tpu_torch/ops/kernels/bigru.py``), ``bigru_sequence_fused``
(ops/rnn_fused.py) and ``bigru_layer``'s fused branch under
``FLAGS.fused_bigru`` (ops/rnn.py) — against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_bigru.py`` does: ``_gru_pallas_raw`` and
``_gru_bwd_pallas_raw`` with ``batch_split=B`` directly, and
``bigru_layer`` forced through its fused branch by monkeypatching
``paddle_tpu.ops.rnn_fused._use_pallas_bigru``.  On the CPU the port's
wrappers run their plain versions.  Tolerances are the JAX file's: values
rtol 1e-5 / atol 1e-6, gradients rtol 2e-5 / atol 2e-6.  The flagship's
loss and 19 gradients with both of the slice's switches on (this one and
``ops/losses.py``'s ``_USE_LSE_READOUT``) are held against
``jax.value_and_grad`` with the reference's switches forced, at the
tolerances of ``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
from paddle_tpu.models import Seq2SeqAttention as JaxSeq2Seq
from paddle_tpu.ops import losses as j_losses
from paddle_tpu.ops import rnn_fused as j_rnn_fused
from paddle_tpu.ops.pallas_kernels import (_gru_bwd_pallas_raw,
                                           _gru_pallas_raw)
from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention, params_from_jax
from paddle_tpu_torch.ops import bigru_layer, losses
from paddle_tpu_torch.ops.kernels import (bigru_backward,
                                          bigru_backward_plain,
                                          bigru_forward, bigru_forward_plain,
                                          launch_counts)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.ops.rnn_fused import bigru_sequence_fused
from paddle_tpu_torch.utils.flags import FLAGS, Flags

#: (B, T, H, lengths): B = 5 and 33 are not multiples of the kernel's
#: 32-row blocks, so a partial block sits on each side of the split
_SHAPES = [(4, 6, 8, [6, 3, 5, 1]), (5, 9, 16, [9, 1, 4, 9, 7]),
           (33, 4, 8, None)]


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


def _lengths(rng, B, T, lengths):
    if lengths is None:
        lengths = rng.randint(1, T + 1, (B,))
        lengths[0] = T
    return np.asarray(lengths)


def _stacked(rng, B, T, H, lengths):
    """A stacked bidirectional batch, time-major: xp [T, 2B, 3H], the mask
    [T, 2B] with the backward half flipped in time, w2 [2H, 3H]."""
    lens = _lengths(rng, B, T, lengths)
    m = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    m2 = np.concatenate([m, m[:, ::-1]]).T.copy()
    xp = (rng.randn(T, 2 * B, 3 * H) * 0.3).astype(np.float32)
    w2 = (rng.randn(2 * H, 3 * H) * 0.2).astype(np.float32)
    return xp, m2, w2


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=(1e-5, 1e-6), name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1], err_msg=name)


@pytest.mark.parametrize("residuals", [True, False])
@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_bigru_forward_matches_pallas(rng, B, T, H, lengths, residuals):
    """K11 forward: h_seq, h_final and (training) z and h_prev of the
    stacked batch."""
    xp, m2, w2 = _stacked(rng, B, T, H, lengths)
    want = _gru_pallas_raw(jnp.asarray(xp), jnp.asarray(m2),
                           jnp.asarray(w2), residuals=residuals,
                           batch_split=B)
    got = bigru_forward(_t(xp), _t(m2), _t(w2), residuals=residuals,
                        batch_split=B)
    assert len(got) == len(want) == (4 if residuals else 2)
    shapes = [(T, 2 * B, H), (2 * B, H), (T, 2 * B, 3 * H), (T, 2 * B, H)]
    for g, w, shape, name in zip(got, want, shapes,
                                 ("h_seq", "h_fin", "z", "h_prev")):
        assert tuple(g.shape) == shape and g.dtype == torch.float32, name
        _close(g.numpy(), w, name=name)


@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_bigru_backward_matches_pallas(rng, B, T, H, lengths):
    """K11 reverse from the reference's own residuals: d_z and d_h0, with
    the reference's column-stacked w_t [3H, 2H]."""
    xp, m2, w2 = _stacked(rng, B, T, H, lengths)
    _, _, z, hp = _gru_pallas_raw(jnp.asarray(xp), jnp.asarray(m2),
                                  jnp.asarray(w2), residuals=True,
                                  batch_split=B)
    w_t = np.concatenate([w2[:H].T, w2[H:].T], 1)
    d_out = rng.randn(T, 2 * B, H).astype(np.float32)
    d_hfin = rng.randn(2 * B, H).astype(np.float32)
    want = _gru_bwd_pallas_raw(jnp.asarray(d_out), jnp.asarray(m2), z, hp,
                               jnp.asarray(w_t), jnp.asarray(d_hfin),
                               batch_split=B)
    got = bigru_backward(_t(d_out), _t(m2), _t(z), _t(hp), _t(w_t),
                         _t(d_hfin), batch_split=B)
    for g, w, name in zip(got, want, ("d_z", "d_h0")):
        _close(g.numpy(), w, name=name)


def _layer_args(rng, B=4, T=6, E=8, H=8, lengths=(6, 3, 5, 1)):
    """tests/test_bigru.py's arguments, as numpy."""
    x = (rng.randn(B, T, E) * 0.3).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)

    def w(shape, s=0.2):
        return (rng.randn(*shape) * s).astype(np.float32)

    return (x, mask, w((E, 3 * H)), w((H, 3 * H)), np.zeros(3 * H, np.float32),
            w((E, 3 * H)), w((H, 3 * H)), np.zeros(3 * H, np.float32))


_LAYER_CASES = [dict(), dict(B=5, T=7, E=6, H=16, lengths=(7, 1, 4, 7, 2))]
_GRAD_NAMES = ("x", "wx_fw", "wh_fw", "wx_bw", "wh_bw")


def _jax_layer(args, ct):
    """The reference's bigru_layer (values) and the gradients of
    tests/test_bigru.py's loss in x, wx_fw, wh_fw, wx_bw, wh_bw."""
    ja = [jnp.asarray(a) for a in args]

    def loss(x, wxf, whf, wxb, whb):
        h_fw, h_bw, h_fin = JO.bigru_layer(x, ja[1], wxf, whf, ja[4], wxb,
                                           whb, ja[7])
        return (jnp.sum(h_fw * ct) + jnp.sum(h_bw * ct * 0.5)
                + jnp.sum(h_fin ** 2))

    dv = (ja[0], ja[2], ja[3], ja[5], ja[6])
    grads = jax.grad(loss, argnums=tuple(range(5)))(*dv)
    return JO.bigru_layer(*ja), grads


def _port_layer(args, ct):
    ta = [_t(a) for a in args]
    leaves = [ta[i].requires_grad_() for i in (0, 2, 3, 5, 6)]
    h_fw, h_bw, h_fin = bigru_layer(*ta)
    loss = ((h_fw * _t(ct)).sum() + (h_bw * _t(ct) * 0.5).sum()
            + (h_fin ** 2).sum())
    return (h_fw, h_bw, h_fin), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", range(len(_LAYER_CASES)))
def test_fused_bigru_layer_matches_the_reference_fused_branch(
        monkeypatch, rng, case):
    """The port's bigru_layer with ``fused_bigru`` on against the
    reference's forced through ``bigru_sequence_fused`` (interpret mode):
    h_fw, h_bw, h_bw_fin and the five gradients."""
    args = _layer_args(rng, **_LAYER_CASES[case])
    B, T = args[1].shape
    ct = rng.randn(B, T, args[3].shape[0]).astype(np.float32)
    monkeypatch.setattr(j_rnn_fused, "_use_pallas_bigru", lambda B, H: True)
    monkeypatch.setattr(FLAGS, "fused_bigru", True)
    (jv, jg), (tv, tg) = _jax_layer(args, ct), _port_layer(args, ct)
    for a, b, name in zip(tv, jv, ("h_fw", "h_bw", "h_bw_fin")):
        _close(a.detach().numpy(), b, name=name)
    for a, b, name in zip(tg, jg, _GRAD_NAMES):
        _close(a.numpy(), b, tol=(2e-5, 2e-6), name=name)


@pytest.mark.parametrize("case", range(len(_LAYER_CASES)))
def test_fused_bigru_layer_matches_the_two_call_branch(monkeypatch, rng,
                                                       case):
    """The port's own two branches agree: values bit for bit (each row's
    arithmetic is the same), gradients to rounding (d_w summed per
    direction over the stacked batch)."""
    args = _layer_args(rng, **_LAYER_CASES[case])
    B, T = args[1].shape
    ct = rng.randn(B, T, args[3].shape[0]).astype(np.float32)
    two_v, two_g = _port_layer(args, ct)
    monkeypatch.setattr(FLAGS, "fused_bigru", True)
    before = launch_counts()
    fused_v, fused_g = _port_layer(args, ct)
    assert launch_counts() == before          # CPU: plain versions only
    for a, b in zip(fused_v, two_v):
        assert torch.equal(a, b)
    for a, b, name in zip(fused_g, two_g, _GRAD_NAMES):
        _close(a.numpy(), b.numpy(), tol=(2e-5, 2e-6), name=name)


def test_fused_bigru_layer_without_grad_runs_the_inference_variant(
        monkeypatch, rng):
    """Under no_grad the fused branch stores no residuals and gives the
    same values."""
    args = [_t(a) for a in _layer_args(rng)]
    monkeypatch.setattr(FLAGS, "fused_bigru", True)
    with_grad = bigru_layer(*args)
    with torch.no_grad():
        no_grad = bigru_layer(*args)
    for a, b in zip(no_grad, with_grad):
        assert torch.equal(a, b)
        assert not a.requires_grad


def test_bigru_sequence_fused_gradients_are_per_direction(rng):
    """d_w_fw comes from the forward rows only and d_w_bw from the
    backward rows only: a cotangent on one half leaves the other
    direction's weight gradient zero."""
    B, T, H = 3, 5, 8
    xp, m2, w2 = _stacked(rng, B, T, H, None)
    xp2 = _t(xp).transpose(0, 1).requires_grad_()
    w_fw, w_bw = (_t(w2[:H]).requires_grad_(), _t(w2[H:]).requires_grad_())
    h2, _ = bigru_sequence_fused(xp2, _t(m2).t(), w_fw, w_bw, B)
    d_xp, d_fw, d_bw = torch.autograd.grad(h2[:B].sum(), [xp2, w_fw, w_bw])
    assert d_fw.abs().max() > 0 and torch.equal(d_bw, torch.zeros_like(d_bw))
    assert torch.equal(d_xp[B:], torch.zeros_like(d_xp[B:]))


def test_bigru_wrappers_on_the_cpu_run_the_plain_versions_and_check(rng):
    """On the CPU a wrapper runs its plain version and counts no launch;
    both refuse a split that does not halve the batch and shapes that do
    not fit."""
    B, T, H = 3, 4, 8
    xp, m2, w2 = (_t(a) for a in _stacked(rng, B, T, H, None))
    before = launch_counts()
    got = bigru_forward(xp, m2, w2, residuals=True, batch_split=B)
    want = bigru_forward_plain(xp, m2, w2, residuals=True, batch_split=B)
    w_t = torch.cat([w2[:H].t(), w2[H:].t()], 1)
    d_out, d_hfin = torch.randn(T, 2 * B, H), torch.randn(2 * B, H)
    g_bwd = bigru_backward(d_out, m2, got[2], got[3], w_t, d_hfin,
                           batch_split=B)
    p_bwd = bigru_backward_plain(d_out, m2, got[2], got[3], w_t, d_hfin,
                                 batch_split=B)
    assert launch_counts() == before
    for a, b in zip(got + g_bwd, want + p_bwd):
        assert torch.equal(a, b)
    for split in (0, 2, 4):
        with pytest.raises(ValueError, match="2 \\* batch_split"):
            bigru_forward(xp, m2, w2, batch_split=split)
        with pytest.raises(ValueError, match="2 \\* batch_split"):
            bigru_backward(d_out, m2, got[2], got[3], w_t, d_hfin,
                           batch_split=split)
    with pytest.raises(ValueError, match="w2 must be"):
        bigru_forward(xp, m2, w2[:H], batch_split=B)
    with pytest.raises(ValueError, match="mask must be"):
        bigru_forward(xp, m2[:, :B], w2, batch_split=B)
    with pytest.raises(ValueError, match="w_t must be"):
        bigru_backward(d_out, m2, got[2], got[3], w_t[:, :H], d_hfin,
                       batch_split=B)
    with pytest.raises(ValueError, match="residuals must share"):
        bigru_backward(d_out, m2, got[2], got[3].bfloat16(), w_t, d_hfin,
                       batch_split=B)


def test_fused_bigru_is_off_by_default():
    """As the reference's ``use_pallas_bigru``."""
    assert Flags().fused_bigru is False


# ---------------------------------------------------------------------------
# the slice as a whole: the flagship's training loss with both switches on
# ---------------------------------------------------------------------------

_CFG = dict(src_vocab=60, trg_vocab=90, emb_dim=16, enc_dim=24, dec_dim=32,
            att_dim=20)


def _batch(seed=0, B=4, S=7, T=6):
    rs = np.random.RandomState(seed)
    core = rs.randint(3, _CFG["trg_vocab"], (B, T - 1)).astype(np.int32)
    return {
        "src_ids": rs.randint(3, _CFG["src_vocab"], (B, S)).astype(np.int32),
        "src_len": np.array([S, 3, 5, 1][:B], np.int32),
        "trg_in": np.concatenate([np.zeros((B, 1), np.int32), core], 1),
        "trg_next": np.concatenate([core, np.ones((B, 1), np.int32)], 1),
        "trg_len": np.array([T, 2, 4, T][:B], np.int32),
    }


def test_flagship_loss_and_19_gradients_with_both_switches_match_jax(
        monkeypatch):
    """``fused_bigru`` and ``_USE_LSE_READOUT`` on against the reference
    with ``_use_pallas_bigru`` and ``_USE_PALLAS_LSE_READOUT`` forced
    (B*T = 24, so the reference's lse kernel runs, in interpret mode):
    loss rtol 1e-5, each gradient within 2e-4 of its largest entry.  The
    embeddings and ``att_v`` are scaled up so that the attention's
    gradients stand above float32 rounding."""
    jm = JaxSeq2Seq(**_CFG)
    jp = jm.init(jax.random.PRNGKey(5))
    for k, f in (("src_emb", 50.0), ("trg_emb", 50.0), ("att_v", 20.0)):
        jp[k] = jp[k] * f
    batch = _batch()
    monkeypatch.setattr(j_rnn_fused, "_use_pallas_bigru", lambda B, H: True)
    monkeypatch.setattr(j_losses, "_USE_PALLAS_LSE_READOUT", True)
    l_ref, g_ref = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(FLAGS, "fused_bigru", True)
    monkeypatch.setattr(losses, "_USE_LSE_READOUT", True)
    tm = Seq2SeqAttention(**_CFG, device="cpu")
    tp = {k: v.requires_grad_() for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    loss = tm.loss(tp, batch)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert len(grads) == 19
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               rtol=1e-5)
    for name, g in zip(tp, grads):
        want = np.asarray(g_ref[name], np.float64)
        sc = np.abs(want).max()
        assert sc > 0, name
        np.testing.assert_allclose(g.double().numpy() / sc, want / sc,
                                   atol=2e-4, err_msg=name)
