"""The port's GRU training path — K3 with residuals, K4 and the
``gru_sequence_fused`` autograd function (paddle_tpu_torch/ops/kernels/
gru.py, ops/rnn_fused.py) — against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_kernels.py:150-172`` does: ``_gru_pallas_raw`` and
``_gru_bwd_pallas_raw`` directly, and ``gru_sequence_fused`` with
``_use_pallas_rnn`` and ``_bwd_pallas_ok`` forced on.  On the CPU the
port's wrappers run their plain versions.  Tolerance: rtol 1e-5 /
atol 1e-6 (the JAX file's); under bfloat16 residuals 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
from paddle_tpu.ops.pallas_kernels import (_gru_bwd_pallas_raw,
                                           _gru_pallas_raw)
from paddle_tpu.ops.rnn_fused import gru_sequence_fused as j_gru_fused
from paddle_tpu.ops.rnn_fused import residual_dtype as j_residual_dtype
from paddle_tpu_torch.ops import gru_layer as t_gru_layer
from paddle_tpu_torch.ops.kernels import (gru_backward, gru_backward_plain,
                                          gru_forward, launch_counts)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope, residual_dtype
from paddle_tpu_torch.ops.rnn_fused import gru_sequence_fused

_SHAPES = [(4, 6, 8, [6, 3, 5, 1]), (5, 9, 16, [9, 1, 4, 9, 7]),
           (8, 4, 32, [4, 4, 2, 3, 1, 4, 2, 3])]


def _data(rng, B, T, H, lengths):
    xp = (rng.randn(B, T, 3 * H) * 0.3).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    w_h = (rng.randn(H, 3 * H) * 0.2).astype(np.float32)
    return xp, mask, w_h


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=(1e-5, 1e-6)):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_gru_forward_residuals_match_pallas(rng, B, T, H, lengths):
    """K3 with residuals: h_seq, h_final, z and h_prev (time-major)."""
    xp, mask, w_h = _data(rng, B, T, H, lengths)
    want = _gru_pallas_raw(jnp.moveaxis(jnp.asarray(xp), 1, 0),
                           jnp.asarray(mask.T), jnp.asarray(w_h),
                           residuals=True)
    with compute_dtype_scope("float32"):
        h_seq, h_fin, z, hp = gru_forward(_t(xp), _t(mask), _t(w_h),
                                          residuals=True)
    assert z.dtype == hp.dtype == torch.float32
    assert tuple(z.shape) == (T, B, 3 * H) and tuple(hp.shape) == (T, B, H)
    _close(h_seq.transpose(0, 1).numpy(), want[0])
    _close(h_fin.numpy(), want[1])
    _close(z.numpy(), want[2])
    _close(hp.numpy(), want[3])


def _bwd_inputs(rng, B, T, H, lengths):
    xp, mask, w_h = _data(rng, B, T, H, lengths)
    _, _, z, hp = _gru_pallas_raw(jnp.moveaxis(jnp.asarray(xp), 1, 0),
                                  jnp.asarray(mask.T), jnp.asarray(w_h),
                                  residuals=True)
    d_out = rng.randn(T, B, H).astype(np.float32)
    d_hfin = rng.randn(B, H).astype(np.float32)
    return mask.T.copy(), np.asarray(z), np.asarray(hp), w_h, d_out, d_hfin


@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_gru_backward_matches_pallas(rng, B, T, H, lengths):
    """K4: d_z and d_h0 from the same residuals."""
    m_tb, z, hp, w_h, d_out, d_hfin = _bwd_inputs(rng, B, T, H, lengths)
    want_dz, want_dh0 = _gru_bwd_pallas_raw(
        jnp.asarray(d_out), jnp.asarray(m_tb), jnp.asarray(z),
        jnp.asarray(hp), jnp.asarray(w_h.T.copy()), jnp.asarray(d_hfin))
    before = launch_counts()["gru_backward"]
    d_z, d_h0 = gru_backward(_t(d_out), _t(m_tb), _t(z), _t(hp),
                             _t(w_h.T), _t(d_hfin))
    assert launch_counts()["gru_backward"] == before  # plain version ran
    _close(d_z.numpy(), want_dz)
    _close(d_h0.numpy(), want_dh0)


def test_gru_kernels_bf16_residuals_match_pallas(rng, monkeypatch):
    """Under the bfloat16 policy the residuals are bf16 (H <= 512) on both
    sides; forward and reverse loop agree within bf16 rounding."""
    from paddle_tpu.utils.flags import FLAGS

    monkeypatch.setattr(FLAGS, "compute_dtype", "bfloat16")
    B, T, H = 8, 5, 16
    xp, mask, w_h = _data(rng, B, T, H, [5, 4, 3, 5, 1, 2, 5, 5])
    want = _gru_pallas_raw(jnp.moveaxis(jnp.asarray(xp), 1, 0),
                           jnp.asarray(mask.T), jnp.asarray(w_h),
                           residuals=True)
    assert want[2].dtype == jnp.bfloat16
    with compute_dtype_scope("bfloat16"):
        h_seq, h_fin, z, hp = gru_forward(_t(xp), _t(mask), _t(w_h),
                                          residuals=True)
        assert z.dtype == hp.dtype == torch.bfloat16
        for got, ref in ((h_seq.transpose(0, 1), want[0]), (h_fin, want[1]),
                         (z.float(), want[2]), (hp.float(), want[3])):
            _close(got.numpy(), np.asarray(ref, np.float32), (2e-2, 2e-2))
        d_out = rng.randn(T, B, H).astype(np.float32)
        d_hfin = rng.randn(B, H).astype(np.float32)
        want_dz, want_dh0 = _gru_bwd_pallas_raw(
            jnp.asarray(d_out), jnp.asarray(mask.T), want[2], want[3],
            jnp.asarray(w_h.T.copy()), jnp.asarray(d_hfin))
        z_j = _t(want[2].astype(jnp.float32)).bfloat16()
        hp_j = _t(want[3].astype(jnp.float32)).bfloat16()
        d_z, d_h0 = gru_backward(_t(d_out), _t(mask.T), z_j, hp_j,
                                 _t(w_h.T), _t(d_hfin))
    _close(d_z.numpy(), want_dz)
    _close(d_h0.numpy(), want_dh0)


@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_gru_sequence_fused_grads_match_jax_pallas_path(rng, monkeypatch, B,
                                                        T, H, lengths):
    """The autograd function against the JAX custom VJP with both Pallas
    kernels forced on (interpret mode): d_xp, d_w_h and d_h0."""
    monkeypatch.setattr("paddle_tpu.ops.rnn._use_pallas_rnn",
                        lambda B, H: True)
    monkeypatch.setattr("paddle_tpu.ops.rnn_fused._bwd_pallas_ok",
                        lambda B, H: True)
    xp, mask, w_h = _data(rng, B, T, H, lengths)
    ct_seq = rng.randn(B, T, H).astype(np.float32)
    ct_h = rng.randn(B, H).astype(np.float32)
    h0 = np.zeros((B, H), np.float32)

    def obj(xp_, w_, h0_):
        h_seq, h_f = j_gru_fused(xp_, jnp.asarray(mask), w_, h0_, True)
        return (h_seq * ct_seq).sum() + (h_f * ct_h).sum()

    want = jax.grad(obj, (0, 1, 2))(jnp.asarray(xp), jnp.asarray(w_h),
                                    jnp.asarray(h0))
    with compute_dtype_scope("float32"):
        txp, tw, th0 = (_t(a).requires_grad_() for a in (xp, w_h, h0))
        h_seq, h_f = gru_sequence_fused(txp, _t(mask), tw, th0)
        loss = (h_seq * _t(ct_seq)).sum() + (h_f * _t(ct_h)).sum()
        got = torch.autograd.grad(loss, [txp, tw, th0])
    for g, w, nm in zip(got, want, ("d_xp", "d_w_h", "d_h0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=nm)


def test_gru_sequence_fused_without_grad_stores_no_residuals(rng):
    """No gradient wanted: the inference variant runs (same outputs)."""
    xp, mask, w_h = _data(rng, 4, 6, 8, [6, 3, 5, 1])
    with compute_dtype_scope("float32"):
        want = gru_forward(_t(xp), _t(mask), _t(w_h))
        with torch.no_grad():
            got = gru_sequence_fused(_t(xp).requires_grad_(), _t(mask),
                                     _t(w_h))
        assert not got[0].requires_grad
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_grads_match_jax(rng, reverse):
    """Through ``gru_layer`` (input projection, and the flips of the
    reverse direction) against JAX autodiff of its own ``gru_layer``."""
    B, T, E, H = 5, 7, 6, 8
    x = rng.randn(B, T, E).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([7, 2, 5, 7, 1])[:, None]).astype(
        np.float32)
    w_x = (0.3 * rng.randn(E, 3 * H)).astype(np.float32)
    w_h = (0.3 * rng.randn(H, 3 * H)).astype(np.float32)
    b = (0.1 * rng.randn(3 * H)).astype(np.float32)
    ct = rng.randn(B, T, H).astype(np.float32)
    ct_f = rng.randn(B, H).astype(np.float32)

    def obj(x_, wx_, wh_, b_):
        h_seq, h_f = JO.gru_layer(x_, jnp.asarray(mask), wx_, wh_, b_,
                                  reverse=reverse)
        return (h_seq * ct).sum() + (h_f * ct_f).sum()

    want = jax.grad(obj, (0, 1, 2, 3))(*(jnp.asarray(a)
                                         for a in (x, w_x, w_h, b)))
    with compute_dtype_scope("float32"):
        ts = [_t(a).requires_grad_() for a in (x, w_x, w_h, b)]
        h_seq, h_f = t_gru_layer(ts[0], _t(mask), ts[1], ts[2], ts[3],
                                 reverse=reverse)
        loss = (h_seq * _t(ct)).sum() + (h_f * _t(ct_f)).sum()
        got = torch.autograd.grad(loss, ts)
    for g, w, nm in zip(got, want, ("d_x", "d_w_x", "d_w_h", "d_b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=nm)


@pytest.mark.parametrize("cd,H", [("float32", 512), ("bfloat16", 512),
                                  ("bfloat16", 640)])
def test_residual_dtype_matches_jax(monkeypatch, cd, H):
    from paddle_tpu.utils.flags import FLAGS

    monkeypatch.setattr(FLAGS, "compute_dtype", cd)
    with compute_dtype_scope(cd):
        got = residual_dtype(H)
    assert str(got).replace("torch.", "") == jnp.dtype(
        j_residual_dtype(H)).name


def test_gru_backward_rejects_bad_shapes_and_mixed_residuals():
    T, B, H = 3, 2, 4
    args = [torch.zeros(T, B, H), torch.ones(T, B), torch.zeros(T, B, 3 * H),
            torch.zeros(T, B, H), torch.zeros(3 * H, H), torch.zeros(B, H)]
    with pytest.raises(ValueError, match="w_t"):
        gru_backward(*args[:4], torch.zeros(H, 3 * H), args[5])
    with pytest.raises(ValueError, match="residuals"):
        gru_backward(args[0], args[1], args[2], args[3].bfloat16(), *args[4:])
    d_z, d_h0 = gru_backward_plain(*args)
    assert torch.equal(d_z, torch.zeros(T, B, 3 * H))
    assert torch.equal(d_h0, torch.zeros(B, H))
