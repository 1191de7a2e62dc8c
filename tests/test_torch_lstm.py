"""The port's LSTM path — K9 (``lstm_forward``, with and without
residuals), K10 (``lstm_backward``), the ``lstm_sequence_fused`` autograd
function and ``lstm_layer`` (paddle_tpu_torch/ops/kernels/lstm.py,
ops/rnn_fused.py, ops/rnn.py) — against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_kernels.py`` does: ``_lstm_pallas_raw`` and
``_lstm_bwd_pallas_raw`` directly, and ``lstm_sequence_fused`` with
``_use_pallas_rnn`` and ``_bwd_pallas_ok`` forced on, or on its scan path.
On the CPU the port's wrappers run their plain versions.  Tolerance: rtol
1e-5 / atol 1e-6 under the float32 policy (``tests/test_rnn_fused.py``'s);
2e-2 under the bfloat16 policy, where a last-bit difference in the f32
carry can round a bf16 operand or residual the other way (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
from paddle_tpu.ops.pallas_kernels import (_lstm_bwd_pallas_raw,
                                           _lstm_pallas_raw)
from paddle_tpu.ops.rnn_fused import lstm_sequence_fused as j_lstm_fused
from paddle_tpu_torch.ops import lstm_layer as t_lstm_layer
from paddle_tpu_torch.ops import lstm_step as t_lstm_step
from paddle_tpu_torch.ops.kernels import (launch_counts, lstm_backward,
                                          lstm_backward_plain, lstm_forward,
                                          lstm_forward_plain)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.ops.rnn import scan_rnn
from paddle_tpu_torch.ops.rnn_fused import lstm_sequence_fused

# (B, T, H, lengths): mixed lengths with a length-1 row and a full row
_SHAPES = [(4, 6, 8, [6, 3, 5, 1]), (5, 8, 16, [8, 1, 4, 8, 7]),
           (6, 5, 12, [5, 5, 2, 1, 4, 3])]


def _data(rng, B, T, H, lengths):
    xp = (rng.randn(B, T, 4 * H) * 0.4).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    w_h = (rng.randn(H, 4 * H) * 0.2).astype(np.float32)
    pi, pf, po = ((rng.randn(H) * 0.3).astype(np.float32) for _ in range(3))
    return xp, mask, w_h, pi, pf, po


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=(1e-5, 1e-6), msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1], err_msg=msg)


def _pallas_fwd(xp, mask, w_h, pi, pf, po, residuals):
    return _lstm_pallas_raw(jnp.moveaxis(jnp.asarray(xp), 1, 0),
                            jnp.asarray(mask.T), jnp.asarray(w_h),
                            jnp.asarray(pi), jnp.asarray(pf), jnp.asarray(po),
                            residuals=residuals)


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_lstm_forward_matches_pallas(rng, B, T, H, lengths, residuals):
    """K9: h_seq, h_final, c_final and (residuals) z, h_prev, c_prev,
    time-major, with nonzero peepholes; the plain version ran."""
    xp, mask, w_h, pi, pf, po = _data(rng, B, T, H, lengths)
    want = _pallas_fwd(xp, mask, w_h, pi, pf, po, residuals)
    before = launch_counts()["lstm_forward"]
    with compute_dtype_scope("float32"):
        got = lstm_forward(_t(xp), _t(mask), _t(w_h), _t(pi), _t(pf), _t(po),
                           residuals=residuals)
    assert launch_counts()["lstm_forward"] == before
    assert len(got) == len(want) == (6 if residuals else 3)
    _close(got[0].transpose(0, 1).numpy(), want[0], msg="h_seq")
    for g, w, nm in zip(got[1:], want[1:],
                        ("h_fin", "c_fin", "z", "h_prev", "c_prev")):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, msg=nm)
    padded = _t(mask).transpose(0, 1) == 0
    assert torch.equal(got[0].transpose(0, 1)[padded],
                       torch.zeros_like(got[0].transpose(0, 1)[padded]))


def test_lstm_forward_bf16_policy_matches_pallas(rng, monkeypatch):
    """Under the bfloat16 policy both sides round the product operands to
    bf16 and store bf16 residuals (H <= 512)."""
    from paddle_tpu.utils.flags import FLAGS

    monkeypatch.setattr(FLAGS, "compute_dtype", "bfloat16")
    B, T, H, lengths = 8, 6, 16, [6, 1, 4, 6, 2, 5, 6, 3]
    xp, mask, w_h, pi, pf, po = _data(rng, B, T, H, lengths)
    want = _pallas_fwd(xp, mask, w_h, pi, pf, po, True)
    assert want[3].dtype == jnp.bfloat16
    with compute_dtype_scope("bfloat16"):
        got = lstm_forward(_t(xp), _t(mask), _t(w_h), _t(pi), _t(pf), _t(po),
                           residuals=True)
    assert all(g.dtype == torch.bfloat16 for g in got[3:])
    _close(got[0].transpose(0, 1).numpy(), want[0], (2e-2, 2e-2))
    for g, w in zip(got[1:], want[1:]):
        _close(g.float().numpy(), np.asarray(w, np.float32), (2e-2, 2e-2))


def _bwd_inputs(rng, B, T, H, lengths):
    xp, mask, w_h, pi, pf, po = _data(rng, B, T, H, lengths)
    _, _, _, z, _, cp = _pallas_fwd(xp, mask, w_h, pi, pf, po, True)
    d_out = rng.randn(T, B, H).astype(np.float32)
    d_hfin = rng.randn(B, H).astype(np.float32)
    d_cfin = rng.randn(B, H).astype(np.float32)
    return (d_out, mask.T.copy(), np.asarray(z), np.asarray(cp), w_h, pi, pf,
            po, d_hfin, d_cfin)


@pytest.mark.parametrize("want_cn", [True, False])
@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_lstm_backward_matches_pallas(rng, B, T, H, lengths, want_cn):
    """K10: d_z, c_new (when asked), d_h0 and d_c0 from the same
    residuals."""
    d_out, m_tb, z, cp, w_h, pi, pf, po, d_hfin, d_cfin = _bwd_inputs(
        rng, B, T, H, lengths)
    want = _lstm_bwd_pallas_raw(
        jnp.asarray(d_out), jnp.asarray(m_tb), jnp.asarray(z),
        jnp.asarray(cp), jnp.asarray(w_h.T.copy()), jnp.asarray(pi[None]),
        jnp.asarray(pf[None]), jnp.asarray(po[None]), jnp.asarray(d_hfin),
        jnp.asarray(d_cfin), want_cn=want_cn)
    before = launch_counts()["lstm_backward"]
    got = lstm_backward(_t(d_out), _t(m_tb), _t(z), _t(cp), _t(w_h.T),
                        _t(pi), _t(pf), _t(po), _t(d_hfin), _t(d_cfin),
                        want_cn=want_cn)
    assert launch_counts()["lstm_backward"] == before  # plain version ran
    assert (got[1] is None) == (not want_cn) == (want[1] is None)
    for g, w, nm in zip(got, want, ("d_z", "c_new", "d_h0", "d_c0")):
        if w is not None:
            _close(g.numpy(), w, msg=nm)


def _fused_grads_jax(xp, mask, w_h, h0, c0, pi, pf, po, cts, pallas,
                     peeps=True):
    ct_seq, ct_h, ct_c = cts

    def obj(*a):
        h_seq, h_f, c_f = j_lstm_fused(a[0], jnp.asarray(mask), *a[1:],
                                       pallas, peeps)
        return (h_seq * ct_seq).sum() + (h_f * ct_h).sum() + \
            (c_f * ct_c).sum()

    args = [jnp.asarray(v) for v in (xp, w_h, h0, c0, pi, pf, po)]
    return jax.grad(obj, tuple(range(7)))(*args)


def _fused_grads_torch(xp, mask, w_h, h0, c0, pi, pf, po, cts, peeps=True):
    ct_seq, ct_h, ct_c = (_t(c) for c in cts)
    with compute_dtype_scope("float32"):
        ts = [_t(v).requires_grad_() for v in (xp, w_h, h0, c0, pi, pf, po)]
        h_seq, h_f, c_f = lstm_sequence_fused(ts[0], _t(mask), *ts[1:],
                                              has_peepholes=peeps)
        loss = (h_seq * ct_seq).sum() + (h_f * ct_h).sum() + \
            (c_f * ct_c).sum()
        return torch.autograd.grad(loss, ts)


_GRADS = ("d_xp", "d_w_h", "d_h0", "d_c0", "d_pi", "d_pf", "d_po")


@pytest.mark.parametrize("path", ["pallas", "scan"])
@pytest.mark.parametrize("B,T,H,lengths", _SHAPES)
def test_lstm_sequence_fused_grads_match_jax(rng, monkeypatch, B, T, H,
                                             lengths, path):
    """The seven gradients against the JAX custom VJP: with both Pallas
    kernels forced on (interpret mode; they boot from zero carries, so h0 =
    c0 = 0 there) and on its scan path (nonzero h0, c0)."""
    if path == "pallas":
        monkeypatch.setattr("paddle_tpu.ops.rnn._use_pallas_rnn",
                            lambda B, H: True)
        monkeypatch.setattr("paddle_tpu.ops.rnn_fused._bwd_pallas_ok",
                            lambda B, H: True)
    xp, mask, w_h, pi, pf, po = _data(rng, B, T, H, lengths)
    if path == "pallas":
        h0 = c0 = np.zeros((B, H), np.float32)
    else:
        h0 = (0.5 * rng.randn(B, H)).astype(np.float32)
        c0 = (0.5 * rng.randn(B, H)).astype(np.float32)
    cts = (rng.randn(B, T, H).astype(np.float32),
           rng.randn(B, H).astype(np.float32),
           rng.randn(B, H).astype(np.float32))
    want = _fused_grads_jax(xp, mask, w_h, h0, c0, pi, pf, po, cts,
                            path == "pallas")
    got = _fused_grads_torch(xp, mask, w_h, h0, c0, pi, pf, po, cts)
    for g, w, nm in zip(got, want, _GRADS):
        _close(g.numpy(), w, msg=nm)


def test_lstm_sequence_fused_without_peepholes_matches_jax(rng):
    """``has_peepholes=False`` (zero peepholes): the c_new stream is
    skipped and the peephole gradients are zeros, as in the reference."""
    B, T, H, lengths = _SHAPES[1]
    xp, mask, w_h, _, _, _ = _data(rng, B, T, H, lengths)
    zp = np.zeros(H, np.float32)
    h0 = c0 = np.zeros((B, H), np.float32)
    cts = (rng.randn(B, T, H).astype(np.float32),
           rng.randn(B, H).astype(np.float32),
           rng.randn(B, H).astype(np.float32))
    want = _fused_grads_jax(xp, mask, w_h, h0, c0, zp, zp, zp, cts, False,
                            peeps=False)
    got = _fused_grads_torch(xp, mask, w_h, h0, c0, zp, zp, zp, cts,
                             peeps=False)
    for g, w, nm in zip(got, want, _GRADS):
        _close(g.numpy(), w, msg=nm)
    assert all(not g.any() for g in got[4:])


def test_lstm_sequence_fused_without_grad_stores_no_residuals(rng):
    """No gradient wanted: the inference variant runs (same outputs)."""
    xp, mask, w_h, pi, pf, po = _data(rng, 4, 6, 8, [6, 3, 5, 1])
    with compute_dtype_scope("float32"):
        want = lstm_forward(_t(xp), _t(mask), _t(w_h), _t(pi), _t(pf),
                            _t(po))
        with torch.no_grad():
            got = lstm_sequence_fused(_t(xp).requires_grad_(), _t(mask),
                                      _t(w_h), None, None, _t(pi), _t(pf),
                                      _t(po))
    assert len(got) == 3 and not got[0].requires_grad
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax(rng, reverse, act):
    """Through ``lstm_layer`` (input projection, bias, peepholes, the flips
    of the reverse direction; ``sigmoid`` takes the scan path) against JAX
    autodiff of its own ``lstm_layer``: forward and six gradients."""
    B, T, E, H = 5, 7, 6, 8
    x = rng.randn(B, T, E).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([7, 2, 5, 7, 1])[:, None]).astype(
        np.float32)
    vals = [x, (0.3 * rng.randn(E, 4 * H)).astype(np.float32),
            (0.3 * rng.randn(H, 4 * H)).astype(np.float32),
            (0.1 * rng.randn(4 * H)).astype(np.float32),
            (0.3 * rng.randn(H)).astype(np.float32),
            (0.3 * rng.randn(H)).astype(np.float32),
            (0.3 * rng.randn(H)).astype(np.float32)]
    ct = rng.randn(B, T, H).astype(np.float32)
    ct_h = rng.randn(B, H).astype(np.float32)
    ct_c = rng.randn(B, H).astype(np.float32)

    def run(layer, a, m, cts):
        h_seq, (h_f, c_f) = layer(a[0], m, a[1], a[2], a[3],
                                  reverse=reverse, peep_i=a[4], peep_f=a[5],
                                  peep_o=a[6], act=act)
        obj = (h_seq * cts[0]).sum() + (h_f * cts[1]).sum() + \
            (c_f * cts[2]).sum()
        return obj, h_seq

    jobj = lambda *a: run(JO.lstm_layer, a, jnp.asarray(mask),
                          (ct, ct_h, ct_c))
    (_, want_seq), want = jax.value_and_grad(jobj, tuple(range(7)),
                                             has_aux=True)(
        *(jnp.asarray(v) for v in vals))
    with compute_dtype_scope("float32"):
        ts = [_t(v).requires_grad_() for v in vals]
        loss, h_seq = run(t_lstm_layer, ts, _t(mask),
                          tuple(_t(c) for c in (ct, ct_h, ct_c)))
        got = torch.autograd.grad(loss, ts)
    _close(h_seq.detach().numpy(), want_seq, msg="h_seq")
    for g, w, nm in zip(got, want, ("d_x", "d_w_x", "d_w_h", "d_b", "d_pi",
                                    "d_pf", "d_po")):
        _close(g.numpy(), w, msg=nm)


def test_lstm_step_and_tuple_carry_scan_match_jax(rng):
    """``lstm_step`` with peepholes, and ``scan_rnn`` carrying ``(h, c)``
    in reverse, against the JAX package's."""
    B, T, H = 3, 4, 6
    xp = rng.randn(B, T, 4 * H).astype(np.float32)
    w_h = (0.3 * rng.randn(H, 4 * H)).astype(np.float32)
    pk = {k: (0.3 * rng.randn(H)).astype(np.float32)
          for k in ("peep_i", "peep_f", "peep_o")}
    h0 = rng.randn(B, H).astype(np.float32)
    c0 = rng.randn(B, H).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([4, 1, 3])[:, None]).astype(
        np.float32)
    want_h, want_c = JO.lstm_step(jnp.asarray(xp[:, 0]), jnp.asarray(h0),
                                  jnp.asarray(c0), jnp.asarray(w_h),
                                  **{k: jnp.asarray(v) for k, v in pk.items()})

    def j_step(carry, x):
        h2, c2 = JO.lstm_step(x, *carry, jnp.asarray(w_h))
        return (h2, c2), h2

    (jh, jc), jseq = JO.scan_rnn(j_step, (jnp.asarray(h0), jnp.asarray(c0)),
                                 jnp.asarray(xp), jnp.asarray(mask),
                                 reverse=True)
    with compute_dtype_scope("float32"):
        h, c = t_lstm_step(_t(xp[:, 0]), _t(h0), _t(c0), _t(w_h),
                           **{k: _t(v) for k, v in pk.items()})

        def t_step(carry, x):
            h2, c2 = t_lstm_step(x, *carry, _t(w_h))
            return (h2, c2), h2

        (th, tc), tseq = scan_rnn(t_step, (_t(h0), _t(c0)), _t(xp), _t(mask),
                                  reverse=True)
    for g, w in ((h, want_h), (c, want_c), (th, jh), (tc, jc), (tseq, jseq)):
        _close(g.numpy(), w)


def test_lstm_wrappers_check_shapes_dtypes_and_devices():
    T, B, H = 3, 2, 4
    xp = torch.zeros(B, T, 4 * H)
    mask = torch.ones(B, T)
    w_h = torch.zeros(H, 4 * H)
    p = torch.zeros(H)
    with pytest.raises(ValueError, match="xp"):
        lstm_forward(torch.zeros(B, T, 4 * H + 1), mask, w_h, p, p, p)
    with pytest.raises(ValueError, match="w_h"):
        lstm_forward(xp, mask, torch.zeros(4 * H, H), p, p, p)
    with pytest.raises(ValueError, match="po"):
        lstm_forward(xp, mask, w_h, p, p, torch.zeros(1, H))
    with pytest.raises(ValueError, match="c0"):
        lstm_forward(xp, mask, w_h, p, p, p, None, torch.zeros(B + 1, H))
    with pytest.raises(ValueError, match="span devices"):
        lstm_forward(xp, mask.to("meta"), w_h, p, p, p)
    args = [torch.zeros(T, B, H), torch.ones(T, B), torch.zeros(T, B, 4 * H),
            torch.zeros(T, B, H), torch.zeros(4 * H, H), p, p, p,
            torch.zeros(B, H), torch.zeros(B, H)]
    with pytest.raises(ValueError, match="w_t"):
        lstm_backward(*args[:4], torch.zeros(H, 4 * H), *args[5:])
    with pytest.raises(ValueError, match="residuals"):
        lstm_backward(*args[:3], args[3].bfloat16(), *args[4:])
    with pytest.raises(ValueError, match="residuals"):
        lstm_backward(args[0], args[1], args[2].half(), args[3].half(),
                      *args[4:])
    with pytest.raises(ValueError, match="span devices"):
        lstm_backward(*args[:9], args[9].to("meta"))
    d_z, cn, d_h0, d_c0 = lstm_backward_plain(*args)
    assert torch.equal(d_z, torch.zeros(T, B, 4 * H))
    assert torch.equal(cn, torch.zeros(T, B, H))
    assert torch.equal(d_h0, torch.zeros(B, H))
    out = lstm_forward_plain(xp, mask, w_h, p, p, p, residuals=True)
    assert [tuple(o.shape) for o in out] == [(B, T, H), (B, H), (B, H),
                                             (T, B, 4 * H), (T, B, H),
                                             (T, B, H)]


def test_lstm_wrappers_refuse_devices_without_a_kernel():
    """Only a CPU tensor takes the plain version; a device that is neither
    the CPU nor CUDA is refused."""
    T, B, H = 3, 2, 4
    meta = dict(device="meta")
    p = torch.zeros(H, **meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        lstm_forward(torch.zeros(B, T, 4 * H, **meta),
                     torch.ones(B, T, **meta),
                     torch.zeros(H, 4 * H, **meta), p, p, p)
    with pytest.raises(ValueError, match="cpu or cuda"):
        lstm_backward(torch.zeros(T, B, H, **meta), torch.ones(T, B, **meta),
                      torch.zeros(T, B, 4 * H, **meta),
                      torch.zeros(T, B, H, **meta),
                      torch.zeros(4 * H, H, **meta), p, p, p,
                      torch.zeros(B, H, **meta), torch.zeros(B, H, **meta))


@pytest.mark.parametrize("B", [1, 64, 512])
@pytest.mark.parametrize("H", [64, 256, 512, 1280])
def test_lstm_bwd_split_covers_w_t_once_and_fits(B, H):
    """The persistent K10's plan on a 132-SM card: every (k, column) of
    w_t [4H, H] lies in exactly one block's slice, every slice fits the
    shared memory a block may take (232,448 bytes, with the three d_z
    stages), no block is empty, and there are no more blocks than SMs.
    The plan does not depend on B; past the 256-row limit there is none."""
    from paddle_tpu_torch.ops.kernels.lstm import (_lstm_bwd_plan,
                                                   _lstm_bwd_slices)

    plan = _lstm_bwd_plan(B, H, 132)
    if B > 256:
        assert plan is None
        return
    assert plan == _lstm_bwd_plan(1, H, 132)
    assert plan["blocks"] <= 132
    pitch = 80 if plan["cw"] <= 80 else 160
    assert plan["cw"] <= 160 and plan["kw"] % 32 == 0
    assert plan["smem"] == plan["kw"] * pitch * 4 + 3 * 32 * 64 * 4 <= 232448
    cover = np.zeros((4 * H, H), np.int32)
    for ks, cs in _lstm_bwd_slices(plan, H):
        assert len(ks) > 0 and len(cs) > 0
        assert len(ks) <= plan["kw"] and len(cs) <= plan["cw"]
        cover[ks.start:ks.stop, cs.start:cs.stop] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("B,H,sms,want", [
    (64, 256, 132, "persistent"),
    (64, 1280, 132, "persistent"),
    (1, 64, 132, "persistent"),
    (37, 1280, 132, "persistent"),
    (256, 1280, 132, "persistent"),
    # beyond the row limit
    (257, 256, 132, "steps"),
    (512, 1280, 132, "steps"),
    # f32 w_t beyond what 132 SMs hold
    (64, 1300, 132, "steps"),
    (64, 1408, 132, "steps"),
    # fewer SMs: the slices grow past shared memory
    (64, 1280, 100, "steps"),
    (64, 256, 4, "steps"),
    (64, 64, 1, "persistent"),
    # no rows or units
    (0, 256, 132, "steps"),
    (64, 0, 132, "steps"),
])
def test_lstm_bwd_path_is_a_function_of_shape_and_sm_count(B, H, sms, want):
    from paddle_tpu_torch.ops.kernels.lstm import _lstm_bwd_path

    assert _lstm_bwd_path(B, H, sms) == want


def test_lstm_bwd_plan_at_the_benchmark_widths():
    """b64h1280: 16 k-groups of 320 rows x 8 column groups of 160 units,
    128 blocks of 204,800 bytes of w_t (the 640 x 80 split computes as
    many products a block but reads d_z twice as often); b64h256: 32 x 4
    blocks of 32 x 64."""
    from paddle_tpu_torch.ops.kernels.lstm import _lstm_bwd_plan

    assert _lstm_bwd_plan(64, 1280, 132) == {
        "kg": 16, "kw": 320, "cg": 8, "cw": 160, "blocks": 128,
        "smem": 204800 + 24576}
    assert _lstm_bwd_plan(64, 256, 132) == {
        "kg": 32, "kw": 32, "cg": 4, "cw": 64, "blocks": 128,
        "smem": 10240 + 24576}


@pytest.mark.parametrize("B", [1, 64, 512])
@pytest.mark.parametrize("H", [64, 256, 512, 1280])
def test_lstm_fwd_plan_covers_w_h_once_and_fits(B, H):
    """The persistent K9's plan on a 132-SM card: every (k, gate column) of
    w_h [H, 4H] lies in exactly one block's slice (its units' four gate
    columns over the full depth), every block's shared memory (slice,
    ring, partials, carries) fits 232,448 bytes, no block is empty, units a
    block are even and at most 16, and there are no more blocks than SMs.
    The plan does not depend on B; past the 256-row limit there is none."""
    from paddle_tpu_torch.ops.kernels.lstm import (_fwd_smem,
                                                   _lstm_fwd_plan,
                                                   _lstm_fwd_units)

    plan = _lstm_fwd_plan(B, H, 132)
    if B > 256:
        assert plan is None
        return
    assert plan == _lstm_fwd_plan(1, H, 132)
    assert plan["blocks"] <= 132
    assert plan["nu"] % 2 == 0 and 4 <= plan["nu"] <= 16
    assert plan["smem"] == _fwd_smem(H, plan["nu"]) <= 232448
    cover = np.zeros((H, 4 * H), np.int32)
    for units in _lstm_fwd_units(plan, H):
        assert 0 < len(units) <= plan["nu"]
        for gate in range(4):
            cover[:, gate * H + units.start:gate * H + units.stop] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("dtype,B,H,sms,want", [
    (torch.bfloat16, 64, 256, 132, "persistent"),
    (torch.bfloat16, 64, 1280, 132, "persistent"),
    (torch.bfloat16, 37, 1280, 132, "persistent"),
    (torch.bfloat16, 256, 1280, 132, "persistent"),
    (torch.bfloat16, 1, 8, 132, "persistent"),
    (torch.bfloat16, 64, 1536, 132, "persistent"),
    # the f32 policy: f32 w_h does not fit, and TF32 stays off
    (torch.float32, 64, 256, 132, "steps"),
    (torch.float32, 64, 1280, 132, "steps"),
    # beyond the row limit
    (torch.bfloat16, 257, 256, 132, "steps"),
    # H not a multiple of 8 (16-byte rows of the bf16 h stream)
    (torch.bfloat16, 64, 100, 132, "steps"),
    (torch.bfloat16, 64, 1300, 132, "steps"),
    # w_h beyond what the SMs hold
    (torch.bfloat16, 64, 1544, 132, "steps"),
    (torch.bfloat16, 64, 2048, 132, "steps"),
    (torch.bfloat16, 64, 1280, 100, "steps"),
    (torch.bfloat16, 64, 256, 8, "steps"),
    (torch.bfloat16, 64, 64, 1, "steps"),
    # no rows or units
    (torch.bfloat16, 0, 256, 132, "steps"),
    (torch.bfloat16, 64, 0, 132, "steps"),
])
def test_lstm_fwd_path_is_a_function_of_dtype_shape_and_sm_count(
        dtype, B, H, sms, want):
    from paddle_tpu_torch.ops.kernels.lstm import _lstm_fwd_path

    assert _lstm_fwd_path(dtype, B, H, sms) == want


def test_lstm_fwd_plan_at_the_benchmark_widths():
    """b64h1280: 128 blocks of 10 units (40 gate columns, 102,400 bytes of
    bf16 w_h each); b64h256: 64 blocks of 4 units, so that half as many
    blocks meet at each of the 100 barriers as 2 units a block would
    need."""
    from paddle_tpu_torch.ops.kernels.lstm import _lstm_fwd_plan

    assert _lstm_fwd_plan(64, 1280, 132) == {
        "nu": 10, "blocks": 128,
        "smem": 102400 + 32768 + 20480 + 20480 + 120}
    assert _lstm_fwd_plan(64, 256, 132) == {
        "nu": 4, "blocks": 64, "smem": 8192 + 32768 + 8192 + 8192 + 48}
