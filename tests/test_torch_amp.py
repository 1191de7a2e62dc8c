"""Mixed precision (``--amp``) in the port against the JAX package: the
dtype policy (``ops/numerics.py``), each amp-touched module, the whole amp
step of ``lstm_benchmark_net`` and of a narrow ``Seq2SeqAttention``, the
dynamic loss-scale state machine (``resilience/guard.py``,
``trainer/trainer.py``) and amp checkpoints crossing between the packages.

Where the port's path is a kernel (the fused GRU/LSTM sequences, the
attention decoder, the tiled CE readout) the JAX side is forced onto its
Pallas path, which runs in interpret mode on the CPU: under ``--amp`` the
reference's Pallas kernels keep float32 carries and float32 products, its
scans do not, and the port's kernels (and their plain versions here)
follow the Pallas semantics.  The scan paths (a non-default activation)
are held against the JAX scans.

Tolerances.  bfloat16 ones are counted in bfloat16 ulps of the compared
array's largest entry (one ulp is 2^-8 relative): a float32 sum taken in
another order can round a bfloat16 activation the other way, by one ulp,
and each later product or sum carries that one ulp forward, so a short
chain of bfloat16 roundings stays within a few ulps.  Each test names its
count and the chain it covers.  float32 ones are the reference's rtol 1e-5
/ atol 1e-6.  The loss-scale scalars (scale, good steps, the overflow and
bad-step flags) are held bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.ops import attention_decoder as j_ad
from paddle_tpu.ops import losses as j_losses
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.param.optimizers import slot_leaves
from paddle_tpu_torch.resilience import TooManyBadSteps, chaos
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.flags import FLAGS

#: one bfloat16 ulp, relative
ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
        monkeypatch.setattr(flags, "compute_dtype", "float32")
    yield


@pytest.fixture
def amp_on(monkeypatch):
    """``--amp`` in both packages."""
    monkeypatch.setattr(FLAGS, "amp", True)
    monkeypatch.setattr(JFLAGS, "amp", True)
    yield


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package on its Pallas paths (interpret mode): the fused
    GRU/LSTM loops, the attention decoder and the tiled CE readout."""
    monkeypatch.setattr("paddle_tpu.ops.rnn._use_pallas_rnn",
                        lambda B, H: True)
    monkeypatch.setattr("paddle_tpu.ops.rnn_fused._bwd_pallas_ok",
                        lambda B, H: True)
    monkeypatch.setattr(j_ad, "_attn_pallas_block", lambda B, *a: B)
    monkeypatch.setattr(j_losses, "_tiled_ce_cfg",
                        lambda B, T, D, V: (B * T, 128))
    yield


def _close_ulps(got, want, ulps, what=""):
    """max |got - want| within ``ulps`` bfloat16 ulps of want's largest
    entry."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= ulps * ULP, f"{what}: {err / ULP:.2f} ulps > {ulps}"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(v):
    """A host copy of either package's array."""
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def _both_grads(jfn, tfn, vals, ct):
    """Outputs and gradients of sum(out * ct) w.r.t. every input, in both
    packages, from the same float32 inputs."""
    def jloss(*a):
        out = jfn(*a)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(vals))), has_aux=True)(
        *(jnp.asarray(v) for v in vals))
    ts = [_t(v).requires_grad_() for v in vals]
    tout = tfn(*ts)
    tg = torch.autograd.grad((tout.float() * _t(ct)).sum(), ts)
    return (tout.detach().float().numpy(), [g.numpy() for g in tg],
            np.asarray(jout.astype(jnp.float32)),
            [np.asarray(g) for g in jg], tout.dtype, jout.dtype)


# ---------------------------------------------------------------------------
# the dtype policy
# ---------------------------------------------------------------------------


def test_amp_dtype_policy_bf16_activations_f32_allowlist(amp_on):
    """Counterpart of tests/test_amp.py's: matmul and conv outputs bf16,
    batch-norm statistics f32 over a bf16 stream, losses f32; each dtype
    also equals the JAX package's under the same flags."""
    from paddle_tpu.ops.conv import batch_norm as j_bn, conv2d as j_conv
    from paddle_tpu.ops.losses import cross_entropy as j_ce, mse as j_mse
    from paddle_tpu.ops.matmul import linear as j_linear, matmul as j_mm
    from paddle_tpu_torch.ops import (batch_norm, conv2d, cross_entropy,
                                      linear, matmul, mse)

    rs = np.random.RandomState(0)
    x = rs.randn(4, 8).astype(np.float32)
    w = rs.randn(8, 8).astype(np.float32)
    assert linear(_t(x), _t(w)).dtype == torch.bfloat16
    assert matmul(_t(x), _t(w)).dtype == torch.bfloat16
    assert j_linear(jnp.asarray(x), jnp.asarray(w)).dtype == jnp.bfloat16
    assert j_mm(jnp.asarray(x), jnp.asarray(w)).dtype == jnp.bfloat16
    img = rs.randn(2, 8, 8, 3).astype(np.float32)
    k = rs.randn(3, 3, 3, 4).astype(np.float32)
    assert conv2d(_t(img), _t(k)).dtype == torch.bfloat16
    assert j_conv(jnp.asarray(img), jnp.asarray(k)).dtype == jnp.bfloat16
    xb = _t(img).to(torch.bfloat16)
    y, nm, nv = batch_norm(xb, torch.ones(3), torch.zeros(3), torch.zeros(3),
                           torch.ones(3), train=True)
    assert y.dtype == torch.bfloat16
    assert nm.dtype == torch.float32 and nv.dtype == torch.float32
    jy, jm, jv = j_bn(jnp.asarray(img).astype(jnp.bfloat16), jnp.ones(3),
                      jnp.zeros(3), jnp.zeros(3), jnp.ones(3), train=True)
    assert (jy.dtype, jm.dtype, jv.dtype) == (jnp.bfloat16, jnp.float32,
                                              jnp.float32)
    logits = _t(rs.randn(4, 10)).to(torch.bfloat16)
    assert cross_entropy(logits, torch.arange(4)).dtype == torch.float32
    assert mse(logits, logits).dtype == torch.float32
    jl = jnp.asarray(np.asarray(logits.float())).astype(jnp.bfloat16)
    assert j_ce(jl, jnp.arange(4)).dtype == jnp.float32
    assert j_mse(jl, jl).dtype == jnp.float32


def test_amp_off_keeps_f32_everything():
    from paddle_tpu_torch.ops import linear
    from paddle_tpu_torch.ops.numerics import (amp_enabled, compute_dtype,
                                               dot_dtype)

    assert not amp_enabled()
    assert dot_dtype() == torch.float32
    assert compute_dtype() == torch.float32
    assert linear(torch.ones(2, 4), torch.ones(4, 4)).dtype == torch.float32


def test_amp_pins_bf16_compute_whatever_compute_dtype_says(amp_on):
    """``compute_dtype()`` is bf16 under --amp although the tests pin
    ``--compute_dtype=float32``, as in the reference."""
    from paddle_tpu.ops import numerics as jnum
    from paddle_tpu_torch.ops import numerics as tnum

    assert FLAGS.compute_dtype == "float32"
    assert tnum.compute_dtype() == torch.bfloat16
    assert jnum.compute_dtype() == jnp.bfloat16
    assert tnum.dot_dtype() == torch.bfloat16
    with tnum.float32_products():
        # the kernels' plain versions: float32 products, bf16 operands
        assert tnum.dot_dtype() == torch.float32
        assert tnum.compute_dtype() == torch.bfloat16
    assert tnum.dot_dtype() == torch.bfloat16


def test_softmax_statistics_run_f32_but_keep_caller_dtype():
    from paddle_tpu_torch.ops import softmax

    x = torch.linspace(-4, 4, 16).to(torch.bfloat16)
    out = softmax(x)
    assert out.dtype == torch.bfloat16
    # float32 statistics: a bf16 sum of these 16 terms would deviate past
    # a bf16 ulp of 1.0
    np.testing.assert_allclose(float(out.float().sum()), 1.0, atol=2e-2)


def test_bwd_products_take_bf16_operands_under_amp(amp_on):
    """``bwd_mm``/``bwd_einsum`` round their operands to bf16 and return
    float32, as the reference's: equal bit for bit to the float32 product
    of the rounded operands; inside ``float32_products()`` they take the
    float32 operands as they are."""
    from paddle_tpu_torch.ops.numerics import (bwd_einsum, bwd_mm,
                                               float32_products)

    rs = np.random.RandomState(1)
    a, b = _t(rs.randn(5, 7)), _t(rs.randn(7, 3))
    ab = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    got = bwd_mm(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.matmul(*ab))
    assert torch.equal(bwd_einsum("ij,jk->ik", a, b),
                       torch.einsum("ij,jk->ik", *ab))
    with float32_products():
        assert torch.equal(bwd_mm(a, b), torch.matmul(a, b))
        assert torch.equal(bwd_einsum("ij,jk->ik", a, b),
                           torch.einsum("ij,jk->ik", a, b))


# ---------------------------------------------------------------------------
# each amp-touched module against the JAX package
# ---------------------------------------------------------------------------


def test_linear_matches_jax_under_amp(amp_on):
    """x @ w + b: bf16 operands, the float32 product rounded once, the
    bias added in bf16; the gradients through the casts.  Forward 1 ulp
    (the rounding of a float32 sum taken in another order); gradients 2
    (their own bf16 products, fed by the bf16 cotangent)."""
    from paddle_tpu.ops.matmul import linear as j_linear
    from paddle_tpu_torch.ops import linear

    rs = np.random.RandomState(2)
    vals = [rs.randn(6, 3, 16).astype(np.float32),
            (0.3 * rs.randn(16, 24)).astype(np.float32),
            (0.1 * rs.randn(24)).astype(np.float32)]
    ct = rs.randn(6, 3, 24).astype(np.float32)
    tout, tg, jout, jg, tdt, jdt = _both_grads(j_linear, linear, vals, ct)
    assert tdt == torch.bfloat16 and jdt == jnp.bfloat16
    _close_ulps(tout, jout, 1, "out")
    for g, w, nm in zip(tg, jg, ("x", "w", "b")):
        assert g.dtype == np.float32
        _close_ulps(g, w, 2, nm)


def test_attention_matches_jax_under_amp(amp_on):
    """Bahdanau scores + masked softmax + context: scores and weights f32
    (the allowlist), the context in bf16 (an activation).  The query and
    ``tanh`` run in bf16 and feed the f32 scores, the softmax and the bf16
    context: 4 ulps forward and back."""
    from paddle_tpu.ops.attention import (additive_attention_scores as j_sc,
                                          attend as j_attend)
    from paddle_tpu_torch.ops.attention import (additive_attention_scores,
                                                attend)

    rs = np.random.RandomState(3)
    B, S, A, D, H2 = 4, 6, 8, 10, 12
    mask = (np.arange(S)[None] < np.array([6, 3, 5, 1])[:, None]).astype(
        np.float32)
    vals = [rs.randn(B, S, A).astype(np.float32),
            rs.randn(B, D).astype(np.float32),
            (0.4 * rs.randn(D, A)).astype(np.float32),
            (0.5 * rs.randn(A)).astype(np.float32),
            rs.randn(B, S, H2).astype(np.float32)]
    ct = rs.randn(B, H2).astype(np.float32)

    def jfn(ep, s, w, v, enc):
        ctx, _ = j_attend(j_sc(ep, s, w, v), enc, jnp.asarray(mask))
        return ctx

    def tfn(ep, s, w, v, enc):
        scores = additive_attention_scores(ep, s, w, v)
        assert scores.dtype == torch.float32
        ctx, wts = attend(scores, enc, _t(mask))
        assert wts.dtype == torch.float32
        return ctx

    tout, tg, jout, jg, tdt, jdt = _both_grads(jfn, tfn, vals, ct)
    assert tdt == torch.bfloat16 and jdt == jnp.bfloat16
    _close_ulps(tout, jout, 4, "ctx")
    for g, w, nm in zip(tg, jg, ("enc_proj", "dec_state", "w_dec", "v",
                                 "enc")):
        _close_ulps(g, w, 4, nm)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax_pallas_under_amp(amp_on, jax_pallas,
                                                 reverse):
    """``lstm_layer`` (the projection in bf16, the fused loop with its
    f32 carries, peepholes cast to bf16 at the boundary) against the
    reference forced through its Pallas kernels: forward and the seven
    gradients.  The bf16 projection feeds a 7-step f32 recurrence whose
    products round h to bf16 each step, and the weight-gradient
    contractions take bf16 operands: 8 ulps."""
    from paddle_tpu.ops.rnn import lstm_layer as j_lstm
    from paddle_tpu_torch.ops import lstm_layer

    rs = np.random.RandomState(4)
    B, T, E, H = 5, 7, 6, 8
    mask = (np.arange(T)[None] < np.array([7, 2, 5, 7, 1])[:, None]).astype(
        np.float32)
    vals = [rs.randn(B, T, E).astype(np.float32),
            (0.3 * rs.randn(E, 4 * H)).astype(np.float32),
            (0.3 * rs.randn(H, 4 * H)).astype(np.float32),
            (0.1 * rs.randn(4 * H)).astype(np.float32),
            (0.3 * rs.randn(H)).astype(np.float32),
            (0.3 * rs.randn(H)).astype(np.float32),
            (0.3 * rs.randn(H)).astype(np.float32)]
    ct = rs.randn(B, T, H).astype(np.float32)

    def fn(layer, m):
        def f(x, wx, wh, b, pi, pf, po):
            h_seq, _ = layer(x, m, wx, wh, b, reverse=reverse, peep_i=pi,
                             peep_f=pf, peep_o=po)
            return h_seq
        return f

    tout, tg, jout, jg, tdt, jdt = _both_grads(
        fn(j_lstm, jnp.asarray(mask)), fn(lstm_layer, _t(mask)), vals, ct)
    # the kernel path returns f32 h_seq in both packages
    assert tdt == torch.float32 and jdt == jnp.float32
    _close_ulps(tout, jout, 8, "h_seq")
    for g, w, nm in zip(tg, jg, ("x", "w_x", "w_h", "b", "pi", "pf", "po")):
        _close_ulps(g, w, 8, nm)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_matches_jax_pallas_under_amp(amp_on, jax_pallas,
                                                reverse):
    """``gru_layer`` against the reference's Pallas GRU (K3r/K4 semantics:
    f32 carry and products, bf16 residuals, bf16 weight-gradient
    operands): forward and the four gradients, 8 ulps as the LSTM's."""
    from paddle_tpu.ops.rnn import gru_layer as j_gru
    from paddle_tpu_torch.ops import gru_layer

    rs = np.random.RandomState(5)
    B, T, E, H = 4, 6, 5, 8
    mask = (np.arange(T)[None] < np.array([6, 3, 1, 5])[:, None]).astype(
        np.float32)
    vals = [rs.randn(B, T, E).astype(np.float32),
            (0.3 * rs.randn(E, 3 * H)).astype(np.float32),
            (0.3 * rs.randn(H, 3 * H)).astype(np.float32),
            (0.1 * rs.randn(3 * H)).astype(np.float32)]
    ct = rs.randn(B, T, H).astype(np.float32)

    def fn(layer, m):
        def f(x, wx, wh, b):
            return layer(x, m, wx, wh, b, reverse=reverse)[0]
        return f

    tout, tg, jout, jg, tdt, jdt = _both_grads(
        fn(j_gru, jnp.asarray(mask)), fn(gru_layer, _t(mask)), vals, ct)
    assert tdt == torch.float32 and jdt == jnp.float32
    _close_ulps(tout, jout, 8, "h_seq")
    for g, w, nm in zip(tg, jg, ("x", "w_x", "w_h", "b")):
        _close_ulps(g, w, 8, nm)


def test_scan_lstm_matches_jax_scan_under_amp(amp_on):
    """A relu LSTM takes ``scan_rnn`` in both packages: bf16 carries and
    products (the reference's scan semantics under --amp), peepholes cast
    to bf16 at the boundary.  Every step rounds the carries to bf16, so
    the 6-step chain is held to 16 ulps forward and back."""
    from paddle_tpu.ops.rnn import lstm_layer as j_lstm
    from paddle_tpu_torch.ops import lstm_layer

    rs = np.random.RandomState(6)
    B, T, E, H = 4, 6, 5, 8
    mask = (np.arange(T)[None] < np.array([6, 2, 4, 6])[:, None]).astype(
        np.float32)
    vals = [rs.randn(B, T, E).astype(np.float32),
            (0.3 * rs.randn(E, 4 * H)).astype(np.float32),
            (0.3 * rs.randn(H, 4 * H)).astype(np.float32),
            (0.1 * rs.randn(4 * H)).astype(np.float32),
            (0.3 * rs.randn(H)).astype(np.float32)]
    ct = rs.randn(B, T, H).astype(np.float32)

    def fn(layer, m):
        def f(x, wx, wh, b, pi):
            return layer(x, m, wx, wh, b, peep_i=pi, act="relu")[0]
        return f

    tout, tg, jout, jg, tdt, jdt = _both_grads(
        fn(j_lstm, jnp.asarray(mask)), fn(lstm_layer, _t(mask)), vals, ct)
    assert tdt == torch.bfloat16 and jdt == jnp.bfloat16
    _close_ulps(tout, jout, 16, "h_seq")
    for g, w, nm in zip(tg, jg, ("x", "w_x", "w_h", "b", "pi")):
        _close_ulps(g, w, 16, nm)


def test_attention_decoder_matches_jax_pallas_under_amp(amp_on, jax_pallas):
    """The attention GRU decoder against the reference's Pallas branch
    under --amp: the hoisted y product in bf16 widened at K5's boundary,
    the recomputed queries in bf16 widened at K6's, bf16 operands in the
    post-loop contractions.  Forward and the nine gradients; the softmax
    of bf16 scores and six f32 steps that round their operands to bf16:
    8 ulps."""
    from paddle_tpu.ops.attention_decoder import \
        attention_gru_decoder as j_decoder
    from paddle_tpu_torch.ops.attention_decoder import attention_gru_decoder

    rs = np.random.RandomState(7)
    B, S, T, E, H2, D, A = 4, 5, 6, 8, 10, 8, 7
    f = np.float32
    src_mask = (np.arange(S)[None] < np.array([5, 3, 4, 2])[:, None]
                ).astype(f)
    trg_mask = (np.arange(T)[None] < np.array([6, 4, 6, 1])[:, None]
                ).astype(f)
    vals = [rs.randn(B, T, E).astype(f), rs.randn(B, D).astype(f),
            rs.randn(B, S, H2).astype(f), rs.randn(B, S, A).astype(f),
            (0.5 * rs.randn(D, A)).astype(f), (0.5 * rs.randn(A)).astype(f),
            (0.4 * rs.randn(E + H2, 3 * D)).astype(f),
            (0.1 * rs.randn(3 * D)).astype(f),
            (0.4 * rs.randn(D, 3 * D)).astype(f)]
    ct = rs.randn(B, T, D).astype(f)

    def fn(dec, sm, tm):
        def g(y, s0, enc, ep, aw, av, wx, b, wh):
            return dec(y, s0, enc, ep, sm, tm, aw, av, wx, b, wh)
        return g

    tout, tg, jout, jg, tdt, jdt = _both_grads(
        fn(j_decoder, jnp.asarray(src_mask), jnp.asarray(trg_mask)),
        fn(attention_gru_decoder, _t(src_mask), _t(trg_mask)), vals, ct)
    assert tdt == torch.float32 and jdt == jnp.float32
    _close_ulps(tout, jout, 8, "states")
    for g, w, nm in zip(tg, jg, ("y_emb", "s0", "enc", "enc_proj", "att_w",
                                 "att_v", "wx", "b", "wh")):
        _close_ulps(g, w, 8, nm)


def test_ce_readout_matches_jax_tiled_under_amp(amp_on, jax_pallas):
    """The fused readout + token CE (K1/K2's plain versions) against the
    reference's vocab-tiled Pallas pair under --amp: bf16 states (the
    decoder's activations), the loss in f32.  The loss is a mean of f32
    statistics over exact bf16 products: rtol 1e-5; the gradients come
    from bf16-rounded d_logits: 2 ulps."""
    from paddle_tpu_torch.ops.losses import sequence_softmax_ce_readout

    rs = np.random.RandomState(8)
    B, T, D, V = 3, 4, 16, 200
    f = np.float32
    labels = rs.randint(0, V, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([4, 2, 3])[:, None]).astype(f)
    states = rs.randn(B, T, D).astype(f)
    w = (0.3 * rs.randn(D, V)).astype(f)
    b = (0.1 * rs.randn(V)).astype(f)

    def jloss(s, w_, b_):
        return j_losses.sequence_softmax_ce_readout(
            s.astype(jnp.bfloat16), w_, b_, jnp.asarray(labels),
            jnp.asarray(mask))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(states), jnp.asarray(w), jnp.asarray(b))
    ts = [_t(v).requires_grad_() for v in (states, w, b)]
    tl = sequence_softmax_ce_readout(ts[0].to(torch.bfloat16), ts[1], ts[2],
                                     torch.from_numpy(labels), _t(mask))
    assert tl.dtype == torch.float32
    tg = torch.autograd.grad(tl, ts)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for g, want, nm in zip(tg, jg, ("states", "w", "b")):
        _close_ulps(g.numpy(), want, 2, nm)


# ---------------------------------------------------------------------------
# the whole amp step
# ---------------------------------------------------------------------------

V, E, H, B, T = 48, 8, 12, 6, 10


def _lstm_net(nn):
    from paddle_tpu.models.text import lstm_benchmark_net as j_net
    from paddle_tpu_torch.models import lstm_benchmark_net as t_net

    nn.reset_naming()
    net = j_net if nn is jnn else t_net
    return net(V, emb_dim=E, hid_dim=H, num_layers=2)[0]


def _lstm_feeds(n):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        lens = rs.randint(2, T + 1, B).astype(np.int32)
        out.append({"words": (rs.randint(3, V, (B, T)).astype(np.int32),
                              lens),
                    "label": rs.randint(0, 2, (B, 1)).astype(np.int32)})
    return out


def test_lstm_benchmark_net_amp_steps_match_jax(amp_on, jax_pallas,
                                                tmp_path):
    """Four ``SGDTrainer.train_batch`` steps of ``lstm_benchmark_net`` (2
    LSTM layers, seeded normals in every parameter) under --amp in both
    packages from one checkpoint: each step's loss and loss-scale state,
    and the first step's change of every parameter.  Plain SGD, so a
    parameter moves by the learning rate times its gradient and the
    gradient's bf16 differences show as they are.  The first step is held
    within 4 bf16 ulps of each parameter's largest change: the bias
    gradients are sums of a bf16 cotangent, which the two packages reduce
    in another order (2-3 ulps measured), the others agree bit for bit.
    Later steps start from parameters that differ by that much, and a
    bf16 activation that rounds the other way moves the next gradients by
    whole ulps of many terms, so they are held through their losses: rtol
    1e-3 (2^-10) of an f32 mean over bf16 activations."""
    jtr = JaxTrainer(_lstm_net(jnn), jopt.SGD(learning_rate=0.5), seed=5)
    # seeded normals in every parameter: at the init's zero biases and
    # small weights most gradients are zero or tiny
    rs = np.random.RandomState(3)
    jtr.params = {k: jnp.asarray((0.3 * rs.randn(*v.shape)).astype(
        np.float32)) for k, v in jtr.params.items()}
    jtr.save(str(tmp_path), 0)
    start = {k: _np(v).copy() for k, v in jtr.params.items()}
    ttr = SGDTrainer(_lstm_net(tnn), topt.SGD(learning_rate=0.5), seed=5,
                     device="cpu")
    ttr.load(str(tmp_path), 0)
    assert float(ttr.opt_state["amp"]["scale"]) == 65536.0
    for i, feed in enumerate(_lstm_feeds(4)):
        jl = float(jtr.train_batch(feed))
        tl = float(ttr.train_batch(feed))
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        assert int(ttr._last_extras["amp_overflow"]) == \
            int(jtr._last_extras["amp_overflow"]) == 0
        for k in ("scale", "good_steps"):
            assert _np(ttr.opt_state["amp"][k]).tolist() == \
                _np(jtr.opt_state["amp"][k]).tolist()
        if i == 0:
            for k, v in jtr.params.items():
                assert ttr.params[k].dtype == torch.float32
                _close_ulps(_np(ttr.params[k]) - start[k],
                            _np(v) - start[k], 4, k)


def test_seq2seq_amp_loss_and_grads_match_jax(amp_on, jax_pallas):
    """A narrow ``Seq2SeqAttention`` under --amp: the loss and its 19
    gradients against the reference with its GRU, decoder and CE readout
    forced through their Pallas kernels.  The encoder's and decoder's bf16
    activations feed the tiled readout; each gradient is held within 16
    bf16 ulps of its largest entry (a chain of bf16 roundings through two
    GRU layers, the decoder and the readout), the loss at rtol 1e-3."""
    from paddle_tpu.models import Seq2SeqAttention as JaxSeq2Seq
    from paddle_tpu_torch.models.seq2seq import (Seq2SeqAttention,
                                                 params_from_jax)

    cfg = dict(src_vocab=60, trg_vocab=90, emb_dim=16, enc_dim=24,
               dec_dim=32, att_dim=20)
    rs = np.random.RandomState(0)
    Bq, S, Tq = 4, 7, 6
    core = rs.randint(3, cfg["trg_vocab"], (Bq, Tq - 1)).astype(np.int32)
    batch = {
        "src_ids": rs.randint(3, cfg["src_vocab"], (Bq, S)).astype(np.int32),
        "src_len": np.array([S, 3, 5, 1], np.int32),
        "trg_in": np.concatenate([np.zeros((Bq, 1), np.int32), core], 1),
        "trg_next": np.concatenate([core, np.ones((Bq, 1), np.int32)], 1),
        "trg_len": np.array([Tq, 2, 4, Tq], np.int32)}
    jm = JaxSeq2Seq(**cfg)
    jp = jm.init(jax.random.PRNGKey(5))
    for k, f in (("src_emb", 50.0), ("trg_emb", 50.0), ("att_v", 20.0)):
        jp[k] = jp[k] * f
    l_ref, g_ref = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = Seq2SeqAttention(**cfg, device="cpu")
    tp = {k: v.requires_grad_() for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    loss = tm.loss(tp, batch)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-3)
    for name, g in zip(tp, grads):
        _close_ulps(g.numpy(), g_ref[name], 16, name)


# ---------------------------------------------------------------------------
# the loss-scale state machine
# ---------------------------------------------------------------------------


def _mse_trainer(nn, trainer_cls, seed=0, **kw):
    nn.reset_naming()
    x = nn.data("x", size=4)
    y = nn.data("y", size=2)
    cost = nn.mse_cost(input=nn.fc(x, 2, act="relu", name="h"), label=y)
    opt = (jopt if nn is jnn else topt).Adam(learning_rate=0.05)
    if trainer_cls is SGDTrainer:
        kw.setdefault("device", "cpu")
    return trainer_cls(cost, opt, seed=seed, **kw)


def _feeds(n=6, batch=4):
    rs = np.random.RandomState(0)
    return [{"x": rs.randn(batch, 4).astype(np.float32),
             "y": rs.randn(batch, 2).astype(np.float32)} for _ in range(n)]


def _host(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def _slots(tr):
    return [v.detach().numpy().copy() for k in sorted(tr.params)
            for v in slot_leaves(tr.opt_state["slots"][k])]


def test_nan_batch_halves_scale_and_skips_without_abort(amp_on):
    tr = _mse_trainer(tnn, SGDTrainer)
    feeds = _feeds(4)
    tr.train_batch(feeds[0])
    p_before, s_before = _host(tr.params), _slots(tr)
    step_before = int(tr.opt_state["step"])
    scale0 = float(tr.opt_state["amp"]["scale"])
    tr.train_batch(chaos.nan_feed(feeds[1]))
    assert int(tr._last_extras["bad_step"]) == 1
    assert int(tr._last_extras["amp_overflow"]) == 1
    assert float(tr.opt_state["amp"]["scale"]) == scale0 / 2
    for k in p_before:  # the poisoned step held params and slots
        np.testing.assert_array_equal(p_before[k],
                                      tr.params[k].detach().numpy())
    for a, b in zip(s_before, _slots(tr)):
        np.testing.assert_array_equal(a, b)
    assert int(tr.opt_state["step"]) == step_before
    assert tr.amp_overflows_total == 1
    tr.train_batch(feeds[2])
    assert tr.bad_steps_streak == 0


def test_pure_grad_overflow_never_advances_abort_streak(amp_on, monkeypatch):
    """A too-high initial scale takes several halvings to find range; with
    max_bad_steps=2 that search must not abort."""
    monkeypatch.setattr(FLAGS, "loss_scale", 3.0e38)
    tr = _mse_trainer(tnn, SGDTrainer, max_bad_steps=2)
    overflowed = 0
    for f in _feeds(8):
        tr.train_batch(f)
        overflowed += int(tr._last_extras["amp_overflow"])
        assert int(tr._last_extras["bad_step"]) == 0
    assert overflowed >= 2
    assert tr.bad_steps_streak == 0
    assert float(tr.opt_state["amp"]["scale"]) < 3.0e38


def test_planted_grad_overflow_holds_state_bit_for_bit(amp_on, monkeypatch):
    """A batch whose loss is finite but whose scaled gradients overflow (a
    feed scaled so that scale * d_loss passes the f32 range): the step is
    skipped with parameters and slots held bit for bit, the scale halves,
    ``bad_steps_streak`` does not advance, and a clean batch trains."""
    monkeypatch.setattr(FLAGS, "loss_scale", 2.0 ** 24)
    tr = _mse_trainer(tnn, SGDTrainer)
    feeds = _feeds(3)
    tr.train_batch(feeds[0])
    p0, s0 = _host(tr.params), _slots(tr)
    big = {"x": feeds[1]["x"] * 1e15, "y": feeds[1]["y"]}
    loss = float(tr.train_batch(big))
    assert np.isfinite(loss)
    assert int(tr._last_extras["amp_overflow"]) == 1
    assert int(tr._last_extras["bad_step"]) == 0
    assert tr.bad_steps_streak == 0
    assert float(tr.opt_state["amp"]["scale"]) == 2.0 ** 23
    for k in p0:
        np.testing.assert_array_equal(p0[k], tr.params[k].detach().numpy())
    for a, b in zip(s0, _slots(tr)):
        np.testing.assert_array_equal(a, b)
    tr.train_batch(feeds[2])
    assert int(tr._last_extras["amp_overflow"]) == 0
    assert any(not np.array_equal(p0[k], tr.params[k].detach().numpy())
               for k in p0)


def test_growth_schedule_doubles_and_caps(amp_on, monkeypatch):
    monkeypatch.setattr(FLAGS, "loss_scale", 1024.0)
    monkeypatch.setattr(FLAGS, "loss_scale_growth", 2)
    monkeypatch.setattr(FLAGS, "loss_scale_max", 4096.0)
    tr = _mse_trainer(tnn, SGDTrainer)
    for f in _feeds(8):
        tr.train_batch(f)
    assert float(tr.opt_state["amp"]["scale"]) == 4096.0


def test_scale_recovers_after_overflow(amp_on, monkeypatch):
    monkeypatch.setattr(FLAGS, "loss_scale", 1024.0)
    monkeypatch.setattr(FLAGS, "loss_scale_growth", 2)
    tr = _mse_trainer(tnn, SGDTrainer)
    feeds = _feeds(6)
    tr.train_batch(chaos.nan_feed(feeds[0]))
    assert float(tr.opt_state["amp"]["scale"]) == 512.0
    for f in feeds[1:5]:
        tr.train_batch(f)
    assert float(tr.opt_state["amp"]["scale"]) >= 1024.0


def test_persistent_nan_loss_still_aborts(amp_on):
    tr = _mse_trainer(tnn, SGDTrainer, max_bad_steps=3)
    bad = chaos.nan_feed(_feeds(1)[0])
    with pytest.raises(TooManyBadSteps):
        for _ in range(5):
            tr.train_batch(bad)


def test_amp_masters_stay_f32_and_loss_tracks_f32(amp_on, monkeypatch):
    feeds = _feeds(4)
    tr_amp = _mse_trainer(tnn, SGDTrainer)
    losses_amp = [float(tr_amp.train_batch(f)) for f in feeds]
    assert all(v.dtype == torch.float32 for v in tr_amp.params.values())
    assert all(s.dtype == torch.float32 for k in tr_amp.params
               for s in slot_leaves(tr_amp.opt_state["slots"][k]))
    monkeypatch.setattr(FLAGS, "amp", False)
    tr_f32 = _mse_trainer(tnn, SGDTrainer)
    losses_f32 = [float(tr_f32.train_batch(f)) for f in feeds]
    np.testing.assert_allclose(losses_amp, losses_f32, rtol=0.05, atol=0.05)


def test_trainer_refuses_amp_that_disagrees_with_the_flag(monkeypatch):
    with pytest.raises(ValueError, match="disagrees with FLAGS.amp"):
        _mse_trainer(tnn, SGDTrainer, amp=True)
    monkeypatch.setattr(FLAGS, "amp", True)
    with pytest.raises(ValueError, match="disagrees with FLAGS.amp"):
        _mse_trainer(tnn, SGDTrainer, amp=False)
    assert _mse_trainer(tnn, SGDTrainer, amp=True).amp


_SCALE_CASES = {
    # growth every 2 good steps, capped, with a poisoned batch mid-run
    "growth_and_nan": (dict(loss_scale=1024.0, loss_scale_growth=2,
                            loss_scale_max=4096.0), (3,)),
    # a scale past the f32 range: pure gradient overflows, halvings
    "too_high": (dict(loss_scale=3.0e38), ()),
    # the defaults, with two poisoned batches in a row
    "defaults_nan": ({}, (1, 2)),
}


@pytest.mark.parametrize("case", sorted(_SCALE_CASES))
def test_loss_scale_scalars_match_jax_bit_for_bit(amp_on, monkeypatch,
                                                  tmp_path, case):
    """The same feeds (some poisoned) through both packages' trainers from
    one initial checkpoint: ``scale``, ``good_steps``, ``amp_overflow``
    and ``bad_step`` equal bit for bit after every step, and the
    overflow and bad-step totals too."""
    flags, poisoned = _SCALE_CASES[case]
    for name, v in flags.items():
        monkeypatch.setattr(FLAGS, name, v)
        monkeypatch.setattr(JFLAGS, name, v)
    monkeypatch.setattr(FLAGS, "max_bad_steps", 0)
    monkeypatch.setattr(JFLAGS, "max_bad_steps", 0)
    jtr = _mse_trainer(jnn, JaxTrainer)
    jtr.save(str(tmp_path), 0)
    ttr = _mse_trainer(tnn, SGDTrainer, seed=9)
    ttr.load(str(tmp_path), 0)
    for i, f in enumerate(_feeds(8)):
        if i in poisoned:
            jf, tf = jchaos.nan_feed(f), chaos.nan_feed(f)
        else:
            jf = tf = f
        jtr.train_batch(jf)
        ttr.train_batch(tf)
        for k in ("scale", "good_steps"):
            want = np.asarray(jtr.opt_state["amp"][k])
            got = ttr.opt_state["amp"][k].numpy()
            assert got.dtype == want.dtype and got.tobytes() == \
                want.tobytes(), (i, k, got, want)
        for k in ("amp_overflow", "bad_step"):
            assert int(ttr._last_extras[k]) == int(jtr._last_extras[k]), \
                (i, k)
        assert float(ttr._last_extras["loss_scale"]) == \
            float(jtr._last_extras["loss_scale"])
    assert ttr.amp_overflows_total == jtr.amp_overflows_total
    assert ttr.bad_steps_total == jtr.bad_steps_total


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_amp_checkpoint_restores_masters_and_scale_bitexact(
        amp_on, tmp_path, monkeypatch):
    monkeypatch.setattr(FLAGS, "loss_scale_growth", 2)
    tr = _mse_trainer(tnn, SGDTrainer)
    for f in _feeds(5):
        tr.train_batch(f)
    tr.save(str(tmp_path), 0)
    tr2 = _mse_trainer(tnn, SGDTrainer, seed=123)
    tr2.load(str(tmp_path), 0)
    for k in tr.params:
        assert tr2.params[k].dtype == torch.float32
        assert torch.equal(tr.params[k], tr2.params[k])
    for k in ("scale", "good_steps"):
        assert torch.equal(tr2.opt_state["amp"][k], tr.opt_state["amp"][k])
    assert tr2.opt_state["amp"]["good_steps"].dtype == torch.int32


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_amp_checkpoint_crosses_packages(amp_on, tmp_path, monkeypatch,
                                         direction):
    """An --amp checkpoint (masters, Adam slots, the loss-scale state)
    written by one package after three steps, one of them poisoned, is
    loaded by the other: every array and the scale state arrive bit for
    bit, and the reader continues training from them."""
    monkeypatch.setattr(FLAGS, "loss_scale_growth", 2)
    monkeypatch.setattr(JFLAGS, "loss_scale_growth", 2)
    feeds = _feeds(5)
    jtr = _mse_trainer(jnn, JaxTrainer)
    ttr = _mse_trainer(tnn, SGDTrainer, seed=7)
    writer, reader = (jtr, ttr) if direction == "jax_to_torch" else \
        (ttr, jtr)
    for i, f in enumerate(feeds[:3]):
        writer.train_batch((jchaos if writer is jtr else chaos).nan_feed(f)
                           if i == 1 else f)
    writer.save(str(tmp_path), 0)
    reader.load(str(tmp_path), 0)
    assert _np(reader.opt_state["amp"]["scale"]).tobytes() == \
        _np(writer.opt_state["amp"]["scale"]).tobytes()
    assert int(reader.opt_state["amp"]["good_steps"]) == \
        int(writer.opt_state["amp"]["good_steps"]) == 1
    for k in writer.params:
        np.testing.assert_array_equal(_np(reader.params[k]),
                                      _np(writer.params[k]))
    for f in feeds[3:]:
        assert np.isfinite(float(reader.train_batch(f)))
    assert int(reader.opt_state["amp"]["good_steps"]) == 1  # grew at 2


def test_amp_resumed_run_matches_uninterrupted(amp_on, tmp_path,
                                               monkeypatch):
    """A resumed --amp run (params, slots, the random stream and the
    loss-scale state restored) matches an uninterrupted one bit for
    bit."""
    monkeypatch.setattr(FLAGS, "loss_scale_growth", 4)
    feeds = _feeds(6)

    def reader():
        return iter(feeds)

    tr_a = _mse_trainer(tnn, SGDTrainer)
    tr_a.train(reader, num_passes=3)
    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path))
    tr_b = _mse_trainer(tnn, SGDTrainer)
    tr_b.train(reader, num_passes=1)
    tr_c = _mse_trainer(tnn, SGDTrainer, seed=99)
    tr_c.train(reader, num_passes=3, resume="auto")
    for k in tr_a.params:
        assert torch.equal(tr_a.params[k], tr_c.params[k]), k
    for k in ("scale", "good_steps"):
        assert torch.equal(tr_a.opt_state["amp"][k],
                           tr_c.opt_state["amp"][k])
    assert os.path.isdir(os.path.join(str(tmp_path), "pass-00002"))


# ---------------------------------------------------------------------------
# the kernels' plain versions ignore --amp
# ---------------------------------------------------------------------------


def test_kernel_plain_versions_are_the_same_under_amp(monkeypatch):
    """K3r/K4, K9r/K10 and K5/K6 keep float32 carries and products under
    --amp, as the reference's Pallas kernels do; so do their plain
    versions: each output under --amp equals the same call under the
    plain bfloat16 policy bit for bit (the compute dtype is bf16 either
    way; only the activation policy differs)."""
    from paddle_tpu_torch.ops.kernels import (attn_dec_bwd_plain,
                                              attn_dec_fwd_plain,
                                              gru_backward_plain,
                                              gru_forward_plain,
                                              lstm_backward_plain,
                                              lstm_forward_plain)

    rs = np.random.RandomState(11)
    Bq, Tq, Hq = 3, 5, 8
    mask = _t((np.arange(Tq)[None] < np.array([5, 2, 4])[:, None]))
    m_tb = mask.t().contiguous()
    bf = torch.bfloat16

    def run():
        outs = []
        xp = _t(rs.randn(Bq, Tq, 3 * Hq))
        wg = _t(0.3 * rs.randn(Hq, 3 * Hq))
        h, hf, z, hp = gru_forward_plain(xp, mask, wg, residuals=True)
        outs += [h, hf, z, hp]
        outs += list(gru_backward_plain(_t(rs.randn(Tq, Bq, Hq)), m_tb, z,
                                        hp, wg.t().contiguous(),
                                        _t(rs.randn(Bq, Hq))))
        xl = _t(rs.randn(Bq, Tq, 4 * Hq))
        wl = _t(0.3 * rs.randn(Hq, 4 * Hq))
        p = [_t(0.3 * rs.randn(Hq)) for _ in range(3)]
        h, hf, cf, z, hp, cp = lstm_forward_plain(xl, mask, wl, *p,
                                                  residuals=True)
        outs += [h, hf, cf, z, hp, cp]
        outs += list(lstm_backward_plain(
            _t(rs.randn(Tq, Bq, Hq)), m_tb, z, cp, wl.t().contiguous(), *p,
            _t(rs.randn(Bq, Hq)), _t(rs.randn(Bq, Hq)), want_cn=True))
        S, A, H2, D = 4, 6, 10, Hq
        smask = _t((np.arange(S)[None] < np.array([4, 3, 1])[:, None]))
        enc = _t(rs.randn(Bq, S, H2)).to(bf)
        ep = _t(rs.randn(Bq, S, A)).to(bf)
        aw = _t(0.4 * rs.randn(D, A)).to(bf)
        av = _t(0.4 * rs.randn(A)).to(bf)
        wxc = _t(0.4 * rs.randn(H2, 3 * D)).to(bf)
        wh = _t(0.4 * rs.randn(D, 3 * D)).to(bf)
        fwd = attn_dec_fwd_plain(_t(rs.randn(Tq, Bq, 3 * D)), m_tb,
                                 _t(rs.randn(Bq, D)), enc, ep, smask, aw,
                                 av, wxc, wh)
        outs += list(fwd)
        gates = [torch.sigmoid(_t(rs.randn(Tq, Bq, D))) for _ in range(3)]
        outs += list(attn_dec_bwd_plain(
            _t(rs.randn(Tq, Bq, D)), m_tb, fwd[3], *gates,
            _t(rs.randn(Tq, Bq, A)), enc, ep, smask, aw.float(), av,
            wh.float(), wxc.float()))
        return outs

    monkeypatch.setattr(FLAGS, "compute_dtype", "bfloat16")
    want = run()
    rs = np.random.RandomState(11)
    monkeypatch.setattr(FLAGS, "amp", True)
    got = run()
    assert len(got) == len(want) == 25
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and torch.equal(g, w), i




def test_cli_amp_trains_and_checkpoints_the_scale(tmp_path, monkeypatch):
    """``--job=train --amp --loss_scale_growth=2`` through the command
    line: the checkpoints carry the loss-scale state under the
    reference's keys, grown on schedule over six finite steps, and the
    masters stay float32."""
    from paddle_tpu_torch.__main__ import main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = os.path.join(root, "tests", "torch_textclf_conf.py")
    for k, v in {"VOCAB": 48, "EMB": 8, "HID": 12, "BATCH": 6, "T": 10,
                 "N": 18, "TEST_N": 12}.items():
        monkeypatch.setenv(f"TORCH_TEXTCLF_{k}", str(v))
    keep = FLAGS.as_dict()
    try:
        assert main([f"--config={conf}", "--device=cpu", "--job=train",
                     "--num_passes=2", "--amp", "--loss_scale=1024",
                     "--loss_scale_growth=2", f"--save_dir={tmp_path}"]) == 0
        assert FLAGS.amp
    finally:
        for k, v in keep.items():
            setattr(FLAGS, k, v)
    opt = np.load(tmp_path / "pass-00001" / "opt_state.npz")
    params = np.load(tmp_path / "pass-00001" / "params.npz")
    assert opt["['amp']['scale']"] == np.float32(1024 * 2 ** 3)
    assert opt["['amp']['good_steps']"] == 0
    assert opt["['amp']['good_steps']"].dtype == np.int32
    assert all(params[k].dtype == np.float32 for k in params.files)
