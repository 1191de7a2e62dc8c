"""The port's image tier against the JAX package's, on the CPU: the
activations, ``ops/conv.py`` and ``ops/misc.py`` (forward and gradient),
and the image layers (parameter names and shapes, spatial meta, outputs
and the reference's ``ConfigError``s).  The models, the trainer and the
command line on them are in ``tests/test_torch_image_bench.py``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vision.py -q

Inputs come from numpy with a seed; the reference runs at float32
(``tests/conftest.py``), the port under ``compute_dtype_scope("float32")``.

Tolerances: single ops are held at rtol 1e-5 and an absolute 1e-6 of the
larger of 1 and the reference's largest entry (``close``): the same
float32 sums (up to kh*kw*Cin terms for a conv) taken in another order;
element-wise ops and the pools are exact or within one float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.ops as JO
import paddle_tpu.ops.misc as JM
from paddle_tpu.utils.error import ConfigError as JConfigError

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO
import paddle_tpu_torch.ops.misc as TM
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.utils.error import ConfigError

from torch_compare import close, fwd_grad, randn


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

#: names whose domain is positive
_POSITIVE = {"log", "sqrt", "reciprocal"}


@pytest.mark.parametrize("name", ["linear", "sigmoid", "tanh", "relu",
                                  "brelu", "stanh", "softrelu",
                                  "exponential", "log", "abs", "square",
                                  "sqrt", "reciprocal", "softmax"])
def test_activation_matches_reference(name):
    x = randn(5, 7, seed=3, scale=3.0)
    if name in _POSITIVE:
        x = np.abs(x) + 0.5
    if name == "brelu":
        x[0, :3] = [30.0, -2.0, 24.5]  # both bounds
    if name == "softrelu":
        x[1, :2] = [50.0, -60.0]  # the clip
    assert name in TO.ACTIVATIONS
    fwd_grad(JO.get_activation(name), TO.get_activation(name), x)


def test_softmax_statistics_in_float32_and_dtype_kept():
    x = torch.tensor(randn(4, 50, seed=1, scale=4.0)).to(torch.bfloat16)
    y = TO.softmax(x)
    assert y.dtype == torch.bfloat16
    want = JO.softmax(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    close(y.float(), np.asarray(want.astype(jnp.float32)), rtol=0, atol=0)


def test_unknown_activation_and_identity():
    assert TO.get_activation(None) is TO.get_activation("linear")
    with pytest.raises(KeyError, match="unknown activation"):
        TO.get_activation("swish")


# ---------------------------------------------------------------------------
# ops/conv.py
# ---------------------------------------------------------------------------

CONV_CASES = [
    # (H, W, Cin, Cout, k, stride, padding, groups, dilation)
    (9, 9, 4, 6, 3, 1, "SAME", 1, 1),
    (9, 8, 4, 6, 3, 2, "SAME", 1, 1),      # asymmetric SAME (odd total)
    (8, 8, 3, 5, 1, 2, "SAME", 1, 1),
    (19, 19, 3, 4, 11, 4, [(1, 1), (1, 1)], 1, 1),  # AlexNet's stem shape
    (15, 15, 3, 8, 7, 2, [(3, 3), (3, 3)], 1, 1),   # GoogLeNet's stem
    (10, 11, 4, 6, 5, 1, "VALID", 1, 1),
    (10, 10, 4, 6, 3, 1, "SAME", 2, 1),    # groups
    (11, 11, 4, 4, 3, 1, "VALID", 4, 2),   # depthwise, dilation
    (12, 12, 3, 4, 3, 4, "SAME", 1, 1),    # stride 4
    (7, 7, 2, 3, 3, 1, [(1, 2), (0, 1)], 1, 1),  # explicit asymmetric
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_matches_reference(case):
    H, W, cin, cout, k, s, pad, g, d = case
    x = randn(2, H, W, cin, seed=H)
    w = randn(k, k, cin // g, cout, seed=k, scale=0.3)
    kw = dict(stride=(s, s), padding=pad, groups=g, dilation=(d, d))
    fwd_grad(lambda a, b: JO.conv2d(a, b, **kw),
             lambda a, b: TO.conv2d(a, b, **kw), x, w)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("pad", ["SAME", "VALID"])
def test_conv2d_transpose_matches_reference(k, s, pad):
    """``lax.conv_transpose`` (kernel not flipped) for odd and even k,
    strides 1-3; the SAME output is ``in * stride``."""
    x = randn(2, 5, 6, 3, seed=k * 7 + s)
    w = randn(k, k, 3, 4, seed=k, scale=0.3)
    y = TO.conv2d_transpose(torch.tensor(x), torch.tensor(w),
                            stride=(s, s), padding=pad)
    if pad == "SAME":
        assert tuple(y.shape) == (2, 5 * s, 6 * s, 4)
    fwd_grad(lambda a, b: JO.conv2d_transpose(a, b, stride=(s, s),
                                              padding=pad),
             lambda a, b: TO.conv2d_transpose(a, b, stride=(s, s),
                                              padding=pad), x, w)


POOL_PADS = [
    ("SAME", 3, 2, 9), ("SAME", 3, 2, 8), ("SAME", 3, 1, 7),
    ("VALID", 2, 2, 9), ("VALID", 3, 2, 11),
    # the layer's int padding in ceil mode: extra bottom/right rows
    (((0, 0), (1, 2), (1, 2), (0, 0)), 3, 2, 7),
    (((0, 0), (1, 1), (1, 1), (0, 0)), 3, 1, 8),
    (((0, 0), (0, 1), (0, 1), (0, 0)), 3, 2, 14),
    (((0, 0), (2, 3), (2, 3), (0, 0)), 5, 3, 10),
]


@pytest.mark.parametrize("op", ["max_pool2d", "avg_pool2d"])
@pytest.mark.parametrize("pad,k,s,H", POOL_PADS, ids=str)
def test_pool_matches_reference(op, pad, k, s, H):
    """Max pools pad with -inf; average pools divide by the in-bounds taps
    only, so the border windows' divisors are the reference's."""
    x = randn(2, H, H + 1, 3, seed=H + k)
    fwd_grad(lambda a: getattr(JO, op)(a, (k, k), (s, s), pad),
             lambda a: getattr(TO, op)(a, (k, k), (s, s), pad), x)


def test_avg_pool_border_divisors():
    """A map of ones averages to exactly 1 in every window, border windows
    included (the divisor counts in-bounds taps, not the padding)."""
    ones = torch.ones(1, 5, 5, 2)
    for pad in ("SAME", ((0, 0), (1, 2), (1, 2), (0, 0))):
        y = TO.avg_pool2d(ones, (3, 3), (2, 2), pad)
        assert torch.equal(y, torch.ones_like(y))
    x = torch.arange(25.0).reshape(1, 5, 5, 1)
    y = TO.avg_pool2d(x, (3, 3), (2, 2), "SAME")
    # the corner window covers rows/cols 0-1 only (SAME pads 1 before)
    assert y[0, 0, 0, 0].item() == (0 + 1 + 5 + 6) / 4


def test_global_avg_pool_and_maxout_match_reference():
    x = randn(2, 4, 5, 12, seed=2)
    fwd_grad(JO.global_avg_pool, TO.global_avg_pool, x)
    # ties: maxout's gradient is split evenly among equal maxima, as JAX's
    x[0, 0, 0, :4] = 1.5
    fwd_grad(lambda a: JO.maxout(a, 4), lambda a: TO.maxout(a, 4), x)
    with pytest.raises(ValueError, match="maxout"):
        TO.maxout(torch.tensor(x), 5)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_reference(train):
    """Biased variance, the EMA ``0.9 * running + 0.1 * batch`` in train
    mode, the running stats unchanged in eval mode."""
    x = randn(3, 4, 5, 6, seed=4, scale=2.0) + 1.0
    scale = np.abs(randn(6, seed=5)) + 0.5
    bias, rm = randn(6, seed=6), randn(6, seed=7)
    rv = np.abs(randn(6, seed=8)) + 0.5
    args = (x, scale, bias, rm, rv)
    want = JO.batch_norm(*map(jnp.asarray, args), train=train)
    got = TO.batch_norm(*map(torch.tensor, args), train=train)
    for g, w in zip(got, want):
        close(g, w)
    if train:
        mean = x.reshape(-1, 6).astype(np.float64).mean(0)
        var = x.reshape(-1, 6).astype(np.float64).var(0)
        close(got[1], 0.9 * rm + 0.1 * mean)
        close(got[2], 0.9 * rv + 0.1 * var)
    else:
        assert torch.equal(got[1], torch.tensor(rm))
    fwd_grad(lambda a, s, b: JO.batch_norm(a, s, b, jnp.asarray(rm),
                                           jnp.asarray(rv), train=train)[0],
             lambda a, s, b: TO.batch_norm(a, s, b, torch.tensor(rm),
                                           torch.tensor(rv),
                                           train=train)[0],
             x, scale, bias)


def test_batch_norm_statistics_in_float32_for_bfloat16():
    """bf16 activations: float32 statistics and running stats, y back in
    bf16, equal to the reference's on the same bf16 values."""
    x = torch.tensor(randn(4, 3, 3, 5, seed=9, scale=3.0) + 2.0).to(
        torch.bfloat16)
    scale, bias = torch.ones(5), torch.zeros(5)
    rm, rv = torch.zeros(5), torch.ones(5)
    y, nm, nv = TO.batch_norm(x, scale, bias, rm, rv, train=True)
    assert y.dtype == torch.bfloat16 and nm.dtype == nv.dtype == \
        torch.float32
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    wy, wm, wv = JO.batch_norm(jx, *(jnp.asarray(t.numpy()) for t in
                                     (scale, bias, rm, rv)), train=True)
    close(nm, wm)
    close(nv, wv)
    close(y.float(), np.asarray(wy.astype(jnp.float32)), rtol=0,
          atol=2 ** -7)


def test_cmr_norm_matches_reference():
    x = randn(2, 3, 4, 16, seed=10, scale=30.0)
    for size in (3, 5):
        fwd_grad(lambda a: JO.cmr_norm(a, size=size),
                 lambda a: TO.cmr_norm(a, size=size), x)


def test_cmr_norm_bfloat16_keeps_the_correction():
    """Under bf16 activations the float32 denominator keeps the ``1 +
    1e-4 * acc`` correction that a bf16 one would round away: the bf16
    result is the float32 result rounded once to bf16."""
    x = randn(2, 3, 3, 16, seed=11, scale=30.0)
    y32 = TO.cmr_norm(torch.tensor(x))
    y16 = TO.cmr_norm(torch.tensor(x).to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    want = TO.cmr_norm(torch.tensor(x).to(torch.bfloat16).float())
    assert torch.equal(y16, want.to(torch.bfloat16))
    assert (y32 != torch.tensor(x)).float().mean() > 0.9


@pytest.mark.parametrize("out_hw", [(12, 14), (9, 11), (3, 4), (2, 2),
                                    (5, 9), (6, 7)], ids=str)
def test_bilinear_interp_matches_reference(out_hw):
    """Up- and downsampling (``jax.image.resize`` antialiases when it
    downsamples; half-pixel centres)."""
    x = randn(2, 6, 7, 3, seed=12)
    fwd_grad(lambda a: JO.bilinear_interp(a, *out_hw),
             lambda a: TO.bilinear_interp(a, *out_hw), x)


# ---------------------------------------------------------------------------
# ops/misc.py
# ---------------------------------------------------------------------------


MISC = {
    "row_sum": (lambda m, a: m.row_sum(a), ((4, 6),)),
    "row_max": (lambda m, a: m.row_max(a), ((4, 6),)),
    "row_min": (lambda m, a: m.row_min(a), ((4, 6),)),
    "col_sum": (lambda m, a: m.col_sum(a), ((4, 6),)),
    "batch_transpose": (lambda m, a: m.batch_transpose(a), ((2, 3, 5),)),
    "cos_sim": (lambda m, a, b: m.cos_sim(a, b, scale=2.0),
                ((4, 6), (4, 6))),
    "interpolation": (lambda m, w, a, b: m.interpolation(w, a, b),
                      ((4, 1), (4, 6), (4, 6))),
    "outer_prod": (lambda m, a, b: m.outer_prod(a, b), ((4, 3), (4, 5))),
    "tensor_bilinear": (lambda m, a, b, w: m.tensor_bilinear(a, b, w),
                        ((4, 3), (4, 5), (2, 3, 5))),
    "sum_cost": (lambda m, a: m.sum_cost(a), ((4, 6),)),
    "scaling": (lambda m, s, a: m.scaling(s, a), ((4, 1), (4, 6))),
    "slope_intercept": (lambda m, a: m.slope_intercept(a, 1.5, -0.5),
                        ((4, 6),)),
    "power_op": (lambda m, p, a: m.power_op(p, a), ((4, 1), (4, 6))),
}


@pytest.mark.parametrize("name", sorted(MISC))
def test_misc_op_matches_reference(name):
    fn, shapes = MISC[name]
    arrays = [randn(*s, seed=i + 20) for i, s in enumerate(shapes)]
    if name == "power_op":
        arrays[1] = np.abs(arrays[1]) + 0.5
    fwd_grad(lambda *a: fn(JM, *a), lambda *a: fn(TM, *a), *arrays)


def test_top_k_and_max_id_match_reference():
    x = randn(5, 9, seed=30)
    jv, ji = JO.top_k(jnp.asarray(x), 3)
    tv, ti = TO.top_k(torch.tensor(x), 3)
    close(tv, jv)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    mi = TO.max_id(torch.tensor(x))
    assert mi.dtype == torch.int32
    np.testing.assert_array_equal(mi.numpy(), np.asarray(JO.max_id(x)))


def test_dropout_is_inverted_and_seeded():
    x = torch.tensor(np.abs(randn(64, 100, seed=31)) + 1.0)
    assert TO.dropout(torch.Generator().manual_seed(0), x, 0.5,
                      train=False) is x
    assert TO.dropout(torch.Generator().manual_seed(0), x, 0.0,
                      train=True) is x
    y = TO.dropout(torch.Generator().manual_seed(3), x, 0.25, train=True)
    kept = y != 0
    assert torch.allclose(y[kept], x[kept] / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    again = TO.dropout(torch.Generator().manual_seed(3), x, 0.25,
                       train=True)
    assert torch.equal(y, again)
    other = TO.dropout(torch.Generator().manual_seed(4), x, 0.25,
                       train=True)
    assert not torch.equal(y, other)
    xb = x.to(torch.bfloat16)
    assert TO.dropout(torch.Generator().manual_seed(3), xb, 0.25,
                      train=True).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers: names, shapes, meta, outputs
# ---------------------------------------------------------------------------


def _img_graph(nn, mod):
    """Every image layer of this slice once, unnamed, so their
    auto-generated names and parameter names are compared."""
    img = nn.data("pixel", size=4, height=9, width=10)
    label = nn.data("label", size=1, dtype="int32")
    c1 = nn.img_conv(img, filter_size=3, num_filters=8, stride=2)
    c2 = nn.img_conv(c1, filter_size=3, num_filters=8, padding=1,
                     groups=2, act="linear", bias_attr=False)
    bn = nn.batch_norm(c2 + c1)
    p1 = nn.img_pool(bn, pool_size=3, stride=2, padding=1)
    p2 = nn.img_pool(bn, pool_size=3, stride=2, padding=1,
                     pool_type="avg")
    cat = nn.concat([p1, p2])
    lrn = nn.img_cmrnorm(cat, size=3)
    mo = nn.maxout(lrn, groups=2)
    up = nn.bilinear_interp(mo, out_h=6, out_w=5)
    sl = mod.slice_channels(up, 2, 6)
    ct = mod.img_conv_transpose(sl, filter_size=3, num_filters=3, stride=2)
    dr = nn.dropout(ct, 0.3)
    add = nn.addto([dr, ct], act="relu", bias_attr=True)
    logits = nn.fc(add, 5, act="linear")
    cost = nn.classification_cost(logits, label)
    return cost, [c1, c2, bn, p1, p2, cat, lrn, mo, up, sl, ct, dr, add]


def _both_graphs():
    import paddle_tpu.nn.layers_extra as jx
    import paddle_tpu.nn.layers_extra2 as jx2

    class J:
        slice_channels = staticmethod(jx.slice_channels)
        img_conv_transpose = staticmethod(jx2.img_conv_transpose)

    jnn.reset_naming()
    jcost, jl = _img_graph(jnn, J)
    tnn.reset_naming()
    tcost, tl = _img_graph(tnn, tnn)
    return (jcost, jl), (tcost, tl)


def test_image_layers_names_shapes_and_meta_match_reference():
    (jcost, jl), (tcost, tl) = _both_graphs()
    for a, b in zip(tl, jl):
        assert (a.name, a.layer_type, a.size, a.meta.get("hw")) == \
            (b.name, b.layer_type, b.size, b.meta.get("hw"))
    jt = jnn.Topology(jcost)
    tt = tnn.Topology(tcost, device="cpu")
    assert [l.name for l in tt.layers] == [l.name for l in jt.layers]
    want = {k: (s.shape, s.is_state, s.attr.init)
            for k, s in jt.param_specs.items()}
    got = {k: (s.shape, s.is_state, s.attr.init)
           for k, s in tt.param_specs.items()}
    assert got == want
    assert "___batch_norm_0__.moving_mean" in got
    assert "___conv_1__.wbias" not in got and "___addto_1__.wbias" in got


def test_image_layers_outputs_match_reference():
    """The graph above (dropout off: eval mode), every layer's output."""
    (jcost, jl), (tcost, tl) = _both_graphs()
    jt = jnn.Topology(jcost)
    tt = tnn.Topology(tcost, device="cpu")
    jp, js = jt.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(40)
    feed = {"pixel": rs.rand(2, 9, 10, 4).astype(np.float32),
            "label": rs.randint(0, 5, (2, 1)).astype(np.int32)}
    jouts, _ = jt.apply(jp, js, feed, train=False)
    touts, tstate = tt.apply(
        {k: torch.tensor(np.asarray(v)) for k, v in jp.items()},
        {k: torch.tensor(np.asarray(v)) for k, v in js.items()}, feed,
        train=False)
    for layer in tl + [tcost]:
        close(touts[layer.name].value, jouts[layer.name].value,
              what=layer.name)
    assert set(tstate) == set(js)


def test_layer_add_is_addto():
    tnn.reset_naming()
    img = tnn.data("pixel", size=2, height=4, width=4)
    a = tnn.img_conv(img, filter_size=1, num_filters=2)
    s = a + img
    assert s.layer_type == "addto" and s.name == "__addto_0__"
    assert s.parents == [a, img] and s.meta["hw"] == (4, 4)


@pytest.mark.parametrize("ceil_mode", [True, False])
@pytest.mark.parametrize("h,k,s,p", [(7, 3, 2, 0), (8, 3, 2, 1),
                                     (6, 2, 2, 1), (5, 3, 3, 1),
                                     (9, 3, 2, 2), (10, 4, 3, 1)], ids=str)
def test_img_pool_int_padding_matches_reference(h, k, s, p, ceil_mode):
    """Ceil mode (extra bottom/right padding), the legacy clip of a window
    starting in the padding ((6, 2, 2, 1), (5, 3, 3, 1) and (9, 3, 2, 2)
    clip), and floor mode: the output size and values of both pool
    types."""
    jnn.reset_naming()
    tnn.reset_naming()
    x = np.random.RandomState(h * k + s).randn(2, h, h, 3).astype(
        np.float32)
    for pool_type in ("max", "avg"):
        outs = []
        for nn in (jnn, tnn):
            img = nn.data("pixel", size=3, height=h, width=h)
            pool = nn.img_pool(img, pool_size=k, stride=s, padding=p,
                               pool_type=pool_type, ceil_mode=ceil_mode)
            topo = (nn.Topology(pool) if nn is jnn
                    else nn.Topology(pool, device="cpu"))
            out, _ = topo.apply({}, {}, {"pixel": x})
            outs.append((pool.meta["hw"], out[pool.name].value))
        (jhw, want), (thw, got) = outs
        assert thw == jhw and tuple(got.shape[1:3]) == thw
        close(got, want, what=pool_type)


def test_img_pool_act_after_max_pool():
    """``act`` after a max pool is the conventional act before it."""
    tnn.reset_naming()
    img = tnn.data("pixel", size=3, height=8, width=8)
    after = tnn.img_pool(img, pool_size=3, stride=2, padding="SAME",
                         act="relu")
    topo = tnn.Topology(after, device="cpu")
    x = randn(2, 8, 8, 3, seed=41)
    got = topo.apply({}, {}, {"pixel": x})[0][after.name].value
    want = TO.max_pool2d(torch.relu(torch.tensor(x)), (3, 3), (2, 2),
                         "SAME")
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["conv_too_small", "pool_too_small",
                                  "act_with_avg", "non_monotone_act",
                                  "no_spatial_meta", "bad_slice"])
def test_image_layer_config_errors_match_reference(case):
    """The reference's ``ConfigError``s, raised by the port the same way
    and with the same message."""
    import paddle_tpu.nn.layers_extra as jx

    def build(nn, slice_channels):
        img = nn.data("pixel", size=3, height=5, width=5)
        if case == "conv_too_small":
            nn.img_conv(img, filter_size=7, num_filters=2, padding="VALID")
        elif case == "pool_too_small":
            nn.img_pool(img, pool_size=7, padding="VALID")
        elif case == "act_with_avg":
            nn.img_pool(img, pool_size=2, pool_type="avg", act="relu")
        elif case == "non_monotone_act":
            nn.img_pool(img, pool_size=2, act="abs")
        elif case == "no_spatial_meta":
            nn.img_conv(nn.data("x", size=3), filter_size=1, num_filters=2)
        else:
            slice_channels(img, 2, 5)

    msgs = []
    for nn, err, sl in ((jnn, JConfigError, jx.slice_channels),
                        (tnn, ConfigError, tnn.slice_channels)):
        nn.reset_naming()
        with pytest.raises(err) as info:
            build(nn, sl)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("module", ["layers_extra", "layers_extra2"])
def test_unported_extra_layers_name_their_roadmap_item(module):
    """Every layer of the two reference modules is ported: each module's
    ``NOT_PORTED`` is empty and its ``__all__`` is the reference's, every
    name reached here and through ``paddle_tpu_torch.nn``.  (The nested
    data layer is ported too: ``tests/test_torch_nested_seq.py``.)"""
    import importlib

    mod = importlib.import_module(f"paddle_tpu_torch.nn.{module}")
    ref = importlib.import_module(f"paddle_tpu.nn.{module}")
    assert mod.NOT_PORTED == ()
    assert mod.__all__ == ref.__all__
    for name in mod.__all__:
        assert getattr(tnn, name) is getattr(mod, name)
        assert callable(getattr(mod, name))


def test_dropout_layer_train_and_eval():
    """In training the layer's mask comes from the apply's random stream
    (so a seed repeats it); out of training it is the identity."""
    tnn.reset_naming()
    x = tnn.data("x", size=50)
    d = tnn.dropout(x, 0.4)
    topo = tnn.Topology(d, device="cpu")
    feed = {"x": np.ones((8, 50), np.float32)}
    a = topo.apply({}, {}, feed, train=True, rng=5)[0][d.name].value
    b = topo.apply({}, {}, feed, train=True, rng=5)[0][d.name].value
    c = topo.apply({}, {}, feed, train=True, rng=6)[0][d.name].value
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) == {
        0.0, torch.tensor(1.0 / 0.6, dtype=torch.float32).item()}
    e = topo.apply({}, {}, feed, train=False)[0][d.name].value
    assert torch.equal(e, torch.ones(8, 50))


def test_image_layers_keep_the_reference_compute_dtypes(monkeypatch):
    """Under the bf16 policy in both packages: the conv's operands, output
    and bias sum stay bf16, batch norm and LRN return their input's dtype
    (f32 statistics and denominator inside), the fc returns f32; the
    values agree within two bf16 steps of each layer's largest entry
    (each side rounds its bf16 conv output once, and a rounding flip
    moves the next layer's input by one step)."""
    from paddle_tpu.utils.flags import FLAGS as JFLAGS

    monkeypatch.setattr(JFLAGS, "compute_dtype", "bfloat16")

    def build(nn):
        nn.reset_naming()
        img = nn.data("pixel", size=3, height=9, width=9)
        c = nn.img_conv(img, filter_size=3, num_filters=8, stride=2)
        bn = nn.batch_norm(c)
        p = nn.img_pool(bn, pool_size=3, stride=2, padding="SAME")
        lrn = nn.img_cmrnorm(p, size=3)
        return [c, bn, p, lrn, nn.fc(lrn, 4, act="linear")]

    jl, tl = build(jnn), build(tnn)
    jt = jnn.Topology(jl[-1])
    tt = tnn.Topology(tl[-1], device="cpu")
    jp, js = jt.init(jax.random.PRNGKey(3))
    feed = {"pixel": np.random.RandomState(5).rand(2, 9, 9, 3).astype(
        np.float32)}
    jouts, _ = jt.apply(jp, js, feed, train=True)
    with compute_dtype_scope("bfloat16"):
        touts, _ = tt.apply(
            {k: torch.tensor(np.asarray(v)) for k, v in jp.items()},
            {k: torch.tensor(np.asarray(v)) for k, v in js.items()}, feed,
            train=True)
    for a, b in zip(tl, jl):
        got, want = touts[a.name].value, jouts[b.name].value
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), \
            a.name
        w = np.asarray(want.astype(jnp.float32))
        g = got.detach().float().numpy()
        assert np.abs(g - w).max() <= 2 * 2 ** -8 * np.abs(w).max(), a.name
