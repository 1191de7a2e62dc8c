"""Nested (sub)sequences on the port against the JAX package, on the CPU:
the five behaviours of ``tests/test_nested_seq.py`` (a recurrent group
over sub-sequences whose inner RNN boots from the outer memory equals one
flat RNN over the concatenated tokens; a step that outputs a sequence
gives a nested output; gradients flow; the nested feeder kinds), each
also held against the JAX package on the same inputs and parameters, and
the two-level LSTM classifier of ``tests/torch_nested_nets.py`` (the
``seqdata`` phase's nested net at small widths).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_nested_seq.py -q

Tolerance: outputs at rtol 1e-5 / atol 1e-6 (``torch_compare.close``);
each gradient within 1e-5 of its largest entry (1e-6 absolute where it
vanishes): float32 sums in another order over the scans' steps.  The
nested-equals-flat check keeps the reference's rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.data import DataFeeder as JaxFeeder

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.utils.error import ConfigError

from torch_compare import assert_grads_close, close
from torch_nested_nets import flat_rnn_inputs, hier_lstm_net, nested_samples

H = 6  # rnn width
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


def _nested_net(nn, D, emit_sequence=False):
    """The reference test's outer group over sub-sequences with an inner
    RNN booted from the outer memory."""
    xn = nn.data("x", size=D, is_seq=True, nested=True)

    def outer_step(frame, outer_mem):
        def inner_step(tok, inner_mem):
            s = nn.fc([tok, inner_mem], H, act="tanh", name="cell",
                      bias_attr=False)
            return [s, s]

        states = nn.recurrent_group(
            inner_step, [frame], [nn.Memory("im", H, boot=outer_mem)],
            name="inner")
        last = nn.last_seq(states, name="last")
        return [states if emit_sequence else last, last]

    return nn.recurrent_group(outer_step, [xn], [nn.Memory("om", H)],
                              name="outer")


def _flat_net(nn, D):
    xf = nn.data("x", size=D, is_seq=True)

    def flat_step(tok, mem):
        s = nn.fc([tok, mem], H, act="tanh", name="cell", bias_attr=False)
        return [s, s]

    return nn.recurrent_group(flat_step, [xf], [nn.Memory("m", H)],
                              name="flat")


def _both(build, seed=0):
    """``build(nn)`` in each package -> (jax topology, port topology,
    output name, jax params as numpy)."""
    jnn.reset_naming()
    jout = build(jnn)
    jt = jnn.Topology(jout)
    jp, _ = jt.init(jax.random.PRNGKey(seed))
    tnn.reset_naming()
    tout = build(tnn)
    assert tout.name == jout.name
    tt = tnn.Topology(tout, device="cpu")
    assert set(tt.param_specs) == set(jt.param_specs)
    return jt, tt, tout.name, {k: np.asarray(v) for k, v in jp.items()}


def _apply_both(jt, tt, name, jp, feed):
    jo, _ = jt.apply({k: jnp.asarray(v) for k, v in jp.items()}, {}, feed)
    to, _ = tt.apply(tnn.params_from_jax(jp, "cpu"), {}, feed)
    return jo[name], to[name]


SUB = np.array([[4, 2, 3], [3, 4, 0]], np.int32)
OUTER = np.array([3, 2], np.int32)


def _vals(rng, B=2, To=3, Ti=4, D=5):
    return rng.randn(B, To, Ti, D).astype(np.float32)


def test_nested_equals_flat_rnn(rng):
    """Outer group over sub-sequences + inner RNN booted from the outer
    memory == one flat RNN over the concatenated tokens, on the port; the
    nested output equals the JAX package's."""
    B, To, Ti, D = 2, 3, 4, 5
    vals = _vals(rng)
    for b in range(B):
        for j in range(To):
            vals[b, j, SUB[b, j]:] = 0.0
    T = int(SUB.sum(1).max())
    flat_len = SUB.sum(1).astype(np.int32)
    flat = np.zeros((B, T, D), np.float32)
    for b in range(B):
        t = 0
        for j in range(OUTER[b]):
            n = SUB[b, j]
            flat[b, t:t + n] = vals[b, j, :n]
            t += n
    jt, tt, name, jp = _both(lambda nn: _nested_net(nn, D))
    jn, tn = _apply_both(jt, tt, name, jp, {"x": (vals, OUTER, SUB)})
    close(tn.value, jn.value, what="nested outputs vs JAX")
    tnn.reset_naming()
    flat_out = _flat_net(tnn, D)
    tf = tnn.Topology(flat_out, device="cpu")
    assert set(tf.param_specs) == set(tt.param_specs)
    fo, _ = tf.apply(tnn.params_from_jax(jp, "cpu"), {},
                     {"x": (flat, flat_len)})
    nested_states = tn.value.numpy()
    flat_states = fo[flat_out.name].value.numpy()
    for b in range(B):
        t = 0
        for j in range(OUTER[b]):
            t += SUB[b, j]
            np.testing.assert_allclose(nested_states[b, j],
                                       flat_states[b, t - 1], rtol=1e-5,
                                       atol=1e-6, err_msg=f"b={b} sub {j}")


def test_nested_equals_flat_rnn_seeded_shapes():
    """The same equality over seeded lengths, with a padded outer step and
    an empty sub-sequence in every row."""
    rng = np.random.RandomState(3)
    B, To, Ti, D = 4, 5, 6, 3
    vals, outer, sub, flat, flat_len = flat_rnn_inputs(rng, B, To, Ti, D,
                                                       empty_frame=True)
    jt, tt, name, jp = _both(lambda nn: _nested_net(nn, D), seed=1)
    jn, tn = _apply_both(jt, tt, name, jp, {"x": (vals, outer, sub)})
    close(tn.value, jn.value, what="nested outputs vs JAX")
    tnn.reset_naming()
    flat_out = _flat_net(tnn, D)
    fo, _ = tnn.Topology(flat_out, device="cpu").apply(
        tnn.params_from_jax(jp, "cpu"), {}, {"x": (flat, flat_len)})
    fs = fo[flat_out.name].value.numpy()
    for b in range(B):
        ends = np.cumsum(sub[b, :outer[b]])
        for j, t in enumerate(ends):
            if sub[b, j] == 0:
                # an empty sub-sequence's last_seq is zero, on both sides
                assert tn.value[b, j].abs().max().item() == 0
                continue
            np.testing.assert_allclose(tn.value[b, j].numpy(), fs[b, t - 1],
                                       rtol=1e-5, atol=1e-6)


def test_nested_group_emits_nested_output(rng):
    """A step whose output is a sequence produces a nested [B, To, Ti, H]
    act with per-sub-sequence lengths; padded outer steps are zero; the
    values equal the JAX package's."""
    B, To, Ti, D = 2, 3, 4, 5
    vals = _vals(rng)
    jt, tt, name, jp = _both(lambda nn: _nested_net(nn, D, True), seed=1)
    jn, tn = _apply_both(jt, tt, name, jp, {"x": (vals, OUTER, SUB)})
    assert tn.is_nested and jn.is_nested
    assert tuple(tn.value.shape) == (B, To, Ti, H)
    np.testing.assert_array_equal(tn.sub_lengths.numpy(), SUB)
    assert tn.value[1, 2].abs().max().item() == 0
    close(tn.value, jn.value, what="nested sequence output")


def test_nested_grad_flows(rng):
    """Every gradient is finite and nonzero, and equals the JAX
    package's."""
    B, To, Ti, D = 2, 2, 3, 4
    sub = np.array([[3, 2], [2, 0]], np.int32)
    outer = np.array([2, 1], np.int32)
    vals = rng.randn(B, To, Ti, D).astype(np.float32)
    jt, tt, name, jp = _both(lambda nn: _nested_net(nn, D), seed=2)
    feed = {"x": (vals, outer, sub)}

    def jloss(p):
        o, _ = jt.apply(p, {}, feed)
        return (o[name].value ** 2).sum()

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in jp.items()})
    tp = {k: v.requires_grad_()
          for k, v in tnn.params_from_jax(jp, "cpu").items()}
    o, _ = tt.apply(tp, {}, feed)
    grads = torch.autograd.grad((o[name].value ** 2).sum(), list(tp.values()))
    tg = {k: g.double().numpy() for k, g in zip(tp, grads)}
    for k, g in tg.items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
    assert_grads_close(tg, {k: np.asarray(v, np.float64)
                            for k, v in jg.items()}, RTOL, ATOL)


def _feeds_equal(got, want):
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype, k


def test_feeder_nested_kind():
    rows = [([[1, 2, 3], [4]], 0), ([[5]], 1)]
    types = {"x": "ids_nested", "label": "int"}
    feed = DataFeeder(types, buckets=(2, 4, 8))(rows)
    vals, outer, sub = feed["x"]
    np.testing.assert_array_equal(outer, [2, 1])
    assert vals.shape[1] >= 2 and vals.shape[2] >= 3
    np.testing.assert_array_equal(sub[0, :2], [3, 1])
    np.testing.assert_array_equal(vals[0, 0, :3], [1, 2, 3])
    np.testing.assert_array_equal(sub[1], [1] + [0] * (sub.shape[1] - 1))
    _feeds_equal({"x": feed["x"]},
                 {"x": JaxFeeder(types, buckets=(2, 4, 8))(rows)["x"]})


def test_feeder_nested_respects_max_len_and_empty_first_row():
    rows = [([list(range(9)), [1]],), ([[2], [3], [4], [5], [6], [7]],)]
    vals, outer, sub = DataFeeder({"x": "ids_nested"}, buckets=(2, 4, 8),
                                  max_len=4)(rows)["x"]
    assert vals.shape[1] <= 4 and vals.shape[2] <= 4
    assert outer.max() <= 4 and sub.max() <= 4
    rows_b = [([[9] * 6] * 7,)]
    vals_b, outer_b, sub_b = DataFeeder({"x": "ids_nested"},
                                        buckets=(2, 4, 8),
                                        max_len=5)(rows_b)["x"]
    assert outer_b[0] == 5 and sub_b.max() <= 5
    assert np.all(sub_b[0, 5:] == 0)
    assert np.all(vals_b[0, 5:] == 0) and np.all(vals_b[0, :, 5:] == 0)
    rows2 = [([],), ([[[1.0, 2.0], [3.0, 4.0]]],)]
    vals2, outer2, sub2 = DataFeeder({"x": "dense_nested"},
                                     buckets=(2, 4))(rows2)["x"]
    assert vals2.shape[-1] == 2
    np.testing.assert_array_equal(outer2, [0, 1])
    np.testing.assert_array_equal(vals2[1, 0, :2, :],
                                  [[1.0, 2.0], [3.0, 4.0]])
    for kind, rs, kw in (("ids_nested", rows, {"max_len": 4}),
                         ("ids_nested", rows_b, {"max_len": 5}),
                         ("dense_nested", rows2, {})):
        _feeds_equal(DataFeeder({"x": kind}, buckets=(2, 4, 8), **kw)(rs),
                     JaxFeeder({"x": kind}, buckets=(2, 4, 8), **kw)(rs))


def _hier_feed(B, vocab, seed=0):
    rs = np.random.RandomState(seed)
    flat = [(rs.randint(1, vocab, rs.randint(2, 30)).tolist(),
             int(rs.randint(0, 2))) for _ in range(B)]
    docs = nested_samples(flat, 4, 8)
    docs[-1] = ([[3, 4], []] + docs[-1][0][:1], docs[-1][1])
    return DataFeeder({"words": "ids_nested", "label": "int"},
                      buckets=(4, 8))(docs)


def test_hier_lstm_net_loss_and_grads_match_jax():
    """The two-level LSTM classifier (embedding and ``lstmemory`` inside an
    outer group over sentences, an empty sentence included): loss and
    every gradient against the JAX package, from the same parameters
    (peepholes and biases set to seeded normals)."""
    from torch_compare import loss_and_grads, nonzero_params

    V = 40
    jt, tt, name, jp = _both(lambda nn: hier_lstm_net(nn, V, 5, 7)[0],
                             seed=3)
    jp = nonzero_params(jp)
    feed = _hier_feed(5, V)
    jl, jg, tl, tg = loss_and_grads(jt, tt, name, jp, {}, feed)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)


def test_hier_lstm_net_trains():
    """Adam steps through ``SGDTrainer`` on the nested feed lower the
    loss."""
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    tnn.reset_naming()
    cost, _ = hier_lstm_net(tnn, 30, 6, 8)
    tr = SGDTrainer(cost, Adam(learning_rate=0.05), seed=0, device="cpu")
    feed = _hier_feed(6, 30, seed=1)
    first = float(tr.train_batch(feed))
    for _ in range(12):
        last = float(tr.train_batch(feed))
    assert last < first


def test_nested_data_layer_kinds_build():
    """``data(nested=True)`` is accepted as the reference accepts it, a
    sparse nested sequence too; ``nested`` without ``is_seq`` raises."""
    tnn.reset_naming()
    for kw in ({}, {"dtype": "int32"}, {"sparse": "binary"}):
        layer = tnn.data("w", size=10, is_seq=True, nested=True, **kw)
        assert layer.data_spec["nested"]
    with pytest.raises(ConfigError, match="requires is_seq"):
        tnn.data("w", size=10, nested=True)


def test_triple_feed_to_a_flat_layer_is_a_typed_config_error():
    tnn.reset_naming()
    x = tnn.data("x", size=4, is_seq=True)
    topo = tnn.Topology(tnn.pooling(x), device="cpu")
    lens = np.array([3, 2], np.int32)
    with pytest.raises(ConfigError, match="data\\(nested=True\\)"):
        topo.apply({}, {}, {"x": (np.zeros((2, 3, 4), np.float32), lens,
                                  lens[:, None])})
