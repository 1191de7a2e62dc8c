"""The port's nn DSL core (paddle_tpu_torch/nn: graph, the six layers of the
text-classification benchmark net) and ``models.lstm_benchmark_net``
against the JAX package.

Each graph is built twice from the same code, once with ``paddle_tpu.nn``
and once with ``paddle_tpu_torch.nn``; the JAX ``Topology.init``'s
parameters are carried across by ``params_from_jax`` (same names), the same
numpy feed goes through both ``Topology.apply``s, and outputs and
gradients (``jax.value_and_grad`` against ``torch.autograd.grad``) are
compared.  Float32 policy on both sides; the JAX LSTM runs on its scan path
or with its Pallas kernels forced on (interpret mode).  Tolerances: rtol
1e-5 / atol 1e-6 (``tests/test_rnn_fused.py``'s) for layers and the whole
net's gradients, the loss rtol 1e-5; Adam losses within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.models import lstm_benchmark_net as j_lstm_net
from paddle_tpu.param.optimizers import Adam as JaxAdam
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import lstm_benchmark_net as t_lstm_net
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.param import Adam
from paddle_tpu_torch.utils.error import ConfigError


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


def _both(build):
    """Build the graph with each package's nn (fresh names each) -> (JAX
    Topology, port Topology on the CPU, the JAX parameters and state)."""
    jnn.reset_naming()
    jout = build(jnn)
    tnn.reset_naming()
    tout = build(tnn)
    jtopo = jnn.Topology(jout)
    ttopo = tnn.Topology(tout, device="cpu")
    jp, js = jtopo.init(jax.random.PRNGKey(1))
    return jtopo, ttopo, jp, js


def _perturb(params, rng, scale=0.3):
    """Nonzero peepholes and biases (they init to zeros)."""
    out = dict(params)
    for k, v in params.items():
        if ".check_" in k or k.endswith(".wbias"):
            out[k] = jnp.asarray((scale * rng.randn(*v.shape)).astype(
                np.float32))
    return out


def _port_params(jp):
    return {k: v.requires_grad_() for k, v in tnn.params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}


def _j_feed(feed):
    return {k: tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
            else jnp.asarray(v) for k, v in feed.items()}


def _compare(jtopo, ttopo, jp, js, feed, out_name, ct_shape=None, rng=None,
             tol=(1e-5, 1e-6)):
    """Output value of ``out_name`` and the gradients of sum(out * ct) for
    every parameter."""
    ct = None if ct_shape is None else rng.randn(*ct_shape).astype(
        np.float32)

    def jloss(p):
        outs, _ = jtopo.apply(p, js, _j_feed(feed), train=True)
        v = outs[out_name].value
        return (v if ct is None else (v * ct).sum()), v

    (_, jv), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = _port_params(jp)
    outs, _ = ttopo.apply(tp, {}, feed, train=True)
    tv = outs[out_name].value
    obj = tv if ct is None else (tv * torch.from_numpy(ct)).sum()
    tg = torch.autograd.grad(obj, list(tp.values()), allow_unused=True)
    assert set(tp) == set(jg)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=tol[0], atol=tol[1], err_msg=out_name)
    for name, g in zip(tp, tg):
        want = np.asarray(jg[name])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=name)
    return tv


def _seq_feed(rng, B=4, T=6, vocab=20, lengths=(6, 3, 1, 5)):
    return {"words": (rng.randint(0, vocab, (B, T)).astype(np.int32),
                      np.asarray(lengths, np.int32))}


# ---------------------------------------------------------------------------
# names, shapes and the graph core
# ---------------------------------------------------------------------------


def _all_layers(nn):
    words = nn.data("words", size=20, is_seq=True, dtype="int32")
    label = nn.data("label", size=1, dtype="int32")
    emb = nn.embedding(words, 6)
    proj = nn.fc(emb, 16, act="linear")
    l1 = nn.lstmemory(proj, 4, projected_input=True)
    l2 = nn.lstmemory(emb, 5, reverse=True, use_peepholes=False,
                      bias_attr=False)
    p1 = nn.pooling(l1)
    p2 = nn.pooling(l2, pooling_type="avg")
    logits = nn.fc([p1, p2], 3, act="linear")
    return nn.classification_cost(logits, label)


def test_auto_names_param_names_and_shapes_match_the_reference():
    jnn.reset_naming()
    jcost = _all_layers(jnn)
    tnn.reset_naming()
    tcost = _all_layers(tnn)
    jtopo, ttopo = jnn.Topology(jcost), tnn.Topology(tcost, device="cpu")
    assert [l.name for l in ttopo.layers] == [l.name for l in jtopo.layers]
    assert [l.layer_type for l in ttopo.layers] == \
        [l.layer_type for l in jtopo.layers]
    assert {n: s.shape for n, s in ttopo.param_specs.items()} == \
        {n: s.shape for n, s in jtopo.param_specs.items()}
    assert {n: s.attr.init for n, s in ttopo.param_specs.items()} == \
        {n: s.attr.init for n, s in jtopo.param_specs.items()}
    assert tcost.name == jcost.name == "__cls_cost_0__"
    with tnn.naming_scope():
        assert tnn.next_name("fc") == "__fc_0__"
    assert tnn.next_name("fc") == "__fc_2__"


def test_init_distributions_skip_and_device():
    tnn.reset_naming()
    cost, _ = t_lstm_net(300, emb_dim=16, hid_dim=32)
    topo = tnn.Topology(cost, device="cpu")
    p, s = topo.init(3)
    assert not s and len(p) == 15
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in p.values())
    for k, v in p.items():
        if ".check_" in k or k.endswith(".wbias"):
            assert not v.any(), k
    assert abs(p["_emb.w0"].std().item() - 0.01) < 1e-3
    xav = (2.0 / (32 + 128)) ** 0.5                 # _lstm1.w0 [32, 128]
    assert abs(p["_lstm1.w0"].std().item() - xav) / xav < 0.05
    again, _ = topo.init(3)
    assert all(torch.equal(p[k], again[k]) for k in p)
    part, _ = topo.init(3, skip=["_emb.w0"])
    assert "_emb.w0" not in part
    assert all(torch.equal(p[k], part[k]) for k in part)
    other, _ = topo.init(4)
    assert not torch.equal(p["_lstm0.w0"], other["_lstm0.w0"])


def test_graph_errors_match_the_reference():
    tnn.reset_naming()
    x = tnn.data("x", size=4)
    a = tnn.fc(x, 3, name="a")
    b = tnn.fc(x, 3, name="a")
    with pytest.raises(ConfigError, match="duplicate layer name"):
        tnn.Topology([a, b], device="cpu")
    s1 = tnn.fc(x, 3, param_attr=tnn.ParamAttr(name="shared"))
    s2 = tnn.fc(x, 5, param_attr=tnn.ParamAttr(name="shared"))
    with pytest.raises(ConfigError, match="conflicting shapes"):
        tnn.Topology([s1, s2], device="cpu")
    topo = tnn.Topology(a, device="cpu")
    p, st = topo.init(0)
    with pytest.raises(ConfigError, match="missing feed"):
        topo.apply(p, st, {})
    with pytest.raises(ConfigError, match="unknown output"):
        topo.apply(p, st, {"x": np.zeros((2, 4), np.float32)},
                   outputs=["nope"])
    outs, _ = topo.apply(p, st, {"x": np.ones((2, 4), np.float32)},
                         outputs=["a"])
    assert tuple(outs["a"].value.shape) == (2, 3)


@pytest.mark.parametrize("kind", ["triple", "device_pin", "device_specs",
                                  "param_overrides", "sparse_grad"])
def test_unported_feeds_and_options_raise_config_error(kind):
    """``device_pin`` and ``apply(device_specs=)`` raise ``ConfigError``
    naming ROADMAP.md Queue 1 item 8 (the pipeline's model-parallel
    placement); a 3-tuple fed to a data layer that is not nested is a
    typed ``ConfigError`` that says so.  ``apply(param_overrides=)`` is
    ported (the pserver tier's table proxies): an override replaces the
    parameter for the call, and a ``sparse_grad`` table's override with a
    ``pserver_lookup`` takes the embedding's lookup."""
    unported = r"not ported.*Queue 1 item 8\b"
    tnn.reset_naming()
    words = tnn.data("w", size=10, is_seq=True, dtype="int32")
    emb = tnn.embedding(words, 4, sparse_grad=kind == "sparse_grad")
    if kind == "sparse_grad":
        assert emb.param_specs[0].attr.sparse_grad
    if kind == "device_pin":
        with pytest.raises(ConfigError, match=unported):
            tnn.device_pin(emb, "tp")
        return
    topo = tnn.Topology(tnn.pooling(tnn.lstmemory(emb, 4)), device="cpu")
    p, st = topo.init(0)
    ids, lens = np.zeros((2, 3), np.int32), np.array([3, 2], np.int32)
    feed = {"w": (ids, lens)}
    if kind == "triple":
        with pytest.raises(ConfigError, match=r"got a 3-tuple \(a nested "
                           r"feed needs data\(nested=True\)\)"):
            topo.apply(p, st, {"w": (ids, lens, lens[:, None])})
        return
    if kind == "device_specs":
        with pytest.raises(ConfigError, match=unported):
            topo.apply(p, st, feed, device_specs={"tp": None})
        return
    name = emb.param_specs[0].name
    base, _ = topo.apply(p, st, feed)
    if kind == "param_overrides":
        same, _ = topo.apply(p, st, feed, param_overrides={})
        assert torch.equal(same[emb.name].value, base[emb.name].value)
        twice, _ = topo.apply(p, st, feed,
                              param_overrides={name: 2 * p[name]})
        assert torch.allclose(twice[emb.name].value,
                              2 * base[emb.name].value)
        return

    class Proxy:
        calls = []

        def pserver_lookup(self, ids, *, layer, pad_to_zero_id=None):
            self.calls.append(layer)
            return torch.ones(tuple(ids.shape) + (4,))

    out, _ = topo.apply(p, st, feed, param_overrides={name: Proxy()})
    assert Proxy.calls == [emb.name]
    assert torch.equal(out[emb.name].value[0], torch.ones(3, 4))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tnn.reset_naming()
    cost, _ = t_lstm_net(30, emb_dim=4, hid_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.Topology(cost)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.params_from_jax({})


# ---------------------------------------------------------------------------
# each layer against the reference through Topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [None, 2])
def test_embedding_layer_matches_jax(rng, pad):
    def build(nn):
        w = nn.data("words", size=20, is_seq=True, dtype="int32")
        return nn.embedding(w, 5, padding_idx=pad, name="emb")

    jt, tt, jp, js = _both(build)
    feed = _seq_feed(rng)
    feed["words"][0][0, :3] = 2
    _compare(jt, tt, jp, js, feed, "emb", (4, 6, 5), rng)


def test_embedding_of_a_nonseq_int_slot_matches_jax(rng):
    def build(nn):
        w = nn.data("id", size=20, dtype="int32")
        return nn.embedding(w, 5, name="emb")

    jt, tt, jp, js = _both(build)
    feed = {"id": rng.randint(0, 20, (3, 1)).astype(np.int32)}
    out = _compare(jt, tt, jp, js, feed, "emb", (3, 5), rng)
    assert tuple(out.shape) == (3, 5)


@pytest.mark.parametrize("act", ["tanh", "linear", "sigmoid"])
def test_fc_layer_matches_jax(rng, act):
    """A sequence input (output masked per timestep) and a dense one with
    two inputs (separate weights, summed), under each activation."""
    def build(nn):
        w = nn.data("words", size=20, is_seq=True, dtype="int32")
        x = nn.data("x", size=7)
        y = nn.data("y", size=3)
        emb = nn.embedding(w, 5, name="emb")
        s = nn.fc(emb, 6, act=act, name="seqfc")
        d = nn.fc([x, y], 4, act=act, name="densefc")
        return [s, d]

    jt, tt, jp, js = _both(build)
    jp = _perturb(jp, rng)
    feed = _seq_feed(rng)
    feed["x"] = rng.randn(4, 7).astype(np.float32)
    feed["y"] = rng.randn(4, 3).astype(np.float32)
    _compare(jt, tt, jp, js, feed, "seqfc", (4, 6, 6), rng)
    _compare(jt, tt, jp, js, feed, "densefc", (4, 4), rng)


@pytest.mark.parametrize("cfg", [
    dict(), dict(reverse=True), dict(use_peepholes=False),
    dict(bias_attr=False), dict(act="sigmoid"), dict(projected=True)])
def test_lstmemory_layer_matches_jax(rng, cfg):
    """Default cell (fused op), reverse, no peepholes, no bias, a
    non-default activation (scan path) and ``projected_input``; nonzero
    peepholes and biases; mixed lengths with a length-1 row."""
    cfg = dict(cfg)
    projected = cfg.pop("projected", False)

    def build(nn):
        w = nn.data("words", size=20, is_seq=True, dtype="int32")
        emb = nn.embedding(w, 12 if projected else 5, name="emb")
        return nn.lstmemory(emb, 3 if projected else 6, name="lstm",
                            projected_input=projected, **cfg)

    jt, tt, jp, js = _both(build)
    jp = _perturb(jp, rng)
    jp["_emb.w0"] = jp["_emb.w0"] * 50.0
    H = 3 if projected else 6
    out = _compare(jt, tt, jp, js, _seq_feed(rng), "lstm", (4, 6, H), rng)
    assert tuple(out.shape) == (4, 6, H)


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "sqrt"])
def test_pooling_layer_matches_jax(rng, ptype):
    def build(nn):
        w = nn.data("words", size=20, is_seq=True, dtype="int32")
        emb = nn.embedding(w, 5, name="emb")
        return nn.pooling(emb, pooling_type=ptype, name="pool")

    jt, tt, jp, js = _both(build)
    _compare(jt, tt, jp, js, _seq_feed(rng), "pool", (4, 5), rng)


def test_pooling_max_gradient_splits_ties_as_jax():
    """A tie at the maximum between two ids whose embedding rows are equal,
    and a row whose padded tail would win without the mask: the gradient is
    split evenly among the tied positions, as JAX's ``max`` splits it (a
    reduction that routes it to one index would give one id all of it)."""
    def build(nn):
        w = nn.data("words", size=6, is_seq=True, dtype="int32")
        emb = nn.embedding(w, 3, name="emb")
        return nn.pooling(emb, pooling_type="max", name="pool")

    jt, tt, jp, js = _both(build)
    table = np.arange(18, dtype=np.float32).reshape(6, 3) - 9.0
    table[5] = table[4]                       # ids 4 and 5 tie everywhere
    jp = {"_emb.w0": jnp.asarray(table)}
    feed = {"words": (np.array([[4, 1, 5, 0], [1, 2, 5, 5]], np.int32),
                      np.array([4, 2], np.int32))}
    _compare(jt, tt, jp, js, feed, "pool", (2, 3), np.random.RandomState(0))
    tp = _port_params(jp)
    outs, _ = tt.apply(tp, {}, feed)
    g, = torch.autograd.grad(outs["pool"].value.sum(), [tp["_emb.w0"]])
    # row 0: ids 4 and 5 share each column's unit of gradient; row 1: id 2
    # is its maximum (the padded id-5 tail is masked)
    assert torch.equal(g[4], torch.full((3,), 0.5))
    assert torch.equal(g[5], torch.full((3,), 0.5))
    assert torch.equal(g[2], torch.ones(3)) and not g[1].any()


@pytest.mark.parametrize("seq", [False, True])
def test_classification_cost_matches_jax(rng, seq):
    def build(nn):
        if seq:
            w = nn.data("words", size=20, is_seq=True, dtype="int32")
            lab = nn.data("label", size=1, is_seq=True, dtype="int32")
            src = nn.embedding(w, 5, name="emb")
        else:
            x = nn.data("x", size=5)
            lab = nn.data("label", size=1, dtype="int32")
            src = x
        logits = nn.fc(src, 7, act="linear", name="logits")
        return nn.classification_cost(logits, lab, name="cost")

    jt, tt, jp, js = _both(build)
    jp = _perturb(jp, rng)
    if seq:
        feed = _seq_feed(rng)
        feed["label"] = (rng.randint(0, 7, (4, 6)).astype(np.int32),
                         feed["words"][1])
    else:
        feed = {"x": rng.randn(4, 5).astype(np.float32),
                "label": rng.randint(0, 7, (4, 1)).astype(np.int32)}
    _compare(jt, tt, jp, js, feed, "cost")


# ---------------------------------------------------------------------------
# the text-classification benchmark net as a whole
# ---------------------------------------------------------------------------

_NET = dict(emb_dim=8, hid_dim=16)
_VOCAB, _B, _T = 50, 5, 9


def _net_feed(seed=0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(_T // 2, _T + 1, _B)
    lengths[0], lengths[1] = _T, 1
    return {"words": (rs.randint(3, _VOCAB, (_B, _T)).astype(np.int32),
                      lengths.astype(np.int32)),
            "label": rs.randint(0, 2, (_B, 1))}


def _net_pair(rng):
    jnn.reset_naming()
    jcost, _ = j_lstm_net(_VOCAB, **_NET)
    tnn.reset_naming()
    tcost, _ = t_lstm_net(_VOCAB, **_NET)
    jtopo = jnn.Topology(jcost)
    ttopo = tnn.Topology(tcost, device="cpu")
    jp, js = jtopo.init(jax.random.PRNGKey(0))
    jp = _perturb(jp, rng)
    # the embedding init (0.01) leaves the LSTMs near their linear regime;
    # scaled up, the gate nonlinearities and the peepholes matter
    jp["_emb.w0"] = jp["_emb.w0"] * 50.0
    return jtopo, ttopo, jp, js, jcost.name


@pytest.mark.parametrize("path", ["scan", "pallas"])
def test_lstm_benchmark_net_loss_and_all_gradients_match_jax(rng,
                                                             monkeypatch,
                                                             path):
    """The loss and all 15 gradients against ``jax.value_and_grad`` over the
    JAX ``Topology.apply`` (the driving loop of ``bench.py``'s
    ``_topology_step``), on the JAX LSTM's scan path and with its Pallas
    kernels forced on (interpret mode)."""
    if path == "pallas":
        monkeypatch.setattr("paddle_tpu.ops.rnn._use_pallas_rnn",
                            lambda B, H: True)
        monkeypatch.setattr("paddle_tpu.ops.rnn_fused._bwd_pallas_ok",
                            lambda B, H: True)
    jtopo, ttopo, jp, js, cost = _net_pair(rng)
    feed = _net_feed()
    assert len(jp) == 15
    before = launch_counts()
    loss = _compare(jtopo, ttopo, jp, js, feed, cost)
    assert launch_counts() == before         # plain versions on the CPU
    assert np.isfinite(float(loss.detach()))


def test_lstm_benchmark_net_inference_matches_jax(rng):
    """``apply(train=False)`` under ``torch.no_grad()`` (the inference
    variant of the LSTM) returns the logits the JAX package computes."""
    jtopo, ttopo, jp, js, _ = _net_pair(rng)
    feed = _net_feed(1)
    jo, _ = jtopo.apply(jp, js, _j_feed(feed), train=False)
    with torch.no_grad():
        to, _ = ttopo.apply(_port_params(jp), {}, feed, train=False)
    np.testing.assert_allclose(to["logits"].value.numpy(),
                               np.asarray(jo["logits"].value), rtol=1e-5,
                               atol=1e-6)
    assert not to["logits"].value.requires_grad


def test_three_adam_steps_match_jax(rng):
    """``bench.py``'s step three times — apply, gradients, ``Adam(1e-3)``
    — on both packages: losses within 1e-5, step counters 3."""
    jtopo, ttopo, jp, js, cost = _net_pair(rng)
    feed = _net_feed(2)
    jfeed = _j_feed(feed)
    jopt, topt = JaxAdam(learning_rate=1e-3), Adam(learning_rate=1e-3)
    jstate = jopt.init_state(jp)
    tp = _port_params(jp)
    tstate = topt.init_state(tp)

    def jloss(p):
        return jtopo.apply(p, js, jfeed, train=True)[0][cost].value

    jl, tl = [], []
    for _ in range(3):
        l, g = jax.value_and_grad(jloss)(jp)
        jp, jstate = jopt.update(jp, g, jstate, fused=False)
        jl.append(float(l))
        outs, _ = ttopo.apply(tp, {}, feed, train=True)
        loss = outs[cost].value
        grads = torch.autograd.grad(loss, list(tp.values()))
        topt.update(tp, dict(zip(tp, grads)), tstate)
        tl.append(float(loss.detach()))
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert tl[-1] < tl[0]
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
