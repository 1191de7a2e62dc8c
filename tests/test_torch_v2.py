"""The port's ``paddle.v2`` facade (``paddle_tpu_torch.v2``), its
``utils/devices.py`` and the wmt14 stream, against the JAX package's.

Every test of ``tests/test_v2_api.py`` and ``tests/test_v2_networks.py``
runs on the port (``test_api_*`` and ``test_networks_*``, each opening with
the reference test it mirrors), on the CPU: the facade's entry points run
on ``FLAGS.device``, which ``paddle.init(["--device=cpu"])`` sets.  Then
the two packages side by side on the same inputs:

* the wmt14 synthetic stream, sample for sample, both splits;
* ``Parameters`` tars crossed both ways; with ``time.time`` pinned both
  packages write the same bytes;
* the v2 seqToseq script (``tests/torch_v2_seqtoseq.py``) built with both
  facades from a JAX ``to_tar``, trained 3 batches of the wmt14 stream with
  Adam: costs at rtol 1e-5 / atol 1e-6 (f32; the reference's f32 RNN
  tolerance, ``tests/test_rnn_fused.py``), the final parameters too, read
  back by the JAX ``from_tar`` of the port's tar;
* ``paddle.infer(field=['prob', 'id'])`` over the generator's
  ``beam_search`` layer: ids bit-identical, scores at rtol 1e-5;
* ``Topology.proto()`` bytes of a v2-built net (but the
  ``framework_version``, which names the package); the empty and the short
  rows of ``infer``; the refusals of parts not ported.
"""

import io
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.v2 as jp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.v2 as paddle
from paddle_tpu.data import datasets as jds
from paddle_tpu_torch.data import datasets as tds
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.utils import devices
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.flags import FLAGS
from torch_v2_seqtoseq import (FEEDING, v2_seqtoseq_generator,
                               v2_seqtoseq_reader, v2_seqtoseq_trainer,
                               v2_test_sources)

RTOL, ATOL = 1e-5, 1e-6
V = 40


@pytest.fixture(autouse=True)
def _cpu_f32(monkeypatch):
    """The facade on the CPU at f32, names fresh; FLAGS restored after."""
    monkeypatch.setattr(FLAGS, "device", FLAGS.device)
    monkeypatch.setattr(FLAGS, "log_period", 0)
    paddle.init(["--device=cpu"])
    tnn.reset_naming()
    jnn.reset_naming()
    with compute_dtype_scope("float32"):
        yield


# ---------------------------------------------------------------------------
# tests/test_v2_api.py on the port
# ---------------------------------------------------------------------------


def test_api_v2_script_end_to_end(rng):
    """test_v2_api.py::test_v2_script_end_to_end."""
    images = paddle.layer.data("pixel", paddle.data_type.dense_vector(64))
    label = paddle.layer.data("label", paddle.data_type.integer_value(10))
    hidden = paddle.layer.fc(images, size=32, act=paddle.activation.Tanh())
    out = paddle.layer.fc(hidden, size=10, act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=out, label=label)

    parameters = paddle.parameters.create(cost)
    w0 = {k: parameters[k].copy() for k in parameters.names()}
    opt = paddle.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9,
        regularization=paddle.optimizer.L2Regularization(rate=1e-4))
    trainer = paddle.trainer.SGD(cost=cost, parameters=parameters,
                                 update_equation=opt)

    def reader():
        r = np.random.RandomState(0)
        for _ in range(64):
            x = r.rand(64).astype("float32")
            yield x, int(x[:10].argmax())

    seen = []

    def handler(event):
        if isinstance(event, paddle.event.EndIteration):
            seen.append(event.cost)
        if isinstance(event, paddle.event.EndPass):
            seen.append(("pass", event.pass_id))

    trainer.train(paddle.batch(reader, 16), num_passes=6,
                  event_handler=handler)
    assert ("pass", 1) in seen
    costs = [c for c in seen if isinstance(c, float)]
    assert costs[-1] < costs[0]
    # the Parameters object the user holds was updated in place
    assert any(np.abs(parameters[k] - w0[k]).max() > 0 for k in w0
               if k in parameters.params)

    probs = paddle.infer(output_layer=out, parameters=parameters,
                         input=[(np.ones(64, np.float32) * 0.1,)],
                         feeding={"pixel": 0})
    assert probs.shape == (1, 10)
    np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-4)


def _small_net(out_name="out", seed=1):
    images = paddle.layer.data("x", paddle.data_type.dense_vector(8))
    out = paddle.layer.fc(images, size=4, act=paddle.activation.Softmax(),
                          name=out_name)
    lbl = paddle.layer.data("label", paddle.data_type.integer_value(4))
    cost = paddle.layer.classification_cost(input=out, label=lbl)
    return paddle.parameters.create(cost, seed=seed)


def test_api_v2_parameters_tar_roundtrip():
    """test_v2_api.py::test_v2_parameters_tar_roundtrip."""
    p1 = _small_net(seed=1)
    buf = io.BytesIO()
    p1.to_tar(buf)
    buf.seek(0)
    tnn.reset_naming()
    p2 = _small_net(seed=2)
    assert np.abs(p2["_out.w0"] - p1["_out.w0"]).max() > 0
    p2.from_tar(buf)
    np.testing.assert_array_equal(p2["_out.w0"], p1["_out.w0"])


def test_api_v2_sequence_and_dataset():
    """test_v2_api.py::test_v2_sequence_and_dataset."""
    words = paddle.layer.data(
        "words", paddle.data_type.integer_value_sequence(100))
    emb = paddle.layer.embedding(words, 16)
    pooled = paddle.layer.pooling(emb, pooling_type=paddle.pooling.Max())
    out = paddle.layer.fc(pooled, size=2, act=paddle.activation.Softmax())
    lbl = paddle.layer.data("label", paddle.data_type.integer_value(2))
    cost = paddle.layer.classification_cost(input=out, label=lbl)
    parameters = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost=cost, parameters=parameters,
                                 update_equation=paddle.optimizer.Adam())
    reader = paddle.batch(
        paddle.dataset.imdb.train(vocab_size=100, n=64), 16)
    trainer.train(reader, num_passes=1)
    res = trainer.test(paddle.batch(paddle.dataset.imdb.test(vocab_size=100,
                                                             n=32), 16))
    assert np.isfinite(list(res.values())).all()


def test_api_v2_parameters_from_tar_unknown_name_raises():
    """test_v2_api.py::test_v2_parameters_from_tar_unknown_name_raises;
    the refused tar leaves the Parameters as they were."""
    p1 = _small_net(seed=1)
    buf = io.BytesIO()
    p1.to_tar(buf)
    buf.seek(0)
    tnn.reset_naming()
    p2 = _small_net("DIFFERENT", seed=2)
    before = {k: p2[k].copy() for k in p2.names()}
    with pytest.raises(ValueError, match="unknown parameter"):
        p2.from_tar(buf)
    for k in before:
        np.testing.assert_array_equal(p2[k], before[k])


def _toy_generator():
    """test_v2_infer_generation_fields' net: -> (beam_search layer, H)."""
    Vt, H, E = 12, 6, 5
    ctx_in = paddle.layer.data(name="ctx",
                               type=paddle.data_type.dense_vector(H))

    def step(prev_tok, ctx, mem):
        e = tnn.embedding(prev_tok, E)
        h = tnn.fc(tnn.concat([e, ctx, mem]), H, act="tanh")
        return [tnn.fc(h, Vt, act="linear"), h]

    return paddle.layer.beam_search(
        step, input=[paddle.layer.GeneratedInput(size=Vt),
                     paddle.layer.StaticInput(ctx_in)],
        memories=[paddle.layer.memory("m", H, boot=ctx_in)], beam_size=3,
        max_length=5), H


def test_api_v2_infer_generation_fields():
    """test_v2_api.py::test_v2_infer_generation_fields."""
    gen, H = _toy_generator()
    params = paddle.parameters.create(gen)
    rows = [(np.random.RandomState(i).randn(H).astype(np.float32),)
            for i in range(2)]
    ids = paddle.infer(output_layer=gen, parameters=params, input=rows,
                       field="id")
    prob, ids2 = paddle.infer(output_layer=gen, parameters=params,
                              input=rows, field=["prob", "id"])
    assert ids.shape == (2, 3, 5) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ids2)
    assert prob.shape == (2, 3)
    assert np.all(np.diff(prob, axis=1) <= 1e-5)  # best-first


def test_api_v2_reader_compose_alignment():
    """test_v2_api.py::test_v2_reader_compose_alignment."""
    r1 = paddle.reader.creator.np_array(np.arange(3))
    r2 = paddle.reader.creator.np_array(np.arange(2))
    with pytest.raises(paddle.reader.ComposeNotAligned):
        list(paddle.reader.compose(r1, r2)())
    assert len(list(paddle.reader.compose(r1, r1)())) == 3
    assert len(list(paddle.reader.compose(r1, r2,
                                          check_alignment=False)())) == 2


def test_api_v2_topology_wrapper():
    """test_v2_api.py::test_v2_topology_wrapper."""
    words = tnn.data("words", size=0, is_seq=True, dtype="int32")
    emb = tnn.embedding(words, 8, vocab_size=20, name="emb")
    out = tnn.fc(tnn.pooling(emb, pooling_type="max"), 2, act="softmax",
                 name="out")
    lbl = tnn.data("label", size=2, dtype="int32")
    cost = tnn.classification_cost(input=out, label=lbl, name="cost")
    topo = paddle.topology.Topology(cost)
    assert topo.get_layer("emb") is not None
    assert topo.get_layer("nope") is None
    assert {n for n, _ in topo.data_type()} == {"words", "label"}
    kinds = dict(topo.data_type())
    assert kinds["words"] == "ids_seq" and kinds["label"] == "int"
    mc = topo.proto()
    assert any(lc.name == "out" for lc in mc.layers)


# ---------------------------------------------------------------------------
# tests/test_v2_networks.py on the port
# ---------------------------------------------------------------------------

net = paddle.networks


def _run(outs_layers, feed, train=False, rng=None):
    topo = tnn.Topology(outs_layers, device="cpu")
    params, state = topo.init(0)
    outs, _ = topo.apply(params, state, feed, train=train, rng=rng)
    return topo, params, state, outs


def test_networks_simple_img_conv_pool_mnist_block(rng):
    """test_v2_networks.py::test_simple_img_conv_pool_mnist_block."""
    img = tnn.data("pixel", size=1, height=12, width=12)
    lab = tnn.data("label", size=1, dtype="int32")
    h = net.simple_img_conv_pool(img, filter_size=3, num_filters=4,
                                 pool_size=2)
    cost = tnn.classification_cost(tnn.fc(h, 3, act="linear"), lab)
    feed = {"pixel": rng.rand(2, 12, 12, 1).astype(np.float32),
            "label": np.zeros((2, 1), np.int64)}
    *_, outs = _run([cost], feed)
    assert np.isfinite(float(outs[cost.name].value))


def test_networks_img_conv_group_vgg_block(rng):
    """test_v2_networks.py::test_img_conv_group_vgg_block."""
    img = tnn.data("pixel", size=3, height=8, width=8)
    h = net.img_conv_group(img, [4, 4], conv_batchnorm=True)
    assert h.meta["hw"] == (7, 7)
    h2 = net.img_conv_group(img, [4], pool_stride=2, name="g2")
    assert h2.meta["hw"] == (4, 4)
    *_, outs = _run([h, h2],
                    {"pixel": rng.rand(2, 8, 8, 3).astype(np.float32)},
                    train=True, rng=1)
    assert tuple(outs[h.name].value.shape) == (2, 7, 7, 4)
    assert tuple(outs[h2.name].value.shape) == (2, 4, 4, 4)


def test_networks_simple_lstm_and_gru_train(rng):
    """test_v2_networks.py::test_simple_lstm_and_gru_train."""
    from paddle_tpu_torch.param.optimizers import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    xs = tnn.data("xs", size=6, is_seq=True)
    lab = tnn.data("label", size=1, dtype="int32")
    h1 = net.simple_lstm(xs, 8)
    h2 = net.simple_gru(xs, 8)
    pooled = tnn.pooling(tnn.concat([h1, h2]), pooling_type="max")
    cost = tnn.classification_cost(tnn.fc(pooled, 2, act="linear"), lab)
    tr = SGDTrainer(cost=cost, optimizer=SGD(learning_rate=0.1), seed=0,
                    device="cpu")
    lens = rng.randint(2, 6, 4).astype(np.int32)
    feed = {"xs": (rng.randn(4, 5, 6).astype(np.float32), lens),
            "label": rng.randint(0, 2, 4)}
    c0 = float(tr.train_batch(feed))
    for _ in range(10):
        c = float(tr.train_batch(feed))
    assert np.isfinite(c) and c < c0


def test_networks_bidirectional_lstm_matches_manual_concat(rng):
    """test_v2_networks.py::test_bidirectional_lstm_matches_manual_concat."""
    xs = tnn.data("xs", size=5, is_seq=True)
    merged = net.bidirectional_lstm(xs, 4, name="bd")
    fw, bw = net.bidirectional_lstm(xs, 4, name="bd2", return_unmerged=True)
    topo = tnn.Topology([merged, fw, bw], device="cpu")
    params, state = topo.init(0)
    for k in list(params):
        if "bd2" in k:
            params[k] = params[k.replace("bd2", "bd")]
    lens = np.asarray([5, 3], np.int32)
    feed = {"xs": (rng.randn(2, 5, 5).astype(np.float32), lens)}
    outs, _ = topo.apply(params, state, feed, train=False)
    man = torch.cat([outs[fw.name].value, outs[bw.name].value], -1)
    np.testing.assert_allclose(outs[merged.name].value.numpy(), man.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_networks_sequence_conv_pool(rng):
    """test_v2_networks.py::test_sequence_conv_pool."""
    xs = tnn.data("xs", size=6, is_seq=True)
    out = net.sequence_conv_pool(xs, context_len=3, hidden_size=7)
    lens = np.asarray([5, 2], np.int32)
    *_, outs = _run([out], {"xs": (rng.randn(2, 5, 6).astype(np.float32),
                                   lens)})
    assert tuple(outs[out.name].value.shape) == (2, 7)


def test_networks_simple_attention_in_recurrent_group(rng):
    """test_v2_networks.py::test_simple_attention_in_recurrent_group."""
    B, S, T, D, H = 2, 4, 3, 6, 5
    enc_seq = tnn.data("enc", size=D, is_seq=True)
    proj = tnn.fc(enc_seq, D, act="linear", name="encproj")
    frames = tnn.data("frames", size=3, is_seq=True)

    def step(frame, enc_static, proj_static, mem):
        ctx = net.simple_attention(enc_static, proj_static, mem)
        h = tnn.fc(tnn.concat([frame, ctx]), H, act="tanh", name="steph")
        return [h, h]

    out = tnn.recurrent_group(
        step,
        input=[frames, tnn.StaticInput(enc_seq), tnn.StaticInput(proj)],
        memories=[tnn.Memory("m", H)])
    feed = {
        "enc": (rng.randn(B, S, D).astype(np.float32),
                np.asarray([4, 2], np.int32)),
        "frames": (rng.randn(B, T, 3).astype(np.float32),
                   np.asarray([3, 2], np.int32)),
    }
    topo, params, state, outs = _run([out], feed)
    v = outs[out.name].value
    assert tuple(v.shape) == (B, T, H)
    assert torch.isfinite(v).all()
    params = {k: p.requires_grad_() for k, p in params.items()}
    o, _ = topo.apply(params, state, feed, train=False)
    names = [k for k in params if "attention" in k]
    grads = torch.autograd.grad((o[out.name].value ** 2).sum(),
                                [params[k] for k in names])
    assert names and all(g.abs().max() > 0 for g in grads)


def test_networks_v2_evaluator_facade(rng):
    """test_v2_networks.py::test_v2_evaluator_facade."""
    from paddle_tpu_torch.param.optimizers import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    x = tnn.data("x", size=6)
    y = tnn.data("y", size=1, dtype="int32")
    logits = tnn.fc(x, 3, act="linear", name="lg")
    cost = tnn.classification_cost(logits, y)
    tr = SGDTrainer(cost=cost, optimizer=SGD(learning_rate=0.1), seed=2,
                    device="cpu")
    ev, wire = paddle.evaluator.classification_error(input=logits, label=y)
    feeds = [{"x": rng.randn(8, 6).astype(np.float32),
              "y": rng.randint(0, 3, (8,))} for _ in range(3)]
    res = tr.test(lambda: iter(feeds), evaluators={ev: wire})
    assert "classification_error" in res
    assert 0.0 <= res["classification_error"] <= 1.0
    ev2, wire2 = paddle.evaluator.sum(input=logits)
    res2 = tr.test(lambda: iter(feeds), evaluators={ev2: wire2})
    assert np.isfinite(res2["sum"])


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("dict_size", [30000, 1000, 40])
def test_wmt14_stream_equals_the_reference(split, dict_size):
    want = list(jds.wmt14(split, dict_size=dict_size, n=96)())
    got = list(tds.wmt14(split, dict_size=dict_size, n=96)())
    assert got == want
    assert list(paddle.dataset.wmt14.test(dict_size=dict_size, n=5)()) == \
        list(jp.dataset.wmt14.test(dict_size=dict_size, n=5)())


def test_module_surface_matches_the_reference():
    """Every name of the reference's v2 modules has its counterpart; the
    layer passthroughs are the recording (config-captured) constructors."""
    import importlib

    for mod in ("activation", "attr", "data_feeder", "data_type", "dataset",
                "evaluator", "event", "inference", "layer", "minibatch",
                "networks", "optimizer", "parameters", "plot", "pooling",
                "reader", "topology", "trainer"):
        ref = importlib.import_module(f"paddle_tpu.v2.{mod}")
        port = importlib.import_module(f"paddle_tpu_torch.v2.{mod}")
        names = getattr(ref, "__all__", None) or [
            n for n in vars(ref) if not n.startswith("_")
            and callable(getattr(ref, n))]
        missing = [n for n in names if not hasattr(port, n)]
        assert not missing, (mod, missing)
    assert set(jp.__all__) == set(paddle.__all__)
    for name in ("fc", "embedding", "grumemory", "classification_cost",
                 "first_seq", "concat", "data_norm", "crf"):
        assert hasattr(getattr(paddle.layer, name), "__wrapped_layer_fn__")
    assert paddle.layer.eos is tnn.eos_trim
    assert paddle.layer.context_projection is tnn.context_projection_input
    assert paddle.layer.square_error_cost is tnn.mse_cost
    assert paddle.layer.memory is tnn.Memory
    assert str(paddle.activation.Exp()) == str(jp.activation.Exp())
    assert str(paddle.pooling.SquareRootN()) == "sqrt"


@pytest.mark.parametrize("name,kw", [
    ("Momentum", dict(momentum=0.5, learning_rate=0.2,
                      regularization="l2", gradient_clipping_threshold=3.0,
                      learning_rate_schedule="poly",
                      learning_rate_decay_a=0.1)),
    ("Adam", dict(learning_rate=2e-3, beta2=0.99, regularization="l1")),
    ("AdaGrad", {}), ("AdaDelta", dict(rho=0.9)), ("RMSProp", {}),
    ("AdaMax", dict(beta1=0.8)),
    ("DecayedAdaGrad", dict(learning_rate_schedule="exp",
                            learning_rate_decay_b=10.0)),
])
def test_optimizer_factories_match_the_reference(name, kw):
    def make(mod):
        k = dict(kw)
        reg = k.pop("regularization", None)
        if reg == "l2":
            k["regularization"] = mod.L2Regularization(rate=1e-3)
        elif reg == "l1":
            k["regularization"] = mod.L1Regularization(rate=1e-4)
        return getattr(mod, name)(**k)

    want, got = make(jp.optimizer), make(paddle.optimizer)
    assert type(got).__name__ == type(want).__name__
    fields = [f for f in vars(want) if not f.startswith("_")]
    assert fields
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


def _tar_members(data: bytes):
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar]


def test_tars_cross_the_packages_both_ways(monkeypatch):
    """A JAX tar loads into the port and the port's into the JAX package,
    every array equal; with time.time pinned the bytes are the same."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    jcost = v2_seqtoseq_trainer(jp, V=V)
    tcost = v2_seqtoseq_trainer(paddle, V=V)
    jparams = jp.parameters.create(jcost, seed=3)
    tparams = paddle.parameters.create(tcost, seed=4)
    assert jparams.names() == tparams.names()
    assert any(np.abs(jparams[k] - tparams[k]).max() > 0
               for k in jparams.names())
    jbuf = io.BytesIO()
    jparams.to_tar(jbuf)
    tparams.from_tar(io.BytesIO(jbuf.getvalue()))
    for k in jparams.names():
        np.testing.assert_array_equal(tparams[k], jparams[k])
        assert tparams[k].dtype == jparams[k].dtype
    tbuf = io.BytesIO()
    tparams.to_tar(tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
    # and back: the port's own init values into the JAX package
    tnn.reset_naming()
    own = paddle.parameters.create(v2_seqtoseq_trainer(paddle, V=V), seed=5)
    obuf = io.BytesIO()
    own.to_tar(obuf)
    jparams.from_tar(io.BytesIO(obuf.getvalue()))
    for k in own.names():
        np.testing.assert_array_equal(jparams[k], own[k])
    names = [n for n, _ in _tar_members(obuf.getvalue())]
    assert names == [f"params/{k}.npy" for k in own.params] + ["meta.json"]


def _costs(facade, cost, params, reader):
    got = []

    def handler(ev):
        if isinstance(ev, facade.event.EndIteration):
            got.append(ev.cost)

    trainer = facade.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=facade.optimizer.Adam(learning_rate=5e-3))
    trainer.train(reader, num_passes=1, event_handler=handler,
                  feeding=FEEDING)
    return trainer, got


def test_v2_seqtoseq_script_trains_as_the_reference():
    """The v2 seqToseq script with both facades from the JAX package's
    initial tar, 3 Adam steps over the same wmt14 batches."""
    jcost = v2_seqtoseq_trainer(jp, V=V)
    tcost = v2_seqtoseq_trainer(paddle, V=V)
    jparams = jp.parameters.create(jcost)
    tparams = paddle.parameters.create(tcost)
    buf = io.BytesIO()
    jparams.to_tar(buf)
    tparams.from_tar(io.BytesIO(buf.getvalue()))
    _, want = _costs(jp, jcost, jparams, v2_seqtoseq_reader(jp, V, 24, 8))
    ttr, got = _costs(paddle, tcost, tparams,
                      v2_seqtoseq_reader(paddle, V, 24, 8))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[-1] != got[0]
    # the final parameters, through the port's tar into the JAX package
    out = io.BytesIO()
    ttr.save_parameter_to_tar(out)
    jnn.reset_naming()
    back = jp.parameters.create(v2_seqtoseq_trainer(jp, V=V), seed=9)
    back.from_tar(io.BytesIO(out.getvalue()))
    for k in jparams.names():
        np.testing.assert_allclose(back[k], jparams[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        np.testing.assert_array_equal(back[k], tparams[k])


def test_v2_generation_matches_the_reference():
    """paddle.infer(field=['prob', 'id']) over the generator's beam_search
    layer, parameters from one tar: ids bit-identical, scores rtol 1e-5."""
    jgen = v2_seqtoseq_generator(jp, V=V, max_len=10)
    tgen = v2_seqtoseq_generator(paddle, V=V, max_len=10)
    jparams = jp.parameters.create(jgen, seed=7)
    tparams = paddle.parameters.create(tgen)
    buf = io.BytesIO()
    jparams.to_tar(buf)
    tparams.from_tar(io.BytesIO(buf.getvalue()))
    rows = v2_test_sources(paddle, V, 6)
    assert rows == v2_test_sources(jp, V, 6)
    want_p, want_id = jp.infer(output_layer=jgen, parameters=jparams,
                               input=rows, field=["prob", "id"])
    got_p, got_id = paddle.infer(output_layer=tgen, parameters=tparams,
                                 input=rows, field=["prob", "id"])
    assert got_id.dtype == want_id.dtype == np.int32
    np.testing.assert_array_equal(got_id, want_id)
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL)
    # a zero-row call: the reference's shapes and dtypes, nothing run on
    # FLAGS.device's tensors
    want = jp.infer(output_layer=jgen, parameters=jparams, input=[],
                    field=["prob", "id"])
    got = paddle.infer(output_layer=tgen, parameters=tparams, input=[],
                       field=["prob", "id"])
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_infer_zero_rows_never_touches_the_card(monkeypatch):
    """input=[] runs the plain versions on the CPU even with FLAGS.device
    set to the card: no CUDA device is asked for."""
    gen, H = _toy_generator()
    params = paddle.parameters.create(gen)
    FLAGS.device = "cuda"
    got = paddle.infer(output_layer=gen, parameters=params, input=[],
                       field=["prob", "id"])
    assert got[0].shape == (0, 3) and got[1].shape == (0, 3, 5)


def test_infer_rejects_short_rows_naming_the_slot():
    x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
    y = paddle.layer.data("y", paddle.data_type.dense_vector(4))
    out = paddle.layer.fc(input=[x, y], size=2, name="out")
    params = paddle.parameters.create(out)
    with pytest.raises(ValueError, match=r"missing \['y'\]"):
        paddle.infer(output_layer=out, parameters=params,
                     input=[(np.zeros(4, np.float32),)])
    with pytest.raises(ValueError, match="not a sequence"):
        paddle.infer(output_layer=out, parameters=params, input=[3])
    with pytest.raises(KeyError, match="unknown field"):
        paddle.infer(output_layer=out, parameters=params,
                     input=[(np.zeros(4, np.float32),) * 2], field="nope")
    with pytest.raises(ConfigError, match="item 9"):
        paddle.infer(output_layer=out, parameters=params, input=[],
                     audit=True)


def test_proto_bytes_equal_the_reference():
    """Topology.proto() of a v2-built net, byte for byte; the recurrent
    group net is refused by both serializers alike."""
    def build(facade):
        words = facade.layer.data(
            "words", facade.data_type.integer_value_sequence(50))
        emb = facade.layer.embedding(input=words, size=8, name="emb")
        h = facade.networks.simple_lstm(input=emb, size=6, name="lstm")
        pooled = facade.layer.pooling(input=h,
                                      pooling_type=facade.pooling.Max())
        out = facade.layer.fc(input=pooled, size=2,
                              act=facade.activation.Softmax(), name="out")
        lbl = facade.layer.data("label", facade.data_type.integer_value(2))
        return facade.layer.classification_cost(input=out, label=lbl,
                                                 name="cost")

    want = jp.topology.Topology(build(jp)).proto()
    got = paddle.topology.Topology(build(paddle)).proto()
    # the one field that names the package that wrote the dump
    assert got.framework_version.startswith("paddle_tpu_torch")
    got.framework_version = want.framework_version
    assert got.SerializeToString() == want.SerializeToString()
    jnn.reset_naming()
    tnn.reset_naming()
    from paddle_tpu.config.config_parser import SerializationError as JErr
    from paddle_tpu_torch.config.config_parser import SerializationError

    with pytest.raises(JErr, match="recurrent_group"):
        jp.topology.Topology(v2_seqtoseq_trainer(jp, V=V)).proto()
    with pytest.raises(SerializationError, match="recurrent_group"):
        paddle.topology.Topology(v2_seqtoseq_trainer(paddle, V=V)).proto()


# ---------------------------------------------------------------------------
# utils/devices.py and plot
# ---------------------------------------------------------------------------


def test_devices_init_and_queries():
    rest = paddle.init(["--device=cpu", "--log_period=7", "pos",
                        "--unknown_thing=1"])
    assert rest == ["pos", "--unknown_thing=1"]
    assert FLAGS.device == "cpu" and FLAGS.log_period == 7
    assert devices.devices() == [torch.device("cpu")]
    assert devices.device_count() == 1
    assert devices.default_backend() == "cpu"
    assert devices.on_tunnel_backend() is False
    for argv, item in ((["--check_nan"], 9), (["--dcn_axis=dcn"], 8)):
        with pytest.raises(ConfigError, match=f"item {item}"):
            paddle.init(argv)
    # the mesh flags and make_mesh are ported (tests/test_torch_parallel.py)
    assert paddle.init(["--mesh_shape=1", "--device=cpu"]) == []
    assert devices.make_mesh().axis_names == ("data",)
    FLAGS.mesh_shape = ""
    for fn, item in ((devices.apply_numeric_traps, 9),
                     (lambda: devices.force_virtual_devices(8), 8)):
        with pytest.raises(ConfigError, match=f"item {item}"):
            fn()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal")
def test_devices_refuse_a_missing_card():
    paddle.init(["--device=cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.default_backend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.parameters.create(_small_net_cost())


def _small_net_cost():
    x = paddle.layer.data("x", paddle.data_type.dense_vector(3))
    return paddle.layer.fc(input=x, size=2)


def test_plot_collects_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setenv("DISABLE_PLOT", "True")
    p = paddle.plot.Ploter("train", "test")
    p.append("train", 0, 1.5)
    p.append("train", 1, 1.0)
    with pytest.raises(ValueError, match="unknown plot title"):
        p.append("nope", 0, 0.0)
    p.plot(str(tmp_path / "x.png"))  # drawing disabled: a no-op
    assert not (tmp_path / "x.png").exists()
    assert p.__plot_data__["train"].value == [1.5, 1.0]
    p.reset()
    assert p.__plot_data__["train"].step == []
