"""The port's SGDTrainer against the JAX package's, on the same seeded
inputs (the behaviours of tests/test_trainer.py, on the port).

Each case trains a small ``lstm_benchmark_net`` (vocab 48, embedding 8,
2 LSTM layers of 12, B = 6, T = 10) for two passes of 3 batches through
``SGDTrainer.train`` in both packages, the port starting from the JAX
trainer's initial checkpoint (so both start from the same weights, and the
port reads a JAX-written checkpoint).  The per-batch losses, the event
sequence, the end-of-pass test costs and the final checkpoint's every
array (parameters, slots, step) are held against the reference.

Tolerance: the reference's f32 RNN tolerance is rtol 1e-5 / atol 1e-6
(tests/test_rnn_fused.py).  Losses and test costs hold to it (largest
relative difference measured on the CPU: 1.7e-7).  Each final array is
held by its largest difference against its largest entry: 1e-5 for SGD
and Momentum (measured 8.1e-7), 2e-4 for Adam (measured 8.8e-5, in
``_emb.w0``): six steps carry the f32 gradient difference of the two
packages' LSTM backward (summed in another order) into the parameters, and
Adam divides each update by sqrt(v), which magnifies it in embedding rows
whose gradient is near zero.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu.data as jdata
import paddle_tpu.nn as jnn
from paddle_tpu.models.text import lstm_benchmark_net as jax_net
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.trainer import events as jev
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import lstm_benchmark_net as torch_net
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.error import ConfigError

V, E, H, B, T = 48, 8, 12, 6, 10
RTOL_LOSS, ATOL_LOSS = 1e-5, 1e-6
#: max |diff| / max |reference entry| of each final array, by case
TOL_STATE = {"sgd_poly": 1e-5, "momentum_clip_l2": 1e-5, "adam_attrs": 2e-4}

CASES = {
    # plain SGD on the reference's default 'poly' schedule
    "sgd_poly": (lambda m: m.SGD(
        learning_rate=0.5, learning_rate_schedule="poly",
        schedule_args={"decay_a": 0.1, "decay_b": 0.75}), False),
    # Nesterov momentum, global-norm clipping, L2
    "momentum_clip_l2": (lambda m: m.Momentum(
        learning_rate=0.1, momentum=0.9, use_nesterov=True,
        gradient_clipping_threshold=0.05, l2_rate=1e-3), False),
    # Adam with a schedule, clipping, L2 and the per-parameter attributes
    # (learning_rate, l2_decay, is_static, pruning_ratio)
    "adam_attrs": (lambda m: m.Adam(
        learning_rate=2e-2, learning_rate_schedule="warmup_cosine",
        schedule_args={"warmup_steps": 2, "total_steps": 8},
        gradient_clipping_threshold=1.0, l2_rate=1e-4), True),
}


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
    with compute_dtype_scope("float32"):
        yield


def build(nn, attrs: bool):
    """``lstm_benchmark_net`` at small width; with ``attrs``, the same net
    written out with per-parameter attributes."""
    nn.reset_naming()
    if not attrs:
        net = jax_net if nn is jnn else torch_net
        return net(V, emb_dim=E, hid_dim=H, num_layers=2)[0]
    words = nn.data("words", size=V, is_seq=True, dtype="int32")
    label = nn.data("label", size=1, dtype="int32")
    h = nn.embedding(words, E, name="emb", param_attr=nn.ParamAttr(
        initial_std=0.01, init="normal", learning_rate=0.5))
    h = nn.lstmemory(h, H, name="lstm0",
                     param_attr=nn.ParamAttr(l2_decay=1e-2))
    h = nn.lstmemory(h, H, name="lstm1",
                     param_attr=nn.ParamAttr(is_static=True))
    pool = nn.pooling(h, pooling_type="max", name="pool")
    logits = nn.fc(pool, 2, act="linear", name="logits",
                   param_attr=nn.ParamAttr(pruning_ratio=0.5))
    return nn.classification_cost(logits, label, name="cost")


def readers(data):
    feeder = data.DataFeeder({"words": "ids_seq", "label": "int"},
                             buckets=(T,), max_len=T)
    train = data.batch(data.datasets.imdb("train", vocab_size=V, n=3 * B), B)
    test = data.batch(data.datasets.imdb("test", vocab_size=V, n=2 * B), B)
    return train, test, feeder


def recorder(events, ev):
    def handler(e):
        if isinstance(e, ev.BeginPass):
            events.append(("BeginPass", e.pass_id))
        elif isinstance(e, ev.BeginIteration):
            events.append(("BeginIteration", e.pass_id, e.batch_id))
        elif isinstance(e, ev.EndIteration):
            events.append(("EndIteration", e.pass_id, e.batch_id, e.cost))
        elif isinstance(e, ev.EndPass):
            events.append(("EndPass", e.pass_id, dict(e.evaluator)))
    return handler


def jax_trainer(case):
    make, attrs = CASES[case]
    return JaxTrainer(build(jnn, attrs), make(jopt), seed=5)


def torch_trainer(case, init_dir):
    make, attrs = CASES[case]
    tr = SGDTrainer(build(tnn, attrs), make(topt), seed=5, device="cpu")
    tr.load(init_dir, 0)
    return tr


def run(tr, data, ev, num_passes=2):
    train, test, feeder = readers(data)
    events = []
    tr.train(train, num_passes=num_passes, feeder=feeder, test_reader=test,
             event_handler=recorder(events, ev))
    return events


def assert_events_match(got, want):
    assert [e[:3] if e[0] != "EndPass" else e[:2] for e in got] == \
        [e[:3] if e[0] != "EndPass" else e[:2] for e in want]
    for g, w in zip(got, want):
        if g[0] == "EndIteration":
            np.testing.assert_allclose(g[3], w[3], rtol=RTOL_LOSS,
                                       atol=ATOL_LOSS, err_msg=str(g[:3]))
        elif g[0] == "EndPass":
            assert set(g[2]) == set(w[2])
            for k in w[2]:
                np.testing.assert_allclose(g[2][k], w[2][k], rtol=RTOL_LOSS,
                                           atol=ATOL_LOSS)


def assert_checkpoints_match(d_got, d_want, pass_id, tol):
    """Every array of both packages' checkpoints: the same keys (the
    reference's keystr strings), dtypes and shapes, values within ``tol``
    of the array's largest entry."""
    for fname in ("params.npz", "opt_state.npz", "state.npz"):
        got = np.load(os.path.join(d_got, f"pass-{pass_id:05d}", fname))
        want = np.load(os.path.join(d_want, f"pass-{pass_id:05d}", fname))
        assert sorted(got.files) == sorted(want.files), fname
        for k in want.files:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, (fname, k)
            diff = np.abs(got[k].astype(np.float64) - want[k]).max()
            assert diff <= tol * max(np.abs(want[k]).max(), 1e-6), \
                (fname, k, diff)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_reference(case, tmp_path):
    """Per-batch losses, events, test costs and the final parameters and
    slots of two passes, against the JAX trainer."""
    init, jdir, tdir = (str(tmp_path / n) for n in ("init", "jax", "torch"))
    jtr = jax_trainer(case)
    jtr.save(init, 0)
    jevents = run(jtr, jdata, jev)
    jtr.save(jdir, 9)
    ttr = torch_trainer(case, init)
    tevents = run(ttr, tdata, tev)
    ttr.save(tdir, 9)
    assert_events_match(tevents, jevents)
    assert int(ttr.opt_state["step"]) == int(jtr.opt_state["step"]) == 6
    assert_checkpoints_match(tdir, jdir, 9, TOL_STATE[case])
    if CASES[case][1]:
        # the static layer did not move, the pruned half stayed zero
        init_p = np.load(os.path.join(init, "pass-00000", "params.npz"))
        for k in ("['_lstm1.w0']", "['_lstm1.wx']"):
            np.testing.assert_array_equal(
                ttr.params[k[2:-2]].detach().numpy(), init_p[k])
        w = ttr.params["_logits.w0"].detach().numpy()
        assert (w == 0).sum() == w.size // 2
        assert np.array_equal(w == 0, init_p["['_logits.w0']"] == 0)


def test_events_of_a_pass(tmp_path):
    """The reference's event order: BeginPass, (BeginIteration,
    EndIteration) per batch, EndPass carrying the test result."""
    jtr = jax_trainer("sgd_poly")
    jtr.save(str(tmp_path), 0)
    ttr = torch_trainer("sgd_poly", str(tmp_path))
    events = run(ttr, tdata, tev, num_passes=1)
    assert [e[0] for e in events] == (
        ["BeginPass"] + ["BeginIteration", "EndIteration"] * 3 + ["EndPass"])
    assert set(events[-1][2]) == {"cost"}


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_resumes_across_packages(direction, tmp_path,
                                            monkeypatch):
    """A checkpoint written by one package after pass 0 is resumed by the
    other (``resume="auto"``), which continues to the writer's pass-1
    losses."""
    init = str(tmp_path / "init")
    save = str(tmp_path / "ckpt")
    jtr = jax_trainer("adam_attrs")
    jtr.save(init, 0)
    writer_is_jax = direction == "jax_to_torch"
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "save_dir", save)
        monkeypatch.setattr(flags, "resume", "auto")
        monkeypatch.setattr(flags, "checkpoint_on_preemption", False)
    written = (run(jtr, jdata, jev) if writer_is_jax
               else run(torch_trainer("adam_attrs", init), tdata, tev))
    shutil.rmtree(os.path.join(save, "pass-00001"))
    if writer_is_jax:
        resumer = torch_trainer("adam_attrs", init)
        resumed = run(resumer, tdata, tev)
    else:
        resumer = jax_trainer("adam_attrs")
        resumed = run(resumer, jdata, jev)
    assert [e for e in resumed if e[0] == "BeginPass"] == [("BeginPass", 1)]
    assert_events_match(resumed, [e for e in written if e[1] == 1])
    assert int(np.asarray(resumer.opt_state["step"])) == 6


def test_seed_gives_topology_init_values():
    """``SGDTrainer(seed=s)`` starts from ``Topology.init(s)`` (the card
    check holds the trainer against the direct loop on that)."""
    cost = build(tnn, False)
    tr = SGDTrainer(cost, topt.Adam(learning_rate=1e-3), seed=11,
                    device="cpu")
    params, _ = tnn.Topology(cost, device="cpu").init(11)
    assert list(tr.params) == list(params)
    for k, v in params.items():
        assert torch.equal(tr.params[k].detach(), v)
        assert tr.params[k].requires_grad and tr.params[k].is_leaf


def test_train_batch_equals_the_direct_loop():
    """With a constant schedule and finite steps, the guarded trainer step
    gives the direct loop's (apply -> autograd.grad -> Adam.update) losses
    and parameters bit for bit: the guard only selects."""
    cost = build(tnn, False)
    tr = SGDTrainer(cost, topt.Adam(learning_rate=1e-2), seed=2,
                    device="cpu")
    topo = tnn.Topology(cost, device="cpu")
    params, state = topo.init(2)
    params = {k: v.requires_grad_() for k, v in params.items()}
    opt = topt.Adam(learning_rate=1e-2)
    ost = opt.init_state(params)
    _, _, feeder = readers(tdata)
    batches = list(readers(tdata)[0]())
    for rows in batches:
        feed = feeder(rows)
        outs, _ = topo.apply(params, state, feed, train=True)
        loss = outs[cost.name].value
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), ost)
        got = tr.train_batch(feed)
        assert got.item() == loss.item()
    for k in params:
        assert torch.equal(tr.params[k].detach(), params[k].detach()), k
    assert int(tr.opt_state["step"]) == int(ost["step"]) == len(batches)


def test_test_and_infer_match_reference(tmp_path):
    """``test`` (with an evaluator wired, accumulated on the device) and
    ``infer`` from the same checkpoint in both packages."""
    import paddle_tpu.evaluators as JE

    import paddle_tpu_torch.evaluators as TE

    jtr = jax_trainer("sgd_poly")
    jtr.save(str(tmp_path), 0)
    ttr = torch_trainer("sgd_poly", str(tmp_path))
    _, test, feeder = readers(jdata)
    jres = jtr.test(test, feeder=feeder, evaluators={
        JE.ClassificationError(): lambda o, f: {
            "logits": o["logits"], "labels": f["label"]}})
    _, ttest, tfeeder = readers(tdata)
    tres = ttr.test(ttest, feeder=tfeeder, evaluators={
        TE.ClassificationError(): lambda o, f: {
            "logits": o["logits"], "labels": f["label"]}})
    assert set(tres) == set(jres) == {"cost", "classification_error"}
    np.testing.assert_allclose(tres["cost"], jres["cost"], rtol=RTOL_LOSS)
    assert tres["classification_error"] == jres["classification_error"]
    feed = tfeeder(next(iter(ttest())))
    logits_layer = [l for l in ttr.topology.layers if l.name == "logits"]
    jlogits = [l for l in jtr.topology.layers if l.name == "logits"]
    got = ttr.infer(logits_layer, feed)["logits"]
    want = np.asarray(jtr.infer(jlogits, feed)["logits"])
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=ATOL_LOSS)


def test_empty_test_reader_gives_nan_keys():
    tr = SGDTrainer(build(tnn, False), seed=0, device="cpu")
    res = tr.test(lambda: iter(()))
    assert set(res) == {"cost"} and np.isnan(res["cost"])


def test_duplicate_evaluators_get_distinct_keys():
    import paddle_tpu_torch.evaluators as TE

    tr = SGDTrainer(build(tnn, False), seed=0, device="cpu")
    _, test, feeder = readers(tdata)

    def wire(o, f):
        return {"logits": o["logits"], "labels": f["label"]}

    res = tr.test(test, feeder=feeder, evaluators={
        TE.ClassificationError(): wire, TE.ClassificationError(): wire})
    assert set(res) == {"cost", "classification_error",
                        "classification_error:2"}


def test_multi_cost_weights_and_extra_outputs():
    """Two costs train jointly with weights; ``test`` reports the weighted
    joint cost and each cost; ``extra_outputs`` land in the step's
    extras."""
    tnn.reset_naming()
    x = tnn.data("x", size=4)
    lab = tnn.data("label", size=1, dtype="int32")
    h = tnn.fc(x, 5, act="tanh", name="h")
    c1 = tnn.classification_cost(tnn.fc(h, 3, act="linear", name="a"), lab,
                                 name="c1")
    c2 = tnn.classification_cost(tnn.fc(h, 3, act="linear", name="b"), lab,
                                 name="c2")
    tr = SGDTrainer([c1, c2], topt.SGD(learning_rate=0.1),
                    cost_weights=[1.0, 0.5], extra_outputs=[h], seed=0,
                    device="cpu")
    rs = np.random.RandomState(0)
    feed = {"x": rs.randn(8, 4).astype(np.float32),
            "label": rs.randint(0, 3, (8, 1))}
    loss = float(tr.train_batch(feed))
    assert tr._last_extras["h"].shape == (8, 5)
    res = tr.test(lambda: iter([feed]))
    assert set(res) == {"cost", "cost:c1", "cost:c2"}
    np.testing.assert_allclose(res["cost"],
                               res["cost:c1"] + 0.5 * res["cost:c2"],
                               rtol=1e-6)
    assert np.isfinite(loss)
    with pytest.raises(ValueError, match="cost_weights"):
        SGDTrainer([c1, c2], cost_weights=[1.0], device="cpu")


def test_averager_feeds_test():
    """With a ParameterAverager the test pass reads the averaged
    parameters, which trail the trained ones."""
    cost = build(tnn, False)
    tr = SGDTrainer(cost, topt.SGD(learning_rate=0.5), seed=0, device="cpu",
                    averager=topt.ParameterAverager(average_window=0.5))
    train, test, feeder = readers(tdata)
    tr.train(train, feeder=feeder)
    k = "_logits.w0"
    assert not torch.equal(tr.avg_params[k], tr.params[k].detach())
    plain = SGDTrainer(cost, topt.SGD(learning_rate=0.5), seed=0,
                       device="cpu")
    plain.train(train, feeder=feeder)
    assert torch.equal(plain.params[k], tr.params[k])
    assert tr.test(test, feeder=feeder)["cost"] != \
        plain.test(test, feeder=feeder)["cost"]


def test_show_parameter_stats_and_test_period(monkeypatch, caplog):
    """``--show_parameter_stats_period`` logs each parameter's stats and
    ``--test_period`` evaluates mid-pass."""
    import logging

    from paddle_tpu_torch.utils.log import logger

    monkeypatch.setattr(FLAGS, "show_parameter_stats_period", 2)
    monkeypatch.setattr(FLAGS, "test_period", 2)
    monkeypatch.setattr(logger, "propagate", True)
    tr = SGDTrainer(build(tnn, False), seed=0, device="cpu")
    train, test, feeder = readers(tdata)
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch"):
        tr.train(train, feeder=feeder, test_reader=test)
    text = caplog.text
    assert text.count("param _emb.w0") == 1
    assert "Pass 0, Batch 2, Test cost" in text


def test_unported_settings_raise_with_their_item():
    cost = build(tnn, False)
    for kw, item in (({"mesh": object()}, 8), ({"data_axis": "dp"}, 8),
                     ({"sharding_rules": object()}, 8),
                     ({"pipeline": {}}, 8), ({"device_specs": {}}, 8),
                     ({"amp": True}, 4), ({"remat": True}, 4)):
        with pytest.raises(ConfigError, match=f"Queue 1 item {item}"):
            SGDTrainer(cost, device="cpu", **kw)
    tr = SGDTrainer(cost, device="cpu", amp=False, remat=False)
    with pytest.raises(ConfigError, match="item 9"):
        tr.audit({})
    with pytest.raises(ConfigError, match="item 7"):
        tr.publish("a", "b")
    tnn.reset_naming()
    x = tnn.data("x", size=3)
    lab = tnn.data("label", size=1, dtype="int32")
    out = tnn.fc(x, 2, act="linear",
                 param_attr=tnn.ParamAttr(sparse_grad=True))
    cost = tnn.classification_cost(out, lab)
    # a sparse_grad table trains on one device (the masked row update);
    # the pserver tier's sharded tables come with a mesh (item 8)
    assert SGDTrainer(cost, device="cpu").sparse_rows == {
        f"_{out.name}.w0": True}
    with pytest.raises(ConfigError, match="item 8"):
        SGDTrainer(cost, device="cpu", mesh=object())


def test_trainer_defaults_to_cuda_and_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGDTrainer(build(tnn, False))
