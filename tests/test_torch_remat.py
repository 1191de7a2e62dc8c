"""``--remat`` in the port (``SGDTrainer(remat=True)``,
``trainer/trainer.py``): the loss is computed inside
``torch.utils.checkpoint(use_reentrant=False)`` and the backward recomputes
the forward.  The recompute runs the same operations on the same values,
so a remat step equals the plain step bit for bit on the CPU: losses,
parameters, optimizer slots and layer state.  The nets cover the kernel
path (``lstm_benchmark_net``: K9r/K10's plain versions), a dropout layer
(the recompute must replay the same draws: they come from generators
seeded inside the recomputed function), a batch norm (the running stats
come from the first forward only), ``--amp`` with remat, the command
line's ``--remat``, and the JAX package's remat trainer (rtol 1e-5 /
atol 1e-6, the reference's f32 RNN tolerance).
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import lstm_benchmark_net
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.param.optimizers import slot_leaves
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.flags import FLAGS

V, E, H, B, T = 48, 8, 12, 6, 10


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    monkeypatch.setattr(FLAGS, "log_period", 0)
    monkeypatch.setattr(FLAGS, "save_dir", "")
    yield


def _mse_trainer(remat, *, dropout=0.0, batch_norm=False, seed=0):
    tnn.reset_naming()
    x = tnn.data("x", size=4)
    y = tnn.data("y", size=2)
    h = tnn.fc(x, 16, act="relu", name="h")
    if batch_norm:
        h = tnn.batch_norm(h, act="relu", name="bn")
    if dropout:
        h = tnn.dropout(h, dropout, name="drop")
    cost = tnn.mse_cost(input=tnn.fc(h, 2, act="linear", name="o"), label=y)
    return SGDTrainer(cost, topt.Adam(learning_rate=0.05), seed=seed,
                      device="cpu", remat=remat)


def _feeds(n=4, batch=8):
    rs = np.random.RandomState(0)
    return [{"x": rs.randn(batch, 4).astype(np.float32),
             "y": rs.randn(batch, 2).astype(np.float32)} for _ in range(n)]


def _lstm_trainer(remat, seed=5):
    tnn.reset_naming()
    cost, _ = lstm_benchmark_net(V, emb_dim=E, hid_dim=H, num_layers=2)
    return SGDTrainer(cost, topt.Adam(learning_rate=2e-2), seed=seed,
                      device="cpu", remat=remat)


def _lstm_feeds(n):
    rs = np.random.RandomState(1)
    return [{"words": (rs.randint(3, V, (B, T)).astype(np.int32),
                       rs.randint(1, T + 1, B).astype(np.int32)),
             "label": rs.randint(0, 2, (B, 1)).astype(np.int32)}
            for _ in range(n)]


def _assert_same_run(tr_a, tr_b, losses_a, losses_b):
    assert losses_a == losses_b
    for k in tr_a.params:
        assert torch.equal(tr_a.params[k], tr_b.params[k]), k
        for s_a, s_b in zip(slot_leaves(tr_a.opt_state["slots"][k]),
                            slot_leaves(tr_b.opt_state["slots"][k])):
            assert torch.equal(s_a, s_b), k
    assert torch.equal(tr_a.opt_state["step"], tr_b.opt_state["step"])
    assert sorted(tr_a.state) == sorted(tr_b.state)
    for k in tr_a.state:
        assert torch.equal(tr_a.state[k], tr_b.state[k]), k


def _run(tr, feeds):
    return [float(tr.train_batch(f)) for f in feeds]


def test_remat_flag_and_constructor():
    assert not _mse_trainer(None).remat
    assert _mse_trainer(True).remat
    old = FLAGS.remat
    FLAGS.remat = True
    try:
        assert _mse_trainer(None).remat
        assert not _mse_trainer(False).remat
    finally:
        FLAGS.remat = old


def test_remat_matches_plain_training():
    """Counterpart of tests/test_amp.py::test_remat_matches_plain_training:
    three steps, bit for bit (the reference holds rtol 1e-6)."""
    feeds = _feeds(3)
    tr_a, tr_b = _mse_trainer(False), _mse_trainer(True)
    _assert_same_run(tr_a, tr_b, _run(tr_a, feeds), _run(tr_b, feeds))


def test_remat_replays_the_dropout_draws():
    """A dropout layer at rate 0.5: the recompute in the backward draws
    the same mask as the forward, so the remat step equals the plain step
    bit for bit.  The masks are live: another seed gives other losses."""
    feeds = _feeds(4)
    tr_a = _mse_trainer(False, dropout=0.5)
    tr_b = _mse_trainer(True, dropout=0.5)
    la, lb = _run(tr_a, feeds), _run(tr_b, feeds)
    _assert_same_run(tr_a, tr_b, la, lb)
    assert _run(_mse_trainer(True, dropout=0.5, seed=1), feeds) != la
    assert _run(_mse_trainer(False), feeds) != la


def test_remat_takes_layer_state_from_the_first_forward():
    """A batch norm's running statistics move once a step under remat, as
    without it: the recompute's state is dropped."""
    feeds = _feeds(3)
    tr_a = _mse_trainer(False, batch_norm=True)
    tr_b = _mse_trainer(True, batch_norm=True)
    before = {k: v.clone() for k, v in tr_b.state.items()}
    la, lb = _run(tr_a, feeds), _run(tr_b, feeds)
    _assert_same_run(tr_a, tr_b, la, lb)
    assert any(not torch.equal(before[k], tr_b.state[k]) for k in before)


@pytest.mark.parametrize("policy", ["float32", "bfloat16", "amp"])
def test_remat_lstm_benchmark_net_bit_for_bit(monkeypatch, policy):
    """``lstm_benchmark_net`` (K9r and K10's plain versions on the CPU)
    under each policy: three steps with remat equal the plain steps bit
    for bit, the loss-scale state too under --amp."""
    if policy == "amp":
        monkeypatch.setattr(FLAGS, "amp", True)
    else:
        monkeypatch.setattr(FLAGS, "compute_dtype", policy)
    feeds = _lstm_feeds(3)
    tr_a, tr_b = _lstm_trainer(False), _lstm_trainer(True)
    _assert_same_run(tr_a, tr_b, _run(tr_a, feeds), _run(tr_b, feeds))
    if policy == "amp":
        for k in ("scale", "good_steps"):
            assert torch.equal(tr_a.opt_state["amp"][k],
                               tr_b.opt_state["amp"][k])


def test_remat_recomputes_the_lstm_forward(monkeypatch):
    """The backward reruns the forward: each LSTM layer's forward (K9r on
    the card) runs twice a step under remat, once without it."""
    import paddle_tpu_torch.ops.rnn_fused as rf

    calls = []
    real = rf.lstm_forward

    def counting(*a, **kw):
        calls.append(kw.get("residuals", False))
        return real(*a, **kw)

    monkeypatch.setattr(rf, "lstm_forward", counting)
    feed = _lstm_feeds(1)[0]
    with compute_dtype_scope("float32"):
        _lstm_trainer(False).train_batch(feed)
        assert calls == [True, True]
        calls.clear()
        _lstm_trainer(True).train_batch(feed)
    assert calls == [True] * 4


def test_remat_matches_jax_remat_trainer(tmp_path, monkeypatch):
    """Three steps of ``lstm_benchmark_net`` with remat in both packages
    from the JAX trainer's initial checkpoint (f32): the losses within the
    reference's f32 tolerance."""
    import paddle_tpu.nn as jnn
    from paddle_tpu.models.text import lstm_benchmark_net as j_net
    from paddle_tpu.param import optimizers as jopt
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer
    from paddle_tpu.utils.flags import FLAGS as JFLAGS

    monkeypatch.setattr(JFLAGS, "compute_dtype", "float32")
    monkeypatch.setattr(FLAGS, "compute_dtype", "float32")
    jnn.reset_naming()
    jtr = JaxTrainer(j_net(V, emb_dim=E, hid_dim=H, num_layers=2)[0],
                     jopt.Adam(learning_rate=2e-2), seed=5, remat=True)
    jtr.save(str(tmp_path), 0)
    ttr = _lstm_trainer(True)
    ttr.load(str(tmp_path), 0)
    for f in _lstm_feeds(3):
        np.testing.assert_allclose(float(ttr.train_batch(f)),
                                   float(jtr.train_batch(f)), rtol=1e-5,
                                   atol=1e-6)


def test_cli_remat_equals_plain(tmp_path, monkeypatch):
    """``--remat`` through the command line: the checkpoint after two
    passes equals the plain run's array for array, bit for bit."""
    from paddle_tpu_torch.__main__ import main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = os.path.join(root, "tests", "torch_textclf_conf.py")
    for k, v in {"VOCAB": 48, "EMB": 8, "HID": 12, "BATCH": 6, "T": 10,
                 "N": 18, "TEST_N": 12}.items():
        monkeypatch.setenv(f"TORCH_TEXTCLF_{k}", str(v))
    keep = FLAGS.as_dict()
    try:
        for arm in ("plain", "remat"):
            extra = ["--remat"] if arm == "remat" else []
            assert main([f"--config={conf}", "--device=cpu", "--job=train",
                         "--num_passes=2", f"--save_dir={tmp_path / arm}",
                         *extra]) == 0
            for k, v in keep.items():
                setattr(FLAGS, k, v)
    finally:
        for k, v in keep.items():
            setattr(FLAGS, k, v)
    for fname in ("params.npz", "opt_state.npz"):
        a = np.load(tmp_path / "plain" / "pass-00001" / fname)
        b = np.load(tmp_path / "remat" / "pass-00001" / fname)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
