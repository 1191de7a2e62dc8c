"""The port's copies of ``demo/`` (``paddle_tpu_torch/demo``) on the CPU.

* the 19 ``CASES`` of ``tests/test_demos.py``, each demo copy run as
  ``python -m paddle_tpu_torch.demo.<name>.train`` would run it, with the
  reference case's arguments and ``--device cpu``: it prints its
  ``cost``/``loss``/``mse`` lines;
* the model-zoo flow (train, publish the bundle, classify and extract from
  it with no model code) without the AOT exports, which are refused naming
  ROADMAP.md Queue 1 item 10;
* the quick_start builders of the port against the reference demo's, from
  the same parameters (``params_from_jax``) and feed: each config's first
  training step's loss and every gradient at rtol 1e-5 (f32, the shared
  dropout mask; the reference's f32 RNN tolerance,
  ``tests/test_rnn_fused.py``);
* the seqToseq demo's ``make_batches`` against the reference's, and its
  ``main`` result.
"""

import os
import runpy
import sys

import jax
import numpy as np
import pytest

import paddle_tpu.data as jdata
import paddle_tpu.models as jmodels
import paddle_tpu.nn as jnn
import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.models as tmodels
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.utils.error import ConfigError
from test_demos import CASES
from torch_compare import assert_grads_close, loss_and_grads, share_dropout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_demo(module, args, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module] + args)
    runpy.run_module(module, run_name="__main__", alter_sys=False)


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_demo_copy_runs(name, args, monkeypatch, capsys):
    _run_demo(f"paddle_tpu_torch.demo.{name}.train", args + ["--device",
                                                             "cpu"],
              monkeypatch)
    out = capsys.readouterr().out
    assert "cost" in out or "loss" in out or "mse" in out


def test_model_zoo_publish_and_consume(monkeypatch, capsys, tmp_path):
    """tests/test_demos.py::test_model_zoo_publish_and_consume on the
    port's copies, without the AOT exports."""
    bundle = str(tmp_path / "zoo.ptz")
    _run_demo("paddle_tpu_torch.demo.model_zoo.train_and_publish",
              ["--passes", "1", "--n", "64", "--batch-size", "16", "--out",
               bundle, "--device", "cpu"], monkeypatch)
    assert os.path.exists(bundle)
    for job in ("classify", "extract"):
        _run_demo("paddle_tpu_torch.demo.model_zoo.classify",
                  ["--model", bundle, "--job", job, "--device", "cpu"],
                  monkeypatch)
    out = capsys.readouterr().out
    assert "published" in out and "cost" in out
    assert "class " in out and "extracted features" in out


@pytest.mark.parametrize("flag", ["--aot-out", "--aot-hlo-out"])
def test_model_zoo_aot_flags_are_refused(flag, monkeypatch, capsys,
                                         tmp_path):
    bundle = tmp_path / "zoo.ptz"
    with pytest.raises(ConfigError, match="item 10"):
        _run_demo("paddle_tpu_torch.demo.model_zoo.train_and_publish",
                  ["--n", "16", "--out", str(bundle), flag,
                   str(tmp_path / "aot"), "--device", "cpu"], monkeypatch)
    # refused before anything ran
    assert not bundle.exists() and capsys.readouterr().out == ""


def test_demo_copies_cover_every_reference_demo():
    ref = sorted(os.path.relpath(os.path.join(d, f), os.path.join(ROOT,
                                                                  "demo"))
                 for d, _, fs in os.walk(os.path.join(ROOT, "demo"))
                 for f in fs if f.endswith(".py") and f != "_bootstrap.py")
    port_root = os.path.join(ROOT, "paddle_tpu_torch", "demo")
    missing = [p for p in ref if not os.path.exists(os.path.join(port_root,
                                                                 p))]
    assert len(ref) == 15 and not missing, missing


def test_mnist_conf_through_the_command_line(monkeypatch, tmp_path):
    """``python -m paddle_tpu_torch --job=train --config=<the mnist demo
    copy's conf.py>``; the flags the command line sets restored after."""
    from paddle_tpu_torch.__main__ import main as cli
    from paddle_tpu_torch.utils.flags import FLAGS

    monkeypatch.setenv("MNIST_N", "64")
    monkeypatch.setenv("MNIST_BATCH", "16")
    keep = FLAGS.as_dict()
    conf = os.path.join(ROOT, "paddle_tpu_torch", "demo", "mnist", "conf.py")
    try:
        assert cli(["--job=train", f"--config={conf}", "--device=cpu",
                    f"--save_dir={tmp_path}", "--num_passes=1",
                    "--log_period=0"]) == 0
    finally:
        for k, v in keep.items():
            setattr(FLAGS, k, v)
    assert os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# quick_start's builders against the reference demo's
# ---------------------------------------------------------------------------

QS_VOCAB, QS_B = 1000, 4


def _reference_quick_start():
    return runpy.run_path(os.path.join(ROOT, "demo", "quick_start",
                                       "train.py"))


def _qs_build(ns, nn, models, config):
    nn.reset_naming()
    hid = 16
    if config == "lr":
        return ns["bow_net"](QS_VOCAB)[0]
    if config == "lr_sparse":
        return ns["sparse_lr_net"](QS_VOCAB)[0]
    if config == "cnn":
        return models.convolution_net(QS_VOCAB, emb_dim=32, hid_dim=32)[0]
    if config == "bidi-lstm":
        return ns["bidi_lstm_net"](QS_VOCAB, emb_dim=hid, hid_dim=hid)[0]
    if config == "db-lstm":
        return ns["db_lstm_text_net"](QS_VOCAB, emb_dim=hid, hid_dim=hid)[0]
    if config == "resnet-lstm":
        return ns["resnet_lstm_net"](QS_VOCAB, emb_dim=hid, hid_dim=hid)[0]
    return models.stacked_lstm_net(QS_VOCAB, emb_dim=32, hid_dim=32,
                                   stacked_num=3)[0]


@pytest.mark.parametrize("config", ["lr", "lr_sparse", "cnn", "lstm",
                                    "bidi-lstm", "db-lstm", "resnet-lstm"])
def test_quick_start_builders_match_the_reference(config, monkeypatch):
    from paddle_tpu_torch.demo.quick_start import train as tqs

    share_dropout(monkeypatch)
    kind = "sparse_ids" if config == "lr_sparse" else "ids_seq"
    rows = next(iter(jdata.batch(jdata.datasets.imdb(
        "train", vocab_size=QS_VOCAB, n=QS_B), QS_B)()))
    feed = jdata.DataFeeder({"words": kind, "label": "int"},
                            max_len=96)(rows)
    tfeed = tdata.DataFeeder({"words": kind, "label": "int"},
                             max_len=96)(rows)
    for k in feed:
        for a, b in zip(jax.tree_util.tree_leaves(feed[k]),
                        jax.tree_util.tree_leaves(tfeed[k])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jcost = _qs_build(_reference_quick_start(), jnn, jmodels, config)
    tcost = _qs_build(vars(tqs), tnn, tmodels, config)
    assert jcost.name == tcost.name
    jt = jnn.Topology([jcost])
    tt = tnn.Topology([tcost], device="cpu")
    jp, js = jt.init(jax.random.PRNGKey(0))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    assert sorted(jp) == sorted(tt.param_specs.keys() - set(js))
    with compute_dtype_scope("float32"):
        jl, jg, tl, tg = loss_and_grads(jt, tt, jcost.name, jp, js, feed)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert_grads_close(tg, jg, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the seqToseq demo
# ---------------------------------------------------------------------------


def test_seqtoseq_batches_and_main():
    from paddle_tpu_torch.demo.seqToseq import train as tseq

    ref = runpy.run_path(os.path.join(ROOT, "demo", "seqToseq", "train.py"))
    want = ref["make_batches"](100, 40, 8)
    got = tseq.make_batches(100, 40, 8)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    res = tseq.main(["--n", "16", "--batch-size", "8", "--dict-size", "50",
                     "--emb-dim", "8", "--hid-dim", "8", "--generate",
                     "--device", "cpu", "--beam-size", "2"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["tokens"].shape == (4, 2, 20)
    assert np.all(np.diff(res["scores"], axis=1) <= 0)
    assert int(res["params"]["src_emb"].shape[0]) == 50
