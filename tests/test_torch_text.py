"""The port's text nets and v2 helpers against the JAX package's, on the
CPU: ``stacked_lstm_net`` and ``convolution_net`` (narrow widths), the
semantic-role-labeling nets of ``demo/semantic_role_labeling/train.py``
(``tests/torch_text_nets.py``: ``db_lstm_net`` with ``crf_cost`` and
``crf_decoding(share_with=)``, and ``srl_net``), the LSTM and
sequence-conv helpers of ``v2.networks`` with the reference's own
equalities (``tests/test_network_units.py``, ``tests/test_v2_networks.py``),
``error_clip``'s backward, the synthetic ``conll05`` streams and the
not-ported ``stacked_lstm_pp_net``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_text.py -q

Each net: the loss of one training apply and every gradient (parameters
and float inputs) from the same parameters (all-zero ones set to seeded
normals) against ``jax.value_and_grad`` (``tests/torch_compare.py``), the
Viterbi tags of one inference apply equal, and 3 ``Adam`` steps through
each package's ``SGDTrainer`` from the JAX trainer's initial checkpoint
with the losses equal.  Feeds: the synthetic ``sentiment`` and
``conll05_features`` streams through the port's ``DataFeeder``.

Tolerance: rtol 1e-5 / atol 1e-6 (``tests/test_rnn_fused.py``'s) on
losses; gradients by their largest difference against their largest
entry, 1e-5 (1e-6 absolute where one vanishes).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.data as jdata
import paddle_tpu.models as jmodels
import paddle_tpu.nn as jnn
import paddle_tpu.v2.networks as jnet
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.models as tmodels
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.v2.networks as tnet
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.flags import FLAGS

import torch_text_nets as N
from torch_compare import assert_grads_close, loss_and_grads, nonzero_params

RTOL, ATOL = 1e-5, 1e-6
V, B = 40, 4


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
    with compute_dtype_scope("float32"):
        yield


def _sentiment_feed(seed=0, n=B):
    feeder = tdata.DataFeeder({"words": "ids_seq", "label": "int"},
                              max_len=24)
    rows = list(tdata.datasets.sentiment("train", vocab_size=V,
                                         n=n * (seed + 1))())[-n:]
    return feeder(rows)


def _srl_feed(seed=0, n=B, labels=7):
    feeder = tdata.DataFeeder({k: "ids_seq" for k in N.SRL_SLOTS},
                              max_len=48)
    rows = list(tdata.datasets.conll05_features(
        "train", vocab_size=V, n_labels=labels, n=n * (seed + 1))())[-n:]
    return feeder(rows)


def _srl_gru_feed(seed=0, n=B, labels=7):
    feeder = tdata.DataFeeder({"words": "ids_seq", "predicate": "int",
                               "labels": "ids_seq"}, max_len=48)
    rows = list(tdata.datasets.conll05("train", vocab_size=V,
                                       n_labels=labels,
                                       n=n * (seed + 1))())[-n:]
    return feeder(rows)


#: name -> (builder over (nn, models) -> (cost, extra output), feed maker)
NETS = {
    "stacked_lstm_net": (
        lambda nn, m: m.stacked_lstm_net(V, emb_dim=8, hid_dim=12,
                                         stacked_num=3), _sentiment_feed),
    "convolution_net": (
        lambda nn, m: m.convolution_net(V, emb_dim=8, hid_dim=12),
        _sentiment_feed),
    "db_lstm": (
        lambda nn, m: N.db_lstm_net(nn, V, 7, word_dim=6, mark_dim=3,
                                    hidden_dim=16, depth=4), _srl_feed),
    "srl_gru": (lambda nn, m: N.srl_net(nn, V, 7, 6, 5), _srl_gru_feed),
}


def both(name):
    build, feed = NETS[name]
    jnn.reset_naming()
    jc, jx = build(jnn, jmodels)
    tnn.reset_naming()
    tc, tx = build(tnn, tmodels)
    return (jc, jx), (tc, tx), feed


@pytest.mark.parametrize("name", sorted(NETS))
def test_text_net_loss_gradients_and_decode_match_reference(name):
    (jc, jx), (tc, tx), feed_fn = both(name)
    jt = jnn.Topology([jc, jx])
    tt = tnn.Topology([tc, tx], device="cpu")
    assert [l.name for l in tt.layers] == [l.name for l in jt.layers]
    assert {k: s.shape for k, s in tt.param_specs.items()} \
        == {k: s.shape for k, s in jt.param_specs.items()}
    jp, js = jt.init(jax.random.PRNGKey(1))
    jp = nonzero_params(jp)
    feed = feed_fn()
    jv, jg, tv, tg = loss_and_grads(jt, tt, jc.name, jp, js, feed)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)
    want = np.asarray(jt.apply(jp, js, feed)[0][jx.name].value)
    with torch.no_grad():
        got = tt.apply(tnn.params_from_jax(jp, "cpu"), {}, feed)[0][
            tx.name].value.numpy()
    if jx.layer_type == "crf_decoding":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 1
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_text_net_trains_like_reference(name, tmp_path):
    """3 Adam steps through each package's ``SGDTrainer`` from the JAX
    trainer's initial checkpoint, on three batches: the losses agree."""
    (jc, _), (tc, _), feed_fn = both(name)
    jtr = JaxTrainer(jc, jopt.Adam(learning_rate=2e-3), seed=3)
    jtr.save(str(tmp_path), 0)
    ttr = SGDTrainer(tc, topt.Adam(learning_rate=2e-3), seed=3,
                     device="cpu")
    ttr.load(str(tmp_path), 0)
    feeds = [feed_fn(seed=s) for s in range(3)]
    jl = [float(jtr.train_batch(f)) for f in feeds]
    tl = [ttr.train_batch(f).item() for f in feeds]
    assert all(np.isfinite(jl)) and int(ttr.opt_state["step"]) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)


def test_stacked_lstm_net_relu_runs_the_plain_scan(monkeypatch):
    """``act="relu"`` LSTMs take the plain scan in both packages, so the
    LSTM kernels' path never runs for stacked_lstm_net."""
    import paddle_tpu_torch.ops.rnn_fused as RF

    def boom(*a, **k):
        raise AssertionError("lstm_sequence_fused reached")

    monkeypatch.setattr(RF, "lstm_sequence_fused", boom)
    (_, _), (tc, _), feed_fn = both("stacked_lstm_net")
    tt = tnn.Topology(tc, device="cpu")
    p, s = tt.init(0)
    assert np.isfinite(tt.apply(p, s, feed_fn(), train=True)[0][
        tc.name].value.item())


def test_stacked_lstm_pp_net_names_its_roadmap_item():
    tnn.reset_naming()
    with pytest.raises(ConfigError) as info:
        tmodels.stacked_lstm_pp_net(V)
    assert str(info.value) == (
        "stacked_lstm_pp_net (the pipeline tier) is not ported to "
        "paddle_tpu_torch yet (ROADMAP.md, Queue 1 item 8)")


# ---------------------------------------------------------------------------
# v2.networks: the reference's equalities
# ---------------------------------------------------------------------------


def _masked(act):
    return (act.value * act.mask[..., None]).detach().numpy()


def _xs(D, lens, T, seed=0):
    return (np.random.RandomState(seed).randn(len(lens), T, D).astype(
        np.float32), np.asarray(lens, np.int32))


def test_lstmemory_group_equals_lstmemory_without_peepholes():
    """``tests/test_network_units.py:26`` on the port: the group LSTM
    (mixed + ``lstm_step`` in a recurrent group, c_t through
    ``get_output``) computes ``lstmemory(use_peepholes=False)`` with the
    same weights; here for the gradients too."""
    D, H = 5, 4
    tnn.reset_naming()
    x = tnn.data("x", size=D, is_seq=True)
    flat = tnn.lstmemory(x, H, use_peepholes=False, name="flat")
    proj = tnn.fc(x, 4 * H, act="linear", bias_attr=False, name="proj")
    grp = tnet.lstmemory_group(proj, H, name="lg")
    topo = tnn.Topology([flat, grp], device="cpu")
    p, s = topo.init(0)
    p["_flat.wbias"] = torch.randn(4 * H, generator=torch.Generator()
                                   .manual_seed(1))
    p["_proj.w0"] = p["_flat.wx"]
    p["_lg_input_recurrent.w1"] = p["_flat.w0"]
    p["_lg.wbias"] = p["_flat.wbias"]
    outs, _ = topo.apply(p, s, {"x": _xs(D, [6, 4, 1], 6)})
    np.testing.assert_allclose(_masked(outs["flat"]), _masked(outs["lg"]),
                               rtol=1e-5, atol=1e-6)


def test_gru_group_and_simple_gru2_equal_grumemory():
    """``tests/test_network_units.py:53,75`` on the port."""
    D, H = 6, 5
    tnn.reset_naming()
    x = tnn.data("x", size=D, is_seq=True)
    flat = tnn.grumemory(x, H, name="flat")
    proj = tnn.fc(x, 3 * H, act="linear", bias_attr=False, name="proj")
    grp = tnet.gru_group(proj, H, name="gg")
    g2 = tnet.simple_gru2(x, H, name="g2")
    topo = tnn.Topology([flat, grp, g2], device="cpu")
    p, s = topo.init(0)
    p["_flat.wbias"] = 0.3 * torch.ones(3 * H)
    p["_proj.w0"] = p["_g2_transform.w0"] = p["_flat.wx"]
    p["_gg.w0"] = p["_g2.w0"] = p["_flat.w0"]
    p["_gg.wbias"] = p["_g2.wbias"] = p["_flat.wbias"]
    p["_g2_transform.wbias"] = torch.zeros(3 * H)
    outs, _ = topo.apply(p, s, {"x": _xs(D, [5, 3], 5)})
    for name in ("gg", "g2"):
        np.testing.assert_allclose(_masked(outs["flat"]),
                                   _masked(outs[name]), rtol=1e-5,
                                   atol=1e-6)


def test_bidirectional_lstm_matches_manual_concat():
    """``tests/test_v2_networks.py:64`` on the port."""
    tnn.reset_naming()
    xs = tnn.data("xs", size=5, is_seq=True)
    merged = tnet.bidirectional_lstm(xs, 4, name="bd")
    fw, bw = tnet.bidirectional_lstm(xs, 4, name="bd2",
                                     return_unmerged=True)
    assert (fw.name, bw.name) == ("bd2_fw", "bd2_bw")
    topo = tnn.Topology([merged, fw, bw], device="cpu")
    p, s = topo.init(0)
    for k in list(p):
        if "bd2" in k:
            p[k] = p[k.replace("bd2", "bd")]
    outs, _ = topo.apply(p, s, {"xs": _xs(5, [5, 3], 5)})
    torch.testing.assert_close(
        outs[merged.name].value,
        torch.cat([outs[fw.name].value, outs[bw.name].value], -1),
        rtol=0, atol=0)


def test_v2_helpers_match_reference():
    """``simple_lstm``, ``sequence_conv_pool`` (``tests/test_v2_networks.py
    :83``) and ``lstmemory_unit`` in a group, the port's against the JAX
    package's: names, outputs and gradients."""

    def build(nn, net):
        xs = nn.data("xs", size=6, is_seq=True)
        a = net.simple_lstm(xs, 4, name="sl")
        b = net.sequence_conv_pool(xs, context_len=3, hidden_size=7,
                                   name="scp")
        c = net.sequence_conv_pool(xs, context_len=4, hidden_size=5,
                                   context_start=-1, pool_type="avg")
        proj = nn.fc(xs, 12, act="linear", name="proj")
        d = net.lstmemory_group(proj, 3, reverse=True, mixed_bias_attr=True)
        return nn.concat([nn.pooling(a), b, c, nn.last_seq(d)], name="out")

    jnn.reset_naming()
    jout = build(jnn, jnet)
    tnn.reset_naming()
    tout = build(tnn, tnet)
    assert tout.size == jout.size == 4 + 7 + 5 + 3
    jt, tt = jnn.Topology(jout), tnn.Topology(tout, device="cpu")
    assert {k: s.shape for k, s in tt.param_specs.items()} \
        == {k: s.shape for k, s in jt.param_specs.items()}
    jp, js = jt.init(jax.random.PRNGKey(0))
    w = np.random.RandomState(3).randn(2, tout.size).astype(np.float32)
    jv, jg, tv, tg = loss_and_grads(jt, tt, jout.name, nonzero_params(jp),
                                    js, {"xs": _xs(6, [5, 2], 5)},
                                    weight=w)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)


def test_error_clip_clips_the_backward_only():
    tnn.reset_naming()
    x = tnn.data("x", size=3)
    out = tnn.error_clip(x, 0.5)
    topo = tnn.Topology(out, device="cpu")
    v = torch.tensor([[1.0, -2.0, 3.0]], requires_grad=True)
    y = topo.apply({}, {}, {"x": v})[0][out.name].value
    assert torch.equal(y, v.detach())
    (g,) = torch.autograd.grad(y, v, torch.tensor([[2.0, -0.1, -3.0]]))
    assert torch.equal(g, torch.tensor([[0.5, -0.1, -0.5]]))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["conll05", "conll05_features"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_conll05_streams_match_reference(name, split, monkeypatch,
                                         tmp_path):
    """The synthetic streams, row for row (the JAX package's data home
    pointed at an empty directory, so it too takes the synthetic
    branch)."""
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    kw = dict(vocab_size=800, n_labels=19, n=40)
    want = list(getattr(jdata.datasets, name)(split, **kw)())
    got = list(getattr(tdata.datasets, name)(split, **kw)())
    assert got == want and len(got) == 40
    assert len(got[0]) == (9 if name == "conll05_features" else 3)
