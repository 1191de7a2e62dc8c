"""Sequence packing on the port (``--data_pack``) against the JAX package
and against its own unpacked run, on the CPU: the segment ops, the packer
and ``PackedDataFeeder``, the packed layers (the recurrent layers' carry
reset forward and reverse, per-segment pooling / first / last, expand,
the fenced context window), the packed loss and every gradient of
``lstm_benchmark_net``, ``stacked_lstm_net(stacked_num=3)`` and
``convolution_net``, ``auto_pack``, the pad-waste gauges and the layers
that refuse a packed input, each named.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_packing.py -q

Tolerances: the port's packed run against its unpacked run on the same
samples at the reference's own (``tests/test_datapipe.py``): atol 2e-7 on
the loss and 5e-7 on each gradient, and for the convolution net bit for
bit on every gradient but the biases' (a sum over the batch's [B, T]
layout, whose order PyTorch's CPU reduction takes from the shape);
against the JAX package's packed run, the loss at rtol 1e-5 / atol
1e-6 and each gradient within 1e-5 of its largest entry (1e-6 absolute
where it vanishes), float32 sums in another order; the segment ops at
``torch_compare.close``'s rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.datapipe as jdp
import paddle_tpu.models as jmodels
import paddle_tpu.nn as jnn
import paddle_tpu.ops as JO
from paddle_tpu.data.feeder import DataFeeder as JaxFeeder

import paddle_tpu_torch.models as tmodels
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.datapipe import (PackedDataFeeder, ShardSource,
                                       auto_pack, pack_reader, pack_samples,
                                       write_shard_set)
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.utils.error import ConfigError

from torch_compare import (assert_grads_close, close, fwd_grad,
                           loss_and_grads, nonzero_params)

RTOL, ATOL = 1e-5, 1e-6
TYPES = {"words": "ids_seq", "label": "int"}


@pytest.fixture(autouse=True)
def _f32():
    tnn.reset_naming()
    with compute_dtype_scope("float32"):
        yield


def _textclf_samples(n=10, vocab=50, seed=0, lo=2, hi=9):
    rs = np.random.RandomState(seed)
    return [(rs.randint(1, vocab, rs.randint(lo, hi)).tolist(),
             int(rs.randint(0, 2))) for _ in range(n)]


def _same_feed(got, want):
    assert set(got) == set(want)
    for k in want:
        gs = got[k] if isinstance(got[k], tuple) else (got[k],)
        ws = want[k] if isinstance(want[k], tuple) else (want[k],)
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


# ---------------------------------------------------------------------------
# packer and feeder
# ---------------------------------------------------------------------------


def test_pack_samples_respects_budgets_and_order():
    samples = _textclf_samples(20)
    rows = pack_samples(samples, max_len=16, max_segments=3)
    flat = [seq for seqs, _ in rows for seq in seqs]
    assert flat == [list(s[0])[:16] for s in samples]
    for seqs, rest in rows:
        assert len(seqs) <= 3 and sum(len(s) for s in seqs) <= 16
        assert len(rest) == len(seqs)
    assert list(pack_reader(lambda: iter(samples), max_len=16,
                            max_segments=3)()) == rows
    assert rows == jdp.pack_samples(samples, max_len=16, max_segments=3)


def test_packed_feeder_shapes_and_segment_layout():
    samples = [([1, 2, 3], 0), ([4, 5], 1), ([6], 0)]
    rows = pack_samples(samples, max_len=8, max_segments=4)
    assert len(rows) == 1
    pf = PackedDataFeeder(TYPES, max_segments=4)
    feed = pf(rows)
    ids, lengths, seg_ids, positions, seg_lengths = feed["words"]
    assert ids.shape == (1, 8) and seg_lengths.shape == (1, 4)
    assert list(ids[0]) == [1, 2, 3, 4, 5, 6, 0, 0]
    assert list(seg_ids[0]) == [0, 0, 0, 1, 1, 2, -1, -1]
    assert list(positions[0]) == [0, 1, 2, 0, 1, 0, 0, 0]
    assert list(seg_lengths[0]) == [3, 2, 1, 0]
    assert lengths[0] == 6
    assert list(feed["label"][0]) == [0, 1, 0, 0]
    _same_feed(feed, jdp.PackedDataFeeder(TYPES, max_segments=4)(rows))


def test_packed_feeder_dense_slot_equals_the_jax_packages():
    rs = np.random.RandomState(2)
    samples = [(rs.randint(1, 9, rs.randint(1, 6)).tolist(),
                rs.randn(3).astype(np.float32).tolist(), int(i % 2))
               for i in range(9)]
    types = {"words": "ids_seq", "x": "dense", "label": "int"}
    rows = pack_samples(samples, max_len=12, max_segments=3)
    _same_feed(PackedDataFeeder(types, max_segments=3)(rows),
               jdp.PackedDataFeeder(types, max_segments=3)(rows))


def test_packed_feeder_rejects_unpackable_slots():
    with pytest.raises(ConfigError, match="exactly one 'ids_seq'"):
        PackedDataFeeder({"a": "dense", "b": "int"})
    with pytest.raises(ConfigError, match="not packable"):
        PackedDataFeeder({"w": "ids_seq", "x": "sparse_ids"})


def test_pad_waste_drops_at_least_2x_and_gauge_updates():
    from paddle_tpu_torch.obs import get_registry

    rs = np.random.RandomState(0)
    samples = [(rs.randint(1, 100, int(np.clip(rs.exponential(12) + 2, 2,
                                               96))).tolist(), 0)
               for _ in range(256)]
    feeder = DataFeeder(TYPES, max_len=128)
    for i in range(0, 256, 64):
        feeder(samples[i:i + 64])
    pf = PackedDataFeeder(TYPES, max_segments=16)
    rows = pack_samples(samples, max_len=128, max_segments=16)
    for i in range(0, len(rows), 64):
        pf(rows[i:i + 64])
    assert feeder.pad_waste >= 2 * pf.pad_waste, \
        (feeder.pad_waste, pf.pad_waste)
    g = get_registry().gauge("data_pad_waste",
                             "cumulative padded-but-dead token fraction")
    assert g.value == pytest.approx(pf.pad_waste)
    occ = get_registry().gauge(
        "data_bucket_occupancy",
        "real-token fraction of batches padded to this T bucket",
        labels=("bucket",), bucket=128)
    assert occ.value is not None and 0.0 < occ.value <= 1.0


def test_auto_pack_honors_feeder_max_len_and_source_batch_size(tmp_path):
    samples = _textclf_samples(24, lo=2, hi=12)
    feeder = DataFeeder(TYPES, max_len=4)

    def reader():
        return iter([samples[i:i + 6] for i in range(0, 24, 6)])

    packed_reader, pf = auto_pack(reader, feeder)
    rows = [r for batch in packed_reader() for r in batch]
    assert all(len(seq) <= 4 for seqs, _ in rows for seq in seqs)
    batches = list(packed_reader())
    assert all(len(b) <= 6 for b in batches)
    jreader, _ = jdp.auto_pack(reader, JaxFeeder(TYPES, max_len=4))
    assert batches == list(jreader())
    out = str(tmp_path / "bs")
    write_shard_set(out, lambda: iter(samples), num_shards=2)
    src = ShardSource(out, batch_size=6, seed=0)
    auto_pack(src, feeder)
    assert src.cursor_for(0, 0)["offset"] == 0
    assert src.state()["next_batch"] == 0


# ---------------------------------------------------------------------------
# the segment ops against the JAX package's
# ---------------------------------------------------------------------------


def _pack_arrays(seed=0, B=3, S=4, max_len=12):
    rs = np.random.RandomState(seed)
    samples = [(rs.randint(1, 9, rs.randint(1, 5)).tolist(), 0)
               for _ in range(B * 3)]
    rows = pack_samples(samples, max_len=max_len, max_segments=S)[:B]
    ids, lengths, seg_ids, positions, seg_lengths = PackedDataFeeder(
        TYPES, max_segments=S, buckets=(max_len,))(rows)["words"]
    T = ids.shape[1]
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    value = rs.randn(len(rows), T, 5).astype(np.float32)
    return value, mask, seg_ids, seg_lengths


@pytest.mark.parametrize("reverse", [False, True])
def test_segment_starts_equal_the_jax_packages(reverse):
    _, mask, seg_ids, _ = _pack_arrays()
    got = TO.segment_starts(torch.from_numpy(seg_ids),
                            torch.from_numpy(mask), reverse=reverse)
    want = JO.segment_starts(jnp.asarray(seg_ids), jnp.asarray(mask),
                             reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "sqrt"])
def test_segment_pool_equals_the_jax_packages(kind):
    value, mask, seg_ids, seg_lengths = _pack_arrays(1)
    fwd_grad(lambda v: JO.segment_pool(v, jnp.asarray(mask),
                                       jnp.asarray(seg_ids),
                                       jnp.asarray(seg_lengths), kind),
             lambda v: TO.segment_pool(v, torch.from_numpy(mask),
                                       torch.from_numpy(seg_ids),
                                       torch.from_numpy(seg_lengths), kind),
             value)


@pytest.mark.parametrize("op", ["segment_last", "segment_first"])
def test_segment_last_first_equal_the_jax_packages(op):
    value, _, _, seg_lengths = _pack_arrays(2)
    fwd_grad(lambda v: getattr(JO, op)(v, jnp.asarray(seg_lengths)),
             lambda v: getattr(TO, op)(v, torch.from_numpy(seg_lengths)),
             value)


def test_segment_expand_equals_the_jax_packages():
    value, mask, seg_ids, seg_lengths = _pack_arrays(3)
    vec = np.random.RandomState(4).randn(value.shape[0], seg_lengths.shape[1],
                                         5).astype(np.float32)
    fwd_grad(lambda v: JO.segment_expand(v, jnp.asarray(seg_ids),
                                         jnp.asarray(mask)),
             lambda v: TO.segment_expand(v, torch.from_numpy(seg_ids),
                                         torch.from_numpy(mask)), vec)


@pytest.mark.parametrize("start", [-1, 0, -2])
def test_fenced_context_projection_equals_the_jax_packages(start):
    value, mask, seg_ids, _ = _pack_arrays(5)
    fwd_grad(lambda v: JO.context_projection(v, jnp.asarray(mask), 3, start,
                                             seg_ids=jnp.asarray(seg_ids)),
             lambda v: TO.context_projection(v, torch.from_numpy(mask), 3,
                                             start,
                                             seg_ids=torch.from_numpy(
                                                 seg_ids)), value)


# ---------------------------------------------------------------------------
# packed layers and nets
# ---------------------------------------------------------------------------


def _both(build, seed=0):
    jnn.reset_naming()
    jout = build(jnn)
    jt = jnn.Topology(jout)
    jp, js = jt.init(jax.random.PRNGKey(seed))
    tnn.reset_naming()
    tout = build(tnn)
    assert tout.name == jout.name
    return jt, tnn.Topology(tout, device="cpu"), tout.name, \
        nonzero_params(jp), js


def _packed_feed(samples, S=4, max_len=16):
    rows = pack_samples(samples, max_len=max_len, max_segments=S)
    assert len(rows) < len(samples)
    return PackedDataFeeder(TYPES, max_segments=S)(rows)


def _layer_net(kind):
    def build(nn):
        words = nn.data("words", size=40, is_seq=True, dtype="int32")
        emb = nn.embedding(words, 6, name="emb")
        if kind in ("gru", "gru_reverse"):
            h = nn.grumemory(emb, 5, reverse=kind == "gru_reverse",
                             name="rnn")
        elif kind == "elman":
            h = nn.layers.recurrent(nn.fc(emb, 6, act="linear", name="p"),
                                    reverse=True, name="rnn")
        elif kind == "expand":
            pooled = nn.pooling(emb, pooling_type="avg", name="pool")
            h = nn.addto([nn.expand(pooled, emb, name="exp"), emb],
                         name="sum")
        elif kind == "first":
            h = emb
        else:
            h = nn.lstmemory(emb, 5, reverse=kind == "lstm_reverse",
                             act="relu" if kind == "relu" else "tanh",
                             name="rnn")
        last = (nn.first_seq(h, name="last") if kind == "first"
                else nn.last_seq(h, name="last"))
        logits = nn.fc(last, 2, act="linear", name="logits")
        label = nn.data("label", size=1, dtype="int32")
        return nn.classification_cost(logits, label, name="cost")

    return build


@pytest.mark.parametrize("kind", ["lstm", "lstm_reverse", "relu", "gru",
                                  "gru_reverse", "elman", "expand", "first"])
def test_packed_layers_match_the_jax_package_and_unpacked(kind):
    """Each pack-aware layer on a packed feed: loss and every gradient
    against the JAX package's packed run, and the loss against the port's
    own unpacked run of the same samples."""
    samples = _textclf_samples(8, vocab=40, seed=1)
    jt, tt, name, jp, js = _both(_layer_net(kind), seed=2)
    feed = _packed_feed(samples)
    jl, jg, tl, tg = loss_and_grads(jt, tt, name, jp, js, feed,
                                    train=False)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)
    _, _, tu, _ = loss_and_grads(jt, tt, name, jp, js,
                                 DataFeeder(TYPES)(samples), train=False)
    np.testing.assert_allclose(tl, tu, rtol=0, atol=2e-7)


def _model(model, nn, models, V):
    if model == "lstm":
        return models.lstm_benchmark_net(V, emb_dim=8, hid_dim=16,
                                         num_layers=2)[0]
    if model == "stacked_reverse":
        return models.stacked_lstm_net(V, emb_dim=8, hid_dim=8,
                                       stacked_num=3)[0]
    return models.convolution_net(V, emb_dim=8, hid_dim=8)[0]


@pytest.mark.parametrize("model", ["lstm", "stacked_reverse", "conv"])
def test_packed_loss_matches_unpacked_oracle_and_the_jax_package(model):
    """The packed batch computes the per-sample math of one row a sample:
    the port's packed loss and every gradient equal its unpacked run's at
    the reference's tolerances (the convolution net bit for bit), and the
    JAX package's packed run's at the parity tolerance."""
    VOCAB = 40
    samples = _textclf_samples(8, vocab=VOCAB, seed=1)
    jnn.reset_naming()
    jcost = _model(model, jnn, jmodels, VOCAB)
    jt = jnn.Topology([jcost])
    jp, js = jt.init(jax.random.PRNGKey(0))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    tnn.reset_naming()
    tcost = _model(model, tnn, tmodels, VOCAB)
    tt = tnn.Topology([tcost], device="cpu")
    feed_u = DataFeeder(TYPES)(samples)
    feed_p = _packed_feed(samples)
    jl, jg, tl, tg = loss_and_grads(jt, tt, tcost.name, jp, js, feed_p,
                                    train=False)
    _, _, ul, ug = loss_and_grads(jt, tt, tcost.name, jp, js, feed_u,
                                  train=False)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)
    if model == "conv":
        # bit for bit but where a sum runs over the batch's layout: the
        # loss's mean and the biases' gradients (PyTorch's CPU sum order
        # depends on the [B, T] shape; the JAX package's does not)
        for k in ug:
            if not k.endswith("wbias"):
                np.testing.assert_array_equal(tg[k], ug[k], err_msg=k)
    np.testing.assert_allclose(tl, ul, rtol=0, atol=2e-7)
    for k in ug:
        np.testing.assert_allclose(tg[k], ug[k], rtol=0, atol=5e-7,
                                   err_msg=k)


def test_packed_train_step_runs_and_converges():
    from paddle_tpu_torch.param.optimizers import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    VOCAB = 30
    rs = np.random.RandomState(0)
    samples = []
    for _ in range(64):
        L = rs.randint(2, 8)
        seq = rs.randint(1, VOCAB, L).tolist()
        samples.append((seq, seq[0] % 2))
    cost, _ = tmodels.lstm_benchmark_net(VOCAB, emb_dim=8, hid_dim=16,
                                         num_layers=1)
    tr = SGDTrainer(cost, Adam(learning_rate=0.05), seed=0, device="cpu")
    rows = pack_samples(samples, max_len=32, max_segments=8)
    feed = PackedDataFeeder(TYPES, max_segments=8)(rows)
    first = float(tr.train_batch(feed))
    for _ in range(30):
        last = float(tr.train_batch(feed))
    assert last < first


def _refusal_net(kind):
    def build(nn):
        words = nn.data("words", size=20, is_seq=True, dtype="int32")
        emb = nn.embedding(words, 4, name="emb")
        label = nn.data("label", size=1, dtype="int32")
        if kind == "seq_reverse":
            h = nn.pooling(nn.seq_reverse(emb, name="layer"), name="pool")
        elif kind == "seq_concat":
            h = nn.pooling(nn.seq_concat(emb, emb, name="layer"),
                           name="pool")
        elif kind in ("sub_seq", "seq_reshape"):
            h = nn.pooling(
                nn.sub_seq(emb, label, label, name="layer")
                if kind == "sub_seq" else
                nn.seq_reshape(emb, 8, name="layer"), name="pool")
        elif kind == "recurrent_group":
            def step(x, m):
                s = nn.fc([x, m], 4, name="cell")
                return [s, s]

            h = nn.last_seq(nn.recurrent_group(
                step, [emb], [nn.Memory("m", 4)], name="layer"))
        else:
            tags = nn.data("tags", size=3, is_seq=True, dtype="int32")
            e3 = nn.fc(emb, 4 if "ctc" in kind else 3, act="linear",
                       name="e3")
            if kind == "crf_cost":
                return nn.crf_cost(e3, tags, name="layer")
            if kind == "crf_decoding":
                return nn.crf_decoding(e3, name="layer")
            if kind in ("ctc_cost", "warp_ctc"):
                return getattr(nn, kind)(e3, tags, name="layer")
            return nn.eos_trim(nn.maxid(e3), eos_id=1, name="layer")
        return nn.classification_cost(nn.fc(h, 2, act="linear"), label)

    return build


@pytest.mark.parametrize("kind", ["seq_reverse", "seq_concat", "crf_cost",
                                  "crf_decoding", "ctc_cost", "warp_ctc",
                                  "sub_seq", "seq_reshape", "eos_trim",
                                  "recurrent_group"])
def test_packed_input_refused_by_layers_with_no_segment_semantics(kind):
    """A layer that consumes the time axis whole with no per-segment
    variant refuses a packed input with a typed ConfigError naming it, as
    the reference's do."""
    topo = tnn.Topology(_refusal_net(kind)(tnn), device="cpu")
    params, state = topo.init(0)
    feed = _packed_feed(_textclf_samples(6, vocab=20))
    feed["tags"] = (np.zeros_like(feed["words"][0]) % 3, feed["words"][1])
    with pytest.raises(ConfigError,
                       match=f"{kind} 'layer' does not support packed"):
        topo.apply(params, state, feed, train=False)
