"""The port's data tier against the JAX package's: the reader decorators
yield the same samples in the same order for the same seed, the
DataFeeder gives the same arrays (every slot kind), and the synthetic
datasets are sample for sample the reference's.  Everything here is
integer or copied data, so every comparison is exact."""

import numpy as np
import pytest

import paddle_tpu.data as jdata
import paddle_tpu.nn as jnn
from paddle_tpu.data import input_types as jtypes
from paddle_tpu.data.feeder import feeder_kind_for_layer as jkind

import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.data import input_types as ttypes
from paddle_tpu_torch.data.feeder import feeder_kind_for_layer as tkind


def _same(a, b):
    """Samples equal, recursively (arrays exactly)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _src(n=23):
    def reader():
        for i in range(n):
            yield (i, [i] * (i % 4), float(i) / 3)
    return reader


@pytest.mark.parametrize("build", [
    lambda d, r: d.batch(r, 5),
    lambda d, r: d.batch(r, 5, drop_last=False),
    lambda d, r: d.shuffle(r, 7, seed=3),
    lambda d, r: d.shuffle(r, 100, seed=11),
    lambda d, r: d.buffered(r, 4),
    lambda d, r: d.map_readers(lambda a, b: (a[0], b[0]), r, r),
    lambda d, r: d.compose(r, lambda: (x[0] for x in r())),
    lambda d, r: d.chain(r, r),
    lambda d, r: d.firstn(r, 6),
    lambda d, r: d.cache(d.shuffle(r, 4, seed=1)),
    lambda d, r: d.batch(d.shuffle(d.firstn(r, 17), 5, seed=2), 4),
], ids=["batch", "batch_ragged", "shuffle", "shuffle_all", "buffered",
        "map_readers", "compose", "chain", "firstn", "cache", "stacked"])
def test_reader_decorators_match_reference(build):
    want = list(build(jdata, _src())())
    got_reader = build(tdata, _src())
    got = list(got_reader())
    _same(got, want)
    _same(list(got_reader()), want)  # a second pass gives the same samples


@pytest.mark.parametrize("name,kw", [
    ("imdb", {"vocab_size": 48, "n": 40}),
    ("imdb", {"vocab_size": 30000, "n": 5}),
    ("sentiment", {"vocab_size": 100, "n": 30}),
    ("mnist", {"n": 12}),
    ("cifar10", {"n": 9}),
    ("uci_housing", {"n": 25}),
])
@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_datasets_bit_identical(name, kw, split, monkeypatch,
                                          tmp_path):
    # the reference reads real files under its data home when present:
    # point it at an empty directory so it gives its synthetic stream
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    want = list(getattr(jdata.datasets, name)(split, **kw)())
    got = list(getattr(tdata.datasets, name)(split, **kw)())
    assert len(got) == len(want) == kw["n"]
    _same(got, want)


def test_dataset_default_sizes_match_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    for name in ("imdb", "sentiment", "uci_housing"):
        assert sum(1 for _ in getattr(tdata.datasets, name)()()) == \
            sum(1 for _ in getattr(jdata.datasets, name)()())


ROWS = [([1, 2, 3], 0, [0.5, 1.0], [[1.0, 2.0], [3.0, 4.0]], [3, 7],
         [(1, 0.5), (4, 2.0)], [[1, 2], [3]], [[1, 2], [3], [4]]),
        ([4, 5], 1, [1.5, -1.0], [[0.0, 1.0]], [2],
         [(0, 1.0)], [[5], [6, 7, 8], [9]], [[5, 6, 7]]),
        (list(range(20)), 1, [0.0, 0.0], [[1.0, 1.0]] * 11,
         list(range(12)), [], [[1]] * 13, [[1]] * 12 + [list(range(9))])]

TYPES = {"words": "ids_seq", "label": "int", "vec": "dense",
         "frames": "dense_seq", "bag": "sparse_ids",
         "pairs": "sparse_pairs", "bags": "sparse_ids_seq",
         "nested": "ids_nested"}


@pytest.mark.parametrize("kw", [{}, {"buckets": (4, 16), "max_len": 10},
                                {"max_len": 3, "max_nnz": 2}])
def test_feeder_matches_reference(kw):
    jf = jdata.DataFeeder(TYPES, **kw)
    tf = tdata.DataFeeder(TYPES, **kw)
    for rows in (ROWS, ROWS[:2], ROWS[1:]):
        want, got = jf(rows), tf(rows)
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    assert tf.pad_waste == pytest.approx(jf.pad_waste, abs=0)
    assert tf.dropped_features == jf.dropped_features


def test_textclf_feeder_pads_to_t():
    """The textclf config's feeder: one bucket at T, longer rows capped."""
    f = tdata.DataFeeder({"words": "ids_seq", "label": "int"},
                         buckets=(100,), max_len=100)
    rows = [(list(range(150)), 1), (list(range(3)), 0)]
    feed = f(rows)
    ids, lens = feed["words"]
    assert ids.shape == (2, 100) and ids.dtype == np.int32
    np.testing.assert_array_equal(lens, [100, 3])
    assert feed["label"].shape == (2, 1)
    assert f.pad_waste == pytest.approx(1 - 103 / 200)


def test_feeder_errors_name_the_slot():
    f = tdata.DataFeeder({"words": "ids_seq"}, feeding={"words": 3})
    with pytest.raises(ValueError, match="words"):
        f([([1], 0)])
    with pytest.raises(ValueError, match="missing from the feeding map"):
        tdata.DataFeeder({"a": "int"}, feeding={"b": 0})([(1,)])
    with pytest.raises(ValueError, match="unknown slot kind"):
        tdata.DataFeeder({"a": "strange"})([(1,)])


def test_note_padding_sets_the_registry_gauges():
    from paddle_tpu_torch.obs import get_registry

    f = tdata.DataFeeder({"words": "ids_seq"}, buckets=(8,))
    f([([1, 2],), ([3, 4, 5, 6],)])
    snap = get_registry().snapshot()
    assert "data_pad_waste" in snap and "data_bucket_occupancy" in snap
    g = get_registry().gauge("data_pad_waste")
    assert g.value == pytest.approx(f.pad_waste)


def test_feeder_kind_for_layer_matches_reference():
    for kw in ({"size": 3}, {"size": 3, "dtype": "int32"},
               {"size": 3, "is_seq": True},
               {"size": 9, "is_seq": True, "dtype": "int32"}):
        jnn.reset_naming()
        tnn.reset_naming()
        assert tkind(tnn.data("d", **kw)) == jkind(jnn.data("d", **kw))


def test_input_types_match_reference():
    for name in ttypes.__all__:
        if name == "InputType":
            continue
        t = getattr(ttypes, name)(7)
        j = getattr(jtypes, name)(7)
        assert (t.dim, t.seq, t.kind, t.feeder_kind) == \
            (j.dim, j.seq, j.kind, j.feeder_kind)
    assert ttypes.__all__ == jtypes.__all__
