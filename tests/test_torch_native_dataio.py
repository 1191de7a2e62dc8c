"""The port's native data core (``paddle_tpu_torch/data/native.py`` over
``paddle_tpu_torch/csrc/dataio.cc``) on the CPU: every test of
``tests/test_native_dataio.py`` on the port, each opening with the
reference test it mirrors; then each entry point against the JAX package's
on the same seeded inputs, branch by branch (native against native, and
both numpy fallbacks, forced by making each loader return ``None``), the
library's home, a failed build, and the feeder's native pad against the
Python loop beside it.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_native_dataio.py -q

Every comparison is exact (array equality): the core moves ints.  The two
branches differ only in ``shuffle_indices`` (``std::mt19937_64`` against
``RandomState.permutation``), which is why parity holds branch by branch.
"""

import os

import numpy as np
import pytest

from paddle_tpu.data import native as jnative

import paddle_tpu_torch
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.data import native

PKG = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))


# -- the reference's tests, on the port ---------------------------------


def test_native_compiles_and_loads():
    """tests/test_native_dataio.py::test_native_compiles_and_loads"""
    assert native.native_available(), native.build_error()


def test_shuffle_is_permutation_and_deterministic():
    """tests/test_native_dataio.py::
    test_shuffle_is_permutation_and_deterministic"""
    a = native.shuffle_indices(100, seed=7)
    b = native.shuffle_indices(100, seed=7)
    c = native.shuffle_indices(100, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(np.sort(a), np.arange(100))


def test_bucket_by_length():
    """tests/test_native_dataio.py::test_bucket_by_length"""
    lens = np.array([1, 8, 9, 33, 200], np.int32)
    out = native.bucket_by_length(lens, [8, 16, 32, 64])
    np.testing.assert_array_equal(out, [0, 0, 1, 3, 3])


def test_argsort_by_length_stable():
    """tests/test_native_dataio.py::test_argsort_by_length_stable"""
    lens = np.array([5, 2, 5, 1], np.int32)
    out = native.argsort_by_length(lens)
    np.testing.assert_array_equal(out, [3, 1, 0, 2])


def test_pad_batch_matches_manual():
    """tests/test_native_dataio.py::test_pad_batch_matches_manual"""
    seqs = [[1, 2, 3], [4], [5, 6, 7, 8, 9]]
    ids, lens = native.pad_batch_i32(seqs, max_t=4)
    np.testing.assert_array_equal(lens, [3, 1, 4])
    np.testing.assert_array_equal(ids[0], [1, 2, 3, 0])
    np.testing.assert_array_equal(ids[1], [4, 0, 0, 0])
    np.testing.assert_array_equal(ids[2], [5, 6, 7, 8])  # clipped


def test_pack_sequences():
    """tests/test_native_dataio.py::test_pack_sequences"""
    seqs = [[1, 1, 1], [2, 2], [3, 3, 3, 3], [4]]
    ids, seg, used, placed = native.pack_sequences(seqs, n_rows=2, T=6)
    assert placed == 4
    assert used.sum() == 10
    # segment ids partition the non-pad tokens
    for s in range(1, 5):
        assert (seg == s).sum() == len(seqs[s - 1])
    # pads are segment 0 (no id here is 0)
    np.testing.assert_array_equal(seg == 0, ids == 0)


def test_count_tokens():
    """tests/test_native_dataio.py::test_count_tokens"""
    counts = native.count_tokens([[1, 2, 2], [2, 5]], vocab_cap=6)
    np.testing.assert_array_equal(counts, [0, 1, 3, 0, 0, 1])


# -- the port against the JAX package -----------------------------------


def _seqs(rng, n, lo, hi, vocab):
    return [rng.randint(-2, vocab + 2, rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _calls(seed):
    """Each entry point's call on seeded random inputs, as a list of
    (name, fn(module) -> output)."""
    rng = np.random.RandomState(seed)
    seqs = _seqs(rng, 37, 0, 40, 50)
    lens = rng.randint(0, 300, 61).astype(np.int32)
    buckets = sorted(set(rng.randint(1, 260, 6).tolist()))
    pack = _seqs(rng, 40, 1, 12, 50)
    return [
        ("shuffle_indices", lambda m: m.shuffle_indices(257, seed)),
        ("shuffle_indices_big_seed", lambda m: m.shuffle_indices(
            64, 2**40 + seed)),
        ("bucket_by_length", lambda m: m.bucket_by_length(lens, buckets)),
        ("argsort_by_length", lambda m: m.argsort_by_length(lens)),
        ("pad_batch_i32", lambda m: m.pad_batch_i32(seqs, 24)),
        ("pad_batch_i32_wide", lambda m: m.pad_batch_i32(seqs, 64)),
        ("pack_sequences", lambda m: m.pack_sequences(pack, 5, 16)),
        ("count_tokens", lambda m: m.count_tokens(seqs, 40)),
    ]


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_entry_point_equals_the_reference_native(seed):
    """Native against native: the two packages' C++ cores, bit for bit."""
    assert native.native_available() and jnative.native_available()
    for (_, call), (_, jcall) in zip(_calls(seed), _calls(seed)):
        _assert_same(call(native), jcall(jnative))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_entry_point_equals_the_reference_fallback(seed, monkeypatch):
    """Both numpy fallbacks (each loader made to return None)."""
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    assert not native.native_available()
    for (_, call), (_, jcall) in zip(_calls(seed), _calls(seed)):
        _assert_same(call(native), jcall(jnative))


def test_branches_agree_but_for_the_shuffle(monkeypatch):
    """Within the port, native and fallback agree on every entry point
    but ``shuffle_indices``, whose two generators differ (a permutation of
    the same range each)."""
    nat = {n: c(native) for n, c in _calls(5)}
    monkeypatch.setattr(native, "_load", lambda: None)
    fb = {n: c(native) for n, c in _calls(5)}
    for name in nat:
        if name.startswith("shuffle"):
            assert not np.array_equal(nat[name], fb[name])
            np.testing.assert_array_equal(np.sort(nat[name]),
                                          np.sort(fb[name]))
        else:
            _assert_same(nat[name], fb[name])


def test_the_library_lands_in_the_ports_build_directory(tmp_path,
                                                        monkeypatch):
    assert native.native_available()
    so = native.library_path()
    assert os.path.dirname(so) == os.path.join(PKG, "_build")
    assert os.path.basename(so).startswith("libpaddle_tpu_torch_dataio-")
    assert os.path.isfile(so)
    ref_dir = os.path.join(os.path.dirname(PKG), "paddle_tpu", "_native")
    if os.path.isdir(ref_dir):
        assert not [f for f in os.listdir(ref_dir) if "torch" in f]
    # the name follows the source: an edited source is another library
    edited = tmp_path / "dataio.cc"
    with open(native.SOURCE) as f:
        edited.write_text(f.read() + "// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(edited))
    other = native.library_path()
    assert other != so and os.path.dirname(other) == os.path.dirname(so)


def test_a_failed_build_falls_back_and_says_why(tmp_path, monkeypatch):
    bad = tmp_path / "dataio.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.native_available()
    assert native.build_error()
    assert not any(f.endswith(".so") or f.endswith(".tmp") for f in
                   os.listdir(tmp_path / "_build"))
    ids, lens = native.pad_batch_i32([[1, 2], [3]], 3)
    np.testing.assert_array_equal(ids, [[1, 2, 0], [3, 0, 0]])


def _feed_rows(seed, n=9):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 90, rng.randint(1, 30)).tolist(),
             int(rng.randint(0, 2))) for _ in range(n)]


@pytest.mark.parametrize("kw", [{}, {"max_len": 12},
                                {"max_len": 20, "buckets": (20,)}])
def test_feeder_native_pad_equals_the_loop(kw, monkeypatch):
    """The feeder's ``ids_seq`` through the C++ core against the Python
    loop: the same arrays, dtypes and token counts, batch after batch."""
    types = {"words": "ids_seq", "label": "int"}
    nat = DataFeeder(types, **kw)
    outs = [nat(_feed_rows(s)) for s in range(4)]
    monkeypatch.setattr(native, "_load", lambda: None)
    loop = DataFeeder(types, **kw)
    for s, got in enumerate(outs):
        want = loop(_feed_rows(s))
        _assert_same(got["words"][0], want["words"][0])
        _assert_same(got["words"][1], want["words"][1])
        _assert_same(got["label"], want["label"])
    assert (nat.tokens_real, nat.tokens_padded) == (loop.tokens_real,
                                                     loop.tokens_padded)
    assert nat.pad_waste == loop.pad_waste


def test_feeder_native_pad_equals_the_reference_feeder():
    """The port's feeder (native pad) against the JAX package's (its own
    native pad) on the same rows."""
    from paddle_tpu.data.feeder import DataFeeder as JaxFeeder

    types = {"words": "ids_seq", "label": "int"}
    t, j = DataFeeder(types, max_len=16), JaxFeeder(types, max_len=16)
    for s in range(3):
        got, want = t(_feed_rows(s)), j(_feed_rows(s))
        _assert_same(got["words"][0], np.asarray(want["words"][0]))
        _assert_same(got["words"][1], np.asarray(want["words"][1]))
    assert (t.tokens_real, t.tokens_padded) == (j.tokens_real,
                                                 j.tokens_padded)
