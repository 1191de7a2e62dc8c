"""The port's PyDataProvider2 ``@provider`` (``paddle_tpu_torch/data/
provider.py``) on the CPU: every test of ``tests/test_provider.py`` on the
port, each opening with the reference test it mirrors; then the same
provider built with both packages over the same files, batch for batch
(shuffle with a pool, the pass cache, ``calc_batch_size``, the check,
dict slots) and feed for feed; and a provider-fed ``SGDTrainer`` run of
both packages from the same weights (``params_from_jax``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_provider.py -q

The reference shuffles with the module-level ``random``; the port draws
from an explicit ``random.Random``.  A parity test seeds the reference's
global stream and gives the port ``random.Random(seed)``, which draws the
same sequence.  Tolerance: rows, batches and feeds exactly equal; the
trainer's per-step losses at rtol 1e-5 / atol 1e-6 (f32, the reference's
RNN tolerance).
"""

import random

import numpy as np
import pytest
import torch

import paddle_tpu.data as jdata
import paddle_tpu.data.provider as jprov
import paddle_tpu.nn as jnn
from paddle_tpu.models.text import lstm_benchmark_net as jax_net
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.trainer import events as jev
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.data as data
import paddle_tpu_torch.data.provider as tprov
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.data.provider import (CacheType, dense_vector,
                                            integer_value,
                                            integer_value_sequence, provider)
from paddle_tpu_torch.models import lstm_benchmark_net as torch_net
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.flags import FLAGS


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


def _write_file(tmp_path, name, lines):
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


# -- the reference's tests, on the port ---------------------------------


def test_list_input_types_dense_and_label(tmp_path):
    """tests/test_provider.py::test_list_input_types_dense_and_label"""
    f = _write_file(tmp_path, "t.txt",
                    [" ".join(["0.5"] * 4) + ";1", " ".join(["0.1"] * 4) + ";0"])

    @provider(input_types=[dense_vector(4), integer_value(2)],
              should_shuffle=False)
    def process(settings, filename):
        with open(filename) as fh:
            for line in fh:
                feat, lab = line.strip().split(";")
                yield [float(x) for x in feat.split()], int(lab)

    dp = process([f])
    rows = list(dp.reader()())
    assert len(rows) == 2 and rows[0][1] == 1 and len(rows[0][0]) == 4
    assert dp.slot_names == ["slot0", "slot1"]
    assert dp.feeder().types == {"slot0": "dense", "slot1": "int"}


def _vocab_hook(settings, file_list, **kw):
    vocab = {}
    for path in file_list:
        with open(path) as fh:
            for line in fh:
                for w in line.strip().split(";")[0].split():
                    vocab.setdefault(w, len(vocab))
    settings.vocab = vocab
    settings.input_types = {
        "words": integer_value_sequence(len(vocab)),
        "label": integer_value(2),
    }


def test_dict_types_init_hook_and_training(tmp_path):
    """tests/test_provider.py::test_dict_types_init_hook_and_training"""
    f = _write_file(tmp_path, "seq.txt",
                    ["the cat sat;0", "a dog ran far;1", "the dog sat;1",
                     "a cat ran;0"])

    @provider(init_hook=_vocab_hook, should_shuffle=False)
    def process(settings, filename):
        with open(filename) as fh:
            for line in fh:
                text, lab = line.strip().split(";")
                yield {"words": [settings.vocab[w] for w in text.split()],
                       "label": int(lab)}

    dp = process([f])
    assert dp.slot_names == ["words", "label"]
    V = len(dp.settings.vocab)

    nn.reset_naming()
    words = nn.data("words", size=V, is_seq=True, dtype="int32")
    label = nn.data("label", size=1, dtype="int32")
    emb = nn.embedding(words, 8)
    pool = nn.pooling(emb, pooling_type="max")
    cost = nn.classification_cost(nn.fc(pool, 2, act="linear"), label)
    tr = SGDTrainer(cost, Adam(learning_rate=0.1), seed=0, device="cpu")
    feeder = dp.feeder()
    losses = []
    for _ in range(15):
        for batch in data.batch(dp.reader(), 4)():
            losses.append(float(tr.train_batch(feeder(batch))))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def test_cache_pass_in_mem_reads_file_once(tmp_path):
    """tests/test_provider.py::test_cache_pass_in_mem_reads_file_once"""
    f = _write_file(tmp_path, "c.txt", ["1", "2", "3"])
    calls = []

    @provider(input_types=[integer_value(10)], should_shuffle=False,
              cache=CacheType.CACHE_PASS_IN_MEM)
    def process(settings, filename):
        calls.append(filename)
        with open(filename) as fh:
            for line in fh:
                yield int(line)

    dp = process([f])
    first = [r[0] for r in dp.reader()()]
    second = [r[0] for r in dp.reader()()]
    assert first == second == [1, 2, 3]
    assert len(calls) == 1  # second pass replayed from memory


def test_shuffle_pool_and_check(tmp_path):
    """tests/test_provider.py::test_shuffle_pool_and_check"""
    f = _write_file(tmp_path, "s.txt", [str(i) for i in range(50)])

    @provider(input_types=[integer_value(50)], should_shuffle=True,
              pool_size=16, rng=random.Random(0))
    def process(settings, filename):
        with open(filename) as fh:
            for line in fh:
                yield int(line)

    dp = process([f])
    rows = [r[0] for r in dp.reader()()]
    assert sorted(rows) == list(range(50)) and rows != list(range(50))

    @provider(input_types=[integer_value(3)], check=True,
              check_fail_continue=True, should_shuffle=False)
    def bad(settings, filename):
        yield 1
        yield 7  # out of range -> skipped
        yield 2

    assert [r[0] for r in bad([f]).reader()()] == [1, 2]

    @provider(should_shuffle=False)  # no input_types anywhere
    def missing(settings, filename):
        yield 1

    with pytest.raises(ConfigError):
        missing([f])


def test_calc_batch_size_cost_based_batching(tmp_path):
    """tests/test_provider.py::test_calc_batch_size_cost_based_batching:
    rows contribute calc_batch_size(row) units; can_over_batch_size picks
    include-vs-defer for the overshooting row."""
    f = _write_file(tmp_path, "cb.txt", ["x"])
    costs = {0: 3, 1: 3, 2: 5, 3: 2, 4: 7, 5: 1}

    def make(can_over):
        @provider(input_types=[integer_value(10)], should_shuffle=False,
                  calc_batch_size=lambda row: costs[row[0]],
                  can_over_batch_size=can_over)
        def process(settings, filename):
            yield from range(6)

        return process([f])

    over = [[r[0] for r in b] for b in make(True).batch_reader(6)()]
    assert over == [[0, 1], [2, 3], [4], [5]]
    no_over = [[r[0] for r in b] for b in make(False).batch_reader(6)()]
    assert no_over == [[0, 1], [2], [3], [4], [5]]
    dp = make(True)
    dp.calc_batch_size = None
    assert [len(b) for b in dp.batch_reader(4)()] == [4, 2]


def test_sparse_sequence_slots_train(tmp_path):
    """tests/test_provider.py::test_sparse_sequence_slots_train:
    provider -> feeder -> fc over a sparse sequence == fc over the
    densified per-step input."""
    from paddle_tpu_torch.data.provider import (SequenceType,
                                                sparse_non_value_slot)

    f = _write_file(tmp_path, "ss.txt", ["x"])
    DIM = 12
    seqs = [[[1, 3], [2], [5, 7, 9]],
            [[0], [11, 4]]]

    @provider(input_types=[sparse_non_value_slot(
        DIM, seq_type=SequenceType.SEQUENCE), integer_value(2)],
        should_shuffle=False)
    def process(settings, filename):
        for i, s in enumerate(seqs):
            yield s, i % 2

    dp = process([f])
    assert dp.feeder().types["slot0"] == "sparse_ids_seq"
    batch = list(dp.reader()())
    feed = dp.feeder()(batch)
    ids, nnz, lengths = feed["slot0"]
    assert ids.shape[0] == 2 and nnz.shape == ids.shape[:2]
    assert list(lengths) == [3, 2]

    nn.reset_naming()
    bags = nn.data("slot0", size=DIM, is_seq=True, sparse="binary",
                   dtype="int32")
    label = nn.data("label", size=1, dtype="int32")
    h = nn.fc(bags, 6, act="relu")
    pool = nn.pooling(h, pooling_type="max")
    cost = nn.classification_cost(nn.fc(pool, 2, act="linear"), label)
    tr = SGDTrainer(cost, Adam(learning_rate=0.1), seed=0, device="cpu")
    loss = float(tr.train_batch({"slot0": feed["slot0"],
                                 "label": np.asarray([[0], [1]])}))
    assert np.isfinite(loss)

    nn.reset_naming()
    bags2 = nn.data("slot0", size=DIM, is_seq=True, sparse="binary",
                    dtype="int32")
    out = nn.fc(bags2, 6, act="linear", bias_attr=False, name="probe")
    topo = nn.Topology(out, device="cpu")
    params, state = topo.init(0)
    with torch.no_grad():
        outs, _ = topo.apply(params, state, {"slot0": feed["slot0"]})
    y = outs["probe"].value.numpy()
    w = params["_probe.w0"].numpy()
    dense = np.zeros((2, ids.shape[1], DIM), np.float32)
    for b, row in enumerate(seqs):
        for t, bag in enumerate(row):
            for j in bag:
                dense[b, t, j] = 1.0
    want = dense @ w
    # padded timesteps are masked to zero by the fc's sequence handling
    for b, L in enumerate([3, 2]):
        np.testing.assert_allclose(y[b, :L], want[b, :L], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(y[b, L:], 0.0, atol=1e-6)


def test_sparse_sub_sequence_slot_raises():
    """tests/test_provider.py::test_sparse_sub_sequence_slot_raises"""
    from paddle_tpu_torch.data.provider import (SequenceType,
                                                sparse_non_value_slot,
                                                sparse_value_slot)

    with pytest.raises(ConfigError):
        sparse_non_value_slot(8, seq_type=SequenceType.SUB_SEQUENCE)
    with pytest.raises(ConfigError):
        sparse_value_slot(8, seq_type=SequenceType.SUB_SEQUENCE)


# -- the port against the JAX package -----------------------------------


def _corpus(tmp_path, n_files=3, rows=23, seed=0):
    """Files of ``ids;label`` lines, seeded; most rows may hold the id 40,
    one past the slots' range (for the check)."""
    rng = np.random.RandomState(seed)
    files = []
    for i in range(n_files):
        lines = [" ".join(map(str, rng.randint(0, 41 if j % 7 else 40,
                                               rng.randint(1, 18))))
                 + f";{rng.randint(0, 2)}" for j in range(rows)]
        files.append(_write_file(tmp_path, f"part{i}.txt", lines))
    return files


def _make(mod, *, dict_types=False, seed=None, **kw):
    """The same ``@provider`` through ``mod`` (the JAX package's or the
    port's provider module); the port's gets ``rng=random.Random(seed)``."""
    if seed is not None and mod is tprov:
        kw["rng"] = random.Random(seed)
    types = ([mod.integer_value_sequence(40), mod.integer_value(2)]
             if not dict_types else
             {"words": mod.integer_value_sequence(40),
              "label": mod.integer_value(2)})

    @mod.provider(input_types=types, **kw)
    def process(settings, filename):
        with open(filename) as fh:
            for line in fh:
                text, lab = line.strip().split(";")
                ids = [int(x) for x in text.split()]
                if dict_types:
                    yield {"label": int(lab), "words": ids}
                else:
                    yield ids, int(lab)

    return process


CASES = {
    "plain": dict(should_shuffle=False),
    "pool_shuffle": dict(should_shuffle=True, pool_size=10),
    "default_pool": dict(should_shuffle=True),
    "cache_shuffle": dict(should_shuffle=True,
                          cache=CacheType.CACHE_PASS_IN_MEM),
    "check_continue": dict(should_shuffle=True, pool_size=7, check=True,
                           check_fail_continue=True),
    "dict_types": dict(should_shuffle=True, pool_size=16, dict_types=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_rows_as_the_reference_pass_after_pass(case, tmp_path):
    files = _corpus(tmp_path)
    kw = CASES[case]
    jdp = _make(jprov, seed=3, **kw)(files)
    tdp = _make(tprov, seed=3, **kw)(files)
    assert tdp.slot_names == jdp.slot_names
    random.seed(3)
    want = [list(jdp.reader()()) for _ in range(3)]
    got = [list(tdp.reader()()) for _ in range(3)]
    assert got == want
    if kw.get("should_shuffle"):
        assert got[0] != got[1]            # each pass reshuffles


@pytest.mark.parametrize("can_over", [True, False])
def test_same_cost_based_batches_as_the_reference(can_over, tmp_path):
    files = _corpus(tmp_path, seed=1)
    kw = dict(should_shuffle=True, pool_size=12,
              calc_batch_size=lambda row: len(row[0]),
              can_over_batch_size=can_over)
    jdp = _make(jprov, seed=9, **kw)(files)
    tdp = _make(tprov, seed=9, **kw)(files)
    random.seed(9)
    want = list(jdp.batch_reader(40)())
    got = list(tdp.batch_reader(40)())
    assert got == want and len(got) > 5
    want = list(jdp.batch_reader(40, drop_last=True)())
    got = list(tdp.batch_reader(40, drop_last=True)())
    assert got == want


def test_a_failed_check_raises_in_both_without_continue(tmp_path):
    files = _corpus(tmp_path)
    for mod in (jprov, tprov):
        dp = _make(mod, should_shuffle=False, check=True)(files)
        with pytest.raises(AssertionError):
            list(dp.reader()())


def test_same_feeds_as_the_reference(tmp_path):
    """The providers' feeders over the same batches: the same arrays
    (the port's ``ids_seq`` through the native pad core)."""
    files = _corpus(tmp_path, seed=2)
    jdp = _make(jprov, seed=4, should_shuffle=True, pool_size=9)(files)
    tdp = _make(tprov, seed=4, should_shuffle=True, pool_size=9)(files)
    random.seed(4)
    jf, tf = jdp.feeder(), tdp.feeder(max_len=12)
    jf.max_len = 12

    def arrays(v):
        return [np.asarray(a) for a in (v if isinstance(v, tuple) else (v,))]

    for jb, tb in zip(jdata.batch(jdp.reader(), 8)(),
                      data.batch(tdp.reader(), 8)()):
        assert jb == tb
        want, got = jf(jb), tf(tb)
        assert set(got) == set(want)
        for k in want:
            for g, w in zip(arrays(got[k]), arrays(want[k]), strict=True):
                assert g.dtype == w.dtype and g.shape == w.shape, k
                np.testing.assert_array_equal(g, w)
    assert (tf.tokens_real, tf.tokens_padded) == (jf.tokens_real,
                                                   jf.tokens_padded)


def test_an_explicit_rng_makes_the_order_independent_of_the_global():
    """The port's shuffle draws from its own stream only: the global
    ``random`` neither feeds nor is moved by it."""
    def rows(rng):
        @provider(input_types=[integer_value(100)], should_shuffle=True,
                  pool_size=13, rng=rng)
        def process(settings, filename):
            yield from range(60)

        return [r[0] for r in process(["-"]).reader()()]

    random.seed(1)
    before = random.getstate()
    a = rows(random.Random(5))
    assert random.getstate() == before
    random.seed(2)
    b = rows(random.Random(5))
    assert a == b and sorted(a) == list(range(60))
    assert a != rows(random.Random(6))


V, E, H, B, T = 48, 8, 12, 6, 10


def _imdb_files(tmp_path):
    """Small imdb-like files in the provider's ``ids;label`` format."""
    rows = list(data.datasets.imdb("train", vocab_size=V, n=5 * B)())
    half = len(rows) // 2
    return [_write_file(tmp_path, f"imdb{i}.txt",
                        [" ".join(map(str, ids)) + f";{lab}"
                         for ids, lab in part])
            for i, part in enumerate((rows[:half], rows[half:]))]


def test_provider_fed_trainer_matches_the_reference(tmp_path, monkeypatch):
    """A provider (shuffle, pool, pass cache) feeding ``SGDTrainer.train``
    with Adam for 2 passes in both packages, the port starting from the
    JAX trainer's initial weights (``params_from_jax``): every step's
    loss."""
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
    files = _imdb_files(tmp_path)
    kw = dict(should_shuffle=True, pool_size=11,
              cache=CacheType.CACHE_PASS_IN_MEM, dict_types=True)
    jdp = _make(jprov, seed=7, **kw)(files)
    tdp = _make(tprov, seed=7, **kw)(files)
    assert tdp.slot_names == ["words", "label"]

    jnn.reset_naming()
    jtr = JaxTrainer(jax_net(V, emb_dim=E, hid_dim=H, num_layers=2)[0],
                     jopt.Adam(learning_rate=1e-2), seed=5)
    nn.reset_naming()
    ttr = SGDTrainer(torch_net(V, emb_dim=E, hid_dim=H, num_layers=2)[0],
                     Adam(learning_rate=1e-2), seed=5, device="cpu")
    init = nn.params_from_jax({k: np.asarray(v)
                               for k, v in jtr.params.items()}, "cpu")
    assert set(init) == set(ttr.params)
    with torch.no_grad():
        for k, v in init.items():
            ttr.params[k].copy_(v)
    jfeeder = jdp.feeder()
    jfeeder.max_len, jfeeder.buckets = T, (T,)

    def losses(tr, dp, mod, ev, feeder):
        out = []
        tr.train(mod.batch(dp.reader(), B), num_passes=2, feeder=feeder,
                 event_handler=lambda e: out.append(e.cost) if isinstance(
                     e, ev.EndIteration) else None)
        return out

    random.seed(7)
    want = losses(jtr, jdp, jdata, jev, jfeeder)
    got = losses(ttr, tdp, data, tev, tdp.feeder(max_len=T, buckets=(T,)))
    assert len(got) == len(want) == 2 * 5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
