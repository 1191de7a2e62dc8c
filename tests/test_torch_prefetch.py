"""Double-buffered async feeding in the port (``--prefetch_depth``;
``data/feeder.py::BatchPrefetcher`` and the trainer's wiring): the cases of
tests/test_prefetch.py on the port, but its timing-bound
``test_prefetch_collapses_data_wait_share``.

Semantics are loop-equivalent to serial feeding: the same training
trajectory bit for bit, reader errors keep their identity and are
attributed to the data tier, prepare/transfer errors keep theirs, the
read-ahead is bounded, ``close()`` joins the producer, and a preemption
drains at the batch boundary so the resume stays batch-exact.  The
card's side-stream copy is held in tests/test_torch_cuda.py.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.data.feeder import (BatchPrefetcher, PreparedFeed,
                                          PrepareError)
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.resilience import PreemptionHandler, ReaderError, chaos
from paddle_tpu_torch.resilience.checkpoint_io import pass_dir, read_manifest
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.trainer import events as ev
from paddle_tpu_torch.utils.flags import FLAGS


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    monkeypatch.setattr(FLAGS, "log_period", 0)
    monkeypatch.setattr(FLAGS, "save_dir", "")
    yield


def _mse_trainer(seed=0, hidden=8, size=4, **kw):
    tnn.reset_naming()
    x = tnn.data("x", size=size)
    y = tnn.data("y", size=2)
    h = tnn.fc(x, hidden, act="relu", name="h")
    cost = tnn.mse_cost(input=tnn.fc(h, 2, act="linear", name="o"), label=y)
    return SGDTrainer(cost, Adam(learning_rate=0.05), seed=seed,
                      device="cpu", **kw)


def _feeds(n=6, batch=4, size=4):
    rs = np.random.RandomState(0)
    return [{"x": rs.randn(batch, size).astype(np.float32),
             "y": rs.randn(batch, 2).astype(np.float32)} for _ in range(n)]


def _host(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


# ---------------------------------------------------------------------------
# BatchPrefetcher alone
# ---------------------------------------------------------------------------


def test_prefetcher_preserves_order_and_values():
    raw = list(range(20))
    seen = [b.feed for b in BatchPrefetcher(iter(raw),
                                            prepare=lambda r: r * 10,
                                            depth=3)]
    assert seen == [r * 10 for r in raw]


def test_prefetcher_wraps_in_prepared_feed_and_applies_transfer():
    pf = BatchPrefetcher(iter([1, 2]), prepare=lambda r: {"v": r},
                         transfer=lambda f: {**f, "t": True}, depth=2)
    items = list(pf)
    assert all(isinstance(i, PreparedFeed) for i in items)
    assert items[0].feed == {"v": 1, "t": True}


def test_prefetcher_propagates_reader_exception():
    def gen():
        yield 1
        raise IOError("disk gone")

    pf = BatchPrefetcher(iter(gen()), depth=2)
    assert next(pf).feed == 1
    with pytest.raises(IOError, match="disk gone"):
        next(pf)
    pf.close()


def test_prefetcher_wraps_prepare_and_transfer_errors():
    """A prepare or transfer failure arrives as ``PrepareError`` with the
    original exception as its cause (the reader did not raise)."""
    def bad_prepare(r):
        raise TypeError("slot 'x' has dtype object")

    pf = BatchPrefetcher(iter([1]), prepare=bad_prepare, depth=2)
    with pytest.raises(PrepareError) as info:
        next(pf)
    assert isinstance(info.value.__cause__, TypeError)
    pf.close()

    def bad_transfer(f):
        raise RuntimeError("copy failed")

    pf = BatchPrefetcher(iter([1]), transfer=bad_transfer, depth=2)
    with pytest.raises(PrepareError) as info:
        next(pf)
    assert isinstance(info.value.__cause__, RuntimeError)
    pf.close()


def test_prefetcher_bounded_readahead():
    """The producer reads at most depth (queued) + 1 (in flight) batches
    ahead of the consumer."""
    pulled = []
    gate = threading.Event()

    def gen():
        for i in range(50):
            pulled.append(i)
            yield i

    pf = BatchPrefetcher(iter(gen()), depth=2)
    gate.wait(0.3)  # let the producer run ahead as far as it can
    assert len(pulled) <= 2 + 1
    next(pf)
    gate.wait(0.2)
    assert len(pulled) <= 2 + 2
    pf.close()


def test_prefetcher_close_joins_producer_quickly():
    def slow_gen():
        for i in range(1000):
            time.sleep(0.005)
            yield i

    pf = BatchPrefetcher(iter(slow_gen()), depth=2)
    next(pf)
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 2.0
    assert not pf._thread.is_alive()


def test_prefetcher_producer_runs_without_grad():
    """The producer thread's grad mode is its own (per thread): it
    prepares under ``torch.no_grad()`` whatever the consumer's mode."""
    modes = []

    def prepare(r):
        modes.append(torch.is_grad_enabled())
        return r

    with torch.enable_grad():
        list(BatchPrefetcher(iter([1, 2]), prepare=prepare, depth=2))
    assert modes == [False, False]


# ---------------------------------------------------------------------------
# trainer integration
# ---------------------------------------------------------------------------


def test_prefetch_training_trajectory_identical(monkeypatch):
    feeds = _feeds(6)
    losses = {}
    for depth in (0, 2):
        monkeypatch.setattr(FLAGS, "prefetch_depth", depth)
        tr = _mse_trainer()
        got = []
        tr.train(lambda: iter(feeds), num_passes=2,
                 event_handler=lambda e: got.append(e.cost)
                 if isinstance(e, ev.EndIteration) else None)
        losses[depth] = (got, _host(tr.params))
        assert tr._prefetcher is None
    np.testing.assert_array_equal(losses[0][0], losses[2][0])
    for k in losses[0][1]:
        np.testing.assert_array_equal(losses[0][1][k], losses[2][1][k])


def test_prefetch_with_feeder_and_lstm_identical(monkeypatch):
    """``lstm_benchmark_net`` fed by a ``DataFeeder`` over the synthetic
    imdb stream: the feeder runs in the producer thread at depth 2, and
    the losses and parameters equal depth 0's bit for bit."""
    import paddle_tpu_torch.data as tdata
    from paddle_tpu_torch.models import lstm_benchmark_net

    reader = tdata.batch(tdata.datasets.imdb("train", vocab_size=48, n=18),
                         6)
    feeder = tdata.DataFeeder({"words": "ids_seq", "label": "int"},
                              buckets=(10,), max_len=10)
    runs = {}
    for depth in (0, 2):
        monkeypatch.setattr(FLAGS, "prefetch_depth", depth)
        tnn.reset_naming()
        cost, _ = lstm_benchmark_net(48, emb_dim=8, hid_dim=12, num_layers=2)
        tr = SGDTrainer(cost, Adam(learning_rate=1e-2), seed=3, device="cpu")
        got = []
        tr.train(reader, num_passes=2, feeder=feeder,
                 event_handler=lambda e: got.append(e.cost)
                 if isinstance(e, ev.EndIteration) else None)
        runs[depth] = (got, _host(tr.params))
    assert runs[0][0] == runs[2][0]
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], runs[2][1][k])


def test_prefetch_reader_error_attributed_to_data_tier(monkeypatch):
    monkeypatch.setattr(FLAGS, "prefetch_depth", 2)
    feeds = _feeds(4)

    def bad_reader():
        yield feeds[0]
        yield feeds[1]
        raise IOError("socket reset")

    tr = _mse_trainer()
    passes_ended = []
    with pytest.raises(ReaderError, match="socket reset"):
        tr.train(lambda: bad_reader(), num_passes=1,
                 event_handler=lambda e: passes_ended.append(e)
                 if isinstance(e, ev.EndPass) else None)
    assert passes_ended  # pass teardown reached the handlers
    assert tr._prefetcher is None  # producer joined on the error path


def test_prefetch_keeps_feeder_error_identity(monkeypatch):
    """A prepare (DataFeeder) failure keeps its own exception type, as it
    would raise from the prepare phase without prefetch."""
    monkeypatch.setattr(FLAGS, "prefetch_depth", 2)
    feeds = _feeds(4)
    calls = {"n": 0}

    def bad_feeder(batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise TypeError("slot 'x' has dtype object")
        return batch

    tr = _mse_trainer()
    with pytest.raises(TypeError, match="dtype object"):
        tr.train(lambda: iter(feeds), num_passes=1, feeder=bad_feeder)
    assert tr._prefetcher is None              # producer joined


def test_prefetch_attaches_after_resume_fast_forward(tmp_path, monkeypatch):
    """The prefetcher is built after the skip fast-forward, so a resume
    never prepares the batches the skip discards."""
    monkeypatch.setattr(FLAGS, "prefetch_depth", 2)
    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path))
    feeds = _feeds(6)

    def reader():
        return iter(feeds)

    tr = _mse_trainer()
    h = PreemptionHandler()
    tr.train(reader, num_passes=2, preemption=h,
             event_handler=chaos.preempt_at(h, batch=3, pass_id=0))
    assert tr.preempted

    prepared = []

    def counting_feeder(batch):
        prepared.append(1)
        return batch

    tr2 = _mse_trainer()
    tr2.train(reader, num_passes=1, resume="auto", feeder=counting_feeder)
    # 6 batches a pass; the preemption polled at the batch-4 boundary, so
    # 4 are skipped on resume: only the 2 stepped batches were prepared
    assert len(prepared) == 2, prepared
    assert tr2.resume_replayed_batches == 4


def test_prefetch_preemption_drains_clean_and_resumes_batch_exact(
        tmp_path, monkeypatch):
    """Preemption mid-pass with prefetch on: no torn batch (the
    checkpoint's next_batch counts stepped batches, not read-ahead), and
    the resumed run matches the uninterrupted one bit for bit."""
    monkeypatch.setattr(FLAGS, "prefetch_depth", 2)
    feeds = _feeds(6)

    def reader():
        return iter(feeds)

    tr_a = _mse_trainer()
    tr_a.train(reader, num_passes=3)
    final_a = _host(tr_a.params)

    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path))
    tr_b = _mse_trainer()
    h = PreemptionHandler()
    tr_b.train(reader, num_passes=3, preemption=h,
               event_handler=chaos.preempt_at(h, batch=2, pass_id=1))
    assert tr_b.preempted
    assert tr_b._prefetcher is None            # drained at the boundary
    m = read_manifest(pass_dir(str(tmp_path), 1))
    assert m["meta"]["preempted"] and m["meta"]["next_batch"] == 3

    tr_c = _mse_trainer()
    tr_c.train(reader, num_passes=3, resume="auto")
    for k in final_a:
        np.testing.assert_array_equal(final_a[k],
                                      tr_c.params[k].detach().numpy())


def test_cli_prefetch_depth_equals_depth_zero(tmp_path, monkeypatch):
    """``--prefetch_depth=2`` through the command line: the checkpoint
    after two passes equals ``--prefetch_depth=0``'s bit for bit."""
    from paddle_tpu_torch.__main__ import main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = os.path.join(root, "tests", "torch_textclf_conf.py")
    for k, v in {"VOCAB": 48, "EMB": 8, "HID": 12, "BATCH": 6, "T": 10,
                 "N": 18, "TEST_N": 12}.items():
        monkeypatch.setenv(f"TORCH_TEXTCLF_{k}", str(v))
    keep = FLAGS.as_dict()
    try:
        for depth in (0, 2):
            assert main([f"--config={conf}", "--device=cpu", "--job=train",
                         "--num_passes=2", f"--prefetch_depth={depth}",
                         f"--save_dir={tmp_path / str(depth)}"]) == 0
            for k, v in keep.items():
                setattr(FLAGS, k, v)
    finally:
        for k, v in keep.items():
            setattr(FLAGS, k, v)
    for fname in ("params.npz", "opt_state.npz"):
        a = np.load(tmp_path / "0" / "pass-00001" / fname)
        b = np.load(tmp_path / "2" / "pass-00001" / fname)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
