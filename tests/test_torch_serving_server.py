"""The port's ``InferenceServer`` (paddle_tpu_torch/serving/server.py) on
the CPU, where the kernels run their plain versions.

Three parts:

- the behaviour list of ``tests/test_serving_slots.py`` (generation mode
  over a toy LM whose readout is ``LogitsReadout``, so K8's plain version)
  and of ``tests/test_serving.py`` (bucket mode over fake callables), each
  test opening with the reference test it mirrors;
- parity with the JAX package: the same requests served through the
  reference's server and the port's, on the toy LM and on the flagship
  ``Seq2SeqAttention`` at a tiny width, token ids identical and scores
  within rtol 1e-5 / atol 1e-6 (``tests/test_rnn_fused.py``'s f32
  tolerance);
- the options the port does not have yet raise ``ConfigError`` naming
  their ROADMAP.md item (items 7 and 9); item 2's decode-speed options
  are accepted.

Every test runs under a hard ``signal.alarm``, and every server is closed
in a ``with`` block or a ``finally``, as the reference's serving tests do.
"""

import gc
import signal
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.decode import beam_decode
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (CircuitOpenError, DeadlineExceeded,
                                      InferenceFailed, InferenceServer,
                                      InvalidRequestError, ServerClosed,
                                      ServingError, ShedError, SlotScheduler,
                                      WorkerCrashed, batch_bucket)
from paddle_tpu_torch.serving.batching import (Request, ServingFuture,
                                               canonicalize_feed,
                                               merge_feeds)
from paddle_tpu_torch.utils.error import ConfigError
from torch_serving_toy import H, K, ToyLM, jax_toy_lm, toy_params

HARD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def hard_timeout():
    def _abort(signum, frame):
        raise RuntimeError(f"server test exceeded {HARD_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(HARD_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


def _feed(rng, rows=1, bias=0.0):
    return {"h": rng.randn(rows, H).astype(np.float32),
            "eos_bias": np.full((rows, 1), bias, np.float32)}


def _request(feed, *, max_len=None, deadline=None, t_submit=0.0):
    canon, rows, sig = canonicalize_feed(feed)
    return Request(feed=canon, rows=rows, signature=sig,
                   future=ServingFuture(), deadline=deadline,
                   t_submit=t_submit, max_len=max_len)


def _solo(backend, feed, max_len):
    """The oracle: the SAME request through the whole-batch engine."""
    with torch.no_grad():
        state0 = backend.prefill(feed)
        toks, scores = beam_decode(
            backend.step_fn, backend.readout, state0,
            batch_size=int(np.asarray(feed["h"]).shape[0]),
            beam_size=backend.beam_size, vocab_size=backend.vocab_size,
            max_len=max_len, bos=backend.bos, eos=backend.eos)
    return toks.numpy(), scores.numpy()


def _drain(sched, entries):
    results = {}
    while sched.occupied() or len(results) < len(entries):
        for req, out, _steps in sched.harvest():
            results[id(req)] = out
        if sched.occupied():
            sched.step()
    return results


def _gen_server(be, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("batch_delay_ms", 0.0)
    kw.setdefault("max_queue", 32)
    kw.setdefault("default_deadline_ms", 60000.0)
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("max_restart_backoff_s", 0.05)
    return InferenceServer(be, mode="generation", **kw)


def _wait(cond, timeout=10.0, step=0.005):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(step)
    return False


# ---------------------------------------------------------------------------
# tests/test_serving_slots.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["forward", "reversed"],
                         ids=["admit_in_order", "admit_reversed"])
def test_slot_outputs_bit_identical_to_solo_any_admission_order(rng, order):
    """Mirrors tests/test_serving_slots.py::
    test_slot_outputs_bit_identical_to_solo_any_admission_order: every
    request's tokens and scores equal a solo beam_decode bit for bit, in
    any admission order, with a never-EOS resident, through 2 slots."""
    be = ToyLM(rng, max_len=10)
    feeds = [_feed(rng) for _ in range(5)]
    limits = [6, 10, 4, 10, 7]
    feeds[1] = chaos.straggler_request(feeds[1])    # never-EOS resident
    reqs = [_request(f, max_len=l) for f, l in zip(feeds, limits)]
    if order == "reversed":
        reqs, feeds, limits = reqs[::-1], feeds[::-1], limits[::-1]

    sched = SlotScheduler(be, slots=2)
    results = {}
    pending = list(reqs)
    while pending or sched.occupied():
        for req, out, _ in sched.harvest():
            results[id(req)] = out
        while pending and sched.free_count() >= pending[0].rows:
            sched.admit([pending.pop(0)])
        if sched.occupied():
            sched.step()

    assert len(results) == len(reqs)
    for req, feed, limit in zip(reqs, feeds, limits):
        solo_t, solo_s = _solo(be, feed, limit)
        got = results[id(req)]
        np.testing.assert_array_equal(got["tokens"], solo_t)
        np.testing.assert_array_equal(got["scores"], solo_s)
    assert sched.recycled == len(reqs)
    assert sched.free_count() == 2


def test_capacity_one_degenerate_table(rng):
    """Mirrors tests/test_serving_slots.py::
    test_capacity_one_degenerate_table: S=1, pure sequential recycling,
    still bit-identical."""
    be = ToyLM(rng, max_len=8)
    feeds = [_feed(rng) for _ in range(4)]
    reqs = [_request(f, max_len=8) for f in feeds]
    sched = SlotScheduler(be, slots=1)
    results = {}
    pending = list(reqs)
    while pending or sched.occupied():
        for req, out, _ in sched.harvest():
            results[id(req)] = out
        if pending and sched.free_count():
            sched.admit([pending.pop(0)])
        if sched.occupied():
            sched.step()
    for req, feed in zip(reqs, feeds):
        solo_t, solo_s = _solo(be, feed, 8)
        np.testing.assert_array_equal(results[id(req)]["tokens"], solo_t)
        np.testing.assert_array_equal(results[id(req)]["scores"], solo_s)
    assert sched.recycled == 4


def test_multirow_request_spans_slots_and_pad_rows_never_surface(rng):
    """Mirrors tests/test_serving_slots.py::
    test_multirow_request_spans_slots_and_pad_rows_never_surface."""
    be = ToyLM(rng, max_len=6)
    feed = _feed(rng, rows=3)
    req = _request(feed, max_len=6)
    merged, slices, rows = merge_feeds([req], 4)
    assert rows == 3 and slices == [(0, 3)]
    assert np.asarray(merged["h"]).shape[0] == 4          # padded bucket
    np.testing.assert_array_equal(merged["h"][3], merged["h"][2])  # replica

    sched = SlotScheduler(be, slots=4)
    sched.admit([req])
    assert sched.occupied() == 3          # the pad row took no slot
    results = _drain(sched, {id(req): req})
    out = results[id(req)]
    assert out["tokens"].shape == (3, K, 6)   # 3 real rows, no replica
    solo_t, solo_s = _solo(be, feed, 6)
    np.testing.assert_array_equal(out["tokens"], solo_t)
    np.testing.assert_array_equal(out["scores"], solo_s)


def test_straggler_request_does_not_hostage_short_requests(rng):
    """Mirrors tests/test_serving_slots.py::
    test_straggler_request_does_not_hostage_short_requests: shorts beside
    a never-EOS request decoding to the full table depth succeed within
    their deadlines and before the straggler."""
    be = ToyLM(rng, max_len=200, eos_boost=8.0)   # shorts finish in ~1 step
    srv = _gen_server(be, slots=3)
    srv.start()
    with srv:
        done_at = {}
        straggler = chaos.straggler_request(_feed(rng))
        f_strag = srv.submit(straggler, deadline_ms=120000.0)
        shorts = [srv.submit(_feed(rng), deadline_ms=15000.0)
                  for _ in range(6)]
        for i, f in enumerate(shorts):
            assert f.error(60) is None, f"short {i} missed its deadline"
            done_at[i] = time.monotonic()
        t_shorts_done = max(done_at.values())
        assert not f_strag.done(), \
            "straggler finished before the shorts — not a straggler"
        assert f_strag.error(120) is None
        t_straggler_done = time.monotonic()
        assert t_shorts_done < t_straggler_done
        out = f_strag.result(0)
        assert out["tokens"].shape == (1, K, 200)
        assert not np.any(out["tokens"] == be.eos)
        hz = srv.healthz()
    assert hz["counters"]["completed"] == 7
    assert hz["counters"]["slot_evicted"] == 0
    assert hz["slots"]["recycled"] >= 7


def test_deadline_expired_slot_evicted_mid_generation(rng):
    """Mirrors tests/test_serving_slots.py::
    test_deadline_expired_slot_evicted_mid_generation."""
    be = ToyLM(rng, max_len=5000)
    srv = _gen_server(be, slots=1)
    srv.start()
    with srv:
        strag = chaos.straggler_request(_feed(rng))
        f = srv.submit(strag, deadline_ms=30.0)     # expires mid-decode
        err = f.error(60)
        assert isinstance(err, DeadlineExceeded), err
        assert "mid-generation" in str(err)
        ok = srv.submit(_feed(rng), max_len=4, deadline_ms=60000.0)
        assert ok.error(60) is None
        hz = srv.healthz()
    assert hz["counters"]["slot_evicted"] == 1
    assert hz["counters"]["completed"] == 1


def test_scheduler_evict_expired_releases_all_rows(rng):
    """Mirrors tests/test_serving_slots.py::
    test_scheduler_evict_expired_releases_all_rows."""
    be = ToyLM(rng, max_len=50)
    sched = SlotScheduler(be, slots=4, clock=lambda: 100.0)
    req = _request(chaos.straggler_request(_feed(rng, rows=2)),
                   deadline=100.5)
    sched.admit([req])
    sched.step()
    assert sched.occupied() == 2
    assert sched.evict_expired(100.4) == []       # not expired yet
    evicted = sched.evict_expired(101.0)
    assert len(evicted) == 1 and evicted[0][0] is req and evicted[0][1] == 2
    assert sched.occupied() == 0 and sched.free_count() == 4
    assert sched.evict_expired(102.0) == []       # idempotent


def test_resident_requests_and_view_follow_the_table(rng):
    """``resident_requests`` (the crash handler's in-flight set) and
    ``resident_view`` (slots and steps since admission, host bookkeeping
    only) track admission, steps and harvest."""
    be = ToyLM(rng, max_len=6)
    sched = SlotScheduler(be, slots=4)
    a = _request(chaos.straggler_request(_feed(rng, rows=2)), max_len=6)
    b = _request(chaos.straggler_request(_feed(rng)), max_len=3)
    sched.admit([a])
    sched.step()
    sched.admit([b])
    sched.step()
    assert sched.resident_requests() == [a, b]
    view = {id(r): (slots, n) for r, slots, n in sched.resident_view()}
    assert view == {id(a): ([0, 1], 2), id(b): ([2], 1)}
    results = _drain(sched, {id(a): a, id(b): b})
    assert set(results) == {id(a), id(b)}
    assert sched.resident_requests() == [] and sched.resident_view() == []


def test_expired_queued_request_swept_while_table_full(rng):
    """Mirrors tests/test_serving_slots.py::
    test_expired_queued_request_swept_while_table_full."""
    be = ToyLM(rng, max_len=2000)
    srv = _gen_server(be, slots=1)
    srv.start()
    with srv:
        f_strag = srv.submit(chaos.straggler_request(_feed(rng)),
                             deadline_ms=120000.0)
        f_queued = srv.submit(_feed(rng), deadline_ms=50.0)
        err = f_queued.error(10)
        assert isinstance(err, DeadlineExceeded), err
        assert "queued" in str(err)
        assert not f_strag.done()
        assert srv.healthz()["counters"]["slot_evicted"] == 0
        assert f_strag.error(120) is None


def test_overlong_source_rejected_typed_without_feeding_breaker(rng):
    """Mirrors tests/test_serving_slots.py::
    test_overlong_source_rejected_typed_without_feeding_breaker, on the
    port's flagship."""
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.serving import Seq2SeqSlotBackend

    m = Seq2SeqAttention(src_vocab=64, trg_vocab=64, emb_dim=8, enc_dim=8,
                         dec_dim=8, att_dim=8, device="cpu")
    params = m.init(seed=0)
    with pytest.raises(ValueError, match="feeder bucket"):
        Seq2SeqSlotBackend(m, params, src_len=4, beam_size=2, max_len=3)
    be = Seq2SeqSlotBackend(m, params, src_len=8, beam_size=2, max_len=3)
    srv = _gen_server(be, slots=1, breaker_threshold=2)
    srv.start()
    with srv:
        def src_feed(t):
            return {"src": (np.full((1, t), 3, np.int32),
                            np.asarray([t], np.int32))}

        for _ in range(3):          # would trip threshold=2 if breaker-fed
            err = srv.submit(src_feed(9)).error(60)   # buckets to T=16 > 8
            assert isinstance(err, InvalidRequestError), err
            assert "src_len" in str(err)
        assert srv.breaker.snapshot()["consecutive_failures"] == 0
        assert srv.breaker.state == "closed"
        assert srv.submit(src_feed(6)).error(60) is None   # healthy traffic
    assert srv.metrics.count("invalid_request") == 3
    assert srv.metrics.count("completed") == 1


def test_nan_poisoned_request_isolated_to_its_own_slot(rng):
    """Mirrors tests/test_serving_slots.py::
    test_nan_poisoned_request_isolated_to_its_own_slot."""
    be = ToyLM(rng, max_len=6)
    srv = _gen_server(be, slots=4)
    srv.start()
    with srv:
        healthy_feed = _feed(rng)
        f_bad = srv.submit(chaos.nan_feed(_feed(rng)), max_len=6)
        f_ok = srv.submit(healthy_feed, max_len=6)
        err = f_bad.error(60)
        assert isinstance(err, InferenceFailed) and "non-finite" in str(err)
        assert f_ok.error(60) is None
        solo_t, solo_s = _solo(be, healthy_feed, 6)
        out = f_ok.result(0)
        np.testing.assert_array_equal(out["tokens"], solo_t)
        np.testing.assert_array_equal(out["scores"], solo_s)
        assert srv.metrics.count("inference_failed") == 1


def test_worker_kill_mid_step_resets_table_and_recovers(rng):
    """Mirrors tests/test_serving_slots.py::
    test_worker_kill_mid_step_resets_table_and_recovers."""
    be = ToyLM(rng, max_len=50)
    srv = _gen_server(be, slots=2, max_restarts=3)
    srv.start()
    with srv:
        chaos.kill_worker(srv)
        f = srv.submit(chaos.straggler_request(_feed(rng)))
        err = f.error(60)
        assert isinstance(err, WorkerCrashed), err
        assert srv.metrics.count("worker_crashed") >= 1
        assert _wait(lambda: srv.supervisor.alive())
        feed = _feed(rng)
        f2 = srv.submit(feed, max_len=5)
        assert f2.error(60) is None
        solo_t, solo_s = _solo(be, feed, 5)
        np.testing.assert_array_equal(f2.result(0)["tokens"], solo_t)
        np.testing.assert_array_equal(f2.result(0)["scores"], solo_s)
        assert srv.healthz()["slots"]["occupied"] == 0


def test_hung_admit_fails_popped_batch_typed_and_replaces_worker(rng):
    """Mirrors tests/test_serving_slots.py::
    test_hung_admit_fails_popped_batch_typed_and_replaces_worker: the
    popped batch fails typed, the woken stale worker does not write into
    the fresh table (admit's commit guard), the replacement serves."""
    release = threading.Event()
    woke = threading.Event()
    hang_now = [False]
    be = ToyLM(rng, max_len=8)
    srv = _gen_server(be, slots=2, hang_timeout_s=0.1,
                      restart_backoff_s=0.01)
    srv.start()
    orig_admit = srv._scheduler.admit

    def hanging_admit(reqs, **kw):
        if hang_now[0]:
            hang_now[0] = False
            release.wait(30)          # the device-wedge model
            woke.set()
        return orig_admit(reqs, **kw)

    srv._scheduler.admit = hanging_admit
    with srv:
        try:
            hang_now[0] = True
            f = srv.submit(_feed(rng), max_len=4)
            err = f.error(60)
            assert isinstance(err, WorkerCrashed) and "hung" in str(err), err
            assert _wait(lambda: srv.supervisor.alive())
            release.set()                 # the abandoned thread wakes...
            assert woke.wait(10)
            time.sleep(0.05)              # ...and admit discards its write
            feed = _feed(rng)
            f2 = srv.submit(feed, max_len=4)
            assert f2.error(60) is None
            solo_t, _ = _solo(be, feed, 4)
            np.testing.assert_array_equal(f2.result(0)["tokens"], solo_t)
            hz = srv.healthz()
            assert hz["slots"]["occupied"] == 0
            assert hz["counters"]["worker_crashed"] >= 1
        finally:
            release.set()


def test_degradation_ladder_caps_decode_budget(rng):
    """Mirrors tests/test_serving_slots.py::
    test_degradation_ladder_caps_decode_budget."""
    be = ToyLM(rng, max_len=64)
    srv = _gen_server(be, slots=1, max_queue=16,
                      degrade=[{"max_len": 2}], degrade_at=[2])
    srv.start()
    with srv:
        stragglers = [srv.submit(chaos.straggler_request(_feed(rng)))
                      for _ in range(8)]
        outs = []
        for f in stragglers:
            err = f.error(120)
            assert err is None or isinstance(err, ServingError)
            if err is None:
                outs.append(f.result(0)["tokens"].shape[2])
        hz = srv.healthz()
    assert hz["counters"]["degraded"] > 0
    assert any(l == 2 for l in outs), outs


def test_oversized_and_overlong_requests_rejected_typed(rng):
    """Mirrors tests/test_serving_slots.py::
    test_oversized_and_overlong_requests_rejected_typed."""
    be = ToyLM(rng, max_len=8)
    srv = _gen_server(be, slots=2)
    srv.start()
    with srv:
        with pytest.raises(InvalidRequestError, match="split the request"):
            srv.submit(_feed(rng, rows=3))      # rows > slots
        with pytest.raises(InvalidRequestError, match="max_len"):
            srv.submit(_feed(rng), max_len=9)   # beyond the table depth
        with pytest.raises(InvalidRequestError, match="zero-row"):
            srv.submit(_feed(rng, rows=0))
        assert srv.submit(_feed(rng, rows=2), max_len=8).error(60) is None


def test_healthz_surfaces_slot_occupancy_and_recycling(rng):
    """Mirrors tests/test_serving_slots.py::
    test_healthz_surfaces_slot_occupancy_and_recycling."""
    be = ToyLM(rng, max_len=6)
    srv = _gen_server(be, slots=2)
    srv.start()
    with srv:
        for _ in range(4):
            assert srv.submit(_feed(rng), max_len=4).error(60) is None
        hz = srv.healthz()
    assert hz["mode"] == "generation"
    assert hz["slots"]["capacity"] == 2
    assert hz["slots"]["admitted"] == 4
    assert hz["slots"]["recycled"] == 4
    assert hz["counters"]["gen_steps"] == hz["slots"]["steps"] > 0
    assert hz["counters"]["slot_recycled"] == 4
    assert 0 < hz["mean_slot_occupancy"] <= 1.0
    assert hz["mean_request_steps"] is not None


# ---------------------------------------------------------------------------
# tests/test_serving.py on the port (bucket mode over fake callables)
# ---------------------------------------------------------------------------


def _bfeed(value, rows=1, dim=4):
    return {"x": np.full((rows, dim), value, np.float32)}


def _echo_model(sleep_s=0.0, log=None):
    """Fake backend: y = x + 1; optionally records batch row counts."""

    def model(feed):
        if log is not None:
            log.append(np.asarray(feed["x"]).shape[0])
        if sleep_s:
            time.sleep(sleep_s)
        return {"y": np.asarray(feed["x"]) + 1.0}

    return model


def _server(model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_delay_ms", 2.0)
    kw.setdefault("max_queue", 16)
    kw.setdefault("default_deadline_ms", 5000.0)
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("max_restart_backoff_s", 0.05)
    return InferenceServer(model, **kw)


def test_roundtrip_batches_and_metrics():
    """Mirrors tests/test_serving.py::test_roundtrip_batches_and_metrics;
    the callable returns a torch tensor, which the worker copies to the
    host."""
    log = []
    echo = _echo_model(log=log)
    srv = _server(lambda feed: {"y": torch.from_numpy(echo(feed)["y"])},
                  batch_delay_ms=10.0)
    srv.start(warmup_feed=_bfeed(0.0))
    with srv:
        futs = [srv.submit(_bfeed(float(i))) for i in range(10)]
        for i, f in enumerate(futs):
            out = f.result(10)
            np.testing.assert_allclose(out["y"], np.full((1, 4), i + 1.0))
        hz = srv.healthz()
    assert hz["counters"]["completed"] == 10
    assert hz["counters"]["accepted"] == 10
    assert hz["p50_ms"] is not None and hz["p99_ms"] is not None
    served = log[3:]
    assert all(b in (1, 2, 4) for b in served), served
    assert any(b > 1 for b in served), served


def test_not_ready_before_start_and_close_drains_typed():
    """Mirrors tests/test_serving.py::
    test_not_ready_before_start_and_close_drains_typed."""
    srv = _server(_echo_model(sleep_s=0.05))
    try:
        with pytest.raises(ShedError, match="warming"):
            srv.submit(_bfeed(0.0))
        srv.start(warmup=False)
        assert srv.ready
        futs = [srv.submit(_bfeed(float(i))) for i in range(8)]
    finally:
        srv.close()
    errs = [f.error(10) for f in futs]
    assert all(e is None or isinstance(e, ServingError) for e in errs)
    assert any(isinstance(e, ServerClosed) for e in errs)
    with pytest.raises(ServerClosed):
        srv.submit(_bfeed(0.0))


def test_mixed_shapes_batch_by_signature():
    """Mirrors tests/test_serving.py::test_mixed_shapes_batch_by_signature."""
    shapes = []

    def model(feed):
        v = feed["w"][0] if isinstance(feed["w"], tuple) else feed["w"]
        shapes.append(np.asarray(v).shape)
        return {"y": np.zeros((np.asarray(v).shape[0], 1), np.float32)}

    srv = _server(model, batch_delay_ms=20.0)
    srv.start(warmup=False)
    with srv:
        fs = [srv.submit({"w": (np.zeros((1, t), np.int32),
                                np.full((1,), t, np.int32))})
              for t in (9, 13, 40, 11)]
        for f in fs:
            assert f.error(10) is None
    assert sorted(s[1] for s in shapes) == [16, 64], shapes


def test_oversized_request_rejected_at_admission():
    """Mirrors tests/test_serving.py::
    test_oversized_request_rejected_at_admission."""
    srv = _server(_echo_model(), max_batch=4)
    srv.start(warmup=False)
    with srv:
        with pytest.raises(InvalidRequestError, match="split the request"):
            srv.submit(_bfeed(0.0, rows=5))
        assert issubclass(InvalidRequestError, ServingError)
        assert issubclass(InvalidRequestError, ValueError)
        assert srv.submit(_bfeed(1.0, rows=4)).error(10) is None


def test_zero_row_request_never_reaches_raw_backend():
    """Mirrors tests/test_serving.py::
    test_zero_row_request_never_reaches_raw_backend."""
    calls = []
    srv = _server(_echo_model(log=calls), max_batch=4)
    srv.start(warmup=False)
    with srv:
        with pytest.raises(InvalidRequestError, match="zero-row"):
            srv.submit(_bfeed(0.0, rows=0))
        assert calls == []
        assert srv.breaker.snapshot()["consecutive_failures"] == 0


def test_close_with_batch_in_flight_resolves_typed():
    """Mirrors tests/test_serving.py::
    test_close_with_batch_in_flight_resolves_typed."""
    release = threading.Event()

    def model(feed):
        release.wait(30)
        return {"y": np.asarray(feed["x"])}

    srv = _server(model, max_batch=1, batch_delay_ms=0.0)
    try:
        srv.start(warmup=False)
        fut = srv.submit(_bfeed(0.0))
        _wait(lambda: srv.queue.depth() == 0, timeout=5.0)  # in flight
        srv.close(join_timeout=0.2)
        err = fut.error(10)
        assert isinstance(err, ServerClosed), err
    finally:
        release.set()
        srv.close()



class _Echo:
    """A callable backend a weak reference can follow: y = x + 1."""

    def __call__(self, feed):
        return {"y": np.asarray(feed["x"]) + 1.0}


@pytest.mark.parametrize("mode", ["generation", "bucket"])
def test_closed_server_frees_its_backend_without_the_cycle_collector(
        rng, mode):
    """The port's own: a closed server, its worker supervisor and its slot
    table form no reference cycle, so dropping the server frees its
    backend (the model's parameters) at once, with the cycle collector
    off."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        if mode == "generation":
            backend, feed = ToyLM(rng, max_len=6), _feed(rng)
            srv = _gen_server(backend)
        else:
            backend, feed = _Echo(), _bfeed(0.0)
            srv = _server(backend)
        with srv:
            srv.start(warmup_feed=feed)
            srv.submit(feed).result(10)
        ref = weakref.ref(backend)
        del srv, backend
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()

def test_warmup_primes_non_power_of_two_max_batch():
    """Mirrors tests/test_serving.py::
    test_warmup_primes_non_power_of_two_max_batch."""
    log = []
    srv = _server(_echo_model(log=log), max_batch=12)
    srv.start(warmup_feed=_bfeed(0.0))
    with srv:
        assert log == [1, 2, 4, 8, 12]
        assert batch_bucket(9, 12) == 12
        assert srv.metrics.count("warmup_compiles") == 5


def test_warmup_from_multirow_feed_still_primes_small_buckets():
    """Mirrors tests/test_serving.py::
    test_warmup_from_multirow_feed_still_primes_small_buckets."""
    log = []
    srv = _server(_echo_model(log=log), max_batch=8)
    srv.start(warmup_feed=_bfeed(0.0, rows=4))
    with srv:
        assert log == [1, 2, 4, 8]


def test_warmup_feed_list_primes_every_sequence_bucket():
    """Mirrors tests/test_serving.py::
    test_warmup_feed_list_primes_every_sequence_bucket."""
    shapes = []

    def model(feed):
        shapes.append(feed["w"][0].shape)
        return {"y": np.zeros((feed["w"][0].shape[0], 1), np.float32)}

    srv = _server(model, max_batch=2)
    feeds = [{"w": (np.zeros((1, t), np.int32), np.full((1,), t, np.int32))}
             for t in (8, 40)]
    srv.start(warmup_feed=feeds)
    with srv:
        assert set(shapes) == {(1, 8), (2, 8), (1, 64), (2, 64)}


def test_queue_overflow_sheds_immediately():
    """Mirrors tests/test_serving.py::test_queue_overflow_sheds_immediately."""
    srv = _server(_echo_model(sleep_s=0.05), max_queue=4, max_batch=1,
                  batch_delay_ms=0.0)
    srv.start(warmup=False)
    with srv:
        futs = []
        shed = 0
        for i in range(40):
            try:
                futs.append(srv.submit(_bfeed(float(i))))
            except ShedError:
                shed += 1
        t0 = time.monotonic()
        with pytest.raises((ShedError, DeadlineExceeded)):
            for _ in range(10):
                srv.submit(_bfeed(0.0))
        assert time.monotonic() - t0 < 1.0
        assert shed > 0
        for f in futs:
            assert f.error(30) is None or isinstance(f.error(0), ServingError)


def test_infeasible_deadline_rejected_at_admission():
    """Mirrors tests/test_serving.py::
    test_infeasible_deadline_rejected_at_admission."""
    srv = _server(_echo_model(sleep_s=0.02))
    srv.start(warmup=False)
    with srv:
        srv.infer(_bfeed(0.0), deadline_ms=5000)  # warm the service EMA
        with pytest.raises(DeadlineExceeded, match="infeasible"):
            srv.submit(_bfeed(0.0), deadline_ms=0.01)
        assert srv.metrics.count("deadline_infeasible") == 1


def test_deadline_expires_in_queue_typed():
    """Mirrors tests/test_serving.py::test_deadline_expires_in_queue_typed."""
    srv = _server(_echo_model(sleep_s=0.05), max_batch=1, batch_delay_ms=0.0,
                  max_queue=32)
    srv.start(warmup=False)
    with srv:
        futs = [srv.submit(_bfeed(float(i)), deadline_ms=60.0)
                for i in range(8)]
        errs = [f.error(30) for f in futs]
    assert all(e is None or isinstance(e, DeadlineExceeded) for e in errs)
    assert any(isinstance(e, DeadlineExceeded) for e in errs)


def test_slow_client_never_starves():
    """Mirrors tests/test_serving.py::test_slow_client_never_starves."""
    srv = _server(_echo_model(), max_queue=4)
    srv.start(warmup=False)
    with srv:
        feeds = chaos.slow_client((_bfeed(float(i)) for i in range(6)),
                                  delay_s=0.01)
        for f in feeds:
            assert srv.submit(f).error(10) is None
        assert srv.metrics.count("shed") == 0


def test_latency_injection_surfaces_as_deadline_exceeded():
    """Mirrors tests/test_serving.py::
    test_latency_injection_surfaces_as_deadline_exceeded."""
    model = chaos.latency_injection(_echo_model(), at=0, times=1,
                                    delay_s=0.25)
    srv = _server(model, batch_delay_ms=0.0)
    srv.start(warmup=False)
    with srv:
        err = srv.submit(_bfeed(0.0), deadline_ms=80.0).error(30)
        assert isinstance(err, DeadlineExceeded), err
        assert srv.metrics.count("deadline_expired") == 1
        assert srv.submit(_bfeed(1.0), deadline_ms=2000.0).error(30) is None


def test_nan_poison_batch_typed_error_counts_toward_breaker():
    """Mirrors tests/test_serving.py::
    test_nan_poison_batch_typed_error_counts_toward_breaker."""
    srv = _server(_echo_model(), breaker_threshold=3)
    srv.start(warmup=False)
    with srv:
        err = srv.submit(chaos.nan_feed(_bfeed(1.0))).error(30)
        assert isinstance(err, InferenceFailed) and "non-finite" in str(err)
        assert srv.breaker.snapshot()["consecutive_failures"] == 1
        assert srv.submit(_bfeed(1.0)).error(30) is None
        assert srv.breaker.snapshot()["consecutive_failures"] == 0


def test_breaker_trips_fails_fast_then_half_open_recovers():
    """Mirrors tests/test_serving.py::
    test_breaker_trips_fails_fast_then_half_open_recovers; the cooldown is
    read from an injected clock."""
    now = [0.0]
    model = chaos.crash_calls(_echo_model(), at=0, times=3)
    srv = _server(model, max_batch=1, batch_delay_ms=0.0,
                  breaker_threshold=3, breaker_cooldown_s=0.1,
                  default_deadline_ms=0.0, clock=lambda: now[0])
    srv.start(warmup=False)
    with srv:
        errs = [srv.submit(_bfeed(float(i))).error(30) for i in range(3)]
        assert all(isinstance(e, InferenceFailed) for e in errs)
        assert srv.breaker.state == "open"
        t0 = time.monotonic()
        with pytest.raises(CircuitOpenError):
            srv.submit(_bfeed(9.0))
        assert time.monotonic() - t0 < 0.5  # fail-fast, not queued to death
        assert srv.metrics.count("breaker_trips") == 1
        now[0] = 0.15  # past the cooldown: half-open admits a probe
        assert srv.submit(_bfeed(5.0)).error(30) is None
        assert srv.breaker.state == "closed"
        assert srv.submit(_bfeed(6.0)).error(30) is None


def test_worker_kill_mid_batch_restarts_within_backoff_budget():
    """Mirrors tests/test_serving.py::
    test_worker_kill_mid_batch_restarts_within_backoff_budget."""
    srv = _server(_echo_model(), restart_backoff_s=0.01, max_restarts=3)
    srv.start(warmup=False)
    with srv:
        chaos.kill_worker(srv)
        err = srv.submit(_bfeed(0.0)).error(30)
        assert isinstance(err, WorkerCrashed), err
        assert srv.metrics.count("worker_crashed") == 1
        assert _wait(lambda: srv.supervisor.alive(), timeout=10.0)
        assert srv.supervisor.restarts == 1
        assert srv.submit(_bfeed(2.0)).error(30) is None
        assert srv.healthz()["worker"]["alive"]


def test_worker_restart_budget_exhaustion_fails_server_typed():
    """Mirrors tests/test_serving.py::
    test_worker_restart_budget_exhaustion_fails_server_typed."""
    srv = _server(_echo_model(), restart_backoff_s=0.005, max_restarts=1)
    srv.start(warmup=False)
    with srv:
        for _ in range(2):  # budget is 1 restart: second kill exhausts it
            chaos.kill_worker(srv)
            err = srv.submit(_bfeed(0.0)).error(30)
            assert isinstance(err, WorkerCrashed)
            _wait(lambda: srv.supervisor.alive(), timeout=5.0)
        assert _wait(lambda: not srv.ready, timeout=10.0)
        with pytest.raises(ServerClosed, match="budget"):
            srv.submit(_bfeed(0.0))


def test_hung_worker_detected_and_replaced():
    """Mirrors tests/test_serving.py::test_hung_worker_detected_and_replaced."""
    release = threading.Event()
    done = threading.Event()
    first = [True]

    def model(feed):
        if first[0]:
            first[0] = False
            release.wait(30)  # wedge the first batch (device-hang model)
            done.set()
            return {"y": np.full_like(np.asarray(feed["x"]), np.nan)}
        return {"y": np.asarray(feed["x"]) + 1.0}

    srv = _server(model, hang_timeout_s=0.1, restart_backoff_s=0.01,
                  max_batch=1, batch_delay_ms=0.0)
    srv.start(warmup=False)
    with srv:
        try:
            err = srv.submit(_bfeed(0.0)).error(30)
            assert isinstance(err, WorkerCrashed) and "hung" in str(err)
            assert _wait(lambda: srv.supervisor.alive(), timeout=10.0)
            out = srv.submit(_bfeed(4.0)).result(30)
            np.testing.assert_allclose(out["y"], np.full((1, 4), 5.0))
            release.set()  # let the abandoned thread finish with its NaN
            assert done.wait(10)
            time.sleep(0.05)
            assert srv.breaker.snapshot()["consecutive_failures"] == 0
            assert srv.breaker.state == "closed"
        finally:
            release.set()


def test_degradation_ladder_steps_down_before_shedding():
    """Mirrors tests/test_serving.py::
    test_degradation_ladder_steps_down_before_shedding."""
    tiers = []

    def model(feed, tier_opts):
        tiers.append(dict(tier_opts))
        time.sleep(0.01)
        return {"y": np.asarray(feed["x"])}

    srv = _server(model, max_batch=2, batch_delay_ms=0.0, max_queue=12,
                  degrade=[{"greedy": True, "max_len": 16}])
    srv.start(warmup=False)
    with srv:
        futs = []
        for i in range(12):
            try:
                futs.append(srv.submit(_bfeed(float(i))))
            except ServingError:
                pass
        for f in futs:
            f.error(30)
    assert any(t.get("greedy") for t in tiers), tiers
    assert srv.metrics.count("degraded") > 0


def test_overload_burst_zero_silent_drops_shed_and_p99():
    """Mirrors tests/test_serving.py::
    test_overload_burst_zero_silent_drops_shed_and_p99, with its bound."""
    deadline_ms = 3000.0
    srv = _server(_echo_model(sleep_s=0.01), max_batch=4, batch_delay_ms=1.0,
                  max_queue=8, default_deadline_ms=deadline_ms)
    srv.start(warmup_feed=_bfeed(0.0))
    n_burst = 120
    accepted, rejected = [], []
    with srv:
        for i in range(n_burst):
            try:
                accepted.append((i, srv.submit(_bfeed(float(i)))))
            except (ShedError, DeadlineExceeded, CircuitOpenError) as e:
                rejected.append((i, e))
        replies = {}
        for i, f in accepted:
            replies[i] = f.error(60)
        hz = srv.healthz()

    assert len(accepted) + len(rejected) == n_burst
    assert set(replies) == {i for i, _ in accepted}
    assert all(e is None or isinstance(e, ServingError)
               for e in replies.values())
    assert len(rejected) > 0
    assert all(isinstance(e, ServingError) for _, e in rejected)
    ok = [i for i, e in replies.items() if e is None]
    assert ok, "burst must not fail every request"
    assert hz["p99_ms"] is not None and hz["p99_ms"] <= deadline_ms
    for i, f in accepted:
        if replies[i] is None:
            np.testing.assert_allclose(
                f.result(0)["y"], np.full((1, 4), i + 1.0))


# ---------------------------------------------------------------------------
# the port beside the JAX package: the same requests through both servers
# ---------------------------------------------------------------------------


def _serve_through(server_cls, backend, feeds, limits, order, **kw):
    """Submit ``feeds`` in ``order`` to a generation server over
    ``backend``; returns each request's outputs by feed index."""
    srv = server_cls(backend, mode="generation", batch_delay_ms=0.0,
                     max_queue=64, default_deadline_ms=0.0, **kw)
    srv.start()
    with srv:
        futs = {i: srv.submit(feeds[i], max_len=limits[i]) for i in order}
        return {i: f.result(120) for i, f in futs.items()}


def _hold(got, want):
    for i in want:
        np.testing.assert_array_equal(got[i]["tokens"], want[i]["tokens"])
        np.testing.assert_allclose(got[i]["scores"], want[i]["scores"],
                                   rtol=1e-5, atol=1e-6)


def test_toy_lm_served_matches_the_jax_server(rng):
    """The reference's server on the JAX toy LM and the port's on the
    port's, same numpy parameters and requests, admitted in a mixed order
    through a 1-slot table: ids identical, scores within 1e-5 / 1e-6."""
    from paddle_tpu.serving import InferenceServer as JaxServer

    params = toy_params(rng)
    feeds = [_feed(rng) for _ in range(5)]
    feeds[2] = chaos.straggler_request(feeds[2])
    limits = [6, 10, 7, 3, 10]
    order = [3, 0, 4, 2, 1]
    want = _serve_through(JaxServer, jax_toy_lm(params, 10), feeds,
                          limits, order, slots=1)
    got = _serve_through(InferenceServer, ToyLM(params=params, max_len=10),
                         feeds, limits, order, slots=1)
    _hold(got, want)
    assert got[2]["tokens"].shape == (1, K, 7)


def test_flagship_served_matches_the_jax_server(rng):
    """The flagship ``Seq2SeqAttention`` at a tiny width (vocab 16/16,
    dims 8, src_len 8, beam 3), parameters carried by ``params_from_jax``,
    served through both packages' servers: ids identical, scores within
    1e-5 / 1e-6."""
    import jax

    from paddle_tpu.models import Seq2SeqAttention as JaxSeq2Seq
    from paddle_tpu.serving import InferenceServer as JaxServer
    from paddle_tpu.serving import Seq2SeqSlotBackend as JaxBackend
    from paddle_tpu_torch.models.seq2seq import (Seq2SeqAttention,
                                                 params_from_jax)
    from paddle_tpu_torch.serving import Seq2SeqSlotBackend

    cfg = dict(src_vocab=16, trg_vocab=16, emb_dim=8, enc_dim=8, dec_dim=8,
               att_dim=8)
    jm = JaxSeq2Seq(**cfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = Seq2SeqAttention(**cfg, device="cpu")
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    feeds = []
    for _ in range(5):
        t = int(rng.randint(2, 9))
        feeds.append({"src": (rng.randint(3, 16, (1, t)).astype(np.int32),
                              np.asarray([t], np.int32))})
    limits = [6, 4, 6, 5, 6]
    order = [1, 4, 0, 3, 2]
    kw = dict(src_len=8, beam_size=K, max_len=6)
    want = _serve_through(JaxServer, JaxBackend(jm, jp, **kw), feeds,
                          limits, order, slots=2)
    got = _serve_through(InferenceServer, Seq2SeqSlotBackend(tm, tp, **kw),
                         feeds, limits, order, slots=2)
    _hold(got, want)


# ---------------------------------------------------------------------------
# what the port does not have yet raises, naming its ROADMAP.md item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,item", [
    (dict(spec_k=2), 2), (dict(draft=object()), 2),
    (dict(prefix_cache_mb=8.0), 2), (dict(slot_page_pool_mb=8.0), 2)],
    ids=["spec_k", "draft", "prefix_cache_mb", "slot_page_pool_mb"])
def test_unported_generation_options_raise_config_error(rng, kw, item):
    """Queue 1 item 2's decode-speed options are ported now: the server
    takes them without a ``ConfigError`` and hands them to its slot table
    (the toy LM's table is beam 3, so speculation is turned off there, as
    in the reference; ``tests/test_torch_spec_decode.py`` serves with all
    of them on a greedy table)."""
    srv = _gen_server(ToyLM(rng, max_len=4), **kw)
    with srv:
        sched = srv._scheduler
        assert sched.spec_k == 0 and sched.proposer is None
        assert (sched.prefix_cache is None) == ("prefix_cache_mb" not in kw)
        assert (sched.pager is None) == ("slot_page_pool_mb" not in kw)
        for name, mb in kw.items():
            if name == "prefix_cache_mb":
                assert sched.prefix_cache.max_bytes == int(mb * (1 << 20))
            if name == "slot_page_pool_mb":
                assert sched.pager.max_bytes == int(mb * (1 << 20))


@pytest.mark.parametrize("kw,item", [
    (dict(compile_cache=object()), 7), (dict(preflight=True), 9)],
    ids=["compile_cache", "preflight"])
def test_unported_start_options_raise_config_error(rng, kw, item):
    srv = _gen_server(ToyLM(rng, max_len=4))
    with srv:
        with pytest.raises(ConfigError, match=f"Queue 1 item {item}\\b"):
            srv.start(**kw)
        assert not srv.ready


def test_inference_model_in_bucket_mode_raises_config_error():
    class FakeInferenceModel:
        topology = object()

        def infer(self, feed, outputs=None):
            return {}

    with pytest.raises(ConfigError, match="Queue 1 item 7\\b"):
        InferenceServer(FakeInferenceModel())


def test_request_tracing_raises_config_error():
    srv = _server(_echo_model())
    srv.start(warmup=False)
    with srv:
        with pytest.raises(ConfigError, match="Queue 1 item 9\\b"):
            srv.submit(_bfeed(0.0), trace_attrs={"tenant": "a"})
        assert srv.submit(_bfeed(0.0)).error(10) is None


# ---------------------------------------------------------------------------
# hot swap and the model block of the health surface
# ---------------------------------------------------------------------------


def test_bucket_swap_model_serves_the_next_batch_with_the_new_model():
    """Bucket mode: ``swap_model`` returns the previous model and every
    batch after it runs on the new one; the swap is counted."""
    srv = _server(_echo_model(), max_batch=1, batch_delay_ms=0.0)
    srv.start(warmup=False)
    with srv:
        np.testing.assert_allclose(srv.infer(_bfeed(1.0))["y"], 2.0)
        prev = srv.swap_model(lambda feed: {"y": np.asarray(feed["x"]) * 10},
                              info={"version": 2})
        assert callable(prev)
        np.testing.assert_allclose(srv.infer(_bfeed(1.0))["y"], 10.0)
        hz = srv.healthz()
    assert hz["counters"]["model_swaps"] == 1
    assert hz["model"]["version"] == 2


def test_generation_swap_model_drains_then_flips(rng):
    """Generation mode: the resident request finishes on the old table and
    backend; the request queued behind the staged swap is served by the
    new backend, each equal to its solo decode on its own backend."""
    old, new = ToyLM(rng, max_len=200), ToyLM(rng, max_len=200)
    srv = _gen_server(old, slots=2)
    srv.start()
    with srv:
        f_old = _feed(rng)
        fut_old = srv.submit(chaos.straggler_request(f_old), max_len=200)
        assert _wait(lambda: srv.healthz()["slots"]["occupied"] == 1)
        assert srv.swap_model(new, info={"version": 5}) is old
        f_new = _feed(rng)
        fut_new = srv.submit(f_new, max_len=6)
        got_old, got_new = fut_old.result(60), fut_new.result(60)
        hz = srv.healthz()
    solo_old = _solo(old, chaos.straggler_request(f_old), 200)
    solo_new = _solo(new, f_new, 6)
    np.testing.assert_array_equal(got_old["tokens"], solo_old[0])
    np.testing.assert_array_equal(got_old["scores"], solo_old[1])
    np.testing.assert_array_equal(got_new["tokens"], solo_new[0])
    np.testing.assert_array_equal(got_new["scores"], solo_new[1])
    assert srv.model is new and hz["model"]["version"] == 5
    assert hz["counters"]["model_swaps"] == 1


def test_model_info_fills_the_healthz_model_block():
    """The ``model`` block's keys, as tests/test_serving.py::
    test_healthz_model_block_schema_pinned pins them (there over an
    InferenceModel, not ported): absent without info, then the served
    artifact's identity and its freshness."""
    srv = _server(_echo_model(), max_batch=2, max_queue=8)
    with srv:
        assert "model" not in srv.healthz()
        t0 = time.time()
        srv.set_model_info({"bundle": "/pub/v-00007/model.ptz",
                            "version": 7, "fingerprint": "abc",
                            "quantize": None,
                            "train_commit_time": t0 - 12.5})
        block = srv.healthz()["model"]
    assert set(block) == {"bundle", "version", "fingerprint", "quantize",
                          "loaded_at", "freshness_s"}
    assert block["version"] == 7 and block["loaded_at"] >= t0
    assert 12.5 <= block["freshness_s"] < 60.0


def test_concurrent_submitters_lose_no_request_and_no_count():
    """16 client threads (more than the cores) submit 25 requests each
    with a shortened thread switch interval: every request is accepted or
    rejected typed, every accepted one answers with its own result, and
    the counters add up (a lost update in the queue, the futures or the
    registry would break one of these)."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv = _server(_echo_model(), max_batch=4, batch_delay_ms=0.5,
                      max_queue=64)
        srv.start(warmup=False)
        accepted, rejected = [], []
        with srv:
            def client(k):
                for i in range(25):
                    v = float(100 * k + i)
                    try:
                        accepted.append((v, srv.submit(_bfeed(v))))
                    except ServingError as e:
                        rejected.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            for v, f in accepted:
                err = f.error(60)
                assert err is None or isinstance(err, ServingError), err
                if err is None:
                    np.testing.assert_allclose(f.result(0)["y"], v + 1.0)
            hz = srv.healthz()
    finally:
        sys.setswitchinterval(old)
    c = hz["counters"]
    assert len(accepted) + len(rejected) == 400 == c["submitted"]
    assert c["accepted"] == len(accepted)
    assert c["shed"] + c["deadline_infeasible"] == len(rejected)
    assert c["completed"] + c["deadline_expired"] == len(accepted)
    assert c["completed"] > 0
