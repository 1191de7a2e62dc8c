"""The port's serving support modules on the CPU, held against the JAX
package's: typed errors, circuit breaker, batching queue, metrics and
their registry, the worker supervisor, the serving chaos helpers and the
health surface's schema.

The plumbing tests of ``tests/test_serving.py`` come first, each opening
with the reference test it mirrors; then the same inputs (an injected
clock, the same offered requests, the same counter operations) go through
both packages.  Every test runs under a hard ``signal.alarm``, and every
server is closed in a ``with`` block.
"""

import signal

import numpy as np
import pytest

import paddle_tpu.serving as jax_serving
from paddle_tpu.obs.registry import MetricsRegistry as JaxRegistry
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu.serving import batching as jax_batching
from paddle_tpu.serving import errors as jax_errors
from paddle_tpu.serving.metrics import _COUNTERS as JAX_COUNTERS
from paddle_tpu_torch import serving
from paddle_tpu_torch.obs import MetricsRegistry, get_registry
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (BatchQueue, CircuitBreaker,
                                      InferenceServer, ShedError,
                                      WorkerSupervisor, batch_bucket,
                                      canonicalize_feed)
from paddle_tpu_torch.serving import batching, errors
from paddle_tpu_torch.serving.metrics import _COUNTERS, ServerMetrics

HARD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def hard_timeout():
    def _abort(signum, frame):
        raise RuntimeError(f"serving support test exceeded {HARD_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(HARD_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


# ---------------------------------------------------------------------------
# tests/test_serving.py's plumbing units on the port
# ---------------------------------------------------------------------------


def test_batch_bucket_ladder():
    """Mirrors tests/test_serving.py::test_batch_bucket_ladder."""
    assert [batch_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8,
                                                                8, 8]


def test_canonicalize_pads_seq_dims_into_shared_bucket():
    """Mirrors tests/test_serving.py::
    test_canonicalize_pads_seq_dims_into_shared_bucket."""
    f1, r1, s1 = canonicalize_feed(
        {"w": (np.zeros((2, 9), np.int32), np.full((2,), 9, np.int32))})
    f2, r2, s2 = canonicalize_feed(
        {"w": (np.zeros((2, 13), np.int32), np.full((2,), 13, np.int32))})
    assert (r1, r2) == (2, 2)
    assert f1["w"][0].shape == (2, 16) and f2["w"][0].shape == (2, 16)
    assert s1 == s2
    with pytest.raises(ValueError, match="inconsistent batch"):
        canonicalize_feed({"a": np.zeros((2, 3)), "b": np.zeros((3, 3))})


def test_canonicalize_signature_distinguishes_tuple_structure():
    """Mirrors tests/test_serving.py::
    test_canonicalize_signature_distinguishes_tuple_structure."""
    v = np.zeros((1, 16), np.int32)
    _, _, bare = canonicalize_feed({"x": v})
    _, _, tup = canonicalize_feed({"x": (v,)})
    assert bare != tup


def test_breaker_state_machine():
    """Mirrors tests/test_serving.py::test_breaker_state_machine."""
    t = [0.0]
    br = CircuitBreaker(threshold=2, cooldown_s=1.0, clock=lambda: t[0])
    assert br.allow()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow() and br.trips == 1
    t[0] = 1.5  # past cooldown: half-open lets a probe through
    assert br.allow() and br.state == "half_open"
    br.record_failure()  # failed probe re-opens, cooldown restarts
    assert br.state == "open" and not br.allow()
    t[0] = 3.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.trips == 2


def test_healthz_counter_key_set_pinned_for_dashboards():
    """Mirrors tests/test_serving.py::
    test_healthz_counter_key_set_pinned_for_dashboards, over the port's
    registry."""
    expected = {
        "submitted", "accepted", "completed", "shed", "invalid_request",
        "deadline_infeasible", "deadline_expired", "breaker_rejected",
        "breaker_trips", "inference_failed", "worker_crashed",
        "server_closed", "worker_restarts", "degraded", "batches",
        "gen_steps", "slot_recycled", "slot_evicted",
        "compile_cache_hits", "compile_cache_misses", "warmup_compiles",
        "spec_draft_tokens_total", "spec_accepted_tokens_total",
        "prefix_cache_hits", "prefix_cache_misses",
        "slots_paged_out", "slots_paged_in",
    }
    m = ServerMetrics()
    snap = m.snapshot()
    assert set(snap["counters"]) == expected
    assert all(v == 0 for v in snap["counters"].values())
    for key in ("p50_ms", "p99_ms", "mean_batch_rows",
                "mean_slot_occupancy", "mean_request_steps"):
        assert key in snap
    m.inc("shed")
    m.set_count("worker_restarts", 3)
    snap2 = m.snapshot()
    assert snap2["counters"]["shed"] == 1
    assert snap2["counters"]["worker_restarts"] == 3
    reg = {s["labels"]["server"]: s["value"]
           for s in get_registry().snapshot()[
               "serving_worker_restarts"]["series"]}
    assert reg[m._label] == 3.0
    m.unregister()
    gone = {s["labels"]["server"]
            for s in get_registry().snapshot()["serving_shed"]["series"]}
    assert m._label not in gone
    assert m.snapshot()["counters"]["shed"] == 1


# ---------------------------------------------------------------------------
# the port beside the JAX package
# ---------------------------------------------------------------------------

_ERRORS = ("ServingError", "InvalidRequestError", "ShedError",
           "DeadlineExceeded", "QuotaExceeded", "CircuitOpenError",
           "WorkerCrashed", "InferenceFailed", "ServerClosed")


def test_typed_errors_match_the_jax_package():
    """The same error names, exported the same way, with the same method
    resolution order of base names; ``QuotaExceeded`` keeps its fields."""
    assert set(errors.__all__) == set(jax_errors.__all__) == set(_ERRORS)
    for name in _ERRORS:
        ours, ref = getattr(errors, name), getattr(jax_errors, name)
        assert getattr(serving, name) is ours
        assert getattr(jax_serving, name) is ref
        assert ([c.__name__ for c in ours.__mro__]
                == [c.__name__ for c in ref.__mro__]), name
    q = errors.QuotaExceeded("over", tenant="t1", fair_share=True)
    assert (q.tenant, q.fair_share, str(q)) == ("t1", True, "over")
    assert issubclass(errors.InvalidRequestError, ValueError)


@pytest.mark.parametrize("threshold,cooldown,probes", [(2, 1.0, 1),
                                                       (3, 0.5, 2)])
def test_breaker_state_sequence_matches_the_jax_package(threshold, cooldown,
                                                        probes):
    """One injected clock and one success/failure sequence drive both
    breakers: the same state after every event and the same
    ``snapshot()``."""
    events = ["f", "s", "f", "f", "f", ("t", 0.4), "f", ("t", 1.2), "s",
              "f", ("t", 2.0), "s", "s", "f", "f", "f", ("t", 3.5), "s",
              "s", "s"]
    t = [0.0]
    ours = CircuitBreaker(threshold=threshold, cooldown_s=cooldown,
                          probes_to_close=probes, clock=lambda: t[0])
    ref = jax_serving.CircuitBreaker(threshold=threshold, cooldown_s=cooldown,
                                     probes_to_close=probes,
                                     clock=lambda: t[0])
    seen = []
    for ev in events:
        if isinstance(ev, tuple):
            t[0] = ev[1]
        for br in (ours, ref):
            if ev == "f":
                br.record_failure()
            elif ev == "s":
                br.record_success()
        assert ours.allow() == ref.allow()
        assert ours.snapshot() == ref.snapshot(), ev
        seen.append(ours.state)
    assert {"closed", "open", "half_open"} <= set(seen)
    assert ours.trips == ref.trips > 0


def _offer(mod, queue, specs):
    """Offer one request per spec ``(rows, T, deadline)`` to ``queue``,
    built with package ``mod``'s batching; returns them in order."""
    reqs = []
    for i, (rows, T, deadline) in enumerate(specs):
        feed = {"w": (np.full((rows, T), i, np.int32),
                      np.full((rows,), T, np.int32))}
        canon, r, sig = mod.canonicalize_feed(feed)
        req = mod.Request(feed=canon, rows=r, signature=sig,
                          future=mod.ServingFuture(), deadline=deadline,
                          t_submit=0.0)
        queue.offer(req)
        reqs.append(req)
    return reqs


def test_batch_queue_pop_matches_the_jax_package():
    """The same offered requests and clock through both queues: each pop
    returns the same batch and the same expired set, by request index, and
    the bounded offer sheds typed on both."""
    specs = [(1, 9, 5.0), (2, 13, None), (1, 40, 1.5), (1, 12, 0.5),
             (3, 16, 9.0), (1, 64, 4.0), (2, 9, 2.5), (1, 30, 0.8),
             (2, 11, None), (1, 50, 7.0)]
    t = [1.0]
    ours, ref = BatchQueue(len(specs)), jax_batching.BatchQueue(len(specs))
    oreqs = _offer(batching, ours, specs)
    rreqs = _offer(jax_batching, ref, specs)
    opos = {id(r): i for i, r in enumerate(oreqs)}
    rpos = {id(r): i for i, r in enumerate(rreqs)}
    with pytest.raises(ShedError, match="queue full"):
        _offer(batching, ours, specs[:1])
    with pytest.raises(jax_errors.ShedError, match="queue full"):
        _offer(jax_batching, ref, specs[:1])
    popped, expired = [], []
    for max_rows, est in [(4, 0.0), (2, 1.2), (8, 0.0), (1, 3.0), (8, 0.0),
                          (8, 0.0), (8, 0.0)]:
        got = ours.pop_batch(max_rows=max_rows, batch_delay_s=0.0,
                             timeout=0.0, est_service_s=est,
                             clock=lambda: t[0])
        want = ref.pop_batch(max_rows=max_rows, batch_delay_s=0.0,
                             timeout=0.0, est_service_s=est,
                             clock=lambda: t[0])
        idx = [[[opos[id(r)] for r in part] for part in got],
               [[rpos[id(r)] for r in part] for part in want]]
        assert idx[0] == idx[1], (max_rows, est, idx)
        popped += idx[0][0]
        expired += idx[0][1]
        assert ours.depth() == ref.depth()
        t[0] += 0.7
    assert ours.depth() == 0
    assert sorted(popped + expired) == list(range(len(specs)))
    assert popped == [0, 1, 5, 9, 4, 6, 8] and expired == [3, 7, 2]
    assert ours.close() == [] and ref.close() == []
    with pytest.raises(ShedError, match="closed"):
        _offer(batching, ours, specs[:1])


def test_batching_helpers_match_the_jax_package(rng):
    """``Request``'s fields and defaults, ``warmup_bucket_feeds`` and
    ``split_outputs`` as in the JAX package."""
    import dataclasses

    ours = [(f.name, f.default) for f in dataclasses.fields(batching.Request)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(jax_batching.Request)]
    assert ours == ref
    feed = {"w": (rng.randint(0, 9, (3, 11)).astype(np.int32),
                  np.asarray([11, 4, 7], np.int32)),
            "x": rng.randn(3, 5).astype(np.float32)}
    got = batching.warmup_bucket_feeds(feed, [1, 2, 4])
    want = jax_batching.warmup_bucket_feeds(feed, [1, 2, 4])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for a, b in zip(g["w"], w["w"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g["x"], w["x"])
    outs = {"y": rng.randn(6, 2).astype(np.float32),
            "cost": np.float32(1.5)}
    slices = [(0, 2), (2, 3), (3, 6)]
    for g, w in zip(batching.split_outputs(outs, slices),
                    jax_batching.split_outputs(outs, slices)):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_server_counter_names_match_the_jax_package():
    assert _COUNTERS == JAX_COUNTERS


def test_registry_matches_the_jax_package(monkeypatch):
    """The same counter, gauge and histogram operations on both registries
    give the same JSON snapshot and the same Prometheus text (one wall
    clock for both: an exemplar carries its time)."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1000.0)
    regs = (MetricsRegistry(), JaxRegistry())
    for reg in regs:
        c = reg.counter("req_total", "requests", labels=("server",),
                        server="a")
        c.inc()
        c.inc(2)
        reg.counter("req_total", labels=("server",), server="b").set_to(7)
        g = reg.gauge("depth", "queue depth")
        g.set(3.5)
        reg.gauge("unset", "never set")
        h = reg.histogram("lat_seconds", "latency", labels=("server",),
                          server="a")
        for v in (0.0002, 0.003, 0.04, 0.7, 12.0):
            h.observe(v, exemplar="t1" if v > 1 else None)
        reg.remove_series("req_total", server="b")
    ours, ref = regs
    assert ours.snapshot() == ref.snapshot()
    assert ours.prometheus_text() == ref.prometheus_text()


def test_metrics_percentiles_and_observations():
    """``percentile_ms`` (nearest rank) agrees with the snapshot, and the
    batch, slot and step observations land in the snapshot."""
    m = ServerMetrics(window=8)
    try:
        for ms in (5, 1, 9, 3, 7, 2, 8, 4, 6, 10):   # window keeps the last 8
            m.observe_latency(ms / 1e3)
        m.observe_batch(3)
        m.observe_batch(5)
        m.observe_slots(3, 4)
        m.observe_slots(1, 4)
        m.observe_request_steps(6)
        snap = m.snapshot()
        assert m.percentile_ms(50) == pytest.approx(6.0)
        assert m.percentile_ms(99) == pytest.approx(10.0)
        assert snap["p50_ms"] == round(m.percentile_ms(50), 3)
        assert snap["counters"]["batches"] == 2
        assert snap["mean_batch_rows"] == 4.0
        assert snap["mean_slot_occupancy"] == 0.5
        assert snap["mean_request_steps"] == 6.0
    finally:
        m.unregister()


def test_chaos_helpers_match_the_jax_package(rng):
    feed = {"h": rng.randn(2, 4).astype(np.float32),
            "ids": (np.arange(6, dtype=np.int32).reshape(2, 3),
                    np.asarray([3, 2], np.int32))}
    for ours, ref in [(chaos.nan_feed(feed), jax_chaos.nan_feed(feed)),
                      (chaos.straggler_request(feed),
                       jax_chaos.straggler_request(feed))]:
        assert set(ours) == set(ref)
        np.testing.assert_array_equal(ours["h"], ref["h"])
        for a, b in zip(ours["ids"], ref["ids"]):
            np.testing.assert_array_equal(a, b)
        if "eos_bias" in ref:
            np.testing.assert_array_equal(ours["eos_bias"], ref["eos_bias"])
    assert np.isnan(chaos.nan_feed(feed)["h"]).all()

    def model(feed, tier_opts):
        return {"y": feed}

    calls = []
    slow = chaos.latency_injection(model, at=1, times=2, delay_s=0.5,
                                   sleep=calls.append)
    for i in range(4):
        slow(i, {})
    assert calls == [0.5, 0.5]
    crash = chaos.crash_calls(model, at=0, times=1)
    with pytest.raises(RuntimeError, match="call 0"):
        crash(0, {})
    assert crash(1, {}) == {"y": 1}
    paced = []
    assert list(chaos.slow_client(iter("ab"), delay_s=0.2,
                                  sleep=paced.append)) == ["a", "b"]
    assert paced == [0.2, 0.2]


def _flatten_keys(d, prefix=""):
    keys = set()
    for k, v in d.items():
        keys.add(prefix + k)
        if isinstance(v, dict):
            keys |= _flatten_keys(v, prefix + k + ".")
    return keys


def _bucket_model(feed):
    return {"y": np.asarray(feed["x"]) + 1.0}


def test_healthz_key_set_matches_the_jax_server_in_bucket_mode():
    """The same configuration in one process: the same keys, nested keys
    included, before and after traffic."""
    kw = dict(max_batch=2, batch_delay_ms=0.0, max_queue=8,
              default_deadline_ms=5000.0)
    feed = {"x": np.zeros((1, 3), np.float32)}
    with InferenceServer(_bucket_model, **kw) as ours, \
            jax_serving.InferenceServer(_bucket_model, **kw) as ref:
        assert (_flatten_keys(ours.healthz())
                == _flatten_keys(ref.healthz()))
        for srv in (ours, ref):
            srv.start(warmup_feed=feed)
            assert srv.infer(feed)["y"].shape == (1, 3)
        hz, hz_ref = ours.healthz(), ref.healthz()
        assert _flatten_keys(hz) == _flatten_keys(hz_ref)
        assert hz["counters"] == hz_ref["counters"]


def test_healthz_key_set_matches_the_jax_server_in_generation_mode(rng):
    """Generation mode over the two toy LMs of the server tests: the same
    keys, nested keys included (the ``slots`` block too), and the same
    counters after the same requests."""
    from torch_serving_toy import ToyLM, jax_toy_lm, toy_params

    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    params = toy_params(rng)
    kw = dict(mode="generation", slots=2, batch_delay_ms=0.0, max_queue=8,
              default_deadline_ms=0.0)
    feed = {"h": rng.randn(1, 8).astype(np.float32),
            "eos_bias": np.zeros((1, 1), np.float32)}
    with compute_dtype_scope("float32"), \
            InferenceServer(ToyLM(params=params, max_len=5), **kw) as ours, \
            jax_serving.InferenceServer(jax_toy_lm(params, 5), **kw) as ref:
        for srv in (ours, ref):
            srv.start()
            for _ in range(3):
                assert srv.submit(feed, max_len=4).error(60) is None
        hz, hz_ref = ours.healthz(), ref.healthz()
        assert _flatten_keys(hz) == _flatten_keys(hz_ref)
        assert "slots" in hz and "gang" not in hz_ref
        for name in ("submitted", "accepted", "completed", "slot_recycled"):
            assert hz["counters"][name] == hz_ref["counters"][name], name
        assert hz["slots"] == {**hz_ref["slots"], "steps": hz["slots"][
            "steps"]}


def test_worker_supervisor_restarts_with_backoff_then_gives_up():
    """A worker that always crashes: ``on_crash`` per death, relaunches
    after ``backoff_s * 2^attempt`` capped at ``max_backoff_s`` (read
    through the injected ``sleep``), then ``on_give_up`` once the budget
    is spent."""
    import threading

    crashes, gave_up, relaunched = [], threading.Event(), []
    sleeps = []

    def serve_once(gen):
        raise RuntimeError(f"boom {gen}")

    def sleep(s):
        sleeps.append(s)
        threading.Event().wait(0.001)

    sup = WorkerSupervisor(serve_once, max_restarts=3, backoff_s=0.05,
                           max_backoff_s=0.15, poll_s=0.001,
                           on_crash=crashes.append,
                           on_give_up=lambda e: gave_up.set(),
                           on_relaunch=lambda: relaunched.append(1),
                           sleep=sleep)
    sup.start()
    try:
        assert gave_up.wait(30)
    finally:
        sup.stop()
    assert sup.restarts == 3 and len(relaunched) == 3
    assert len(crashes) == 4
    assert all("boom" in str(e) for e in crashes)
    assert [s for s in sleeps if s > 0.001] == [0.05, 0.1, 0.15]


def test_worker_supervisor_detects_a_hang_on_the_injected_clock():
    """A busy worker past ``hang_timeout_s`` on the injected clock is
    declared hung (``TimeoutError``), its generation retired, and a fresh
    worker takes over; the stale worker sees ``current(gen)`` go false."""
    import threading

    now = [0.0]
    entered, release = threading.Event(), threading.Event()
    stale_current, crashes = [], []
    relaunched, stale_noted = threading.Event(), threading.Event()

    def serve_once(gen):
        if gen == 1:
            sup.note_busy(gen)
            entered.set()
            release.wait(30)
            stale_current.append(sup.current(gen))
            stale_noted.set()
            sup.note_idle(gen)
        else:
            threading.Event().wait(0.001)

    sup = WorkerSupervisor(serve_once, max_restarts=2, backoff_s=0.0,
                           hang_timeout_s=5.0, poll_s=0.001,
                           on_crash=crashes.append,
                           on_give_up=lambda e: None,
                           on_relaunch=relaunched.set,
                           clock=lambda: now[0])
    sup.start()
    try:
        assert entered.wait(10)
        now[0] = 4.0
        assert not relaunched.wait(0.05)     # inside the timeout: no hang
        now[0] = 5.5
        assert relaunched.wait(10)
        release.set()
    finally:
        release.set()
        sup.stop()
    # stop() joins the live worker only, not the retired generation
    assert stale_noted.wait(10)
    assert len(crashes) == 1 and isinstance(crashes[0], TimeoutError)
    assert "hung" in str(crashes[0])
    assert sup.restarts == 1
    assert stale_current == [False]
