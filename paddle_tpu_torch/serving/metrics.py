"""Observable health surface of the serving runtime — the port's copy of
``paddle_tpu/serving/metrics.py``.

One ``ServerMetrics`` instance per server, a VIEW over the shared
``paddle_tpu_torch.obs`` metrics registry (docs/observability.md): every
counter is a registry counter ``serving_<name>{server=<id>}``, and
completed-request latency additionally feeds the registry histogram
``serving_latency_seconds`` — so a ``start_metrics_server`` scrape and
``healthz()`` read the SAME monotonic series and can never tell
different stories.  Counters are named after the typed error that
produced them, so the health surface and the exception surface agree
too.

The ``snapshot()`` schema is pinned by tests/test_serving.py and, for
the port, tests/test_torch_serving_support.py: every
``_COUNTERS`` key is pre-seeded (a dashboard sees ``shed=0``, not a
missing key, before the first shed) and the percentile definition is the
same nearest-rank rule ``percentile_ms`` uses.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Optional

__all__ = ["ServerMetrics"]

#: counter names pre-seeded so a snapshot always carries the full schema
#: (a dashboard should see shed=0, not a missing key, before the first shed)
_COUNTERS = (
    "submitted",        # every submit() call, accepted or not
    "accepted",         # admitted to the queue
    "completed",        # replied with outputs, inside the deadline
    "shed",             # ShedError at admission (queue overflow / warming)
    "invalid_request",      # InvalidRequestError (malformed / oversized)
    "deadline_infeasible",  # DeadlineExceeded at admission
    "deadline_expired",     # DeadlineExceeded after acceptance
    "breaker_rejected",     # CircuitOpenError (admission or execution)
    "breaker_trips",        # CLOSED -> OPEN transitions
    "inference_failed",     # model raised / non-finite outputs
    "worker_crashed",       # requests failed by a worker death/hang
    "server_closed",        # requests drained by shutdown (queued/in-flight)
    "worker_restarts",      # supervisor relaunches
    "degraded",             # requests executed at a degraded tier (>0)
    "batches",              # model invocations
    # continuous batching (generation mode; serving/slots.py)
    "gen_steps",            # fused decode_step calls over the slot table
    "slot_recycled",        # slots freed (harvest or eviction) for reuse
    "slot_evicted",         # slots released by mid-generation deadline expiry
    # fleet cold-start (docs/deploy.md; config/compile_cache.py)
    "compile_cache_hits",    # warmup executables LOADED from the cache
    "compile_cache_misses",  # warmup executables compiled + stored
    "warmup_compiles",       # compiles paid by the readiness gate (the
    #                          port: kernel libraries loaded during it,
    #                          SlotScheduler.compiled_programs)
    # decode raw speed (docs/decode.md "Speculative decoding";
    # serving/prefix_cache.py; serving/paging.py)
    "spec_draft_tokens_total",     # draft tokens offered to wide verify
    "spec_accepted_tokens_total",  # draft tokens the model confirmed
    "prefix_cache_hits",           # admissions served from cached prefill
    "prefix_cache_misses",         # admissions that ran the encoder
    "slots_paged_out",             # slot carries host-evicted to the pool
    "slots_paged_in",              # parked carries restored bit-for-bit
)

#: distinguishes the registry children of servers sharing one process
_server_ids = itertools.count()


class ServerMetrics:
    def __init__(self, window: int = 512, registry=None) -> None:
        from paddle_tpu_torch.obs import get_registry

        reg = registry if registry is not None else get_registry()
        self._label = f"s{next(_server_ids)}"
        self._counters = {
            name: reg.counter("serving_" + name,
                              "serving counter (docs/serving.md)",
                              labels=("server",), server=self._label)
            for name in _COUNTERS
        }
        self._registry = reg
        self._gauges = {}
        self._latency_hist = reg.histogram(
            "serving_latency_seconds",
            "completed-request latency", labels=("server",),
            server=self._label)
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=window)  # seconds, completed only
        self._batch_rows = deque(maxlen=window)
        self._occupancy = deque(maxlen=window)  # occupied/capacity per step
        self._req_steps = deque(maxlen=window)  # decode steps per request

    def gauge(self, name: str):
        """Per-server registry gauge ``serving_<name>{server=...}`` —
        the model-freshness / version surface of the hot-reload path
        (docs/publish.md).  Created on first use; retired with the
        counters by ``unregister``."""
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.get(name)
                if g is None:
                    g = self._gauges[name] = self._registry.gauge(
                        "serving_" + name, "serving gauge (docs/serving.md)",
                        labels=("server",), server=self._label)
        return g

    def _counter(self, name: str):
        c = self._counters.get(name)
        if c is None:
            # unknown names keep working (the old dict accepted any key);
            # insertion under the lock so a concurrent snapshot() never
            # iterates a dict changing size
            with self._lock:
                c = self._counters.get(name)
                if c is None:
                    c = self._counters[name] = self._registry.counter(
                        "serving_" + name, "serving counter (dynamic)",
                        labels=("server",), server=self._label)
        return c

    def inc(self, name: str, n: int = 1) -> None:
        self._counter(name).inc(n)

    def observe_latency(self, seconds: float,
                        trace_id: Optional[str] = None) -> None:
        """``trace_id`` (when request tracing is armed) rides the latency
        histogram bucket as an EXEMPLAR: a p99 spike on a dashboard links
        straight to a concrete retained trace (`obs trace --trace=ID`)."""
        self._latency_hist.observe(seconds, exemplar=trace_id)
        with self._lock:
            self._latencies.append(seconds)

    def observe_batch(self, rows: int) -> None:
        self._counter("batches").inc()
        with self._lock:
            self._batch_rows.append(rows)

    def observe_slots(self, occupied: int, capacity: int) -> None:
        """Slot-table occupancy at one fused step (generation mode) — the
        utilization the recycle loop exists to maximize."""
        with self._lock:
            self._occupancy.append(occupied / max(1, capacity))

    def observe_request_steps(self, steps: int) -> None:
        """Decode steps one completed request consumed (its slot-residency
        in step units)."""
        with self._lock:
            self._req_steps.append(int(steps))

    def count(self, name: str) -> int:
        c = self._counters.get(name)
        return 0 if c is None else int(c.value)

    def unregister(self) -> None:
        """Drop this server's series from the shared registry exposition
        (called on server close): a process that creates and retires many
        servers must not scrape dead servers' counters forever.  The
        local child objects keep working — a closed server's
        ``healthz()`` still reads its final numbers."""
        with self._lock:
            names = list(self._counters)
            gnames = list(self._gauges)
        for name in names:
            self._registry.remove_series("serving_" + name,
                                         server=self._label)
        for name in gnames:
            self._registry.remove_series("serving_" + name,
                                         server=self._label)
        self._registry.remove_series("serving_latency_seconds",
                                     server=self._label)

    def set_count(self, name: str, value: int) -> None:
        """Force a counter to an externally-owned value (the supervisor
        owns worker_restarts — healthz mirrors it, and the registry view
        must agree).  Atomic: concurrent healthz probes mirroring the
        same value must not race a read-then-inc into a wrong total."""
        self._counter(name).set_to(value)

    @staticmethod
    def _pct_ms(lat_sorted, p: float) -> Optional[float]:
        """Nearest-rank percentile of a sorted seconds list, in ms — THE
        percentile definition; healthz and percentile_ms must agree."""
        if not lat_sorted:
            return None
        n = len(lat_sorted)
        idx = min(n - 1, max(0, int(round(p / 100.0 * n)) - 1))
        return lat_sorted[idx] * 1e3

    def percentile_ms(self, p: float) -> Optional[float]:
        with self._lock:
            lat = sorted(self._latencies)
        return self._pct_ms(lat, p)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._counters.items())
        counters = {name: int(c.value) for name, c in items}
        with self._lock:
            lat = sorted(self._latencies)
            rows = list(self._batch_rows)
            occ = list(self._occupancy)
            steps = list(self._req_steps)

        def pct(p):
            ms = self._pct_ms(lat, p)
            return None if ms is None else round(ms, 3)

        return {
            "counters": counters,
            "p50_ms": pct(50),
            "p99_ms": pct(99),
            "mean_batch_rows": (round(sum(rows) / len(rows), 2)
                                if rows else None),
            "mean_slot_occupancy": (round(sum(occ) / len(occ), 4)
                                    if occ else None),
            "mean_request_steps": (round(sum(steps) / len(steps), 2)
                                   if steps else None),
        }
