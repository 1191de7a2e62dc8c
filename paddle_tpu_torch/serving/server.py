"""`InferenceServer` — the overload-safe runtime in front of a served
forward; the port of ``paddle_tpu/serving/server.py`` (docs/serving.md).

The pipeline per request:

    submit() ── admission control ──> BatchQueue ──> supervised worker
      │   (closed? breaker open?          │    (coalesce to shape bucket,
      │    deadline feasible?             │     sweep expired, execute
      │    queue bounded?)                │     behind the breaker)
      └── typed rejection, immediately    └── reply or typed error

Guarantees, as in the reference:

- **reply-or-typed-error** — every accepted request's future resolves to
  outputs or to one of ``serving.errors``; rejections raise immediately
  from ``submit``;
- **deadline honesty** — a reply delivered after its deadline is
  converted to ``DeadlineExceeded``, so the success-latency p99 is
  bounded by the configured deadline by construction;
- **graceful degradation** — under queue pressure the configured tier
  ladder steps down (e.g. a shorter ``max_len``) before anything is shed.

Two execution modes share that contract:

- ``mode="bucket"`` (default): one-shot calls of a plain callable
  ``fn(feed[, tier_opts]) -> {name: array}``, coalesced into power-of-two
  row buckets;
- ``mode="generation"``: continuous slot-based batching over a
  :class:`~paddle_tpu_torch.serving.slots.SlotBackend` — the persistent
  decode table advanced one step at a time, finished requests' slots
  recycled to queued requests between steps.

The worker thread runs with grad mode off and on the backend's CUDA device
(``_worker_context``): both are per-thread settings, and a new thread
starts with grad mode on and device 0.  The compute dtype is process-wide
(``FLAGS``), so the worker serves under the caller's policy.

Generation mode takes the slot table's decode-speed options: speculative
decoding (``spec_k``, ``draft``), the prefix cache (``prefix_cache_mb``)
and host paging of slots (``slot_page_pool_mb``).  Each cycle re-admits
parked slots before new requests, and pages one cold resident out when the
table is full and requests queue.

Not ported yet; each raises :class:`~paddle_tpu_torch.utils.error
.ConfigError` naming its ROADMAP.md item: ``start(compile_cache=)`` and an
``InferenceModel`` in bucket mode, Queue 1 item 7; ``start(preflight=True)``
and request tracing (``submit(trace_attrs=)``), item 9.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.serving.batching import (BatchQueue, Request,
                                               ServingFuture, batch_bucket,
                                               canonicalize_feed,
                                               merge_feeds, split_outputs,
                                               warmup_bucket_feeds)
from paddle_tpu_torch.serving.breaker import CircuitBreaker
from paddle_tpu_torch.serving.errors import (CircuitOpenError,
                                             DeadlineExceeded,
                                             InferenceFailed,
                                             InvalidRequestError,
                                             ServerClosed, ShedError,
                                             WorkerCrashed)
from paddle_tpu_torch.serving.metrics import ServerMetrics
from paddle_tpu_torch.serving.worker import WorkerSupervisor
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.log import logger

__all__ = ["InferenceServer"]


class _WorkerKilled(Exception):
    """Chaos-injected worker death (resilience.chaos.kill_worker)."""


def _not_ported(what: str, item: int) -> ConfigError:
    return ConfigError(f"{what} is not ported to paddle_tpu_torch yet "
                       f"(ROADMAP.md, Queue 1 item {item})")


def _host(v):
    """A bucket-mode output as a host array (a device tensor is copied)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return v


def _has_nonfinite(outputs: Dict[str, Any]) -> bool:
    for v in outputs.values():
        a = np.asarray(v)
        if a.dtype.kind == "f" and a.size and not np.all(np.isfinite(a)):
            return True
    return False


class InferenceServer:
    """Serve a forward with batching, shedding, deadlines, and a supervised
    worker.

    ``model`` (bucket mode) is a callable ``fn(feed) -> {name: array}``; a
    callable taking a second argument receives the active degradation-tier
    options dict (``fn(feed, tier_opts)``).  Outputs may be numpy arrays or
    tensors (copied to the host in the worker).

    With ``mode="generation"``, ``model`` is a :class:`~paddle_tpu_torch
    .serving.slots.SlotBackend` and the worker runs the continuous slot loop
    (evict -> harvest -> admit -> one decode step); ``slots`` bounds both
    the decode table and admission (a request's rows must fit the table),
    and the degradation ladder's ``{"max_len": n}`` tiers cap the decode
    budget of newly admitted requests under queue pressure.  ``spec_k``,
    ``draft``, ``prefix_cache_mb`` and ``slot_page_pool_mb`` arm the slot
    table's speculative decoding, prefix cache and host page pool
    (``SlotScheduler``'s ``spec_k``, ``draft``, ``prefix_cache_mb`` and
    ``page_pool_mb``); none of them changes an answer.
    """

    RUNNING, FAILED, CLOSED = "running", "failed", "closed"

    def __init__(
        self,
        model,
        *,
        mode: str = "bucket",
        slots: int = 8,
        max_batch: int = 8,
        batch_delay_ms: float = 2.0,
        max_queue: int = 64,
        default_deadline_ms: float = 1000.0,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 5.0,
        breaker_probes: int = 1,
        max_restarts: int = 3,
        restart_backoff_s: float = 0.05,
        max_restart_backoff_s: float = 2.0,
        hang_timeout_s: float = 0.0,
        degrade: Optional[List[dict]] = None,
        degrade_at: Optional[List[int]] = None,
        nonfinite: str = "error",
        spec_k: int = 0,
        draft=None,
        prefix_cache_mb: float = 0.0,
        slot_page_pool_mb: float = 0.0,
        clock=time.monotonic,
        sleep=time.sleep,
    ) -> None:
        if nonfinite not in ("error", "allow"):
            raise ValueError("nonfinite must be 'error' or 'allow'")
        if mode not in ("bucket", "generation"):
            raise ValueError("mode must be 'bucket' or 'generation'")
        self.model = model
        self.mode = mode
        if mode == "generation":
            # the slot table bounds admission: a request's rows must fit it
            max_batch = int(slots)
        self.max_batch = int(max_batch)
        self.batch_delay_s = float(batch_delay_ms) / 1e3
        self.default_deadline_ms = float(default_deadline_ms)
        self.nonfinite = nonfinite
        self._clock = clock
        self.metrics = ServerMetrics()
        self.queue = BatchQueue(max_queue)
        self.breaker = CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            probes_to_close=breaker_probes, clock=clock)
        self._scheduler = None
        if mode == "generation":
            from paddle_tpu_torch.serving.slots import SlotScheduler

            if not (hasattr(model, "prefill") and hasattr(model, "step_fn")):
                raise TypeError(
                    "mode='generation' needs a SlotBackend (prefill/"
                    "step_fn/readout — serving/slots.py), got "
                    f"{type(model).__name__}")
            self._scheduler = SlotScheduler(
                model, slots=slots, clock=clock, spec_k=spec_k,
                draft=draft, prefix_cache_mb=prefix_cache_mb,
                page_pool_mb=slot_page_pool_mb)
            self._runner = None
        else:
            self._runner = self._make_runner(model)
        # the worker thread's device: the backend's, never a fallback
        dev = getattr(model, "device", None)
        self._device = None if dev is None else torch.device(dev)
        # degradation ladder: tier 0 = full service; thresholds default to
        # evenly-spaced queue-depth watermarks
        self.degrade = list(degrade or [])
        if degrade_at is not None:
            if len(degrade_at) != len(self.degrade):
                raise ValueError("degrade_at must match degrade in length")
            self.degrade_at = [int(d) for d in degrade_at]
        else:
            n = len(self.degrade)
            self.degrade_at = [max(1, (max_queue * (i + 1)) // (n + 1))
                               for i in range(n)]
        self._service_ema: Optional[float] = None  # seconds per batch
        #: clock seconds of start() -> ready; None until the readiness
        #: gate passes
        self.cold_start_s: Optional[float] = None
        self._model_info: Optional[dict] = None   # set_model_info()
        self._model_loaded_at: Optional[float] = None
        self._state = self.RUNNING
        self._ready = False
        self._fail_reason: Optional[str] = None
        self._in_flight: List[Request] = []
        self._kill_worker = False
        #: generation-mode hot-swap staging: (scheduler, model, info),
        #: flipped by the worker once the current table fully drains
        self._swap_next = None
        self._spec_seen = None   # the last wide step's stats counted
        self.supervisor = WorkerSupervisor(
            (self._serve_generation_once if mode == "generation"
             else self._serve_once),
            max_restarts=max_restarts,
            backoff_s=restart_backoff_s,
            max_backoff_s=max_restart_backoff_s,
            hang_timeout_s=hang_timeout_s,
            on_crash=self._on_worker_crash,
            on_give_up=self._on_worker_give_up,
            # a relaunched generation worker starts from a FRESH table: the
            # crash may have left the carry poisoned, and its resident
            # requests were already failed typed by on_crash.  Late-bound:
            # a hot-swap replaces self._scheduler
            on_relaunch=((lambda: self._scheduler.reset())
                         if self._scheduler is not None else None),
            clock=clock,
            sleep=sleep,
            worker_context=self._worker_context,
        )

    # ------------------------------------------------------------------
    # model adapters
    # ------------------------------------------------------------------

    def _make_runner(self, model):
        """Normalize the backend to ``runner(feed, tier_opts)``."""
        if getattr(model, "infer", None) is not None and hasattr(
                model, "topology"):
            raise _not_ported("bucket mode over an InferenceModel "
                              "(config/deploy.py)", 7)
        if not callable(model):
            raise TypeError(
                "model must be a callable fn(feed[, tier_opts]) -> "
                "{name: array}")
        try:
            takes_tier = len(inspect.signature(model).parameters) >= 2
        except (TypeError, ValueError):
            takes_tier = False
        if takes_tier:
            return lambda feed, tier_opts: model(feed, tier_opts)
        return lambda feed, tier_opts: model(feed)

    def _worker_context(self):
        """Per-thread settings of the worker: grad mode off, and the
        backend's CUDA device current (``torch.cuda.device`` raises when
        no card is present: the worker never drops to the CPU)."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self._device is not None and self._device.type == "cuda":
            stack.enter_context(torch.cuda.device(self._device))
        return stack

    # ------------------------------------------------------------------
    # lifecycle: warmup/readiness gate -> running -> closed/failed
    # ------------------------------------------------------------------

    def start(self, *, warmup_feed=None, warmup: bool = True,
              preflight: bool = False,
              compile_cache=None) -> "InferenceServer":
        """Warm every batch bucket of every given feed's canonical shape,
        then start the supervised worker.  ``warmup_feed`` is one feed dict
        or a list of them (one per expected sequence-length bucket)."""
        if preflight:
            raise _not_ported("start(preflight=True) (the analysis tier)", 9)
        if compile_cache is not None:
            raise _not_ported("start(compile_cache=)", 7)
        t_start = self._clock()
        feeds = (warmup_feed if isinstance(warmup_feed, (list, tuple))
                 else [warmup_feed] if warmup_feed is not None else [])
        if warmup:
            if self.mode == "generation":
                self._warmup_generation(feeds)
            else:
                self._warmup(feeds)
        self.supervisor.start()
        self._ready = True
        self.cold_start_s = self._clock() - t_start
        return self

    def _buckets(self) -> List[int]:
        # derived from batch_bucket itself so warmup never drifts from the
        # hot path's ladder: exactly the shapes merge_feeds can produce
        return sorted({batch_bucket(r, self.max_batch)
                       for r in range(1, self.max_batch + 1)})

    def _warmup(self, feeds: List[Dict[str, Any]]) -> None:
        """Run the callable once at every batch bucket of every feed, under
        the worker's per-thread settings."""
        if not feeds:
            return
        t0 = self._clock()
        n = 0
        with self._worker_context():
            for feed in feeds:
                for padded in warmup_bucket_feeds(feed, self._buckets()):
                    self._runner(padded, {})
                    n += 1
        self.metrics.inc("warmup_compiles", n)
        logger.info("serving warmup: %d bucket shape(s) over %d feed(s) "
                    "in %.2fs", n, len(feeds), self._clock() - t0)

    def _warmup_generation(self, feeds: List[Dict[str, Any]]) -> None:
        """Run the continuous path once before ready: prefill + write at
        every admission row bucket of every feed shape, plus one full
        admit -> step -> harvest cycle.  On the card this builds and loads
        the kernel libraries and warms the allocator, so the first request
        does not pay for them."""
        sched = self._scheduler
        if not feeds:
            feeds = [self.model.example_feed(1)]
        buckets = self._buckets()
        t0 = self._clock()
        before = sched.compiled_programs()
        synth = None
        with self._worker_context():
            for feed in feeds:
                canon, _, sig = canonicalize_feed(feed)
                one = {name: (tuple(p[:1] for p in v)
                              if isinstance(v, tuple) else v[:1])
                       for name, v in canon.items()}

                def synth(n, one=one, sig=sig):
                    return [Request(feed=one, rows=1, signature=sig,
                                    future=ServingFuture(), deadline=None,
                                    t_submit=t0, max_len=1)
                            for _ in range(n)]

                for bucket in buckets:
                    sched.admit(synth(min(bucket, sched.slots)))
                    sched.reset()
            # one full cycle: step, finalize and release
            sched.admit(synth(1))
            sched.step()
            sched.harvest()
            sched.reset()
        # the synthetic traffic must not read as served traffic on healthz
        sched.admitted = sched.recycled = sched.steps_run = 0
        sched.spec_drafted = sched.spec_accepted = sched.spec_steps = 0
        sched.last_spec = None
        if sched.prefix_cache is not None:
            # the synthetic feed's entry and its hit/miss counts are
            # warmup noise, not traffic
            sched.prefix_cache.clear()
            sched.prefix_cache.hits = sched.prefix_cache.misses = 0
            sched.prefix_cache.evictions = 0
        self.metrics.inc("warmup_compiles",
                         max(0, sched.compiled_programs() - before))
        logger.info("generation warmup: %d admission bucket(s) over %d "
                    "feed(s) + 1 step cycle in %.2fs",
                    len(buckets), len(feeds), self._clock() - t0)

    @property
    def ready(self) -> bool:
        return self._ready and self._state == self.RUNNING

    # ------------------------------------------------------------------
    # zero-downtime hot-swap
    # ------------------------------------------------------------------

    def swap_model(self, model, *, info: Optional[dict] = None):
        """Replace the serving backend between batches.  Bucket mode: the
        worker reads ``self._runner`` once per popped batch, so every batch
        is served entirely by one model.  Generation mode drains instead of
        cutting over: a fresh slot table for the incoming
        :class:`~paddle_tpu_torch.serving.slots.SlotBackend` is built in
        THIS caller's thread, then the swap is staged — the worker stops
        admitting, lets resident requests finish on the old table, and
        flips scheduler and model once it is empty, host page pool
        included.  The new table keeps the old one's speculation, prefix
        cache and page pool settings; the old prefix cache is cleared at
        the flip (its keys embed the retired fingerprint).  The incoming
        backend must live on the served device (the worker thread's).
        Returns the previous model."""
        if self.mode != "bucket":
            from paddle_tpu_torch.serving.slots import SlotScheduler

            if not (hasattr(model, "prefill") and hasattr(model, "step_fn")):
                raise TypeError(
                    "generation swap needs a SlotBackend (prefill/step_fn/"
                    f"readout), got {type(model).__name__}")
            dev = getattr(model, "device", None)
            if (None if dev is None else torch.device(dev)) != self._device:
                raise ValueError(
                    f"generation swap onto device {dev} from the served "
                    f"device {self._device}")
            old = self._scheduler
            sched = SlotScheduler(
                model, slots=old.slots, clock=self._clock,
                spec_k=old.spec_k, draft=old.proposer,
                prefix_cache_mb=(0.0 if old.prefix_cache is None else
                                 old.prefix_cache.max_bytes / (1 << 20)),
                page_pool_mb=(0.0 if old.pager is None else
                              old.pager.max_bytes / (1 << 20)))
            prev = self.model
            self._swap_next = (sched, model, info)
            return prev
        runner = self._make_runner(model)
        prev = self.model
        self.model = model
        self._runner = runner   # atomic attribute store: the swap point
        self.set_model_info(info)
        self.metrics.inc("model_swaps")
        return prev

    def set_model_info(self, info: Optional[dict]) -> None:
        """Attach the served artifact's identity to the health surface:
        ``healthz()['model']`` plus the registry gauge
        ``serving_model_version``."""
        self._model_info = dict(info) if info else None
        self._model_loaded_at = time.time() if info else None
        if self._model_info is not None:
            v = self._model_info.get("version")
            if v is not None:
                self.metrics.gauge("model_version").set(float(v))

    def close(self, join_timeout: float = 2.0) -> None:
        if self._state == self.CLOSED:
            return
        self._state = self.CLOSED
        self._fail_requests(
            self.queue.close(),
            lambda: ServerClosed("server shut down"), "server_closed")
        self.supervisor.stop(join_timeout)
        # the worker generation is retired: a batch still executing will
        # discard its results instead of completing futures, so fail the
        # in-flight requests too (set-once: a no-op for any the worker
        # finished before the stop)
        in_flight, self._in_flight = self._in_flight, []
        self._fail_requests(
            in_flight,
            lambda: ServerClosed("server shut down with the batch in flight"),
            "server_closed")
        # retire this server's series from the shared registry (healthz()
        # keeps reading the detached counters)
        self.metrics.unregister()

    # ------------------------------------------------------------------
    # admission control
    # ------------------------------------------------------------------

    def submit(self, feed: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               max_len: Optional[int] = None,
               session_id: Optional[str] = None,
               trace_attrs: Optional[Dict[str, Any]] = None
               ) -> ServingFuture:
        """Admit one request (a dict feed with a leading batch dim on every
        part) or raise a typed rejection immediately.  Returns a
        :class:`ServingFuture` that is guaranteed to resolve.

        ``max_len`` (generation mode) is the request's own decode budget;
        it must fit the slot table's depth (the backend's ``max_len``).
        ``session_id`` scopes the request's prefix-cache and draft-corpus
        keys to its chat session."""
        if trace_attrs is not None:
            raise _not_ported("request tracing (submit(trace_attrs=))", 9)
        self.metrics.inc("submitted")
        if self._state != self.RUNNING:
            self.metrics.inc("server_closed")
            raise ServerClosed(self._fail_reason or "server is closed")
        if not self._ready:
            self.metrics.inc("shed")
            raise ShedError("server is still warming up (not ready)")
        if max_len is not None:
            depth = getattr(self.model, "max_len", None)
            if self.mode != "generation":
                self.metrics.inc("invalid_request")
                raise InvalidRequestError(
                    "max_len is a generation-mode request option")
            if max_len < 1 or (depth is not None and max_len > depth):
                self.metrics.inc("invalid_request")
                raise InvalidRequestError(
                    f"request max_len {max_len} outside the slot table's "
                    f"depth 1..{depth} — raise the backend's max_len")
        try:
            canon, rows, sig = canonicalize_feed(feed)
        except ValueError as e:
            self.metrics.inc("invalid_request")
            raise InvalidRequestError(str(e)) from e
        if rows > self.max_batch:
            # an oversized request could never be selected by the batcher
            self.metrics.inc("invalid_request")
            raise InvalidRequestError(
                f"request carries {rows} rows but the server batches at "
                f"most {self.max_batch} — split the request")
        if rows == 0:
            # a zero-row request never reaches the device; the backends the
            # port serves have no shape inference to reply empty from
            self.metrics.inc("invalid_request")
            raise InvalidRequestError(
                "zero-row request on a backend without shape inference — "
                "nothing to execute")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        now = self._clock()
        deadline = now + deadline_ms / 1e3 if deadline_ms > 0 else None
        if not self.breaker.allow():
            self.metrics.inc("breaker_rejected")
            raise CircuitOpenError(
                "circuit breaker is open — backend failing; retry after "
                f"{self.breaker.cooldown_s:.1f}s")
        if deadline is not None and self._service_ema is not None:
            # feasibility estimate: one service time, plus the queue's
            # backlog in units of batches ahead of us
            depth = self.queue.depth()
            est = self._service_ema * (1.0 + depth / max(1, self.max_batch))
            if now + est > deadline:
                self.metrics.inc("deadline_infeasible")
                raise DeadlineExceeded(
                    f"infeasible deadline: {deadline_ms:.1f}ms budget vs "
                    f"~{est * 1e3:.1f}ms estimated queue+service time")
        req = Request(feed=canon, rows=rows, signature=sig,
                      future=ServingFuture(), deadline=deadline,
                      t_submit=now, deadline_ms=deadline_ms,
                      max_len=max_len, session_id=session_id)
        try:
            self.queue.offer(req)
        except ShedError:
            self.metrics.inc("shed")
            raise
        self.metrics.inc("accepted")
        return req.future

    def infer(self, feed: Dict[str, Any],
              deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None,
              max_len: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Synchronous submit + wait."""
        fut = self.submit(feed, deadline_ms, max_len=max_len)
        if timeout is None and deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if timeout is None:
            timeout = (deadline_ms / 1e3 + 30.0) if deadline_ms > 0 else None
        return fut.result(timeout)

    # ------------------------------------------------------------------
    # the worker side
    # ------------------------------------------------------------------

    def _pick_tier(self, depth: int) -> int:
        tier = 0
        for i, watermark in enumerate(self.degrade_at):
            if depth >= watermark:
                tier = i + 1
        return tier

    def _fail_requests(self, reqs: List[Request], exc_factory,
                       counter: str) -> None:
        n = sum(r.future._complete(error=exc_factory()) for r in reqs)
        if n:
            self.metrics.inc(counter, n)

    def _serve_once(self, gen: int) -> None:
        batch, expired = self.queue.pop_batch(
            max_rows=self.max_batch,
            batch_delay_s=self.batch_delay_s,
            timeout=0.05,
            est_service_s=self._service_ema or 0.0,
            clock=self._clock)
        self._fail_requests(
            expired,
            lambda: DeadlineExceeded("deadline expired while queued"),
            "deadline_expired")
        if not batch:
            return
        if not self.breaker.allow():
            self._fail_requests(
                batch, lambda: CircuitOpenError("circuit breaker is open"),
                "breaker_rejected")
            return
        tier = self._pick_tier(self.queue.depth())
        tier_opts = self.degrade[tier - 1] if tier else {}
        if tier:
            for r in batch:
                r.tier = tier
            self.metrics.inc("degraded", len(batch))
        rows = sum(r.rows for r in batch)
        # the batch is in flight from the moment it leaves the queue: a
        # failure anywhere past this point (merge included) must reach the
        # crash handler with these futures still attributed
        self._in_flight = batch
        try:
            merged, slices, _ = merge_feeds(batch, self.max_batch)
        except Exception as e:  # noqa: BLE001 — structural mismatch
            self._fail_requests(
                batch,
                lambda: InvalidRequestError(
                    f"requests could not be merged into one batch: "
                    f"{type(e).__name__}: {e}"),
                "invalid_request")
            self._in_flight = []
            return
        self.supervisor.note_busy(gen)
        try:
            self._execute(gen, batch, merged, slices, rows, tier_opts)
        except BaseException:
            # crash/kill path: leave _in_flight populated — the monitor's
            # crash handler fails those futures with WorkerCrashed
            self.supervisor.note_idle(gen)
            raise
        if self.supervisor.current(gen):
            self._in_flight = []
        self.supervisor.note_idle(gen)

    def _record_failure(self, gen: int) -> None:
        # breaker state belongs to the LIVE worker: an abandoned (hung,
        # replaced) worker that finally un-wedges must not pin failures or
        # successes on the healthy backend serving current traffic.  The
        # reference also journals the trip (obs/journal.py, not ported)
        if not self.supervisor.current(gen):
            return
        trips_before = self.breaker.trips
        self.breaker.record_failure()
        if self.breaker.trips > trips_before:
            self.metrics.inc("breaker_trips")

    def _execute(self, gen: int, batch: List[Request], merged, slices,
                 rows: int, tier_opts: dict) -> None:
        if self._kill_worker:
            self._kill_worker = False
            raise _WorkerKilled("chaos: worker killed mid-batch")
        t0 = self._clock()
        try:
            outputs = {k: _host(v)
                       for k, v in self._runner(merged, tier_opts).items()}
        except _WorkerKilled:
            raise
        except Exception as e:  # noqa: BLE001 — a model fault, not a crash
            self._record_failure(gen)

            def _mk(e=e):
                err = InferenceFailed(
                    f"model call failed: {type(e).__name__}: {e}")
                err.__cause__ = e
                return err

            self._fail_requests(batch, _mk, "inference_failed")
            return
        dt = self._clock() - t0
        if self.supervisor.current(gen):
            self._service_ema = (dt if self._service_ema is None
                                 else 0.8 * self._service_ema + 0.2 * dt)
            self.metrics.observe_batch(rows)
        if self.nonfinite == "error" and _has_nonfinite(outputs):
            self._record_failure(gen)
            self._fail_requests(
                batch,
                lambda: InferenceFailed(
                    "model produced non-finite outputs (poisoned batch?)"),
                "inference_failed")
            return
        if self.supervisor.current(gen):
            self.breaker.record_success()
        per_req = split_outputs(outputs, slices)
        now = self._clock()
        for r, out in zip(batch, per_req):
            if not self.supervisor.current(gen):
                return  # abandoned worker: its results are unwanted
            if r.deadline is not None and now > r.deadline:
                if r.future._complete(error=DeadlineExceeded(
                        f"completed {1e3 * (now - r.deadline):.1f}ms past "
                        f"the {r.deadline_ms:.1f}ms deadline")):
                    self.metrics.inc("deadline_expired")
            elif r.future._complete(result=out):
                self.metrics.inc("completed")
                self.metrics.observe_latency(now - r.t_submit)

    # ------------------------------------------------------------------
    # the generation worker: continuous slot loop (serving/slots.py)
    # ------------------------------------------------------------------

    def _complete_harvested(self, gen: int, req: Request, outputs,
                            steps: int) -> None:
        """Reply to one harvested request with the bucket path's exact
        deadline/nonfinite honesty."""
        now = self._clock()
        if (self.nonfinite == "error"
                and not np.all(np.isfinite(outputs["scores"]))):
            # rows are independent in the slot table, so poison stays in
            # its own request — co-resident slots are unaffected
            self._record_failure(gen)
            if req.future._complete(error=InferenceFailed(
                    "decode produced non-finite scores (poisoned "
                    "request?)")):
                self.metrics.inc("inference_failed")
            return
        if self.supervisor.current(gen):
            self.breaker.record_success()
        if req.deadline is not None and now > req.deadline:
            if req.future._complete(error=DeadlineExceeded(
                    f"completed {1e3 * (now - req.deadline):.1f}ms past "
                    f"the {req.deadline_ms:.1f}ms deadline")):
                self.metrics.inc("deadline_expired")
        elif req.future._complete(result=outputs):
            self.metrics.inc("completed")
            dt = now - req.t_submit
            self.metrics.observe_latency(dt)
            self.metrics.observe_request_steps(steps)
            if self.supervisor.current(gen):
                self._service_ema = (dt if self._service_ema is None
                                     else 0.8 * self._service_ema + 0.2 * dt)

    def _serve_generation_once(self, gen: int) -> None:
        """One cycle of the continuous loop: evict expired slots, harvest
        finished ones, admit queued requests into the freed slots, run ONE
        decode step for every occupied slot.  Every phase keeps the bucket
        path's reply-or-typed-error guarantees."""
        sched = self._scheduler
        # staged hot-swap: admission is paused while a swap is pending
        # (free=0 below), so the table drains; once empty — host page pool
        # included — flip scheduler and model, and clear the old prefix
        # cache (its keys embed the retired fingerprint)
        if (self._swap_next is not None and sched.occupied() == 0
                and (sched.pager is None or len(sched.pager) == 0)):
            new_sched, new_model, info = self._swap_next
            self._swap_next = None
            if sched.prefix_cache is not None:
                sched.prefix_cache.clear()
            self.model = new_model
            self._scheduler = sched = new_sched
            self.set_model_info(info)
            self.metrics.inc("model_swaps")
        live = lambda: self.supervisor.current(gen)  # noqa: E731
        # deadline plane first: an expired resident can never reply in
        # time, and its slot is capacity short requests are waiting on
        evicted = sched.evict_expired(self._clock(), commit=live)
        if evicted:
            self._fail_requests(
                [r for r, _ in evicted],
                lambda: DeadlineExceeded("deadline expired mid-generation "
                                         "(slot evicted)"),
                "deadline_expired")
            freed = sum(n for _, n in evicted)
            self.metrics.inc("slot_evicted", freed)
            self.metrics.inc("slot_recycled", freed)
        # harvest is the cycle's one host sync (the previous step's launches
        # complete here): it must sit inside the busy window or a wedged
        # card never trips hang detection
        self.supervisor.note_busy(gen)
        try:
            harvested = sched.harvest(commit=live)
        finally:
            self.supervisor.note_idle(gen)
        for req, outputs, steps in harvested:
            if not live():
                return  # abandoned worker: its results are unwanted
            self.metrics.inc("slot_recycled", req.rows)
            self._complete_harvested(gen, req, outputs, steps)
        if sched.pager is not None and self._swap_next is None:
            # re-admit parked slots FIRST: paged work predates anything in
            # the queue and must not be overtaken indefinitely
            self.supervisor.note_busy(gen)
            try:
                sched.page_in(commit=live)
            finally:
                self.supervisor.note_idle(gen)
        # admit into freed slots: with residents decoding, the pop must not
        # block — the coalescing window only applies to an idle table.  The
        # pop runs even with a FULL table (max_rows=0 selects nothing): its
        # sweep keeps failing already-expired queued requests
        free = (0 if self._swap_next is not None
                else sched.free_count())  # draining: admission paused
        occupied = sched.occupied()
        batch, expired = self.queue.pop_batch(
            max_rows=free,
            batch_delay_s=self.batch_delay_s if occupied == 0 else 0.0,
            timeout=0.05 if occupied == 0 else 0.0,
            est_service_s=self._service_ema or 0.0,
            clock=self._clock)
        self._fail_requests(
            expired,
            lambda: DeadlineExceeded("deadline expired while queued"),
            "deadline_expired")
        if batch and not self.breaker.allow():
            self._fail_requests(
                batch,
                lambda: CircuitOpenError("circuit breaker is open"),
                "breaker_rejected")
            batch = []
        if batch:
            tier = self._pick_tier(self.queue.depth())
            tier_opts = self.degrade[tier - 1] if tier else {}
            if tier:
                for r in batch:
                    r.tier = tier
                self.metrics.inc("degraded", len(batch))
            # the popped batch joins the in-flight set BEFORE the prefill:
            # a crash or hang inside admit must fail these futures too
            self._in_flight = sched.resident_requests() + batch
            self.supervisor.note_busy(gen)
            try:
                sched.admit(batch, limit_cap=tier_opts.get("max_len"),
                            commit=live)
            except _WorkerKilled:
                raise
            except ValueError as e:
                # a malformed admitted feed (e.g. a source longer than the
                # table's fixed src_len) is a CLIENT bug: reject typed and
                # never feed the breaker
                self._fail_requests(
                    batch,
                    lambda: InvalidRequestError(
                        f"request cannot enter the slot table: {e}"),
                    "invalid_request")
            except Exception as e:  # noqa: BLE001 — a model fault
                self._record_failure(gen)

                def _mk(e=e):
                    err = InferenceFailed(
                        f"prefill failed: {type(e).__name__}: {e}")
                    err.__cause__ = e
                    return err

                self._fail_requests(batch, _mk, "inference_failed")
            finally:
                self.supervisor.note_idle(gen)
        # paging: with the table full and work still queued, move ONE cold
        # resident to the host pool a cycle so the next cycle's admission
        # has a slot (one a cycle bounds the copies and the churn)
        if (sched.pager is not None and self._swap_next is None
                and self.queue.depth() > 0 and sched.free_count() == 0):
            self.supervisor.note_busy(gen)
            try:
                sched.page_out_victim(commit=live)
            finally:
                self.supervisor.note_idle(gen)
        # the table's residents are the in-flight set: a worker death past
        # this point must fail exactly these futures (WorkerCrashed)
        self._in_flight = sched.resident_requests()
        if not self._in_flight:
            return
        if self._kill_worker:
            self._kill_worker = False
            raise _WorkerKilled("chaos: worker killed mid-step")
        self.supervisor.note_busy(gen)
        try:
            ran = sched.step(commit=live)
        except _WorkerKilled:
            self.supervisor.note_idle(gen)
            raise
        except Exception as e:  # noqa: BLE001 — a model fault, not a crash
            self.supervisor.note_idle(gen)
            self._record_failure(gen)
            residents = sched.reset()

            def _mk(e=e):
                err = InferenceFailed(
                    f"decode step failed: {type(e).__name__}: {e}")
                err.__cause__ = e
                return err

            self._fail_requests(residents, _mk, "inference_failed")
            self._in_flight = []
            return
        except BaseException:
            # crash/kill path: leave _in_flight populated for the crash
            # handler
            self.supervisor.note_idle(gen)
            raise
        self.supervisor.note_idle(gen)
        if ran:
            self.metrics.inc("gen_steps")
            self.metrics.observe_slots(sched.occupied(), sched.slots)
            spec = sched.last_spec
            if spec is not None and spec is not self._spec_seen:
                # the per-step speculation stats: the tokens each drained
                # wide step emitted (the reference stamps them, and the
                # accepted drafts, on each resident's trace span; the
                # accepted count is spec_accepted_tokens_total)
                self._spec_seen = spec
                self.metrics.inc("spec_emitted_tokens_total",
                                 int(spec[0].sum()))

    # ------------------------------------------------------------------
    # supervision callbacks + chaos hooks
    # ------------------------------------------------------------------

    def _on_worker_crash(self, exc: Exception) -> None:
        in_flight, self._in_flight = self._in_flight, []
        self._fail_requests(
            in_flight,
            lambda: WorkerCrashed(f"worker died mid-batch: {exc}"),
            "worker_crashed")

    def _on_worker_give_up(self, exc: Exception) -> None:
        self._state = self.FAILED
        self._fail_reason = (f"worker restart budget exhausted "
                             f"({self.supervisor.max_restarts}): {exc}")
        self._fail_requests(
            self.queue.close(),
            lambda: WorkerCrashed(self._fail_reason), "worker_crashed")

    def chaos_kill_worker(self) -> None:
        """Chaos hook (``resilience.chaos.kill_worker``): the worker dies
        with the next popped batch (or decode step) in flight."""
        self._kill_worker = True

    # ------------------------------------------------------------------
    # health surface
    # ------------------------------------------------------------------

    def healthz(self) -> dict:
        # the supervisor owns the relaunch count — mirror it into the
        # registry view FIRST so healthz, /metrics, and worker.restarts
        # never disagree
        self.metrics.set_count("worker_restarts", self.supervisor.restarts)
        if self._scheduler is not None:
            # the scheduler owns the decode-speed counters (speculation,
            # prefix cache, paging; forced page-outs included): mirror them
            # into the registry BEFORE the snapshot so healthz and the
            # registry agree
            self._mirror_decode_counters(self._scheduler)
        snap = self.metrics.snapshot()
        out = {
            "ready": self.ready,
            "state": self._state,
            "mode": self.mode,
            "queue_depth": self.queue.depth(),
            "breaker": self.breaker.snapshot(),
            "worker": {"alive": self.supervisor.alive(),
                       "restarts": self.supervisor.restarts,
                       "max_restarts": self.supervisor.max_restarts},
            "service_ema_ms": (round(self._service_ema * 1e3, 3)
                               if self._service_ema is not None else None),
            # no compile cache yet (ROADMAP.md Queue 1 item 7): hits and
            # misses stay 0; warmup_compiles counts the kernel libraries
            # the warmup loaded (SlotScheduler.compiled_programs)
            "cold_start": {
                "cold_start_s": (round(self.cold_start_s, 3)
                                 if self.cold_start_s is not None else None),
                "compile_cache_hits": self.metrics.count(
                    "compile_cache_hits"),
                "compile_cache_misses": self.metrics.count(
                    "compile_cache_misses"),
                "warmup_compiles": self.metrics.count("warmup_compiles"),
            },
            **snap,
        }
        info = self._model_info
        if info is not None:
            tct = info.get("train_commit_time")
            fresh = (round(time.time() - float(tct), 3)
                     if tct is not None else None)
            self.metrics.gauge("model_freshness_seconds").set(fresh)
            out["model"] = {
                "bundle": info.get("bundle"),
                "version": info.get("version"),
                "fingerprint": info.get("fingerprint"),
                "quantize": info.get("quantize"),
                "loaded_at": self._model_loaded_at,
                "freshness_s": fresh,
            }
        if self._scheduler is not None:
            sched = self._scheduler
            out["slots"] = {
                "capacity": sched.slots,
                "occupied": sched.occupied(),
                "free": sched.free_count(),
                "admitted": sched.admitted,
                "recycled": sched.recycled,
                "steps": sched.steps_run,
            }
        return out

    def _mirror_decode_counters(self, sched) -> None:
        if sched.pager is not None:
            p = sched.pager.stats()
            self.metrics.set_count("slots_paged_out", p["paged_out"])
            self.metrics.set_count("slots_paged_in", p["paged_in"])
        if sched.spec_k > 0:
            self.metrics.set_count("spec_draft_tokens_total",
                                   sched.spec_drafted)
            self.metrics.set_count("spec_accepted_tokens_total",
                                   sched.spec_accepted)
            self.metrics.gauge("spec_accept_rate").set(round(
                sched.spec_accepted / sched.spec_drafted
                if sched.spec_drafted else 0.0, 4))
        if sched.prefix_cache is not None:
            c = sched.prefix_cache.stats()
            self.metrics.set_count("prefix_cache_hits", c["hits"])
            self.metrics.set_count("prefix_cache_misses", c["misses"])

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
