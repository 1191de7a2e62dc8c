"""Supervised inference worker — the port's copy of
``paddle_tpu/serving/worker.py``.

One worker thread drains the batch queue; one monitor thread supervises
it with the discipline of the reference's gang supervisor:

- **crash** — an exception escaping the serve loop kills the worker; the
  monitor fails the in-flight batch with a typed :class:`WorkerCrashed`
  (reply-or-error, never a silent drop) and relaunches after exponential
  backoff (``backoff_s * 2^attempt``, capped), bounded by
  ``max_restarts``;
- **hang** — a batch stuck on the device past ``hang_timeout_s`` (Python
  threads cannot be killed) gets *abandoned*: its generation counter is
  retired so a later wake-up finds its results unwanted (futures are
  set-once and already failed), and a fresh worker takes over;
- **budget exhausted** — ``on_give_up`` flips the server into its failed
  state, draining the queue with typed errors.

The worker thread runs its whole loop inside ``worker_context()`` (the
server passes grad mode off and the backend's CUDA device: both are
per-thread state, so the caller's settings do not reach a new thread).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, ContextManager, Optional

from paddle_tpu_torch.utils.log import logger

__all__ = ["WorkerSupervisor"]


class WorkerSupervisor:
    def __init__(
        self,
        serve_once: Callable[[int], None],   # serve_once(generation)
        *,
        max_restarts: int = 3,
        backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
        hang_timeout_s: float = 0.0,         # 0 = hang detection off
        poll_s: float = 0.01,
        on_crash: Callable[[Exception], None],
        on_give_up: Callable[[Exception], None],
        on_relaunch: Optional[Callable[[], None]] = None,
        clock=time.monotonic,
        sleep=time.sleep,
        worker_context: Callable[[], ContextManager] = contextlib.nullcontext,
    ) -> None:
        self._serve_once = serve_once
        self._worker_context = worker_context
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.hang_timeout_s = float(hang_timeout_s)
        self.poll_s = float(poll_s)
        self._on_crash = on_crash
        self._on_give_up = on_give_up
        self._on_relaunch = on_relaunch
        self._clock = clock
        self._sleep = sleep
        self.restarts = 0
        self._generation = 0  # tpu-lint: guarded-by=none - monotonic int bumped only under _lock; lock-free == probes are advisory: an abandoned worker runs at most one extra loop, and every state COMMIT re-checks under the slot table's lock
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None  # tpu-lint: guarded-by=none - swapped under _lock; readers snapshot the reference once (atomic under the GIL) and at worst see the previous generation's thread for one poll
        self._monitor: Optional[threading.Thread] = None
        self._crash_exc: Optional[Exception] = None  # tpu-lint: guarded-by=none - written only by the dying worker thread; the monitor reads it only after alive() goes False, and thread death publishes the write
        self._busy_since: Optional[float] = None  # tpu-lint: guarded-by=none - atomic reference swap by the live worker only; the monitor snapshots once per poll, so a stale value shifts hang detection by at most one poll

    # -- the worker side ----------------------------------------------------

    def _worker_main(self, gen: int) -> None:
        try:
            with self._worker_context():
                while not self._stop.is_set() and gen == self._generation:
                    self._serve_once(gen)
        except Exception as e:  # noqa: BLE001 — any escape is a crash
            if gen == self._generation:
                self._crash_exc = e

    def note_busy(self, gen: int) -> None:
        if gen == self._generation:
            self._busy_since = self._clock()

    def note_idle(self, gen: int) -> None:
        if gen == self._generation:
            self._busy_since = None

    def current(self, gen: int) -> bool:
        """Is ``gen`` still the live worker generation?  An abandoned
        (hung-then-replaced) worker uses this to stop touching shared
        state when it finally wakes up."""
        return gen == self._generation and not self._stop.is_set()

    # -- the supervisor side ------------------------------------------------

    def start(self) -> None:
        self._spawn_worker()
        self._monitor = threading.Thread(
            target=self._monitor_main, name="serving-monitor", daemon=True)
        self._monitor.start()

    def _spawn_worker(self) -> None:
        with self._lock:
            self._generation += 1
            gen = self._generation
            self._crash_exc = None
            self._busy_since = None
        if gen > 1 and self._on_relaunch is not None:
            # stateful workers (the generation-mode slot table) rebuild
            # their state BEFORE the replacement starts serving: a crashed
            # step may have left the carry poisoned, and the in-flight
            # requests it held were already failed typed by on_crash
            self._on_relaunch()
        with self._lock:
            if gen != self._generation:
                return  # stop() raced the relaunch: stay down
            self._worker = threading.Thread(
                target=self._worker_main, args=(gen,),
                name=f"serving-worker-{gen}", daemon=True)
            self._worker.start()

    def alive(self) -> bool:
        w = self._worker
        return w is not None and w.is_alive()

    def _monitor_main(self) -> None:
        while not self._stop.is_set():
            crashed: Optional[Exception] = None
            busy_since = self._busy_since  # single read: the worker's
            # note_idle may null the field between a test and a subtract
            if not self.alive():
                crashed = self._crash_exc or RuntimeError("worker died")
            elif (self.hang_timeout_s > 0 and busy_since is not None
                  and self._clock() - busy_since > self.hang_timeout_s):
                crashed = TimeoutError(
                    f"worker hung: batch in flight for more than "
                    f"{self.hang_timeout_s:.3f}s")
            if crashed is not None:
                if self._stop.is_set():  # shutdown, not a crash
                    return
                # retire the generation FIRST: a hung worker that
                # un-wedges during the backoff below must find itself
                # abandoned immediately — if it could still pop a batch
                # before _spawn_worker bumps the generation, that batch
                # would be silently dropped when the bump lands mid-run
                with self._lock:
                    self._generation += 1
                self._on_crash(crashed)
                if self.restarts >= self.max_restarts:
                    # no relaunch happens for the budget-exhausting crash:
                    # `restarts` counts relaunches actually performed
                    logger.error(
                        "serving worker burned its restart budget "
                        "(%d restarts): %s", self.max_restarts, crashed)
                    self._on_give_up(crashed)
                    return
                self.restarts += 1
                backoff = min(self.backoff_s * (2 ** (self.restarts - 1)),
                              self.max_backoff_s)
                logger.warning(
                    "serving worker %s (%s); restart %d/%d after %.3fs",
                    "hung" if isinstance(crashed, TimeoutError) else "crashed",
                    crashed, self.restarts, self.max_restarts, backoff)
                self._sleep(backoff)
                if self._stop.is_set():
                    return
                self._spawn_worker()
            self._sleep(self.poll_s)

    def stop(self, join_timeout: float = 2.0) -> None:
        self._stop.set()
        with self._lock:
            self._generation += 1  # retire the live worker generation
        for t in (self._worker, self._monitor):
            if t is not None and t is not threading.current_thread():
                t.join(join_timeout)
        # drop the owner's callbacks: they are bound to it, so keeping them
        # would hold a stopped owner (a closed server and its model) alive
        # until the cycle collector runs.  A worker that outlived the join
        # finds _stop set and never calls serve_once again
        self._serve_once = self._on_crash = self._on_give_up = _ignore
        self._on_relaunch, self._worker_context = None, contextlib.nullcontext


def _ignore(*_args) -> None:
    """A stopped supervisor's callbacks."""
