"""Circuit breaker around the served forward — the port's copy of
``paddle_tpu/serving/breaker.py``.

Classic three-state machine (CLOSED -> OPEN on ``threshold`` consecutive
failures; OPEN -> HALF_OPEN after ``cooldown_s``; HALF_OPEN -> CLOSED
after ``probes_to_close`` consecutive probe successes, or straight back
to OPEN on a probe failure).  Exists for the failure mode retries make
*worse*: a backend that deterministically faults (poisoned weights, a
wedged device, a NaN-producing batch pattern) would otherwise absorb every
request's full deadline before failing it — the breaker converts that
into an immediate typed :class:`CircuitOpenError` and spends exactly one
probe batch per cooldown window discovering recovery.
"""

from __future__ import annotations

import threading
import time

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, threshold: int = 5, cooldown_s: float = 5.0,
                 probes_to_close: int = 1, clock=time.monotonic) -> None:
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.probes_to_close = int(probes_to_close)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._probe_successes = 0
        self._opened_at = 0.0
        self.trips = 0  # CLOSED/HALF_OPEN -> OPEN transitions, for metrics

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = self.HALF_OPEN
            self._probe_successes = 0
        return self._state

    def allow(self) -> bool:
        """May a batch execute right now?  OPEN past its cooldown lets
        probes through (HALF_OPEN); OPEN inside the cooldown fails fast."""
        with self._lock:
            return self._state_locked() != self.OPEN

    def record_success(self) -> None:
        with self._lock:
            st = self._state_locked()
            if st == self.HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.probes_to_close:
                    self._state = self.CLOSED
                    self._consecutive_failures = 0
            else:
                self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            st = self._state_locked()
            if st == self.HALF_OPEN:
                # a failed probe re-opens immediately: the backend is
                # still sick, restart the cooldown clock
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.trips += 1
                return
            self._consecutive_failures += 1
            if (st == self.CLOSED
                    and self._consecutive_failures >= self.threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.trips += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state_locked(),
                    "consecutive_failures": self._consecutive_failures,
                    "trips": self.trips}
