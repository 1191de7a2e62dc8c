"""Typed failure classes for the serving tier — the port's copy of
``paddle_tpu/serving/errors.py``, same names and bases.

The serving contract (docs/serving.md) is *reply-or-typed-error, never a
silent drop*: every request either receives its outputs or exactly one of
these exceptions, each naming the tier that rejected it — admission
control (``ShedError``), the deadline plane (``DeadlineExceeded``), the
circuit breaker (``CircuitOpenError``), the worker runtime
(``WorkerCrashed``), the model itself (``InferenceFailed``), or the
server lifecycle (``ServerClosed``).  Attribution first, so an
overloaded queue is never misdiagnosed as a broken model.
"""

from __future__ import annotations

__all__ = ["ServingError", "InvalidRequestError", "ShedError",
           "DeadlineExceeded", "CircuitOpenError", "WorkerCrashed",
           "InferenceFailed", "ServerClosed", "QuotaExceeded"]


class ServingError(RuntimeError):
    """Base class for every typed serving failure."""


class InvalidRequestError(ServingError, ValueError):
    """The request itself is malformed (e.g. more rows than the server's
    ``max_batch`` can ever select) — rejected at admission.  Subclasses
    ``ValueError`` too: it is a client bug, not a load condition, but a
    client catching ``ServingError`` for its shed/backoff accounting must
    still see it typed."""


class ShedError(ServingError):
    """Admission control rejected the request *immediately*: the bounded
    queue is full (or the server is past its overload watermark).  The
    client should back off / retry against another replica — queuing it
    to certain death would only burn its deadline."""


class DeadlineExceeded(ServingError):
    """The request's deadline is (or became) unmeetable.

    Raised at admission when ``now + estimated_queue_wait +
    estimated_service_time`` already exceeds the deadline (infeasible —
    rejected before queuing), or delivered as the reply when the deadline
    expired while queued or in flight."""


class QuotaExceeded(ServingError):
    """The tenancy tier rejected the request: the tenant's own
    token-bucket quota is exhausted, or — under aggregate contention —
    the tenant is past its weighted fair share (``fair_share=True``).
    Like :class:`ShedError` it is a load condition, not a model failure;
    unlike a shed it names exactly ONE tenant, so a flooding tenant can
    never read as a whole-fleet incident.  ``tenant`` carries the name;
    a tenant at its quota gets this error, never silent starvation of
    others (docs/serving.md "Fleet serving")."""

    def __init__(self, message: str, *, tenant: str = "",
                 fair_share: bool = False) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.fair_share = fair_share


class CircuitOpenError(ServingError):
    """The circuit breaker is OPEN: the compiled forward failed
    ``threshold`` consecutive times and requests are failed fast until a
    half-open probe succeeds.  Fail-fast beats queuing into a known-bad
    backend."""


class WorkerCrashed(ServingError):
    """The inference worker died (or was declared hung) while this
    request was queued or in flight.  The supervisor restarts the worker
    with bounded backoff; the in-flight batch is failed with this error
    rather than silently dropped."""


class InferenceFailed(ServingError):
    """The model call itself raised, or produced non-finite outputs with
    ``nonfinite='error'``.  The original exception (when any) rides as
    ``__cause__``; counts toward the circuit breaker."""


class ServerClosed(ServingError):
    """The server is shut down (or burned its worker-restart budget) —
    nothing will ever execute this request."""
