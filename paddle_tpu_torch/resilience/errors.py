"""Typed failure classes for the resilience subsystem — the port's own
copy of the framework-free ``paddle_tpu/resilience/errors.py``.

Each maps a recovery path to a distinct exception so callers (and the
trainer's event plane) can attribute a failure to the tier that produced
it: storage (``CheckpointError``), the input pipeline (``ReaderError``),
the numerics of the step itself (``TooManyBadSteps``), or the cluster
runtime (``GangError`` / ``GangFailedError``).
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["CheckpointError", "ReaderError", "TooManyBadSteps",
           "GangError", "GangFailedError", "GangResized", "SDCDivergence",
           "DCNError", "DCNTimeout", "DCNPartitioned"]


class CheckpointError(RuntimeError):
    """A checkpoint directory failed validation (missing files, CRC
    mismatch, unreadable manifest) or could not be written atomically."""


class ReaderError(RuntimeError):
    """The data reader raised (or kept raising past its retry budget).

    The trainer re-raises reader-side failures under this type so a
    mid-pass crash is attributed to the input pipeline, never to the
    train step that happened to be in flight.
    """


class TooManyBadSteps(RuntimeError):
    """The bad-step guard skipped ``max_bad_steps`` consecutive updates —
    the loss/gradients are persistently non-finite and continuing would
    only burn accelerator time."""


class SDCDivergence(RuntimeError):
    """This rank's in-jit state fingerprint lost the cross-replica vote
    (resilience/integrity.py): its params/optimizer-slots differ from the
    replicas that are bit-identical by construction — the silent-data-
    corruption signature.  Raising it exits the rank nonzero so the
    elastic supervisor expels (shrinks) it and heals the gang from a
    verified checkpoint; the divergence itself is journaled and the
    quarantine marker names this rank in the gang dir."""


class GangError(RuntimeError):
    """A gang coordination primitive failed on the WORKER side: a barrier
    or coordinator-broadcast timed out (a peer likely died mid-protocol).
    The supervisor treats the resulting nonzero exit like any rank death
    and relaunches the gang."""


class GangResized(Exception):
    """Control-flow signal, not a failure: the supervisor published a new
    world while this rank was blocked in a gang barrier (typically the
    save barrier — waiting on a peer that just died).  Carries the new
    ``world`` dict; the trainer catches it at its save sites and runs the
    elastic resize protocol instead of waiting out the barrier timeout.
    A rank that does not catch it exits nonzero and the supervisor falls
    back to the whole-gang relaunch — never less safe than the old path.
    """

    def __init__(self, world: dict) -> None:
        super().__init__(f"gang resized to epoch {world.get('epoch')}: "
                         f"ranks {world.get('ranks')}")
        self.world = dict(world)


class DCNError(GangError):
    """A cross-pod (DCN) transport operation failed.  Subclass of
    ``GangError`` so every existing worker-side handler that treats a
    gang-primitive failure as fatal keeps working unchanged; the typed
    subclasses below add WHICH pod was unreachable and WHY."""

    def __init__(self, message: str, *, pod: Optional[int] = None,
                 op: str = "", attempts: int = 0) -> None:
        super().__init__(message)
        #: pod index the transport attributes the failure to (None when
        #: no single pod could be blamed)
        self.pod = pod
        #: the transport operation that failed (e.g. "exchange sdc-...")
        self.op = op
        #: attempts made (1 + retries) before giving up
        self.attempts = attempts


class DCNTimeout(DCNError):
    """A DCN exchange exhausted its retry budget and the missing pod is
    NOT heartbeating — indistinguishable from pod death on this evidence,
    so the caller should let the normal pod-failure path (supervisor
    watchdog -> elastic shrink of the dcn axis) attribute and expel it."""


class DCNPartitioned(DCNError):
    """A DCN exchange exhausted its retry budget while the missing pod's
    ranks were still heartbeating: the pod is alive but unreachable over
    DCN — a network partition, not a death.  Distinct from
    :class:`DCNTimeout` so the supervisor can expel a partitioned pod
    with "partition" attribution (and tests can pin the difference), and
    distinct from "pod slow", which the bounded retries absorb without
    raising at all."""


class GangFailedError(RuntimeError):
    """The gang supervisor burned its restart budget (or deadline).

    ``reports`` carries per-attempt, per-rank attribution
    (:class:`~paddle_tpu.resilience.cluster.RankReport`): which rank died
    with what exit code, which rank hung and how stale its heartbeat was,
    and which ranks were merely gang-killed alongside the culprit.
    """

    def __init__(self, message: str, *, reports: Optional[List] = None) -> None:
        super().__init__(message)
        self.reports = list(reports or [])
