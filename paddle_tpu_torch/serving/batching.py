"""Bounded, deadline-aware dynamic micro-batching — the port's copy of
``paddle_tpu/serving/batching.py``.

Requests batch together iff their feed signatures match: sequence dims are
padded up the feeder's bucket ladder, and a merged batch is padded to a
power-of-two row bucket by REPLICATING rows (real, valid data), so a batch
never invents a new shape or a zero-length sequence.

Admission is bounded: ``BatchQueue.offer`` raises :class:`ShedError` the
moment the queue is full.  Requests whose deadline expires while queued are
swept out at pop time and returned to the caller, which completes them with
:class:`DeadlineExceeded`; they never reach the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.data.feeder import bucket_length
from paddle_tpu_torch.serving.errors import ShedError

__all__ = ["ServingFuture", "Request", "BatchQueue", "canonicalize_feed",
           "merge_feeds", "split_outputs", "batch_bucket",
           "warmup_bucket_feeds"]


class ServingFuture:
    """Reply slot for one request: exactly one of a result dict or a typed
    error, set once (late writers lose)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[Dict[str, np.ndarray]] = None
        self._error: Optional[Exception] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, result=None, error: Optional[Exception] = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self._error = error
            self._event.set()
            return True

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self, timeout: Optional[float] = None) -> Optional[Exception]:
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        return self._error


@dataclass
class Request:
    feed: Dict[str, Any]          # canonicalized (seq dims bucket-padded)
    rows: int
    signature: Tuple
    future: ServingFuture
    deadline: Optional[float]     # absolute, clock() domain; None = none
    t_submit: float
    deadline_ms: Optional[float] = None   # original budget, for reporting
    tier: int = 0                 # degradation tier chosen at execution
    max_len: Optional[int] = None  # per-request decode budget (None = the
    #                                backend's max_len)
    session_id: Optional[str] = None  # chat session scope of the prefix
    #                                   cache (not ported yet; carried)
    tenant: Optional[str] = None  # fleet tenancy attribution (None =
    #                               untenanted)
    # request tracing (the reference's obs/trace.py, not ported yet: these
    # stay ""/None)
    req_id: str = ""
    span: Any = None
    qspan: Any = None


def _pad_dim1(arr: np.ndarray, to: int) -> np.ndarray:
    if arr.ndim < 2 or arr.shape[1] >= to:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[1] = (0, to - arr.shape[1])
    return np.pad(arr, pad)


def canonicalize_feed(feed: Dict[str, Any]
                      ) -> Tuple[Dict[str, Any], int, Tuple]:
    """Normalize one request's feed into its shape bucket: every rank >= 2
    part of a tuple-valued (sequence) input has its dim 1 padded up to the
    feeder's bucket ladder.  Returns ``(canonical_feed, rows, signature)``."""
    canon: Dict[str, Any] = {}
    rows = None
    sig: List[Tuple] = []
    for name in sorted(feed):
        v = feed[name]
        parts = list(v) if isinstance(v, tuple) else [v]
        sig.append((name, len(parts) if isinstance(v, tuple) else -1))
        out_parts = []
        for p in parts:
            a = np.asarray(p)
            if a.ndim == 0:
                raise ValueError(
                    f"serving feed {name!r} must be batched arrays "
                    f"(got a scalar)")
            if isinstance(v, tuple) and a.ndim >= 2:
                a = _pad_dim1(a, bucket_length(a.shape[1]))
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise ValueError(
                    f"serving feed has inconsistent batch dims: {name!r} "
                    f"carries {a.shape[0]} rows, expected {rows}")
            out_parts.append(a)
            sig.append((name, a.shape[1:], str(a.dtype)))
        canon[name] = tuple(out_parts) if isinstance(v, tuple) else out_parts[0]
    if rows is None:
        raise ValueError("serving feed is empty")
    return canon, rows, tuple(sig)


def batch_bucket(rows: int, max_batch: int) -> int:
    """Smallest power of two >= rows, capped at max_batch."""
    b = 1
    while b < rows and b < max_batch:
        b *= 2
    return min(b, max_batch)


def _pad_rows(arr: np.ndarray, to: int) -> np.ndarray:
    if arr.shape[0] >= to:
        return arr
    # replicate the last row: real data, never a zero-length sequence
    reps = np.repeat(arr[-1:], to - arr.shape[0], axis=0)
    return np.concatenate([arr, reps], axis=0)


def warmup_bucket_feeds(feed: Dict[str, Any],
                        buckets) -> List[Dict[str, Any]]:
    """One warmup feed per batch bucket: canonicalize, slice to ONE row (a
    multi-row feed must not leave the small buckets cold), replicate up
    each bucket — built from the primitives ``merge_feeds`` batches with,
    so warmed shapes never drift from the hot path's."""
    canon, _, _ = canonicalize_feed(feed)
    one = {name: (tuple(p[:1] for p in v) if isinstance(v, tuple)
                  else v[:1])
           for name, v in canon.items()}
    return [{name: (tuple(_pad_rows(p, bucket) for p in v)
                    if isinstance(v, tuple) else _pad_rows(v, bucket))
             for name, v in one.items()}
            for bucket in buckets]


def merge_feeds(reqs: List[Request], max_batch: int
                ) -> Tuple[Dict[str, Any], List[Tuple[int, int]], int]:
    """Concatenate same-signature request feeds along the batch dim and pad
    to the power-of-two batch bucket by replication.  Returns ``(merged,
    slices, rows)``: per-request ``(start, stop)`` row slices and the TRUE
    row count (``merged`` rows ``[rows:]`` are replicas)."""
    slices: List[Tuple[int, int]] = []
    row = 0
    for r in reqs:
        slices.append((row, row + r.rows))
        row += r.rows
    bucket = batch_bucket(row, max_batch)
    merged: Dict[str, Any] = {}
    for name, v in reqs[0].feed.items():
        if isinstance(v, tuple):
            merged[name] = tuple(
                _pad_rows(np.concatenate([r.feed[name][i] for r in reqs],
                                         axis=0), bucket)
                for i in range(len(v)))
        else:
            merged[name] = _pad_rows(
                np.concatenate([r.feed[name] for r in reqs], axis=0), bucket)
    return merged, slices, row


def split_outputs(outputs: Dict[str, np.ndarray],
                  slices: List[Tuple[int, int]]) -> List[Dict[str, np.ndarray]]:
    """Per-request row slices of a merged batch's outputs; a rank-0 output
    (a cost or metric head) goes to every request whole."""
    res = []
    for a, b in slices:
        per: Dict[str, np.ndarray] = {}
        for k, v in outputs.items():
            arr = np.asarray(v)
            per[k] = arr if arr.ndim == 0 else arr[a:b]
        res.append(per)
    return res


class BatchQueue:
    """FIFO of :class:`Request` with a hard depth bound and shape-aware
    batch extraction.  The head request defines the batch's signature; the
    pop waits up to ``batch_delay_s`` for more same-signature rows (or
    until the batch bucket is full), then sweeps expired requests out.
    Multi-producer-safe; one consumer (the supervised worker) at a time."""

    def __init__(self, max_queue: int) -> None:
        self.max_queue = int(max_queue)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False  # tpu-lint: guarded-by=none - monotonic False->True flag; a stale lock-free read only delays observing shutdown by one poll (close() still wakes waiters under _cv)

    def depth(self) -> int:
        with self._cv:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def offer(self, req: Request) -> None:
        with self._cv:
            if self._closed:
                raise ShedError("queue is closed")
            if len(self._q) >= self.max_queue:
                raise ShedError(
                    f"queue full ({self.max_queue} requests) — shedding")
            self._q.append(req)
            self._cv.notify_all()

    def pop_batch(self, *, max_rows: int, batch_delay_s: float,
                  timeout: float, est_service_s: float = 0.0,
                  clock=time.monotonic
                  ) -> Tuple[List[Request], List[Request]]:
        """Extract one batch.  Returns ``(batch, expired)``: ``batch`` is
        same-signature requests totalling <= ``max_rows`` rows, oldest
        first; ``expired`` are same-signature requests whose deadline
        cannot survive ``est_service_s`` more seconds, and other-signature
        requests already past their deadline — the caller completes those
        with ``DeadlineExceeded`` (never a silent drop).  Both empty on
        timeout or close."""
        hard_deadline = clock() + timeout
        with self._cv:
            while not self._q:
                if self._closed:
                    return [], []
                rem = hard_deadline - clock()
                if rem <= 0:
                    return [], []
                self._cv.wait(min(rem, 0.05))
            sig = self._q[0].signature
            # coalescing window: wait for more same-signature rows
            window_end = clock() + batch_delay_s
            while not self._closed:
                rows = sum(r.rows for r in self._q if r.signature == sig)
                if rows >= max_rows:
                    break
                rem = window_end - clock()
                if rem <= 0:
                    break
                self._cv.wait(min(rem, 0.05))
            batch: List[Request] = []
            keep: List[Request] = []
            expired: List[Request] = []
            now = clock()
            rows = 0
            for r in self._q:
                if r.signature != sig:
                    # already-dead work must not occupy the bounded queue
                    # and shed live traffic
                    if r.deadline is not None and now > r.deadline:
                        expired.append(r)
                    else:
                        keep.append(r)
                elif (r.deadline is not None
                      and now + est_service_s > r.deadline):
                    expired.append(r)
                elif rows + r.rows <= max_rows:
                    batch.append(r)
                    rows += r.rows
                else:
                    keep.append(r)
            self._q = deque(keep)
            self._cv.notify_all()
            return batch, expired

    def close(self) -> List[Request]:
        """Close the queue and return every still-queued request so the
        caller can fail them with a typed error."""
        with self._cv:
            self._closed = True
            drained = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        return drained
