"""Request plumbing for the slot table — a copy of the framework-free parts
of ``paddle_tpu/serving/batching.py``: ``ServingFuture``, ``Request``,
``canonicalize_feed``, ``batch_bucket`` and ``merge_feeds``.

Requests batch together iff their feed signatures match: sequence dims are
padded up the feeder's bucket ladder, and a merged batch is padded to a
power-of-two row bucket by REPLICATING rows (real, valid data).  The bounded
``BatchQueue`` waits for the server slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.data.feeder import bucket_length

__all__ = ["ServingFuture", "Request", "canonicalize_feed", "batch_bucket",
           "merge_feeds"]


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
    max_len: Optional[int] = None  # per-request decode budget (None = the
    #                                backend's max_len)


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
