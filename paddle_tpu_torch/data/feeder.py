"""Sequence-length buckets — a copy of
``paddle_tpu/data/feeder.py::bucket_length`` (framework-free; the port keeps
its own copy so that it never imports the JAX package)."""

from __future__ import annotations

from typing import Sequence

__all__ = ["bucket_length"]

_DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_length(n: int, buckets: Sequence[int] = _DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (n itself past the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return n
