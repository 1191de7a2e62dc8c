"""Composable reader pipeline — the port's own copy of the framework-free
``paddle_tpu/data/reader.py`` (the v2 reader decorators).

Reference: python/paddle/v2/reader/decorator.py (map_readers, buffered,
shuffle, batched via paddle.batch, compose, chain, firstn) and the minibatch
helper.  A *reader creator* is a zero-arg callable returning an iterator of
samples; decorators wrap creators.  ``buffered`` runs the source in a
background thread — the analog of PyDataProvider2's async pool
(reference: paddle/gserver/dataproviders/PyDataProvider2.cpp:195-212).
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Any, Callable, Iterable, Iterator, List

__all__ = [
    "batch",
    "shuffle",
    "buffered",
    "map_readers",
    "compose",
    "chain",
    "firstn",
    "cache",
]

Reader = Callable[[], Iterator[Any]]


def batch(reader: Reader, batch_size: int, drop_last: bool = True) -> Reader:
    """Group samples into lists of batch_size (paddle.batch analog).

    drop_last defaults True, as in the JAX package: every batch has one
    shape."""

    def creator():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return creator


def shuffle(reader: Reader, buf_size: int, seed: int = 0) -> Reader:
    def creator():
        rng = _random.Random(seed)
        buf: List[Any] = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for s in buf:
                    yield s
                buf = []
        rng.shuffle(buf)
        for s in buf:
            yield s

    return creator


def buffered(reader: Reader, size: int) -> Reader:
    """Background-thread prefetch (PyDataProvider2 async-pool analog)."""

    _end = object()

    def creator():
        q: queue.Queue = queue.Queue(maxsize=size)

        def worker():
            try:
                for sample in reader():
                    q.put(sample)
            finally:
                q.put(_end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is _end:
                break
            yield s

    return creator


def map_readers(func: Callable, *readers: Reader) -> Reader:
    def creator():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return creator


def compose(*readers: Reader) -> Reader:
    """Zip readers; each sample is the tuple of component samples (flattened
    for tuple components, matching the v2 compose semantics)."""

    def fuse(*items):
        out: List[Any] = []
        for it in items:
            if isinstance(it, tuple):
                out.extend(it)
            else:
                out.append(it)
        return tuple(out)

    return map_readers(fuse, *readers)


def chain(*readers: Reader) -> Reader:
    def creator():
        return itertools.chain(*[r() for r in readers])

    return creator


def firstn(reader: Reader, n: int) -> Reader:
    def creator():
        return itertools.islice(reader(), n)

    return creator


def cache(reader: Reader) -> Reader:
    """Materialize once, replay from memory (CacheOnePassInMemory analog)."""
    data: List[Any] = []
    filled = [False]

    def creator():
        if not filled[0]:
            data.extend(reader())
            filled[0] = True
        return iter(data)

    return creator
