"""``paddle.v2.reader`` — counterpart of ``paddle_tpu/v2/reader.py``: the
reader decorators the reference exposes (python/paddle/v2/reader/
decorator.py) and ``creator``'s two reader creators (creator.py).

The decorators are the port's reader combinators (``data/reader.py``);
``compose`` is the v2 one, which checks that its readers are aligned."""

from __future__ import annotations

import itertools

from paddle_tpu_torch.data.reader import (  # noqa: F401
    batch,
    buffered,
    cache,
    chain,
    firstn,
    map_readers,
    shuffle,
)

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle",
    "ComposeNotAligned", "firstn", "creator",
]

_END = object()


class ComposeNotAligned(ValueError):
    """``compose``'s readers yield different numbers of samples
    (reference: v2/reader/decorator.py:44)."""


def compose(*readers, check_alignment: bool = True):
    """Zip readers; each sample is the tuple of the readers' samples, tuple
    samples flattened into it.  With ``check_alignment`` (the reference's
    default) readers of different lengths raise ``ComposeNotAligned``;
    without it the shortest ends the stream."""

    def fuse(items):
        out = []
        for it in items:
            if isinstance(it, tuple):
                out.extend(it)
            else:
                out.append(it)
        return tuple(out)

    def reader():
        its = [r() for r in readers]
        if not check_alignment:
            for items in zip(*its):
                yield fuse(items)
            return
        # zip_longest ends when every reader has: a sentinel in a row means
        # the lengths differ
        for items in itertools.zip_longest(*its, fillvalue=_END):
            if any(it is _END for it in items):
                raise ComposeNotAligned(
                    "compose: component readers have different lengths")
            yield fuse(items)

    return reader


class _Creator:
    """``paddle.v2.reader.creator`` (creator.py)."""

    @staticmethod
    def np_array(x):
        """Yield the elements along the first axis of a numpy array (a 0-d
        array yields itself)."""

        def reader():
            if getattr(x, "ndim", 1) < 1:
                yield x
                return
            for e in x:
                yield e

        return reader

    @staticmethod
    def text_file(path):
        """Yield the file's lines without their trailing newline."""

        def reader():
            with open(path, "r") as f:
                for line in f:
                    yield line.rstrip("\n")

        return reader


creator = _Creator()
