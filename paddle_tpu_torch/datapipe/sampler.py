"""Deterministic global shuffle — a seeded permutation over record
indices, split per host (docs/data.md "Determinism contract").

The whole shuffle STATE is the tiny tuple ``(seed, pass)``: the
permutation itself is recomputed on demand from a ``numpy``
``SeedSequence([seed, pass_id])`` stream, never stored — which is what
makes the iterator cursor O(1) (datapipe/iterator.py) instead of an
O(dataset) shuffle-buffer snapshot.

Host split: rank ``r`` of ``W`` reads the permutation positions
``p >= offset`` with ``(p - offset) % W == r`` — a strided split of ONE
global sequence.  Because SPMD training consumes the same number of
batches on every rank, the globally-consumed prefix after ``k`` batches
of per-rank size ``B`` is exactly ``offset + k*B*W`` positions — so an
elastic resize at a batch boundary re-splits the SAME permutation from
that offset under the new world size with no duplicated and no dropped
sample (pinned by tests/test_datapipe.py).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["pass_permutation", "split_positions", "pass_rng_word"]


def pass_permutation(n: int, seed: int, pass_id: int,
                     shuffle: bool = True) -> np.ndarray:
    """The global record order of one pass: a permutation of
    ``arange(n)`` drawn from ``SeedSequence([seed, pass_id])`` (each pass
    reshuffles deterministically), or plain ``arange`` with
    ``shuffle=False``."""
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        int(pass_id)]))
    return rng.permutation(n)


def pass_rng_word(seed: int, pass_id: int) -> int:
    """One deterministic 32-bit word per (seed, pass) — the cursor's
    ``rng`` field, available to sample-level augmentation randomness so
    a restored iterator continues the exact random stream."""
    ss = np.random.SeedSequence([int(seed), int(pass_id)])
    return int(ss.generate_state(1, dtype=np.uint32)[0])


def split_positions(n: int, offset: int, world: int,
                    index: int) -> Iterator[int]:
    """Permutation positions owned by rank ``index`` of ``world`` from
    global ``offset``: ``offset + index, offset + index + world, ...``
    (strictly below ``n``).  The union over ranks is exactly
    ``[offset, n)`` — every position once."""
    if not 0 <= index < world:
        raise ValueError(f"rank index {index} out of world {world}")
    return iter(range(int(offset) + int(index), int(n), int(world)))
