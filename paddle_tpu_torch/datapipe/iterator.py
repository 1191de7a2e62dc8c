"""Checkpointable shard iterator — O(1)-state resume for the input
pipeline (docs/data.md "Resume and resize").

``ShardSource`` is a reader *creator* (the ``paddle_tpu_torch.data`` reader
protocol: calling it yields batches), plus four capabilities the trainer
duck-types on (``trainer/trainer.py``):

- ``cursor_for(pass_id, next_batch)`` — the tiny JSON cursor
  ``{seed, pass, offset, next_batch, world, rng}`` describing the state
  of the pipeline after ``next_batch`` batches of ``pass_id`` have been
  *stepped*.  Rides every checkpoint manifest (``meta["data_cursor"]``).
  Computed ARITHMETICALLY from the stepped-batch count, so prefetcher
  read-ahead can never leak into a checkpoint.
- ``restore(cursor)`` — point the source at a saved cursor;
  ``--resume=auto`` then re-enters the pass with ZERO replayed samples
  (the trainer's re-read-and-discard fast-forward survives only as the
  fallback for plain readers).
- ``seek(pass_id)`` — align to the trainer's pass loop (no-op when
  already there; rewinds/advances to the pass boundary otherwise).
- ``reshard(world, index, pass_id=..., next_batch=...)`` — adopt a new
  world split mid-pass at a batch boundary: the globally-consumed prefix
  ``offset`` is fixed under the OLD world, then the SAME permutation is
  re-split from it under the new one — no sample duplicated, none
  dropped (the elastic ``ev.Resize`` contract; see datapipe/sampler.py).

Corrupt records raise a typed :class:`~paddle_tpu_torch.datapipe.shards
.ShardCorruptError` naming shard file + record index; with
``skip_corrupt=True`` they are skipped and counted in
``dropped_records`` (mirrored into the trainer's ``_last_extras``), the
batch simply coming up short — data loss is surfaced, never silent.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from paddle_tpu_torch.datapipe.sampler import (pass_permutation, pass_rng_word,
                                         split_positions)
from paddle_tpu_torch.datapipe.shards import ShardCorruptError, ShardDataset
from paddle_tpu_torch.utils.log import logger

__all__ = ["ShardSource", "is_checkpointable_source"]


def is_checkpointable_source(reader: Any) -> bool:
    """The trainer's duck-type: a reader creator whose mid-pass state is
    a restorable cursor (ShardSource or anything matching its surface)."""
    return all(callable(getattr(reader, m, None))
               for m in ("cursor_for", "restore", "seek"))


class ShardSource:
    """Deterministic, checkpointable batch source over a shard set.

    ``world``/``index`` split the seeded permutation per host
    (sampler.split_positions); the default ``(1, 0)`` reads everything —
    the right setting for replica-style gangs (the CPU test harness) and
    single-process SPMD, where ONE process feeds the global batch.  Pass
    ``shard_by_gang=True`` to let the trainer bind the split to the live
    gang (and re-bind it on elastic resizes).

    ``transform`` maps each decoded sample before batching (tokenize,
    reshape) — host-side, deterministic functions only.
    """

    def __init__(self, dataset: Union[str, ShardDataset], *,
                 batch_size: int,
                 seed: Optional[int] = None,
                 shuffle: bool = True,
                 world: int = 1,
                 index: int = 0,
                 shard_by_gang: bool = False,
                 skip_corrupt: bool = False,
                 transform: Optional[Callable[[Any], Any]] = None) -> None:
        from paddle_tpu_torch.utils.flags import FLAGS

        self.dataset = (ShardDataset(dataset) if isinstance(dataset, str)
                        else dataset)
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.seed = int(FLAGS.shuffle_seed if seed is None else seed)
        self.shuffle = bool(shuffle)
        self.shard_by_gang = bool(shard_by_gang)
        self.skip_corrupt = bool(skip_corrupt)
        self.transform = transform
        #: corrupt records skipped under ``skip_corrupt`` (surfaced in the
        #: trainer's ``_last_extras['dropped_records']``)
        self.dropped_records = 0
        self._world = int(world)
        self._index = int(index)
        if not 0 <= self._index < self._world:
            raise ValueError(f"index {index} out of world {world}")
        # cursor: the pass, the globally-consumed offset at batch
        # ``_batch_base``, and the live count of batches yielded this
        # pass (read-ahead included — checkpoints use cursor_for, which
        # takes the STEPPED count from the trainer instead)
        self._pass = 0
        self._offset_base = 0
        self._batch_base = 0
        self._next_batch = 0
        # the just-rolled-over pass's bases (pass, offset_base,
        # batch_base): prefetch read-ahead can exhaust the generator —
        # rolling the cursor to pass+1 — while the trainer still steps
        # the tail of pass p; cursor_for/reshard for THAT pass answer
        # from this stash instead of failing (docs/data.md)
        self._prev: Optional[tuple] = None
        self._perm_key: Optional[tuple] = None
        self._perm: Optional[np.ndarray] = None

    # -- cursor protocol -------------------------------------------------

    @property
    def world(self) -> int:
        return self._world

    @property
    def index(self) -> int:
        return self._index

    @property
    def pass_id(self) -> int:
        return self._pass

    def _offset_at(self, next_batch: int) -> int:
        return (self._offset_base
                + (int(next_batch) - self._batch_base)
                * self.batch_size * self._world)

    def cursor_for(self, pass_id: int, next_batch: int) -> Dict[str, Any]:
        """The durable cursor after ``next_batch`` STEPPED batches of
        ``pass_id`` — O(1) arithmetic off the stepped count, immune to
        prefetch read-ahead."""
        pass_id, next_batch = int(pass_id), int(next_batch)
        if pass_id == self._pass:
            offset = self._offset_at(next_batch)
        elif (self._prev is not None and pass_id == self._prev[0]
              and self._pass == pass_id + 1):
            # read-ahead already rolled the cursor past this pass's end
            # while the trainer still steps its tail (e.g. a preemption
            # checkpoint with --prefetch_depth): answer from the stashed
            # bases so the manifest never loses the cursor
            _, ob, bb = self._prev
            offset = ob + (next_batch - bb) * self.batch_size * self._world
        elif next_batch == 0:
            # a pass boundary the source has not rolled onto yet (or an
            # end-of-pass save asked after rollover — handled above)
            offset = 0
        else:
            raise ValueError(
                f"cursor_for(pass={pass_id}, next_batch={next_batch}) "
                f"disagrees with the source's pass {self._pass}")
        return {"seed": self.seed, "pass": pass_id, "offset": int(offset),
                "next_batch": next_batch, "world": self._world,
                "rng": pass_rng_word(self.seed, pass_id)}

    def state(self) -> Dict[str, Any]:
        """The LIVE cursor (batches yielded, read-ahead included).
        Checkpoints should prefer ``cursor_for`` with the stepped count."""
        return self.cursor_for(self._pass, self._next_batch)

    def restore(self, cursor: Dict[str, Any]) -> None:
        """Adopt a saved cursor: the next batch read is the one the
        checkpoint recorded as next — zero replayed samples."""
        seed = int(cursor["seed"])
        if seed != self.seed:
            logger.warning(
                "ShardSource.restore: cursor seed %d overrides configured "
                "seed %d (the saved permutation defines the data order)",
                seed, self.seed)
            self.seed = seed
        self._pass = int(cursor["pass"])
        self._offset_base = int(cursor["offset"])
        self._batch_base = int(cursor.get("next_batch", 0))
        self._next_batch = self._batch_base
        self._prev = None
        self._perm = self._perm_key = None

    def seek(self, pass_id: int) -> None:
        """Align to the trainer's pass loop: entering a different pass
        resets the cursor to that pass's start."""
        if int(pass_id) != self._pass:
            self._pass = int(pass_id)
            self._offset_base = self._batch_base = self._next_batch = 0
            self._prev = None
            self._perm = self._perm_key = None

    def _unroll_to(self, pass_id: int, next_batch: int) -> bool:
        """Un-roll a read-ahead pass rollover: point the cursor back at
        ``pass_id`` with its stashed bases (the trainer is still mid-pass
        there).  Returns True when the stash applied."""
        if (self._prev is not None and int(pass_id) == self._prev[0]
                and self._pass == int(pass_id) + 1):
            self._pass, self._offset_base, self._batch_base = (
                self._prev[0], self._prev[1], self._prev[2])
            self._next_batch = int(next_batch)
            self._prev = None
            self._perm = self._perm_key = None
            return True
        return False

    def reshard(self, world: int, index: int, *, pass_id: int,
                next_batch: int) -> None:
        """Re-split the SAME permutation under a new world at a batch
        boundary: fix the globally-consumed offset under the OLD world,
        then stride from it with the new one.  ``next_batch`` is the
        stepped-batch count (prefetched-but-unstepped batches must be
        discarded by the caller — the trainer closes its prefetcher and
        re-creates the pass iterator).  A read-ahead rollover past the
        pass end is un-rolled first, so the offset is never recomputed
        from zeroed bases mid-pass."""
        world, index = int(world), int(index)
        if not 0 <= index < world:
            raise ValueError(f"index {index} out of world {world}")
        if not self._unroll_to(pass_id, next_batch):
            self.seek(pass_id)
        offset = self._offset_at(next_batch)
        self._world, self._index = world, index
        self._offset_base = offset
        self._batch_base = self._next_batch = int(next_batch)

    def bind_world(self, world: int, index: int) -> None:
        """Initial world binding (train start) — positionally identical
        to a reshard at the current cursor."""
        self.reshard(world, index, pass_id=self._pass,
                     next_batch=self._next_batch)

    # -- iteration -------------------------------------------------------

    def _permutation(self) -> np.ndarray:
        key = (self.seed, self._pass, len(self.dataset), self.shuffle)
        if self._perm is None or self._perm_key != key:
            self._perm = pass_permutation(len(self.dataset), self.seed,
                                          self._pass, shuffle=self.shuffle)
            self._perm_key = key
        return self._perm

    def batches_remaining(self) -> int:
        """Full per-rank batches left in the current pass (every rank
        agrees: the global window is ``batch_size * world`` samples)."""
        n = len(self.dataset)
        consumed = self._offset_at(self._next_batch)
        return max(0, (n - consumed) // (self.batch_size * self._world))

    def _read_batch(self, start: int, perm: np.ndarray) -> List[Any]:
        rows: List[Any] = []
        last_err = None
        for pos in split_positions(
                min(start + self.batch_size * self._world, len(perm)),
                start, self._world, self._index):
            try:
                sample = self.dataset.read(int(perm[pos]))
            except ShardCorruptError as e:
                if not self.skip_corrupt:
                    raise
                self.dropped_records += 1
                last_err = e
                logger.warning(
                    "ShardSource: dropped corrupt record (%s; %d dropped "
                    "total)", e, self.dropped_records)
                continue
            rows.append(self.transform(sample) if self.transform else sample)
        if not rows and last_err is not None:
            # EVERY record of the window was corrupt: yielding nothing
            # while still consuming the window would desync the
            # trainer's stepped-batch count from the cursor arithmetic
            # (a later resume/resize would re-train consumed samples) —
            # total corruption fails loudly instead
            raise ShardCorruptError(
                f"every record in the batch window at offset {start} is "
                f"corrupt ({self.dropped_records} dropped total; last: "
                f"{last_err})", path=last_err.path, record=last_err.record)
        return rows

    def __call__(self) -> Iterator[List[Any]]:
        """One pass of batches from the current cursor.  Natural
        exhaustion rolls the cursor to ``(pass+1, offset 0)``; abandoning
        the iterator mid-pass (preemption, resize) leaves the cursor
        restorable.  Reads live state every batch, so a ``reshard``
        between batches takes effect without rebuilding the iterator."""
        entered_pass = self._pass
        while True:
            if self._pass != entered_pass:
                return  # seek/restore moved the cursor under us
            perm = self._permutation()
            nb = self._next_batch
            start = self._offset_at(nb)
            if start + self.batch_size * self._world > len(perm):
                # end of pass: roll the cursor to the next pass boundary,
                # stashing this pass's bases — a prefetching trainer is
                # still STEPPING this pass's tail, and its checkpoints/
                # reshards must keep answering for it (cursor_for/
                # _unroll_to)
                self._prev = (self._pass, self._offset_base,
                              self._batch_base)
                self._pass += 1
                self._offset_base = self._batch_base = self._next_batch = 0
                self._perm = self._perm_key = None
                return
            rows = self._read_batch(start, perm)
            self._next_batch = nb + 1
            yield rows

    def close(self) -> None:
        self.dataset.close()
