"""``paddle_tpu_torch.datapipe`` — the deterministic sharded data
pipeline, counterpart of ``paddle_tpu/datapipe`` (framework-free; the
port keeps its own copy, with the same ``.ptshard`` format byte for byte).

The production input tier the reference devotes ``gserver/dataproviders``
to (PyDataProvider2 feeding the trainer), rebuilt index-first
(docs/data.md):

- **indexed record shards** (``shards.py``): CRC-per-record files with a
  footer index for O(1) random access, written as atomically-published
  CRC-manifested sets; ``write_shard_set`` packs any ``paddle_tpu_torch.data``
  reader (also ``python -m paddle_tpu_torch data pack``);
- **deterministic global shuffle** (``sampler.py``): a seeded
  permutation over record indices, recomputed — never stored — from
  ``(seed, pass)``, strided per host;
- **checkpointable iteration** (``iterator.py``): ``ShardSource``'s
  entire state is a tiny cursor ``(seed, pass, offset, next_batch)``
  that rides the checkpoint manifest — ``--resume=auto`` restores the
  cursor with ZERO replayed samples, and an elastic resize re-splits the
  same permutation with no duplicated or dropped sample;
- **sequence packing** (``packing.py``): multiple short sequences share
  one padded row with segment ids / position offsets plumbed through
  masking, the RNN carries, and the sequence losses (``--data_pack``).
"""

from paddle_tpu_torch.datapipe.iterator import ShardSource, is_checkpointable_source
from paddle_tpu_torch.datapipe.packing import (PackedDataFeeder, auto_pack,
                                         pack_reader, pack_samples)
from paddle_tpu_torch.datapipe.sampler import (pass_permutation, pass_rng_word,
                                         split_positions)
from paddle_tpu_torch.datapipe.shards import (ShardCorruptError, ShardDataset,
                                        ShardError, ShardReader, ShardWriter,
                                        write_shard_set)

__all__ = [
    "ShardWriter",
    "ShardReader",
    "ShardDataset",
    "ShardError",
    "ShardCorruptError",
    "write_shard_set",
    "pass_permutation",
    "pass_rng_word",
    "split_positions",
    "ShardSource",
    "is_checkpointable_source",
    "pack_samples",
    "pack_reader",
    "PackedDataFeeder",
    "auto_pack",
]
