"""Data helpers of the port (the reference's ``paddle_tpu/data``): the
reader decorators, the ``DataFeeder``, the typed input slots, the dataset
loaders (real files under ``datasets.data_home()``, else the synthetic
streams; ``formats`` parses them), PyDataProvider2's ``provider`` and the
native pad core (``native``).  ``resilient_reader``
(``resilience/reader.py``) is surfaced here beside the other reader
decorators, as in the reference."""

from paddle_tpu_torch.data import datasets, provider
from paddle_tpu_torch.data.feeder import (DataFeeder, PreparedFeed,
                                          PrepareError, bucket_length,
                                          feeder_kind_for_layer,
                                          note_padding)
from paddle_tpu_torch.data.reader import (batch, buffered, cache, chain,
                                          compose, firstn, map_readers,
                                          shuffle)
from paddle_tpu_torch.resilience.reader import resilient_reader

__all__ = ["batch", "shuffle", "buffered", "map_readers", "compose",
           "chain", "firstn", "cache", "DataFeeder", "PreparedFeed",
           "PrepareError", "bucket_length", "feeder_kind_for_layer",
           "note_padding", "datasets", "provider", "resilient_reader"]
