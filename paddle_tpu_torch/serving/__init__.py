"""Serving tier of the port (the reference's ``paddle_tpu/serving``): the
slot table and its request plumbing.  ``InferenceServer`` and its worker,
breaker, metrics and degradation ladder wait for a later slice."""

from paddle_tpu_torch.serving.batching import (Request, ServingFuture,
                                               batch_bucket,
                                               canonicalize_feed,
                                               merge_feeds)
from paddle_tpu_torch.serving.slots import (Seq2SeqSlotBackend, SlotBackend,
                                            SlotScheduler)

__all__ = ["Request", "ServingFuture", "batch_bucket", "canonicalize_feed",
           "merge_feeds", "Seq2SeqSlotBackend", "SlotBackend",
           "SlotScheduler"]
