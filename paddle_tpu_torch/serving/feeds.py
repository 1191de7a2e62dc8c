"""Synthetic-feed helpers, re-exported for the serving tier — counterpart
of ``paddle_tpu/serving/feeds.py``.  They live in
:mod:`paddle_tpu_torch.nn.feeds`, a pure Topology utility that the tiers
below serving use too."""

from paddle_tpu_torch.nn.feeds import (empty_outputs, example_feed,
                                       zero_batch_like)

__all__ = ["example_feed", "zero_batch_like", "empty_outputs"]
