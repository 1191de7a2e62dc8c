"""Embedding lookup with its backward — counterpart of
``paddle_tpu/ops/embedding.py::embedding_lookup``.

The reference's backward is an id-sorted scatter-add: the flattened ids are
sorted and the cotangent rows of equal ids summed into their table row.
``torch.nn.functional.embedding`` has that backward: on CUDA it sorts the
ids and sums each id's segment in a fixed order, without atomics, so the
table gradient is the same bits from run to run (``index_add_`` on CUDA
sums duplicates with atomics in an order that changes between runs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["embedding_lookup"]


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, D], ids int [B, ...] -> [B, ..., D]; differentiable in
    ``table`` (a dense [V, D] gradient)."""
    return F.embedding(ids.to(torch.long), table)
