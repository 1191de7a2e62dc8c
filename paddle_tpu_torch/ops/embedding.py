"""Embedding lookup with its backward, and ``one_hot`` — counterpart of
``paddle_tpu/ops/embedding.py``.

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

__all__ = ["embedding_lookup", "one_hot"]


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                     pad_to_zero_id=None) -> torch.Tensor:
    """table [V, D], ids int [B, ...] -> [B, ..., D]; differentiable in
    ``table`` (a dense [V, D] gradient).  Rows whose id is
    ``pad_to_zero_id`` come out as zeros (and send no gradient to the
    pad row)."""
    out = F.embedding(ids.to(torch.long), table)
    if pad_to_zero_id is not None:
        out = out * (ids != pad_to_zero_id)[..., None].to(out.dtype)
    return out


def one_hot(ids: torch.Tensor, depth: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ids int [...] -> [..., depth] rows of the identity."""
    return torch.eye(depth, dtype=dtype, device=ids.device)[ids.to(torch.long)]
