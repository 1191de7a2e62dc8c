"""Embedding lookup (forward) — counterpart of
``paddle_tpu/ops/embedding.py::embedding_lookup``."""

from __future__ import annotations

import torch

__all__ = ["embedding_lookup"]


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, D], ids int [B, ...] -> [B, ..., D]."""
    ids = ids.to(torch.long)
    return table.index_select(0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))
