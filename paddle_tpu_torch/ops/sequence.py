"""Sequence masks — counterpart of
``paddle_tpu/ops/sequence.py::mask_from_lengths``."""

from __future__ import annotations

import torch

__all__ = ["mask_from_lengths"]


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, T] float mask (1.0 for real positions)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths.to(torch.long)[:, None]).to(torch.float32)
