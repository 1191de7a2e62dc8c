"""Sequence masks, pooling and first/last steps over padded batches —
counterpart of ``paddle_tpu/ops/sequence.py`` (``mask_from_lengths``,
``seq_pool_*``, ``seq_first``, ``seq_last``).

``seq_pool_max`` fills the masked positions with the dtype's most negative
finite value and reduces with ``torch.amax``, whose gradient splits ties
evenly among the maxima, as JAX's ``max`` does (``torch.max(dim=)`` would
route it to one index)."""

from __future__ import annotations

import torch

__all__ = ["mask_from_lengths", "seq_pool_sum", "seq_pool_avg",
           "seq_pool_sqrt", "seq_pool_max", "seq_first", "seq_last"]


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, T] float mask (1.0 for real positions)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths.to(torch.long)[:, None]).to(torch.float32)


def _masked(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return value * mask[..., None].to(value.dtype)


def seq_pool_sum(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, D], [B, T] -> [B, D] sum over the real positions."""
    return _masked(value, mask).sum(1)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask.sum(1, keepdim=True), min=1.0)


def seq_pool_avg(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = seq_pool_sum(value, mask)
    return s / _count(mask).to(s.dtype)


def seq_pool_sqrt(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum / sqrt(len) — the reference's "SquareRootN" average."""
    s = seq_pool_sum(value, mask)
    return s / torch.sqrt(_count(mask)).to(s.dtype)


def seq_pool_max(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    neg = torch.finfo(value.dtype).min
    z = torch.where(mask[..., None] > 0, value,
                    torch.full((), neg, dtype=value.dtype,
                               device=value.device))
    return torch.amax(z, dim=1)


def seq_last(value: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Last real timestep of each sequence: [B, T, ...], [B] -> [B, ...]
    (row 0 for an empty sequence)."""
    idx = torch.clamp(lengths.to(torch.long) - 1, min=0)
    return value[torch.arange(value.shape[0], device=value.device), idx]


def seq_first(value: torch.Tensor) -> torch.Tensor:
    """First timestep: [B, T, ...] -> [B, ...]."""
    return value[:, 0]
