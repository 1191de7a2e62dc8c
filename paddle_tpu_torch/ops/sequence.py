"""Sequence ops over padded batches — counterpart of
``paddle_tpu/ops/sequence.py``: masks, pooling, first/last steps, expand,
reverse, concat along time, the context window (zero or trainable padding)
and the per-row window slice, and the packed-sequence (segment) ops that
the pack-aware layers run on a packed row (``--data_pack``).

``seq_pool_max`` fills the masked positions with the dtype's most negative
finite value and reduces with ``torch.amax``, whose gradient splits ties
evenly among the maxima, as JAX's ``max`` does (``torch.max(dim=)`` would
route it to one index)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mask_from_lengths", "seq_pool_sum", "seq_pool_avg",
           "seq_pool_sqrt", "seq_pool_max", "seq_first", "seq_last",
           "seq_expand", "seq_reverse", "seq_concat", "context_projection",
           "context_projection_trainable", "seq_slice_window", "PACK_KEYS",
           "segment_valid", "segment_starts", "segment_pool",
           "segment_last", "segment_first", "segment_expand"]


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


def seq_expand(vec: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-sequence [B, D] vector to every timestep -> [B, T, D],
    the padded positions zeroed."""
    out = vec[:, None, :].expand(vec.shape[0], mask.shape[1], vec.shape[1])
    return _masked(out, mask)


def seq_reverse(value: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence within its real length; the padded positions
    keep their own values (they are not zeroed)."""
    T = value.shape[1]
    pos = torch.arange(T, device=value.device)[None, :]
    L = lengths.to(torch.long)[:, None]
    src = torch.where(pos < L, L - 1 - pos, pos)
    return _take_time(value, src)


def _take_time(value: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """value [B, T, ...] gathered along time at idx [B, T'] -> [B, T', ...]
    (``take_along_axis`` on axis 1)."""
    shape = idx.shape + value.shape[2:]
    full = idx.reshape(idx.shape + (1,) * (value.dim() - 2)).expand(shape)
    return torch.gather(value, 1, full)


def seq_concat(a: torch.Tensor, a_len: torch.Tensor, b: torch.Tensor,
               b_len: torch.Tensor):
    """Concatenate along time, each row ``a_i ++ b_i`` repadded: output T =
    Ta + Tb, ``b`` shifted by each row's ``a_len``.  -> (value [B, T, D],
    lengths [B])."""
    Ta, Tb = a.shape[1], b.shape[1]
    T = Ta + Tb
    pos = torch.arange(T, device=a.device)[None, :]
    aL = a_len.to(torch.long)[:, None]
    a_pad = torch.nn.functional.pad(a, (0, 0, 0, Tb))
    b_pad = torch.nn.functional.pad(b, (0, 0, 0, Ta))
    b_shift = _take_time(b_pad, torch.clamp(pos - aL, 0, T - 1))
    out = torch.where((pos < aL)[..., None], a_pad, b_shift)
    out_len = a_len + b_len
    return _masked(out, mask_from_lengths(out_len, T)), out_len


def _shift_time(v: torch.Tensor, off: int, fill=0) -> torch.Tensor:
    """out[:, t] = v[:, t + off], ``fill`` where t + off is outside [0,
    T)."""
    T = v.shape[1]
    if off == 0:
        return v
    if abs(off) >= T:
        return torch.full_like(v, fill)
    z = torch.full_like(v[:, :abs(off)], fill)
    if off < 0:
        return torch.cat([z, v[:, :T + off]], 1)
    return torch.cat([v[:, off:], z], 1)


def context_projection(value: torch.Tensor, mask: torch.Tensor,
                       context_len: int, context_start: int,
                       seg_ids: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sliding window over time with zero padding: output[t] =
    concat(value[t + start], ..., value[t + start + len - 1]).  The input
    is masked first, so a window crossing a row's end reads zeros, not the
    next row.  ``seg_ids`` (a packed row) fences the window at segment
    boundaries: a neighbour of another segment reads as zero, as row
    padding would.  [B, T, D] -> [B, T, D * context_len], masked."""
    v = _masked(value, mask)
    cols = []
    for k in range(context_len):
        off = context_start + k
        shifted = _shift_time(v, off)
        if seg_ids is not None and off != 0:
            same = _shift_time(seg_ids, off, fill=-2) == seg_ids
            shifted = shifted * same[..., None].to(shifted.dtype)
        cols.append(shifted)
    return _masked(torch.cat(cols, -1), mask)


def context_projection_trainable(value: torch.Tensor, lengths: torch.Tensor,
                                 mask: torch.Tensor, context_len: int,
                                 context_start: int,
                                 pad_weights: torch.Tensor) -> torch.Tensor:
    """Context projection with trainable boundary padding: ``pad_weights``
    [begin_pad + end_pad, D], ``begin_pad = max(0, -context_start)``.  Row
    ``p`` of the begin block stands in for source position ``p -
    begin_pad`` (< 0), row ``begin_pad + q`` for position ``length + q``
    (>= the row's length, not >= T).  Gradients reach the used padding
    rows only.  [B, T, D] -> [B, T, D * context_len], masked."""
    B, T, D = value.shape
    begin_pad = max(0, -context_start)
    v = _masked(value, mask)
    L = lengths.to(torch.long)[:, None]
    base = torch.arange(T, device=value.device)[None, :]
    cols = []
    for k in range(context_len):
        pos = base + (context_start + k)                       # [1, T]
        shifted = _take_time(v, torch.clamp(pos, 0, T - 1).expand(B, T))
        pad_row = torch.where(pos < 0, pos + begin_pad,
                              begin_pad + (pos - L))           # [B, T]
        pad_row = torch.clamp(pad_row, 0, pad_weights.shape[0] - 1)
        pad_vals = pad_weights[pad_row].to(shifted.dtype)      # [B, T, D]
        use_pad = (pos < 0) | (pos >= L)
        cols.append(torch.where(use_pad[..., None], pad_vals, shifted))
    return _masked(torch.cat(cols, -1), mask)


def seq_slice_window(value: torch.Tensor, starts: torch.Tensor,
                     width: int) -> torch.Tensor:
    """The fixed-width window of each row starting at its own offset
    (positions clamped into [0, T)): [B, T, D], [B] -> [B, width, D]."""
    T = value.shape[1]
    pos = starts.to(torch.long)[:, None] + torch.arange(
        width, device=value.device)[None, :]
    return _take_time(value, torch.clamp(pos, 0, T - 1))


# ---------------------------------------------------------------------------
# sequence packing (``--data_pack``): a packed row holds several whole
# sequences back to back.  seg_ids [B, T] gives each token its segment index
# (-1 on padding), positions [B, T] its offset within the segment,
# seg_lengths [B, S] the tokens of each segment (0: an unused slot; S is the
# static max_segments).  The pack-aware layers run these in place of the
# padded-batch reductions above.
# ---------------------------------------------------------------------------

#: the ``Act.state`` keys that mark (and carry) a packed sequence
PACK_KEYS = ("seg_ids", "positions", "seg_lengths")


def segment_valid(seg_lengths: torch.Tensor) -> torch.Tensor:
    """[B, S] tokens per segment -> [B, S] float validity mask."""
    return (seg_lengths > 0).to(torch.float32)


def segment_starts(seg_ids: torch.Tensor, mask: torch.Tensor, *,
                   reverse: bool = False) -> torch.Tensor:
    """[B, T] mask of the positions where a scan enters a segment, where
    the recurrent carry resets: a segment's first token going forward, its
    last going in reverse (a reverse scan meets segments tail first)."""
    pad = torch.full_like(seg_ids[:, :1], -1)
    if reverse:
        neighbor = torch.cat([seg_ids[:, 1:], pad], 1)
    else:
        neighbor = torch.cat([pad, seg_ids[:, :-1]], 1)
    return ((seg_ids != neighbor) & (mask > 0)).to(torch.float32)


def _segment_members(seg_ids: torch.Tensor, mask: torch.Tensor,
                     S: int) -> torch.Tensor:
    """[B, S, T] bool: token t of the row is a real token of segment s."""
    s = torch.arange(S, device=seg_ids.device)[None, :, None]
    return (seg_ids[:, None, :] == s) & (mask[:, None, :] > 0)


def segment_pool(value: torch.Tensor, mask: torch.Tensor,
                 seg_ids: torch.Tensor, seg_lengths: torch.Tensor,
                 pooling_type: str = "max") -> torch.Tensor:
    """Pooling of each segment of a packed row: [B, T, D] -> [B, S, D]
    (max/avg/sum/sqrt); empty segment slots come out zero.  ``max`` splits
    the gradient of tied maxima evenly (``torch.amax``), as JAX's
    ``segment_max`` does."""
    S = seg_lengths.shape[1]
    member = _segment_members(seg_ids, mask, S)[..., None]     # [B,S,T,1]
    counts = seg_lengths.to(value.dtype)[..., None]            # [B,S,1]
    if pooling_type == "max":
        neg = torch.full((), torch.finfo(value.dtype).min, dtype=value.dtype,
                         device=value.device)
        out = torch.amax(torch.where(member, value[:, None], neg), dim=2)
        return torch.where(counts > 0, out, torch.zeros_like(out))
    out = (value[:, None] * member.to(value.dtype)).sum(2)
    if pooling_type == "sum":
        return out
    n = torch.clamp(counts, min=1.0)
    if pooling_type == "avg":
        return out / n
    if pooling_type == "sqrt":
        return out / torch.sqrt(n)
    raise ValueError(f"unknown segment pooling type {pooling_type!r}")


def _segment_start_index(seg_lengths: torch.Tensor) -> torch.Tensor:
    """[B, S] each segment's first token index (segments lie contiguous,
    in order)."""
    return torch.cumsum(seg_lengths, 1) - seg_lengths


def _segment_take(value: torch.Tensor, idx: torch.Tensor,
                  seg_lengths: torch.Tensor) -> torch.Tensor:
    out = _take_time(value, torch.clamp(idx.to(torch.long), 0,
                                        value.shape[1] - 1))
    return out * segment_valid(seg_lengths)[..., None].to(out.dtype)


def segment_last(value: torch.Tensor, seg_lengths: torch.Tensor
                 ) -> torch.Tensor:
    """The last real token of every segment: [B, T, D] -> [B, S, D],
    empty slots zero."""
    start = _segment_start_index(seg_lengths)
    return _segment_take(value, start + torch.clamp(seg_lengths, min=1) - 1,
                         seg_lengths)


def segment_first(value: torch.Tensor, seg_lengths: torch.Tensor
                  ) -> torch.Tensor:
    """The first token of every segment: [B, T, D] -> [B, S, D], empty
    slots zero."""
    return _segment_take(value, _segment_start_index(seg_lengths),
                         seg_lengths)


def segment_expand(vec: torch.Tensor, seg_ids: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """A per-segment [B, S, D] vector broadcast back over each segment's
    tokens: -> [B, T, D], padding zeroed."""
    idx = torch.clamp(seg_ids.to(torch.long), 0, vec.shape[1] - 1)
    return _masked(_take_time(vec, idx), mask)
