"""CTC loss — counterpart of ``paddle_tpu/ops/ctc.py``.

The alpha (forward) recursion in log space over the extended label
sequence [blank, l1, blank, ..., lL, blank], one step a frame over padded
[B, T, C] log-probabilities with per-row input and label lengths.  The
reference runs it as a ``lax.scan`` of plain ``jnp``; this is the same loop
in PyTorch, its backward by autograd.  Impossible paths sit at ``_NEG =
-1e30``, not ``-inf``, so a label that cannot fit its input gives a loss
near 1e30 with a finite gradient, as the reference's does.  ``logaddexp``
keeps ``jnp.logaddexp``'s derivative, ``exp(x - out)`` for each operand:
where both operands sit at ``_NEG``, ``out`` rounds to ``_NEG`` and each
gets 1 (``torch.logaddexp``'s own backward gives each 1/2), so an
infeasible row's gradient is the reference's.
"""

from __future__ import annotations

import torch

__all__ = ["ctc_loss"]

_NEG = -1e30


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with ``jnp.logaddexp``'s derivative."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


logaddexp = _LogAddExp.apply


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor, *,
             blank: int = 0, norm_by_times: bool = False) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood.

    log_probs: [B, T, C] log-softmax outputs; labels: [B, L] int (padded);
    input_lengths: [B]; label_lengths: [B].  Returns [B] float32 losses
    (divided by the input length with ``norm_by_times``).  A row with a
    label of length 0 takes the all-blank path only."""
    log_probs = log_probs.float()
    B, T, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels = labels.to(torch.long)
    input_lengths = input_lengths.to(dev)
    label_lengths = label_lengths.to(dev).to(torch.long)

    # the extended sequence [B, S] and where a skip (s-2 -> s) is allowed:
    # e[s] != blank and e[s] != e[s-2]
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    can_skip = torch.zeros((B, S), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    # every frame's log-prob of each extended symbol, [B, T, S]
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))
    keep = (torch.arange(T, device=dev)[:, None]
            < input_lengths[None, :])[..., None]          # [T, B, 1]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)

    s_idx = torch.arange(S, device=dev)[None, :]
    e0 = emit[:, 0]
    alpha = torch.where(s_idx == 0, e0, neg)
    alpha = torch.where((s_idx == 1) & (label_lengths[:, None] > 0), e0,
                        alpha)
    pad1 = neg.expand(B, 1)
    pad2 = neg.expand(B, 2)
    for t in range(1, T):
        a_shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_shift2 = torch.cat([pad2, alpha[:, :-2]], dim=1)[:, :S]
        a_shift2 = torch.where(can_skip, a_shift2, neg)
        merged = logaddexp(logaddexp(alpha, a_shift1), a_shift2)
        alpha = torch.where(keep[t], merged + emit[:, t], alpha)

    # logsumexp of alpha at s = 2 L_b (the trailing blank) and 2 L_b - 1
    sl = 2 * label_lengths
    a_end = torch.gather(alpha, 1, sl[:, None])[:, 0]
    a_end2 = torch.gather(alpha, 1, torch.clamp(sl - 1, min=0)[:, None])[:, 0]
    a_end2 = torch.where(label_lengths > 0, a_end2, neg)
    loss = -logaddexp(a_end, a_end2)
    if norm_by_times:
        loss = loss / torch.clamp(input_lengths.to(torch.float32), min=1.0)
    return loss
