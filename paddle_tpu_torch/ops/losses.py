"""Losses — counterpart of ``paddle_tpu/ops/losses.py`` (``cross_entropy``,
``sequence_cross_entropy``, ``masked_token_mean``,
``sequence_softmax_ce_readout``).

``cross_entropy`` takes a float32 log-softmax of the logits and gathers the
label's entry, as the reference does (never log of probabilities).

``sequence_softmax_ce_readout`` is the fused vocab readout + token
cross-entropy with the reference's TILED semantics (``:231-284``): the
``ce_readout_fwd`` kernel (K1) takes each row's logsumexp and label logit
from the float32 logits and keeps the logits in the compute dtype as the
backward's residual; the backward scales each row by
``d * mask / max(sum(mask), 1)`` and the ``ce_readout_bwd`` kernel (K2)
returns ``d_states``, ``d_w`` and ``d_b`` without storing ``d_logits``.
On the CPU both kernels run their plain versions.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels.ce_readout import (ce_readout_bwd,
                                                     ce_readout_fwd)
from paddle_tpu_torch.ops.numerics import mxu_cast

__all__ = ["cross_entropy", "sequence_cross_entropy", "masked_token_mean",
           "sequence_softmax_ce_readout"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-class CE from logits [..., C] and integer labels [...] ->
    per-example losses [...] (float32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lab = labels.to(torch.long).unsqueeze(-1)
    return -torch.gather(logp, -1, lab).squeeze(-1)


def masked_token_mean(per_token: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Mean over the real (mask > 0) positions — the sequence-cost
    reduction."""
    mask = mask.to(per_token.dtype)
    return (per_token * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sequence_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Token-level CE over a padded [B, T, C] batch, averaged over the real
    tokens."""
    return masked_token_mean(cross_entropy(logits, labels), mask)


class _CEReadout(torch.autograd.Function):
    """(states [B, T, D], w [D, V], b [V], labels, mask) -> scalar loss."""

    @staticmethod
    def forward(ctx, states, w, b, labels, mask):
        B, T, D = states.shape
        sc, wc = mxu_cast(states.reshape(B * T, D), w)
        lab = labels.reshape(B * T)
        per_tok, lse, logits = ce_readout_fwd(sc.contiguous(),
                                              wc.contiguous(), b, lab)
        loss = masked_token_mean(per_tok.reshape(B, T), mask)
        # the compute-dtype w is rebuilt in the backward rather than kept
        # alive across the step (the reference saves the primal w too)
        ctx.save_for_backward(sc, w, lab, lse, logits, mask)
        ctx.dtypes = (states.dtype, w.dtype, b.dtype)
        ctx.shape = (B, T, D)
        return loss

    @staticmethod
    def backward(ctx, d):
        sc, w, lab, lse, logits, mask = ctx.saved_tensors
        s_dt, w_dt, b_dt = ctx.dtypes
        B, T, D = ctx.shape
        mask_f = mask.float()
        scale = (d * mask_f / torch.clamp(mask_f.sum(), min=1.0)).reshape(-1)
        d_states, d_w, d_b = ce_readout_bwd(
            logits, sc, mxu_cast(w).contiguous(), lab, lse, scale)
        return (d_states.reshape(B, T, D).to(s_dt), d_w.to(w_dt),
                d_b.to(b_dt), None, None)


def sequence_softmax_ce_readout(states: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor, labels: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Fused vocab readout + token CE: states [B, T, D] x w [D, V] + b [V]
    against labels [B, T] int, averaged over mask [B, T] -> scalar loss
    (float32).  The [B*T, V] logits exist once, in the compute dtype; the
    float32 logits and ``d_logits`` never reach device memory."""
    return _CEReadout.apply(states, w, b, labels, mask)
