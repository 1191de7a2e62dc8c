"""Fused GRU sequence op with a hand-written backward — counterpart of
``paddle_tpu/ops/rnn_fused.py::gru_sequence_fused``.

The forward runs the ``gru_forward`` kernel (K3; the plain version on the
CPU).  Where a gradient is wanted it also SAVES the per-step
pre-activations ``z`` [T, B, 3H] and the carries entering each step
``h_prev`` [T, B, H], time-major in ``residual_dtype(H)``.  The backward
then needs no replay of the forward: the ``gru_backward`` kernel (K4) runs
the reverse loop from those residuals and emits the per-step cotangents
``d_z``, which serve directly as ``d_xp`` (the input projection enters the
cell additively), and the recurrent weight gradient is one batched
contraction after the loop (the reference's shared tail, ``:218-225``):

    d_w_h = [h_prev^T . d_z[..., :2H]  |  (r * h_prev)^T . d_z[..., 2H:]]

A call under ``torch.no_grad()`` (or with no input that needs a gradient)
runs the inference variant, which stores no residuals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.gru import gru_backward, gru_forward
from paddle_tpu_torch.ops.numerics import bwd_einsum

__all__ = ["gru_sequence_fused"]


class _GruSequence(torch.autograd.Function):
    """(xp, mask, w_h, h0) -> (h_seq, h_final) with the residual backward."""

    @staticmethod
    def forward(ctx, xp, mask, w_h, h0):
        h_seq, h_fin, z_tb, hp_tb = gru_forward(xp, mask, w_h, h0,
                                                residuals=True)
        ctx.save_for_backward(mask, w_h, z_tb, hp_tb)
        ctx.xp_dtype = xp.dtype
        ctx.h0_dtype = None if h0 is None else h0.dtype
        return h_seq, h_fin

    @staticmethod
    def backward(ctx, d_hseq, d_hfin):
        mask, w_h, z_tb, hp_tb = ctx.saved_tensors
        H = w_h.shape[0]
        d_z, d_h0 = gru_backward(
            d_hseq.transpose(0, 1).float(), mask.transpose(0, 1).float(),
            z_tb, hp_tb, w_h.float().t(), d_hfin.float())
        hp_f = hp_tb.float()
        rh = torch.sigmoid(z_tb[..., :H].float()) * hp_f
        d_wh = torch.cat([bwd_einsum("tbh,tbz->hz", hp_f, d_z[..., :2 * H]),
                          bwd_einsum("tbh,tbz->hz", rh, d_z[..., 2 * H:])],
                         dim=1).to(w_h.dtype)
        d_xp = d_z.transpose(0, 1).to(ctx.xp_dtype)
        d_h0 = None if ctx.h0_dtype is None else d_h0.to(ctx.h0_dtype)
        return d_xp, None, d_wh, d_h0


def gru_sequence_fused(xp: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over a padded batch given its input projection xp [B, T, 3H]
    -> (h_seq [B, T, H], h_final [B, H]), float32.  Differentiable in xp,
    w_h and h0 through the residual backward (K4)."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xp, w_h, h0))
    if not needs_grad:
        return gru_forward(xp, mask, w_h, h0)
    return _GruSequence.apply(xp, mask, w_h, h0)
