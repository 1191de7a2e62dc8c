"""Fused GRU and LSTM sequence ops with hand-written backwards —
counterpart of ``paddle_tpu/ops/rnn_fused.py`` (``gru_sequence_fused``,
``lstm_sequence_fused``).

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

The LSTM follows the same contract with ``lstm_forward`` (K9) and
``lstm_backward`` (K10): the forward saves ``z`` [T, B, 4H] (PRE-peephole),
``h_prev`` and ``c_prev``; the reverse loop emits ``d_z`` (= ``d_xp``) and,
when the peepholes are live, ``c_new`` for ``d_po``; the tail
(``:382-399``) is one batched contraction for ``d_w_h`` and one reduction
per peephole.

A call under ``torch.no_grad()`` (or with no input that needs a gradient)
runs the inference variant, which stores no residuals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.gru import gru_backward, gru_forward
from paddle_tpu_torch.ops.kernels.lstm import lstm_backward, lstm_forward
from paddle_tpu_torch.ops.numerics import bwd_einsum

__all__ = ["gru_sequence_fused", "lstm_sequence_fused"]


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


class _LstmSequence(torch.autograd.Function):
    """(xp, mask, w_h, h0, c0, pi, pf, po) -> (h_seq, h_final, c_final)
    with the residual backward."""

    @staticmethod
    def forward(ctx, xp, mask, w_h, h0, c0, pi, pf, po, has_peepholes):
        h_seq, h_fin, c_fin, z_tb, hp_tb, cp_tb = lstm_forward(
            xp, mask, w_h, pi, pf, po, h0, c0, residuals=True)
        ctx.save_for_backward(mask, w_h, pi, pf, po, z_tb, hp_tb, cp_tb)
        ctx.has_peepholes = has_peepholes
        ctx.dtypes = (xp.dtype, None if h0 is None else h0.dtype,
                      None if c0 is None else c0.dtype)
        return h_seq, h_fin, c_fin

    @staticmethod
    def backward(ctx, d_hseq, d_hfin, d_cfin):
        mask, w_h, pi, pf, po, z_tb, hp_tb, cp_tb = ctx.saved_tensors
        xp_dt, h0_dt, c0_dt = ctx.dtypes
        H = w_h.shape[0]
        d_z, cn, d_h0, d_c0 = lstm_backward(
            d_hseq.transpose(0, 1).float(), mask.transpose(0, 1).float(),
            z_tb, cp_tb, w_h.float().t(), pi, pf, po, d_hfin.float(),
            d_cfin.float(), want_cn=ctx.has_peepholes)
        if ctx.has_peepholes:
            # one batched reduction per peephole, outside the loop
            cp_f = cp_tb.float()
            d_pi = bwd_einsum("tbh,tbh->h", d_z[..., :H], cp_f)
            d_pf = bwd_einsum("tbh,tbh->h", d_z[..., H:2 * H], cp_f)
            d_po = bwd_einsum("tbh,tbh->h", d_z[..., 2 * H:3 * H], cn)
        else:
            d_pi = d_pf = d_po = torch.zeros_like(pi)
        d_wh = bwd_einsum("tbh,tbz->hz", hp_tb.float(), d_z).to(w_h.dtype)
        d_xp = d_z.transpose(0, 1).to(xp_dt)
        return (d_xp, None, d_wh,
                None if h0_dt is None else d_h0.to(h0_dt),
                None if c0_dt is None else d_c0.to(c0_dt),
                d_pi.to(pi.dtype), d_pf.to(pf.dtype), d_po.to(po.dtype), None)


def lstm_sequence_fused(xp: torch.Tensor, mask: torch.Tensor,
                        w_h: torch.Tensor, h0: Optional[torch.Tensor],
                        c0: Optional[torch.Tensor], pi: torch.Tensor,
                        pf: torch.Tensor, po: torch.Tensor, *,
                        has_peepholes: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LSTM over a padded batch given its input projection xp [B, T, 4H]
    (gate order [i, f, o, g]) and the peepholes pi/pf/po [H] (zeros for the
    plain cell) -> (h_seq [B, T, H], h_final, c_final [B, H]), float32.
    h0/c0: [B, H] or None for zeros.  Differentiable in xp, w_h, h0, c0
    and the peepholes through the residual backward (K10).
    ``has_peepholes=False`` tells the backward the peepholes are zeros: it
    skips the ``c_new`` stream and returns zero peephole gradients."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (xp, w_h, h0, c0, pi, pf, po))
    if not needs_grad:
        return lstm_forward(xp, mask, w_h, pi, pf, po, h0, c0)
    return _LstmSequence.apply(xp, mask, w_h, h0, c0, pi, pf, po,
                               has_peepholes)
