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

``bigru_sequence_fused`` (the reference's ``:451-512``) runs both
directions of a bidirectional GRU layer in one time loop over a stacked
batch of 2B rows (``bigru_forward``/``bigru_backward``, K11): the forward
direction's rows, then the backward direction's flipped in time.  Its
backward takes each direction's ``d_w_h`` from that direction's rows with
the same batched contraction.

A call under ``torch.no_grad()`` (or with no input that needs a gradient)
runs the inference variant, which stores no residuals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.bigru import bigru_backward, bigru_forward
from paddle_tpu_torch.ops.kernels.gru import gru_backward, gru_forward
from paddle_tpu_torch.ops.kernels.lstm import lstm_backward, lstm_forward
from paddle_tpu_torch.ops.numerics import bwd_einsum

__all__ = ["gru_sequence_fused", "bigru_sequence_fused",
           "lstm_sequence_fused"]


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
        d_wh = _gru_d_wh(z_tb, hp_tb, d_z, H).to(w_h.dtype)
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


def _gru_d_wh(z_tb: torch.Tensor, hp_tb: torch.Tensor, d_z: torch.Tensor,
              H: int) -> torch.Tensor:
    """The recurrent weight gradient from time-major residuals and d_z:
    ``[h_prev^T . d_z[..., :2H] | (r * h_prev)^T . d_z[..., 2H:]]``."""
    hp_f = hp_tb.float()
    rh = torch.sigmoid(z_tb[..., :H].float()) * hp_f
    return torch.cat([bwd_einsum("tbh,tbz->hz", hp_f, d_z[..., :2 * H]),
                      bwd_einsum("tbh,tbz->hz", rh, d_z[..., 2 * H:])],
                     dim=1)


class _BiGruSequence(torch.autograd.Function):
    """(xp2, mask2, w_fw, w_bw, batch) -> (h_seq2, h_final2) over the
    stacked batch, with the residual backward (K11 reverse)."""

    @staticmethod
    def forward(ctx, xp2, mask2, w_fw, w_bw, batch):
        h_tb, h_fin, z_tb, hp_tb = bigru_forward(
            xp2.transpose(0, 1), mask2.transpose(0, 1),
            torch.cat([w_fw, w_bw]), residuals=True, batch_split=batch)
        ctx.save_for_backward(mask2, w_fw, w_bw, z_tb, hp_tb)
        ctx.batch = batch
        ctx.xp_dtype = xp2.dtype
        return h_tb.transpose(0, 1), h_fin

    @staticmethod
    def backward(ctx, d_hseq, d_hfin):
        mask2, w_fw, w_bw, z_tb, hp_tb = ctx.saved_tensors
        B, H = ctx.batch, w_fw.shape[0]
        # the transposed weights stacked on columns [3H, 2H], the
        # reference's layout, which the kernel reads as it is
        w_t = torch.cat([w_fw.float().t(), w_bw.float().t()], dim=1)
        d_z, _ = bigru_backward(
            d_hseq.transpose(0, 1).float(), mask2.transpose(0, 1).float(),
            z_tb, hp_tb, w_t, d_hfin.float(), batch_split=B)
        fw, bw = slice(0, B), slice(B, None)
        d_w_fw = _gru_d_wh(z_tb[:, fw], hp_tb[:, fw], d_z[:, fw], H)
        d_w_bw = _gru_d_wh(z_tb[:, bw], hp_tb[:, bw], d_z[:, bw], H)
        return (d_z.transpose(0, 1).to(ctx.xp_dtype), None,
                d_w_fw.to(w_fw.dtype), d_w_bw.to(w_bw.dtype), None)


def bigru_sequence_fused(xp2: torch.Tensor, mask2: torch.Tensor,
                         w_fw: torch.Tensor, w_bw: torch.Tensor, batch: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a bidirectional GRU in one time loop: xp2
    [2B, T, 3H] holds the forward direction's input projections and then
    the backward direction's, flipped in time (mask2 [2B, T] likewise);
    w_fw/w_bw [H, 3H] are the directions' recurrent weights; batch = B.
    Returns (h_seq2 [2B, T, H], h_final2 [2B, H]), float32, in the same
    stacking (the caller flips the second half back).  Differentiable in
    xp2, w_fw and w_bw."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xp2, w_fw, w_bw))
    if not needs_grad:
        h_tb, h_fin = bigru_forward(
            xp2.transpose(0, 1), mask2.transpose(0, 1),
            torch.cat([w_fw, w_bw]), residuals=False, batch_split=batch)
        return h_tb.transpose(0, 1), h_fin
    return _BiGruSequence.apply(xp2, mask2, w_fw, w_bw, batch)


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
