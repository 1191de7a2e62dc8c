"""Attention GRU decoder with a hand-written backward — counterpart of
``paddle_tpu/ops/attention_decoder.py::attention_gru_decoder``, the
flagship's training hot loop, on the reference's scan path.

The math is the reference's: the Bahdanau decoder of
``additive_attention_scores`` + ``attend`` + the input projection +
``gru_step`` over the teacher-forced target, with ``scan_rnn`` masking
(carry held, output zeroed at padded target steps).  The teacher-forced
half of the input projection is HOISTED out of the loop,
``xp_y = y_emb @ wx[:E] + b`` for all steps at once, and only the context
half ``ctx @ wx[E:]`` stays in the loop, as ``_decoder_fwd_scan`` does.
That is not the generation step's concatenated product
(``models/seq2seq.py::_dec_step``): the two round and sum differently, and
parity with the reference's training path needs the split.

The forward saves ``probs`` [T, B, S] (f32), ``ctxs`` [T, B, 2H] (compute
dtype) and ``s_prev`` [T, B, D] (the carry entering each step).  The
backward is ``_agd_bwd``'s scan branch: the GRU gates and the attention
queries of every step are recomputed as batched products before the
reverse loop; the loop keeps only the float32 ``d_enc_proj`` and ``d_v``
accumulators and emits the small per-step ``d_xp`` and ``sum_dpre``; every
weight gradient is one batched contraction after it.

This slice runs both loops in plain PyTorch: the reference's Pallas
decoder kernels (K5 ``attn_dec_fwd_pallas``, K6 ``attn_dec_bwd_pallas``)
are gated off here (``use_pallas_attention``) and replace the two loops in
the next slice.  The port has no flag for it.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.attention import (additive_attention_scores, attend,
                                            score_product)
from paddle_tpu_torch.ops.matmul import linear
from paddle_tpu_torch.ops.numerics import (bwd_einsum, bwd_mm, compute_dtype,
                                           mxu_cast)
from paddle_tpu_torch.ops.rnn import gru_cell_bwd, gru_step

__all__ = ["attention_gru_decoder"]


def _decoder_fwd(y_emb, s0, enc, enc_proj, src_mask, trg_mask, att_w, att_v,
                 wx, b, wh):
    """The forward loop -> (states [B, T, D], probs, ctxs, s_prev), the last
    three time-major."""
    B, T = trg_mask.shape
    E = y_emb.shape[-1]
    rd = compute_dtype()                    # residual dtype of ctx
    xp_y = linear(y_emb, wx[:E], b)         # hoisted: [B, T, 3D] f32
    wx_c = wx[E:]
    s = s0
    outs, probs, ctxs, s_prev = [], [], [], []
    for t in range(T):
        m_t = trg_mask[:, t, None]
        scores = additive_attention_scores(enc_proj, s, att_w, att_v)
        ctx, w = attend(scores, enc, src_mask)
        s_new = gru_step(xp_y[:, t] + linear(ctx, wx_c), s, wh)
        s_out = torch.where(m_t > 0, s_new, s)
        outs.append(s_out * m_t.to(s_out.dtype))
        probs.append(w)
        ctxs.append(ctx.to(rd))
        s_prev.append(s)
        s = s_out
    return (torch.stack(outs, 1), torch.stack(probs), torch.stack(ctxs),
            torch.stack(s_prev))


def _decoder_bwd(saved, d_states):
    (y_emb, s0, enc, enc_proj, src_mask, trg_mask, att_w, att_v, wx, b, wh,
     s_prev, probs, ctxs) = saved
    B, T = trg_mask.shape
    D = s0.shape[-1]
    S, A = enc.shape[1], enc_proj.shape[-1]
    E = y_emb.shape[-1]
    f32 = torch.float32
    dev = d_states.device

    y_tb = y_emb.transpose(0, 1)
    m_tb = trg_mask.transpose(0, 1)
    # the hoisted y-projection, recomputed (the same product as the
    # forward's, so the same values)
    xp_y_tb = linear(y_emb, wx[:E], b).transpose(0, 1)
    d_out_tb = d_states.transpose(0, 1).float()
    att_w_f, att_v_f = att_w.float(), att_v.float()
    wx_f, wh_f = wx.float(), wh.float()
    neg = torch.finfo(f32).min
    maskb = src_mask > 0
    mask_f = src_mask.float()

    # GRU gates and attention queries of every step, batched
    xp_all = (xp_y_tb + linear(ctxs, wx[E:])).float()       # [T, B, 3D]
    zr_all = xp_all[..., :2 * D] + linear(s_prev, wh[:, :2 * D]).float()
    ru_all = torch.sigmoid(zr_all)
    r_all, u_all = ru_all[..., :D], ru_all[..., D:]
    cand_all = torch.tanh(
        xp_all[..., 2 * D:]
        + linear((r_all * s_prev.float()).to(s_prev.dtype),
                 wh[:, 2 * D:]).float())
    q_all = linear(s_prev, att_w)                           # [T, B, A]

    wh_c_t, wh_g_t = wh_f[:, 2 * D:].t(), wh_f[:, :2 * D].t()
    wx_c_t, att_w_t = wx_f[E:].t(), att_w_f.t()
    d_s = torch.zeros(B, D, device=dev)
    d_enc_p = torch.zeros(B, S, A, device=dev)              # f32 accumulators
    d_v = torch.zeros(A, device=dev)
    d_xp_tb = torch.empty(T, B, 3 * D, device=dev)
    sum_dpre_tb = torch.empty(T, B, A, device=dev)
    for t in range(T - 1, -1, -1):
        mcol = (m_tb[t] > 0).to(f32)[:, None]
        d_snew = mcol * (d_out_tb[t] + d_s)
        # GRU backward (gates precomputed above)
        d_zr, d_zc, d_h = gru_cell_bwd(d_snew, s_prev[t].float(), r_all[t],
                                       u_all[t], cand_all[t], wh_c_t, wh_g_t)
        d_xp = torch.cat([d_zr, d_zc], -1)                  # [B, 3D]
        d_ctx = bwd_mm(d_xp, wx_c_t)                        # [B, 2H]

        # attention backward: the softmax chain from the recomputed query
        d_w = bwd_einsum("bh,bsh->bs", d_ctx.to(enc.dtype), enc)
        enc_proj_c, q_c = mxu_cast(enc_proj, q_all[t][:, None, :])
        pre = torch.tanh(enc_proj_c + q_c)                  # [B, S, A] cd
        scores = score_product(pre, att_v)
        z = torch.where(maskb, scores, torch.full_like(scores, neg))
        w0 = torch.softmax(z, dim=-1)
        w1 = w0 * mask_f
        n = torch.clamp(w1.sum(-1, keepdim=True), min=1e-9)
        d_w1 = d_w / n
        d_n = -(d_w * w1).sum(-1, keepdim=True) / (n * n)
        d_w1 = d_w1 + d_n * (w1.sum(-1, keepdim=True) > 1e-9).to(f32)
        d_w0 = d_w1 * mask_f
        d_z = w0 * (d_w0 - (w0 * d_w0).sum(-1, keepdim=True))
        d_scores = torch.where(maskb, d_z, torch.zeros_like(d_z))
        pre_f = pre.float()
        d_pre = (1.0 - pre_f * pre_f) * (d_scores[..., None] * att_v_f)
        d_enc_p = d_enc_p + d_pre
        sum_dpre = d_pre.sum(1)                             # [B, A]
        d_h = d_h + bwd_mm(sum_dpre, att_w_t)
        d_v = d_v + bwd_einsum("bs,bsa->a", d_scores, pre_f)

        d_s = (1.0 - mcol) * d_s + d_h
        d_xp_tb[t] = d_xp
        sum_dpre_tb[t] = sum_dpre
    d_b = d_xp_tb.sum(dim=(0, 1))

    # batched contractions after the loop
    d_ctx_tb = bwd_mm(d_xp_tb, wx_c_t)                      # [T, B, 2H]
    sp_f = s_prev.float()
    d_wh = torch.cat(
        [bwd_einsum("tbd,tbz->dz", sp_f, d_xp_tb[..., :2 * D]),
         bwd_einsum("tbd,tbz->dz", r_all * sp_f, d_xp_tb[..., 2 * D:])],
        dim=1)
    d_attw = bwd_einsum("tbd,tba->da", sp_f, sum_dpre_tb)
    d_enc = bwd_einsum("tbs,tbh->bsh", probs, d_ctx_tb).to(enc.dtype)
    d_wx = torch.cat([bwd_einsum("tbi,tbo->io", y_tb, d_xp_tb),
                      bwd_einsum("tbi,tbo->io", ctxs, d_xp_tb)], dim=0)
    d_y_emb = bwd_mm(d_xp_tb, wx_f[:E].t()).to(y_emb.dtype).transpose(0, 1)
    return (d_y_emb, d_s.to(s0.dtype), d_enc, d_enc_p.to(enc_proj.dtype),
            None, None, d_attw.to(att_w.dtype), d_v.to(att_v.dtype),
            d_wx.to(wx.dtype), d_b.to(b.dtype), d_wh.to(wh.dtype))


class _AttentionGruDecoder(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y_emb, s0, enc, enc_proj, src_mask, trg_mask, att_w,
                att_v, wx, b, wh):
        states, probs, ctxs, s_prev = _decoder_fwd(
            y_emb, s0, enc, enc_proj, src_mask, trg_mask, att_w, att_v, wx,
            b, wh)
        ctx.save_for_backward(y_emb, s0, enc, enc_proj, src_mask, trg_mask,
                              att_w, att_v, wx, b, wh, s_prev, probs, ctxs)
        return states

    @staticmethod
    def backward(ctx, d_states):
        return _decoder_bwd(ctx.saved_tensors, d_states)


def attention_gru_decoder(y_emb: torch.Tensor, s0: torch.Tensor,
                          enc: torch.Tensor, enc_proj: torch.Tensor,
                          src_mask: torch.Tensor, trg_mask: torch.Tensor,
                          att_w: torch.Tensor, att_v: torch.Tensor,
                          wx: torch.Tensor, b: torch.Tensor,
                          wh: torch.Tensor) -> torch.Tensor:
    """y_emb [B, T, E], s0 [B, D], enc [B, S, 2H], enc_proj [B, S, A],
    src_mask [B, S], trg_mask [B, T], att_w [D, A], att_v [A],
    wx [E + 2H, 3D], b [3D], wh [D, 3D] -> states [B, T, D] (zeroed at
    padded target steps, carry held).  Differentiable in every input but
    the masks, through the hand-written backward."""
    return _AttentionGruDecoder.apply(y_emb, s0, enc, enc_proj, src_mask,
                                      trg_mask, att_w, att_v, wx, b, wh)
