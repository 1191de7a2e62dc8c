"""Attention GRU decoder with a hand-written backward — counterpart of
``paddle_tpu/ops/attention_decoder.py::attention_gru_decoder``, the
flagship's training hot loop, in the reference's default configuration
(``use_pallas_attention``, on for the TPU backend): both time loops run in
hand-written kernels, K5 ``attn_dec_fwd`` and K6 ``attn_dec_bwd``
(``ops/kernels/attention_decoder.py``), as the reference's Pallas branch
runs ``attn_dec_fwd_pallas`` and ``attn_dec_bwd_pallas``.  The reference
takes its scan path only on other backends; the kernels' plain versions
are that scan path's loops, and a CPU tensor runs them.

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
backward is ``_agd_bwd``: the GRU gates and the attention queries of every
step are recomputed as batched products before the reverse loop; the loop
(K6) emits the small per-step ``d_xp`` and ``sum_dpre`` and the float32
``d_enc_proj`` and ``d_v`` sums (on the card, one pass after its steps
forms them from each step's ``d_score``); every weight gradient is one
batched contraction after it.  The port has no flag for the scan
path on the card.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels.attention_decoder import (attn_dec_bwd,
                                                            attn_dec_fwd)
from paddle_tpu_torch.ops.matmul import linear
from paddle_tpu_torch.ops.numerics import bwd_einsum, bwd_mm, mxu_cast

__all__ = ["attention_gru_decoder", "recompute_gates"]


def _decoder_fwd(y_emb, s0, enc, enc_proj, src_mask, trg_mask, att_w, att_v,
                 wx, b, wh):
    """K5 with the reference's Pallas-branch casts -> (states [B, T, D],
    probs, ctxs, s_prev), the last three time-major."""
    E = y_emb.shape[-1]
    f32 = torch.float32
    xp_y = linear(y_emb, wx[:E], b)         # hoisted: [B, T, 3D] f32
    enc_c, encp_c, attw_c, attv_c, wxc_c, wh_c = mxu_cast(
        enc, enc_proj, att_w, att_v, wx[E:], wh)
    states, probs, ctxs, s_prev = attn_dec_fwd(
        xp_y.transpose(0, 1), trg_mask.t().to(f32), s0.to(f32),
        enc_c, encp_c, src_mask.to(f32), attw_c, attv_c, wxc_c, wh_c)
    return states.transpose(0, 1), probs, ctxs, s_prev


def recompute_gates(xp_y_tb, ctxs, s_prev, wx_c, wh, att_w):
    """The GRU gates and attention queries of every decoder step, as batched
    products from the forward's residuals (the reverse loop's inputs):
    xp_y [T, B, 3D], ctxs [T, B, 2H], s_prev [T, B, D] -> (r, u, cand
    [T, B, D], q [T, B, A]), float32."""
    D = s_prev.shape[-1]
    xp_all = (xp_y_tb + linear(ctxs, wx_c)).float()         # [T, B, 3D]
    zr_all = xp_all[..., :2 * D] + linear(s_prev, wh[:, :2 * D]).float()
    ru_all = torch.sigmoid(zr_all)
    r_all, u_all = ru_all[..., :D], ru_all[..., D:]
    cand_all = torch.tanh(
        xp_all[..., 2 * D:]
        + linear((r_all * s_prev.float()).to(s_prev.dtype),
                 wh[:, 2 * D:]).float())
    q_all = linear(s_prev, att_w)                           # [T, B, A]
    return r_all, u_all, cand_all, q_all


def _decoder_bwd(saved, d_states):
    (y_emb, s0, enc, enc_proj, src_mask, trg_mask, att_w, att_v, wx, b, wh,
     s_prev, probs, ctxs) = saved
    D = s0.shape[-1]
    E = y_emb.shape[-1]
    f32 = torch.float32

    y_tb = y_emb.transpose(0, 1)
    m_tb = trg_mask.transpose(0, 1)
    # the hoisted y-projection, recomputed (the same product as the
    # forward's, so the same values)
    xp_y_tb = linear(y_emb, wx[:E], b).transpose(0, 1)
    d_out_tb = d_states.transpose(0, 1).float()
    wx_f, wh_f = wx.float(), wh.float()
    wx_c_t = wx_f[E:].t()

    r_all, u_all, cand_all, q_all = recompute_gates(
        xp_y_tb, ctxs, s_prev, wx[E:], wh, att_w)
    # the reverse loop (K6), with the reference's Pallas-branch casts
    enc_c, encp_c = mxu_cast(enc, enc_proj)
    d_xp_tb, sum_dpre_tb, d_enc_p, d_v, d_s = attn_dec_bwd(
        d_out_tb, m_tb.to(f32), s_prev, r_all, u_all, cand_all,
        q_all, enc_c, encp_c, src_mask.to(f32), att_w.float(), att_v, wh_f,
        wx_f[E:])
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
