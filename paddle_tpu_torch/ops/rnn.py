"""Recurrent cells and full-sequence GRU ops — counterpart of
``paddle_tpu/ops/rnn.py`` for the GRU this slice runs.

The input projection for all timesteps is one matmul outside the time loop;
the default-activation GRU runs its loop in the ``gru_forward`` kernel
(through ``rnn_fused.gru_sequence_fused``), any other activation in the
plain ``scan_rnn`` loop.  Do not swap in ``torch.nn.GRU``: the reference
applies ``r`` to ``h`` BEFORE the candidate product (``gru_step``), torch's
GRU after it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from paddle_tpu_torch.ops.activations import get_activation
from paddle_tpu_torch.ops.matmul import linear
from paddle_tpu_torch.ops.numerics import bwd_mm

__all__ = ["gru_cell", "gru_cell_bwd", "gru_step", "scan_rnn", "gru_layer",
           "bigru_layer"]


def gru_cell(xp: torch.Tensor, h: torch.Tensor, w_h: torch.Tensor, *,
             act="tanh", gate_act="sigmoid"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One GRU step with its pre-activations -> (h_new, zr [B, 2H],
    zc [B, H]).  xp [B, 3H] input projection (+bias), gate layout [r, u, c];
    w_h [H, 3H] with the candidate block applied to (r * h)."""
    ga, aa = get_activation(gate_act), get_activation(act)
    H = h.shape[-1]
    zr = xp[..., :2 * H] + linear(h, w_h[:, :2 * H])
    r, u = ga(zr).split(H, dim=-1)
    zc = xp[..., 2 * H:] + linear(r * h, w_h[:, 2 * H:])
    return u * h + (1.0 - u) * aa(zc), zr, zc


def gru_step(xp: torch.Tensor, h: torch.Tensor, w_h: torch.Tensor, *,
             act="tanh", gate_act="sigmoid") -> torch.Tensor:
    """One GRU step (``gru_cell``'s new carry)."""
    return gru_cell(xp, h, w_h, act=act, gate_act=gate_act)[0]


def gru_cell_bwd(d_hnew: torch.Tensor, h_prev: torch.Tensor, r: torch.Tensor,
                 u: torch.Tensor, cand: torch.Tensor, w_c_t: torch.Tensor,
                 w_g_t: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the default-activation ``gru_cell`` from its gates, in
    float32 with ``bwd_mm`` products: d_hnew [B, H], the carry h_prev and
    the gates r, u, cand [B, H], the transposed weight blocks w_c_t [H, H]
    and w_g_t [2H, H] -> (d_zr [B, 2H], d_zc [B, H], d_h_prev [B, H])."""
    d_u = d_hnew * (h_prev - cand)
    d_zc = d_hnew * (1.0 - u) * (1.0 - cand * cand)
    d_rh = bwd_mm(d_zc, w_c_t)
    d_zr = torch.cat([d_rh * h_prev * r * (1 - r), d_u * u * (1 - u)], -1)
    d_hp = d_hnew * u + d_rh * r + bwd_mm(d_zr, w_g_t)
    return d_zr, d_zc, d_hp


def scan_rnn(step_fn: Callable, carry_init: torch.Tensor, xs_btd: torch.Tensor,
             mask_bt: torch.Tensor, *, reverse: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``step_fn(carry, x_t) -> (carry, out_t)`` over time with length
    masking: where mask == 0 the carry is held and the output is zero.
    xs [B, T, ...] -> (final carry, outs [B, T, ...])."""
    T = mask_bt.shape[1]
    carry = carry_init
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        m_t = mask_bt[:, t]
        new, out = step_fn(carry, xs_btd[:, t])
        mb = m_t.reshape(m_t.shape + (1,) * (new.dim() - 1))
        carry = torch.where(mb > 0, new, carry)
        outs[t] = out * mb.to(out.dtype)
    return carry, torch.stack(outs, 1)


def gru_layer(x: torch.Tensor, mask: torch.Tensor, w_x: Optional[torch.Tensor],
              w_h: torch.Tensor, b: torch.Tensor, *,
              h0: Optional[torch.Tensor] = None, reverse: bool = False,
              act="tanh", gate_act="sigmoid"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over a padded batch.  x [B, T, D] -> (h_seq [B, T, H], h_final).
    ``w_x=None``: x is already the [B, T, 3H] projection."""
    B, T, _ = x.shape
    H = w_h.shape[0]
    xp = (x + b.to(x.dtype)) if w_x is None else linear(x, w_x, b)
    if (act, gate_act) == ("tanh", "sigmoid"):
        from paddle_tpu_torch.ops.rnn_fused import gru_sequence_fused

        # reverse rides a flip: padding moves to the front, where the zero
        # carry holds through the masked steps
        xp_r = torch.flip(xp, [1]) if reverse else xp
        m_r = torch.flip(mask, [1]) if reverse else mask
        h_seq, h_fin = gru_sequence_fused(xp_r, m_r, w_h, h0)
        if reverse:
            h_seq = torch.flip(h_seq, [1])
        return h_seq, h_fin
    h = torch.zeros(B, H, dtype=xp.dtype, device=xp.device) if h0 is None \
        else h0

    def step(h, xp_t):
        h2 = gru_step(xp_t, h, w_h, act=act, gate_act=gate_act)
        return h2, h2

    h_fin, h_seq = scan_rnn(step, h, xp, mask, reverse=reverse)
    return h_seq, h_fin


def bigru_layer(x, mask, wx_fw, wh_fw, b_fw, wx_bw, wh_bw, b_bw
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional GRU over a padded batch: two ``gru_layer`` calls, the
    backward one reversed.  Returns (h_fw, h_bw, h_bw_final)."""
    h_fw, _ = gru_layer(x, mask, wx_fw, wh_fw, b_fw)
    h_bw, h_bw_fin = gru_layer(x, mask, wx_bw, wh_bw, b_bw, reverse=True)
    return h_fw, h_bw, h_bw_fin
