"""Recurrent cells and full-sequence GRU/LSTM ops — counterpart of
``paddle_tpu/ops/rnn.py``.

The input projection for all timesteps is one matmul outside the time loop;
the default-activation cells run their loops in the kernels (GRU:
``gru_forward``/``gru_backward`` through ``rnn_fused.gru_sequence_fused``,
or, for ``bigru_layer`` under ``FLAGS.fused_bigru``, ``bigru_forward``/
``bigru_backward`` through ``rnn_fused.bigru_sequence_fused``;
LSTM: ``lstm_forward``/``lstm_backward`` through
``rnn_fused.lstm_sequence_fused``), any other activation in the plain
``scan_rnn`` loop.  Do not swap in ``torch.nn.GRU``/``torch.nn.LSTM`` or
cuDNN: the reference GRU applies ``r`` to ``h`` BEFORE the candidate product
(``gru_step``), torch's after it; the reference LSTM's gate layout is
``[i, f, o, g]`` (torch's ``[i, f, g, o]``) with the legacy peepholes: i and
f see ``c_prev``, o sees ``c_new``.

Under ``--amp`` the input projection leaves in bfloat16.  The kernel
paths widen it at their boundary and keep float32 carries (the reference's
Pallas semantics); ``scan_rnn`` keeps its carry in ``xp``'s dtype and
multiplies into bfloat16 (the reference's scan semantics), with the
peepholes cast to that dtype at the boundary.  ``gru_cell_bwd`` and
``lstm_cell_bwd`` serve the kernels' plain versions, which run inside
``numerics.float32_products()``: their ``bwd_mm`` products stay float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from paddle_tpu_torch.ops.activations import get_activation
from paddle_tpu_torch.ops.matmul import linear
from paddle_tpu_torch.ops.numerics import bwd_mm
from paddle_tpu_torch.utils.flags import FLAGS

__all__ = ["gru_cell", "gru_cell_bwd", "gru_step", "lstm_cell",
           "lstm_cell_bwd", "lstm_step", "scan_rnn", "gru_layer",
           "bigru_layer", "lstm_layer"]


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


def lstm_cell(xp: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_h: torch.Tensor, *, peep_i=None, peep_f=None, peep_o=None,
              act="tanh", gate_act="sigmoid", state_act="tanh"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LSTM step with its pre-activations -> (h_new, c_new, z [B, 4H]).
    xp [B, 4H] input projection (+bias), h/c [B, H], w_h [H, 4H]; gate
    layout [i, f, o, g]; ``z = xp + h . w_h`` is the PRE-peephole
    pre-activation.  Peepholes (optional [H] vectors, the reference's
    ``check`` weights): i and f see c_prev, o sees c_new."""
    ga, sa, aa = (get_activation(gate_act), get_activation(state_act),
                  get_activation(act))
    z = xp + linear(h, w_h)
    i, f, o, g = z.chunk(4, dim=-1)
    if peep_i is not None:
        i = i + peep_i.to(z.dtype) * c
    if peep_f is not None:
        f = f + peep_f.to(z.dtype) * c
    i, f = ga(i), ga(f)
    c_new = f * c + i * aa(g)
    if peep_o is not None:
        o = o + peep_o.to(z.dtype) * c_new
    return ga(o) * sa(c_new), c_new, z


def lstm_step(xp: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_h: torch.Tensor, *, peep_i=None, peep_f=None, peep_o=None,
              act="tanh", gate_act="sigmoid", state_act="tanh"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step (``lstm_cell``'s new carries)."""
    h_new, c_new, _ = lstm_cell(xp, h, c, w_h, peep_i=peep_i, peep_f=peep_f,
                                peep_o=peep_o, act=act, gate_act=gate_act,
                                state_act=state_act)
    return h_new, c_new


def lstm_cell_bwd(d_hnew: torch.Tensor, d_c: torch.Tensor, z: torch.Tensor,
                  c_prev: torch.Tensor, w_t: torch.Tensor, pi: torch.Tensor,
                  pf: torch.Tensor, po: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Backward of the default-activation ``lstm_cell`` from its saved
    pre-peephole ``z`` [B, 4H] and ``c_prev`` [B, H], in float32 with a
    ``bwd_mm`` product: d_hnew and d_c [B, H] are the cotangents of h_new
    and c_new, w_t [4H, H] the transposed weight, pi/pf/po [H] the
    peepholes -> (d_z [B, 4H], d_h_prev [B, H] (the product part),
    d_c_prev [B, H], c_new [B, H])."""
    H = c_prev.shape[-1]
    i = torch.sigmoid(z[:, :H] + pi * c_prev)
    f = torch.sigmoid(z[:, H:2 * H] + pf * c_prev)
    g = torch.tanh(z[:, 3 * H:])
    c_new = f * c_prev + i * g
    o = torch.sigmoid(z[:, 2 * H:3 * H] + po * c_new)
    tc = torch.tanh(c_new)
    d_zo = d_hnew * tc * o * (1 - o)
    d_cnew = d_c + d_hnew * o * (1.0 - tc * tc) + d_zo * po
    d_zi = d_cnew * g * i * (1 - i)
    d_zf = d_cnew * c_prev * f * (1 - f)
    d_zg = d_cnew * i * (1 - g * g)
    d_cp = d_cnew * f + d_zi * pi + d_zf * pf
    d_z = torch.cat([d_zi, d_zf, d_zo, d_zg], -1)
    return d_z, bwd_mm(d_z, w_t), d_cp, c_new


def _tree_map(fn: Callable, *trees):
    """``fn`` over matching tensors of tensors or (nested) tuples."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def scan_rnn(step_fn: Callable, carry_init, xs_btd: torch.Tensor,
             mask_bt: torch.Tensor, *, reverse: bool = False,
             reset_bt: Optional[torch.Tensor] = None):
    """Run ``step_fn(carry, x_t) -> (carry, out_t)`` over time with length
    masking: where mask == 0 the carry is held and the output is zero.
    The carry, the inputs and the output are tensors or tuples of tensors
    (an LSTM's ``(h, c)``; a recurrent group's several frame inputs).
    ``reset_bt`` [B, T] (a packed row's ``segment_starts``) puts
    ``carry_init`` back in place of the incoming carry where it is 1, so
    no state flows from one packed segment into the next.
    xs [B, T, ...] -> (final carry, outs [B, T, ...])."""
    T = mask_bt.shape[1]
    carry = carry_init
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        m_t = mask_bt[:, t]

        def bmask(a, m=m_t):  # [B] mask broadcast against [B, ...]
            return m.reshape(m.shape + (1,) * (a.dim() - 1))

        if reset_bt is not None:
            r_t = reset_bt[:, t]
            carry = _tree_map(
                lambda init, c: torch.where(bmask(c, r_t).to(c.dtype) > 0,
                                            init, c), carry_init, carry)
        new, out = step_fn(carry, _tree_map(lambda x: x[:, t], xs_btd))
        carry = _tree_map(lambda n, o: torch.where(bmask(n) > 0, n, o), new,
                          carry)
        outs[t] = _tree_map(lambda o: o * bmask(o).to(o.dtype), out)
    return carry, _tree_map(lambda *o: torch.stack(o, 1), *outs)


def gru_layer(x: torch.Tensor, mask: torch.Tensor, w_x: Optional[torch.Tensor],
              w_h: torch.Tensor, b: torch.Tensor, *,
              h0: Optional[torch.Tensor] = None, reverse: bool = False,
              act="tanh", gate_act="sigmoid",
              reset: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over a padded batch.  x [B, T, D] -> (h_seq [B, T, H], h_final).
    ``w_x=None``: x is already the [B, T, 3H] projection.  ``reset`` [B, T]
    (a packed row) zeroes the carry at segment entries; it runs
    ``scan_rnn``, as the reference's reset does: only the unreset default
    cell takes ``gru_sequence_fused``."""
    B, T, _ = x.shape
    H = w_h.shape[0]
    xp = (x + b.to(x.dtype)) if w_x is None else linear(x, w_x, b)
    if reset is None and (act, gate_act) == ("tanh", "sigmoid"):
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

    h_fin, h_seq = scan_rnn(step, h, xp, mask, reverse=reverse,
                            reset_bt=reset)
    return h_seq, h_fin


def bigru_layer(x, mask, wx_fw, wh_fw, b_fw, wx_bw, wh_bw, b_bw
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional GRU over a padded batch -- the flagship's encoder.
    Returns (h_fw [B, T, H], h_bw [B, T, H], h_bw_final [B, H]).

    By default two ``gru_layer`` calls, the backward one reversed.  With
    ``FLAGS.fused_bigru`` both directions run in ONE time loop
    (``rnn_fused.bigru_sequence_fused``, K11): the backward direction's
    projection is flipped whole -- its padding moves to the front, where
    the zero carry holds through the masked steps -- and stacked under the
    forward one's, and its outputs are flipped back."""
    if not FLAGS.fused_bigru:
        h_fw, _ = gru_layer(x, mask, wx_fw, wh_fw, b_fw)
        h_bw, h_bw_fin = gru_layer(x, mask, wx_bw, wh_bw, b_bw, reverse=True)
        return h_fw, h_bw, h_bw_fin
    from paddle_tpu_torch.ops.rnn_fused import bigru_sequence_fused

    B = x.shape[0]
    xp_fw = linear(x, wx_fw, b_fw)
    xp_bw = linear(x, wx_bw, b_bw)
    xp2 = torch.cat([xp_fw, torch.flip(xp_bw, [1])])
    mask2 = torch.cat([mask, torch.flip(mask, [1])])
    h2, h_fin2 = bigru_sequence_fused(xp2, mask2, wh_fw, wh_bw, B)
    return h2[:B], torch.flip(h2[B:], [1]), h_fin2[B:]


def lstm_layer(x: torch.Tensor, mask: torch.Tensor,
               w_x: Optional[torch.Tensor], w_h: torch.Tensor,
               b: torch.Tensor, *, h0: Optional[torch.Tensor] = None,
               c0: Optional[torch.Tensor] = None, reverse: bool = False,
               peep_i=None, peep_f=None, peep_o=None, act="tanh",
               gate_act="sigmoid", state_act="tanh",
               reset: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """LSTM over a padded batch.  x [B, T, D] -> (h_seq [B, T, H],
    (h_final, c_final)).  ``w_x=None``: x is already the [B, T, 4H]
    projection.  The default cell (peepholes included; absent ones are
    zeros, which degenerate exactly) runs ``lstm_sequence_fused``, with
    ``reverse`` as a flip; any other activation runs ``scan_rnn``.
    ``reset`` [B, T] (a packed row's ``segment_starts``) zeroes the (h, c)
    carry at segment entries and runs ``scan_rnn`` whatever the cell: the
    reference routes a reset the same way (its fused time loop has no
    reset), so a packed LSTM launches no K9/K10."""
    B, T, _ = x.shape
    H = w_h.shape[0]
    xp = (x + b.to(x.dtype)) if w_x is None else linear(x, w_x, b)
    if reset is None and \
            (act, gate_act, state_act) == ("tanh", "sigmoid", "tanh"):
        from paddle_tpu_torch.ops.rnn_fused import lstm_sequence_fused

        has_peeps = any(p is not None for p in (peep_i, peep_f, peep_o))
        zp = torch.zeros(H, dtype=xp.dtype, device=xp.device)
        # peepholes join the carry arithmetic in xp's dtype, as the
        # reference casts them at this boundary
        pi, pf, po = (zp if p is None else p.to(xp.dtype)
                      for p in (peep_i, peep_f, peep_o))
        xp_r = torch.flip(xp, [1]) if reverse else xp
        m_r = torch.flip(mask, [1]) if reverse else mask
        h_seq, h_fin, c_fin = lstm_sequence_fused(
            xp_r, m_r, w_h, h0, c0, pi, pf, po, has_peepholes=has_peeps)
        if reverse:
            h_seq = torch.flip(h_seq, [1])
        return h_seq, (h_fin, c_fin)
    zeros = torch.zeros(B, H, dtype=xp.dtype, device=xp.device)
    h = zeros if h0 is None else h0
    c = zeros if c0 is None else c0

    def step(carry, xp_t):
        h2, c2 = lstm_step(xp_t, *carry, w_h, peep_i=peep_i, peep_f=peep_f,
                           peep_o=peep_o, act=act, gate_act=gate_act,
                           state_act=state_act)
        return (h2, c2), h2

    (h_fin, c_fin), h_seq = scan_rnn(step, (h, c), xp, mask, reverse=reverse,
                                     reset_bt=reset)
    return h_seq, (h_fin, c_fin)
