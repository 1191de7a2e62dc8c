"""LSTM time loops, forward and backward: the CUDA kernels' wrappers and
their plain versions.

- ``lstm_forward`` replaces ``paddle_tpu/ops/pallas_kernels.py::
  _lstm_pallas_raw`` (K9): ``residuals=False`` is the inference variant,
  ``residuals=True`` adds the backward's residual outputs ``z`` (the
  pre-peephole pre-activations), ``h_prev`` and ``c_prev`` (time-major, in
  ``residual_dtype(H)``), as the reference's training call.  Unlike the
  reference kernel, which boots from zeros, it starts from ``h0``/``c0``.
- ``lstm_backward`` replaces ``_lstm_bwd_pallas_raw`` (K10), the reverse
  loop, all in float32.

Gate layout ``[i, f, o, g]``; peepholes pi/pf/po [H] (zeros for the plain
cell): i and f see ``c_prev``, o sees ``c_new``.  Each wrapper dispatches on
the tensors' device: a CPU tensor runs the plain version; a CUDA tensor
launches ``csrc/lstm_forward.cu`` / ``csrc/lstm_backward.cu`` or raises.  No
flag picks the plain version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.numerics import compute_dtype, residual_dtype
from paddle_tpu_torch.ops.rnn import lstm_cell, lstm_cell_bwd

__all__ = ["lstm_forward", "lstm_forward_plain", "lstm_backward",
           "lstm_backward_plain", "LSTM_FORWARD", "LSTM_BACKWARD"]

_FWD_ARGS = [ARG_PTR] * 13 + [ARG_INT] * 4 + [ARG_PTR]
LSTM_FORWARD = register("lstm_forward", {"lstm_forward_f32": _FWD_ARGS,
                                         "lstm_forward_bf16": _FWD_ARGS})
_ENTRY = {torch.float32: "lstm_forward_f32",
          torch.bfloat16: "lstm_forward_bf16"}

LSTM_BACKWARD = register("lstm_backward", {
    "lstm_backward": [ARG_PTR] * 12 + [ARG_INT] * 4 + [ARG_PTR]})

_RES_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(fn: str, want) -> None:
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t, _ in want.values() if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{fn} inputs span devices {devs}")


def _check(xp, mask, w_h, pi, pf, po, h0, c0) -> Tuple[int, int, int]:
    if xp.dim() != 3 or xp.shape[-1] % 4:
        raise ValueError(f"xp must be [B, T, 4H], got {tuple(xp.shape)}")
    B, T, H4 = xp.shape
    H = H4 // 4
    _check_shapes("lstm_forward", {
        "xp": (xp, (B, T, H4)), "mask": (mask, (B, T)),
        "w_h": (w_h, (H, H4)), "pi": (pi, (H,)), "pf": (pf, (H,)),
        "po": (po, (H,)), "h0": (h0, (B, H)), "c0": (c0, (B, H))})
    return B, T, H


def lstm_forward_plain(xp: torch.Tensor, mask: torch.Tensor,
                       w_h: torch.Tensor, pi: torch.Tensor, pf: torch.Tensor,
                       po: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       c0: Optional[torch.Tensor] = None, *,
                       residuals: bool = False):
    """The kernel's function as a step loop of PyTorch ops (``lstm_cell``).
    Same arguments and results as ``lstm_forward``."""
    B, T, H = _check(xp, mask, w_h, pi, pf, po, h0, c0)
    dev = xp.device
    xp = xp.float()
    m = mask.float()
    h = torch.zeros(B, H, device=dev) if h0 is None else h0.float()
    c = torch.zeros(B, H, device=dev) if c0 is None else c0.float()
    peeps = dict(peep_i=pi.float(), peep_f=pf.float(), peep_o=po.float())
    rd = residual_dtype(H)
    outs, zs, hps, cps = [], [], [], []
    for t in range(T):
        m_t = m[:, t, None]
        h_new, c_new, z = lstm_cell(xp[:, t], h, c, w_h, **peeps)
        if residuals:
            zs.append(z.to(rd))
            hps.append(h.to(rd))
            cps.append(c.to(rd))
        keep = m_t > 0
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
        outs.append(h * m_t)
    h_seq = (torch.stack(outs, 1) if outs
             else torch.zeros(B, 0, H, device=dev))
    if not residuals:
        return h_seq, h, c

    def stacked(parts, width):
        return (torch.stack(parts) if parts
                else torch.zeros(0, B, width, dtype=rd, device=dev))

    return h_seq, h, c, stacked(zs, 4 * H), stacked(hps, H), stacked(cps, H)


def lstm_forward(xp: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
                 pi: torch.Tensor, pf: torch.Tensor, po: torch.Tensor,
                 h0: Optional[torch.Tensor] = None,
                 c0: Optional[torch.Tensor] = None, *,
                 residuals: bool = False):
    """LSTM over a padded batch given its input projection.

    xp [B, T, 4H] (gate order [i, f, o, g]), mask [B, T], w_h [H, 4H] (f32
    or bf16; cast to the compute dtype), pi/pf/po [H] peepholes, h0/c0
    [B, H] or None for zeros -> (h_seq [B, T, H], h_final, c_final
    [B, H]), all float32.  Masked steps hold the carries and emit zero.
    ``residuals=True`` also returns the backward's residuals, time-major in
    ``residual_dtype(H)``: z [T, B, 4H] (pre-peephole), h_prev and c_prev
    [T, B, H] (the carries entering each step)."""
    B, T, H = _check(xp, mask, w_h, pi, pf, po, h0, c0)
    if xp.device.type == "cpu":
        return lstm_forward_plain(xp, mask, w_h, pi, pf, po, h0, c0,
                                  residuals=residuals)
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_forward runs on cpu or cuda, not "
                         f"{xp.device}")
    cd = compute_dtype()
    dev = xp.device
    xp_tb = xp.float().transpose(0, 1).contiguous()        # time-major
    m_tb = mask.float().transpose(0, 1).contiguous()
    w = w_h.to(cd).contiguous()
    p = [v.float().contiguous() for v in (pi, pf, po)]

    def carry(v):
        return (torch.zeros(B, H, device=dev) if v is None
                else v.float().clone().contiguous())

    h, c = carry(h0), carry(c0)
    h_tmp = torch.empty(B, H, device=dev)
    h_seq = torch.empty(T, B, H, device=dev)
    rd = residual_dtype(H)
    res = ([torch.empty(T, B, n, dtype=rd, device=dev)
            for n in (4 * H, H, H)] if residuals else [None] * 3)
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        LSTM_FORWARD.call(
            _ENTRY[cd], xp_tb.data_ptr(), m_tb.data_ptr(), w.data_ptr(),
            *(v.data_ptr() for v in p), h_seq.data_ptr(), h.data_ptr(),
            h_tmp.data_ptr(), c.data_ptr(),
            *(None if r is None else r.data_ptr() for r in res),
            int(rd == torch.bfloat16), T, B, H, stream)
    LSTM_FORWARD.launches += 1
    if not residuals:
        return h_seq.transpose(0, 1), h, c
    return (h_seq.transpose(0, 1), h, c, *res)


def _check_bwd(d_out_tb, m_tb, z_tb, cp_tb, w_t, pi, pf, po, d_hfin,
               d_cfin) -> Tuple[int, int, int]:
    if z_tb.dim() != 3 or z_tb.shape[-1] % 4:
        raise ValueError(f"z must be [T, B, 4H], got {tuple(z_tb.shape)}")
    T, B, H4 = z_tb.shape
    H = H4 // 4
    _check_shapes("lstm_backward", {
        "d_out": (d_out_tb, (T, B, H)), "mask": (m_tb, (T, B)),
        "z": (z_tb, (T, B, H4)), "c_prev": (cp_tb, (T, B, H)),
        "w_t": (w_t, (H4, H)), "pi": (pi, (H,)), "pf": (pf, (H,)),
        "po": (po, (H,)), "d_hfin": (d_hfin, (B, H)),
        "d_cfin": (d_cfin, (B, H))})
    if z_tb.dtype not in _RES_DTYPES or cp_tb.dtype != z_tb.dtype:
        raise ValueError(f"residuals must share float32 or bfloat16, got "
                         f"{z_tb.dtype} and {cp_tb.dtype}")
    return T, B, H


def lstm_backward_plain(d_out_tb: torch.Tensor, m_tb: torch.Tensor,
                        z_tb: torch.Tensor, cp_tb: torch.Tensor,
                        w_t: torch.Tensor, pi: torch.Tensor,
                        pf: torch.Tensor, po: torch.Tensor,
                        d_hfin: torch.Tensor, d_cfin: torch.Tensor, *,
                        want_cn: bool = True):
    """The kernel's function as a reverse step loop of PyTorch ops
    (``lstm_cell_bwd``, the reference's ``_lstm_bwd_kernel`` math).  Same
    arguments and results as ``lstm_backward``."""
    T, B, H = _check_bwd(d_out_tb, m_tb, z_tb, cp_tb, w_t, pi, pf, po,
                         d_hfin, d_cfin)
    dev = z_tb.device
    w_t, pi, pf, po = (v.float() for v in (w_t, pi, pf, po))
    d_h, d_c = d_hfin.float(), d_cfin.float()
    d_z = torch.empty(T, B, 4 * H, device=dev)
    cn = torch.empty(T, B, H, device=dev) if want_cn else None
    for t in range(T - 1, -1, -1):
        mcol = (m_tb[t] > 0).float()[:, None]
        d_hnew = mcol * (d_out_tb[t].float() + d_h)
        dz, d_hp, d_cp, c_new = lstm_cell_bwd(
            d_hnew, mcol * d_c, z_tb[t].float(), cp_tb[t].float(), w_t, pi,
            pf, po)
        d_h = (1.0 - mcol) * d_h + d_hp
        d_c = (1.0 - mcol) * d_c + d_cp
        d_z[t] = dz
        if want_cn:
            cn[t] = c_new
    return d_z, cn, d_h, d_c


def lstm_backward(d_out_tb: torch.Tensor, m_tb: torch.Tensor,
                  z_tb: torch.Tensor, cp_tb: torch.Tensor, w_t: torch.Tensor,
                  pi: torch.Tensor, pf: torch.Tensor, po: torch.Tensor,
                  d_hfin: torch.Tensor, d_cfin: torch.Tensor, *,
                  want_cn: bool = True):
    """Reverse LSTM loop from the forward's residuals, time-major.

    d_out [T, B, H] (the cotangent of h_seq), mask [T, B], z [T, B, 4H]
    and c_prev [T, B, H] (``lstm_forward(residuals=True)``, f32 or bf16),
    w_t [4H, H] (the transposed recurrent weight, used in f32), pi/pf/po
    [H], d_hfin/d_cfin [B, H] -> (d_z [T, B, 4H] f32, the pre-activation
    cotangents; c_new [T, B, H] f32 for the ``d_po`` reduction, or None
    unless ``want_cn``; d_h0, d_c0 [B, H] f32)."""
    T, B, H = _check_bwd(d_out_tb, m_tb, z_tb, cp_tb, w_t, pi, pf, po,
                         d_hfin, d_cfin)
    if z_tb.device.type == "cpu":
        return lstm_backward_plain(d_out_tb, m_tb, z_tb, cp_tb, w_t, pi, pf,
                                   po, d_hfin, d_cfin, want_cn=want_cn)
    if z_tb.device.type != "cuda":
        raise ValueError(f"lstm_backward runs on cpu or cuda, not "
                         f"{z_tb.device}")
    dev = z_tb.device
    dout = d_out_tb.float().contiguous()
    m = m_tb.float().contiguous()
    z = z_tb.contiguous()
    cp = cp_tb.contiguous()
    wt = w_t.float().contiguous()
    p = [v.float().contiguous() for v in (pi, pf, po)]
    d_h = d_hfin.float().clone().contiguous()
    d_c = d_cfin.float().clone().contiguous()
    d_z = torch.empty(T, B, 4 * H, device=dev)
    cn = torch.empty(T, B, H, device=dev) if want_cn else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        LSTM_BACKWARD.call(
            "lstm_backward", dout.data_ptr(), m.data_ptr(), z.data_ptr(),
            cp.data_ptr(), wt.data_ptr(), *(v.data_ptr() for v in p),
            d_z.data_ptr(), None if cn is None else cn.data_ptr(),
            d_h.data_ptr(), d_c.data_ptr(), int(z.dtype == torch.bfloat16),
            T, B, H, stream)
    LSTM_BACKWARD.launches += 1
    return d_z, cn, d_h, d_c
