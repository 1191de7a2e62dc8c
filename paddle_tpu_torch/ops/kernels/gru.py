"""GRU time loops, forward and backward: the CUDA kernels' wrappers and their
plain versions.

- ``gru_forward`` replaces ``paddle_tpu/ops/pallas_kernels.py::
  _gru_pallas_raw`` (K3): ``residuals=False`` is the inference variant,
  ``residuals=True`` adds the backward's residual outputs ``z``/``h_prev``
  (time-major, in ``residual_dtype(H)``), as the reference's training call.
- ``gru_backward`` replaces ``_gru_bwd_pallas_raw`` (K4), the reverse loop.

Each wrapper dispatches on the tensors' device: a CPU tensor runs the plain
version; a CUDA tensor launches ``csrc/gru_forward.cu`` /
``csrc/gru_backward.cu`` or raises.  No flag picks the plain version on the
card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.numerics import compute_dtype, residual_dtype
from paddle_tpu_torch.ops.rnn import gru_cell, gru_cell_bwd

__all__ = ["gru_forward", "gru_forward_plain", "gru_backward",
           "gru_backward_plain", "GRU_FORWARD", "GRU_BACKWARD"]

_FWD_ARGS = [ARG_PTR] * 9 + [ARG_INT] * 4 + [ARG_PTR]
GRU_FORWARD = register("gru_forward", {"gru_forward_f32": _FWD_ARGS,
                                       "gru_forward_bf16": _FWD_ARGS})
_ENTRY = {torch.float32: "gru_forward_f32",
          torch.bfloat16: "gru_forward_bf16"}

GRU_BACKWARD = register("gru_backward", {
    "gru_backward": [ARG_PTR] * 8 + [ARG_INT] * 4 + [ARG_PTR]})

_RES_DTYPES = (torch.float32, torch.bfloat16)


def _check(xp, mask, w_h, h0) -> Tuple[int, int, int]:
    if xp.dim() != 3 or xp.shape[-1] % 3:
        raise ValueError(f"xp must be [B, T, 3H], got {tuple(xp.shape)}")
    B, T, H3 = xp.shape
    H = H3 // 3
    if tuple(mask.shape) != (B, T):
        raise ValueError(f"mask must be [B, T] = {(B, T)}, got "
                         f"{tuple(mask.shape)}")
    if tuple(w_h.shape) != (H, H3):
        raise ValueError(f"w_h must be [H, 3H] = {(H, H3)}, got "
                         f"{tuple(w_h.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, H):
        raise ValueError(f"h0 must be [B, H] = {(B, H)}, got "
                         f"{tuple(h0.shape)}")
    devs = {t.device for t in (xp, mask, w_h, h0) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"gru_forward inputs span devices {devs}")
    return B, T, H


def gru_forward_plain(xp: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
                      h0: Optional[torch.Tensor] = None, *,
                      residuals: bool = False):
    """The kernel's function as a step loop of PyTorch ops.  Same arguments
    and results as ``gru_forward``."""
    B, T, H = _check(xp, mask, w_h, h0)
    xp = xp.float()
    m = mask.float()
    h = (torch.zeros(B, H, device=xp.device) if h0 is None
         else h0.float())
    rd = residual_dtype(H)
    outs, zs, hps = [], [], []
    for t in range(T):
        m_t = m[:, t, None]
        h_new, zr, zc = gru_cell(xp[:, t], h, w_h)
        if residuals:
            zs.append(torch.cat([zr, zc], -1).to(rd))
            hps.append(h.to(rd))
        h = torch.where(m_t > 0, h_new, h)
        outs.append(h * m_t)
    h_seq = (torch.stack(outs, 1) if outs
             else torch.zeros(B, 0, H, device=xp.device))
    if not residuals:
        return h_seq, h
    z = (torch.stack(zs) if zs
         else torch.zeros(0, B, 3 * H, dtype=rd, device=xp.device))
    hp = (torch.stack(hps) if hps
          else torch.zeros(0, B, H, dtype=rd, device=xp.device))
    return h_seq, h, z, hp


def gru_forward(xp: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *,
                residuals: bool = False):
    """GRU over a padded batch given its input projection.

    xp [B, T, 3H] (gate order [r, u, c]), mask [B, T], w_h [H, 3H] (f32 or
    bf16; cast to the compute dtype), h0 [B, H] or None for zeros ->
    (h_seq [B, T, H], h_final [B, H]), both float32.  Masked steps hold the
    carry and emit zero.  ``residuals=True`` also returns the backward's
    residuals, time-major in ``residual_dtype(H)``: z [T, B, 3H] (the
    pre-activations ``[zr, zc]``) and h_prev [T, B, H] (the carry entering
    each step)."""
    B, T, H = _check(xp, mask, w_h, h0)
    if xp.device.type == "cpu":
        return gru_forward_plain(xp, mask, w_h, h0, residuals=residuals)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_forward runs on cpu or cuda, not "
                         f"{xp.device}")
    cd = compute_dtype()
    dev = xp.device
    xp_tb = xp.float().transpose(0, 1).contiguous()        # time-major
    m_tb = mask.float().transpose(0, 1).contiguous()
    w = w_h.to(cd).contiguous()
    h = (torch.zeros(B, H, device=dev) if h0 is None
         else h0.float().clone().contiguous())
    h_seq = torch.empty(T, B, H, device=dev)
    rh = torch.empty(B, H, device=dev)
    u = torch.empty(B, H, device=dev)
    rd = residual_dtype(H)
    z = torch.empty(T, B, 3 * H, dtype=rd, device=dev) if residuals else None
    hp = torch.empty(T, B, H, dtype=rd, device=dev) if residuals else None
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        GRU_FORWARD.call(
            _ENTRY[cd], xp_tb.data_ptr(), m_tb.data_ptr(), w.data_ptr(),
            h_seq.data_ptr(), h.data_ptr(), rh.data_ptr(), u.data_ptr(),
            z.data_ptr() if residuals else None,
            hp.data_ptr() if residuals else None,
            int(rd == torch.bfloat16), T, B, H, stream)
    GRU_FORWARD.launches += 1
    if not residuals:
        return h_seq.transpose(0, 1), h
    return h_seq.transpose(0, 1), h, z, hp


def _check_bwd(d_out_tb, m_tb, z_tb, hp_tb, w_t, d_hfin) -> Tuple[int, int,
                                                                  int]:
    if z_tb.dim() != 3 or z_tb.shape[-1] % 3:
        raise ValueError(f"z must be [T, B, 3H], got {tuple(z_tb.shape)}")
    T, B, H3 = z_tb.shape
    H = H3 // 3
    want = {"d_out": (d_out_tb, (T, B, H)), "mask": (m_tb, (T, B)),
            "h_prev": (hp_tb, (T, B, H)), "w_t": (w_t, (H3, H)),
            "d_hfin": (d_hfin, (B, H))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    if z_tb.dtype not in _RES_DTYPES or hp_tb.dtype != z_tb.dtype:
        raise ValueError(f"residuals must share float32 or bfloat16, got "
                         f"{z_tb.dtype} and {hp_tb.dtype}")
    devs = {t.device for t in (d_out_tb, m_tb, z_tb, hp_tb, w_t, d_hfin)}
    if len(devs) != 1:
        raise ValueError(f"gru_backward inputs span devices {devs}")
    return T, B, H


def gru_backward_plain(d_out_tb: torch.Tensor, m_tb: torch.Tensor,
                       z_tb: torch.Tensor, hp_tb: torch.Tensor,
                       w_t: torch.Tensor, d_hfin: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function as a reverse step loop of PyTorch ops (the
    reference's ``_gru_bwd_kernel`` math).  Same arguments and results as
    ``gru_backward``."""
    T, B, H = _check_bwd(d_out_tb, m_tb, z_tb, hp_tb, w_t, d_hfin)
    w_t = w_t.float()
    d_c = d_hfin.float()
    d_z = torch.empty(T, B, 3 * H, device=z_tb.device)
    for t in range(T - 1, -1, -1):
        z = z_tb[t].float()
        r = torch.sigmoid(z[:, :H])
        u = torch.sigmoid(z[:, H:2 * H])
        cand = torch.tanh(z[:, 2 * H:])
        mcol = (m_tb[t] > 0).float()[:, None]
        d_hnew = mcol * (d_out_tb[t].float() + d_c)
        d_zr, d_zc, d_hp = gru_cell_bwd(d_hnew, hp_tb[t].float(), r, u, cand,
                                        w_t[2 * H:], w_t[:2 * H])
        d_c = (1.0 - mcol) * d_c + d_hp
        d_z[t, :, :2 * H] = d_zr
        d_z[t, :, 2 * H:] = d_zc
    return d_z, d_c


def gru_backward(d_out_tb: torch.Tensor, m_tb: torch.Tensor,
                 z_tb: torch.Tensor, hp_tb: torch.Tensor, w_t: torch.Tensor,
                 d_hfin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse GRU loop from the forward's residuals, time-major.

    d_out [T, B, H] (the cotangent of h_seq), mask [T, B], z [T, B, 3H] and
    h_prev [T, B, H] (``gru_forward(residuals=True)``, f32 or bf16),
    w_t [3H, H] (the transposed recurrent weight, used in f32),
    d_hfin [B, H] -> (d_z [T, B, 3H] f32, the pre-activation cotangents
    ``[d_zr, d_zc]``; d_h0 [B, H] f32)."""
    T, B, H = _check_bwd(d_out_tb, m_tb, z_tb, hp_tb, w_t, d_hfin)
    if z_tb.device.type == "cpu":
        return gru_backward_plain(d_out_tb, m_tb, z_tb, hp_tb, w_t, d_hfin)
    if z_tb.device.type != "cuda":
        raise ValueError(f"gru_backward runs on cpu or cuda, not "
                         f"{z_tb.device}")
    dev = z_tb.device
    dout = d_out_tb.float().contiguous()
    m = m_tb.float().contiguous()
    z = z_tb.contiguous()
    hp = hp_tb.contiguous()
    wt = w_t.float().contiguous()
    d_c = d_hfin.float().clone().contiguous()
    d_z = torch.empty(T, B, 3 * H, device=dev)
    part = torch.empty(B, H, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        GRU_BACKWARD.call(
            "gru_backward", dout.data_ptr(), m.data_ptr(), z.data_ptr(),
            hp.data_ptr(), wt.data_ptr(), d_z.data_ptr(), d_c.data_ptr(),
            part.data_ptr(), int(z.dtype == torch.bfloat16), T, B, H, stream)
    GRU_BACKWARD.launches += 1
    return d_z, d_c
