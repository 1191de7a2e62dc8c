"""GRU forward time loop: the CUDA kernel's wrapper and its plain version.

Replaces ``paddle_tpu/ops/pallas_kernels.py::_gru_pallas_raw`` (inference
variant).  ``gru_forward`` dispatches on the tensors' device: a CPU tensor
runs ``gru_forward_plain``; a CUDA tensor launches ``csrc/gru_forward.cu``
or raises.  No flag picks the plain version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.matmul import linear
from paddle_tpu_torch.ops.numerics import compute_dtype

__all__ = ["gru_forward", "gru_forward_plain", "GRU_FORWARD"]

_ARGS = [ARG_PTR] * 7 + [ARG_INT] * 3 + [ARG_PTR]
GRU_FORWARD = register("gru_forward", {"gru_forward_f32": _ARGS,
                                       "gru_forward_bf16": _ARGS})
_ENTRY = {torch.float32: "gru_forward_f32",
          torch.bfloat16: "gru_forward_bf16"}


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
                      h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function as a step loop of PyTorch ops.  Same arguments
    and results as ``gru_forward``."""
    B, T, H = _check(xp, mask, w_h, h0)
    xp = xp.float()
    m = mask.float()
    h = (torch.zeros(B, H, device=xp.device) if h0 is None
         else h0.float())
    w_g, w_c = w_h[:, :2 * H], w_h[:, 2 * H:]
    outs = []
    for t in range(T):
        x_t, m_t = xp[:, t], m[:, t, None]
        r, u = torch.sigmoid(x_t[:, :2 * H] + linear(h, w_g)).split(H, -1)
        cand = torch.tanh(x_t[:, 2 * H:] + linear(r * h, w_c))
        h_new = u * h + (1.0 - u) * cand
        h = torch.where(m_t > 0, h_new, h)
        outs.append(h * m_t)
    h_seq = (torch.stack(outs, 1) if outs
             else torch.zeros(B, 0, H, device=xp.device))
    return h_seq, h


def gru_forward(xp: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over a padded batch given its input projection.

    xp [B, T, 3H] (gate order [r, u, c]), mask [B, T], w_h [H, 3H] (f32 or
    bf16; cast to the compute dtype), h0 [B, H] or None for zeros ->
    (h_seq [B, T, H], h_final [B, H]), both float32.  Masked steps hold the
    carry and emit zero."""
    B, T, H = _check(xp, mask, w_h, h0)
    if xp.device.type == "cpu":
        return gru_forward_plain(xp, mask, w_h, h0)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_forward runs on cpu or cuda, not "
                         f"{xp.device}")
    cd = compute_dtype()
    xp_tb = xp.float().transpose(0, 1).contiguous()        # time-major
    m_tb = mask.float().transpose(0, 1).contiguous()
    w = w_h.to(cd).contiguous()
    h = (torch.zeros(B, H, device=xp.device) if h0 is None
         else h0.float().clone().contiguous())
    h_seq = torch.empty(T, B, H, device=xp.device)
    rh = torch.empty(B, H, device=xp.device)
    u = torch.empty(B, H, device=xp.device)
    with torch.cuda.device(xp.device):        # launch on the tensors' card
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        GRU_FORWARD.call(_ENTRY[cd], xp_tb.data_ptr(), m_tb.data_ptr(),
                         w.data_ptr(), h_seq.data_ptr(), h.data_ptr(),
                         rh.data_ptr(), u.data_ptr(), T, B, H, stream)
    GRU_FORWARD.launches += 1
    return h_seq.transpose(0, 1), h
