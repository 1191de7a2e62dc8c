"""Bidirectional GRU time loops, forward and backward (both directions of a
layer in one loop over a stacked batch): the CUDA kernels' wrappers and
their plain versions.

- ``bigru_forward`` replaces ``paddle_tpu/ops/pallas_kernels.py::
  _gru_pallas_raw`` called with ``batch_split=B`` (K11): ``residuals=False``
  is the inference variant, ``residuals=True`` adds the backward's
  residuals ``z``/``h_prev`` in ``residual_dtype(H)``.  It picks K3's
  kernel by K3's function (``gru._gru_fwd_path`` with two directions):
  ``"persistent"`` under bf16, one cooperative launch whose blocks each
  serve one direction, or ``"steps"``; ``BIGRU_FORWARD.launches_by_path``
  splits the count.
- ``bigru_backward`` replaces ``_gru_bwd_pallas_raw`` with
  ``batch_split=B``, the reverse loop.  It picks K4's kernel by K4's
  function (``gru._gru_bwd_path`` with two directions):
  ``"persistent"``, one cooperative launch whose blocks each serve one
  direction, or ``"steps"``; ``BIGRU_BACKWARD.launches_by_path`` splits
  the count.

The interfaces are the reference's, time-major: the stacked batch holds
``2 * batch_split`` rows, the forward direction's first and then the
backward direction's, flipped in time by the caller.  The forward takes the
recurrent weights stacked on rows, ``w2 [2H, 3H]``; the reverse takes the
transposed weights stacked on columns, ``w_t [3H, 2H]``, and the kernel
reads that layout as it is (row stride 2H).  Each row computes exactly what
one direction's ``gru_forward``/``gru_backward`` computes for it, so the
plain versions are two calls of those plain versions.

Each wrapper dispatches on the tensors' device: a CPU tensor runs the plain
version; a CUDA tensor launches ``csrc/bigru_forward.cu`` /
``csrc/bigru_backward.cu`` or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.kernels.build import device_sms as _device_sms
from paddle_tpu_torch.ops.kernels.gru import (_gru_bwd_path, _gru_bwd_plan,
                                              _gru_fwd_path, _gru_fwd_plan,
                                              gru_backward_plain,
                                              gru_forward_plain)
from paddle_tpu_torch.ops.numerics import compute_dtype, residual_dtype

__all__ = ["bigru_forward", "bigru_forward_plain", "bigru_backward",
           "bigru_backward_plain", "BIGRU_FORWARD", "BIGRU_BACKWARD"]

_FWD_ARGS = [ARG_PTR] * 9 + [ARG_INT] * 5 + [ARG_PTR]
BIGRU_FORWARD = register("bigru_forward", {
    "bigru_forward_f32": _FWD_ARGS, "bigru_forward_bf16": _FWD_ARGS,
    "bigru_forward_persistent": [ARG_PTR] * 10 + [ARG_INT] * 7 + [ARG_PTR]})
_ENTRY = {torch.float32: "bigru_forward_f32",
          torch.bfloat16: "bigru_forward_bf16"}

BIGRU_BACKWARD = register("bigru_backward", {
    "bigru_backward": [ARG_PTR] * 8 + [ARG_INT] * 5 + [ARG_PTR],
    "bigru_backward_persistent": [ARG_PTR] * 10 + [ARG_INT] * 7 + [ARG_PTR]})

_RES_DTYPES = (torch.float32, torch.bfloat16)


def _check_split(rows: int, batch_split: int) -> None:
    if batch_split < 1 or rows != 2 * batch_split:
        raise ValueError(f"the stacked batch must hold 2 * batch_split rows,"
                         f" got {rows} rows and batch_split={batch_split}")


def _check(xp_tb, m_tb, w2, batch_split) -> Tuple[int, int, int]:
    if xp_tb.dim() != 3 or xp_tb.shape[-1] % 3:
        raise ValueError(f"xp must be [T, 2B, 3H], got {tuple(xp_tb.shape)}")
    T, B2, H3 = xp_tb.shape
    H = H3 // 3
    _check_split(B2, batch_split)
    if tuple(m_tb.shape) != (T, B2):
        raise ValueError(f"mask must be [T, 2B] = {(T, B2)}, got "
                         f"{tuple(m_tb.shape)}")
    if tuple(w2.shape) != (2 * H, H3):
        raise ValueError(f"w2 must be [2H, 3H] = {(2 * H, H3)}, got "
                         f"{tuple(w2.shape)}")
    devs = {t.device for t in (xp_tb, m_tb, w2)}
    if len(devs) != 1:
        raise ValueError(f"bigru_forward inputs span devices {devs}")
    return T, B2, H


def bigru_forward_plain(xp_tb: torch.Tensor, m_tb: torch.Tensor,
                        w2: torch.Tensor, *, residuals: bool = True,
                        batch_split: int):
    """The kernel's function as two one-direction step loops
    (``gru_forward_plain`` on each half).  Same arguments and results as
    ``bigru_forward``."""
    _, _, H = _check(xp_tb, m_tb, w2, batch_split)
    halves = [gru_forward_plain(xp_tb[:, rows].transpose(0, 1),
                                m_tb[:, rows].t(), w, residuals=residuals)
              for rows, w in ((slice(0, batch_split), w2[:H]),
                              (slice(batch_split, None), w2[H:]))]
    (hs_a, hf_a, *res_a), (hs_b, hf_b, *res_b) = halves
    out = (torch.cat([hs_a, hs_b]).transpose(0, 1), torch.cat([hf_a, hf_b]))
    return out + tuple(torch.cat([a, b], 1) for a, b in zip(res_a, res_b))


def bigru_forward(xp_tb: torch.Tensor, m_tb: torch.Tensor, w2: torch.Tensor,
                  *, residuals: bool = True, batch_split: int):
    """Both GRU directions over a stacked time-major batch, zero initial
    carries.

    xp_tb [T, 2B, 3H] (gate order [r, u, c]; rows [B:] are the backward
    direction's inputs flipped in time), m_tb [T, 2B], w2 [2H, 3H] (rows
    [:H] the forward direction's recurrent weight, [H:] the backward one's;
    f32 or bf16, cast to the compute dtype), batch_split = B ->
    (h_seq [T, 2B, H], h_final [2B, H]), float32, in the same stacking.
    ``residuals=True`` also returns z [T, 2B, 3H] and h_prev [T, 2B, H] in
    ``residual_dtype(H)``."""
    T, B2, H = _check(xp_tb, m_tb, w2, batch_split)
    if xp_tb.device.type == "cpu":
        return bigru_forward_plain(xp_tb, m_tb, w2, residuals=residuals,
                                   batch_split=batch_split)
    if xp_tb.device.type != "cuda":
        raise ValueError(f"bigru_forward runs on cpu or cuda, not "
                         f"{xp_tb.device}")
    cd = compute_dtype()
    path = _gru_fwd_path(cd, batch_split, H, _device_sms(xp_tb.device),
                         ndir=2)
    out = _launch_fwd(xp_tb, m_tb, w2, residuals, batch_split, path)
    BIGRU_FORWARD.count(path)
    return out


def _launch_fwd(xp_tb, m_tb, w2, residuals: bool, batch_split: int,
                path: str):
    """K11's forward on CUDA operands through the kernel of ``path``;
    counts nothing (the wrapper counts)."""
    T, B2, H3 = xp_tb.shape
    H = H3 // 3
    cd = compute_dtype()
    dev = xp_tb.device
    xp = xp_tb.float().contiguous()
    m = m_tb.float().contiguous()
    w = w2.to(cd).contiguous()
    h = torch.zeros(B2, H, device=dev)
    h_seq = torch.empty(T, B2, H, device=dev)
    rd = residual_dtype(H)
    z = torch.empty(T, B2, 3 * H, dtype=rd, device=dev) if residuals else None
    hp = torch.empty(T, B2, H, dtype=rd, device=dev) if residuals else None
    res = [z.data_ptr() if residuals else None,
           hp.data_ptr() if residuals else None]
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "persistent":
            plan = _gru_fwd_plan(batch_split, H, _device_sms(dev), ndir=2)
            if cd != torch.bfloat16 or plan is None:
                raise ValueError(f"the persistent forward takes bf16 "
                                 f"compute and a plan, not {cd} at B=2x"
                                 f"{batch_split}, H={H}")
            hb = torch.empty(2, B2, H, dtype=torch.bfloat16, device=dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            BIGRU_FORWARD.call(
                "bigru_forward_persistent", xp.data_ptr(), m.data_ptr(),
                w.data_ptr(), h_seq.data_ptr(), h.data_ptr(),
                hb[0].data_ptr(), hb[1].data_ptr(), *res, bar.data_ptr(),
                int(rd == torch.bfloat16), T, B2, H, batch_split, plan["ug"],
                plan["rg"], stream)
        else:
            rh_u = torch.empty(2, B2, H, device=dev)
            BIGRU_FORWARD.call(
                _ENTRY[cd], xp.data_ptr(), m.data_ptr(), w.data_ptr(),
                h_seq.data_ptr(), h.data_ptr(), rh_u[0].data_ptr(),
                rh_u[1].data_ptr(), *res, int(rd == torch.bfloat16), T, B2,
                H, batch_split, stream)
    if not residuals:
        return h_seq, h
    return h_seq, h, z, hp


def _check_bwd(dout_tb, m_tb, z_tb, hp_tb, w_t, d_hfin,
               batch_split) -> Tuple[int, int, int]:
    if z_tb.dim() != 3 or z_tb.shape[-1] % 3:
        raise ValueError(f"z must be [T, 2B, 3H], got {tuple(z_tb.shape)}")
    T, B2, H3 = z_tb.shape
    H = H3 // 3
    _check_split(B2, batch_split)
    want = {"d_out": (dout_tb, (T, B2, H)), "mask": (m_tb, (T, B2)),
            "h_prev": (hp_tb, (T, B2, H)), "w_t": (w_t, (H3, 2 * H)),
            "d_hfin": (d_hfin, (B2, H))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    if z_tb.dtype not in _RES_DTYPES or hp_tb.dtype != z_tb.dtype:
        raise ValueError(f"residuals must share float32 or bfloat16, got "
                         f"{z_tb.dtype} and {hp_tb.dtype}")
    devs = {t.device for t in (dout_tb, m_tb, z_tb, hp_tb, w_t, d_hfin)}
    if len(devs) != 1:
        raise ValueError(f"bigru_backward inputs span devices {devs}")
    return T, B2, H


def bigru_backward_plain(dout_tb: torch.Tensor, m_tb: torch.Tensor,
                         z_tb: torch.Tensor, hp_tb: torch.Tensor,
                         w_t: torch.Tensor, d_hfin: torch.Tensor, *,
                         batch_split: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function as two one-direction reverse loops
    (``gru_backward_plain`` on each half).  Same arguments and results as
    ``bigru_backward``."""
    _, _, H = _check_bwd(dout_tb, m_tb, z_tb, hp_tb, w_t, d_hfin,
                         batch_split)
    halves = [gru_backward_plain(dout_tb[:, rows], m_tb[:, rows],
                                 z_tb[:, rows], hp_tb[:, rows], wt,
                                 d_hfin[rows])
              for rows, wt in ((slice(0, batch_split), w_t[:, :H]),
                               (slice(batch_split, None), w_t[:, H:]))]
    (dz_a, dh_a), (dz_b, dh_b) = halves
    return torch.cat([dz_a, dz_b], 1), torch.cat([dh_a, dh_b])


def bigru_backward(dout_tb: torch.Tensor, m_tb: torch.Tensor,
                   z_tb: torch.Tensor, hp_tb: torch.Tensor,
                   w_t: torch.Tensor, d_hfin: torch.Tensor, *,
                   batch_split: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse loop of both GRU directions from ``bigru_forward``'s
    residuals, time-major.

    d_out [T, 2B, H] (the cotangent of h_seq), mask [T, 2B], z [T, 2B, 3H]
    and h_prev [T, 2B, H] (f32 or bf16), w_t [3H, 2H] (the two directions'
    transposed recurrent weights stacked on columns, used in f32),
    d_hfin [2B, H], batch_split = B -> (d_z [T, 2B, 3H] f32, the
    pre-activation cotangents; d_h0 [2B, H] f32)."""
    T, B2, H = _check_bwd(dout_tb, m_tb, z_tb, hp_tb, w_t, d_hfin,
                          batch_split)
    if z_tb.device.type == "cpu":
        return bigru_backward_plain(dout_tb, m_tb, z_tb, hp_tb, w_t, d_hfin,
                                    batch_split=batch_split)
    if z_tb.device.type != "cuda":
        raise ValueError(f"bigru_backward runs on cpu or cuda, not "
                         f"{z_tb.device}")
    path = _gru_bwd_path(batch_split, H, _device_sms(z_tb.device), ndir=2)
    out = _launch_bwd(dout_tb, m_tb, z_tb, hp_tb, w_t, d_hfin, batch_split,
                      path)
    BIGRU_BACKWARD.count(path)
    return out


def _launch_bwd(dout_tb, m_tb, z_tb, hp_tb, w_t, d_hfin, batch_split: int,
                path: str):
    """K11's reverse on CUDA operands through the kernel of ``path``; counts
    nothing (the wrapper counts)."""
    T, B2, H3 = z_tb.shape
    H = H3 // 3
    dev = z_tb.device
    dout = dout_tb.float().contiguous()
    m = m_tb.float().contiguous()
    z = z_tb.contiguous()
    hp = hp_tb.contiguous()
    wt = w_t.float().contiguous()
    d_c = d_hfin.float().clone().contiguous()
    d_z = torch.empty(T, B2, 3 * H, device=dev)
    part = torch.empty(B2, H, device=dev)
    args = [dout.data_ptr(), m.data_ptr(), z.data_ptr(), hp.data_ptr(),
            wt.data_ptr(), d_z.data_ptr(), d_c.data_ptr(), part.data_ptr()]
    res_bf16 = int(z.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "persistent":
            plan = _gru_bwd_plan(batch_split, H, _device_sms(dev), ndir=2)
            dzc = torch.empty(B2, H, device=dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            BIGRU_BACKWARD.call(
                "bigru_backward_persistent", *args, dzc.data_ptr(),
                bar.data_ptr(), res_bf16, T, B2, H, batch_split, plan["cg"],
                plan["rg"], stream)
        else:
            BIGRU_BACKWARD.call("bigru_backward", *args, res_bf16, T, B2, H,
                                batch_split, stream)
    return d_z, d_c
