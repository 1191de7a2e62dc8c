"""GRU time loops, forward and backward: the CUDA kernels' wrappers and their
plain versions.

- ``gru_forward`` replaces ``paddle_tpu/ops/pallas_kernels.py::
  _gru_pallas_raw`` (K3): ``residuals=False`` is the inference variant,
  ``residuals=True`` adds the backward's residual outputs ``z``/``h_prev``
  (time-major, in ``residual_dtype(H)``), as the reference's training call.
  On the card ``_gru_fwd_path`` picks its kernel from (compute dtype, B,
  H, SM count) alone: ``"persistent"`` under bf16, the whole loop in one
  cooperative launch with bf16 ``W`` resident in shared memory split by
  16-unit groups across the SMs (``_gru_fwd_plan``), where the split
  fits; else ``"steps"``, two launches per step.
  ``GRU_FORWARD.launches_by_path`` splits the count.  K11's forward
  (``ops/kernels/bigru.py``) shares both kernels and the plan.
- ``gru_backward`` replaces ``_gru_bwd_pallas_raw`` (K4), the reverse loop,
  all in float32.  On the card ``_gru_bwd_path`` picks its kernel from (B,
  H, SM count) alone: ``"persistent"``, the whole loop in one cooperative
  launch with ``w_t`` resident in shared memory split by 32-column groups
  across the SMs (``_gru_bwd_plan``), where the split fits; else
  ``"steps"``, two launches per reverse step.
  ``GRU_BACKWARD.launches_by_path`` splits the count.  K11's reverse
  (``ops/kernels/bigru.py``) shares both kernels and the plan.

Each wrapper dispatches on the tensors' device: a CPU tensor runs the plain
version; a CUDA tensor launches ``csrc/gru_forward.cu`` /
``csrc/gru_backward.cu`` or raises.  No flag picks the plain version on the
card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.kernels.build import device_sms as _device_sms
from paddle_tpu_torch.ops.numerics import (compute_dtype, float32_products,
                                           residual_dtype)
from paddle_tpu_torch.ops.rnn import gru_cell, gru_cell_bwd

__all__ = ["gru_forward", "gru_forward_plain", "gru_backward",
           "gru_backward_plain", "GRU_FORWARD", "GRU_BACKWARD",
           "gru_fwd_kernel_info", "gru_bwd_kernel_info"]

_FWD_ARGS = [ARG_PTR] * 9 + [ARG_INT] * 4 + [ARG_PTR]
GRU_FORWARD = register("gru_forward", {
    "gru_forward_f32": _FWD_ARGS, "gru_forward_bf16": _FWD_ARGS,
    "gru_forward_persistent": [ARG_PTR] * 10 + [ARG_INT] * 6 + [ARG_PTR],
    "gru_forward_info": [ARG_INT] * 3 + [ARG_PTR] * 3})
_ENTRY = {torch.float32: "gru_forward_f32",
          torch.bfloat16: "gru_forward_bf16"}

GRU_BACKWARD = register("gru_backward", {
    "gru_backward": [ARG_PTR] * 8 + [ARG_INT] * 4 + [ARG_PTR],
    "gru_backward_persistent": [ARG_PTR] * 10 + [ARG_INT] * 6 + [ARG_PTR],
    "gru_backward_info": [ARG_INT] * 2 + [ARG_PTR] * 3})

#: the persistent reverse kernel's fixed shapes (csrc/gru_common.cuh,
#: namespace k4): a block holds 32 columns of w_t over the full depth 3H,
#: each product's depth padded to whole 256-deep operand stages, and a ring
#: of two [16 x 256] f32 stages, within the 232,448 bytes a block may take
_PG_CW, _PG_KC, _PG_SMEM = 32, 256, 232448
_PG_STAGE_BYTES = 2 * 16 * _PG_KC * 4
#: rows a direction the persistent kernel takes (16 at a time): a step's
#: d_z rows, the d_zc stream and the carries (~9 MB at H = 512) stay in L2
_PG_ROWS_MAX = 1024

#: the persistent forward kernel's fixed shapes (csrc/gru_common.cuh,
#: namespace k3): a block holds the three gate columns of 16 units over the
#: full depth H in bf16 (96 H bytes of mma B fragments) and the f32 carry
#: and update gate of those units for each of its rows (128 bytes a row)
_PF_NU = 16
#: rows a direction the persistent forward takes (16 at a time), above
#: every batch the port runs (serve and dslgen B <= 64, training 384)
_PF_ROWS_MAX = 1024

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


@float32_products()
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
    path = _gru_fwd_path(cd, B, H, _device_sms(xp.device))
    out = _launch_fwd(xp, mask, w_h, h0, residuals, path)
    GRU_FORWARD.count(path)
    return out


def _launch_fwd(xp, mask, w_h, h0, residuals: bool, path: str):
    """K3 on CUDA operands through the kernel of ``path``; counts nothing
    (the wrapper counts)."""
    B, T, H3 = xp.shape
    H = H3 // 3
    cd = compute_dtype()
    dev = xp.device
    xp_tb = xp.float().transpose(0, 1).contiguous()        # time-major
    m_tb = mask.float().transpose(0, 1).contiguous()
    w = w_h.to(cd).contiguous()
    h = (torch.zeros(B, H, device=dev) if h0 is None
         else h0.float().clone().contiguous())
    h_seq = torch.empty(T, B, H, device=dev)
    rd = residual_dtype(H)
    z = torch.empty(T, B, 3 * H, dtype=rd, device=dev) if residuals else None
    hp = torch.empty(T, B, H, dtype=rd, device=dev) if residuals else None
    res = [z.data_ptr() if residuals else None,
           hp.data_ptr() if residuals else None]
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "persistent":
            plan = _gru_fwd_plan(B, H, _device_sms(dev))
            if cd != torch.bfloat16 or plan is None:
                raise ValueError(f"the persistent forward takes bf16 "
                                 f"compute and a plan, not {cd} at B={B}, "
                                 f"H={H}")
            hb = torch.empty(2, B, H, dtype=torch.bfloat16, device=dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            GRU_FORWARD.call(
                "gru_forward_persistent", xp_tb.data_ptr(), m_tb.data_ptr(),
                w.data_ptr(), h_seq.data_ptr(), h.data_ptr(),
                hb[0].data_ptr(), hb[1].data_ptr(), *res, bar.data_ptr(),
                int(rd == torch.bfloat16), T, B, H, plan["ug"], plan["rg"],
                stream)
        else:
            rh_u = torch.empty(2, B, H, device=dev)
            GRU_FORWARD.call(
                _ENTRY[cd], xp_tb.data_ptr(), m_tb.data_ptr(), w.data_ptr(),
                h_seq.data_ptr(), h.data_ptr(), rh_u[0].data_ptr(),
                rh_u[1].data_ptr(), *res, int(rd == torch.bfloat16), T, B, H,
                stream)
    if not residuals:
        return h_seq.transpose(0, 1), h
    return h_seq.transpose(0, 1), h, z, hp


def _gru_fwd_plan(B: int, H: int, sm_count: int, ndir: int = 1
                  ) -> Optional[Dict[str, int]]:
    """The persistent forward kernel's split over one block per SM, or None
    where it does not fit: ``ndir`` directions (1 for K3, 2 for K11's
    forward) x ``ug = H / 16`` unit groups x ``rg`` row groups, as many as
    the SMs allow.  A block holds the three gate columns of its direction's
    units ``16 ug ..`` over the full depth H and computes them complete for
    the 16-row tiles ``rg, rg + rgs, ...`` of its direction.  ``smem`` is
    what a block takes at the row limit.  None when B (rows a direction)
    is outside 1..1024, H % 32 != 0, the block's share does not fit
    232,448 bytes or there are fewer SMs than unit groups.  Depends on B
    only through that limit; and no order of a row's sums depends on the
    plan at all, only on H."""
    if not 1 <= B <= _PF_ROWS_MAX:
        return None
    return _gru_fwd_plan_for(H, sm_count, ndir)


def _gru_fwd_smem(H: int, rows: int, rg: int) -> int:
    """Shared bytes a block of the persistent forward takes: W's fragments
    and the carry and gate of the most rows a row group holds."""
    return 96 * H + 128 * _gru_fwd_rows_a_block(rows, rg)


def _gru_fwd_rows_a_block(rows: int, rg: int) -> int:
    """Rows of carry a block holds: 16 x the tiles of row group 0."""
    ntile = -(-rows // 16)
    return -(-ntile // rg) * 16


@functools.lru_cache(maxsize=None)
def _gru_fwd_plan_for(H: int, sm_count: int, ndir: int
                      ) -> Optional[Dict[str, int]]:
    if H < 1 or H % 32 or sm_count < 1 or ndir not in (1, 2):
        return None
    ug = H // _PF_NU
    rg = sm_count // (ndir * ug)
    if rg < 1:
        return None
    smem = _gru_fwd_smem(H, _PF_ROWS_MAX, rg)
    if smem > _PG_SMEM:
        return None
    return {"nu": _PF_NU, "ug": ug, "rg": rg, "blocks": ndir * ug * rg,
            "smem": smem}


def _gru_fwd_slices(plan: Dict[str, int], H: int, rows: int, ndir: int = 1
                    ) -> List[Tuple[int, List[int], List[int]]]:
    """Each block's (direction, columns of ``W`` it holds, batch rows of
    its direction) as the kernel cuts them: block i serves direction ``i //
    (ug * rg)``, unit group ``i % (ug * rg) % ug`` (columns ``j``, ``H +
    j`` and ``2H + j`` of each of its 16 units ``j``) and row group ``i %
    (ug * rg) // ug``, which takes the 16-row tiles ``rg, rg + rgs, ...``
    of its direction's ``rows`` rows."""
    ug, rgs, nu = plan["ug"], plan["rg"], plan["nu"]
    ntile = -(-rows // 16)
    out = []
    for i in range(plan["blocks"]):
        d, u, g = i // (ug * rgs), i % (ug * rgs) % ug, i % (ug * rgs) // ug
        units = range(u * nu, (u + 1) * nu)
        cols = [gate * H + j for gate in range(3) for j in units]
        mine = [b for t in range(g, ntile, rgs)
                for b in range(16 * t, min(rows, 16 * t + 16))]
        out.append((d, cols, mine))
    return out


def _gru_fwd_path(dtype: torch.dtype, B: int, H: int, sm_count: int,
                  ndir: int = 1) -> str:
    """The forward kernel on the card: ``"persistent"`` under the bf16
    compute policy where ``_gru_fwd_plan`` finds a split, else
    ``"steps"`` (always under f32)."""
    return ("persistent" if dtype == torch.bfloat16
            and _gru_fwd_plan(B, H, sm_count, ndir) else "steps")


def gru_fwd_kernel_info(B: int, H: int, sm_count: int, ndir: int = 1
                        ) -> Dict[str, Tuple[int, int, int]]:
    """(registers a thread, spilled bytes a thread, shared bytes a block) of
    the forward kernels under bf16, the persistent one at ``B`` rows a
    direction, width H and its plan on ``sm_count`` SMs, from
    ``cudaFuncGetAttributes``."""
    plan = _gru_fwd_plan(B, H, sm_count, ndir)
    rows = _gru_fwd_rows_a_block(B, plan["rg"]) if plan else 0
    return _kernel_info(GRU_FORWARD, "gru_forward_info",
                        ("persistent", "steps_gates", "steps_cand"), H, rows)


def _kernel_info(lib, fn: str, names, *args
                 ) -> Dict[str, Tuple[int, int, int]]:
    out = {}
    for which, name in enumerate(names):
        vals = [ctypes.c_int() for _ in range(3)]
        err = getattr(lib.lib(), fn)(which, *args,
                                     *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"{fn}({which}): CUDA error {err}")
        out[name] = tuple(v.value for v in vals)
    return out


def _kpad(k: int) -> int:
    return -(-k // _PG_KC) * _PG_KC


def _gru_bwd_plan(B: int, H: int, sm_count: int, ndir: int = 1
                  ) -> Optional[Dict[str, int]]:
    """The persistent reverse kernel's split over one block per SM, or None
    where it does not fit: ``ndir`` directions (1 for K4, 2 for K11's
    reverse) x ``cg = ceil(H / 32)`` column groups x ``rg`` row groups, as
    many as the SMs allow.  A block holds its direction's ``w_t`` columns
    ``32 cg ..`` over the full depth 3H (zero-padded to whole 256-deep
    stages) and computes those columns complete for the 16-row tiles ``rg,
    rg + rgs, ...`` of its direction.  None when B (rows a direction) is
    outside 1..1024, H % 4 != 0, the slice does not fit 232,448 bytes (H
    above 512) or there are fewer SMs than column groups.  Depends on B
    only through that limit; and no order of a row's sums depends on the
    plan at all, only on H."""
    if not 1 <= B <= _PG_ROWS_MAX:
        return None
    return _gru_plan_for(H, sm_count, ndir)


@functools.lru_cache(maxsize=None)
def _gru_plan_for(H: int, sm_count: int, ndir: int
                  ) -> Optional[Dict[str, int]]:
    if H < 1 or H % 4 or sm_count < 1 or ndir not in (1, 2):
        return None
    cg = -(-H // _PG_CW)
    rg = sm_count // (ndir * cg)
    smem = (_kpad(H) + _kpad(2 * H)) * _PG_CW * 4 + _PG_STAGE_BYTES
    if rg < 1 or smem > _PG_SMEM:
        return None
    return {"cw": _PG_CW, "cg": cg, "rg": rg, "blocks": ndir * cg * rg,
            "smem": smem}


def _gru_bwd_slices(plan: Dict[str, int], H: int, rows: int, ndir: int = 1
                    ) -> List[Tuple[int, range, range, List[int]]]:
    """Each block's (direction, rows of ``w_t``, columns, batch rows of its
    direction) as the kernel cuts them: block i serves direction ``i //
    (cg * rg)``, column group ``i % (cg * rg) % cg`` and row group ``i %
    (cg * rg) // cg``, which takes the 16-row tiles ``rg, rg + rgs, ...``
    of its direction's ``rows`` rows."""
    cg, rgs = plan["cg"], plan["rg"]
    ntile = -(-rows // 16)
    out = []
    for i in range(plan["blocks"]):
        d, c, g = i // (cg * rgs), i % (cg * rgs) % cg, i % (cg * rgs) // cg
        mine = [b for t in range(g, ntile, rgs)
                for b in range(16 * t, min(rows, 16 * t + 16))]
        out.append((d, range(3 * H),
                    range(c * _PG_CW, min(H, (c + 1) * _PG_CW)), mine))
    return out


def _gru_bwd_path(B: int, H: int, sm_count: int, ndir: int = 1) -> str:
    """The reverse kernel on the card: ``"persistent"`` where
    ``_gru_bwd_plan`` finds a split, else ``"steps"``."""
    return ("persistent" if _gru_bwd_plan(B, H, sm_count, ndir)
            else "steps")


def gru_bwd_kernel_info(H: int) -> Dict[str, Tuple[int, int, int]]:
    """(registers a thread, spilled bytes a thread, shared bytes a block) of
    the reverse kernels, the persistent one at width H, from
    ``cudaFuncGetAttributes``."""
    return _kernel_info(GRU_BACKWARD, "gru_backward_info",
                        ("persistent", "steps_cand", "steps_gate"), H)


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


@float32_products()
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
    path = _gru_bwd_path(B, H, _device_sms(z_tb.device))
    out = _launch_bwd(d_out_tb, m_tb, z_tb, hp_tb, w_t, d_hfin, path)
    GRU_BACKWARD.count(path)
    return out


def _launch_bwd(d_out_tb, m_tb, z_tb, hp_tb, w_t, d_hfin, path: str):
    """K4 on CUDA operands through the kernel of ``path``; counts nothing
    (the wrapper counts)."""
    T, B, H3 = z_tb.shape
    H = H3 // 3
    dev = z_tb.device
    dout = d_out_tb.float().contiguous()
    m = m_tb.float().contiguous()
    z = z_tb.contiguous()
    hp = hp_tb.contiguous()
    wt = w_t.float().contiguous()
    d_c = d_hfin.float().clone().contiguous()
    d_z = torch.empty(T, B, 3 * H, device=dev)
    part = torch.empty(B, H, device=dev)
    args = [dout.data_ptr(), m.data_ptr(), z.data_ptr(), hp.data_ptr(),
            wt.data_ptr(), d_z.data_ptr(), d_c.data_ptr(), part.data_ptr()]
    res_bf16 = int(z.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "persistent":
            plan = _gru_bwd_plan(B, H, _device_sms(dev))
            dzc = torch.empty(B, H, device=dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            GRU_BACKWARD.call(
                "gru_backward_persistent", *args, dzc.data_ptr(),
                bar.data_ptr(), res_bf16, T, B, H, plan["cg"], plan["rg"],
                stream)
        else:
            GRU_BACKWARD.call("gru_backward", *args, res_bf16, T, B, H,
                              stream)
    return d_z, d_c


def _smoke_fwd() -> Dict[str, float]:
    """One small launch of each K3 kernel (the f32 and bf16 step kernels,
    the persistent kernel) on the current card, uncounted, against
    ``gru_forward_plain``: f32 within 1e-5 of the largest value, bf16
    within 5e-3 (the card tests' tolerances)."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    dev = torch.device("cuda", torch.cuda.current_device())
    B, T, H = 5, 6, 64
    g = torch.Generator().manual_seed(3)
    mask = torch.ones(B, T)
    mask[-1, T // 2:] = 0.0
    xp = (0.5 * torch.randn(B, T, 3 * H, generator=g)).to(dev)
    w_h = (torch.randn(H, 3 * H, generator=g) * (2.0 / (4 * H)) ** 0.5
           ).to(dev)
    h0 = (0.5 * torch.randn(B, H, generator=g)).to(dev)
    mask = mask.to(dev)
    errs = {}
    with uncounted(GRU_FORWARD):
        for cd, path, tol in (("float32", "steps", 1e-5),
                              ("bfloat16", "steps", 5e-3),
                              ("bfloat16", "persistent", 5e-3)):
            with compute_dtype_scope(cd):
                got = _launch_fwd(xp, mask, w_h, h0, False, path)
                want = gru_forward_plain(xp, mask, w_h, h0)
            errs[f"{path}_{cd}"] = smoke_error(
                f"gru_forward {path} {cd}", got, want, tol)
    return errs


GRU_FORWARD.smoke = _smoke_fwd


def _smoke_bwd() -> Dict[str, float]:
    """One small launch of each K4 kernel (steps, persistent) on the
    current card, uncounted, from the plain forward's f32 residuals,
    against ``gru_backward_plain`` within 1e-5 of the largest value."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    dev = torch.device("cuda", torch.cuda.current_device())
    B, T, H = 5, 6, 64
    g = torch.Generator().manual_seed(5)
    mask = torch.ones(B, T)
    mask[-1, T // 2:] = 0.0
    xp = (0.5 * torch.randn(B, T, 3 * H, generator=g)).to(dev)
    w_h = (torch.randn(H, 3 * H, generator=g) * (2.0 / (4 * H)) ** 0.5
           ).to(dev)
    d_out, d_hfin = (torch.randn(*s, generator=g).to(dev)
                     for s in ((T, B, H), (B, H)))
    mask = mask.to(dev)
    errs = {}
    with compute_dtype_scope("float32"), uncounted(GRU_BACKWARD):
        _, _, z, hp = gru_forward_plain(xp, mask, w_h, residuals=True)
        bargs = [d_out, mask.t().contiguous(), z, hp, w_h.t().contiguous(),
                 d_hfin]
        want = gru_backward_plain(*bargs)
        for path in ("steps", "persistent"):
            errs[path] = smoke_error(f"gru_backward {path}",
                                     _launch_bwd(*bargs, path), want, 1e-5)
    return errs


GRU_BACKWARD.smoke = _smoke_bwd
