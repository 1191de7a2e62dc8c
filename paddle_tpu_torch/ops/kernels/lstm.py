"""LSTM time loops, forward and backward: the CUDA kernels' wrappers and
their plain versions.

- ``lstm_forward`` replaces ``paddle_tpu/ops/pallas_kernels.py::
  _lstm_pallas_raw`` (K9): ``residuals=False`` is the inference variant,
  ``residuals=True`` adds the backward's residual outputs ``z`` (the
  pre-peephole pre-activations), ``h_prev`` and ``c_prev`` (time-major, in
  ``residual_dtype(H)``), as the reference's training call.  Unlike the
  reference kernel, which boots from zeros, it starts from ``h0``/``c0``.
  On the card ``_lstm_fwd_path`` picks its kernel from (compute dtype, B,
  H, SM count) alone: ``"persistent"``, the whole loop in one cooperative
  launch with bf16 ``w_h`` resident in shared memory split by units across
  the SMs (``_lstm_fwd_plan``) and its products on the tensor cores, under
  the bfloat16 policy where the split fits; else ``"steps"``, one launch
  per step.  ``LSTM_FORWARD.launches_by_path`` splits the count.
- ``lstm_backward`` replaces ``_lstm_bwd_pallas_raw`` (K10), the reverse
  loop, all in float32.  On the card ``_lstm_bwd_path`` picks its kernel
  from (B, H, SM count) alone: ``"persistent"``, the whole loop in one
  cooperative launch with ``w_t`` resident in shared memory split across
  the SMs (``_lstm_bwd_plan``), where the split fits; else ``"steps"``, one
  launch per reverse step.  ``LSTM_BACKWARD.launches_by_path`` splits the
  count.

Gate layout ``[i, f, o, g]``; peepholes pi/pf/po [H] (zeros for the plain
cell): i and f see ``c_prev``, o sees ``c_new``.  Each wrapper dispatches on
the tensors' device: a CPU tensor runs the plain version; a CUDA tensor
launches ``csrc/lstm_forward.cu`` / ``csrc/lstm_backward.cu`` or raises.  No
flag picks the plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools

from typing import Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.kernels.build import device_sms as _device_sms
from paddle_tpu_torch.ops.numerics import compute_dtype, residual_dtype
from paddle_tpu_torch.ops.rnn import lstm_cell, lstm_cell_bwd

__all__ = ["lstm_forward", "lstm_forward_plain", "lstm_backward",
           "lstm_backward_plain", "LSTM_FORWARD", "LSTM_BACKWARD",
           "lstm_fwd_kernel_info", "lstm_bwd_kernel_info"]

_FWD_ARGS = [ARG_PTR] * 13 + [ARG_INT] * 4 + [ARG_PTR]
LSTM_FORWARD = register("lstm_forward", {
    "lstm_forward_f32": _FWD_ARGS, "lstm_forward_bf16": _FWD_ARGS,
    "lstm_forward_persistent": [ARG_PTR] * 14 + [ARG_INT] * 5 + [ARG_PTR],
    "lstm_forward_info": [ARG_INT] * 3 + [ARG_PTR] * 3})
_ENTRY = {torch.float32: "lstm_forward_f32",
          torch.bfloat16: "lstm_forward_bf16"}

#: the persistent K9's fixed shapes (csrc/lstm_forward.cu, namespace k9):
#: rows in blocks of 64 and at most 256 (the f32 carries' room in shared
#: memory); units a block even (whole n8 tiles of four gate columns) and
#: at most 16; at least 4, so that at small H fewer blocks meet at each
#: step's barrier; the product's depth in 64-deep stages, four in the ring
_PF_ROWS, _PF_ROWS_MAX, _PF_KC, _PF_NST = 64, 256, 64, 4
_PF_NU_MIN, _PF_NU_MAX = 4, 16
_PF_SMEM = 232448

LSTM_BACKWARD = register("lstm_backward", {
    "lstm_backward": [ARG_PTR] * 12 + [ARG_INT] * 4 + [ARG_PTR],
    "lstm_backward_persistent": [ARG_PTR] * 14 + [ARG_INT] * 7 + [ARG_PTR],
    "lstm_backward_info": [ARG_INT] * 3 + [ARG_PTR] * 3})

#: the persistent K10's fixed shapes (csrc/lstm_backward.cu, namespace k10):
#: a thread computes 4 rows x 5 or 10 columns, so a column group is at most
#: 80 or 160 units (the shared pitch of its w_t slice); a k-group's depth is
#: a multiple of the 32-deep d_z stage; shared memory holds the slice and a
#: ring of three [64 x 32] f32 d_z stages, within the 232,448 bytes a block
#: may take
_PK_PITCH, _PK_KC, _PK_SMEM = (80, 160), 32, 232448
_PK_STAGE_BYTES = 3 * 64 * _PK_KC * 4
#: rows the persistent kernel takes (64 at a time): the [KG, B, H] f32
#: partials stay in L2 (21 MB at B = 256, H = 1280)
_PK_ROWS_MAX = 256

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
    path = _lstm_fwd_path(compute_dtype(), B, H, _device_sms(xp.device))
    out = _launch_fwd(xp, mask, w_h, pi, pf, po, h0, c0, residuals, path)
    LSTM_FORWARD.count(path)
    return out


def _launch_fwd(xp, mask, w_h, pi, pf, po, h0, c0, residuals: bool,
                path: str):
    """K9 on CUDA operands through the kernel of ``path``; counts nothing
    (the wrapper counts)."""
    B, T, H4 = xp.shape
    H = H4 // 4
    cd = compute_dtype()
    dev = xp.device
    w = w_h.to(cd).contiguous()
    p = [v.float().contiguous() for v in (pi, pf, po)]

    def carry(v):
        return (torch.zeros(B, H, device=dev) if v is None
                else v.float().clone().contiguous())

    h, c = carry(h0), carry(c0)
    h_seq = torch.empty(T, B, H, device=dev)
    rd = residual_dtype(H)
    res = ([torch.empty(T, B, n, dtype=rd, device=dev)
            for n in (4 * H, H, H)] if residuals else [None] * 3)
    res_ptrs = [None if r is None else r.data_ptr() for r in res]
    res_bf16 = int(rd == torch.bfloat16)
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "persistent":
            plan = _lstm_fwd_plan(B, H, _device_sms(dev))
            x = xp.float().contiguous()           # read batch-major
            m = mask.float().contiguous()
            hb = torch.empty(2, B, H, dtype=torch.bfloat16, device=dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            LSTM_FORWARD.call(
                "lstm_forward_persistent", x.data_ptr(), m.data_ptr(),
                w.data_ptr(), *(v.data_ptr() for v in p), h_seq.data_ptr(),
                h.data_ptr(), c.data_ptr(), hb.data_ptr(), *res_ptrs,
                bar.data_ptr(), res_bf16, T, B, H, plan["nu"], stream)
        else:
            xp_tb = xp.float().transpose(0, 1).contiguous()  # time-major
            m_tb = mask.float().transpose(0, 1).contiguous()
            h_tmp = torch.empty(B, H, device=dev)
            LSTM_FORWARD.call(
                _ENTRY[cd], xp_tb.data_ptr(), m_tb.data_ptr(), w.data_ptr(),
                *(v.data_ptr() for v in p), h_seq.data_ptr(), h.data_ptr(),
                h_tmp.data_ptr(), c.data_ptr(), *res_ptrs, res_bf16, T, B,
                H, stream)
    if not residuals:
        return h_seq.transpose(0, 1), h, c
    return (h_seq.transpose(0, 1), h, c, *res)


def _fwd_smem(H: int, nu: int) -> int:
    """Shared bytes of a persistent K9 block (``k9::smem_bytes``): the w_h
    slice (bf16, depth padded to whole stages), the h ring, the two
    k-groups' partial z, the f32 h and c carries and the peepholes."""
    kp = -(-H // _PF_KC) * _PF_KC
    return (kp * 4 * nu * 2 + _PF_NST * _PF_ROWS * _PF_KC * 2
            + 2 * _PF_ROWS * 4 * nu * 4 + 2 * _PF_ROWS_MAX * nu * 4
            + 3 * nu * 4)


def _lstm_fwd_plan(B: int, H: int, sm_count: int
                   ) -> Optional[Dict[str, int]]:
    """The persistent K9's split of ``w_h`` [H, 4H] over the SMs, or None
    where it does not fit.  Block i owns units ``i * nu`` .. ``+ nu - 1``
    and their four gate columns over the full depth: ``nu``, the smallest
    even count >= 4 that needs no more blocks than SMs (10 at H = 1280 on
    132 SMs, 128 blocks; 4 at H = 256, 64 blocks).  None when B is outside
    1..256, H is not a multiple of 8 (16-byte rows of the bf16 h stream),
    or the slice with its ring, partials and carries passes 232,448 bytes
    (``nu`` > 16 too): on 132 SMs up to H = 1536.  Depends on B only
    through that limit, so a row's sums run in the same order at any B."""
    if not 1 <= B <= _PF_ROWS_MAX:
        return None
    return _fwd_plan_for(H, sm_count)


@functools.lru_cache(maxsize=None)
def _fwd_plan_for(H: int, sm_count: int) -> Optional[Dict[str, int]]:
    if H < 1 or H % 8 or sm_count < 1:
        return None
    nu = max(_PF_NU_MIN, -(-H // sm_count))
    nu += nu % 2
    smem = _fwd_smem(H, nu)
    if nu > _PF_NU_MAX or smem > _PF_SMEM:
        return None
    return {"nu": nu, "blocks": -(-H // nu), "smem": smem}


def _lstm_fwd_units(plan: Dict[str, int], H: int) -> List[range]:
    """Each block's units as the kernel cuts them: block i owns ``nu``
    units from ``i * nu`` (the last block fewer)."""
    nu = plan["nu"]
    return [range(i * nu, min(H, (i + 1) * nu))
            for i in range(plan["blocks"])]


def _lstm_fwd_path(dtype: torch.dtype, B: int, H: int, sm_count: int) -> str:
    """K9's kernel on the card: ``"persistent"`` under the bfloat16 policy
    where ``_lstm_fwd_plan`` finds a split, else ``"steps"`` (f32 ``w_h``
    at H = 1280 is 26 MB, and the port's policy keeps TF32 off)."""
    return ("persistent" if dtype == torch.bfloat16
            and _lstm_fwd_plan(B, H, sm_count) else "steps")


def lstm_fwd_kernel_info(H: int, sm_count: int
                         ) -> Dict[str, Tuple[int, int, int]]:
    """(registers a thread, spilled bytes a thread, shared bytes a block) of
    K9's two kernels, the persistent one with its plan at width H, from
    ``cudaFuncGetAttributes``."""
    plan = _lstm_fwd_plan(1, H, sm_count)
    out = {}
    for which, name in enumerate(("persistent", "steps")):
        vals = [ctypes.c_int() for _ in range(3)]
        err = LSTM_FORWARD.lib().lstm_forward_info(
            which, H, plan["nu"] if plan else 2,
            *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"lstm_forward_info({which}): CUDA error "
                               f"{err}")
        out[name] = tuple(v.value for v in vals)
    return out


def _lstm_bwd_plan(B: int, H: int, sm_count: int) -> Optional[Dict[str, int]]:
    """The persistent K10's split of ``w_t`` [4H, H] over one block per SM,
    or None where it does not fit.  ``cg = ceil(H / cw)`` column groups of
    ``cw <= 160`` units and ``kg = ceil(4H / kw)`` k-groups of ``kw`` rows,
    a multiple of 32, as many as the SMs allow.  Of the splits whose slice
    (``kw`` x its pitch, 80 or 160 columns) and d_z stages fit 232,448
    bytes, the one whose block computes the fewest products a step
    (``kw`` x pitch, the critical path), then the widest columns (each
    column group reads all of d_z[s] once a step).  None when B is outside
    1..256 or no split fits: on 132 SMs the split fits up to H = 1280 (16 x
    8 blocks of 320 x 160), not at H = 1300.  Depends on B only through
    that limit, so a row's sums run in the same order at any B."""
    if not 1 <= B <= _PK_ROWS_MAX:
        return None
    return _plan_for(H, sm_count)


@functools.lru_cache(maxsize=None)
def _plan_for(H: int, sm_count: int) -> Optional[Dict[str, int]]:
    if H < 1 or sm_count < 1:
        return None
    K = 4 * H
    best = None
    for cg in range(-(-H // _PK_PITCH[1]), min(H, sm_count) + 1):
        cw = -(-H // cg)
        if -(-H // cw) != cg:              # the same width as a smaller cg
            continue
        kg = min(sm_count // cg, -(-K // _PK_KC))
        kw = -(-K // kg)
        kw = -(-kw // _PK_KC) * _PK_KC         # whole d_z stages
        kg = -(-K // kw)
        pitch = _PK_PITCH[0] if cw <= _PK_PITCH[0] else _PK_PITCH[1]
        smem = kw * pitch * 4 + _PK_STAGE_BYTES
        if smem <= _PK_SMEM and (best is None or kw * pitch < best["cost"]):
            best = {"kg": kg, "kw": kw, "cg": cg, "cw": cw,
                    "blocks": kg * cg, "smem": smem, "cost": kw * pitch}
    if best is not None:
        del best["cost"]
    return best


def _lstm_bwd_slices(plan: Dict[str, int], H: int
                     ) -> List[Tuple[range, range]]:
    """Each block's (rows of ``w_t``, columns) as the kernel cuts them:
    block i owns k-group ``i % kg`` and column group ``i // kg``."""
    K = 4 * H
    out = []
    for i in range(plan["blocks"]):
        g, c = i % plan["kg"], i // plan["kg"]
        out.append((range(g * plan["kw"], min(K, (g + 1) * plan["kw"])),
                    range(c * plan["cw"], min(H, (c + 1) * plan["cw"]))))
    return out


def _lstm_bwd_path(B: int, H: int, sm_count: int) -> str:
    """K10's kernel on the card: ``"persistent"`` where ``_lstm_bwd_plan``
    finds a split, else ``"steps"``."""
    return "persistent" if _lstm_bwd_plan(B, H, sm_count) else "steps"


def lstm_bwd_kernel_info(H: int, sm_count: int
                         ) -> Dict[str, Tuple[int, int, int]]:
    """(registers a thread, spilled bytes a thread, shared bytes a block) of
    K10's two kernels, the persistent one with its slice at width H, from
    ``cudaFuncGetAttributes``."""
    plan = _lstm_bwd_plan(1, H, sm_count)
    out = {}
    for which, name in enumerate(("persistent", "steps")):
        vals = [ctypes.c_int() for _ in range(3)]
        err = LSTM_BACKWARD.lib().lstm_backward_info(
            which, plan["kw"] if plan else 0, plan["cw"] if plan else 0,
            *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"lstm_backward_info({which}): CUDA error "
                               f"{err}")
        out[name] = tuple(v.value for v in vals)
    return out


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
    path = _lstm_bwd_path(B, H, _device_sms(dev))
    out = _launch_bwd(d_out_tb, m_tb, z_tb, cp_tb, w_t, pi, pf, po, d_hfin,
                      d_cfin, want_cn, path)
    LSTM_BACKWARD.count(path)
    return out


def _launch_bwd(d_out_tb, m_tb, z_tb, cp_tb, w_t, pi, pf, po, d_hfin, d_cfin,
                want_cn: bool, path: str):
    """K10 on CUDA operands through the kernel of ``path``; counts nothing
    (the wrapper counts)."""
    T, B, H4 = z_tb.shape
    H = H4 // 4
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
    args = [dout.data_ptr(), m.data_ptr(), z.data_ptr(), cp.data_ptr(),
            wt.data_ptr(), *(v.data_ptr() for v in p), d_z.data_ptr(),
            None if cn is None else cn.data_ptr(), d_h.data_ptr(),
            d_c.data_ptr()]
    res_bf16 = int(z.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "persistent":
            plan = _lstm_bwd_plan(B, H, _device_sms(dev))
            part = torch.empty(plan["kg"], B, H, device=dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            LSTM_BACKWARD.call(
                "lstm_backward_persistent", *args, part.data_ptr(),
                bar.data_ptr(), res_bf16, T, B, H, plan["kg"], plan["kw"],
                plan["cw"], stream)
        else:
            LSTM_BACKWARD.call("lstm_backward", *args, res_bf16, T, B, H,
                               stream)
    return d_z, cn, d_h, d_c
