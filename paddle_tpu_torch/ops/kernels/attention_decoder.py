"""Attention GRU decoder time loops, forward and backward: the CUDA kernels'
wrappers and their plain versions.

- ``attn_dec_fwd`` replaces ``paddle_tpu/ops/pallas_kernels.py::
  attn_dec_fwd_pallas`` (K5): the Bahdanau attention and the GRU step over
  the teacher-forced target, emitting the states and the backward's
  residuals ``probs``, ``ctx`` and ``s_prev``.  On the card
  ``_attn_dec_fwd_path`` picks its kernel from (compute dtype, B, S, D, A,
  2H, SM count) alone: ``"persistent"``, the whole loop in one cooperative
  launch with the bf16 weights resident in shared memory split by units
  across the SMs (``_attn_dec_fwd_plan``) and the products on the tensor
  cores, under the bfloat16 policy where the split fits; else ``"steps"``,
  four launches per step.  ``ATTN_DEC_FWD.launches_by_path`` splits the
  count.
- ``attn_dec_bwd`` replaces ``attn_dec_bwd_pallas`` (K6), its reverse loop:
  the per-step cotangents ``d_xp`` and ``sum_dpre``, ``d_enc_proj`` and
  ``d_v`` (on the card summed by one pass after the loop from the steps'
  ``d_score``, over t from T-1 down to 0 as the loop would) and ``d_s0``;
  every weight gradient is a batched product outside
  (``ops/attention_decoder.py``).

Both keep the reference kernels' time-major interfaces.  The plain versions
are the scan path's step loops (the reference's ``_fwd_step`` and
``_agd_bwd.rev_step``), fed the same arguments.  Each wrapper dispatches on
the tensors' device: a CPU tensor runs the plain version; a CUDA tensor
launches ``csrc/attn_dec_fwd.cu`` / ``csrc/attn_dec_bwd.cu`` or raises.  No
flag picks the plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.ops.attention import (additive_attention_scores, attend,
                                            score_product)
from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.kernels.build import device_sms as _device_sms
from paddle_tpu_torch.ops.matmul import linear
from paddle_tpu_torch.ops.numerics import (bwd_einsum, bwd_mm, compute_dtype,
                                           float32_products, mxu_cast)
from paddle_tpu_torch.ops.rnn import gru_cell_bwd, gru_step

__all__ = ["attn_dec_fwd", "attn_dec_fwd_plain", "attn_dec_bwd",
           "attn_dec_bwd_plain", "denc_dv_after_loop", "ATTN_DEC_FWD",
           "ATTN_DEC_BWD", "attn_dec_fwd_kernel_info"]

_FWD_ARGS = [ARG_PTR] * 15 + [ARG_INT] * 6 + [ARG_PTR]
ATTN_DEC_FWD = register("attn_dec_fwd", {
    "attn_dec_fwd_f32": _FWD_ARGS, "attn_dec_fwd_bf16": _FWD_ARGS,
    "attn_dec_fwd_persistent": [ARG_PTR] * 18 + [ARG_INT] * 8 + [ARG_PTR],
    "attn_dec_fwd_info": [ARG_INT] * 5 + [ARG_PTR] * 3})
_BWD_ARGS = [ARG_PTR] * 21 + [ARG_INT] * 6 + [ARG_PTR]
ATTN_DEC_BWD = register("attn_dec_bwd", {"attn_dec_bwd_f32": _BWD_ARGS,
                                         "attn_dec_bwd_bf16": _BWD_ARGS})
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: most source positions the kernels take (their attention block keeps two
#: float32 values a position in shared memory)
MAX_S = 4096

Dims = Tuple[int, int, int, int, int, int]

#: the persistent K5's fixed shapes (csrc/attn_dec_fwd.cu, namespace k5):
#: a block's units NU and query columns QC are whole n8 tiles, at most two
#: (8 or 16); its warps each own one 16-row tile, so a row group takes at
#: most 8 tiles (128 rows); the products' depths D and 2H are whole 32-deep
#: operand loads; shared memory holds the block's bf16 weight columns, and
#: the f32 scores and rounded queries of the 4 batch rows its attention
#: takes at once, and att_v
_PA_UNITS, _PA_ROWS, _PA_SMEM, _PA_ATT_ROWS = (16, 8), 128, 232448, 4


def _attn_dec_fwd_smem(S: int, D: int, A: int, H2: int, nu: int,
                       qc: int) -> int:
    return ((D * (qc + 2 * nu) + H2 * 3 * nu + D * nu) * 2
            + (_PA_ATT_ROWS * S + (_PA_ATT_ROWS + 1) * A) * 4)


def _attn_dec_fwd_plan(B: int, S: int, D: int, A: int, H2: int,
                       sm_count: int) -> Optional[Dict[str, int]]:
    """The persistent K5's split over one block per SM, or None where it
    does not fit: ``cg`` column groups (``nu = D / cg`` units with all
    their gate columns, ``qc = A / cg`` query columns, each 16 where the
    widths allow, else 8) x ``rg = sm_count // cg`` row groups.  The
    fewest column groups whose weights fit 232,448 bytes, since every
    column group reads each product's operand rows once a step.  None when
    B is outside 1..128 rg, D or 2H is not a multiple of 32, S exceeds
    MAX_S or no split fits.  Depends on B only through that limit; no
    order of a row's sums depends on the plan, only on the widths."""
    plan = _attn_plan_for(S, D, A, H2, sm_count)
    if plan is None or not 1 <= B <= _PA_ROWS * plan["rg"]:
        return None
    return plan


@functools.lru_cache(maxsize=None)
def _attn_plan_for(S: int, D: int, A: int, H2: int, sm_count: int
                   ) -> Optional[Dict[str, int]]:
    if (min(S, D, A, H2, sm_count) < 1 or S > MAX_S or D % 32
            or H2 % 32):
        return None
    for nu in _PA_UNITS:
        if D % nu:
            continue
        cg = D // nu
        qc = A // cg if A % cg == 0 else 0
        smem = _attn_dec_fwd_smem(S, D, A, H2, nu, qc)
        if qc not in _PA_UNITS or smem > _PA_SMEM or cg > sm_count:
            continue
        rg = sm_count // cg
        return {"cg": cg, "rg": rg, "nu": nu, "qc": qc, "blocks": cg * rg,
                "smem": smem}
    return None


def _attn_dec_fwd_slices(plan: Dict[str, int], B: int, D: int
                         ) -> List[Tuple[List[int], List[int], List[int]]]:
    """Each block's (columns of each gate block of ``wh`` and ``wx_c``, i.e.
    its units; columns of ``att_w``; batch rows of its products) as the
    kernel cuts them: block i serves column group ``i % cg`` and row group
    ``i // cg``, whose warp w takes the 16-row tile ``rg * tpg + w``."""
    ntile = -(-B // 16)
    tpg = -(-ntile // plan["rg"])
    out = []
    for i in range(plan["blocks"]):
        c, g = i % plan["cg"], i // plan["cg"]
        rows = [b for t in range(g * tpg, min(ntile, (g + 1) * tpg))
                for b in range(16 * t, min(B, 16 * t + 16))]
        out.append((list(range(c * plan["nu"], (c + 1) * plan["nu"])),
                    list(range(c * plan["qc"], (c + 1) * plan["qc"])),
                    rows))
    return out


def _attn_dec_fwd_path(dtype: torch.dtype, B: int, S: int, D: int, A: int,
                       H2: int, sm_count: int) -> str:
    """K5's kernel on the card: ``"persistent"`` under the bfloat16 policy
    where ``_attn_dec_fwd_plan`` finds a split, else ``"steps"``."""
    if dtype == torch.bfloat16 and _attn_dec_fwd_plan(B, S, D, A, H2,
                                                      sm_count):
        return "persistent"
    return "steps"


def attn_dec_fwd_kernel_info(S: int, D: int, A: int, H2: int
                             ) -> Dict[str, Tuple[int, int, int]]:
    """(registers a thread, spilled bytes a thread, shared bytes a block) of
    the persistent K5 (16 units and query columns a block, at these widths)
    and of the steps path's attention and candidate kernels (bf16), from
    ``cudaFuncGetAttributes``."""
    out = {}
    for which, name in enumerate(("persistent", "steps_attention",
                                  "steps_cand")):
        vals = [ctypes.c_int() for _ in range(3)]
        err = ATTN_DEC_FWD.lib().attn_dec_fwd_info(
            which, S, D, A, H2, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"attn_dec_fwd_info({which}): CUDA error "
                               f"{err}")
        out[name] = tuple(v.value for v in vals)
    return out


def _check_shapes(want, where: str) -> None:
    """Each named tensor has its shape, and all lie on one device."""
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{where}: {name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    devs = {t.device for t, _ in want.values()}
    if len(devs) != 1:
        raise ValueError(f"{where} inputs span devices {devs}")


def _check_dtypes(want, dtype: torch.dtype, what: str, where: str) -> None:
    for name, t in want.items():
        if t.dtype != dtype:
            raise ValueError(f"{where}: {name} must be {what} ({dtype}), got "
                             f"{t.dtype}")


def _check_fwd(xp_y_tb, m_tb, s0, enc, enc_proj, src_mask, att_w, att_v,
               wx_c, wh) -> Dims:
    where = "attn_dec_fwd"
    if xp_y_tb.dim() != 3 or xp_y_tb.shape[-1] % 3:
        raise ValueError(f"{where}: xp_y must be [T, B, 3D], got "
                         f"{list(xp_y_tb.shape)}")
    if enc.dim() != 3 or enc_proj.dim() != 3:
        raise ValueError(f"{where}: enc and enc_proj must be [B, S, *], got "
                         f"{list(enc.shape)} and {list(enc_proj.shape)}")
    T, B, D3 = xp_y_tb.shape
    D = D3 // 3
    S, H2, A = enc.shape[1], enc.shape[2], enc_proj.shape[2]
    _check_shapes({"mask": (m_tb, (T, B)), "s0": (s0, (B, D)),
                   "enc": (enc, (B, S, H2)), "enc_proj": (enc_proj, (B, S, A)),
                   "src_mask": (src_mask, (B, S)), "att_w": (att_w, (D, A)),
                   "att_v": (att_v, (A,)), "wx_c": (wx_c, (H2, D3)),
                   "wh": (wh, (D, D3)), "xp_y": (xp_y_tb, (T, B, D3))}, where)
    _check_dtypes({"xp_y": xp_y_tb, "mask": m_tb, "s0": s0,
                   "src_mask": src_mask}, torch.float32, "float32", where)
    _check_dtypes({"enc": enc, "enc_proj": enc_proj, "att_w": att_w,
                   "att_v": att_v, "wx_c": wx_c, "wh": wh}, compute_dtype(),
                  "cast to the compute dtype", where)
    return T, B, S, D, A, H2


def _check_bwd(d_out_tb, m_tb, s_prev, r, u, cand, q, enc, enc_proj,
               src_mask, att_w, att_v, wh, wx_c) -> Dims:
    where = "attn_dec_bwd"
    if d_out_tb.dim() != 3 or enc.dim() != 3 or enc_proj.dim() != 3:
        raise ValueError(f"{where}: d_out must be [T, B, D] and enc, "
                         f"enc_proj [B, S, *]; got {list(d_out_tb.shape)}, "
                         f"{list(enc.shape)}, {list(enc_proj.shape)}")
    T, B, D = d_out_tb.shape
    S, H2, A = enc.shape[1], enc.shape[2], enc_proj.shape[2]
    _check_shapes({"d_out": (d_out_tb, (T, B, D)), "mask": (m_tb, (T, B)),
                   "s_prev": (s_prev, (T, B, D)), "r": (r, (T, B, D)),
                   "u": (u, (T, B, D)), "cand": (cand, (T, B, D)),
                   "q": (q, (T, B, A)), "enc": (enc, (B, S, H2)),
                   "enc_proj": (enc_proj, (B, S, A)),
                   "src_mask": (src_mask, (B, S)), "att_w": (att_w, (D, A)),
                   "att_v": (att_v, (A,)), "wh": (wh, (D, 3 * D)),
                   "wx_c": (wx_c, (H2, 3 * D))}, where)
    _check_dtypes({"d_out": d_out_tb, "mask": m_tb, "s_prev": s_prev, "r": r,
                   "u": u, "cand": cand, "q": q, "src_mask": src_mask,
                   "att_w": att_w, "wh": wh, "wx_c": wx_c}, torch.float32,
                  "float32", where)
    _check_dtypes({"enc": enc, "enc_proj": enc_proj}, compute_dtype(),
                  "cast to the compute dtype", where)
    if not att_v.is_floating_point():
        raise ValueError(f"{where}: att_v must be floating, got "
                         f"{att_v.dtype}")
    return T, B, S, D, A, H2


def _device_of(t: torch.Tensor, where: str, S: int) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{where} runs on cpu or cuda, not {t.device}")
    if S > MAX_S:
        raise ValueError(f"{where}: the kernel takes at most MAX_S = {MAX_S} "
                         f"source positions, got S = {S}")
    return t.device


@float32_products()
def attn_dec_fwd_plain(xp_y_tb, m_tb, s0, enc, enc_proj, src_mask, att_w,
                       att_v, wx_c, wh):
    """The kernel's function as a step loop of PyTorch ops.  Same arguments
    and results as ``attn_dec_fwd``."""
    T, B, S, D, A, H2 = _check_fwd(xp_y_tb, m_tb, s0, enc, enc_proj,
                                   src_mask, att_w, att_v, wx_c, wh)
    dev = xp_y_tb.device
    cd = compute_dtype()
    states = torch.zeros(T, B, D, device=dev)
    probs = torch.zeros(T, B, S, device=dev)
    ctxs = torch.zeros(T, B, H2, dtype=cd, device=dev)
    s_prev = torch.zeros(T, B, D, device=dev)
    s = s0
    for t in range(T):
        m_t = m_tb[t, :, None]
        scores = additive_attention_scores(enc_proj, s, att_w, att_v)
        ctx, w = attend(scores, enc, src_mask)
        s_new = gru_step(xp_y_tb[t] + linear(ctx, wx_c), s, wh)
        s_out = torch.where(m_t > 0, s_new, s)
        states[t] = s_out * m_t
        probs[t] = w
        ctxs[t] = ctx.to(cd)
        s_prev[t] = s
        s = s_out
    return states, probs, ctxs, s_prev


def attn_dec_fwd(xp_y_tb: torch.Tensor, m_tb: torch.Tensor, s0: torch.Tensor,
                 enc: torch.Tensor, enc_proj: torch.Tensor,
                 src_mask: torch.Tensor, att_w: torch.Tensor,
                 att_v: torch.Tensor, wx_c: torch.Tensor, wh: torch.Tensor):
    """Attention GRU decoder over a teacher-forced target, time-major.

    xp_y [T, B, 3D] (the target half of the input projection, bias
    included), mask [T, B], s0 [B, D], src_mask [B, S], all float32; enc
    [B, S, 2H], enc_proj [B, S, A], att_w [D, A], att_v [A], wx_c [2H, 3D],
    wh [D, 3D] cast to the compute dtype -> (states [T, B, D] f32, zeroed at
    padded steps where the carry holds; probs [T, B, S] f32; ctx [T, B, 2H]
    in the compute dtype; s_prev [T, B, D] f32, the carry entering each
    step)."""
    T, B, S, D, A, H2 = _check_fwd(xp_y_tb, m_tb, s0, enc, enc_proj,
                                   src_mask, att_w, att_v, wx_c, wh)
    if xp_y_tb.device.type == "cpu":
        return attn_dec_fwd_plain(xp_y_tb, m_tb, s0, enc, enc_proj, src_mask,
                                  att_w, att_v, wx_c, wh)
    dev = _device_of(xp_y_tb, "attn_dec_fwd", S)
    path = _attn_dec_fwd_path(compute_dtype(), B, S, D, A, H2,
                              _device_sms(dev))
    out = _launch_fwd(xp_y_tb, m_tb, s0, enc, enc_proj, src_mask, att_w,
                      att_v, wx_c, wh, path)
    ATTN_DEC_FWD.count(path)
    return out


def _launch_fwd(xp_y_tb, m_tb, s0, enc, enc_proj, src_mask, att_w, att_v,
                wx_c, wh, path: str):
    """K5 on CUDA operands through the kernel of ``path``; counts nothing
    (the wrapper counts)."""
    T, B, S, D, A, H2 = _check_fwd(xp_y_tb, m_tb, s0, enc, enc_proj,
                                   src_mask, att_w, att_v, wx_c, wh)
    dev = xp_y_tb.device
    cd = compute_dtype()
    ins = [t.contiguous() for t in (xp_y_tb, m_tb, s0, enc, enc_proj,
                                    src_mask, att_w, att_v, wx_c, wh)]
    states = torch.empty(T, B, D, device=dev)
    probs = torch.empty(T, B, S, device=dev)
    ctx = torch.empty(T, B, H2, dtype=cd, device=dev)
    s_prev = torch.empty(T, B, D, device=dev)
    outs = [states.data_ptr(), probs.data_ptr(), ctx.data_ptr(),
            s_prev.data_ptr()]
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "persistent":
            plan = _attn_dec_fwd_plan(B, S, D, A, H2, _device_sms(dev))
            q = torch.empty(B, A, device=dev)
            sb = torch.empty(2, B, D, dtype=torch.bfloat16, device=dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            ATTN_DEC_FWD.call(
                "attn_dec_fwd_persistent", *(t.data_ptr() for t in ins),
                *outs, q.data_ptr(), sb[0].data_ptr(), sb[1].data_ptr(),
                bar.data_ptr(), T, B, S, D, A, H2, plan["cg"], plan["rg"],
                stream)
        else:
            work = torch.empty(B * (A + 6 * D), device=dev)  # carry + scratch
            ATTN_DEC_FWD.call(
                f"attn_dec_fwd_{_SUFFIX[cd]}", *(t.data_ptr() for t in ins),
                *outs, work.data_ptr(), T, B, S, D, A, H2, stream)
    return states, probs, ctx, s_prev


def denc_dv_after_loop(q, enc_proj, att_v, d_score):
    """``d_enc_proj`` and ``d_v`` from every step's ``d_score`` [T, B, S]
    and query q [T, B, A], as the kernel's pass after its loop forms them:
    ``d_enc_proj`` summed over t from T-1 down to 0 (the loop's order),
    ``d_v`` over source positions of each position's sum over t, then over
    rows.  ``pre`` is recomputed with the loop's casts."""
    T, B, S = d_score.shape
    att_v_f = att_v.float()
    d_enc_p = torch.zeros(enc_proj.shape, device=enc_proj.device)
    dv_pos = torch.zeros(enc_proj.shape, device=enc_proj.device)
    for t in range(T - 1, -1, -1):
        enc_proj_c, q_c = mxu_cast(enc_proj, q[t][:, None, :])
        pre_f = torch.tanh(enc_proj_c + q_c).float()       # [B, S, A]
        d = d_score[t][..., None]
        d_enc_p = d_enc_p + (1.0 - pre_f * pre_f) * (d * att_v_f)
        dv_pos = dv_pos + d * pre_f
    return d_enc_p, dv_pos.sum(1).sum(0)


@float32_products()
def attn_dec_bwd_plain(d_out_tb, m_tb, s_prev, r, u, cand, q, enc, enc_proj,
                       src_mask, att_w, att_v, wh, wx_c, *,
                       deferred: bool = False):
    """The kernel's function as a reverse step loop of PyTorch ops.  Same
    arguments and results as ``attn_dec_bwd``.  ``deferred=True`` forms
    ``d_enc_proj`` and ``d_v`` as the kernel does, after the loop from the
    steps' ``d_score`` (``denc_dv_after_loop``), not inside it."""
    T, B, S, D, A, H2 = _check_bwd(d_out_tb, m_tb, s_prev, r, u, cand, q,
                                   enc, enc_proj, src_mask, att_w, att_v, wh,
                                   wx_c)
    f32 = torch.float32
    dev = d_out_tb.device
    neg = torch.finfo(f32).min
    maskb = src_mask > 0
    att_v_f = att_v.float()
    wh_c_t, wh_g_t = wh[:, 2 * D:].t(), wh[:, :2 * D].t()
    wx_c_t, att_w_t = wx_c.t(), att_w.t()
    d_s = torch.zeros(B, D, device=dev)
    d_enc_p = torch.zeros(B, S, A, device=dev)
    d_v = torch.zeros(A, device=dev)
    d_xp_tb = torch.zeros(T, B, 3 * D, device=dev)
    sum_dpre_tb = torch.zeros(T, B, A, device=dev)
    d_score_tb = torch.zeros(T, B, S, device=dev)
    for t in range(T - 1, -1, -1):
        mcol = (m_tb[t] > 0).to(f32)[:, None]
        d_snew = mcol * (d_out_tb[t] + d_s)
        # GRU backward (gates precomputed by the caller)
        d_zr, d_zc, d_h = gru_cell_bwd(d_snew, s_prev[t], r[t], u[t],
                                       cand[t], wh_c_t, wh_g_t)
        d_xp = torch.cat([d_zr, d_zc], -1)                  # [B, 3D]
        d_ctx = bwd_mm(d_xp, wx_c_t)                        # [B, 2H]

        # attention backward: the softmax chain from the recomputed query
        d_w = bwd_einsum("bh,bsh->bs", d_ctx.to(enc.dtype), enc)
        enc_proj_c, q_c = mxu_cast(enc_proj, q[t][:, None, :])
        pre = torch.tanh(enc_proj_c + q_c)                  # [B, S, A] cd
        scores = score_product(pre, att_v)
        z = torch.where(maskb, scores, torch.full_like(scores, neg))
        w0 = torch.softmax(z, dim=-1)
        w1 = w0 * src_mask
        n = torch.clamp(w1.sum(-1, keepdim=True), min=1e-9)
        d_w1 = d_w / n
        d_n = -(d_w * w1).sum(-1, keepdim=True) / (n * n)
        d_w1 = d_w1 + d_n * (w1.sum(-1, keepdim=True) > 1e-9).to(f32)
        d_w0 = d_w1 * src_mask
        d_z = w0 * (d_w0 - (w0 * d_w0).sum(-1, keepdim=True))
        d_scores = torch.where(maskb, d_z, torch.zeros_like(d_z))
        pre_f = pre.float()
        d_pre = (1.0 - pre_f * pre_f) * (d_scores[..., None] * att_v_f)
        sum_dpre = d_pre.sum(1)                             # [B, A]
        d_h = d_h + bwd_mm(sum_dpre, att_w_t)
        if deferred:
            d_score_tb[t] = d_scores
        else:
            d_enc_p = d_enc_p + d_pre
            d_v = d_v + bwd_einsum("bs,bsa->a", d_scores, pre_f)

        d_s = (1.0 - mcol) * d_s + d_h
        d_xp_tb[t] = d_xp
        sum_dpre_tb[t] = sum_dpre
    if deferred:
        d_enc_p, d_v = denc_dv_after_loop(q, enc_proj, att_v, d_score_tb)
    return d_xp_tb, sum_dpre_tb, d_enc_p, d_v, d_s


def attn_dec_bwd(d_out_tb: torch.Tensor, m_tb: torch.Tensor,
                 s_prev: torch.Tensor, r: torch.Tensor, u: torch.Tensor,
                 cand: torch.Tensor, q: torch.Tensor, enc: torch.Tensor,
                 enc_proj: torch.Tensor, src_mask: torch.Tensor,
                 att_w: torch.Tensor, att_v: torch.Tensor, wh: torch.Tensor,
                 wx_c: torch.Tensor):
    """Reverse pass of ``attn_dec_fwd``, time-major.

    d_out [T, B, D] (the cotangent of states), mask [T, B], s_prev, r, u,
    cand [T, B, D] (the carry entering each step and its GRU gates), q
    [T, B, A] (the attention query of each step), src_mask [B, S], att_w
    [D, A], wh [D, 3D], wx_c [2H, 3D], all float32; enc [B, S, 2H] and
    enc_proj [B, S, A] in the compute dtype; att_v [A] -> (d_xp [T, B, 3D],
    sum_dpre [T, B, A], d_enc_proj [B, S, A], d_v [A], d_s0 [B, D]), all
    float32."""
    T, B, S, D, A, H2 = _check_bwd(d_out_tb, m_tb, s_prev, r, u, cand, q,
                                   enc, enc_proj, src_mask, att_w, att_v, wh,
                                   wx_c)
    if d_out_tb.device.type == "cpu":
        return attn_dec_bwd_plain(d_out_tb, m_tb, s_prev, r, u, cand, q, enc,
                                  enc_proj, src_mask, att_w, att_v, wh, wx_c)
    dev = _device_of(d_out_tb, "attn_dec_bwd", S)
    ins = [t.contiguous() for t in (d_out_tb, m_tb, s_prev, r, u, cand, q,
                                    enc, enc_proj, src_mask)]
    # the products take the transposed float32 weights, as the reference
    # kernel's caller hands them over
    weights = [att_v.float().contiguous(), att_w.t().contiguous(),
               wh[:, 2 * D:].t().contiguous(), wh[:, :2 * D].t().contiguous(),
               wx_c.t().contiguous()]
    d_xp = torch.empty(T, B, 3 * D, device=dev)
    sum_dpre = torch.empty(T, B, A, device=dev)
    d_enc_p = torch.empty(B, S, A, device=dev)
    d_v = torch.empty(A, device=dev)
    d_s0 = torch.empty(B, D, device=dev)
    # the step's scratch and d_score [T, B, S], kept for the pass that sums
    # d_enc_proj and d_v after the loop
    work = torch.empty(B * (2 * D + H2 + A) + T * B * S, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ATTN_DEC_BWD.call(
            f"attn_dec_bwd_{_SUFFIX[enc.dtype]}",
            *(t.data_ptr() for t in ins + weights), d_xp.data_ptr(),
            sum_dpre.data_ptr(), d_enc_p.data_ptr(), d_v.data_ptr(),
            d_s0.data_ptr(), work.data_ptr(), T, B, S, D, A, H2, stream)
    ATTN_DEC_BWD.count("single")
    return d_xp, sum_dpre, d_enc_p, d_v, d_s0


#: the smoke calls' shape (B, S, T, D, A, 2H), one the persistent plan takes
_SMOKE_SHAPE = (3, 7, 5, 32, 32, 64)


def _smoke_inputs(dev):
    """Seeded small K5 inputs at float32: source and target tails, weights
    scaled by their fan-in."""
    B, S, T, D, A, H2 = _SMOKE_SHAPE
    g = torch.Generator().manual_seed(5)

    def r(scale, *shape):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    m = torch.ones(T, B)
    m[T // 2:, -1] = 0.0
    src_mask = torch.ones(B, S)
    src_mask[-1, S // 2:] = 0.0
    return dict(xp_y=r(0.5, T, B, 3 * D), m=m.to(dev), s0=r(0.5, B, D),
                enc=r(1.0, B, S, H2), enc_proj=r(1.0, B, S, A),
                src_mask=src_mask.to(dev), att_w=r(D ** -0.5, D, A),
                att_v=r(2.0 * A ** -0.5, A), wx_c=r(H2 ** -0.5, H2, 3 * D),
                wh=r(D ** -0.5, D, 3 * D))


def _fwd_args(x, dt):
    return [x["xp_y"], x["m"], x["s0"]] + [
        x[k].to(dt) for k in ("enc", "enc_proj")] + [x["src_mask"]] + [
        x[k].to(dt) for k in ("att_w", "att_v", "wx_c", "wh")]


def _smoke_fwd() -> Dict[str, float]:
    """One small launch of each K5 kernel (the f32 and bf16 step kernels,
    the persistent kernel) on the current card, uncounted, against
    ``attn_dec_fwd_plain``: f32 within 2e-5 of each output's largest
    value, bf16 within 5e-3 (the card tests' tolerances)."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    x = _smoke_inputs(torch.device("cuda", torch.cuda.current_device()))
    errs = {}
    with uncounted(ATTN_DEC_FWD):
        for cd, path, tol in (("float32", "steps", 2e-5),
                              ("bfloat16", "steps", 5e-3),
                              ("bfloat16", "persistent", 5e-3)):
            with compute_dtype_scope(cd):
                args = _fwd_args(x, getattr(torch, cd))
                got = _launch_fwd(*args, path)
                want = attn_dec_fwd_plain(*args)
            errs[f"{path}_{cd}"] = max(
                smoke_error(f"attn_dec_fwd {path} {cd}", (a,), (b,), tol)
                for a, b in zip(got, want))
    return errs


def _smoke_bwd() -> Dict[str, float]:
    """One small launch of each K6 kernel (f32 and bf16 encoder operands)
    on the current card, uncounted, from the plain forward's residuals,
    against ``attn_dec_bwd_plain``: within 2e-5 (f32) or 1e-2 (bf16) of
    each output's largest value."""
    from paddle_tpu_torch.ops.attention_decoder import recompute_gates
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    dev = torch.device("cuda", torch.cuda.current_device())
    x = _smoke_inputs(dev)
    T, B, D = x["xp_y"].shape[0], x["xp_y"].shape[1], _SMOKE_SHAPE[3]
    d_out = torch.randn(T, B, D, generator=torch.Generator().manual_seed(6)
                        ).to(dev)
    errs = {}
    with uncounted(ATTN_DEC_BWD):
        for cd, tol in (("float32", 2e-5), ("bfloat16", 1e-2)):
            with compute_dtype_scope(cd):
                args = _fwd_args(x, getattr(torch, cd))
                _, _, ctxs, s_prev = attn_dec_fwd_plain(*args)
                r, u, cand, q = recompute_gates(x["xp_y"], ctxs, s_prev,
                                                x["wx_c"], x["wh"],
                                                x["att_w"])
                bargs = [d_out, x["m"], s_prev, r, u, cand, q, args[3],
                         args[4], x["src_mask"], x["att_w"], x["att_v"],
                         x["wh"], x["wx_c"]]
                got = attn_dec_bwd(*bargs)
                want = attn_dec_bwd_plain(*bargs)
            errs[cd] = max(smoke_error(f"attn_dec_bwd {cd}", (a,), (b,), tol)
                           for a, b in zip(got, want))
    return errs


ATTN_DEC_FWD.smoke = _smoke_fwd
ATTN_DEC_BWD.smoke = _smoke_bwd
