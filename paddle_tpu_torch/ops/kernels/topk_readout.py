"""Vocab-tiled top-k + logsumexp readout: the CUDA kernel's wrapper and its
plain version.

Replaces ``paddle_tpu/ops/pallas_kernels.py::topk_lse_readout_pallas``.
``topk_lse_readout`` dispatches on the tensors' device: a CPU tensor runs
``topk_lse_readout_plain``; a CUDA tensor launches
``csrc/topk_lse_readout.cu`` or raises.

On the card ``_topk_path`` picks pass 1's kernel from the shape, dtype and
operand alignment alone, never by catching a failure: ``"wgmma"`` (TMA
loads and Hopper warpgroup products; bf16, D in {64, 128, 256, 512},
V % 8 == 0, N > 0, 16-byte aligned operands, as TMA needs) or ``"simt"``
(float32, and every shape TMA cannot take).  Both write per-slice partials
(128-column tiles, or 256-column chunks on the wgmma path) in the layout
the merge pass shared with K8 reads; the library counts its launches per
path (``launches_by_path``).
"""

from __future__ import annotations

import ctypes
import math

from typing import Dict, Sequence, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.numerics import pointwise

__all__ = ["topk_lse_readout", "topk_lse_readout_plain", "stable_topk",
           "topk_lse_stats", "TOPK_LSE_READOUT", "MAX_K", "topk_kernel_info"]

#: static bound of the per-tile top-k (the reference's _MAX_KERNEL_K)
MAX_K = 16

_ARGS = [ARG_PTR] * 10 + [ARG_INT] * 4 + [ARG_PTR]
TOPK_LSE_READOUT = register(
    "topk_lse_readout",
    {"topk_lse_readout_f32": _ARGS, "topk_lse_readout_bf16": _ARGS,
     "topk_lse_readout_bf16_wgmma": _ARGS,
     "topk_lse_readout_info": [ARG_INT, ARG_INT] + [ARG_PTR] * 3})
_ENTRY = {("simt", torch.float32): "topk_lse_readout_f32",
          ("simt", torch.bfloat16): "topk_lse_readout_bf16",
          ("wgmma", torch.bfloat16): "topk_lse_readout_bf16_wgmma"}
#: vocab columns of one pass-1 partial: a SIMT tile (csrc VT), a wgmma
#: chunk (csrc k7::CHUNK); the partial count depends on V alone
_TILE = {"simt": 128, "wgmma": 256}
#: depths the TMA + wgmma pass 1 takes
_WGMMA_DEPTHS = (64, 128, 256, 512)


def _topk_path(N: int, D: int, V: int, dtype: torch.dtype,
               ptrs: Sequence[int]) -> str:
    """Pass 1's kernel for a CUDA call, from the shape, the compute dtype
    and the operands' addresses: ``"wgmma"`` where TMA can take the
    operands (bf16, D one of the instantiated depths, w rows a multiple of
    16 bytes, every base 16-byte aligned, N > 0), else ``"simt"``."""
    if (dtype == torch.bfloat16 and N > 0 and D in _WGMMA_DEPTHS
            and V % 8 == 0 and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "simt"


def _topk_scratch(N: int, V: int, k: int, path: str
                  ) -> Dict[str, Tuple[int, ...]]:
    """The four pass-1 partial buffers, as views of one float32 scratch
    allocation: the top-k values and ids [N, nV, k] (ids int32), the
    max and sum-exp [N, nV], nV = ceil(V / 128) SIMT tiles or ceil(V / 256)
    wgmma chunks."""
    nv = -(-V // _TILE[path])
    return {"pv": (N, nv, k), "pi": (N, nv, k), "pm": (N, nv),
            "ps": (N, nv)}


def topk_kernel_info(D: int) -> Dict[str, Tuple[int, int, int]]:
    """(registers a thread, spilled bytes a thread, shared bytes a block) of
    pass 1's kernels at depth D, from ``cudaFuncGetAttributes``."""
    out = {}
    for which, name in enumerate(("wgmma", "simt_bf16", "simt_f32")):
        vals = [ctypes.c_int() for _ in range(3)]
        err = TOPK_LSE_READOUT.lib().topk_lse_readout_info(
            which, D, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"topk_lse_readout_info({which}): CUDA error "
                               f"{err}")
        out[name] = tuple(v.value for v in vals)
    return out


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis in ``lax.top_k`` order: larger value first,
    ties to the lowest index (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _check(states, w, b, k) -> Tuple[int, int, int]:
    if states.dim() != 2 or w.dim() != 2:
        raise ValueError(f"states [N, D] and w [D, V] expected, got "
                         f"{tuple(states.shape)} and {tuple(w.shape)}")
    N, D = states.shape
    if w.shape[0] != D:
        raise ValueError(f"w depth {w.shape[0]} != states depth {D}")
    V = w.shape[1]
    if tuple(b.shape) != (V,):
        raise ValueError(f"b must be [V] = {(V,)}, got {tuple(b.shape)}")
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"k must be in [1, min({MAX_K}, V={V})], got {k}")
    if states.dtype != w.dtype:
        raise ValueError(f"states ({states.dtype}) and w ({w.dtype}) must "
                         f"share the compute dtype")
    devs = {states.device, w.device, b.device}
    if len(devs) != 1:
        raise ValueError(f"topk_lse_readout inputs span devices {devs}")
    return N, D, V


def topk_lse_readout_plain(states: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The kernel's function in PyTorch ops: float32 logits, then
    ``topk_lse_stats``."""
    _check(states, w, b, k)
    return topk_lse_stats(torch.matmul(states.float(), w.float()) + b.float(),
                          k)


def topk_lse_stats(logits: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The statistics both readout kernels compute, over float32 logits
    [N, V]: ``stable_topk`` and the logsumexp over finite-min-clamped
    values (an all ``-inf`` row gives about ``finfo.min``, not nan)."""
    vals, idx = stable_topk(logits, k)
    lc = torch.clamp(logits, min=torch.finfo(torch.float32).min)
    m = lc.max(dim=-1, keepdim=True).values
    lse = m[:, 0] + pointwise(
        torch.log, pointwise(torch.exp, lc - m).sum(dim=-1))
    return vals, idx, lse


def topk_lse_readout(states: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """states [N, D] and w [D, V] in the compute dtype (f32 or bf16), b [V]
    -> (vals [N, k] f32, idx [N, k] i64, lse [N] f32): the k largest
    logits of ``states @ w + b`` per row, ties to the lowest id, and the
    row logsumexp.  The [N, V] logits never reach device memory."""
    N, D, V = _check(states, w, b, k)
    if states.device.type == "cpu":
        return topk_lse_readout_plain(states, w, b, k)
    if states.device.type != "cuda":
        raise ValueError(f"topk_lse_readout runs on cpu or cuda, not "
                         f"{states.device}")
    if states.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {states.dtype}")
    s = states.contiguous()
    wc = w.contiguous()
    bf = b.float().contiguous()
    path = _topk_path(N, D, V, states.dtype,
                      (s.data_ptr(), wc.data_ptr(), bf.data_ptr()))
    out = _launch(s, wc, bf, k, path)
    TOPK_LSE_READOUT.count(path)
    return out


def _launch(s: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
            path: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both passes on contiguous CUDA operands through the kernel of
    ``path``; counts nothing (the wrapper counts).  Three allocations: the
    partials' scratch, vals + lse, idx."""
    N, D = s.shape
    V = w.shape[1]
    dev = s.device
    sizes = [math.prod(p) for p in _topk_scratch(N, V, k, path).values()]
    scratch = torch.empty(sum(sizes), device=dev)
    ptrs, at = [], scratch.data_ptr()
    for n in sizes:                           # pv, pi, pm, ps: 4-byte items
        ptrs.append(at)
        at += 4 * n
    vl = torch.empty(N * k + N, device=dev)
    vals, lse = vl[:N * k].view(N, k), vl[N * k:]
    idx = torch.empty(N, k, device=dev, dtype=torch.int64)
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        TOPK_LSE_READOUT.call(
            _ENTRY[(path, s.dtype)], s.data_ptr(), w.data_ptr(),
            b.data_ptr(), *ptrs, vals.data_ptr(), idx.data_ptr(),
            lse.data_ptr(), N, D, V, k, stream)
    return vals, idx, lse


def _smoke() -> Dict[str, float]:
    """One small launch of each K7 kernel (the f32 and bf16 SIMT pass 1,
    the TMA + wgmma pass 1) on the current card, uncounted, against
    ``topk_lse_readout_plain``: values and lse within 1e-4 of the largest
    value, ids equal (the seeded logits hold no near ties at k = 3)."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted

    dev = torch.device("cuda", torch.cuda.current_device())
    N, D, V, k = 6, 64, 264, 3
    g = torch.Generator().manual_seed(11)
    s32 = torch.randn(N, D, generator=g).to(dev)
    w32 = (0.2 * torch.randn(D, V, generator=g)).to(dev)
    b = (0.1 * torch.randn(V, generator=g)).to(dev)
    errs = {}
    with uncounted(TOPK_LSE_READOUT):
        for path, dt in (("simt", torch.float32), ("simt", torch.bfloat16),
                         ("wgmma", torch.bfloat16)):
            s, w = s32.to(dt).contiguous(), w32.to(dt).contiguous()
            vals, idx, lse = _launch(s, w, b, k, path)
            pv, pi, pl = topk_lse_readout_plain(s, w, b, k)
            name = f"topk_lse_readout {path} {str(dt)[6:]}"
            if not torch.equal(idx, pi):
                raise RuntimeError(f"smoke call {name}: ids differ")
            errs[f"{path}_{str(dt)[6:]}"] = smoke_error(
                name, (vals, lse), (pv, pl), 1e-4)
    return errs


TOPK_LSE_READOUT.smoke = _smoke
