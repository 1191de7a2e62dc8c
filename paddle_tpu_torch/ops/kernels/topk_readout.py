"""Vocab-tiled top-k + logsumexp readout: the CUDA kernel's wrapper and its
plain version.

Replaces ``paddle_tpu/ops/pallas_kernels.py::topk_lse_readout_pallas``.
``topk_lse_readout`` dispatches on the tensors' device: a CPU tensor runs
``topk_lse_readout_plain``; a CUDA tensor launches
``csrc/topk_lse_readout.cu`` or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register

__all__ = ["topk_lse_readout", "topk_lse_readout_plain", "stable_topk",
           "TOPK_LSE_READOUT", "MAX_K"]

#: static bound of the per-tile top-k (the reference's _MAX_KERNEL_K)
MAX_K = 16

_ARGS = [ARG_PTR] * 10 + [ARG_INT] * 4 + [ARG_PTR]
TOPK_LSE_READOUT = register(
    "topk_lse_readout",
    {"topk_lse_readout_f32": _ARGS, "topk_lse_readout_bf16": _ARGS})
_ENTRY = {torch.float32: "topk_lse_readout_f32",
          torch.bfloat16: "topk_lse_readout_bf16"}


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
    """The kernel's function in PyTorch ops: float32 logits, a stable sort
    for the top-k, and the logsumexp over finite-min-clamped logits."""
    _check(states, w, b, k)
    logits = torch.matmul(states.float(), w.float()) + b.float()
    vals, idx = stable_topk(logits, k)
    lc = torch.clamp(logits, min=torch.finfo(torch.float32).min)
    m = lc.max(dim=-1, keepdim=True).values
    lse = m[:, 0] + torch.log(torch.exp(lc - m).sum(dim=-1))
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
    if states.dtype not in _ENTRY:
        raise ValueError(f"unsupported compute dtype {states.dtype}")
    dev = states.device
    s = states.contiguous()
    wc = w.contiguous()
    bf = b.float().contiguous()
    nv = TOPK_LSE_READOUT.lib().topk_lse_num_tiles(V)
    pv = torch.empty(N, nv, k, device=dev)
    pi = torch.empty(N, nv, k, device=dev, dtype=torch.int32)
    pm = torch.empty(N, nv, device=dev)
    ps = torch.empty(N, nv, device=dev)
    vals = torch.empty(N, k, device=dev)
    idx = torch.empty(N, k, device=dev, dtype=torch.int64)
    lse = torch.empty(N, device=dev)
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        TOPK_LSE_READOUT.call(
            _ENTRY[states.dtype], s.data_ptr(), wc.data_ptr(), bf.data_ptr(),
            pv.data_ptr(), pi.data_ptr(), pm.data_ptr(), ps.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), N, D, V, k,
            stream)
    TOPK_LSE_READOUT.launches += 1
    return vals, idx, lse
