"""Top-k + logsumexp over pre-built logits: the CUDA kernel's wrapper and
its plain version.

Replaces ``paddle_tpu/ops/pallas_kernels.py::topk_lse_logits_pallas``, the
readout of ``ops/decode.py::LogitsReadout``.  ``topk_lse_logits``
dispatches on the tensor's device: a CPU tensor runs
``topk_lse_logits_plain``; a CUDA tensor launches
``csrc/topk_lse_logits.cu`` or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.kernels.topk_readout import MAX_K, topk_lse_stats

__all__ = ["topk_lse_logits", "topk_lse_logits_plain", "TOPK_LSE_LOGITS"]

_ARGS = [ARG_PTR] * 8 + [ARG_INT] * 3 + [ARG_PTR]
TOPK_LSE_LOGITS = register(
    "topk_lse_logits",
    {"topk_lse_logits_f32": _ARGS, "topk_lse_logits_bf16": _ARGS,
     "topk_logits_num_tiles": [ARG_INT]})
_ENTRY = {torch.float32: "topk_lse_logits_f32",
          torch.bfloat16: "topk_lse_logits_bf16"}


def _check(logits: torch.Tensor, k: int) -> Tuple[int, int]:
    if logits.dim() != 2:
        raise ValueError(f"logits [N, V] expected, got "
                         f"{tuple(logits.shape)}")
    N, V = logits.shape
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"k must be in [1, min({MAX_K}, V={V})], got {k}")
    if logits.dtype not in _ENTRY:
        raise ValueError(f"logits must be float32 or bfloat16, got "
                         f"{logits.dtype}")
    return N, V


def topk_lse_logits_plain(logits: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The kernel's function in PyTorch ops: ``topk_lse_stats`` over the
    logits widened to float32."""
    _check(logits, k)
    return topk_lse_stats(logits.float(), k)


def topk_lse_logits(logits: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [N, V] (f32 or bf16) -> (vals [N, k] f32, idx [N, k] i64,
    lse [N] f32): the k largest logits per row, ties to the lowest id, and
    the row logsumexp over finite-min-clamped values, from one read of the
    logits."""
    N, V = _check(logits, k)
    if logits.device.type == "cpu":
        return topk_lse_logits_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"topk_lse_logits runs on cpu or cuda, not "
                         f"{logits.device}")
    dev = logits.device
    lc = logits.contiguous()
    nv = TOPK_LSE_LOGITS.lib().topk_logits_num_tiles(V)
    pv = torch.empty(N, nv, k, device=dev)
    pi = torch.empty(N, nv, k, device=dev, dtype=torch.int32)
    pm = torch.empty(N, nv, device=dev)
    ps = torch.empty(N, nv, device=dev)
    vals = torch.empty(N, k, device=dev)
    idx = torch.empty(N, k, device=dev, dtype=torch.int64)
    lse = torch.empty(N, device=dev)
    with torch.cuda.device(dev):              # launch on the tensor's card
        stream = torch.cuda.current_stream(dev).cuda_stream
        TOPK_LSE_LOGITS.call(
            _ENTRY[logits.dtype], lc.data_ptr(), pv.data_ptr(),
            pi.data_ptr(), pm.data_ptr(), ps.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), lse.data_ptr(), N, V, k, stream)
    TOPK_LSE_LOGITS.launches += 1
    return vals, idx, lse
