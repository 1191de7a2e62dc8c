"""Top-k + logsumexp over pre-built logits: the CUDA kernel's wrapper and
its plain version.

Replaces ``paddle_tpu/ops/pallas_kernels.py::topk_lse_logits_pallas``, the
readout of ``ops/decode.py::LogitsReadout``.  ``topk_lse_logits``
dispatches on the tensor's device: a CPU tensor runs
``topk_lse_logits_plain``; a CUDA tensor launches
``csrc/topk_lse_logits.cu`` (one launch, each row split over a thread block
cluster by ``_k8_plan``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register
from paddle_tpu_torch.ops.kernels.topk_readout import MAX_K, topk_lse_stats

__all__ = ["topk_lse_logits", "topk_lse_logits_plain", "TOPK_LSE_LOGITS",
           "K8Plan", "topk_logits_kernel_info"]

_ARGS = [ARG_PTR] * 4 + [ARG_INT] * 6 + [ARG_PTR]
TOPK_LSE_LOGITS = register(
    "topk_lse_logits",
    {"topk_lse_logits_f32": _ARGS, "topk_lse_logits_bf16": _ARGS,
     "topk_lse_logits_info": [ARG_INT] * 2 + [ARG_PTR] * 3})
_ENTRY = {torch.float32: "topk_lse_logits_f32",
          torch.bfloat16: "topk_lse_logits_bf16"}

#: slice and chunk lengths are multiples of this many columns (16 bytes of
#: bf16; csrc k8::ALIGN)
_ALIGN = 8
#: blocks a row at most: the portable cluster size (csrc k8::MAX_CLUSTER)
_MAX_CLUSTER = 8
#: a block's staging buffer holds at most this many bytes of logits (csrc
#: k8::MAX_CHUNK_BYTES); a longer slice is staged a chunk at a time
_MAX_CHUNK_BYTES = 65536
#: the columns of a row one block reduces at most, each slice staged in
#: one chunk where it fits, and the block's width (csrc k8::THREADS, fixed
#: at compile time): picked by timing plans at the DSL generation's readout
#: (N = 192, V = 30000, f32 and bf16) on the H100 (``chip_probe.py
#: k8plans``; PERF.md): 2 blocks of 256 threads a row
_SLICE_COLUMNS = 16384
_THREADS = 256


class K8Plan(NamedTuple):
    """How the kernel splits a row of V logits: ``clusters`` blocks (one
    thread block cluster), block r reducing columns [r * slice,
    min((r + 1) * slice, V)), staged ``chunk`` columns at a time."""
    clusters: int
    slice: int
    chunk: int


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


def _plan_for(V: int, dtype: torch.dtype, clusters: int,
              chunk_bytes: int) -> K8Plan:
    """A row of V logits split over at most ``clusters`` blocks (fewer
    where a slice would be empty), staged in chunks of at most
    ``chunk_bytes``."""
    S = _roundup(-(-V // clusters), _ALIGN)
    return K8Plan(-(-V // S), S, min(S, chunk_bytes // _itemsize(dtype)))


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


@functools.lru_cache(maxsize=None)
def _k8_plan(V: int, dtype: torch.dtype) -> K8Plan:
    """The kernel's split of a row, from V and the logits' dtype alone (so a
    row's result never depends on N): one block per ``_SLICE_COLUMNS`` of
    the row, at most ``_MAX_CLUSTER``, each staging its slice in chunks of
    up to ``_MAX_CHUNK_BYTES``."""
    C = max(1, min(_MAX_CLUSTER, -(-V // _SLICE_COLUMNS)))
    return _plan_for(V, dtype, C, _MAX_CHUNK_BYTES)


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
    out = _launch(logits, k, _k8_plan(V, logits.dtype))
    if N:
        TOPK_LSE_LOGITS.count("single")
    return out


def _launch(logits: torch.Tensor, k: int, plan: K8Plan
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the kernel under ``plan`` (none for N = 0); counts
    nothing (the wrapper counts).  Allocates only the three outputs."""
    N, V = logits.shape
    dev = logits.device
    lc = logits.contiguous()
    vals = torch.empty(N, k, device=dev)
    idx = torch.empty(N, k, device=dev, dtype=torch.int64)
    lse = torch.empty(N, device=dev)
    if N:
        with torch.cuda.device(dev):          # launch on the tensor's card
            TOPK_LSE_LOGITS.call(
                _ENTRY[logits.dtype], lc.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), lse.data_ptr(), N, V, k, plan.clusters,
                plan.slice, plan.chunk,
                torch.cuda.current_stream(dev).cuda_stream)
    return vals, idx, lse


def topk_logits_kernel_info(dtype: torch.dtype, k: int
                            ) -> Tuple[int, int, int]:
    """(registers a thread, spilled bytes a thread, static shared bytes a
    block) of the kernel for ``dtype`` and k, from
    ``cudaFuncGetAttributes``."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = TOPK_LSE_LOGITS.lib().topk_lse_logits_info(
        int(dtype == torch.bfloat16), k, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"topk_lse_logits_info: CUDA error {err}")
    return tuple(v.value for v in vals)


def _smoke() -> Dict[str, float]:
    """One small launch of each K8 kernel (f32 and bf16 logits) on the
    current card, uncounted, against ``topk_lse_logits_plain``: ids equal,
    values and lse within 1e-5 of the largest value."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(4, 1000, generator=torch.Generator().manual_seed(8)
                    ).to(dev)
    errs = {}
    with uncounted(TOPK_LSE_LOGITS):
        for dt in (torch.float32, torch.bfloat16):
            lg = x.to(dt)
            name = str(dt)[6:]
            vals, idx, lse = topk_lse_logits(lg, 3)
            pv, pi, pl = topk_lse_logits_plain(lg, 3)
            if not torch.equal(idx, pi):
                raise RuntimeError(f"smoke call topk_lse_logits {name}: "
                                   f"ids differ")
            errs[name] = smoke_error(f"topk_lse_logits {name}",
                                     (vals, lse), (pv, pl), 1e-5)
    return errs


TOPK_LSE_LOGITS.smoke = _smoke
