"""Row logsumexp read in one pass: the CUDA kernel's wrapper and its plain
version.

Replaces ``paddle_tpu/ops/pallas_kernels.py::logsumexp_rows_pallas`` (K12),
the softmax statistics of ``ops/losses.py``'s logsumexp readout
(``_CEReadoutLSE``).  ``logsumexp_rows`` dispatches on the tensor's device:
a CPU tensor runs ``logsumexp_rows_plain``; a CUDA tensor launches
``csrc/logsumexp_rows.cu`` or raises.  Unlike the reference, any row count
is taken (no row tile).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register

__all__ = ["logsumexp_rows", "logsumexp_rows_plain", "LOGSUMEXP_ROWS"]

_ARGS = [ARG_PTR] * 2 + [ARG_INT] * 2 + [ARG_PTR]
LOGSUMEXP_ROWS = register("logsumexp_rows", {"logsumexp_rows_f32": _ARGS,
                                             "logsumexp_rows_bf16": _ARGS})
_ENTRY = {torch.float32: "logsumexp_rows_f32",
          torch.bfloat16: "logsumexp_rows_bf16"}


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be [N, V] with V >= 1, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")


def logsumexp_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """The reference's formula (``_lse_kernel``) in PyTorch ops: the row
    max, then ``max + log(sum(exp(x - max)))`` in float32.  An all -inf
    row gives nan, as there."""
    _check(x)
    xf = x.float()
    m = xf.max(dim=-1, keepdim=True).values
    return m[:, 0] + torch.log(torch.exp(xf - m).sum(dim=-1))


def logsumexp_rows(x: torch.Tensor) -> torch.Tensor:
    """x [N, V] (float32 or bfloat16) -> lse [N] float32, reading each
    logit once."""
    _check(x)
    if x.device.type == "cpu":
        return logsumexp_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"logsumexp_rows runs on cpu or cuda, not "
                         f"{x.device}")
    N, V = x.shape
    xc = x.contiguous()
    lse = torch.empty(N, device=x.device)
    with torch.cuda.device(x.device):         # launch on the tensor's card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        LOGSUMEXP_ROWS.call(_ENTRY[x.dtype], xc.data_ptr(), lse.data_ptr(),
                            N, V, stream)
    LOGSUMEXP_ROWS.count("single")
    return lse


def _smoke() -> Dict[str, float]:
    """One small launch of each K12 kernel (f32 and bf16 rows) on the
    current card, uncounted, against ``logsumexp_rows_plain`` within 1e-6
    of the largest value (the card tests' rtol)."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted

    dev = torch.device("cuda", torch.cuda.current_device())
    x = (3.0 * torch.randn(5, 300, generator=torch.Generator().manual_seed(
        12))).to(dev)
    errs = {}
    with uncounted(LOGSUMEXP_ROWS):
        for dt in (torch.float32, torch.bfloat16):
            xt = x.to(dt)
            name = str(dt)[6:]
            errs[name] = smoke_error(f"logsumexp_rows {name}",
                                     (logsumexp_rows(xt),),
                                     (logsumexp_rows_plain(xt),), 1e-6)
    return errs


LOGSUMEXP_ROWS.smoke = _smoke
