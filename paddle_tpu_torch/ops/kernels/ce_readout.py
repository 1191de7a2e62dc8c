"""Vocab-tiled readout + softmax cross-entropy, forward and backward: the
CUDA kernels' wrappers and their plain versions.

- ``ce_readout_fwd`` replaces ``paddle_tpu/ops/pallas_kernels.py::
  ce_readout_fwd_pallas`` (K1): per row the logsumexp of ``states @ w + b``
  and the token loss ``lse - l[label]``, and the logits in the compute dtype
  as the backward's residual.
- ``ce_readout_bwd`` replaces ``ce_readout_bwd_pallas`` (K2): ``d_states``,
  ``d_w`` and ``d_b`` from that residual, with the [N, V] ``d_logits``
  never stored.

Each wrapper dispatches on the tensors' device: a CPU tensor runs the plain
version; a CUDA tensor launches ``csrc/ce_readout_fwd.cu`` /
``csrc/ce_readout_bwd.cu`` or raises.  The kernels mask the ragged vocab
tail themselves, so ``w`` is never padded per call.

On the card ``_ce_path`` picks the kernel from the shape, dtype and
operand alignment alone, never by catching a failure: ``"wgmma"`` (TMA
loads and Hopper warpgroup products; bf16, D in {64, 128, 256, 512},
V % 8 == 0, 16-byte aligned operands, as TMA needs), ``"wmma"`` (any other
bf16 shape) or ``"simt"`` (float32, CUDA-core FMAs).  Each library counts
its launches per path (``launches_by_path``).
"""

from __future__ import annotations

import ctypes

from typing import Dict, Sequence, Tuple

import torch

from paddle_tpu_torch.ops.kernels.build import ARG_INT, ARG_PTR, register

__all__ = ["ce_readout_fwd", "ce_readout_fwd_plain", "ce_readout_bwd",
           "ce_readout_bwd_plain", "CE_READOUT_FWD", "CE_READOUT_BWD",
           "ce_kernel_info"]

_FWD_ARGS = [ARG_PTR] * 7 + [ARG_INT] * 3 + [ARG_PTR]
_INFO_ARGS = [ARG_INT, ARG_INT] + [ARG_PTR] * 3
CE_READOUT_FWD = register("ce_readout_fwd", {
    "ce_readout_fwd_f32": _FWD_ARGS, "ce_readout_fwd_bf16": _FWD_ARGS,
    "ce_readout_fwd_bf16_wgmma": [ARG_PTR] * 8 + [ARG_INT] * 3 + [ARG_PTR],
    "ce_readout_fwd_info": _INFO_ARGS})
_BWD_ARGS = [ARG_PTR] * 9 + [ARG_INT] * 3 + [ARG_PTR]
CE_READOUT_BWD = register("ce_readout_bwd", {
    "ce_readout_bwd_f32": _BWD_ARGS, "ce_readout_bwd_bf16": _BWD_ARGS,
    "ce_readout_bwd_bf16_wgmma": [ARG_PTR] * 10 + [ARG_INT] * 3 + [ARG_PTR],
    "ce_readout_bwd_info": _INFO_ARGS})
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: depths the TMA + wgmma kernels are instantiated for
_WGMMA_DEPTHS = (64, 128, 256, 512)
#: vocab columns a block of the wgmma forward owns (csrc k1::CHUNK)
_FWD_CHUNK = 2048


def _ce_path(N: int, D: int, V: int, dtype: torch.dtype,
             ptrs: Sequence[int]) -> str:
    """The kernel a CUDA call takes, from the shape, the compute dtype and
    the operands' addresses: ``"wgmma"`` where TMA can take the operands
    (bf16, D one of the instantiated depths, rows a multiple of 16 bytes,
    every base 16-byte aligned, N > 0), else ``"wmma"`` for bf16 and
    ``"simt"`` for float32."""
    if dtype == torch.float32:
        return "simt"
    if (N > 0 and D in _WGMMA_DEPTHS and V % 8 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "wmma"


def _ce_scratch(N: int, D: int, V: int, path: str) -> Dict[str, tuple]:
    """The float32 scratch each wgmma kernel takes: the forward's partial
    (max, sum-exp, label logit) per vocab chunk and row, and the backward's
    second-chunk d_states.  The chunks depend on V alone."""
    if path != "wgmma":
        return {"fwd": (0,), "bwd": (0,)}
    return {"fwd": (3, -(-V // _FWD_CHUNK), N), "bwd": (N, D)}


def ce_kernel_info(D: int) -> Dict[str, Tuple[int, int, int]]:
    """(registers a thread, spilled bytes a thread, shared bytes a block) of
    every CE kernel at depth D, from ``cudaFuncGetAttributes``."""
    out = {}
    for lib, fn, names in (
            (CE_READOUT_FWD, "ce_readout_fwd_info",
             ("fwd_wgmma", "fwd_wmma", "fwd_simt")),
            (CE_READOUT_BWD, "ce_readout_bwd_info",
             ("bwd_a_wgmma", "bwd_b_wgmma", "bwd_a_wmma", "bwd_b_wmma",
              "bwd_a_simt", "bwd_b_simt"))):
        for which, name in enumerate(names):
            vals = [ctypes.c_int() for _ in range(3)]
            err = getattr(lib.lib(), fn)(which, D,
                                         *(ctypes.byref(v) for v in vals))
            if err != 0:
                raise RuntimeError(f"{fn}({which}): CUDA error {err}")
            out[name] = tuple(v.value for v in vals)
    return out


def _check_fwd(states, w, b, labels) -> Tuple[int, int, int]:
    if states.dim() != 2 or w.dim() != 2:
        raise ValueError(f"states [N, D] and w [D, V] expected, got "
                         f"{tuple(states.shape)} and {tuple(w.shape)}")
    N, D = states.shape
    if w.shape[0] != D:
        raise ValueError(f"w depth {w.shape[0]} != states depth {D}")
    V = w.shape[1]
    if tuple(b.shape) != (V,) or tuple(labels.shape) != (N,):
        raise ValueError(f"b must be [V] = {(V,)} and labels [N] = {(N,)}, "
                         f"got {tuple(b.shape)} and {tuple(labels.shape)}")
    if states.dtype != w.dtype or states.dtype not in _SUFFIX:
        raise ValueError(f"states ({states.dtype}) and w ({w.dtype}) must "
                         f"share the compute dtype (float32 or bfloat16)")
    devs = {t.device for t in (states, w, b, labels)}
    if len(devs) != 1:
        raise ValueError(f"ce_readout_fwd inputs span devices {devs}")
    return N, D, V


def ce_readout_fwd_plain(states: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops: float32 logits, their
    logsumexp, and the unrounded label logit."""
    N, _, V = _check_fwd(states, w, b, labels)
    logits = torch.matmul(states.float(), w.float()) + b.float()
    m = logits.max(dim=-1, keepdim=True).values
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    tok = logits.gather(1, labels.long().clamp(0, V - 1)[:, None])[:, 0]
    tok = torch.where((labels >= 0) & (labels < V), tok, torch.zeros_like(tok))
    return lse - tok, lse, logits.to(states.dtype)


def ce_readout_fwd(states: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """states [N, D] and w [D, V] in the compute dtype (f32 or bf16), b [V],
    labels [N] int -> (per_tok [N] f32 = lse - label logit, lse [N] f32,
    logits [N, V] in the compute dtype, the backward's residual).  The
    statistics and the label logit come from the float32 logits."""
    N, D, V = _check_fwd(states, w, b, labels)
    if states.device.type == "cpu":
        return ce_readout_fwd_plain(states, w, b, labels)
    if states.device.type != "cuda":
        raise ValueError(f"ce_readout_fwd runs on cpu or cuda, not "
                         f"{states.device}")
    dev = states.device
    s = states.contiguous()
    wc = w.contiguous()
    bf = b.float().contiguous()
    lab = labels.to(torch.int32).contiguous()
    per_tok = torch.empty(N, device=dev)
    lse = torch.empty(N, device=dev)
    logits = torch.empty(N, V, dtype=states.dtype, device=dev)
    path = _ce_path(N, D, V, states.dtype,
                    (s.data_ptr(), wc.data_ptr(), logits.data_ptr(),
                     bf.data_ptr()))
    args = [s.data_ptr(), wc.data_ptr(), bf.data_ptr(), lab.data_ptr(),
            per_tok.data_ptr(), lse.data_ptr(), logits.data_ptr()]
    fn = f"ce_readout_fwd_{_SUFFIX[states.dtype]}"
    if path == "wgmma":
        part = torch.empty(_ce_scratch(N, D, V, path)["fwd"], device=dev)
        args.append(part.data_ptr())
        fn += "_wgmma"
    with torch.cuda.device(dev):              # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        CE_READOUT_FWD.call(fn, *args, N, D, V, stream)
    CE_READOUT_FWD.count(path)
    return per_tok, lse, logits


def _check_bwd(logits, states, w, labels, lse, scale) -> Tuple[int, int,
                                                                int]:
    if logits.dim() != 2 or states.dim() != 2:
        raise ValueError(f"logits [N, V] and states [N, D] expected, got "
                         f"{tuple(logits.shape)} and {tuple(states.shape)}")
    N, V = logits.shape
    D = states.shape[1]
    want = {"states": (states, (N, D)), "w": (w, (D, V)),
            "labels": (labels, (N,)), "lse": (lse, (N,)),
            "scale": (scale, (N,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    if not (logits.dtype == states.dtype == w.dtype) \
            or logits.dtype not in _SUFFIX:
        raise ValueError(f"logits, states and w must share the compute "
                         f"dtype, got {logits.dtype}, {states.dtype}, "
                         f"{w.dtype}")
    devs = {t.device for t in (logits, states, w, labels, lse, scale)}
    if len(devs) != 1:
        raise ValueError(f"ce_readout_bwd inputs span devices {devs}")
    return N, D, V


def ce_readout_bwd_plain(logits: torch.Tensor, states: torch.Tensor,
                         w: torch.Tensor, labels: torch.Tensor,
                         lse: torch.Tensor, scale: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops, with the [N, V] d_logits built
    in float32."""
    N, _, V = _check_bwd(logits, states, w, labels, lse, scale)
    d_l = torch.exp(logits.float() - lse.float()[:, None])
    rows = torch.arange(N, device=logits.device)
    hit = (labels >= 0) & (labels < V)
    d_l[rows[hit], labels[hit].long()] -= 1.0
    d_l *= scale.float()[:, None]
    d_b = d_l.sum(dim=0)
    d_lc = d_l.to(states.dtype).float()
    d_states = torch.matmul(d_lc, w.float().t())
    d_w = torch.matmul(states.float().t(), d_lc)
    return d_states, d_w, d_b


def ce_readout_bwd(logits: torch.Tensor, states: torch.Tensor,
                   w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                   scale: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [N, V] (``ce_readout_fwd``'s residual), states [N, D] and
    w [D, V], all in the compute dtype; labels [N] int, lse [N] and the
    per-row cotangent scale [N] -> (d_states [N, D], d_w [D, V], d_b [V]),
    float32: the gradients of sum_n scale[n] * per_tok[n].  ``d_l`` is
    rounded to the compute dtype for the two products, not for ``d_b``."""
    N, D, V = _check_bwd(logits, states, w, labels, lse, scale)
    if logits.device.type == "cpu":
        return ce_readout_bwd_plain(logits, states, w, labels, lse, scale)
    if logits.device.type != "cuda":
        raise ValueError(f"ce_readout_bwd runs on cpu or cuda, not "
                         f"{logits.device}")
    dev = logits.device
    lg, s, wc = logits.contiguous(), states.contiguous(), w.contiguous()
    lab = labels.to(torch.int32).contiguous()
    ls = lse.float().contiguous()
    sc = scale.float().contiguous()
    d_states = torch.empty(N, D, device=dev)
    d_w = torch.empty(D, V, device=dev)
    d_b = torch.empty(V, device=dev)
    path = _ce_path(N, D, V, logits.dtype,
                    (lg.data_ptr(), s.data_ptr(), wc.data_ptr()))
    args = [lg.data_ptr(), s.data_ptr(), wc.data_ptr(), lab.data_ptr(),
            ls.data_ptr(), sc.data_ptr(), d_states.data_ptr(),
            d_w.data_ptr(), d_b.data_ptr()]
    fn = f"ce_readout_bwd_{_SUFFIX[logits.dtype]}"
    if path == "wgmma":
        part = torch.empty(_ce_scratch(N, D, V, path)["bwd"], device=dev)
        args.append(part.data_ptr())
        fn += "_wgmma"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        CE_READOUT_BWD.call(fn, *args, N, D, V, stream)
    CE_READOUT_BWD.count(path)
    return d_states, d_w, d_b


#: the smoke calls' shapes (N, D, V) and compute dtypes, one a kernel:
#: CUDA cores (f32), WMMA (bf16 at a depth TMA does not take), TMA + wgmma
_SMOKE_CASES = (((3, 96, 131), torch.float32, "simt"),
                ((3, 96, 131), torch.bfloat16, "wmma"),
                ((130, 64, 64), torch.bfloat16, "wgmma"))


def _smoke_inputs(N: int, D: int, V: int, dt: torch.dtype, dev):
    """Seeded small K1/K2 inputs: an out-of-vocab label, a masked row."""
    g = torch.Generator().manual_seed(N + D + V)
    s = torch.randn(N, D, generator=g).to(dev).to(dt)
    w = (0.1 * torch.randn(D, V, generator=g)).to(dev).to(dt)
    b = (0.1 * torch.randn(V, generator=g)).to(dev)
    lab = torch.randint(0, V, (N,), generator=g).to(dev)
    lab[-1] = V + 3
    scale = (torch.rand(N, generator=g) / N).to(dev)
    scale[0] = 0.0
    return s, w, b, lab, scale


def _smoke_fwd() -> Dict[str, float]:
    """One small launch of each K1 kernel on the current card, uncounted,
    against ``ce_readout_fwd_plain``: the picked-target logit and lse
    within 1e-5 of the largest value, the logits within 1e-5 (f32) or
    1e-2 (bf16 logits) of theirs."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted

    dev = torch.device("cuda", torch.cuda.current_device())
    errs = {}
    with uncounted(CE_READOUT_FWD):
        for (N, D, V), dt, path in _SMOKE_CASES:
            s, w, b, lab, _ = _smoke_inputs(N, D, V, dt, dev)
            pt, lse, logits = ce_readout_fwd(s, w, b, lab)
            ppt, plse, plogits = ce_readout_fwd_plain(s, w, b, lab)
            name = f"ce_readout_fwd {path}"
            smoke_error(name, (pt, lse), (ppt, plse), 1e-5)
            errs[path] = smoke_error(name, (logits,), (plogits,),
                                     1e-2 if dt == torch.bfloat16 else 1e-5)
    return errs


def _smoke_bwd() -> Dict[str, float]:
    """One small launch of each K2 kernel on the current card, uncounted,
    from the plain forward's logits and lse, against
    ``ce_readout_bwd_plain``: within 1e-5 (f32) or 1e-2 (bf16) of the
    largest gradient."""
    from paddle_tpu_torch.ops.kernels.build import smoke_error, uncounted

    dev = torch.device("cuda", torch.cuda.current_device())
    errs = {}
    with uncounted(CE_READOUT_BWD):
        for (N, D, V), dt, path in _SMOKE_CASES:
            s, w, b, lab, scale = _smoke_inputs(N, D, V, dt, dev)
            _, lse, logits = ce_readout_fwd_plain(s, w, b, lab)
            args = (logits, s, w, lab, lse, scale)
            errs[path] = smoke_error(
                f"ce_readout_bwd {path}", ce_readout_bwd(*args),
                ce_readout_bwd_plain(*args),
                1e-2 if dt == torch.bfloat16 else 1e-5)
    return errs


CE_READOUT_FWD.smoke = _smoke_fwd
CE_READOUT_BWD.smoke = _smoke_bwd
