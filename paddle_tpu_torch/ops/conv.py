"""Convolution, pooling and normalization — counterpart of
``paddle_tpu/ops/conv.py``.

Layout.  Activations stay NHWC ``[B, H, W, C]`` and conv weights HWIO
``[kh, kw, Cin/groups, Cout]``, as the reference stores them, so a JAX
parameter dict and either package's checkpoints carry across unchanged.
Each op views its NHWC input as PyTorch's NCHW with ``x.permute(0, 3, 1,
2)`` (a ``channels_last`` tensor, which cuDNN takes without a copy), turns
an HWIO weight into OIHW with ``w.permute(3, 2, 0, 1)``, and returns NHWC.

Padding.  The reference's ``SAME`` is XLA's rule, for convs and pools
alike: ``total = max((ceil(in / s) - 1) * s + k_eff - in, 0)`` padded
``total // 2`` before and the rest after, which is asymmetric whenever
``total`` is odd.  PyTorch's ``padding="same"`` takes stride 1 only and
its pools pad symmetrically, so every op here resolves its padding to
explicit (before, after) pairs: the symmetric part goes to the op's own
``padding`` argument where the op allows it, the rest through ``F.pad``
(zeros for conv and avg-pool, ``-inf`` for max-pool), and the op runs
VALID over it.  PyTorch's ``ceil_mode`` and ``count_include_pad`` are not
used: the reference's ceil mode is extra bottom/right padding chosen by
the layer (``nn/layers.py::img_pool``), and its average divides by the
count of in-bounds taps.

The reference rewrites strided convs of <= 4 input channels as
space-to-depth + a stride-1 conv (``_space_to_depth_conv``), a layout
trick for the TPU's 128-lane matrix unit that computes the identical
convolution; the port runs the plain conv for every shape.

None of these is a hand-written kernel: the reference computes them with
``lax.conv_general_dilated``, ``lax.conv_transpose``, ``lax.reduce_window``
and plain ``jnp``, outside any Pallas kernel, so the port uses PyTorch's
own ops (cuDNN on the card).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.numerics import acc_dtype, mxu_cast, pointwise

__all__ = ["conv2d", "conv2d_transpose", "max_pool2d", "avg_pool2d",
           "batch_norm", "cmr_norm", "bilinear_interp", "maxout",
           "global_avg_pool"]

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
PaddingLike = Union[str, Sequence[Sequence[int]]]


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: the odd pixel goes after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _resolve_pads(padding: PaddingLike, hw: Tuple[int, int],
                  window: Tuple[int, int], stride: Tuple[int, int]) -> Pads:
    """A padding spec ('SAME', 'VALID', ((lo, hi), (lo, hi)) over H and W,
    or the four NHWC pairs ``lax.reduce_window`` takes) as two int pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding == "SAME":
            return tuple(_same_pads(n, k, s)
                         for n, k, s in zip(hw, window, stride))
        raise ValueError(f"padding must be 'SAME', 'VALID' or pairs, got "
                         f"{padding!r}")
    pairs = [tuple(int(v) for v in p) for p in padding]
    if len(pairs) == 4:  # NHWC pairs: the batch and channel ones are zero
        if pairs[0] != (0, 0) or pairs[3] != (0, 0):
            raise ValueError(f"only spatial padding is supported, got "
                             f"{padding!r}")
        pairs = pairs[1:3]
    return pairs[0], pairs[1]


def _split_pads(pads: Pads, limit: Tuple[int, int]):
    """-> (the symmetric part an op pads itself, capped at ``limit``, and
    the rest as an ``F.pad`` spec over NCHW's last two dims, or None)."""
    sym = tuple(min(lo, hi, cap) for (lo, hi), cap in zip(pads, limit))
    rest = (pads[1][0] - sym[1], pads[1][1] - sym[1],
            pads[0][0] - sym[0], pads[0][1] - sym[0])
    return sym, (rest if any(rest) else None)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor: ``channels_last`` on the card.  On
    the CPU it is made contiguous, because PyTorch's CPU convolution on
    ``channels_last`` float32 input rounds about ten times coarser than on
    contiguous input (measured against float64), which a batch norm over
    few samples amplifies (VGG's gradients at B = 2 moved by up to 1e-1 of
    their largest entry).  A copy paid only on the CPU."""
    y = x.permute(0, 3, 1, 2)
    return y.contiguous() if y.device.type == "cpu" else y


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
           padding: PaddingLike = "SAME", dilation=(1, 1), groups: int = 1
           ) -> torch.Tensor:
    """NHWC conv: x [B, H, W, Cin], w [kh, kw, Cin/groups, Cout] -> [B, H',
    W', Cout].  Operands and output stay in the compute dtype, as the
    reference keeps them (``mxu_cast``; cuDNN accumulates in float32); under
    the float32 policy the card computes real float32 (TF32 is off,
    ``device.resolve_device``)."""
    x, w = mxu_cast(x, w)
    s, d = tuple(stride), tuple(dilation)
    k_eff = tuple((k - 1) * dd + 1 for k, dd in zip(w.shape[:2], d))
    pads = _resolve_pads(padding, tuple(x.shape[1:3]), k_eff, s)
    sym, rest = _split_pads(pads, (1 << 30, 1 << 30))
    xn = _nchw(x)
    if rest is not None:
        xn = F.pad(xn, rest)
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=s, padding=sym,
                 dilation=d, groups=groups)
    return _nhwc(y)


def _transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding of the stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return pad_a, pad_len - pad_a


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                     padding: str = "SAME") -> torch.Tensor:
    """Transposed NHWC conv (the reference's ``lax.conv_transpose`` with
    its default ``transpose_kernel=False``): x [B, H, W, Cin], w [kh, kw,
    Cin, Cout] -> [B, H*s, W*s, Cout] for SAME.

    That is a fractionally strided conv with the HWIO kernel NOT flipped:
    the input dilated by the stride, padded by ``_transpose_pads`` and
    cross-correlated with ``w``.  ``F.conv_transpose2d`` is instead the
    adjoint of ``conv2d``, which flips the kernel spatially and swaps its
    in/out axes; so it is given the kernel pre-flipped, as ``[Cin, Cout,
    kh, kw]``, and ``padding = k - 1 - pad_before``, ``output_padding =
    pad_after - pad_before`` (a negative one, where SAME pads one less
    after than before, is cropped off the result)."""
    x, w = mxu_cast(x, w)
    pads = [_transpose_pads(k, s, padding)
            for k, s in zip(w.shape[:2], stride)]
    pad = tuple(k - 1 - a for k, (a, _) in zip(w.shape[:2], pads))
    extra = [b - a for a, b in pads]
    y = F.conv_transpose2d(
        _nchw(x), w.flip(0, 1).permute(2, 3, 0, 1), stride=tuple(stride),
        padding=pad, output_padding=tuple(max(e, 0) for e in extra))
    crop_h, crop_w = (min(e, 0) for e in extra)
    if crop_h or crop_w:
        y = y[:, :, :y.shape[2] + crop_h, :y.shape[3] + crop_w]
    return _nhwc(y)


def max_pool2d(x: torch.Tensor, window=(2, 2), stride=None,
               padding: PaddingLike = "VALID") -> torch.Tensor:
    """Max pooling, NHWC; padded taps are ``-inf``."""
    window = tuple(window)
    stride = tuple(stride or window)
    pads = _resolve_pads(padding, tuple(x.shape[1:3]), window, stride)
    # F.max_pool2d pads with -inf itself, up to half the window
    sym, rest = _split_pads(pads, tuple(k // 2 for k in window))
    xn = _nchw(x)
    if rest is not None:
        xn = F.pad(xn, rest, value=float("-inf"))
    return _nhwc(F.max_pool2d(xn, window, stride, padding=sym))


def avg_pool2d(x: torch.Tensor, window=(2, 2), stride=None,
               padding: PaddingLike = "VALID") -> torch.Tensor:
    """Average pooling, NHWC: the window's sum over zero-padded input
    divided by the count of its in-bounds taps (the reference's pooled
    ones map; cuDNN's include-padding=false)."""
    window = tuple(window)
    stride = tuple(stride or window)
    pads = _resolve_pads(padding, tuple(x.shape[1:3]), window, stride)
    spec = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])

    def window_sum(t: torch.Tensor) -> torch.Tensor:
        if any(spec):
            t = F.pad(t, spec)
        return F.avg_pool2d(t, window, stride, divisor_override=1)

    total = window_sum(_nchw(x))
    ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype,
                      device=x.device)
    return _nhwc(total / window_sum(ones))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool, momentum: float = 0.9, eps: float = 1e-5):
    """Batch norm over every axis but the last (channels) -> (y,
    new_running_mean, new_running_var).

    Not ``F.batch_norm``: the statistics are float32 even for bfloat16
    activations, the variance is the biased one (``jnp.var``), and the
    running stats move as ``momentum * running + (1 - momentum) * batch``
    with ``momentum = 0.9`` (PyTorch's momentum weighs the batch, and its
    running variance is the unbiased one).  ``y`` is cast back to
    ``x.dtype``.  Out of training the running stats normalise and come
    back unchanged; the layer writes them into the state only when
    training."""
    axes = tuple(range(x.dim() - 1))
    if train:
        xf = x.to(acc_dtype())
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, correction=0)
        new_mean = momentum * running_mean + (1.0 - momentum) * mean
        new_var = momentum * running_var + (1.0 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    y = (x - mean) * inv * scale + bias
    return y.to(x.dtype), new_mean, new_var


def cmr_norm(x: torch.Tensor, *, size: int = 5, scale: float = 1e-4,
             power: float = 0.75) -> torch.Tensor:
    """Cross-map response normalisation (AlexNet's LRN), NHWC: each value
    over ``(1 + scale * sum of squares over `size` adjacent channels) **
    power``.  The denominator is float32, as the reference takes it: near
    1.0 a bfloat16 step is ~4e-3, which would round the ``1e-4 * acc``
    correction away."""
    half = size // 2
    sq = torch.square(x.to(acc_dtype()))
    acc = F.pad(sq, (half, half)).unfold(-1, size, 1).sum(dim=-1)
    denom = pointwise(lambda t: torch.pow(t, power), 1.0 + scale * acc)
    return (x / denom).to(x.dtype)


def bilinear_interp(x: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Bilinear resize, NHWC, as ``jax.image.resize(method="bilinear")``:
    half-pixel centres, and when downsampling the triangle kernel widened
    by the scale (antialiasing), its weights normalised over the in-bounds
    taps.  ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=True)`` at ``size=(out_h, out_w)`` computes exactly that."""
    y = F.interpolate(_nchw(x), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    return _nhwc(y).to(x.dtype)


def maxout(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Maxout over channel groups, NHWC: [B, H, W, C] -> [B, H, W,
    C/groups], the max over each run of ``groups`` adjacent channels."""
    B, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"channels ({C}) must divide into maxout groups "
                         f"({groups})")
    return torch.amax(x.reshape(B, H, W, C // groups, groups), dim=-1)
