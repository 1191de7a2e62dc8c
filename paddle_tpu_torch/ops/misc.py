"""Aggregate, top-k and other small ops — counterpart of
``paddle_tpu/ops/misc.py``: row/column reductions, top-k, batched
transpose, cosine similarity, interpolation, outer and bilinear tensor
products, scaling, power and dropout, each a short PyTorch expression as
the reference's is a short ``jnp`` one; and the random draws the sampling
layers make (``uniform_classes``: NCE's noise classes, ``categorical``:
``sampling_id``'s ids), each from an explicit ``torch.Generator`` as
``dropout``'s mask is.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops.numerics import dot_dtype, mxu_cast

__all__ = ["row_sum", "row_max", "row_min", "col_sum", "top_k", "max_id",
           "batch_transpose", "cos_sim", "interpolation", "outer_prod",
           "tensor_bilinear", "sum_cost", "scaling", "slope_intercept",
           "power_op", "dropout", "uniform_classes", "categorical"]


def row_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=-1)


def row_max(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(x, dim=-1)


def row_min(x: torch.Tensor) -> torch.Tensor:
    return torch.amin(x, dim=-1)


def col_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=0)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values and int32 indices of the k largest entries along the last
    axis, largest first."""
    v, i = torch.topk(x, k, dim=-1)
    return v, i.to(torch.int32)


def max_id(x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(x, dim=-1).to(torch.int32)


def batch_transpose(x: torch.Tensor) -> torch.Tensor:
    """[B, M, N] -> [B, N, M]."""
    return x.transpose(-1, -2)


def cos_sim(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0,
            eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity: [B, D], [B, D] -> [B]."""
    num = (a * b).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(
        b, dim=-1)
    return scale * num / torch.clamp(den, min=eps)


def interpolation(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """``w * a + (1 - w) * b`` with a per-row scalar w [B, 1]."""
    return w * a + (1.0 - w) * b


def outer_prod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M], [B, N] -> [B, M*N], the row-wise outer product."""
    return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)


def tensor_bilinear(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor
                    ) -> torch.Tensor:
    """out[n, k] = a[n] @ w[k] @ b[n] for w [K, Da, Db]: compute-dtype
    operands, float32 products and sums (every product of two bfloat16
    values is exact in float32)."""
    ac, bc, wc = (t.to(dot_dtype()) for t in mxu_cast(a, b, w))
    return torch.einsum("bi,kij,bj->bk", ac, wc, bc)


def sum_cost(x: torch.Tensor) -> torch.Tensor:
    return x.sum()


def scaling(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row scalar scaling [B, 1] * [B, D]."""
    return scale * x


def slope_intercept(x: torch.Tensor, slope: float = 1.0,
                    intercept: float = 0.0) -> torch.Tensor:
    return slope * x + intercept


def power_op(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row power ``x ** p`` with p [B, 1]."""
    return torch.pow(x, p)


def dropout(gen: torch.Generator, x: torch.Tensor, rate: float, *,
            train: bool) -> torch.Tensor:
    """Inverted dropout: ``x / keep`` where kept, 0 elsewhere, with ``keep
    = 1 - rate``; the identity out of training or at rate 0.

    ``gen`` is the ``torch.Generator`` that ``ApplyContext.next_rng`` hands
    out, a CPU one.  A CPU generator cannot draw a CUDA tensor, and drawing
    the mask on the CPU would copy it across every step, so the mask is
    drawn on ``x``'s device from a generator there, seeded from ``gen``.
    The masks are not the reference's numbers (``jax.random`` draws
    differently), nor the same on the card as on the CPU for one seed."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=_device_generator(gen, x.device),
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _device_generator(gen: torch.Generator,
                      device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``gen``: a CPU generator
    cannot draw a CUDA tensor."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


def uniform_classes(gen: torch.Generator, shape, num_classes: int,
                    device) -> torch.Tensor:
    """int64 class ids of ``shape``, uniform over [0, num_classes), drawn
    on ``device`` (the reference's ``jax.random.randint``; other
    numbers)."""
    device = torch.device(device)
    return torch.randint(0, num_classes, tuple(shape), device=device,
                         generator=_device_generator(gen, device))


def categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One id a row of ``logits`` [..., C], drawn from ``softmax(logits)``
    (the reference's ``jax.random.categorical``, which takes logits; other
    numbers): the Gumbel-max draw ``argmax(logits + g)`` with ``g =
    -log(-log(u))``, u uniform in (0, 1), on ``logits``' device.  int64."""
    u = torch.rand(logits.shape, device=logits.device,
                   generator=_device_generator(gen, logits.device))
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits.float() + g, dim=-1)
