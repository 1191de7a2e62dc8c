"""Activation functions — counterpart of ``paddle_tpu/ops/activations.py``:
the reference's registry of elementwise activations, each a plain PyTorch
function (no kernel tier of their own, as in the reference).

The transcendental ones (``sigmoid``, ``tanh``, ``stanh``, ``softrelu``,
``exponential``, ``log``, ``sqrt``) run through ``numerics.pointwise``, so
an element's bits on the CPU do not depend on the tensor's size (the slot
table's batch invariance).  ``softmax`` takes its statistics in float32
and returns the caller's dtype, as the reference does.  ``sequence_softmax``
is not ported here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from paddle_tpu_torch.ops.numerics import pointwise

__all__ = ["ACTIVATIONS", "get_activation", "sigmoid", "tanh", "relu",
           "softmax"]


def linear(x: torch.Tensor) -> torch.Tensor:
    return x


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return pointwise(torch.sigmoid, x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return pointwise(torch.tanh, x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def brelu(x: torch.Tensor, t_min: float = 0.0, t_max: float = 24.0
          ) -> torch.Tensor:
    """Bounded relu (the reference's default bound 24)."""
    return torch.clamp(x, t_min, t_max)


def stanh(x: torch.Tensor, a: float = 1.7159, b: float = 2.0 / 3.0
          ) -> torch.Tensor:
    """Scaled tanh ``a * tanh(b * x)``."""
    return a * pointwise(torch.tanh, b * x)


def softrelu(x: torch.Tensor, threshold: float = 40.0) -> torch.Tensor:
    """``log(1 + exp(x))`` on ``x`` clipped to ``[-threshold, threshold]``."""
    return pointwise(lambda v: torch.log1p(torch.exp(v)),
                     torch.clamp(x, -threshold, threshold))


def exponential(x: torch.Tensor) -> torch.Tensor:
    return pointwise(torch.exp, x)


def log_act(x: torch.Tensor) -> torch.Tensor:
    return pointwise(torch.log, x)


def abs_act(x: torch.Tensor) -> torch.Tensor:
    return torch.abs(x)


def square(x: torch.Tensor) -> torch.Tensor:
    return torch.square(x)


def sqrt_act(x: torch.Tensor) -> torch.Tensor:
    return pointwise(torch.sqrt, x)


def reciprocal(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / x


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Softmax with float32 statistics, returned in the caller's dtype."""
    return torch.softmax(x.float(), dim=axis).to(x.dtype)


ACTIVATIONS: Dict[str, Callable[..., torch.Tensor]] = {
    "linear": linear, "sigmoid": sigmoid, "tanh": tanh, "relu": relu,
    "brelu": brelu, "stanh": stanh, "softrelu": softrelu,
    "exponential": exponential, "log": log_act, "abs": abs_act,
    "square": square, "sqrt": sqrt_act, "reciprocal": reciprocal,
    "softmax": softmax}


def get_activation(name: Optional[Union[str, Callable]]):
    """Resolve an activation by name; None / '' / 'linear' -> identity."""
    if name is None or name == "":
        return linear
    if callable(name):
        return name
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise KeyError(f"unknown activation {name!r}; known: "
                       f"{sorted(ACTIVATIONS)}") from None
