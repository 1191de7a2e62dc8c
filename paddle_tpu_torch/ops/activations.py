"""Activation functions — counterpart of ``paddle_tpu/ops/activations.py``
for the names this slice reaches."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

__all__ = ["ACTIVATIONS", "get_activation", "sigmoid", "tanh"]


def linear(x: torch.Tensor) -> torch.Tensor:
    return x


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": linear, "sigmoid": sigmoid, "tanh": tanh}


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
