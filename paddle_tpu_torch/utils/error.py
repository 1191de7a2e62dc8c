"""Errors and the layer stack named in them — the port's own copy of
``paddle_tpu/utils/error.py``.

While a topology is applied, layer names are pushed on a per-thread stack,
so an exception raised inside a layer names the layer responsible.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, List

__all__ = ["PaddleTpuError", "ConfigError", "ShapeError", "layer_scope",
           "not_ported"]


class PaddleTpuError(Exception):
    """Base for framework errors."""


class ConfigError(PaddleTpuError):
    """Bad model/layer configuration."""


class ShapeError(PaddleTpuError):
    """Shape/dtype mismatch when wiring or applying layers."""


def not_ported(what: str, item: int) -> ConfigError:
    """The error for a part of the reference the port does not have yet,
    naming the ROADMAP.md Queue 1 item that ports it."""
    return ConfigError(f"{what} is not ported to paddle_tpu_torch yet "
                       f"(ROADMAP.md, Queue 1 item {item})")


_tls = threading.local()


def _stack() -> List[str]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextmanager
def layer_scope(name: str) -> Iterator[None]:
    stack = _stack()
    stack.append(name)
    try:
        yield
    except PaddleTpuError:
        raise
    except Exception as e:
        path = " -> ".join(stack)
        raise PaddleTpuError(f"error in layer stack [{path}]: {e}") from e
    finally:
        stack.pop()
