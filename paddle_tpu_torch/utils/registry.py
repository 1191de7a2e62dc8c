"""Class/function registries — the port's own copy of the framework-free
``paddle_tpu/utils/registry.py`` (the reference's ClassRegistrar analog).

The reference registers layers, data providers, evaluators and activations by
name into static registries (reference: paddle/utils/ClassRegistrar.h;
REGISTER_LAYER in paddle/gserver/layers/Layer.h:31-37).  Here a `Registry` maps
string keys to factories; decorators register at import time.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

__all__ = ["Registry"]

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._items:
                raise ValueError(f"{self.kind} {name!r} already registered")
            self._items[name] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        try:
            return self._items[name]
        except KeyError:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._items))

    def names(self) -> list:
        return sorted(self._items)
