"""``paddle.v2.dataset`` — counterpart of ``paddle_tpu/v2/dataset.py``: a
module per dataset with ``train()``/``test()`` reader creators over the
port's synthetic streams (``data/datasets.py``)."""

from __future__ import annotations

import types as _types

from paddle_tpu_torch.data import datasets as _ds

__all__ = ["mnist", "cifar", "imdb", "imikolov", "movielens", "conll05",
           "sentiment", "uci_housing", "wmt14"]


def _module(name: str, loader, **default_kw) -> _types.ModuleType:
    m = _types.ModuleType(f"paddle_tpu_torch.v2.dataset.{name}")
    m.train = lambda **kw: loader("train", **{**default_kw, **kw})
    m.test = lambda **kw: loader("test", **{**default_kw, **kw})
    return m


mnist = _module("mnist", _ds.mnist)
cifar = _module("cifar", _ds.cifar10)
imdb = _module("imdb", _ds.imdb)
imikolov = _module("imikolov", _ds.imikolov)
movielens = _module("movielens", _ds.movielens)
conll05 = _module("conll05", _ds.conll05)
sentiment = _module("sentiment", _ds.sentiment)
uci_housing = _module("uci_housing", _ds.uci_housing)
wmt14 = _module("wmt14", _ds.wmt14)
