"""Synthetic feeds derived from a Topology's input specs — counterpart of
``paddle_tpu/nn/feeds.py``.

A pure Topology utility of the nn tier, re-exported for serving as
``paddle_tpu_torch.serving.feeds``.  Serving needs a feed before it has
seen real traffic: a warm-up pass over every batch bucket before the
server reports ready, and the correctly shaped empty reply to an
empty-input request (``empty_outputs``: the outputs of a one-row
synthetic feed with the batch dimension zeroed).

Every data-layer kind the feeder produces is covered (dense, int, image
NHWC, sequences, nested, sparse COO), built from the layer's ``size``,
``data_spec`` and ``meta['hw']`` alone.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["example_feed", "zero_batch_like", "empty_outputs"]


def example_feed(topology, *, batch: int = 1, seq_len: int = 8,
                 nnz: int = 4, rng=None) -> Dict[str, Any]:
    """A valid all-zeros feed for every data layer of ``topology``.

    Token ids are 0 (always in-vocab), lengths are full (no masking edge
    cases at trace time), sparse bags carry one feature per row.

    With ``rng`` (a ``np.random.RandomState``) float values and token ids
    randomize (ids stay in-vocab, lengths stay full): a feed that
    exercises real embedding rows and activation ranges."""
    feed: Dict[str, Any] = {}
    B, T = int(batch), int(seq_len)

    def fill_f(shape):
        if rng is None:
            return np.zeros(shape, np.float32)
        return (rng.randn(*shape) * 0.5).astype(np.float32)

    def fill_i(shape, hi):
        if rng is None:
            return np.zeros(shape, np.int32)
        return rng.randint(0, max(2, int(hi)), shape).astype(np.int32)

    for layer in topology.data_layers:
        spec = layer.data_spec or {}
        size = max(int(layer.size), 1)
        is_int = spec.get("dtype") == "int32"
        sparse = spec.get("sparse")
        if sparse and spec.get("is_seq"):
            ids = fill_i((B, T, nnz), size)
            bag = np.ones((B, T), np.int32)
            lens = np.full((B,), T, np.int32)
            if sparse == "float":
                feed[layer.name] = (ids, fill_f((B, T, nnz)),
                                    bag, lens)
            else:
                feed[layer.name] = (ids, bag, lens)
        elif sparse:
            ids = fill_i((B, nnz), size)
            bag = np.ones((B,), np.int32)
            if sparse == "float":
                feed[layer.name] = (ids, fill_f((B, nnz)), bag)
            else:
                feed[layer.name] = (ids, bag)
        elif spec.get("nested"):
            To = Ti = max(2, min(T, 4))
            if is_int:
                value = fill_i((B, To, Ti), size)
            else:
                value = fill_f((B, To, Ti, size))
            outer = np.full((B,), To, np.int32)
            sub = np.full((B, To), Ti, np.int32)
            feed[layer.name] = (value, outer, sub)
        elif spec.get("is_seq"):
            if is_int:
                value = fill_i((B, T), size)
            else:
                value = fill_f((B, T, size))
            feed[layer.name] = (value, np.full((B,), T, np.int32))
        elif is_int:
            feed[layer.name] = fill_i((B, 1), size)
        elif layer.meta.get("hw"):
            h, w = layer.meta["hw"]
            feed[layer.name] = fill_f((B, h, w, size))
        else:
            feed[layer.name] = fill_f((B, size))
    return feed


def zero_batch_like(feed: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild a zero-row feed as a ONE-row feed of the same per-row
    shapes (ints become ones — valid lengths/ids; floats become zeros), for
    ``empty_outputs``: a one-row run is well defined where a literal B=0
    one can hit degenerate reshapes."""
    def one_row(a):
        a = np.asarray(a)
        shape = (1,) + a.shape[1:]
        if a.dtype.kind in "iu":
            return np.ones(shape, a.dtype)
        return np.zeros(shape, a.dtype)

    return {k: (tuple(one_row(p) for p in v) if isinstance(v, tuple)
                else one_row(v))
            for k, v in feed.items()}


def empty_outputs(run_fn, params, state, feed_1row: Dict[str, Any]
                  ) -> Any:
    """Run ``run_fn(params, state, feed_1row)`` once under
    ``torch.no_grad()`` (the reference infers the shapes with
    ``jax.eval_shape``) and return its result with every array's leading
    (batch) dimension set to 0, as numpy: the correctly shaped empty reply
    to an empty-input request.  The result may nest dicts, lists and
    tuples of tensors or arrays."""
    import torch

    with torch.no_grad():
        out = run_fn(params, state, feed_1row)

    def zero(v):
        if isinstance(v, dict):
            return {k: zero(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(zero(x) for x in v)
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        shape = ((0,) + a.shape[1:]) if a.shape else a.shape
        return np.zeros(shape, a.dtype)

    return zero(out)
