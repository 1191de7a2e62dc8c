"""Record layer-constructor calls so a built Topology can be serialized —
counterpart of ``paddle_tpu/config/capture.py``.

``wrap_module`` wraps every public layer function of a module so each
``LayerOutput`` it returns carries ``meta['config'] = {fn, kwargs, call_id,
out}``: the constructor's name, the arguments the caller passed (bound to
the function's parameter names), a process-wide call number and the output
index (-1 for a single node).  ``config_parser`` serializes that record and
replays it to rebuild the graph.

The *innermost* wrapped call that returned a node wins: a composite helper
(``bidirectional_rnn``, ...) expands into primitive calls whose records the
nodes keep, as the reference's composites expand into primitive layer
protos.  A constructor that returns several nodes cannot have their names
forced on replay, so the rebuild relies on it regenerating the same
auto-names under fresh counters (``build_topology`` replays inside a
``naming_scope``).
"""

from __future__ import annotations

import functools
import inspect
import itertools
from typing import Any, Dict

__all__ = ["configurable", "wrap_module", "bound_arguments"]

_call_counter = itertools.count()


def bound_arguments(sig, args, kwargs) -> Dict[str, Any]:
    """The arguments a caller passed, by parameter name (``**kw``
    catch-alls flattened so a replay can pass them again)."""
    if not sig:
        return dict(kwargs)
    try:
        raw = dict(sig.bind(*args, **kwargs).arguments)
    except TypeError:
        return dict(kwargs)
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD and p.name in raw:
            raw.update(raw.pop(p.name))
    return raw


def configurable(fn):
    """Wrap a layer constructor so returned LayerOutputs carry their
    config."""
    sig = None

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # imported here: importing this module first must not re-enter the
        # nn package, whose layer modules import this one
        from paddle_tpu_torch.nn.graph import LayerOutput

        nonlocal sig
        out = fn(*args, **kwargs)
        call_id = next(_call_counter)
        if sig is None:
            try:
                sig = inspect.signature(fn)
            except (TypeError, ValueError):
                sig = False
        raw = bound_arguments(sig, args, kwargs)

        def attach(node, idx):
            if isinstance(node, LayerOutput) and "config" not in node.meta:
                node.meta["config"] = {"fn": fn.__name__, "kwargs": raw,
                                       "call_id": call_id, "out": idx}

        if isinstance(out, LayerOutput):
            attach(out, -1)
        elif isinstance(out, (tuple, list)):
            for i, o in enumerate(out):
                attach(o, i)
        return out

    wrapper.__wrapped_layer_fn__ = fn
    return wrapper


def wrap_module(namespace: Dict[str, Any], names) -> None:
    """Wrap every function in ``names`` inside a module's globals()."""
    for n in names:
        fn = namespace.get(n)
        if callable(fn) and not hasattr(fn, "__wrapped_layer_fn__"):
            namespace[n] = configurable(fn)
