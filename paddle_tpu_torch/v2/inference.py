"""``paddle.infer`` — counterpart of ``paddle_tpu/v2/inference.py``
(python/paddle/v2/inference.py): run a trained topology on raw input rows,
on ``FLAGS.device``.

Not ported here: ``audit=True``, the reference's preflight of the jitted
inference closure through its jaxpr auditor (ROADMAP.md Queue 1 item 9);
it raises a ``ConfigError`` naming the item.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.nn.graph import LayerOutput, Topology
from paddle_tpu_torch.v2.parameters import Parameters, to_numpy
from paddle_tpu_torch.v2.trainer import _auto_feeder

__all__ = ["infer"]


def _tensors(arrays, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def infer(output_layer, parameters: Parameters, input: Sequence,
          feeding: Optional[Dict[str, int]] = None,
          field="value", audit: bool = False):
    """``paddle.infer(output_layer=out, parameters=params, input=rows)``.

    ``field`` selects what to take from each output layer, the reference's
    generation contract (python/paddle/v2/inference.py:117, field=['prob',
    'id'] for beam_search outputs): ``"value"``/``"id"`` the layer's value
    (the token ids of a beam_search layer), ``"prob"``/``"score"`` the
    scores in the layer's state (the beams' log-probabilities).  A list of
    fields gives a list back.

    ``input=[]`` replies with empty outputs of the right shapes: one pass
    of the plain versions on the CPU over a one-row synthetic feed gives
    the per-row shapes (the reference's ``jax.eval_shape``), so nothing
    runs on the card.  A row with fewer fields than the topology's input
    slots raises ``ValueError`` naming the missing slot."""
    if audit:
        from paddle_tpu_torch.utils.error import not_ported

        raise not_ported("paddle.infer(audit=True) (the decode audit of the "
                         "inference closure)", 9)
    from paddle_tpu_torch.utils.flags import FLAGS

    outputs = ([output_layer] if isinstance(output_layer, LayerOutput)
               else list(output_layer))
    rows = list(input)
    topo = Topology(outputs, device="cpu" if not rows else FLAGS.device)
    feeder = _auto_feeder(topo, feeding)
    _check_arity(topo, feeder, rows)
    fields_l = field if isinstance(field, (list, tuple)) else [field]
    need_state = any(f in ("prob", "score") for f in fields_l)

    def run(params, state, feed):
        outs, _ = topo.apply(params, state, feed, train=False)
        return [(outs[o.name].value,
                 (outs[o.name].state or {}) if need_state else {})
                for o in outputs]

    params = _tensors(parameters.params, topo.device)
    state = _tensors(parameters.state, topo.device)
    if not rows:
        from paddle_tpu_torch.nn.feeds import empty_outputs, example_feed

        pairs = empty_outputs(run, params, state,
                              example_feed(topo, batch=1))
        return _pick_fields(pairs, fields_l)
    with torch.no_grad():
        pairs = run(params, state, feeder(rows))
    return _pick_fields(pairs, fields_l)


def _check_arity(topo: Topology, feeder, rows) -> None:
    """Reject rows with fewer fields than the topology's input slots,
    naming the missing slot (else a bare IndexError inside the feeder)."""
    slots = sorted(feeder.feeding.items(), key=lambda kv: kv[1])
    for i, row in enumerate(rows):
        try:
            n = len(row)
        except TypeError:
            raise ValueError(
                f"input row {i} is not a sequence of per-slot fields "
                f"(got {type(row).__name__}); expected "
                f"{[name for name, _ in slots]}") from None
        missing = [name for name, idx in slots if idx >= n]
        if missing:
            raise ValueError(
                f"input row {i} has {n} field(s) but this topology feeds "
                f"{len(slots)} input slot(s) — missing {missing} "
                f"(feeding={dict(slots)})")


def _host(v):
    """A host copy; int64 (PyTorch's index type) as the reference's int32."""
    a = to_numpy(v)
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _pick_fields(pairs, fields_l):
    def pick(value, state, f):
        if f in ("value", "id"):
            return _host(value)
        if f in ("prob", "score"):
            for k in ("scores", "prob", "score"):
                if k in state:
                    return _host(state[k])
            raise KeyError(
                f"output layer has no auxiliary {f!r} field; state keys: "
                f"{sorted(state)}")
        raise KeyError(f"unknown field {f!r}; use value/id/prob/score")

    res = []
    for f in fields_l:
        got = [pick(v, s, f) for v, s in pairs]
        res.append(got[0] if len(got) == 1 else got)
    return res[0] if len(res) == 1 else res
