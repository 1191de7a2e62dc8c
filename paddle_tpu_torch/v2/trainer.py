"""``paddle.v2.trainer.SGD`` — counterpart of ``paddle_tpu/v2/trainer.py``
(python/paddle/v2/trainer.py:30-175): ``SGD(cost=, parameters=,
update_equation=)`` over the port's ``SGDTrainer`` on ``FLAGS.device``.

The user's ``Parameters`` are copied by value into the trainer's own
tensors, so the optimizer's slots and the pruning masks refer to the
tensors that train; after ``train`` (also when it raises) the trained
values are copied back into the ``Parameters``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.data.feeder import DataFeeder, feeder_kind_for_layer
from paddle_tpu_torch.nn.graph import LayerOutput
from paddle_tpu_torch.trainer.trainer import SGDTrainer
from paddle_tpu_torch.v2.parameters import Parameters, to_numpy

__all__ = ["SGD"]


def _auto_feeder(topology, feeding: Optional[Dict[str, int]]):
    types = {l.name: feeder_kind_for_layer(l) for l in topology.data_layers}
    return DataFeeder(types, feeding)


@torch.no_grad()
def _adopt(dst: Dict[str, torch.Tensor], src: Dict[str, np.ndarray]) -> None:
    for name, arr in src.items():
        if name in dst:
            t = dst[name]
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype))


class SGD:
    """v2 signature: SGD(cost, parameters, update_equation, extra_layers).
    Other keywords go to ``SGDTrainer``; its ``device`` defaults to
    ``FLAGS.device``."""

    def __init__(self, cost, parameters: Parameters, update_equation,
                 extra_layers: Sequence[LayerOutput] = (), **kw):
        from paddle_tpu_torch.utils.flags import FLAGS

        kw.setdefault("device", FLAGS.device)
        self._parameters = parameters
        self._trainer = SGDTrainer(cost, update_equation,
                                   extra_outputs=list(extra_layers), **kw)
        # the Parameters passed in are the values the trainer starts from
        _adopt(self._trainer.params, parameters.params)
        _adopt(self._trainer.state, parameters.state)
        # pruning masks from the adopted values, not the discarded init
        # (ParameterUpdaterHook.cpp:36-78)
        self._trainer.rebuild_masks()

    def _sync_back(self) -> None:
        for group, src in ((self._parameters.params, self._trainer.params),
                           (self._parameters.state, self._trainer.state)):
            for name in group:
                if name in src:
                    group[name] = to_numpy(src[name])

    def train(self, reader: Callable, *, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None) -> None:
        feeder = _auto_feeder(self._trainer.topology, feeding)

        def handler(ev):
            if event_handler:
                event_handler(ev)

        try:
            self._trainer.train(reader, num_passes=num_passes,
                                event_handler=handler, feeder=feeder)
        finally:
            self._sync_back()

    def test(self, reader: Callable,
             feeding: Optional[Dict[str, int]] = None) -> Dict[str, float]:
        feeder = _auto_feeder(self._trainer.topology, feeding)
        return self._trainer.test(reader, feeder=feeder)

    def save_parameter_to_tar(self, f) -> None:
        self._sync_back()
        self._parameters.to_tar(f)
