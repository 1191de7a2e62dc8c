"""``paddle.v2.topology`` — counterpart of ``paddle_tpu/v2/topology.py``
(python/paddle/v2/topology.py): ``Topology`` wraps the output layers and
gives the serialized model proto, layer lookup, the data layers and their
feeder kinds."""

from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch.nn.graph import LayerOutput
from paddle_tpu_torch.nn.graph import Topology as _NnTopology

__all__ = ["Topology"]


class Topology:
    """The whole network reachable from ``layers`` (and ``extra_layers``,
    e.g. evaluator inputs that are no costs), on ``FLAGS.device``."""

    def __init__(self, layers, extra_layers=None):
        from paddle_tpu_torch.utils.flags import FLAGS

        def check(ls):
            ls = [ls] if isinstance(ls, LayerOutput) else list(ls)
            for l in ls:
                if not isinstance(l, LayerOutput):
                    raise ValueError(
                        f"Topology expects LayerOutput(s), got "
                        f"{type(l).__name__}")
            return ls

        self.layers = check(layers)
        extra = check(extra_layers) if extra_layers is not None else []
        self._topology = _NnTopology(self.layers + extra,
                                     device=FLAGS.device)

    @property
    def nn_topology(self) -> _NnTopology:
        """The layer DSL's graph underneath."""
        return self._topology

    def proto(self):
        """The serialized ModelConfig (reference Topology.proto()), through
        the port's ``dump_model_config``."""
        from paddle_tpu_torch.config import dump_model_config

        return dump_model_config(self._topology)

    def get_layer(self, name: str) -> Optional[LayerOutput]:
        for l in self._topology.layers:
            if l.name == name:
                return l
        return None

    def data_layers(self) -> Sequence[LayerOutput]:
        return list(self._topology.data_layers)

    def data_type(self):
        """[(name, kind)] for every data layer in graph order, the kinds
        the DataFeeder takes (the v2 trainer's feeder derives them the same
        way)."""
        from paddle_tpu_torch.data.feeder import feeder_kind_for_layer

        return [(l.name, feeder_kind_for_layer(l)) for l in self.data_layers()]
