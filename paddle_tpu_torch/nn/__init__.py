"""paddle_tpu_torch.nn — the layer DSL of the port (counterpart of
``paddle_tpu/nn``): the graph core and the layers of the text-classification
benchmark net.

    nn.reset_naming()
    words = nn.data("words", size=30000, is_seq=True, dtype="int32")
    ...
    topo = nn.Topology(cost)                 # device="cuda" by default
    params, state = topo.init(seed)          # or params_from_jax(jax_params)
    outs, _ = topo.apply(params, state, feed, train=True)
    loss = outs[cost.name].value
"""

from paddle_tpu_torch.nn.graph import (Act, ApplyContext, LayerOutput,
                                       ParamAttr, ParamSpec, Topology,
                                       device_pin, naming_scope, next_name,
                                       reset_naming)
from paddle_tpu_torch.nn.layers import (classification_cost, data,
                                        embedding, fc, lstmemory, pooling)
from paddle_tpu_torch.param.convert import params_from_jax

__all__ = ["Act", "ApplyContext", "LayerOutput", "ParamAttr", "ParamSpec",
           "Topology", "device_pin", "naming_scope", "next_name",
           "reset_naming", "data", "fc", "embedding", "lstmemory", "pooling",
           "classification_cost", "params_from_jax"]
