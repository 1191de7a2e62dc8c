"""paddle_tpu_torch.nn — the layer DSL of the port (counterpart of
``paddle_tpu/nn``): the graph core, the layers of the text-classification
benchmark net and of the seqToseq generation net, ``mixed`` with
``full_matrix_projection``, ``gru_step``, recurrent groups and
``beam_search`` generation.

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
from paddle_tpu_torch.nn.layers import (classification_cost, concat, data,
                                        embedding, fc, first_seq, grumemory,
                                        last_seq, lstmemory, pooling)
from paddle_tpu_torch.nn.projections import full_matrix_projection, mixed
from paddle_tpu_torch.nn.recurrent import (GeneratedInput, Memory,
                                           SequenceGenerator, StaticInput,
                                           beam_search, recurrent_group)
from paddle_tpu_torch.nn.steps import gru_step
from paddle_tpu_torch.param.convert import params_from_jax

__all__ = ["Act", "ApplyContext", "LayerOutput", "ParamAttr", "ParamSpec",
           "Topology", "device_pin", "naming_scope", "next_name",
           "reset_naming", "data", "fc", "embedding", "concat", "lstmemory",
           "grumemory", "pooling", "last_seq", "first_seq",
           "classification_cost", "mixed", "full_matrix_projection",
           "gru_step", "Memory", "StaticInput", "GeneratedInput",
           "recurrent_group", "beam_search", "SequenceGenerator",
           "params_from_jax"]
