"""paddle_tpu_torch.nn — the layer DSL of the port (counterpart of
``paddle_tpu/nn``): the graph core, every layer of the reference's
``layers.py`` (dense, embedding, image, recurrent, sequence, elementwise
and cost layers), ``mixed`` with every projection and operator, the step
cells ``lstm_step`` and ``gru_step``, recurrent groups, ``beam_search``
generation, and every layer of the reference's ``layers_extra.py`` (the
CRF, CTC, NCE, the hierarchical sigmoid and the utility layers) and
``layers_extra2.py`` (``selective_fc``, ``mdlstmemory`` and the rest).
Sparse data layers (``data(sparse=...)``) feed ``fc`` and
``selective_fc``.

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
from paddle_tpu_torch.nn import layers as _layers
from paddle_tpu_torch.nn import layers_extra as _extra
from paddle_tpu_torch.nn import layers_extra2 as _extra2
from paddle_tpu_torch.nn import projections as _projections
from paddle_tpu_torch.nn.layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layers_extra import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layers_extra2 import *  # noqa: F401,F403
from paddle_tpu_torch.nn.projections import *  # noqa: F401,F403
from paddle_tpu_torch.nn.recurrent import (GeneratedInput, Memory,
                                           SequenceGenerator, StaticInput,
                                           beam_search, recurrent_group)
from paddle_tpu_torch.nn.steps import gru_step, lstm_step
from paddle_tpu_torch.param.convert import params_from_jax

__all__ = ["Act", "ApplyContext", "LayerOutput", "ParamAttr", "ParamSpec",
           "Topology", "device_pin", "naming_scope", "next_name",
           "reset_naming", *_layers.__all__, *_extra.__all__,
           *_extra2.__all__, *_projections.__all__, "lstm_step", "gru_step",
           "Memory", "StaticInput", "GeneratedInput", "recurrent_group",
           "beam_search", "SequenceGenerator", "params_from_jax"]
