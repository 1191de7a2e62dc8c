"""paddle_tpu_torch.nn — the layer DSL of the port (counterpart of
``paddle_tpu/nn``): the graph core, the layers of the text-classification
benchmark net and of the seqToseq generation net, ``mixed`` with
``full_matrix_projection``, ``gru_step``, recurrent groups,
``beam_search`` generation and the image layers (``img_conv``,
``img_pool``, ``batch_norm``, ``img_cmrnorm``, ``maxout``,
``bilinear_interp``, ``addto``, ``dropout``, ``slice_channels``,
``img_conv_transpose``).  The other layers of the reference's
``layers_extra.py`` and ``layers_extra2.py`` are here under their names
and raise ``ConfigError`` when called.

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
from paddle_tpu_torch.nn.layers import (addto, batch_norm, bilinear_interp,
                                        classification_cost, concat, data,
                                        dropout, embedding, fc, first_seq,
                                        grumemory, img_cmrnorm, img_conv,
                                        img_pool, last_seq, lstmemory,
                                        maxout, pooling)
from paddle_tpu_torch.nn import layers_extra as _extra
from paddle_tpu_torch.nn import layers_extra2 as _extra2
# slice_channels, img_conv_transpose and the not-ported names
from paddle_tpu_torch.nn.layers_extra import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layers_extra2 import *  # noqa: F401,F403
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
           "params_from_jax", "addto", "dropout", "img_conv", "img_pool",
           "batch_norm", "img_cmrnorm", "maxout", "bilinear_interp",
           *_extra.__all__, *_extra2.__all__]
