"""``paddle.v2.layer`` — counterpart of ``paddle_tpu/v2/layer.py``: the
reference's layer namespace with its calling conventions
(python/paddle/v2/layer.py over trainer_config_helpers/layers.py):
activation objects, typed data layers, ``input=`` keyword everywhere.

The constructors are the port's layer DSL's own, as ``paddle_tpu_torch.nn``
exports them: the wrapped functions that record each call for config
serialization (``config/capture.py``), so a net built here serializes to
the same ModelConfig as one built with ``nn``.  ``data`` turns a
``paddle.data_type`` InputType into a data layer; the v2 trainer's
feeder reads the type back from the layer.
"""

from __future__ import annotations

from typing import Optional

import paddle_tpu_torch.nn as _nn
from paddle_tpu_torch.v2.data_type import InputType

# direct passthroughs under their reference names
fc = _nn.fc
embedding = _nn.embedding
img_conv = _nn.img_conv
img_pool = _nn.img_pool
batch_norm = _nn.batch_norm
img_cmrnorm = _nn.img_cmrnorm
maxout = _nn.maxout
bilinear_interp = _nn.bilinear_interp
lstmemory = _nn.lstmemory
grumemory = _nn.grumemory
recurrent = _nn.recurrent
bidirectional_rnn = _nn.bidirectional_rnn
pooling = _nn.pooling
last_seq = _nn.last_seq
first_seq = _nn.first_seq
expand = _nn.expand
concat = _nn.concat
seq_concat = _nn.seq_concat
seq_reshape = _nn.seq_reshape
addto = _nn.addto
dropout = _nn.dropout
mixed = _nn.mixed
full_matrix_projection = _nn.full_matrix_projection
trans_full_matrix_projection = _nn.trans_full_matrix_projection
table_projection = _nn.table_projection
identity_projection = _nn.identity_projection
dotmul_projection = _nn.dotmul_projection
scaling_projection = _nn.scaling_projection
conv_projection = _nn.conv_projection
dotmul_operator = _nn.dotmul_operator
conv_operator = _nn.conv_operator
cos_sim = _nn.cos_sim
interpolation = _nn.interpolation
power = _nn.power
scaling = _nn.scaling
slope_intercept = _nn.slope_intercept
sum_to_one_norm = _nn.sum_to_one_norm
tensor = _nn.tensor
maxid = _nn.maxid
eos = _nn.eos_trim
classification_cost = _nn.classification_cost
cross_entropy_cost = _nn.cross_entropy_cost
cross_entropy_with_selfnorm_cost = _nn.cross_entropy_with_selfnorm
multi_binary_label_cross_entropy_cost = _nn.multi_binary_label_cross_entropy
square_error_cost = _nn.mse_cost
mse_cost = _nn.mse_cost
huber_cost = _nn.huber_cost
smooth_l1_cost = _nn.smooth_l1_cost
rank_cost = _nn.rank_cost
lambda_cost = _nn.lambda_cost
sum_cost = _nn.sum_cost
crf = _nn.crf_cost
crf_decoding = _nn.crf_decoding
ctc = _nn.ctc_cost
warp_ctc = _nn.warp_ctc
nce = _nn.nce_cost
hsigmoid = _nn.hsigmoid_cost
multiplex = _nn.multiplex
pad = _nn.pad
rotate = _nn.rotate
block_expand = _nn.block_expand
sub_seq = _nn.sub_seq
sampling_id = _nn.sampling_id
# in the reference context_projection is a projection (inside mixed only,
# trainer_config_helpers/layers.py:608); the layer of that name stays
# nn.context_projection
context_projection = _nn.context_projection_input
prelu = _nn.prelu
trans = _nn.trans
resize = _nn.resize
data_norm = _nn.data_norm
conv_shift = _nn.conv_shift
linear_comb = _nn.linear_comb
convex_comb = _nn.convex_comb
get_output = _nn.get_output
selective_fc = _nn.selective_fc
spp = _nn.spp
priorbox = _nn.priorbox
img_conv_transpose = _nn.img_conv_transpose
mdlstmemory = _nn.mdlstmemory
recurrent_group = _nn.recurrent_group
memory = _nn.Memory
beam_search = _nn.beam_search
GeneratedInput = _nn.GeneratedInput
StaticInput = _nn.StaticInput


def data(name: str, type: Optional[InputType] = None, *, size: int = 0,
         height: Optional[int] = None, width: Optional[int] = None,
         **kw) -> "_nn.LayerOutput":
    """Typed data layer: ``paddle.layer.data("words",
    paddle.data_type.integer_value_sequence(V))``."""
    if type is not None:
        sparse = {"sparse_binary": "binary", "sparse_float": "float"}.get(type.kind)
        out = _nn.data(
            name,
            size=type.dim,
            is_seq=type.seq,
            dtype="int32" if type.kind == "int" else "float32",
            height=height, width=width,
            sparse=sparse,
        )
        out.meta["v2_type"] = type
        return out
    return _nn.data(name, size=size, height=height, width=width, **kw)
