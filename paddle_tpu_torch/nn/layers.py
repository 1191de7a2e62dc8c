"""User-facing layer functions — counterpart of ``paddle_tpu/nn/layers.py``,
every layer of it: the dense, embedding and image layers, the recurrent
layers (``lstmemory``, ``grumemory``, the Elman ``recurrent``,
``bidirectional_rnn``), the sequence layers (pooling, first/last step,
``expand``, ``seq_reverse``, ``seq_concat``, ``context_projection``), the
elementwise math layers, ``error_clip`` and the cost layers.

Each function returns a symbolic ``LayerOutput`` whose ``forward`` closure
computes the op with the port's ``ops``.  Names, arguments, parameter names
(``_{name}.w{i}``, ``_{name}.wbias``, ``_{name}.wx``,
``_{name}.check_{i,f,o}``, ``_{name}.moving_mean``/``moving_var``),
shapes and ``ParamAttr`` defaults follow the reference, so parameters
carry across from the JAX package by name.
Sequence activations are padded batches with a mask; ``embedding`` and a
sequence ``fc`` multiply their output by it.  A packed sequence input
(``--data_pack``) carries its segments in ``Act.state`` through every
per-position layer: the recurrent layers reset their carry at segment
entries, ``pooling``/``last_seq``/``first_seq`` reduce each segment (a
sequence over the segment axis), ``expand`` broadcasts back over the
segments and ``context_projection`` fences its window at their edges.  The
layers with no per-segment meaning (``seq_reverse``, ``seq_concat``) refuse
it.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Union

import torch

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (COST_NORM, PACK_KEYS, Act,
                                       LayerOutput, ParamAttr, ParamSpec,
                                       next_name)
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["data", "fc", "embedding", "addto", "concat", "dropout",
           "error_clip", "img_conv", "img_pool", "batch_norm", "img_cmrnorm",
           "maxout", "bilinear_interp", "lstmemory", "grumemory",
           "bidirectional_rnn", "recurrent", "pooling", "last_seq",
           "first_seq", "expand", "seq_reverse", "seq_concat",
           "context_projection", "maxid", "cos_sim", "interpolation",
           "outer_prod", "tensor", "scaling", "slope_intercept", "power",
           "sum_to_one_norm", "classification_cost", "cross_entropy_cost",
           "cross_entropy_with_selfnorm", "soft_cross_entropy_cost",
           "multi_binary_label_cross_entropy", "mse_cost", "huber_cost",
           "smooth_l1_cost", "rank_cost", "sum_cost"]

AttrLike = Union[ParamAttr, bool, None]


def _pa(attr: AttrLike, default_name: str, **defaults) -> ParamAttr:
    if isinstance(attr, ParamAttr):
        return attr if attr.name else replace(attr, name=default_name)
    return ParamAttr(name=default_name, **defaults)


def _bias_attr(bias: AttrLike, default_name: str) -> Optional[ParamAttr]:
    if bias is False or bias is None:
        return None
    if bias is True:
        return ParamAttr(name=default_name, init="zeros")
    pa = _pa(bias, default_name)
    return pa if bias.init else replace(pa, init="zeros")


def _pack_state(a: Act) -> dict:
    """The packing keys riding an Act (seg_ids, positions, seg_lengths);
    empty for an unpacked one."""
    return {k: a.state[k] for k in PACK_KEYS if k in a.state}


def _refuse_packed(a: Act, name: str, kind: str) -> None:
    """A layer that consumes the time axis whole and has no per-segment
    variant would mix packed neighbours' tokens: a wrong loss, not an
    error.  It calls this, so a packed run of such a topology fails at its
    first batch naming the layer."""
    if _pack_state(a):
        raise ConfigError(
            f"{kind} {name!r} does not support packed sequences "
            f"(--data_pack): it computes across the time axis and would "
            f"mix packed neighbors' tokens — feed this topology "
            f"unpacked, or use a pack-aware layer")


def _seq_like(parent: Act, value) -> Act:
    # the pack state rides every per-position layer unchanged, so a
    # segment-aware layer downstream (pooling, an RNN's reset) still sees it
    return Act(value=value, lengths=parent.lengths, mask=parent.mask,
               sub_lengths=parent.sub_lengths, state=_pack_state(parent))


def _segment_seq(value, seg_lengths) -> Act:
    """A per-segment result [B, S, ...] as a sequence over the segment
    axis, masked by the segments' validity."""
    valid = O.segment_valid(seg_lengths)
    return Act(value=value, mask=valid,
               lengths=valid.sum(1).to(torch.int32))


def _inherit_meta(node: LayerOutput, src: LayerOutput) -> LayerOutput:
    """Carry the spatial dims (``hw``) and the sparse kind through a
    pass-through layer."""
    for key in ("hw", "sparse"):
        if key in src.meta:
            node.meta[key] = src.meta[key]
    return node


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def data(name: str, *, size: int = 0, is_seq: bool = False,
         dtype: str = "float32", height: Optional[int] = None,
         width: Optional[int] = None, sparse: Optional[str] = None,
         nested: bool = False) -> LayerOutput:
    """Input layer.  For sequences feed (value [B, T, size] | ids [B, T],
    lengths [B]); for images pass height/width (feed NHWC [B, H, W, size]).
    For sparse features (``sparse='binary'|'float'``, the reference's
    sparse_binary_vector / sparse_float_vector) feed padded COO rows:
    (ids [B, N], nnz [B]) or (ids [B, N], weights [B, N], nnz [B]), a
    sequence of bags (ids [B, T, N], [weights,] nnz [B, T], lengths [B]);
    ``size`` is the full sparse dimension, and only sparse-aware layers
    (``fc``, ``selective_fc``) may consume it.  Nested sequences
    (``nested=True``, the reference's sub-sequence start positions) feed
    (value [B, To, Ti(, size)] | ids [B, To, Ti], outer_lengths [B],
    sub_lengths [B, To]); a recurrent group over them iterates over the
    sub-sequences."""
    if sparse not in (None, "binary", "float"):
        raise ConfigError(f"sparse must be 'binary' or 'float', got "
                          f"{sparse!r}")
    if nested and not is_seq:
        raise ConfigError("nested=True requires is_seq=True")
    meta = {}
    if height is not None:
        meta["hw"] = (height, width)
    if sparse:
        meta["sparse"] = sparse
    return LayerOutput(name=name, layer_type="data", size=size, parents=[],
                       forward=None, is_data=True,
                       data_spec={"dtype": dtype, "is_seq": is_seq,
                                  **({"sparse": sparse} if sparse else {}),
                                  **({"nested": True} if nested else {})},
                       meta=meta)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------


def _flat_in_size(ipt: LayerOutput) -> int:
    if "hw" in ipt.meta:
        h, w = ipt.meta["hw"]
        return h * w * ipt.size
    return ipt.size


def fc(input: Union[LayerOutput, Sequence[LayerOutput]], size: int, *,
       act: str = "tanh", name: Optional[str] = None,
       param_attr: AttrLike = None, bias_attr: AttrLike = True
       ) -> LayerOutput:
    """Fully-connected layer.  Several inputs get separate weight matrices,
    summed; a sequence input applies per timestep (output masked).  A
    sparse input is multiplied by row gather (``sparse_gather_matmul``); a
    sparse sequence takes its slots' validity from ``state['nnz_mask']``
    (its ``mask`` is the sequence mask)."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    name = name or next_name("fc")
    sparse_kinds = [ipt.meta.get("sparse") for ipt in inputs]
    specs = []
    for i, ipt in enumerate(inputs):
        pa = _pa(param_attr if len(inputs) == 1 else None, f"_{name}.w{i}")
        specs.append(ParamSpec(name=pa.name, shape=(_flat_in_size(ipt), size),
                               attr=pa))
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(size,), attr=ba))
    act_fn = O.get_activation(act)

    def forward(ctx, params, *acts: Act) -> Act:
        out = None
        for spec, a, sparse in zip(specs[:len(inputs)], acts, sparse_kinds):
            if sparse:
                y = O.sparse_gather_matmul(
                    a.value, a.state["weights"],
                    a.state.get("nnz_mask", a.mask), params[spec.name])
            else:
                v = a.value
                if not a.is_seq and v.dim() > 2:
                    v = v.reshape(v.shape[0], -1)
                y = O.linear(v, params[spec.name])
            out = y if out is None else out + y
        if ba:
            out = out + params[ba.name].to(out.dtype)
        out = act_fn(out)
        ref = acts[0]
        if ref.is_seq:
            return _seq_like(ref, out * ref.mask[..., None].to(out.dtype))
        return Act(value=out)

    return LayerOutput(name, "fc", size, inputs, forward, specs)


def embedding(input: LayerOutput, size: int, *,
              vocab_size: Optional[int] = None, name: Optional[str] = None,
              param_attr: AttrLike = None, padding_idx: Optional[int] = None,
              sparse_grad: bool = False) -> LayerOutput:
    """Embedding lookup.  ``input`` is an integer data layer; its ``size``
    is the vocabulary size unless ``vocab_size`` is given.
    ``sparse_grad=True`` (the ``ParamAttr(sparse_grad=True)`` sugar) marks
    the table row-sparse: ``SGDTrainer`` then holds the rows a batch did
    not touch, value and optimizer slots, at each update, and a trainer
    whose mesh carries the pserver axis routes the table through the
    pserver tier (its parameter is then a ``pserver.TableProxy``: sharded
    all-to-all lookup, gradients through the proxy rows)."""
    name = name or next_name("embedding")
    V = vocab_size or input.size
    pa = _pa(param_attr, f"_{name}.w0", initial_std=0.01, init="normal")
    if sparse_grad and not pa.sparse_grad:
        pa = replace(pa, sparse_grad=True)
    spec = ParamSpec(name=pa.name, shape=(V, size), attr=pa)

    def forward(ctx, params, a: Act) -> Act:
        ids = a.value
        if not a.is_seq and ids.dim() == 2 and ids.shape[1] == 1:
            # a non-seq int slot feeds as [B, 1]; its embedding is [B, D]
            ids = ids[:, 0]
        table = params[spec.name]
        if hasattr(table, "pserver_lookup"):
            out = table.pserver_lookup(ids, layer=name,
                                       pad_to_zero_id=padding_idx)
        else:
            out = O.embedding_lookup(table, ids, pad_to_zero_id=padding_idx)
        if a.is_seq:
            return _seq_like(a, out * a.mask[..., None].to(out.dtype))
        return Act(value=out)

    return LayerOutput(name, "embedding", size, [input], forward, [spec])


def addto(input: Sequence[LayerOutput], *, act: str = "linear",
          name: Optional[str] = None, bias_attr: AttrLike = False
          ) -> LayerOutput:
    """Elementwise sum of the inputs (+ an optional bias), then ``act``;
    keeps the first input's spatial dims and sequence lengths."""
    inputs = list(input)
    name = name or next_name("addto")
    size = inputs[0].size
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    specs = [ParamSpec(name=ba.name, shape=(size,), attr=ba)] if ba else []
    act_fn = O.get_activation(act)

    def forward(ctx, params, *acts: Act) -> Act:
        out = acts[0].value
        for a in acts[1:]:
            out = out + a.value
        if ba:
            out = out + params[ba.name].to(out.dtype)
        out = act_fn(out)
        ref = acts[0]
        return _seq_like(ref, out) if ref.is_seq else Act(value=out)

    return _inherit_meta(LayerOutput(name, "addto", size, inputs, forward,
                                     specs), inputs[0])


def concat(input: Sequence[LayerOutput], *,
           name: Optional[str] = None) -> LayerOutput:
    """Feature concat over the last axis; a sequence first input keeps its
    lengths and mask, and feature maps of one size (inception branches)
    keep their spatial dims."""
    inputs = list(input)
    name = name or next_name("concat")
    size = sum(i.size for i in inputs)

    def forward(ctx, params, *acts: Act) -> Act:
        out = torch.cat([a.value for a in acts], dim=-1)
        ref = acts[0]
        return _seq_like(ref, out) if ref.is_seq else Act(value=out)

    node = LayerOutput(name, "concat", size, inputs, forward, [])
    hws = {i.meta.get("hw") for i in inputs}
    if len(hws) == 1 and None not in hws:
        node.meta["hw"] = hws.pop()
    return node


def dropout(input: LayerOutput, rate: float, *,
            name: Optional[str] = None) -> LayerOutput:
    """Inverted dropout while training (``ops.dropout``; its mask is drawn
    on the activation's device), the identity otherwise."""
    name = name or next_name("dropout")

    def forward(ctx, params, a: Act) -> Act:
        out = O.dropout(ctx.next_rng(), a.value, rate, train=ctx.train)
        return _seq_like(a, out) if a.is_seq else Act(value=out)

    return _inherit_meta(LayerOutput(name, "dropout", input.size, [input],
                                     forward, []), input)


class _ClipGrad(torch.autograd.Function):
    """The identity forward; the backward clips the error signal."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.t = t
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -ctx.t, ctx.t), None


def error_clip(input: LayerOutput, threshold: float, *,
               name: Optional[str] = None) -> LayerOutput:
    """Clip the backward error signal flowing through this point to
    [-threshold, threshold] (the reference's ``error_clipping_threshold``);
    the identity in the forward pass."""
    name = name or next_name("error_clip")
    t = float(threshold)

    def forward(ctx, params, a: Act) -> Act:
        out = _ClipGrad.apply(a.value, t)
        return _seq_like(a, out) if a.is_seq else Act(value=out)

    return _inherit_meta(LayerOutput(name, "error_clip", input.size, [input],
                                     forward, []), input)


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


def _spatial(ipt: LayerOutput):
    if "hw" not in ipt.meta:
        raise ConfigError(f"layer {ipt.name!r} has no spatial meta; use "
                          f"data(height=, width=)")
    return ipt.meta["hw"]


def img_conv(input: LayerOutput, *, filter_size: int, num_filters: int,
             stride: int = 1, padding: Union[str, int] = "SAME",
             groups: int = 1, act: str = "relu", name: Optional[str] = None,
             param_attr: AttrLike = None, bias_attr: AttrLike = True
             ) -> LayerOutput:
    """2-D convolution over an NHWC feature map, HWIO weight ``w0``
    [filter_size, filter_size, C/groups, num_filters] and bias ``wbias``.
    ``padding`` is 'SAME', 'VALID' or an int (symmetric pixels).  The bias
    is added in the conv's compute dtype, as the reference adds it."""
    name = name or next_name("conv")
    h, w = _spatial(input)
    cin = input.size
    pa = _pa(param_attr, f"_{name}.w0")
    wspec = ParamSpec(name=pa.name, shape=(filter_size, filter_size,
                                           cin // groups, num_filters),
                      attr=pa)
    specs = [wspec]
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(num_filters,), attr=ba))
    act_fn = O.get_activation(act)
    if isinstance(padding, int):
        oh = (h + 2 * padding - filter_size) // stride + 1
        ow = (w + 2 * padding - filter_size) // stride + 1
        pad_arg = [(padding, padding), (padding, padding)]
    elif padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
        pad_arg = padding
    else:
        oh = (h - filter_size) // stride + 1
        ow = (w - filter_size) // stride + 1
        pad_arg = padding
    if oh <= 0 or ow <= 0:
        raise ConfigError(
            f"conv {name!r}: output spatial dims ({oh}, {ow}) are not "
            f"positive — filter {filter_size}/stride {stride}/padding "
            f"{padding!r} does not fit the {h}x{w} input")

    def forward(ctx, params, a: Act) -> Act:
        y = O.conv2d(a.value, params[wspec.name], stride=(stride, stride),
                     padding=pad_arg, groups=groups)
        if ba:
            y = y + params[ba.name].to(y.dtype)
        return Act(value=act_fn(y))

    out = LayerOutput(name, "conv", num_filters, [input], forward, specs)
    out.meta["hw"] = (oh, ow)
    return out


#: activations that commute with max pooling (monotone non-decreasing), so
#: ``act`` after the pool equals the conventional ``act`` before it
_MAX_COMMUTING = ("linear", "relu", "sigmoid", "tanh", "brelu", "softrelu",
                  "stanh", "exponential", "log", "sqrt")


def img_pool(input: LayerOutput, *, pool_size: int,
             stride: Optional[int] = None, pool_type: str = "max",
             padding: Union[str, int] = "VALID", ceil_mode: bool = True,
             act: str = "linear", name: Optional[str] = None
             ) -> LayerOutput:
    """Spatial max or average pooling.  ``padding`` is 'SAME'/'VALID' (XLA's
    meanings) or an int (symmetric pixels).

    With an int padding, ``ceil_mode`` (the reference's default) sizes the
    output by ceiling division and pads the extra rows/columns at the
    bottom/right, dropping a last window that would start wholly in that
    padding (the legacy clip; it would pool no real pixel).  That is the
    reference's rule, not PyTorch's ``ceil_mode``, so the pads are resolved
    here and the op pools over them.

    ``act`` runs after a max pool (``relu(max_pool(x)) == max_pool(
    relu(x))`` on a map stride^2 times smaller); it is refused for average
    pooling and for an activation that is not monotone non-decreasing."""
    name = name or next_name("pool")
    stride = stride or pool_size
    h, w = _spatial(input)
    if isinstance(padding, int):
        if ceil_mode:
            oh = -(-(h + 2 * padding - pool_size) // stride) + 1
            ow = -(-(w + 2 * padding - pool_size) // stride) + 1
            # the legacy clip
            if (oh - 1) * stride >= h + padding:
                oh -= 1
            if (ow - 1) * stride >= w + padding:
                ow -= 1
        else:
            oh = (h + 2 * padding - pool_size) // stride + 1
            ow = (w + 2 * padding - pool_size) // stride + 1
        extra_h = max(0, (oh - 1) * stride + pool_size - (h + 2 * padding))
        extra_w = max(0, (ow - 1) * stride + pool_size - (w + 2 * padding))
        pad_arg = ((0, 0), (padding, padding + extra_h),
                   (padding, padding + extra_w), (0, 0))
    elif padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
        pad_arg = padding
    else:
        oh = (h - pool_size) // stride + 1
        ow = (w - pool_size) // stride + 1
        pad_arg = padding
    if oh <= 0 or ow <= 0:
        raise ConfigError(
            f"pool {name!r}: output spatial dims ({oh}, {ow}) are not "
            f"positive — window {pool_size}/stride {stride}/padding "
            f"{padding!r} does not fit the {h}x{w} input")
    if act not in (None, "", "linear"):
        if pool_type != "max":
            raise ConfigError(
                f"pool {name!r}: act={act!r} is only supported with "
                f"pool_type='max' (relu(max_pool(x)) == max_pool(relu(x)); "
                f"no such identity holds for {pool_type!r} pooling)")
        # callables pass through: the caller asserts monotonicity
        if isinstance(act, str) and act not in _MAX_COMMUTING:
            raise ConfigError(
                f"pool {name!r}: act={act!r} is not monotone-nondecreasing, "
                f"so act-after-max-pool differs from the conventional "
                f"act-before-pool; supported: {_MAX_COMMUTING[1:]}")
    op = O.max_pool2d if pool_type == "max" else O.avg_pool2d
    act_fn = O.get_activation(act)

    def forward(ctx, params, a: Act) -> Act:
        y = op(a.value, (pool_size, pool_size), (stride, stride), pad_arg)
        return Act(value=act_fn(y))

    out = LayerOutput(name, "pool", input.size, [input], forward, [])
    out.meta["hw"] = (oh, ow)
    return out


def batch_norm(input: LayerOutput, *, act: str = "relu",
               momentum: float = 0.9, epsilon: float = 1e-5,
               name: Optional[str] = None) -> LayerOutput:
    """Batch normalisation over the channel (last) axis: scale ``w0``
    (ones), shift ``wbias`` (zeros), and the running stats
    ``moving_mean``/``moving_var``, state specs written through
    ``ctx.updated_state`` only when training (``ops.batch_norm``)."""
    name = name or next_name("batch_norm")
    C = input.size

    def spec(suffix: str, init: str, is_state: bool = False) -> ParamSpec:
        return ParamSpec(name=f"_{name}.{suffix}", shape=(C,),
                         attr=ParamAttr(name=f"_{name}.{suffix}", init=init),
                         is_state=is_state)

    sspec, bspec = spec("w0", "ones"), spec("wbias", "zeros")
    mspec = spec("moving_mean", "zeros", True)
    vspec = spec("moving_var", "ones", True)
    act_fn = O.get_activation(act)

    def forward(ctx, params, a: Act) -> Act:
        y, nm, nv = O.batch_norm(
            a.value, params[sspec.name], params[bspec.name],
            params[mspec.name], params[vspec.name], train=ctx.train,
            momentum=momentum, eps=epsilon)
        if ctx.train:
            # state, not parameters: no gradient flows into the next step
            ctx.updated_state[mspec.name] = nm.detach()
            ctx.updated_state[vspec.name] = nv.detach()
        y = act_fn(y)
        return _seq_like(a, y) if a.is_seq else Act(value=y)

    return _inherit_meta(LayerOutput(name, "batch_norm", C, [input], forward,
                                     [sspec, bspec, mspec, vspec]), input)


def img_cmrnorm(input: LayerOutput, *, size: int = 5, scale: float = 1e-4,
                power: float = 0.75, name: Optional[str] = None
                ) -> LayerOutput:
    """Cross-map response normalisation (``ops.cmr_norm``)."""
    name = name or next_name("cmrnorm")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=O.cmr_norm(a.value, size=size, scale=scale,
                                    power=power))

    return _inherit_meta(LayerOutput(name, "cmrnorm", input.size, [input],
                                     forward, []), input)


def maxout(input: LayerOutput, *, groups: int,
           name: Optional[str] = None) -> LayerOutput:
    """Max over each run of ``groups`` adjacent channels."""
    name = name or next_name("maxout")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=O.maxout(a.value, groups))

    return _inherit_meta(LayerOutput(name, "maxout", input.size // groups,
                                     [input], forward, []), input)


def bilinear_interp(input: LayerOutput, *, out_h: int, out_w: int,
                    name: Optional[str] = None) -> LayerOutput:
    """Bilinear resize of a feature map to ``out_h`` x ``out_w``."""
    name = name or next_name("bilinear")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=O.bilinear_interp(a.value, out_h, out_w))

    out = LayerOutput(name, "bilinear_interp", input.size, [input], forward,
                      [])
    out.meta["hw"] = (out_h, out_w)
    return out


# ---------------------------------------------------------------------------
# recurrent
# ---------------------------------------------------------------------------


def _reset(packst: dict, a: Act, reverse: bool):
    """A packed input's carry resets for a scan in this direction (None
    when unpacked)."""
    return (O.segment_starts(packst["seg_ids"], a.mask, reverse=reverse)
            if packst else None)


def lstmemory(input: LayerOutput, size: Optional[int] = None, *,
              reverse: bool = False, act: str = "tanh",
              gate_act: str = "sigmoid", state_act: str = "tanh",
              use_peepholes: bool = True, projected_input: bool = False,
              name: Optional[str] = None, param_attr: AttrLike = None,
              bias_attr: AttrLike = True) -> LayerOutput:
    """LSTM over a sequence.  The layer owns the input projection ``wx``
    [D, 4H] and the recurrent weight ``w0`` [H, 4H] (gate order
    [i, f, o, g]); ``projected_input=True`` takes the [B, T, 4*size]
    pre-projection as input instead and creates no ``wx``.  Peephole
    ("check") weights are on by default, initialised to zeros."""
    name = name or next_name("lstmemory")
    if projected_input:
        H = size or input.size // 4
        if input.size != 4 * H:
            raise ConfigError(
                f"lstmemory {name!r}: projected_input needs input.size == "
                f"4*size ({4 * H}), got {input.size}")
    else:
        H = size or input.size
    D = input.size
    pa = _pa(param_attr, f"_{name}.w0")
    wh = ParamSpec(name=pa.name, shape=(H, 4 * H), attr=pa)
    specs = [wh]
    wx = None
    if not projected_input:
        wx = ParamSpec(name=f"_{name}.wx", shape=(D, 4 * H),
                       attr=replace(pa, name=f"_{name}.wx"))
        specs.insert(0, wx)
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(4 * H,), attr=ba))
    peeps = []
    if use_peepholes:
        for g in ("i", "f", "o"):
            ps = ParamSpec(name=f"_{name}.check_{g}", shape=(H,),
                           attr=ParamAttr(name=f"_{name}.check_{g}",
                                          init="zeros"))
            peeps.append(ps)
            specs.append(ps)

    def forward(ctx, params, a: Act) -> Act:
        b = (params[ba.name] if ba else
             torch.zeros(4 * H, dtype=a.value.dtype, device=a.value.device))
        pk = {}
        if use_peepholes:
            pk = dict(peep_i=params[peeps[0].name],
                      peep_f=params[peeps[1].name],
                      peep_o=params[peeps[2].name])
        packst = _pack_state(a)
        h_seq, (h_f, c_f) = O.lstm_layer(
            a.value, a.mask, params[wx.name] if wx else None,
            params[wh.name], b, reverse=reverse, act=act, gate_act=gate_act,
            state_act=state_act, reset=_reset(packst, a, reverse), **pk)
        return Act(value=h_seq, lengths=a.lengths, mask=a.mask,
                   state={"final_h": h_f, "final_c": c_f, **packst})

    return LayerOutput(name, "lstmemory", H, [input], forward, specs)


def grumemory(input: LayerOutput, size: Optional[int] = None, *,
              reverse: bool = False, act: str = "tanh",
              gate_act: str = "sigmoid", projected_input: bool = False,
              name: Optional[str] = None, param_attr: AttrLike = None,
              bias_attr: AttrLike = True) -> LayerOutput:
    """GRU over a sequence (gate layout [r, u, c], ``r`` applied to h before
    the candidate product).  The layer owns the input projection ``wx``
    [D, 3H] and the recurrent weight ``w0`` [H, 3H];
    ``projected_input=True`` takes the [B, T, 3*size] pre-projection as
    input instead and creates no ``wx``.  Runs ``ops.gru_layer``, so the
    default cell is the ``gru_forward`` kernel on the card."""
    name = name or next_name("grumemory")
    if projected_input:
        H = size or input.size // 3
        if input.size != 3 * H:
            raise ConfigError(
                f"grumemory {name!r}: projected_input needs input.size == "
                f"3*size ({3 * H}), got {input.size}")
    else:
        H = size or input.size
    D = input.size
    pa = _pa(param_attr, f"_{name}.w0")
    wh = ParamSpec(name=pa.name, shape=(H, 3 * H), attr=pa)
    specs = [wh]
    wx = None
    if not projected_input:
        wx = ParamSpec(name=f"_{name}.wx", shape=(D, 3 * H),
                       attr=replace(pa, name=f"_{name}.wx"))
        specs.insert(0, wx)
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(3 * H,), attr=ba))

    def forward(ctx, params, a: Act) -> Act:
        b = (params[ba.name] if ba else
             torch.zeros(3 * H, dtype=a.value.dtype, device=a.value.device))
        packst = _pack_state(a)
        h_seq, h_f = O.gru_layer(
            a.value, a.mask, params[wx.name] if wx else None,
            params[wh.name], b, reverse=reverse, act=act, gate_act=gate_act,
            reset=_reset(packst, a, reverse))
        return Act(value=h_seq, lengths=a.lengths, mask=a.mask,
                   state={"final_h": h_f, **packst})

    return LayerOutput(name, "grumemory", H, [input], forward, specs)


def recurrent(input: LayerOutput, *, act: str = "tanh", reverse: bool = False,
              name: Optional[str] = None, param_attr: AttrLike = None,
              bias_attr: AttrLike = True) -> LayerOutput:
    """The simple (Elman) recurrent layer: h_t = act(x_t + b + h_{t-1} @
    W), W ``w0`` [H, H] with H the input's size, over ``ops.scan_rnn``
    (its row products through ``ops/matmul.py``)."""
    name = name or next_name("recurrent")
    H = input.size
    pa = _pa(param_attr, f"_{name}.w0")
    wh = ParamSpec(name=pa.name, shape=(H, H), attr=pa)
    specs = [wh]
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(H,), attr=ba))
    act_fn = O.get_activation(act)

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        if ba:
            x = x + params[ba.name].to(x.dtype)

        def step(h, x_t):
            h2 = act_fn(x_t + O.linear(h, params[wh.name]))
            return h2, h2

        h0 = torch.zeros(x.shape[0], H, dtype=x.dtype, device=x.device)
        packst = _pack_state(a)
        h_f, h_seq = O.scan_rnn(step, h0, x, a.mask, reverse=reverse,
                                reset_bt=_reset(packst, a, reverse))
        return Act(value=h_seq, lengths=a.lengths, mask=a.mask,
                   state={"final_h": h_f, **packst})

    return LayerOutput(name, "recurrent", H, [input], forward, specs)


def bidirectional_rnn(input: LayerOutput, size: int, *, cell: str = "lstm",
                      name: Optional[str] = None) -> LayerOutput:
    """A forward and a reverse ``lstmemory`` (``cell="lstm"``) or
    ``grumemory`` (otherwise), ``{name}_fw`` and ``{name}_bw``,
    concatenated: output size 2 * size."""
    name = name or next_name("bidir")
    maker = lstmemory if cell == "lstm" else grumemory
    fwd = maker(input, size, name=f"{name}_fw")
    bwd = maker(input, size, reverse=True, name=f"{name}_bw")
    return concat([fwd, bwd], name=name)


# ---------------------------------------------------------------------------
# sequence pooling and structure
# ---------------------------------------------------------------------------


def pooling(input: LayerOutput, *, pooling_type: str = "max",
            name: Optional[str] = None) -> LayerOutput:
    """Sequence pooling [B, T, D] -> [B, D] (max/avg/sum/sqrt over the real
    positions).  A packed input pools each segment on its own: the output
    is a sequence over the segment axis ([B, S, D], masked by segment
    validity), so the per-sample layers after it (``fc``, a cost's mean
    over real positions) treat each packed sample as a row of its own."""
    name = name or next_name("seq_pool")
    fns = {"max": O.seq_pool_max, "avg": O.seq_pool_avg,
           "sum": O.seq_pool_sum, "sqrt": O.seq_pool_sqrt}
    fn = fns[pooling_type]

    def forward(ctx, params, a: Act) -> Act:
        segl = a.state.get("seg_lengths")
        if segl is not None:
            return _segment_seq(O.segment_pool(
                a.value, a.mask, a.state["seg_ids"], segl, pooling_type),
                segl)
        return Act(value=fn(a.value, a.mask))

    return LayerOutput(name, "seq_pool", input.size, [input], forward, [])


def last_seq(input: LayerOutput, *, name: Optional[str] = None
             ) -> LayerOutput:
    """The last real timestep of each sequence: [B, T, D] -> [B, D]; of
    each segment of a packed row: a sequence [B, S, D] over the
    segments."""
    name = name or next_name("last_seq")

    def forward(ctx, params, a: Act) -> Act:
        segl = a.state.get("seg_lengths")
        if segl is not None:
            return _segment_seq(O.segment_last(a.value, segl), segl)
        return Act(value=O.seq_last(a.value, a.lengths))

    return LayerOutput(name, "last_seq", input.size, [input], forward, [])


def first_seq(input: LayerOutput, *, name: Optional[str] = None
              ) -> LayerOutput:
    """The first timestep of each sequence: [B, T, D] -> [B, D]; of each
    segment of a packed row: a sequence [B, S, D] over the segments."""
    name = name or next_name("first_seq")

    def forward(ctx, params, a: Act) -> Act:
        segl = a.state.get("seg_lengths")
        if segl is not None:
            return _segment_seq(O.segment_first(a.value, segl), segl)
        return Act(value=O.seq_first(a.value))

    return LayerOutput(name, "first_seq", input.size, [input], forward, [])


def expand(input: LayerOutput, expand_as: LayerOutput, *,
           name: Optional[str] = None) -> LayerOutput:
    """Broadcast a per-sequence vector [B, D] over the timesteps of
    ``expand_as`` (its lengths and mask; padding zeroed).  Over a packed
    ``expand_as``, a per-segment vector [B, S, D] broadcasts over its own
    segment's tokens."""
    name = name or next_name("expand")

    def forward(ctx, params, vec: Act, seq: Act) -> Act:
        packst = _pack_state(seq)
        if packst and vec.value.dim() == 3:
            value = O.segment_expand(vec.value, packst["seg_ids"], seq.mask)
        else:
            value = O.seq_expand(vec.value, seq.mask)
        return Act(value=value, lengths=seq.lengths, mask=seq.mask,
                   state=packst)

    return LayerOutput(name, "expand", input.size, [input, expand_as],
                       forward, [])


def seq_reverse(input: LayerOutput, *, name: Optional[str] = None
                ) -> LayerOutput:
    """Each sequence reversed within its real length."""
    name = name or next_name("seq_reverse")

    def forward(ctx, params, a: Act) -> Act:
        _refuse_packed(a, name, "seq_reverse")
        return Act(value=O.seq_reverse(a.value, a.lengths),
                   lengths=a.lengths, mask=a.mask)

    return LayerOutput(name, "seq_reverse", input.size, [input], forward, [])


def seq_concat(a: LayerOutput, b: LayerOutput, *,
               name: Optional[str] = None) -> LayerOutput:
    """Two sequences concatenated along time, row by row."""
    name = name or next_name("seq_concat")

    def forward(ctx, params, x: Act, y: Act) -> Act:
        _refuse_packed(x, name, "seq_concat")
        _refuse_packed(y, name, "seq_concat")
        v, lengths = O.seq_concat(x.value, x.lengths, y.value, y.lengths)
        return Act(value=v, lengths=lengths,
                   mask=O.mask_from_lengths(lengths, v.shape[1]))

    return LayerOutput(name, "seq_concat", a.size, [a, b], forward, [])


def context_projection(input: LayerOutput, *, context_len: int,
                       context_start: Optional[int] = None,
                       name: Optional[str] = None) -> LayerOutput:
    """Sliding-window context features with zero padding: [B, T, D] ->
    [B, T, D * context_len], the window starting at ``context_start``
    (default ``-(context_len // 2)``).  Over a packed row the window stops
    at segment edges."""
    name = name or next_name("context_proj")
    start = -(context_len // 2) if context_start is None else context_start

    def forward(ctx, params, a: Act) -> Act:
        packst = _pack_state(a)
        out = O.context_projection(a.value, a.mask, context_len, start,
                                   seg_ids=packst.get("seg_ids"))
        return Act(value=out, lengths=a.lengths, mask=a.mask, state=packst)

    return LayerOutput(name, "context_projection", input.size * context_len,
                       [input], forward, [])


# ---------------------------------------------------------------------------
# elementwise math
# ---------------------------------------------------------------------------


def maxid(input: LayerOutput, *, name: Optional[str] = None) -> LayerOutput:
    """The argmax of each row (int32), per timestep on a sequence."""
    name = name or next_name("maxid")

    def forward(ctx, params, a: Act) -> Act:
        out = O.max_id(a.value)
        return _seq_like(a, out) if a.is_seq else Act(value=out)

    return LayerOutput(name, "maxid", 1, [input], forward, [])


def cos_sim(a: LayerOutput, b: LayerOutput, *, scale: float = 1.0,
            name: Optional[str] = None) -> LayerOutput:
    """Row cosine similarity times ``scale``: [B, 1]."""
    name = name or next_name("cos_sim")

    def forward(ctx, params, x: Act, y: Act) -> Act:
        return Act(value=O.cos_sim(x.value, y.value, scale)[:, None])

    return LayerOutput(name, "cos_sim", 1, [a, b], forward, [])


def interpolation(weight: LayerOutput, a: LayerOutput, b: LayerOutput, *,
                  name: Optional[str] = None) -> LayerOutput:
    """``w * a + (1 - w) * b`` with a per-row weight [B, 1]."""
    name = name or next_name("interpolation")

    def forward(ctx, params, w: Act, x: Act, y: Act) -> Act:
        return Act(value=O.interpolation(w.value, x.value, y.value))

    return LayerOutput(name, "interpolation", a.size, [weight, a, b],
                       forward, [])


def outer_prod(a: LayerOutput, b: LayerOutput, *,
               name: Optional[str] = None) -> LayerOutput:
    """The row-wise outer product, flattened: [B, Da * Db]."""
    name = name or next_name("outer_prod")

    def forward(ctx, params, x: Act, y: Act) -> Act:
        return Act(value=O.outer_prod(x.value, y.value))

    return LayerOutput(name, "outer_prod", a.size * b.size, [a, b], forward,
                       [])


def tensor(a: LayerOutput, b: LayerOutput, size: int, *,
           act: str = "linear", name: Optional[str] = None,
           param_attr: AttrLike = None) -> LayerOutput:
    """The bilinear tensor layer: out[n, k] = a[n] @ W[k] @ b[n], W ``w0``
    [size, Da, Db]."""
    name = name or next_name("tensor")
    pa = _pa(param_attr, f"_{name}.w0")
    spec = ParamSpec(name=pa.name, shape=(size, a.size, b.size), attr=pa)
    act_fn = O.get_activation(act)

    def forward(ctx, params, x: Act, y: Act) -> Act:
        return Act(value=act_fn(O.tensor_bilinear(x.value, y.value,
                                                  params[spec.name])))

    return LayerOutput(name, "tensor", size, [a, b], forward, [spec])


def scaling(weight: LayerOutput, input: LayerOutput, *,
            name: Optional[str] = None) -> LayerOutput:
    """Each row of ``input`` times its own scalar [B, 1]."""
    name = name or next_name("scaling")

    def forward(ctx, params, w: Act, a: Act) -> Act:
        return Act(value=O.scaling(w.value, a.value))

    return LayerOutput(name, "scaling", input.size, [weight, input], forward,
                       [])


def slope_intercept(input: LayerOutput, *, slope: float = 1.0,
                    intercept: float = 0.0,
                    name: Optional[str] = None) -> LayerOutput:
    """``slope * x + intercept``."""
    name = name or next_name("slope_intercept")

    def forward(ctx, params, a: Act) -> Act:
        out = O.slope_intercept(a.value, slope, intercept)
        return _seq_like(a, out) if a.is_seq else Act(value=out)

    return LayerOutput(name, "slope_intercept", input.size, [input], forward,
                       [])


def power(weight: LayerOutput, input: LayerOutput, *,
          name: Optional[str] = None) -> LayerOutput:
    """``x ** p`` with a per-row exponent p [B, 1]."""
    name = name or next_name("power")

    def forward(ctx, params, w: Act, a: Act) -> Act:
        return Act(value=O.power_op(w.value, a.value))

    return LayerOutput(name, "power", input.size, [weight, input], forward,
                       [])


def sum_to_one_norm(input: LayerOutput, *,
                    name: Optional[str] = None) -> LayerOutput:
    """Each row divided by its sum (at least 1e-12)."""
    name = name or next_name("sum_to_one")

    def forward(ctx, params, a: Act) -> Act:
        s = torch.clamp(a.value.sum(-1, keepdim=True), min=1e-12)
        return Act(value=a.value / s)

    return LayerOutput(name, "sum_to_one_norm", input.size, [input], forward,
                       [])


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------


def _cost_layer(name: str, ltype: str, inputs, fn) -> LayerOutput:
    """``fn(*acts) -> (cost, norm)``: the cost and what it averages over
    (``COST_NORM``)."""

    def forward(ctx, params, *acts: Act) -> Act:
        value, norm = fn(*acts)
        return Act(value=value, state={COST_NORM: norm})

    return LayerOutput(name, ltype, 1, list(inputs), forward, [])


def _mean(t: torch.Tensor):
    """``(t.mean(), t.numel())``: a batch mean and what it averages over."""
    return t.mean(), t.numel()


def classification_cost(input: LayerOutput, label: LayerOutput, *,
                        name: Optional[str] = None) -> LayerOutput:
    """Softmax + CE (use act='linear' on the producing fc): the mean over
    the batch, or over the real tokens of a sequence input."""
    name = name or next_name("cls_cost")

    def fn(logits: Act, lab: Act):
        if logits.is_seq:
            return (O.sequence_cross_entropy(logits.value, lab.value,
                                             logits.mask),
                    logits.mask.sum())
        labels = lab.value.reshape(lab.value.shape[0])
        return _mean(O.cross_entropy(logits.value, labels))

    return _cost_layer(name, "classification_cost", [input, label], fn)


cross_entropy_cost = classification_cost


def cross_entropy_with_selfnorm(input: LayerOutput, label: LayerOutput, *,
                                softmax_selfnorm_alpha: float = 0.1,
                                name: Optional[str] = None) -> LayerOutput:
    """CE + alpha * log(Z)^2 (self-normalisation), the batch mean; log(Z)
    is the full row logsumexp in float32."""
    name = name or next_name("selfnorm_cost")

    def fn(logits: Act, lab: Act):
        lz = torch.logsumexp(logits.value.float(), dim=-1)
        ce = O.cross_entropy(logits.value,
                             lab.value.reshape(lab.value.shape[0]))
        return _mean(ce + softmax_selfnorm_alpha * torch.square(lz))

    return _cost_layer(name, "cross_entropy_with_selfnorm", [input, label],
                       fn)


def soft_cross_entropy_cost(input: LayerOutput, label: LayerOutput, *,
                            name: Optional[str] = None) -> LayerOutput:
    """CE against target probabilities, the batch mean."""
    name = name or next_name("soft_ce_cost")
    return _cost_layer(
        name, "soft_cross_entropy", [input, label],
        lambda p, t: _mean(O.soft_cross_entropy(p.value, t.value)))


def multi_binary_label_cross_entropy(input: LayerOutput, label: LayerOutput,
                                     *, name: Optional[str] = None
                                     ) -> LayerOutput:
    """Independent BCE per class, summed over classes; the batch mean."""
    name = name or next_name("mbce_cost")
    return _cost_layer(
        name, "multi_binary_label_cross_entropy", [input, label],
        lambda p, t: _mean(O.multi_binary_label_cross_entropy(p.value,
                                                              t.value)))


def mse_cost(input: LayerOutput, label: LayerOutput, *,
             name: Optional[str] = None) -> LayerOutput:
    """0.5 * squared error summed over features; the batch mean."""
    name = name or next_name("mse_cost")
    return _cost_layer(name, "mse_cost", [input, label],
                       lambda p, t: _mean(O.mse(p.value, t.value)))


regression_cost = mse_cost


def huber_cost(input: LayerOutput, label: LayerOutput, *, delta: float = 1.0,
               name: Optional[str] = None) -> LayerOutput:
    """Huber loss summed over features; the batch mean."""
    name = name or next_name("huber_cost")
    return _cost_layer(name, "huber_cost", [input, label],
                       lambda p, t: _mean(O.huber(p.value, t.value, delta)))


def smooth_l1_cost(input: LayerOutput, label: LayerOutput, *,
                   name: Optional[str] = None) -> LayerOutput:
    """Smooth L1 (Huber at delta 1); the batch mean."""
    name = name or next_name("smooth_l1_cost")
    return _cost_layer(name, "smooth_l1_cost", [input, label],
                       lambda p, t: _mean(O.smooth_l1(p.value, t.value)))


def rank_cost(left: LayerOutput, right: LayerOutput, label: LayerOutput, *,
              name: Optional[str] = None) -> LayerOutput:
    """Pairwise rank cost of two scores against a label in [0, 1]; the
    batch mean."""
    name = name or next_name("rank_cost")
    return _cost_layer(
        name, "rank_cost", [left, right, label],
        lambda l, r, t: _mean(O.rank_cost(l.value, r.value, t.value)))


def sum_cost(input: LayerOutput, *, name: Optional[str] = None
             ) -> LayerOutput:
    """The sum of every entry of the input."""
    name = name or next_name("sum_cost")
    return _cost_layer(name, "sum_cost", [input],
                       lambda a: (a.value.sum(), None))


# record constructor calls on the returned nodes so Topologies serialize to
# ModelConfig protos (config/config_parser.py)
from paddle_tpu_torch.config.capture import wrap_module as _wrap_module  # noqa: E402

_wrap_module(globals(), __all__)
