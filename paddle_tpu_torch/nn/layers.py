"""User-facing layer functions — counterpart of ``paddle_tpu/nn/layers.py``
for the layers the text-classification benchmark net (``data``, ``fc``,
``embedding``, ``lstmemory``, ``pooling``, ``classification_cost``), the
seqToseq generation net (``concat``, ``grumemory``, ``first_seq``,
``last_seq``) and the image models (``img_conv``, ``img_pool``,
``batch_norm``, ``img_cmrnorm``, ``maxout``, ``bilinear_interp``,
``addto``, ``dropout``) are built from.

Each function returns a symbolic ``LayerOutput`` whose ``forward`` closure
computes the op with the port's ``ops``.  Names, arguments, parameter names
(``_{name}.w{i}``, ``_{name}.wbias``, ``_{name}.wx``,
``_{name}.check_{i,f,o}``, ``_{name}.moving_mean``/``moving_var``),
shapes and ``ParamAttr`` defaults follow the reference, so parameters
carry across from the JAX package by name.
Sequence activations are padded batches with a mask; ``embedding`` and a
sequence ``fc`` multiply their output by it.  A packed sequence input
(``--data_pack``) is refused.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Union

import torch

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (PACK_KEYS, Act, LayerOutput, ParamAttr,
                                       ParamSpec, _not_ported, next_name)
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["data", "fc", "embedding", "addto", "concat", "dropout",
           "img_conv", "img_pool", "batch_norm", "img_cmrnorm", "maxout",
           "bilinear_interp", "lstmemory", "grumemory", "pooling",
           "last_seq", "first_seq", "classification_cost"]

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


def _refuse_packed(a: Act, name: str, kind: str) -> None:
    """A cross-time layer over a packed row would mix neighbouring samples'
    tokens: refuse it (the packed variants are not ported)."""
    if any(k in a.state for k in PACK_KEYS):
        raise ConfigError(
            f"{kind} {name!r} does not support packed sequences "
            f"(--data_pack) in paddle_tpu_torch: feed this topology "
            f"unpacked")


def _seq_like(parent: Act, value) -> Act:
    return Act(value=value, lengths=parent.lengths, mask=parent.mask)


def _inherit_meta(node: LayerOutput, src: LayerOutput) -> LayerOutput:
    """Carry the spatial dims (``hw``) through a pass-through layer."""
    if "hw" in src.meta:
        node.meta["hw"] = src.meta["hw"]
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
    Sparse (``sparse=``) and nested (``nested=True``) inputs are not
    ported and raise ``ConfigError``."""
    if sparse is not None:
        raise _not_ported(f"the sparse data layer {name!r}")
    if nested:
        raise _not_ported(f"the nested-sequence data layer {name!r}")
    meta = {}
    if height is not None:
        meta["hw"] = (height, width)
    return LayerOutput(name=name, layer_type="data", size=size, parents=[],
                       forward=None, is_data=True,
                       data_spec={"dtype": dtype, "is_seq": is_seq},
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
    summed; a sequence input applies per timestep (output masked)."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    name = name or next_name("fc")
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
        for spec, a in zip(specs[:len(inputs)], acts):
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
    is the vocabulary size unless ``vocab_size`` is given.  The row-sparse
    table update (``sparse_grad=True``) is not ported and raises."""
    name = name or next_name("embedding")
    if sparse_grad:
        raise _not_ported(f"the row-sparse table of embedding {name!r} "
                          f"(sparse_grad=True)", 8)
    V = vocab_size or input.size
    pa = _pa(param_attr, f"_{name}.w0", initial_std=0.01, init="normal")
    spec = ParamSpec(name=pa.name, shape=(V, size), attr=pa)

    def forward(ctx, params, a: Act) -> Act:
        ids = a.value
        if not a.is_seq and ids.dim() == 2 and ids.shape[1] == 1:
            # a non-seq int slot feeds as [B, 1]; its embedding is [B, D]
            ids = ids[:, 0]
        out = O.embedding_lookup(params[spec.name], ids,
                                 pad_to_zero_id=padding_idx)
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
        _refuse_packed(a, name, "lstmemory")
        b = (params[ba.name] if ba else
             torch.zeros(4 * H, dtype=a.value.dtype, device=a.value.device))
        pk = {}
        if use_peepholes:
            pk = dict(peep_i=params[peeps[0].name],
                      peep_f=params[peeps[1].name],
                      peep_o=params[peeps[2].name])
        h_seq, (h_f, c_f) = O.lstm_layer(
            a.value, a.mask, params[wx.name] if wx else None,
            params[wh.name], b, reverse=reverse, act=act, gate_act=gate_act,
            state_act=state_act, **pk)
        return Act(value=h_seq, lengths=a.lengths, mask=a.mask,
                   state={"final_h": h_f, "final_c": c_f})

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
        _refuse_packed(a, name, "grumemory")
        b = (params[ba.name] if ba else
             torch.zeros(3 * H, dtype=a.value.dtype, device=a.value.device))
        h_seq, h_f = O.gru_layer(
            a.value, a.mask, params[wx.name] if wx else None,
            params[wh.name], b, reverse=reverse, act=act, gate_act=gate_act)
        return Act(value=h_seq, lengths=a.lengths, mask=a.mask,
                   state={"final_h": h_f})

    return LayerOutput(name, "grumemory", H, [input], forward, specs)


# ---------------------------------------------------------------------------
# sequence pooling and structure
# ---------------------------------------------------------------------------


def pooling(input: LayerOutput, *, pooling_type: str = "max",
            name: Optional[str] = None) -> LayerOutput:
    """Sequence pooling [B, T, D] -> [B, D] (max/avg/sum/sqrt over the real
    positions)."""
    name = name or next_name("seq_pool")
    fns = {"max": O.seq_pool_max, "avg": O.seq_pool_avg,
           "sum": O.seq_pool_sum, "sqrt": O.seq_pool_sqrt}
    fn = fns[pooling_type]

    def forward(ctx, params, a: Act) -> Act:
        _refuse_packed(a, name, "pooling")
        return Act(value=fn(a.value, a.mask))

    return LayerOutput(name, "seq_pool", input.size, [input], forward, [])


def last_seq(input: LayerOutput, *, name: Optional[str] = None
             ) -> LayerOutput:
    """The last real timestep of each sequence: [B, T, D] -> [B, D]."""
    name = name or next_name("last_seq")

    def forward(ctx, params, a: Act) -> Act:
        _refuse_packed(a, name, "last_seq")
        return Act(value=O.seq_last(a.value, a.lengths))

    return LayerOutput(name, "last_seq", input.size, [input], forward, [])


def first_seq(input: LayerOutput, *, name: Optional[str] = None
              ) -> LayerOutput:
    """The first timestep of each sequence: [B, T, D] -> [B, D]."""
    name = name or next_name("first_seq")

    def forward(ctx, params, a: Act) -> Act:
        _refuse_packed(a, name, "first_seq")
        return Act(value=O.seq_first(a.value))

    return LayerOutput(name, "first_seq", input.size, [input], forward, [])


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------


def classification_cost(input: LayerOutput, label: LayerOutput, *,
                        name: Optional[str] = None) -> LayerOutput:
    """Softmax + CE (use act='linear' on the producing fc): the mean over
    the batch, or over the real tokens of a sequence input."""
    name = name or next_name("cls_cost")

    def forward(ctx, params, logits: Act, lab: Act) -> Act:
        if logits.is_seq:
            return Act(value=O.sequence_cross_entropy(
                logits.value, lab.value, logits.mask))
        labels = lab.value.reshape(lab.value.shape[0])
        return Act(value=O.cross_entropy(logits.value, labels).mean())

    return LayerOutput(name, "classification_cost", 1, [input, label],
                       forward, [])
