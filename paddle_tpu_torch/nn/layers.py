"""User-facing layer functions — counterpart of ``paddle_tpu/nn/layers.py``
for the layers the text-classification benchmark net (``data``, ``fc``,
``embedding``, ``lstmemory``, ``pooling``, ``classification_cost``) and the
seqToseq generation net (``concat``, ``grumemory``, ``first_seq``,
``last_seq``) are built from.

Each function returns a symbolic ``LayerOutput`` whose ``forward`` closure
computes the op with the port's ``ops``.  Names, arguments, parameter names
(``_{name}.w{i}``, ``_{name}.wbias``, ``_{name}.wx``,
``_{name}.check_{i,f,o}``), shapes and ``ParamAttr`` defaults follow the
reference, so parameters carry across from the JAX package by name.
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

__all__ = ["data", "fc", "embedding", "concat", "lstmemory", "grumemory",
           "pooling", "last_seq", "first_seq", "classification_cost"]

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


def concat(input: Sequence[LayerOutput], *,
           name: Optional[str] = None) -> LayerOutput:
    """Feature concat over the last axis; a sequence first input keeps its
    lengths and mask."""
    inputs = list(input)
    name = name or next_name("concat")
    size = sum(i.size for i in inputs)

    def forward(ctx, params, *acts: Act) -> Act:
        out = torch.cat([a.value for a in acts], dim=-1)
        ref = acts[0]
        return _seq_like(ref, out) if ref.is_seq else Act(value=out)

    return LayerOutput(name, "concat", size, inputs, forward, [])


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
