"""Counterpart of ``paddle_tpu/nn/layers_extra.py``: the structured and
sampled costs and the utility layers of the reference's layer inventory,
every layer of it — the linear-chain CRF (``crf_cost``, ``crf_decoding``;
``ops/crf.py``), CTC (``ctc_cost``, ``warp_ctc``; ``ops/ctc.py``), NCE and
the hierarchical sigmoid, ``sampling_id``, ``multiplex``, ``pad``,
``rotate``, ``featmap_expand``, ``block_expand``, ``sub_seq``,
``seq_reshape``, ``eos_trim`` and ``slice_channels``.

The reference computes all of them with plain ``jnp``, ``lax.scan`` and
XLA gathers, so the port runs PyTorch's own ops.  The random draws (NCE's
noise classes, ``sampling_id``'s ids) go through ``ops.uniform_classes``
and ``ops.categorical`` with the apply's generator: other numbers than
``jax.random``'s.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (Act, LayerOutput, ParamAttr,
                                       ParamSpec, next_name)
from paddle_tpu_torch.nn.layers import _inherit_meta, _refuse_packed
from paddle_tpu_torch.ops.crf import crf_decode, crf_nll
from paddle_tpu_torch.ops.ctc import ctc_loss
from paddle_tpu_torch.utils.error import ConfigError

#: the reference module's layers that are not ported yet: none
NOT_PORTED = ()

__all__ = ["crf_cost", "crf_decoding", "ctc_cost", "warp_ctc", "nce_cost",
           "hsigmoid_cost", "sampling_id", "multiplex", "pad", "rotate",
           "featmap_expand", "block_expand", "sub_seq", "seq_reshape",
           "eos_trim", "slice_channels"]


def _crf_specs(name: str, C: int):
    """``_{name}.start`` [C], ``.end`` [C], ``.trans`` [C, C], zeros."""

    def mk(suffix, shape):
        return ParamSpec(name=f"_{name}.{suffix}", shape=shape,
                         attr=ParamAttr(name=f"_{name}.{suffix}",
                                        init="zeros"))

    return mk("start", (C,)), mk("end", (C,)), mk("trans", (C, C))


def crf_cost(input: LayerOutput, label: LayerOutput, *,
             size: Optional[int] = None, name: Optional[str] = None,
             param_attr=None) -> LayerOutput:
    """Linear-chain CRF negative log-likelihood, the batch mean:
    ``input`` the per-step emissions [B, T, C] (a sequence), ``label`` the
    int tags [B, T].  ``param_attr`` is accepted for the reference's
    signature; the weights are named after the layer."""
    name = name or next_name("crf_cost")
    C = size or input.size
    s_start, s_end, s_trans = _crf_specs(name, C)

    def forward(ctx, params, emis: Act, lab: Act) -> Act:
        _refuse_packed(emis, name, "crf_cost")
        return Act(value=crf_nll(emis.value, lab.value, emis.mask,
                                 params[s_start.name], params[s_end.name],
                                 params[s_trans.name]))

    return LayerOutput(name, "crf_cost", 1, [input, label], forward,
                       [s_start, s_end, s_trans])


def crf_decoding(input: LayerOutput, *, size: Optional[int] = None,
                 name: Optional[str] = None,
                 share_with: Optional[str] = None) -> LayerOutput:
    """Viterbi decode -> int32 tags [B, T] (0 on padding), ``state['score']``
    the best path's score [B].  ``share_with`` names the ``crf_cost``
    layer whose weights it reads."""
    name = name or next_name("crf_decoding")
    C = size or input.size
    s_start, s_end, s_trans = _crf_specs(share_with or name, C)

    def forward(ctx, params, emis: Act) -> Act:
        _refuse_packed(emis, name, "crf_decoding")
        tags, score = crf_decode(emis.value, emis.mask, params[s_start.name],
                                 params[s_end.name], params[s_trans.name])
        return Act(value=tags, lengths=emis.lengths, mask=emis.mask,
                   state={"score": score})

    return LayerOutput(name, "crf_decoding", 1, [input], forward,
                       [s_start, s_end, s_trans])


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def ctc_cost(input: LayerOutput, label: LayerOutput, *,
             blank: Optional[int] = None, norm_by_times: bool = False,
             name: Optional[str] = None) -> LayerOutput:
    """CTC negative log-likelihood, the batch mean (the reference's
    ctc_layer): ``input`` the per-step class logits [B, T, C] (a sequence,
    softmax taken here), ``label`` the int label sequence [B, L] with its
    own lengths.  The blank defaults to the LAST index (``input.size -
    1``), labels in [0, num_classes); ``warp_ctc`` has blank 0."""
    name = name or next_name("ctc_cost")
    blank_ix = input.size - 1 if blank is None else blank
    if blank is None and label.size > blank_ix:
        raise ConfigError(
            f"ctc_cost {name!r}: label vocabulary ({label.size}) reaches the "
            f"defaulted blank index {blank_ix} (= input.size - 1, the "
            f"reference ctc_layer convention; changed from blank=0). Size "
            f"the logits as num_classes + 1, or pass blank= explicitly")
    return _ctc_layer(input, label, blank_ix, norm_by_times, name,
                      "ctc_cost")


def warp_ctc(input: LayerOutput, label: LayerOutput, *, blank: int = 0,
             norm_by_times: bool = False,
             name: Optional[str] = None) -> LayerOutput:
    """CTC with the warp-ctc conventions (the reference's warp_ctc_layer):
    ``blank`` any index, 0 by default; linear logits in, the softmax taken
    here.  The same loss as ``ctc_cost`` otherwise."""
    name = name or next_name("warp_ctc")
    return _ctc_layer(input, label, blank, norm_by_times, name, "warp_ctc")


def _ctc_layer(input, label, blank, norm_by_times, name, kind):
    def forward(ctx, params, logits: Act, lab: Act) -> Act:
        _refuse_packed(logits, name, kind)
        lp = torch.log_softmax(logits.value.float(), dim=-1)
        losses = ctc_loss(lp, lab.value, logits.lengths, lab.lengths,
                          blank=blank, norm_by_times=norm_by_times)
        return Act(value=losses.mean())

    return LayerOutput(name, kind, 1, [input, label], forward, [])


# ---------------------------------------------------------------------------
# NCE and the hierarchical sigmoid
# ---------------------------------------------------------------------------


def _table_specs(name: str, rows: int, D: int):
    """``_{name}.w0`` [rows, D] (xavier) and ``_{name}.wbias`` [rows]
    (zeros), the tables of NCE and the hierarchical sigmoid."""
    return (ParamSpec(name=f"_{name}.w0", shape=(rows, D),
                      attr=ParamAttr(name=f"_{name}.w0")),
            ParamSpec(name=f"_{name}.wbias", shape=(rows,),
                      attr=ParamAttr(name=f"_{name}.wbias", init="zeros")))


def _row_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """x [B, D] against the table rows ``rows`` [B, ...]: ``x[b] . w[r] +
    b[r]`` -> [B, ...], float32."""
    wr = F.embedding(rows, w)                            # [B, ..., D]
    xb = x.reshape(x.shape[0], *([1] * (rows.dim() - 1)), x.shape[1])
    return (xb.float() * wr.float()).sum(-1) + b[rows].float()


def nce_cost(input: LayerOutput, label: LayerOutput, *, num_classes: int,
             num_neg_samples: int = 10, name: Optional[str] = None,
             param_attr=None) -> LayerOutput:
    """Noise-contrastive estimation over ``num_classes`` (the reference's
    nce_layer): the label's logit against ``num_neg_samples`` noise classes
    a row, drawn uniformly over all classes (the label not excluded) with
    ``ops.uniform_classes``; each logit less ``log k - log C``; the mean
    over rows of the positive's and the noises' binary CE.  Tables
    ``_{name}.w0`` [C, D], ``_{name}.wbias`` [C]; ``param_attr`` is
    accepted for the reference's signature."""
    name = name or next_name("nce")
    wspec, bspec = _table_specs(name, num_classes, input.size)
    k = num_neg_samples
    # log k + ln(noise prob), in float32 as the reference takes it
    shift = float(np.float32(np.log(np.float32(k)))
                  + np.float32(-np.log(np.float32(num_classes))))

    def forward(ctx, params, feat: Act, lab: Act) -> Act:
        x = feat.value
        B = x.shape[0]
        y = lab.value.reshape(B).to(torch.long)
        noise = O.uniform_classes(ctx.next_rng(), (B, k), num_classes,
                                  x.device)
        w, b = params[wspec.name], params[bspec.name]
        pos = _row_logits(x, w, b, y[:, None])[:, 0] - shift
        neg = _row_logits(x, w, b, noise.to(torch.long)) - shift
        pos_loss = O.binary_cross_entropy(pos, torch.ones_like(pos))
        neg_loss = O.binary_cross_entropy(neg, torch.zeros_like(neg))
        return Act(value=(pos_loss + neg_loss.sum(-1)).mean())

    return LayerOutput(name, "nce_cost", 1, [input, label], forward,
                       [wspec, bspec])


def hsigmoid_cost(input: LayerOutput, label: LayerOutput, *,
                  num_classes: int,
                  name: Optional[str] = None) -> LayerOutput:
    """Hierarchical sigmoid over an implicit balanced binary tree (the
    reference's hsigmoid): ``depth = ceil(log2(max(C, 2)))`` levels and
    ``2**depth - 1`` internal nodes addressed heap-style; at each level the
    node ``(child >> 1) - 1`` decides the branch ``child & 1`` of the
    class's leaf ``y + 2**depth``.  The batch mean of the summed binary
    CEs.  Tables ``_{name}.w0`` [nodes, D], ``_{name}.wbias`` [nodes]."""
    name = name or next_name("hsigmoid")
    # log2 in float32, as the reference takes it
    depth = max(int(np.ceil(np.log2(np.float32(max(num_classes, 2))))), 1)
    wspec, bspec = _table_specs(name, 2 ** depth - 1, input.size)

    def forward(ctx, params, feat: Act, lab: Act) -> Act:
        x = feat.value
        B = x.shape[0]
        idx = lab.value.reshape(B).to(torch.long) + (1 << depth)
        w, b = params[wspec.name], params[bspec.name]
        losses = torch.zeros((B,), dtype=torch.float32, device=x.device)
        for level in range(depth):
            child = idx >> level
            logit = _row_logits(x, w, b, ((child >> 1) - 1)[:, None])[:, 0]
            losses = losses + O.binary_cross_entropy(
                logit, (child & 1).to(torch.float32))
        return Act(value=losses.mean())

    return LayerOutput(name, "hsigmoid_cost", 1, [input, label], forward,
                       [wspec, bspec])


# ---------------------------------------------------------------------------
# utility layers
# ---------------------------------------------------------------------------


def sampling_id(input: LayerOutput, *,
                name: Optional[str] = None) -> LayerOutput:
    """One id a row drawn from ``softmax(input)`` (``ops.categorical``):
    the reference's layer calls ``jax.random.categorical`` on its input,
    which takes it as logits.  int32 ids [B]."""
    name = name or next_name("sampling_id")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=O.categorical(ctx.next_rng(),
                                       a.value).to(torch.int32))

    return LayerOutput(name, "sampling_id", 1, [input], forward, [])


def multiplex(index: LayerOutput, inputs: Sequence[LayerOutput], *,
              name: Optional[str] = None) -> LayerOutput:
    """Row-wise select among the inputs by the integer ``index`` [B] (or
    [B, 1])."""
    name = name or next_name("multiplex")
    ins = list(inputs)

    def forward(ctx, params, idx: Act, *acts: Act) -> Act:
        stacked = torch.stack([a.value for a in acts], dim=1)  # [B, N, D]
        sel = idx.value.reshape(-1).to(torch.long)
        return Act(value=stacked[torch.arange(stacked.shape[0],
                                              device=sel.device), sel])

    return LayerOutput(name, "multiplex", ins[0].size, [index, *ins],
                       forward, [])


def pad(input: LayerOutput, *, pad_h=(0, 0), pad_w=(0, 0), pad_c=(0, 0),
        name: Optional[str] = None) -> LayerOutput:
    """Zero-pad an NHWC feature map by (before, after) along H, W and C."""
    name = name or next_name("pad")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=F.pad(a.value, (*pad_c, *pad_w, *pad_h)))

    node = LayerOutput(name, "pad", input.size + pad_c[0] + pad_c[1],
                       [input], forward, [])
    if "hw" in input.meta:
        h, w = input.meta["hw"]
        node.meta["hw"] = (h + pad_h[0] + pad_h[1], w + pad_w[0] + pad_w[1])
    return node


def rotate(input: LayerOutput, *, name: Optional[str] = None) -> LayerOutput:
    """Rotate an NHWC feature map by 90 degrees (``rot90`` over H, W)."""
    name = name or next_name("rotate")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=torch.rot90(a.value, 1, dims=(1, 2)))

    node = LayerOutput(name, "rotate", input.size, [input], forward, [])
    if "hw" in input.meta:
        h, w = input.meta["hw"]
        node.meta["hw"] = (w, h)
    return node


def featmap_expand(input: LayerOutput, *, num_filters: int,
                   name: Optional[str] = None) -> LayerOutput:
    """Repeat each feature ``num_filters`` times along the last axis."""
    name = name or next_name("featmap_expand")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=torch.repeat_interleave(a.value, num_filters,
                                                 dim=-1))

    return _inherit_meta(LayerOutput(name, "featmap_expand",
                                     input.size * num_filters, [input],
                                     forward, []), input)


def block_expand(input: LayerOutput, *, block_x: int, block_y: int,
                 stride_x: int, stride_y: int,
                 name: Optional[str] = None) -> LayerOutput:
    """im2col: an NHWC image -> the sequence of its patches [B, n_blocks,
    C*block_y*block_x] (channel-major features), full length."""
    name = name or next_name("block_expand")
    h, w = input.meta.get("hw", (None, None))
    C = input.size
    n = ((h - block_y) // stride_y + 1) * ((w - block_x) // stride_x + 1)

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        B = x.shape[0]
        patches = F.unfold(x.permute(0, 3, 1, 2), (block_y, block_x),
                           stride=(stride_y, stride_x))  # [B, C*by*bx, n]
        return Act(value=patches.transpose(1, 2),
                   lengths=torch.full((B,), n, dtype=torch.int32,
                                      device=x.device),
                   mask=torch.ones((B, n), dtype=torch.float32,
                                   device=x.device))

    return LayerOutput(name, "block_expand", C * block_x * block_y,
                       [input], forward, [])


def sub_seq(input: LayerOutput, offsets: LayerOutput, sizes: LayerOutput, *,
            name: Optional[str] = None) -> LayerOutput:
    """Each row's subsequence [offset, offset + size), repadded at the
    front; positions past the row's end are clipped to T - 1."""
    name = name or next_name("sub_seq")

    def forward(ctx, params, a: Act, off: Act, sz: Act) -> Act:
        _refuse_packed(a, name, "sub_seq")
        T = a.value.shape[1]
        o = off.value.reshape(-1).to(torch.long)
        s = sz.value.reshape(-1).to(torch.int32)
        steps = torch.arange(T, device=o.device)
        pos = torch.clamp(o[:, None] + steps[None, :], 0, T - 1)
        v = torch.gather(a.value, 1,
                         pos[..., None].expand(-1, -1, a.value.shape[2]))
        mask = (steps[None, :] < s[:, None]).to(torch.float32)
        return Act(value=v * mask[..., None].to(v.dtype), lengths=s,
                   mask=mask)

    return LayerOutput(name, "sub_seq", input.size, [input, offsets, sizes],
                       forward, [])


def seq_reshape(input: LayerOutput, reshape_size: int, *,
                name: Optional[str] = None) -> LayerOutput:
    """[B, T, D] -> [B, T*D/reshape_size, reshape_size]; each length scaled
    by D/reshape_size through float32 and truncated, as the reference's."""
    name = name or next_name("seq_reshape")

    def forward(ctx, params, a: Act) -> Act:
        _refuse_packed(a, name, "seq_reshape")
        B, T, D = a.value.shape
        T2 = T * D // reshape_size
        v = a.value.reshape(B, T2, reshape_size)
        lengths = (a.lengths.to(torch.float32)
                   * (D / reshape_size)).to(torch.int32)
        mask = O.mask_from_lengths(lengths, T2)
        return Act(value=v * mask[..., None].to(v.dtype), lengths=lengths,
                   mask=mask)

    return LayerOutput(name, "seq_reshape", reshape_size, [input], forward,
                       [])


def eos_trim(input: LayerOutput, *, eos_id: int = 1,
             name: Optional[str] = None) -> LayerOutput:
    """Cut each id sequence at its first ``eos_id`` (the EOS itself
    dropped), never past its own length."""
    name = name or next_name("eos_trim")

    def forward(ctx, params, a: Act) -> Act:
        _refuse_packed(a, name, "eos_trim")
        ids = a.value
        is_eos = ids == eos_id
        # argmax of a 0/1 int tensor: the first EOS
        first = torch.argmax(is_eos.to(torch.int32), dim=1)
        new_len = torch.where(is_eos.any(dim=1), first,
                              a.lengths.to(first.dtype)).to(torch.int32)
        new_len = torch.minimum(new_len, a.lengths.to(torch.int32))
        mask = O.mask_from_lengths(new_len, ids.shape[1])
        return Act(value=ids * mask.to(ids.dtype), lengths=new_len,
                   mask=mask)

    return LayerOutput(name, "eos_trim", input.size, [input], forward, [])


def slice_channels(input: LayerOutput, start: int, end: int,
                   name: Optional[str] = None) -> LayerOutput:
    """Channel/feature sub-range [start, end) of a layer (the reference's
    slice projection); for feature maps, of the last (channel) axis."""
    name = name or next_name("slice")
    if not (0 <= start < end <= input.size):
        raise ConfigError(
            f"slice_channels {name!r}: range [{start}, {end}) invalid for "
            f"input size {input.size}")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=a.value[..., start:end], lengths=a.lengths,
                   mask=a.mask)

    return _inherit_meta(LayerOutput(name, "slice_channels", end - start,
                                     [input], forward, []), input)
