"""Counterpart of ``paddle_tpu/nn/layers_extra2.py``, the long tail of the
reference's layer inventory, every layer of it: ``prelu``, ``trans``,
``resize``, ``data_norm``, ``conv_shift``, ``linear_comb`` /
``convex_comb``, ``cos_vm``, ``get_output``, ``lambda_cost``,
``selective_fc`` (dense-mask, candidate-id and sparse-input paths),
``spp``, ``priorbox``, ``eos_id``, ``img_conv_transpose``,
``mdlstmemory``, ``cross_channel_norm`` and ``print_value``.

The reference computes them with plain ``jnp`` and ``lax.scan``
(``mdlstmemory``: two nested scans), so the port runs PyTorch's own ops,
its row products through ``ops.linear``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (Act, LayerOutput, ParamAttr,
                                       ParamSpec, next_name)
from paddle_tpu_torch.nn.layers import (AttrLike, _bias_attr, _inherit_meta,
                                        _pa, _seq_like, _spatial)
from paddle_tpu_torch.utils.error import ConfigError

#: the reference module's layers that are not ported yet: none
NOT_PORTED = ()

__all__ = ["prelu", "trans", "resize", "data_norm", "conv_shift",
           "linear_comb", "convex_comb", "cos_vm", "get_output",
           "lambda_cost", "selective_fc", "spp", "priorbox", "eos_id",
           "img_conv_transpose", "mdlstmemory", "cross_channel_norm",
           "print_value"]


def prelu(input: LayerOutput, *, name: Optional[str] = None,
          param_attr: AttrLike = None,
          channel_shared: bool = False) -> LayerOutput:
    """Parametric ReLU, ``max(0, x) + a * min(0, x)`` with a learned slope
    ``_{name}.w0`` a feature ([1] with ``channel_shared``), zeros at
    init."""
    name = name or next_name("prelu")
    pa = _pa(param_attr, f"_{name}.w0", init="normal", initial_std=0.0)
    spec = ParamSpec(name=pa.name,
                     shape=(1,) if channel_shared else (input.size,),
                     attr=pa)

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        slope = params[spec.name].to(x.dtype)
        y = torch.clamp(x, min=0) + slope * torch.clamp(x, max=0)
        return _seq_like(a, y) if a.is_seq else Act(value=y)

    return LayerOutput(name, "prelu", input.size, [input], forward, [spec])


def trans(input: LayerOutput, *, name: Optional[str] = None) -> LayerOutput:
    """Transpose each sample's [H, W] matrix: a feature map [B, H, W, C] ->
    [B, W, H, C], or a flat square [B, S*S] through [B, S, S]."""
    name = name or next_name("trans")
    if "hw" in input.meta:
        h, w = input.meta["hw"]
        c = input.size
    else:
        side = int(round(input.size ** 0.5))
        if side * side != input.size:
            raise ConfigError("trans needs spatial meta or a square size")
        h = w = side
        c = None

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        if c is not None:
            return Act(value=x.transpose(1, 2))
        b = x.shape[0]
        return Act(value=x.reshape(b, h, w).transpose(1, 2).reshape(b,
                                                                    h * w))

    out = LayerOutput(name, "trans", input.size, [input], forward, [])
    if c is not None:
        out.meta["hw"] = (w, h)
    return out


def resize(input: LayerOutput, size: int, *,
           name: Optional[str] = None) -> LayerOutput:
    """The batch's values re-cut into rows of ``size``."""
    name = name or next_name("resize")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=a.value.reshape(-1, size))

    return LayerOutput(name, "resize", size, [input], forward, [])


def data_norm(input: LayerOutput, *, strategy: str = "z-score",
              name: Optional[str] = None) -> LayerOutput:
    """Normalise features by statistics kept in the layer's state
    (``_{name}.mean``/``.var``/``.min``/``.max``): z-score, min-max or
    decimal scaling.  In training it normalises by the batch's statistics
    (population variance) and writes the state's new values (a 0.99
    moving average of mean and variance, the running min and max) to
    ``ctx.updated_state``."""
    if strategy not in ("z-score", "min-max", "decimal-scaling"):
        raise ConfigError(f"unknown data_norm strategy {strategy!r}")
    name = name or next_name("data_norm")
    D = input.size

    def state(suffix, init):
        return ParamSpec(f"_{name}.{suffix}", (D,), ParamAttr(init=init),
                         is_state=True)

    mean_s, var_s = state("mean", "zeros"), state("var", "ones")
    min_s, max_s = state("min", "zeros"), state("max", "ones")

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        mean, var = params[mean_s.name], params[var_s.name]
        mn, mx = params[min_s.name], params[max_s.name]
        if ctx.train:
            m = x.mean(dim=0)
            v = x.var(dim=0, correction=0)
            bmn, bmx = torch.amin(x, dim=0), torch.amax(x, dim=0)
            mom = 0.99
            ctx.updated_state[mean_s.name] = mom * mean + (1 - mom) * m
            ctx.updated_state[var_s.name] = mom * var + (1 - mom) * v
            ctx.updated_state[min_s.name] = torch.minimum(mn, bmn)
            ctx.updated_state[max_s.name] = torch.maximum(mx, bmx)
            mean, var = m, v
            mn, mx = torch.minimum(mn, bmn), torch.maximum(mx, bmx)
        if strategy == "z-score":
            y = (x - mean) / torch.sqrt(var + 1e-6)
        elif strategy == "min-max":
            y = (x - mn) / torch.clamp(mx - mn, min=1e-6)
        else:
            top = torch.clamp(torch.maximum(mn.abs(), mx.abs()), min=1e-6)
            y = x / torch.pow(10.0, torch.ceil(torch.log10(top)))
        return Act(value=y)

    return LayerOutput(name, "data_norm", D, [input], forward,
                       [mean_s, var_s, min_s, max_s])


def conv_shift(a: LayerOutput, b: LayerOutput, *,
               name: Optional[str] = None) -> LayerOutput:
    """Circular convolution of a [B, M] with the kernel b [B, N], N odd:
    ``out[i] = sum_j b[j] * a[(i + j - (N-1)/2) mod M]``."""
    name = name or next_name("conv_shift")
    N = b.size
    if N % 2 == 0:
        raise ConfigError("conv_shift kernel size must be odd")
    half = (N - 1) // 2

    def forward(ctx, params, xa: Act, xb: Act) -> Act:
        x, k = xa.value, xb.value
        y = sum(k[:, j:j + 1] * torch.roll(x, -(j - half), dims=1)
                for j in range(N))
        return Act(value=y)

    return LayerOutput(name, "conv_shift", a.size, [a, b], forward, [])


def linear_comb(weights: LayerOutput, input: LayerOutput, size: int, *,
                name: Optional[str] = None) -> LayerOutput:
    """``input`` [B, K*size] as K vectors, combined by ``weights`` [B, K]:
    ``sum_k w_k v_k`` [B, size]."""
    name = name or next_name("linear_comb")
    if input.size % size != 0:
        raise ConfigError("linear_comb: input.size must be K*size")
    K = input.size // size

    def forward(ctx, params, wa: Act, va: Act) -> Act:
        v = va.value.reshape(-1, K, size)
        return Act(value=(wa.value[:, :, None] * v).sum(1))

    return LayerOutput(name, "linear_comb", size, [weights, input], forward,
                       [])


def convex_comb(weights: LayerOutput, input: LayerOutput, size: int, *,
                name: Optional[str] = None) -> LayerOutput:
    """``linear_comb`` under its other registered name."""
    return linear_comb(weights, input, size, name=name)


def cos_vm(vec: LayerOutput, mat: LayerOutput, *, scale: float = 1.0,
           name: Optional[str] = None) -> LayerOutput:
    """Cosine similarity of vec [B, D] with each of the K vectors of mat
    [B, K*D] -> [B, K], times ``scale``."""
    name = name or next_name("cos_vm")
    D = vec.size
    if mat.size % D != 0:
        raise ConfigError("cos_vm: mat.size must be K*vec.size")
    K = mat.size // D

    def forward(ctx, params, va: Act, ma: Act) -> Act:
        v = va.value
        m = ma.value.reshape(-1, K, D)
        num = (v[:, None, :] * m).sum(-1)
        den = (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
               * torch.linalg.vector_norm(m, dim=-1) + 1e-8)
        return Act(value=scale * num / den)

    return LayerOutput(name, "cos_vm", K, [vec, mat], forward, [])


def get_output(input: LayerOutput, key: str, *, size: Optional[int] = None,
               name: Optional[str] = None) -> LayerOutput:
    """The aux output ``key`` of a layer (its ``Act.state[key]``), e.g.
    ``lstm_step``'s cell state ``'state'``."""
    name = name or next_name("get_output")

    def forward(ctx, params, a: Act) -> Act:
        if key not in a.state:
            raise ConfigError(
                f"get_output: {input.name!r} has no aux output {key!r}; "
                f"available: {sorted(a.state)}")
        return Act(value=a.state[key])

    return LayerOutput(name, "get_output", size or input.size, [input],
                       forward, [])


def lambda_cost(score: LayerOutput, label: LayerOutput, *,
                NDCG_num: int = 5, name: Optional[str] = None
                ) -> LayerOutput:
    """LambdaRank: the pairwise logistic loss over one query's documents
    (a sequence), each pair with a higher-relevance first document weighted
    by its |delta NDCG@NDCG_num| at the ranks the current scores give
    (a stable sort, as ``jnp.argsort``'s); summed, over the real
    documents' count."""
    name = name or next_name("lambda_cost")

    def forward(ctx, params, sa: Act, la: Act) -> Act:
        s, rel = sa.value, la.value
        if s.dim() == 3:
            s = s[..., 0]
        if rel.dim() == 3:
            rel = rel[..., 0]
        mask = sa.mask if sa.mask is not None else torch.ones_like(s)
        T = s.shape[1]
        gain = (torch.pow(2.0, rel) - 1.0) * mask
        k = min(NDCG_num, T)
        top = torch.topk(gain, k, dim=1).values
        disc = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32,
                                             device=s.device))
        idcg = torch.clamp((top * disc).sum(1, keepdim=True), min=1e-6)
        order = torch.argsort(-s, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True).to(torch.float32)
        dfac = 1.0 / torch.log2(ranks + 2.0)
        dg = gain[:, :, None] - gain[:, None, :]
        dd = dfac[:, :, None] - dfac[:, None, :]
        dndcg = (dg * dd).abs() / idcg[:, :, None]
        ds = s[:, :, None] - s[:, None, :]
        rel_gt = (rel[:, :, None] > rel[:, None, :]).to(s.dtype)
        pair_mask = mask[:, :, None] * mask[:, None, :]
        loss = (torch.log1p(torch.exp(-torch.clamp(ds, -30, 30))) * rel_gt
                * dndcg * pair_mask)
        return Act(value=loss.sum() / torch.clamp(mask.sum(), min=1.0))

    return LayerOutput(name, "lambda_cost", 1, [score, label], forward, [])


def _selective_specs(inputs, size, name, param_attr, bias_attr):
    """Weights ``_{name}.w{i}`` [in_i, size], one an input, and the bias
    ``_{name}.wbias`` [size] -> (weight specs, all specs, bias attr)."""
    wspecs = []
    for i, ipt in enumerate(inputs):
        pa = _pa(param_attr if len(inputs) == 1 else None, f"_{name}.w{i}")
        wspecs.append(ParamSpec(name=pa.name, shape=(ipt.size, size),
                                attr=pa))
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    specs = list(wspecs)
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(size,), attr=ba))
    return wspecs, specs, ba


def selective_fc(input, select: LayerOutput, size: int, *,
                 act: str = "tanh", name: Optional[str] = None,
                 param_attr: AttrLike = None, bias_attr: AttrLike = True,
                 select_mode: str = "mask") -> LayerOutput:
    """An fc evaluated on selected output columns only.  Several inputs get
    separate weights, summed, as in ``fc``.

    - ``select_mode='mask'``: ``select`` is a dense 0/1 [B, size]; the fc
      runs densely and its unselected outputs are exactly 0 after ``act``.
      A sparse first input is multiplied by row gather
      (``sparse_gather_matmul``).
    - ``select_mode='ids'``: ``select`` holds candidate ids [B, C]; only
      those columns of the weight (and of the bias) are gathered and
      multiplied (``selective_columns_matmul``).  The output is [B, C],
      column j scoring candidate ``select[b, j]``, times ``select``'s mask
      where it is a sequence; ``state['sel_ids']`` keeps the ids.
    """
    if select_mode not in ("mask", "ids"):
        raise ConfigError(f"select_mode must be 'mask' or 'ids', got "
                          f"{select_mode!r}")
    name = name or next_name("selective_fc")
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    wspecs, specs, ba = _selective_specs(inputs, size, name, param_attr,
                                         bias_attr)
    act_fn = O.get_activation(act)

    if select_mode == "ids":
        def forward_ids(ctx, params, *acts: Act) -> Act:
            sel = acts[-1]
            y = None
            for i, (spec, a) in enumerate(zip(wspecs, acts[:-1])):
                z = O.selective_columns_matmul(
                    a.value, sel.value, params[spec.name],
                    params[ba.name] if (ba and i == 0) else None)
                y = z if y is None else y + z
            y = act_fn(y)
            if sel.mask is not None:
                y = y * sel.mask.to(y.dtype)
            return Act(value=y, state={"sel_ids": sel.value})

        out = LayerOutput(name, "selective_fc", select.size,
                          [*inputs, select], forward_ids, specs)
        out.meta["select_mode"] = "ids"
        return out

    sparse_kinds = ([ipt.meta.get("sparse") for ipt in inputs]
                    if inputs[0].meta.get("sparse") else [None] * len(inputs))

    def forward(ctx, params, *acts: Act) -> Act:
        sel = acts[-1]
        y = None
        for spec, a, sparse in zip(wspecs, acts[:-1], sparse_kinds):
            if sparse:
                z = O.sparse_gather_matmul(
                    a.value, a.state["weights"],
                    a.state.get("nnz_mask", a.mask), params[spec.name])
            else:
                z = O.linear(a.value, params[spec.name])
            y = z if y is None else y + z
        if ba:
            y = y + params[ba.name].to(y.dtype)
        return Act(value=act_fn(y) * sel.value.to(y.dtype))

    return LayerOutput(name, "selective_fc", size, [*inputs, select],
                       forward, specs)


def spp(input: LayerOutput, *, pyramid_height: int = 3,
        pool_type: str = "max", name: Optional[str] = None) -> LayerOutput:
    """Spatial pyramid pooling: the feature map pooled (max or mean) into
    1x1, 2x2, ... 2^(h-1) grids of nearly even cells, concatenated ->
    [B, C * sum(b*b)]."""
    name = name or next_name("spp")
    h, w = _spatial(input)
    C = input.size
    bins = [2 ** i for i in range(pyramid_height)]

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        parts: List[torch.Tensor] = []
        for b in bins:
            hs = [h * i // b for i in range(b + 1)]
            ws = [w * i // b for i in range(b + 1)]
            for i in range(b):
                for j in range(b):
                    cell = x[:, hs[i]:max(hs[i + 1], hs[i] + 1),
                             ws[j]:max(ws[j + 1], ws[j] + 1), :]
                    parts.append(torch.amax(cell, dim=(1, 2))
                                 if pool_type == "max"
                                 else cell.mean(dim=(1, 2)))
        return Act(value=torch.cat(parts, dim=-1))

    return LayerOutput(name, "spp", C * sum(b * b for b in bins), [input],
                       forward, [])


def priorbox(input: LayerOutput, image: LayerOutput, *,
             min_size: Sequence[int], max_size: Sequence[int] = (),
             aspect_ratio: Sequence[float] = (2.0,),
             variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
             name: Optional[str] = None) -> LayerOutput:
    """SSD prior boxes: for each cell of ``input``'s feature map, boxes of
    each min size and aspect ratio and each max size, in coordinates
    normalised by ``image``'s size, clipped to [0, 1].  A constant built
    here: [1, 2, K*4], row 0 the boxes, row 1 their variances."""
    name = name or next_name("priorbox")
    fh, fw = _spatial(input)
    ih, iw = _spatial(image)
    ratios = [1.0]
    for ar in aspect_ratio:
        ratios.extend((ar, 1.0 / ar))
    num_priors = len(ratios) * len(min_size) + len(max_size)
    K = fh * fw * num_priors
    boxes = np.zeros((fh, fw, num_priors, 4), np.float32)
    for i in range(fh):
        for j in range(fw):
            cx, cy = (j + 0.5) / fw, (i + 0.5) / fh
            p = 0
            for ms in min_size:
                for r in ratios:
                    bw = ms * (r ** 0.5) / iw
                    bh = ms / (r ** 0.5) / ih
                    boxes[i, j, p] = [cx - bw / 2, cy - bh / 2,
                                      cx + bw / 2, cy + bh / 2]
                    p += 1
            for k, Ms in enumerate(max_size):
                s = (min_size[min(k, len(min_size) - 1)] * Ms) ** 0.5
                boxes[i, j, p] = [cx - s / 2 / iw, cy - s / 2 / ih,
                                  cx + s / 2 / iw, cy + s / 2 / ih]
                p += 1
    boxes = np.clip(boxes, 0.0, 1.0).reshape(-1)
    var = np.tile(np.asarray(variance, np.float32), K)
    const = torch.from_numpy(np.stack([boxes, var])[None])  # [1, 2, K*4]

    def forward(ctx, params, a: Act, img: Act) -> Act:
        return Act(value=const.to(a.value.device))

    return LayerOutput(name, "priorbox", K * 4, [input, image], forward, [])


def eos_id(input: LayerOutput, *, eos_id: int = 1,
           name: Optional[str] = None) -> LayerOutput:
    """1.0 where the id equals ``eos_id`` (0 on a sequence's padding)."""
    name = name or next_name("eos_id")

    def forward(ctx, params, a: Act) -> Act:
        flag = (a.value == eos_id).to(torch.float32)
        return _seq_like(a, flag * a.mask) if a.is_seq else Act(value=flag)

    return LayerOutput(name, "eos_id", 1, [input], forward, [])


def img_conv_transpose(input: LayerOutput, *, filter_size: int,
                       num_filters: int, stride: int = 1, act: str = "relu",
                       name: Optional[str] = None,
                       param_attr: AttrLike = None,
                       bias_attr: AttrLike = True) -> LayerOutput:
    """Transposed convolution with SAME padding (``ops.conv2d_transpose``):
    output H, W = input H, W * stride; weight ``w0`` [filter_size,
    filter_size, C, num_filters], bias ``wbias``."""
    name = name or next_name("convt")
    h, w = _spatial(input)
    pa = _pa(param_attr, f"_{name}.w0")
    wspec = ParamSpec(name=pa.name, shape=(filter_size, filter_size,
                                           input.size, num_filters), attr=pa)
    specs = [wspec]
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(num_filters,), attr=ba))
    act_fn = O.get_activation(act)

    def forward(ctx, params, a: Act) -> Act:
        y = O.conv2d_transpose(a.value, params[wspec.name],
                               stride=(stride, stride), padding="SAME")
        if ba:
            y = y + params[ba.name].to(y.dtype)
        return Act(value=act_fn(y))

    out = LayerOutput(name, "convt", num_filters, [input], forward, specs)
    out.meta["hw"] = (h * stride, w * stride)
    return out


def mdlstmemory(input: LayerOutput, size: int, *, act: str = "tanh",
                name: Optional[str] = None, param_attr: AttrLike = None,
                bias_attr: AttrLike = True) -> LayerOutput:
    """A 2-D LSTM over a feature map [B, H, W, C] -> [B, H, W, size]: each
    cell reads its LEFT and TOP neighbours, with a forget gate for each;
    gate layout [i, f_left, f_top, o, g].  Rows run outside, columns
    inside, as the reference's two nested scans.  Weights ``_{name}.wx``
    [C, 5H] (built from the attribute named ``.w0``), ``.wl``, ``.wt`` [H,
    5H], bias ``.wbias`` [5H]."""
    name = name or next_name("mdlstm")
    h, w = _spatial(input)
    C, H = input.size, size
    wx = ParamSpec(f"_{name}.wx", (C, 5 * H), _pa(param_attr, f"_{name}.w0"))
    wl = ParamSpec(f"_{name}.wl", (H, 5 * H), _pa(param_attr, f"_{name}.wl"))
    wt = ParamSpec(f"_{name}.wt", (H, 5 * H), _pa(param_attr, f"_{name}.wt"))
    specs = [wx, wl, wt]
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(5 * H,), attr=ba))
    act_fn = O.get_activation(act)
    sig = O.get_activation("sigmoid")

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        B, rows, cols = x.shape[:3]
        xp = O.linear(x, params[wx.name],
                      params[ba.name] if ba else None)   # [B, h, w, 5H]
        w_l, w_t = params[wl.name], params[wt.name]
        zero = torch.zeros((B, H), dtype=xp.dtype, device=xp.device)
        h_top = c_top = [zero] * cols
        out_rows = []
        for i in range(rows):
            h_left = c_left = zero
            h_row, c_row = [], []
            for j in range(cols):
                z = (xp[:, i, j] + O.linear(h_left, w_l)
                     + O.linear(h_top[j], w_t))
                gi, fl, ft, go, g = torch.chunk(z, 5, dim=-1)
                c_left = (sig(fl) * c_left + sig(ft) * c_top[j]
                          + sig(gi) * act_fn(g))
                h_left = sig(go) * act_fn(c_left)
                h_row.append(h_left)
                c_row.append(c_left)
            h_top, c_top = h_row, c_row
            out_rows.append(torch.stack(h_row, dim=1))
        return Act(value=torch.stack(out_rows, dim=1))   # [B, h, w, H]

    out = LayerOutput(name, "mdlstm", H, [input], forward, specs)
    out.meta["hw"] = (h, w)
    return out


def cross_channel_norm(input: LayerOutput, *, name: Optional[str] = None,
                       param_attr: AttrLike = None) -> LayerOutput:
    """Each pixel's L2 normalisation across channels, times a trainable
    per-channel scale ``_{name}.w0`` (ones at init): the SSD block."""
    name = name or next_name("cross_channel_norm")
    C = input.size
    pa = _pa(param_attr, f"_{name}.w0", init="ones")
    sspec = ParamSpec(name=pa.name, shape=(C,), attr=pa)

    def forward(ctx, params, a: Act) -> Act:
        x = a.value
        norm = torch.sqrt(x.float().square().sum(-1, keepdim=True) + 1e-12)
        return Act(value=(x / norm.to(x.dtype))
                   * params[sspec.name].to(x.dtype))

    return _inherit_meta(LayerOutput(name, "cross_channel_norm", C, [input],
                                     forward, [sspec]), input)


def print_value(input: LayerOutput, *, message: Optional[str] = None,
                name: Optional[str] = None) -> LayerOutput:
    """A debug layer: prints ``message`` (the layer's name by default),
    literally, and its input's values at each forward, and passes the input
    through unchanged.  On the card the print reads the tensor back to the
    host, a synchronisation every step it runs."""
    name = name or next_name("print")
    label = message or name

    def forward(ctx, params, a: Act) -> Act:
        print(f"{label}: {a.value.detach().cpu()}", flush=True)
        return a

    return _inherit_meta(LayerOutput(name, "print", input.size, [input],
                                     forward, []), input)
