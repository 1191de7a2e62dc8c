"""Prebuilt network helpers — counterpart of ``paddle_tpu/v2/networks.py``,
every helper of it: the image ones (``simple_img_conv_pool``,
``img_conv_bn_pool``, ``img_conv_group``, ``small_vgg``,
``vgg_16_network``), the recurrent ones (``simple_lstm``, ``simple_gru``,
``simple_gru2``, ``lstmemory_unit``, ``lstmemory_group``, ``gru_unit``,
``gru_group``, ``bidirectional_lstm``, ``bidirectional_gru``),
``sequence_conv_pool`` and ``simple_attention``.

Each composes the port's layer DSL as the reference composes its own, with
the same layer and parameter names and shapes, so a JAX parameter dict
carries across.  Not ported: the recording of helper calls for config
serialization.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

import paddle_tpu_torch.nn as _nn
import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (Act, LayerOutput, ParamAttr,
                                       ParamSpec, next_name)

__all__ = ["simple_img_conv_pool", "img_conv_bn_pool", "img_conv_group",
           "small_vgg", "vgg_16_network", "simple_lstm", "simple_gru",
           "simple_gru2", "lstmemory_unit", "lstmemory_group", "gru_unit",
           "gru_group", "bidirectional_lstm", "bidirectional_gru",
           "sequence_conv_pool", "simple_attention"]


def simple_img_conv_pool(input, filter_size, num_filters, pool_size, *,
                         conv_stride=1, conv_padding=0, pool_stride=1,
                         pool_padding=0, act="relu", pool_type="max",
                         name=None):
    """conv + pool, the mnist/LeNet block: a VALID conv (``conv_padding``
    0) and stride-1 pooling by default, as the reference's."""
    conv = _nn.img_conv(input, filter_size=filter_size,
                        num_filters=num_filters, stride=conv_stride,
                        padding=conv_padding, act=act,
                        name=name and f"{name}_conv")
    return _nn.img_pool(conv, pool_size=pool_size, stride=pool_stride,
                        padding=pool_padding, pool_type=pool_type,
                        name=name and f"{name}_pool")


def img_conv_bn_pool(input, filter_size, num_filters, pool_size, *,
                     conv_stride=1, conv_padding=0, pool_stride=1,
                     pool_padding=0, act="relu", pool_type="max", name=None):
    """conv -> batch_norm -> pool: the conv is linear, the activation sits
    on the batch norm."""
    conv = _nn.img_conv(input, filter_size=filter_size,
                        num_filters=num_filters, stride=conv_stride,
                        padding=conv_padding, act="linear",
                        name=name and f"{name}_conv")
    bn = _nn.batch_norm(conv, act=act, name=name and f"{name}_bn")
    return _nn.img_pool(bn, pool_size=pool_size, stride=pool_stride,
                        padding=pool_padding, pool_type=pool_type,
                        name=name and f"{name}_pool")


def img_conv_group(input, conv_num_filter: Sequence[int], *,
                   conv_filter_size=3, conv_act="relu", conv_padding=1,
                   pool_size=2, pool_stride=1, pool_type="max",
                   conv_batchnorm=False, conv_batchnorm_drop_rate=0,
                   name=None):
    """N stacked convs then one pool, the VGG block (3x3 convs padded by 1
    and stride-1 pooling by default).  ``conv_batchnorm_drop_rate``, a
    scalar or one rate per conv, adds dropout after each batch norm."""
    h = input
    drops = conv_batchnorm_drop_rate
    if not hasattr(drops, "__len__"):
        drops = [drops] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        h = _nn.img_conv(h, filter_size=conv_filter_size, num_filters=nf,
                         padding=conv_padding,
                         act="linear" if conv_batchnorm else conv_act,
                         name=name and f"{name}_conv{i}")
        if conv_batchnorm:
            h = _nn.batch_norm(h, act=conv_act,
                               name=name and f"{name}_bn{i}")
            if drops[i]:
                h = _nn.dropout(h, drops[i])
    return _nn.img_pool(h, pool_size=pool_size, stride=pool_stride,
                        pool_type=pool_type, name=name and f"{name}_pool")


def small_vgg(input_image, num_classes=10, *, name=None):
    """The CIFAR VGG of the reference's image demos: four batch-normed
    conv groups (64x2, 128x2, 256x3, 512x3) with their dropout schedule,
    then pool, dropout, fc512, dropout, batch norm, a softmax fc."""

    def block(ipt, nf, times, dropouts):
        return img_conv_group(ipt, [nf] * times, conv_filter_size=3,
                              conv_padding=1, conv_act="relu",
                              conv_batchnorm=True,
                              conv_batchnorm_drop_rate=dropouts,
                              pool_size=2, pool_stride=2)

    h = block(input_image, 64, 2, [0.3, 0])
    h = block(h, 128, 2, [0.4, 0])
    h = block(h, 256, 3, [0.4, 0.4, 0])
    h = block(h, 512, 3, [0.4, 0.4, 0])
    h = _nn.img_pool(h, pool_size=2, stride=2)
    h = _nn.dropout(h, 0.5)
    h = _nn.fc(h, 512, act="linear")
    h = _nn.dropout(h, 0.5)
    h = _nn.batch_norm(h, act="relu")
    return _nn.fc(h, num_classes, act="softmax", name=name)


def vgg_16_network(input_image, num_classes=1000, *, name=None):
    """VGG-16: conv groups 64x2/128x2/256x3/512x3/512x3, each with a 2x2
    stride-2 pool, then fc4096 x 2 (dropout 0.5) and a softmax fc."""
    h = input_image
    for nf, times in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        h = img_conv_group(h, [nf] * times, conv_filter_size=3,
                           conv_padding=1, conv_act="relu",
                           pool_size=2, pool_stride=2)
    h = _nn.fc(h, 4096, act="relu")
    h = _nn.dropout(h, 0.5)
    h = _nn.fc(h, 4096, act="relu")
    h = _nn.dropout(h, 0.5)
    return _nn.fc(h, num_classes, act="softmax", name=name)


def simple_lstm(input, size, *, act="tanh", gate_act="sigmoid", name=None):
    """D->4H mixing + recurrent LSTM: ``lstmemory`` owns the input
    projection, so it is ``lstmemory`` alone (``wx`` [D, 4H], ``w0``
    [H, 4H])."""
    return _nn.lstmemory(input, size, act=act, gate_act=gate_act, name=name)


def simple_gru(input, size, *, act="tanh", gate_act="sigmoid", name=None):
    """D->3H mixing + recurrent GRU: ``grumemory`` owns the input
    projection, so it is ``grumemory`` alone."""
    return _nn.grumemory(input, size, act=act, gate_act=gate_act, name=name)


def simple_gru2(input, size, *, act="tanh", gate_act="sigmoid",
                mixed_param_attr=None, gru_param_attr=None, reverse=False,
                name=None):
    """A mixed D->3H transform ``{name}_transform`` (with bias) and a
    ``grumemory`` over the pre-projection: the transform owns [D, 3H], the
    cell only the recurrent [H, 3H]."""
    name = name or next_name("simple_gru2")
    m = _nn.mixed(size * 3,
                  input=[_nn.full_matrix_projection(
                      input, param_attr=mixed_param_attr)],
                  bias_attr=True, name=f"{name}_transform")
    return _nn.grumemory(m, size, projected_input=True, act=act,
                         gate_act=gate_act, reverse=reverse,
                         param_attr=gru_param_attr, name=name)


def lstmemory_unit(input, out_mem, state_mem, *, size=None, act="tanh",
                   gate_act="sigmoid", state_act="tanh", param_attr=None,
                   mixed_bias_attr=False, lstm_bias_attr=True, name=None):
    """One LSTM step inside a ``recurrent_group`` step: a mixed layer
    ``{name}_input_recurrent`` sums identity(``input``, the [B, 4*size]
    pre-projected frame) and full_matrix(``out_mem``), then ``lstm_step``
    ``name`` applies the gates to ``state_mem``.  Returns h_t; c_t is
    ``get_output(h, 'state')``."""
    name = name or next_name("lstm_unit")
    if size is None:
        size = input.size // 4
    m = _nn.mixed(size * 4,
                  input=[_nn.identity_projection(input),
                         _nn.full_matrix_projection(out_mem,
                                                    param_attr=param_attr)],
                  bias_attr=mixed_bias_attr,
                  name=f"{name}_input_recurrent")
    return _nn.lstm_step(m, state_mem, size, act=act, gate_act=gate_act,
                         state_act=state_act, bias_attr=lstm_bias_attr,
                         name=name)


def lstmemory_group(input, size=None, *, reverse=False, act="tanh",
                    gate_act="sigmoid", state_act="tanh", param_attr=None,
                    mixed_bias_attr=False, lstm_bias_attr=True, name=None):
    """A recurrent-group LSTM over the [B, T, 4*size] pre-projection: the
    math of ``lstmemory(use_peepholes=False)``, with each step's h and c
    ordinary layers (memories ``{name}_out`` and ``{name}_state``; c_t
    reaches its memory through ``get_output(h, 'state')``).  The group
    node carries the helper's name."""
    name = name or next_name("lstm_group")
    if size is None:
        size = input.size // 4

    def _step(ipt, om, sm):
        h = lstmemory_unit(ipt, om, sm, size=size, act=act,
                           gate_act=gate_act, state_act=state_act,
                           param_attr=param_attr,
                           mixed_bias_attr=mixed_bias_attr,
                           lstm_bias_attr=lstm_bias_attr, name=name)
        c = _nn.get_output(h, "state", size=size)
        return [h, h, c]

    return _nn.recurrent_group(
        step=_step, input=[input],
        memories=[_nn.Memory(f"{name}_out", size),
                  _nn.Memory(f"{name}_state", size)],
        reverse=reverse, name=name)


def gru_unit(input, out_mem, *, size=None, act="tanh", gate_act="sigmoid",
             gru_param_attr=None, gru_bias_attr=True, naive=False,
             name=None):
    """One GRU step inside a ``recurrent_group``/``beam_search`` step:
    ``input`` is the [B, 3*size] x-projection, ``out_mem`` the group's h
    memory.  ``naive`` is accepted for the reference's signature (one
    implementation here)."""
    del naive
    if size is None:
        size = input.size // 3
    return _nn.gru_step(input, out_mem, size, act=act, gate_act=gate_act,
                        param_attr=gru_param_attr, bias_attr=gru_bias_attr,
                        name=name)


def gru_group(input, size=None, *, reverse=False, act="tanh",
              gate_act="sigmoid", gru_param_attr=None, gru_bias_attr=True,
              naive=False, name=None):
    """Recurrent-group GRU over the [B, T, 3*size] pre-projection; the group
    node carries the helper's name."""
    del naive
    name = name or next_name("gru_group")
    if size is None:
        size = input.size // 3

    def _step(ipt, om):
        h = gru_unit(ipt, om, size=size, act=act, gate_act=gate_act,
                     gru_param_attr=gru_param_attr,
                     gru_bias_attr=gru_bias_attr, name=name)
        return [h, h]

    return _nn.recurrent_group(
        step=_step, input=[input], memories=[_nn.Memory(f"{name}_out", size)],
        reverse=reverse, name=name)


def bidirectional_lstm(input, size, *, return_unmerged=False, name=None):
    """Forward + reverse ``lstmemory`` (``{name}_fw``, ``{name}_bw``),
    concatenated (or both returned)."""
    fwd = _nn.lstmemory(input, size, name=name and f"{name}_fw")
    bwd = _nn.lstmemory(input, size, reverse=True,
                        name=name and f"{name}_bw")
    if return_unmerged:
        return fwd, bwd
    return _nn.concat([fwd, bwd], name=name)


def bidirectional_gru(input, size, *, return_unmerged=False, name=None):
    """Forward + reverse ``grumemory``, concatenated (or both returned)."""
    fwd = _nn.grumemory(input, size, name=name and f"{name}_fw")
    bwd = _nn.grumemory(input, size, reverse=True,
                        name=name and f"{name}_bw")
    if return_unmerged:
        return fwd, bwd
    return _nn.concat([fwd, bwd], name=name)


def sequence_conv_pool(input, context_len, hidden_size, *,
                       context_start=None, pool_type="max", act="tanh",
                       name=None):
    """The text-CNN block: ``context_projection`` window, ``fc``, sequence
    pooling (``{name}_ctx``, ``{name}_fc``, ``{name}_pool``)."""
    ctx = _nn.context_projection(input, context_len=context_len,
                                 context_start=context_start,
                                 name=name and f"{name}_ctx")
    h = _nn.fc(ctx, hidden_size, act=act, name=name and f"{name}_fc")
    return _nn.pooling(h, pooling_type=pool_type,
                       name=name and f"{name}_pool")


def simple_attention(encoded_sequence, encoded_proj, decoder_state, *,
                     name: Optional[str] = None) -> LayerOutput:
    """Bahdanau additive attention inside a ``recurrent_group`` /
    ``beam_search`` step: ``encoded_sequence`` [B, S, D] and
    ``encoded_proj`` [B, S, A] arrive as StaticInputs (lengths and mask
    kept), ``decoder_state`` is the [B, H] memory.  Returns the [B, D]
    context (``state['weights']``: the attention weights).  Owns the
    decoder-state projection ``_{name}.w0`` [H, A] and the scoring vector
    ``_{name}.v`` [A] (normal, std 0.05)."""
    name = name or next_name("attention")
    H = decoder_state.size
    A = encoded_proj.size
    w_spec = ParamSpec(name=f"_{name}.w0", shape=(H, A),
                       attr=ParamAttr(name=f"_{name}.w0"))
    v_spec = ParamSpec(name=f"_{name}.v", shape=(A,),
                       attr=ParamAttr(name=f"_{name}.v", initial_std=0.05))

    def forward(ctx, params, enc_a: Act, proj_a: Act, state_a: Act) -> Act:
        enc = enc_a.value
        scores = O.additive_attention_scores(
            proj_a.value, state_a.value, params[w_spec.name],
            params[v_spec.name])
        mask = enc_a.mask if enc_a.mask is not None else torch.ones(
            enc.shape[:2], dtype=torch.float32, device=enc.device)
        context, weights = O.attend(scores, enc, mask)
        return Act(value=context, state={"weights": weights})

    return LayerOutput(name, "simple_attention", encoded_sequence.size,
                       [encoded_sequence, encoded_proj, decoder_state],
                       forward, [w_spec, v_spec])
