"""Prebuilt network helpers — counterpart of ``paddle_tpu/v2/networks.py``
for the recurrent ones the seqToseq generation net uses:
``simple_attention``, ``gru_unit``, ``gru_group``, ``simple_gru`` and
``bidirectional_gru``.

Each composes the port's layer DSL as the reference composes its own, with
the same parameter names and shapes, so a JAX parameter dict carries
across.  Not ported yet: the image, LSTM and sequence-conv helpers, and
the recording of helper calls for config serialization.
"""

from __future__ import annotations

from typing import Optional

import torch

import paddle_tpu_torch.nn as _nn
import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (Act, LayerOutput, ParamAttr,
                                       ParamSpec, next_name)

__all__ = ["simple_gru", "gru_unit", "gru_group", "bidirectional_gru",
           "simple_attention"]


def simple_gru(input, size, *, act="tanh", gate_act="sigmoid", name=None):
    """D->3H mixing + recurrent GRU: ``grumemory`` owns the input
    projection, so it is ``grumemory`` alone."""
    return _nn.grumemory(input, size, act=act, gate_act=gate_act, name=name)


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


def bidirectional_gru(input, size, *, return_unmerged=False, name=None):
    """Forward + reverse ``grumemory``, concatenated (or both returned)."""
    fwd = _nn.grumemory(input, size, name=name and f"{name}_fw")
    bwd = _nn.grumemory(input, size, reverse=True,
                        name=name and f"{name}_bw")
    if return_unmerged:
        return fwd, bwd
    return _nn.concat([fwd, bwd], name=name)


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
