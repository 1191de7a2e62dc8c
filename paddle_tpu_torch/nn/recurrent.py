"""Recurrent groups and generation — counterpart of
``paddle_tpu/nn/recurrent.py``.

A recurrent group runs a sub-network built from the layer DSL frame by
frame over a sequence, with ``Memory`` edges carrying state from one frame
to the next and boot layers for t=0.  The step is built ONCE at config
time into a ``StepTopology`` (a graph with no device of its own: it runs
wherever the outer ``apply`` runs, since every feed is an ``Act`` already
there), and its parameters are hoisted into the group layer.

- ``recurrent_group`` walks the frames in a Python loop (``ops.scan_rnn``):
  where a row's sequence has ended its memories hold and its output is
  zero, as the reference's masked scan.  Over a nested sequence it walks
  the sub-sequences: each frame is itself a padded sequence [B, Ti, ...]
  with its own lengths and mask, an inner group in the step walks its
  tokens (its memories may boot from the outer step's layers), and a step
  whose output is a sequence gives a nested output [B, To, Ti, ...] with
  ``sub_lengths``.  A packed input is refused (the group has no
  per-segment carry reset).
- ``beam_search`` is the generation mode: the step takes the previous
  token ids, ends in a vocab-size logits layer, and is driven by
  ``SequenceGenerator``.
- ``SequenceGenerator.generate`` without callbacks runs the decode engine
  (``ops/decode.py::beam_decode``) with ``LogitsReadout``, whose
  ``topk_lse_logits`` kernel reads each step's logits once.  The callback
  and trace protocol needs the full per-step log-probs and a record of
  every step, so it keeps the reference's fixed-length loop.

Token ids are int64 (the reference's are int32; the values agree).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import torch

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (Act, LayerOutput, StepTopology,
                                       next_name)
from paddle_tpu_torch.nn.layers import _refuse_packed
from paddle_tpu_torch.nn.layers import data as data_layer
from paddle_tpu_torch.ops.decode import (NEG, LogitsReadout, _finalize,
                                         beam_decode, beam_gather)
from paddle_tpu_torch.ops.kernels.topk_readout import stable_topk
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["Memory", "StaticInput", "GeneratedInput", "recurrent_group",
           "beam_search", "SequenceGenerator"]


@dataclass
class Memory:
    """Recurrent state slot: carries the step's memory-update layer from
    frame t to t+1.  ``boot`` (a layer producing [B, size]) seeds t=0;
    default zeros."""

    name: str
    size: int
    boot: Optional[LayerOutput] = None


@dataclass
class StaticInput:
    """Per-sequence (not per-frame) input visible to every step, with its
    lengths and mask (a step may attend over it)."""

    input: LayerOutput


@dataclass
class GeneratedInput:
    """The generated-token slot of a ``beam_search`` step: at step t it
    carries the token chosen at t-1 (``bos_id`` at t=0).  The step embeds
    it itself (an ``embedding`` layer inside the step)."""

    size: int          # vocabulary size
    bos_id: int = 0
    eos_id: int = 1


def _build_step(step: Callable, lead, name: str, static_inputs, memories):
    """Call ``step`` once on data layers named as the reference names them
    -> (static layers, memory layers, output layer, memory updates)."""
    static_layers = [data_layer(f"__{name}_static{i}__", size=l.size)
                     for i, l in enumerate(static_inputs)]
    mem_layers = [data_layer(f"__{name}_mem_{m.name}__", size=m.size)
                  for m in memories]
    result = step(*lead, *static_layers, *mem_layers)
    if isinstance(result, LayerOutput):
        result = [result]
    out_layer, mem_updates = result[0], list(result[1:])
    if len(mem_updates) != len(memories):
        raise ConfigError(f"step returned {len(mem_updates)} memory updates "
                          f"for {len(memories)} memories")
    return static_layers, mem_layers, out_layer, mem_updates


def _boot_index(memories, first: int) -> Dict[int, int]:
    """Memory index -> position of its boot layer among the group's
    parents, the boots following the ``first`` other parents."""
    boot_ix, k = {}, first
    for mi, m in enumerate(memories):
        if m.boot is not None:
            boot_ix[mi] = k
            k += 1
    return boot_ix


def _mems0(memories, boot_ix, acts, B: int, device) -> list:
    return [acts[boot_ix[mi]].value if mi in boot_ix
            else torch.zeros(B, m.size, dtype=torch.float32, device=device)
            for mi, m in enumerate(memories)]


def recurrent_group(step: Callable[..., Sequence[LayerOutput]],
                    input: Sequence[Union[LayerOutput, StaticInput]],
                    memories: Sequence[Memory], *, reverse: bool = False,
                    name: Optional[str] = None) -> LayerOutput:
    """Run ``step`` over the frames of the sequence inputs.

    ``step(*frame_layers, *static_layers, *memory_layers) -> [out,
    *mem_updates]`` builds the per-frame sub-network once;
    ``mem_updates[i]`` is the new value of ``memories[i]``.  The group's
    output is the sequence of ``out`` frames."""
    name = name or next_name("recurrent_group")
    seq_inputs = [i for i in input if isinstance(i, LayerOutput)]
    static_inputs = [i.input for i in input if isinstance(i, StaticInput)]
    if not seq_inputs:
        raise ConfigError("recurrent_group needs at least one sequence input")
    frame_layers = [data_layer(f"__{name}_frame{i}__", size=l.size)
                    for i, l in enumerate(seq_inputs)]
    static_layers, mem_layers, out_layer, mem_updates = _build_step(
        step, frame_layers, name, static_inputs, memories)
    sub_topo = StepTopology([out_layer, *mem_updates])
    specs = list(sub_topo.param_specs.values())
    parents = seq_inputs + static_inputs + [m.boot for m in memories
                                            if m.boot is not None]
    n_seq, n_static = len(seq_inputs), len(static_inputs)
    boot_ix = _boot_index(memories, n_seq + n_static)

    def forward(ctx, params, *acts: Act) -> Act:
        seq_acts = acts[:n_seq]
        static_acts = acts[n_seq:n_seq + n_static]
        for a in (*seq_acts, *static_acts):
            _refuse_packed(a, name, "recurrent_group")
        ref = seq_acts[0]
        mem0 = _mems0(memories, boot_ix, acts, ref.value.shape[0],
                      ref.value.device)

        def run_step(mems, frame_acts):
            feed = {sl.name: sa for sl, sa in zip(static_layers, static_acts)}
            feed.update({ml.name: Act(value=mv)
                         for ml, mv in zip(mem_layers, mems)})
            feed.update({fl.name: fa
                         for fl, fa in zip(frame_layers, frame_acts)})
            outs, _ = sub_topo.apply(params, {}, feed, train=ctx.train)
            return (tuple(outs[u.name].value for u in mem_updates),
                    outs[out_layer.name])

        values = tuple(a.value for a in seq_acts)
        if ref.is_nested:
            # the outer iteration is over sub-sequences: frame t of every
            # input is a padded sequence [B, Ti, ...] of sub_lengths[:, t]
            Ti = ref.value.shape[2]

            def step_fn(mems, inp):
                frames, sl_t = inp
                imask = O.mask_from_lengths(sl_t, Ti)
                new_mems, out = run_step(mems, [
                    Act(value=f_t, lengths=sl_t, mask=imask)
                    for f_t in frames])
                # a sequence output carries its lengths out of the scan
                return new_mems, ((out.value, out.lengths) if out.is_seq
                                  else (out.value,))

            _, outs = O.scan_rnn(step_fn, tuple(mem0),
                                 (values, ref.sub_lengths), ref.mask,
                                 reverse=reverse)
            return Act(value=outs[0], lengths=ref.lengths, mask=ref.mask,
                       sub_lengths=outs[1] if len(outs) > 1 else None)

        def step_fn(mems, frames):
            new_mems, out = run_step(mems, [Act(value=f_t) for f_t in frames])
            return new_mems, out.value

        _, out_seq = O.scan_rnn(step_fn, tuple(mem0), values, ref.mask,
                                reverse=reverse)
        return Act(value=out_seq, lengths=ref.lengths, mask=ref.mask)

    return LayerOutput(name, "recurrent_group", out_layer.size, parents,
                       forward, specs)


def _tile_rows(x: Optional[torch.Tensor], K: int) -> Optional[torch.Tensor]:
    return None if x is None else x.repeat_interleave(K, dim=0)


def beam_search(step: Callable[..., Sequence[LayerOutput]],
                input: Sequence[Union[GeneratedInput, StaticInput]],
                memories: Sequence[Memory], *, beam_size: int = 3,
                max_length: int = 50, length_penalty: float = 0.0,
                name: Optional[str] = None) -> LayerOutput:
    """Generation-mode recurrent group.

    ``step(gen_layer, *static_layers, *memory_layers) -> [vocab_logits,
    *mem_updates]`` builds the per-token sub-network once; ``gen_layer``
    carries the previous token ids [N] and the step must end in an
    un-normalised vocab-size logits layer.

    Output Act: ``value`` [B, beam_size, max_length] token ids best-first,
    ``state['scores']`` [B, beam_size] log-prob scores.  Generation is
    inference: it runs under ``torch.no_grad()``."""
    name = name or next_name("beam_search")
    gens = [i for i in input if isinstance(i, GeneratedInput)]
    static_inputs = [i.input for i in input if isinstance(i, StaticInput)]
    if len(gens) != 1:
        raise ConfigError("beam_search needs exactly one GeneratedInput")
    gen = gens[0]
    if not memories:
        raise ConfigError("beam_search needs at least one memory")
    if not static_inputs and all(m.boot is None for m in memories):
        raise ConfigError(
            "beam_search needs at least one StaticInput or a booted memory "
            "to derive the batch size (an unconditioned generator has no "
            "batch-shaped input)")
    gen_layer = data_layer(f"__{name}_gen__", size=gen.size, dtype="int32")
    static_layers, mem_layers, out_layer, mem_updates = _build_step(
        step, [gen_layer], name, static_inputs, memories)
    if out_layer.size != gen.size:
        raise ConfigError(
            f"beam_search step must end in a vocab-size ({gen.size}) logits "
            f"layer, got size {out_layer.size}")
    sub_topo = StepTopology([out_layer, *mem_updates])
    specs = list(sub_topo.param_specs.values())
    parents = static_inputs + [m.boot for m in memories if m.boot is not None]
    n_static = len(static_inputs)
    boot_ix = _boot_index(memories, n_static)

    def forward(ctx, params, *acts: Act) -> Act:
        static_acts = acts[:n_static]
        for a in static_acts:
            _refuse_packed(a, name, "beam_search")
        ref = static_acts[0] if static_acts else acts[boot_ix[min(boot_ix)]]
        B, K = ref.value.shape[0], beam_size
        # statics are per sequence: rows tiled per beam with their lengths
        # and masks ([B, ...] -> [B*K, ...])
        tiled = [Act(value=_tile_rows(a.value, K),
                     lengths=_tile_rows(a.lengths, K),
                     mask=_tile_rows(a.mask, K)) for a in static_acts]
        mems0 = dict(zip((m.name for m in memories),
                         _mems0(memories, boot_ix, acts, B,
                                ref.value.device)))

        def step_fn(p, tokens, mems):
            feed = {gen_layer.name: Act(value=tokens)}
            feed.update({sl.name: sa for sl, sa in zip(static_layers, tiled)})
            feed.update({ml.name: Act(value=mems[m.name])
                         for ml, m in zip(mem_layers, memories)})
            outs, _ = sub_topo.apply(p, {}, feed, train=False)
            return (outs[out_layer.name].value,
                    {m.name: outs[u.name].value
                     for m, u in zip(memories, mem_updates)})

        generator = SequenceGenerator(step_fn, vocab_size=gen.size,
                                      bos_id=gen.bos_id, eos_id=gen.eos_id)
        with torch.no_grad():
            tokens, scores = generator.generate(
                params, mems0, batch_size=B, beam_size=K,
                max_len=max_length, length_penalty=length_penalty)
        return Act(value=tokens, state={"scores": scores})

    return LayerOutput(name, "beam_search", gen.size, parents, forward, specs)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


class SequenceGenerator:
    """Beam generation over a functional step protocol:
    ``step_fn(params, tokens [N], mems) -> (logits [N, V], new_mems)``,
    ``mems`` a dict of tensors with leading dim N."""

    def __init__(self, step_fn, *, vocab_size: int, bos_id: int = 0,
                 eos_id: int = 1):
        self.step_fn = step_fn
        self.V = vocab_size
        self.bos = bos_id
        self.eos = eos_id

    def generate(self, params, mems0, *, batch_size: int, beam_size: int = 3,
                 max_len: int = 50, length_penalty: float = 0.0,
                 candidate_adjust_fn=None, drop_fn=None,
                 return_trace: bool = False, early_exit=None):
        """``mems0`` has leading dim B.  Returns (tokens [B, K, max_len] i64,
        scores [B, K]) best-first.

        Without callbacks the search runs on the decode engine with
        ``LogitsReadout`` (all-beams-finished early exit as
        ``early_exit`` / ``FLAGS.decode_early_exit`` says).  The beam
        control callbacks of the reference:

        - ``candidate_adjust_fn(step_logp [B, K, V], tokens, t)`` returns
          adjusted per-candidate log-probs, applied before each step's
          top-k.  ``tokens`` is the whole [B, K, max_len+1] buffer; slots
          after ``t`` hold EOS padding.
        - ``drop_fn(tokens, scores [B, K], t)`` returns a bool [B, K]; True
          drops that beam after the expansion (newest token at ``t+1``).
        - ``return_trace=True`` also returns ``{"parent", "token", "score"}``
          [T, B, K] in the search's own (pre-sort) beam order, and
          ``"order"`` [B, K] mapping each returned beam to its slot there.

        These run the reference's fixed ``max_len`` loop over full
        log-softmaxed logits."""
        B, K, V = batch_size, beam_size, self.V
        step_fn = self.step_fn
        if candidate_adjust_fn is None and drop_fn is None \
                and not return_trace:
            return beam_decode(
                lambda tokens, mems: step_fn(params, tokens, mems),
                LogitsReadout(), mems0, batch_size=B, beam_size=K,
                vocab_size=V, max_len=max_len, bos=self.bos, eos=self.eos,
                length_penalty=length_penalty, early_exit=early_exit)

        dev = next(iter(mems0.values())).device
        mems = {k: v.repeat_interleave(K, dim=0) for k, v in mems0.items()}
        logp = torch.tensor([0.0] + [NEG] * (K - 1), device=dev)[None].repeat(
            B, 1)
        tokens = torch.full((B, K, max_len + 1), self.eos, dtype=torch.long,
                            device=dev)
        tokens[:, :, 0] = self.bos
        finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
        eos_only = torch.full((V,), NEG, device=dev)
        eos_only[self.eos] = 0.0
        trace = []
        for t in range(max_len):
            logits, mems_new = step_fn(params, tokens[:, :, t].reshape(B * K),
                                       mems)
            step_logp = torch.log_softmax(logits.float(), -1).reshape(B, K, V)
            step_logp = torch.where(finished[..., None], eos_only, step_logp)
            if candidate_adjust_fn is not None:
                step_logp = candidate_adjust_fn(step_logp, tokens, t)
                step_logp = torch.where(finished[..., None], eos_only,
                                        step_logp)
            flat = (logp[..., None] + step_logp).reshape(B, K * V)
            new_logp, idx = stable_topk(flat, K)
            beam_idx = torch.div(idx, V, rounding_mode="floor")
            tok = idx % V
            mems = beam_gather(mems_new, beam_idx)
            tokens, finished = beam_gather((tokens, finished), beam_idx)
            tokens[:, :, t + 1] = tok
            finished = finished | (tok == self.eos)
            if drop_fn is not None:
                dropped = drop_fn(tokens, new_logp, t)
                new_logp = torch.where(dropped, torch.full_like(new_logp, NEG),
                                       new_logp)
                finished = finished | dropped
            logp = new_logp
            if return_trace:
                trace.append((beam_idx, tok, new_logp))
        out, scores, order = _finalize(tokens, logp, eos=self.eos,
                                       length_penalty=length_penalty)
        if return_trace:
            parent, token, score = (torch.stack(x) for x in zip(*trace))
            return out, scores, {"parent": parent, "token": token,
                                 "score": score, "order": order}
        return out, scores
