"""Decode engine — counterpart of ``paddle_tpu/ops/decode.py``.

One generation implementation for every surface of this slice: the model's
``beam_search``/``greedy_decode`` and the slot table of
``serving/slots.py`` all drive ``decode_step``.

- **Readout**: ``LinearReadout`` hands the pre-readout states to the
  ``topk_lse_readout`` kernel, which returns per row the k best logits,
  their ids and the logsumexp; the [N, V] logits never reach device memory.
- **Early exit**: the reference's ``lax.while_loop`` becomes a Python loop
  that stops once every beam emitted EOS (finished beams extend only with
  EOS at zero cost and token buffers are EOS-prefilled, so stopping early
  gives the same output as running ``max_len`` steps).  ``early_exit=False``
  runs the fixed count.  The check reads one flag back to the host per step.
- **Tie order**: every top-k here (the kernel, ``stable_topk``, the harvest
  sort) breaks ties toward the lowest index, as ``lax.top_k`` and JAX's
  stable ``argsort`` do, so token ids match the reference exactly.

The carry of a slot table of S slots, each holding one request's K beams::

    tokens   [S, K, max_len+1] i64   EOS-prefilled token buffers, BOS at 0
    logp     [S, K] f32              cumulative beam log-probs
    state    dict of tensors, leading dim S*K (or [S, K, ...])
    finished [S, K] bool             per-beam EOS mask
    active   [S] bool                slot occupancy (host-managed)
    step     [S] i64                 per-slot step count

``decode_step`` returns a new carry and leaves its input untouched (the
slot scheduler commits a step only if its ``commit()`` still holds);
``write_slot`` and ``release_slot`` update the carry in place, which saves
a copy of the whole table per admitted row, and return it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.topk_readout import (stable_topk,
                                                       topk_lse_readout)
from paddle_tpu_torch.ops.numerics import compute_dtype

__all__ = ["NEG", "LinearReadout", "beam_gather", "decode_step",
           "init_slot_carry", "write_slot", "release_slot", "finalize_slots",
           "beam_decode", "greedy_decode"]

#: the reference's kill score for impossible candidates; scores must match
#: it exactly
NEG = -1e9

State = Dict[str, Any]


def _tree_map(fn: Callable, tree, *rest):
    """Map over the tensor leaves of a (nested) dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class LinearReadout:
    """The engine owns the [D, V] projection: the step net returns
    pre-readout states [N, D] and the kernel returns per row
    ``(vals [N, k], idx [N, k], lse [N])`` without building the logits.

    The compute-dtype copy of ``w`` is made once per dtype and kept: casting
    the 30k-vocab matrix on every decode step would move 90 MB a token."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        self.w = w      # [D, V]
        self.b = b      # [V]
        self._w_cast: Dict[torch.dtype, torch.Tensor] = {}

    def _w_in(self, dtype: torch.dtype) -> torch.Tensor:
        wc = self._w_cast.get(dtype)
        if wc is None:
            wc = self._w_cast[dtype] = self.w.to(dtype).contiguous()
        return wc

    def __call__(self, states: torch.Tensor, k: int):
        cd = compute_dtype()
        return topk_lse_readout(states.to(cd), self._w_in(cd), self.b, k)


def beam_gather(tree, beam_idx: torch.Tensor):
    """Reorder every [B*K, ...] / [B, K, ...] leaf of ``tree`` (a tensor,
    dict or tuple of those) by ``beam_idx`` [B, K]: one gather per leaf
    (eager PyTorch gains nothing from the reference's per-dtype packing)."""
    B, K = beam_idx.shape

    def take(x):
        if x.dim() >= 2 and x.shape[0] == B and x.shape[1] == K:
            xb = x.reshape(B, K, -1)
        elif x.shape[0] == B * K:
            xb = x.reshape(B, K, -1)
        else:
            raise ValueError(
                f"beam_gather leaf has no beam axis: shape "
                f"{tuple(x.shape)} with B={B}, K={K}")
        ix = beam_idx[..., None].expand(B, K, xb.shape[-1])
        return torch.gather(xb, 1, ix).reshape(x.shape)

    if isinstance(tree, tuple):
        return tuple(_tree_map(take, t) for t in tree)
    return _tree_map(take, tree)


def _eos_candidates(vocab: int, k: int, eos: int, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row candidate list of a FINISHED beam, in ``lax.top_k``
    order over the reference's eos-only row: EOS first at zero cost, then
    the lowest non-EOS ids at the kill score."""
    toks = [eos] + [v for v in range(min(vocab, k + 1)) if v != eos][:k - 1]
    toks += [eos] * (k - len(toks))          # k > vocab: EOS filler
    vals = [0.0] + [NEG] * (k - 1)
    return (torch.tensor(toks, dtype=torch.long, device=device),
            torch.tensor(vals, dtype=torch.float32, device=device))


def decode_step(step_fn: Callable, readout, carry: dict, *, vocab_size: int,
                eos: int = 1) -> dict:
    """ONE decode step over a slot table.  ``step_fn(tokens [S*K] i64,
    state) -> (readout_input, new_state)``; ``active``/``step`` freeze
    unoccupied slots bit for bit and let each slot run at its own position.
    Returns a new carry; the input carry is not modified."""
    tokens, logp = carry["tokens"], carry["logp"]
    state, finished = carry["state"], carry["finished"]
    active, step = carry["active"], carry["step"]
    S, K, Lp1 = tokens.shape
    dev = tokens.device
    kr = min(K, vocab_size)        # per-row candidates: top-K needs <= V
    fin_toks, fin_vals = _eos_candidates(vocab_size, kr, eos, dev)

    # each slot reads the token at ITS OWN step position
    y = torch.gather(tokens, 2, step.view(S, 1, 1).expand(S, K, 1))[..., 0]
    r_in, state_new = step_fn(y.reshape(S * K), state)
    vals, idx, lse = readout(r_in, kr)
    row_logp = (vals - lse[:, None]).reshape(S, K, kr)
    row_idx = idx.reshape(S, K, kr)
    # finished beams may only emit EOS at zero cost
    fin = finished[..., None]
    row_logp = torch.where(fin, fin_vals, row_logp)
    row_idx = torch.where(fin, fin_toks, row_idx)
    flat = (logp[..., None] + row_logp).reshape(S, K * kr)
    new_logp, flat_ix = stable_topk(flat, K)
    beam_ix = torch.div(flat_ix, kr, rounding_mode="floor")
    tok = torch.gather(row_idx.reshape(S, K * kr), 1, flat_ix)
    tokens_g, state_g, finished_g = beam_gather(
        (tokens, state_new, finished), beam_ix)
    pos = (torch.arange(Lp1, device=dev)[None, :] == (step + 1)[:, None])
    tokens_g = torch.where(pos[:, None, :], tok[:, :, None], tokens_g)
    finished_g = finished_g | (tok == eos)

    # freeze inactive slots bit for bit
    row_keep = active.repeat_interleave(K)

    def _sel(new, old):
        if new.shape[0] == S * K:
            m = row_keep.reshape((S * K,) + (1,) * (new.dim() - 1))
        else:
            m = active.reshape((S,) + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)

    return {
        "tokens": torch.where(active[:, None, None], tokens_g, tokens),
        "logp": torch.where(active[:, None], new_logp, logp),
        "state": _tree_map(_sel, state_g, state),
        "finished": torch.where(active[:, None], finished_g, finished),
        "active": active,
        "step": torch.where(active, step + 1, step),
    }


def _init_logp(rows: int, K: int, device) -> torch.Tensor:
    return torch.tensor([0.0] + [NEG] * (K - 1), dtype=torch.float32,
                        device=device)[None].repeat(rows, 1)


def init_slot_carry(state_template: State, *, slots: int, beam_size: int,
                    max_len: int, eos: int = 1) -> dict:
    """An EMPTY slot table: every slot inactive and finished, token buffers
    EOS-prefilled, state leaves zero-filled at the beam-tiled shapes.
    ``state_template`` is a per-sequence state dict with leading dim 1
    (e.g. one prefill's output); the table lives on its device."""
    S, K = int(slots), int(beam_size)
    leaves = []
    _tree_map(leaves.append, state_template)
    dev = leaves[0].device

    def make(leaf):
        return torch.zeros((S * K,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                           device=leaf.device)

    return {
        "tokens": torch.full((S, K, max_len + 1), eos, dtype=torch.long,
                             device=dev),
        "logp": _init_logp(S, K, dev),
        "state": _tree_map(make, state_template),
        "finished": torch.ones(S, K, dtype=torch.bool, device=dev),
        "active": torch.zeros(S, dtype=torch.bool, device=dev),
        "step": torch.zeros(S, dtype=torch.long, device=dev),
    }


def write_slot(carry: dict, slot: int, state0: State, *, bos: int = 0,
               eos: int = 1, row: int = 0) -> dict:
    """Prefill: admit row ``row`` of the prefill output ``state0`` into slot
    ``slot`` IN PLACE — beam-tiled to K rows over [slot*K, slot*K+K); the
    slot's tokens, scores and masks are reset and it comes back active at
    step 0.  Returns ``carry``."""
    tokens = carry["tokens"]
    S, K, Lp1 = tokens.shape

    def put(table, leaf):
        table[slot * K:(slot + 1) * K] = leaf[row:row + 1].to(table.dtype)

    _tree_map(put, carry["state"], state0)
    tokens[slot] = eos
    tokens[slot, :, 0] = bos
    carry["logp"][slot] = _init_logp(1, K, tokens.device)[0]
    carry["finished"][slot] = False
    carry["active"][slot] = True
    carry["step"][slot] = 0
    return carry


def release_slot(carry: dict, slot: int) -> dict:
    """Free slot ``slot`` IN PLACE: inactive and all-finished, so
    ``decode_step`` freezes it until the next ``write_slot``."""
    carry["active"][slot] = False
    carry["finished"][slot] = True
    return carry


def _finalize(tokens: torch.Tensor, logp: torch.Tensor, *, eos: int,
              length_penalty: float):
    """The shared decode epilogue: strip BOS, apply the length penalty,
    sort beams best-first (stable, as JAX's ``argsort``).  ``beam_decode``
    and the slot harvest both go through this one implementation."""
    out = tokens[:, :, 1:]
    if length_penalty > 0:
        lengths = (out != eos).to(torch.float32).sum(-1) + 1.0
        scores = logp / torch.pow(lengths, length_penalty)
    else:
        scores = logp
    order = torch.argsort(-scores, dim=1, stable=True)
    out = torch.gather(out, 1, order[..., None].expand_as(out))
    return out, torch.gather(scores, 1, order)


def finalize_slots(carry: dict, *, eos: int = 1, length_penalty: float = 0.0):
    """Harvest view of the whole table: ``(tokens [S, K, max_len],
    scores [S, K])`` sorted best-first per slot."""
    return _finalize(carry["tokens"], carry["logp"], eos=eos,
                     length_penalty=length_penalty)


def _resolve_early_exit(early_exit: Optional[bool]) -> bool:
    if early_exit is not None:
        return bool(early_exit)
    from paddle_tpu_torch.utils.flags import FLAGS

    return bool(FLAGS.decode_early_exit)


def beam_decode(step_fn: Callable, readout, state0: State, *,
                batch_size: int, beam_size: int, vocab_size: int,
                max_len: int, bos: int = 0, eos: int = 1,
                length_penalty: float = 0.0,
                early_exit: Optional[bool] = None):
    """Batched beam search over the step protocol: ``state0`` has leading
    dim B and is beam-tiled here.  Returns ``(tokens [B, K, max_len],
    scores [B, K])`` sorted best-first.  The loop body IS ``decode_step``
    over an always-active table of B slots."""
    B, K = batch_size, beam_size
    leaves = []
    _tree_map(leaves.append, state0)
    dev = leaves[0].device
    tokens = torch.full((B, K, max_len + 1), eos, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = bos
    sc = {
        "tokens": tokens,
        "logp": _init_logp(B, K, dev),
        "state": _tree_map(lambda x: x.repeat_interleave(K, dim=0), state0),
        "finished": torch.zeros(B, K, dtype=torch.bool, device=dev),
        "active": torch.ones(B, dtype=torch.bool, device=dev),
        "step": torch.zeros(B, dtype=torch.long, device=dev),
    }
    early = _resolve_early_exit(early_exit)
    for _ in range(max_len):
        if early and bool(sc["finished"].all()):
            break
        sc = decode_step(step_fn, readout, sc, vocab_size=vocab_size,
                         eos=eos)
    return _finalize(sc["tokens"], sc["logp"], eos=eos,
                     length_penalty=length_penalty)


def greedy_decode(step_fn: Callable, readout, state0: State, *,
                  batch_size: int, vocab_size: int, max_len: int,
                  bos: int = 0, eos: int = 1,
                  early_exit: Optional[bool] = None):
    """Greedy fast path: B rows, no beam tiling, the readout at k=1.
    Token-identical to ``beam_decode(beam_size=1)``; returns
    ``(tokens [B, max_len], scores [B])``."""
    B = batch_size
    leaves = []
    _tree_map(leaves.append, state0)
    dev = leaves[0].device
    tokens = torch.full((B, max_len + 1), eos, dtype=torch.long, device=dev)
    tokens[:, 0] = bos
    logp = torch.zeros(B, dtype=torch.float32, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    state = state0
    early = _resolve_early_exit(early_exit)
    for t in range(max_len):
        if early and bool(finished.all()):
            break
        r_in, state = step_fn(tokens[:, t], state)
        vals, idx, lse = readout(r_in, 1)
        tok = torch.where(finished, torch.full_like(idx[:, 0], eos),
                          idx[:, 0])
        logp = logp + torch.where(finished, torch.zeros_like(lse),
                                  vals[:, 0] - lse)
        tokens[:, t + 1] = tok
        finished = finished | (tok == eos)
    return tokens[:, 1:], logp
