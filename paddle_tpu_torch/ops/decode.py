"""Decode engine — counterpart of ``paddle_tpu/ops/decode.py``.

One generation implementation for every surface of this slice: the model's
``beam_search``/``greedy_decode`` and the slot table of
``serving/slots.py`` all drive ``decode_step``.

- **Readout**: ``LinearReadout`` hands the pre-readout states to the
  ``topk_lse_readout`` kernel, which returns per row the k best logits,
  their ids and the logsumexp; the [N, V] logits never reach device memory.
  ``LogitsReadout`` serves step nets that end in their own logits layer
  (the nn DSL's ``beam_search``): the ``topk_lse_logits`` kernel takes the
  same statistics from one read of the logits.
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

``decode_step`` and ``spec_verify_step`` (the speculative wide step over a
greedy table) return a new carry and leave their input untouched (the
slot scheduler commits a step only if its ``commit()`` still holds);
``write_slot``, ``release_slot`` and ``restore_slot`` update the carry in
place, which saves a copy of the whole table per admitted row, and return
it.  ``extract_slot`` copies one slot's context out for host paging.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.topk_logits import topk_lse_logits
from paddle_tpu_torch.ops.kernels.topk_readout import (MAX_K, stable_topk,
                                                       topk_lse_readout)
from paddle_tpu_torch.ops.numerics import compute_dtype

__all__ = ["NEG", "LinearReadout", "LogitsReadout", "beam_gather",
           "decode_step", "init_slot_carry", "write_slot", "release_slot",
           "spec_verify_step", "extract_slot", "restore_slot",
           "finalize_slots", "beam_decode", "greedy_decode"]

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


class LogitsReadout:
    """The step net returns the full logits [N, V] (the nn DSL's
    ``beam_search`` step ends in a logits layer) and the ``topk_lse_logits``
    kernel reads them once for ``(vals [N, k], idx [N, k], lse [N])``.

    The reference's shape gate decides the route, and nothing else does:
    k > 16 or V < k takes its unfused statistics (``_topk_lse_unfused``);
    every other shape runs the kernel (the plain version on the CPU)."""

    def __call__(self, logits: torch.Tensor, k: int):
        if k > MAX_K or logits.shape[-1] < k:
            return _topk_lse_unfused(logits, k)
        return topk_lse_logits(logits, k)


def _topk_lse_unfused(logits: torch.Tensor, k: int):
    """The reference's ``_topk_lse_xla``: float32 logits, a two-pass
    logsumexp (no finite-min clamp) and ``stable_topk``."""
    lf = logits.float()
    m = lf.max(dim=-1).values
    lse = m + torch.log(torch.exp(lf - m[..., None]).sum(dim=-1))
    vals, idx = stable_topk(lf, k)
    return vals, idx, lse


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


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves: List[torch.Tensor]):
    """``tree``'s structure with ``leaves`` in ``_leaves`` order."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def spec_verify_step(step_fn: Callable, readout, carry: dict, drafts, cap, *,
                     vocab_size: int, eos: int = 1):
    """ONE wide-verify step for speculative decoding over a GREEDY
    (``beam_size == 1``) slot table: per active slot, score the current
    token plus ``k`` host-proposed draft tokens in one call and emit the
    longest prefix the model itself would have produced — between 1 and
    ``k + 1`` tokens per slot per step.

    ``drafts`` is ``[S, k]`` (host draft proposals per slot,
    ``ops/speculative.py``); ``cap`` is ``[S]``, the per-slot remaining
    decode budget (``limit - tokens_emitted``): emission stops there, so a
    score never accumulates past the request's own ``max_len``.  Returns
    ``(new_carry, aux)`` with ``aux = {"emitted": [S, k+1], "n": [S],
    "accepted": [S]}``: the emitted tokens (EOS past ``n``), the tokens
    emitted and the draft tokens accepted.  The input carry is not
    modified.

    Bit-identity with the one-token path (``decode_step``), as in the
    reference:

    - position ``j``'s input is the previous emission of the solo run
      while every earlier draft matched the model's own greedy emission
      (or the row already finished, where emissions are forced EOS at
      zero cost whatever the state); ``step_fn`` runs at S rows at every
      position, as the one-token step does, and the readout's rows do
      not depend on how many rows share the call;
    - ``logp`` accumulates position by position in the one-token path's
      float order (``logp + (val - lse)``, ``+ 0.0`` once finished);
    - the carried state is SELECTED from the sweep: row ``r``'s state
      after position ``n - 1`` saw exactly the solo inputs.

    The readout runs ONCE over the ``(k+1)·S`` rows of one contiguous
    stacked tensor (so its operand is a fresh aligned allocation and K7
    takes the same pass-1 kernel as at S rows).  State leaves that
    ``step_fn`` returns unmodified (the same tensor object: the encoder
    outputs, projections and mask of ``Seq2SeqSlotBackend``) are detected
    by identity on the first position and neither stacked nor selected.
    Inactive slots are frozen bit for bit.  Beam search has no greedy
    verify: ``beam_size > 1`` raises."""
    tokens, logp = carry["tokens"], carry["logp"]
    state, finished = carry["state"], carry["finished"]
    active, step = carry["active"], carry["step"]
    S, K, Lp1 = tokens.shape
    if K != 1:
        raise ValueError(
            f"spec_verify_step is a greedy path: beam_size must be 1, "
            f"got K={K} (beam search falls back to decode_step)")
    dev = tokens.device
    drafts = torch.as_tensor(drafts, device=dev).long()
    cap = torch.as_tensor(cap, device=dev).long()
    if drafts.dim() != 2 or drafts.shape[0] != S or tuple(cap.shape) != (S,):
        raise ValueError(f"drafts [S={S}, k] and cap [S] expected, got "
                         f"{tuple(drafts.shape)} and {tuple(cap.shape)}")
    k = int(drafts.shape[1])

    # position inputs: x_0 = each slot's current token, x_j = draft j-1
    y0 = torch.gather(tokens[:, 0], 1, step[:, None])[:, 0]
    xs = torch.cat([y0[None], drafts.T], dim=0)            # [k+1, S]

    # the sweep: the recurrence through all k+1 positions, keeping each
    # position's readout input and its changed state leaves
    in_leaves = _leaves(state)
    changed: Optional[List[bool]] = None
    r_list, st_list = [], []
    st = state
    for j in range(k + 1):
        r_in, st = step_fn(xs[j], st)
        out_leaves = _leaves(st)
        if changed is None:
            changed = [o is not i for o, i in zip(out_leaves, in_leaves)]
        r_list.append(r_in)
        st_list.append([o for o, c in zip(out_leaves, changed) if c])
    r_all = torch.stack(r_list)                            # [k+1, S, D]
    vals, idx, lse = readout(r_all.reshape((k + 1) * S, -1), 1)
    g = idx[:, 0].reshape(k + 1, S)            # greedy token per position
    lp = (vals[:, 0] - lse).reshape(k + 1, S)  # its log-prob

    # accept/emit: 'emitting' is sticky per row — a position emits only
    # while every earlier draft matched the row's own emission (or the row
    # is finished: forced EOS at zero cost) and the budget is not spent
    fin = finished[:, 0]
    logp_new = logp[:, 0]
    emitting = active & (cap > 0)
    n = torch.zeros(S, dtype=torch.long, device=dev)
    acc = torch.zeros(S, dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    em = []
    for j in range(k + 1):
        if j:
            matched = drafts[:, j - 1] == em[j - 1]
            emitting = emitting & (fin | matched) & (n < cap)
            acc = acc + (emitting & ~fin).long()
        e_j = torch.where(fin, torch.full_like(g[j], eos), g[j])
        logp_new = torch.where(
            emitting, logp_new + torch.where(fin, zero, lp[j]), logp_new)
        em.append(torch.where(emitting, e_j, torch.full_like(e_j, eos)))
        n = n + emitting.long()
        fin = fin | (emitting & (e_j == eos))
    em_arr = torch.stack(em, dim=1)                        # [S, k+1]

    # token-buffer epilogue: the n emitted tokens at each slot's own
    # position (offsets past n keep the EOS-prefilled buffer)
    off = (torch.arange(Lp1, device=dev)[None, :] - (step[:, None] + 1))
    sel = (off >= 0) & (off < n[:, None])                  # [S, Lp1]
    gathered = torch.gather(em_arr, 1, off.clamp(0, k))
    tokens_new = torch.where(sel[:, None, :], gathered[:, None, :], tokens)

    # state select: each row keeps its sweep state at position n-1; rows
    # that emitted nothing keep the original, bit for bit
    pos = (n - 1).clamp(0, k)
    live = n > 0
    rows = torch.arange(S, device=dev)
    picked = iter(zip(*st_list))          # per changed leaf: k+1 states
    new_leaves = []
    for leaf, ch in zip(in_leaves, changed):
        if not ch:
            new_leaves.append(leaf)
            continue
        stacked = torch.stack(next(picked))                # [k+1, S, ...]
        m = live.reshape((S,) + (1,) * (leaf.dim() - 1))
        new_leaves.append(torch.where(m, stacked[pos, rows], leaf))

    new_carry = {
        "tokens": tokens_new,
        "logp": logp_new[:, None],
        "state": _unflatten(state, new_leaves),
        "finished": fin[:, None],
        "active": active,
        "step": step + n,
    }
    return new_carry, {"emitted": em_arr, "n": n, "accepted": acc}


def _slot_rows(leaf: torch.Tensor, S: int, K: int, slot: int) -> slice:
    if leaf.shape[0] == S * K:
        return slice(slot * K, (slot + 1) * K)
    if leaf.shape[0] == S:
        return slice(slot, slot + 1)
    raise ValueError(f"slot leaf has no slot axis: shape "
                     f"{tuple(leaf.shape)} with S={S}, K={K}")


def extract_slot(carry: dict, slot: int) -> dict:
    """Page-out: one slot's full decode context — token buffer, scores,
    state rows, finished mask, step — as copies on the table's device
    (``serving/paging.py`` moves them to the host).  The copies preserve
    every bit, so a slot paged out and restored decodes exactly as if it
    had never left the table."""
    tokens = carry["tokens"]
    S, K, _ = tokens.shape
    return {
        "tokens": tokens[slot:slot + 1].clone(),
        "logp": carry["logp"][slot:slot + 1].clone(),
        "state": _tree_map(
            lambda x: x[_slot_rows(x, S, K, slot)].clone(), carry["state"]),
        "finished": carry["finished"][slot:slot + 1].clone(),
        "step": carry["step"][slot:slot + 1].clone(),
    }


def restore_slot(carry: dict, slot: int, saved: dict) -> dict:
    """Page-in: write an :func:`extract_slot` snapshot (on any device)
    back into slot ``slot`` IN PLACE and re-activate it at its saved step
    — the inverse of :func:`extract_slot` up to bit identity.  Returns
    ``carry``."""
    tokens = carry["tokens"]
    S, K, _ = tokens.shape

    def put(table, piece):
        table[_slot_rows(table, S, K, slot)] = piece.to(table.dtype)

    _tree_map(put, carry["state"], saved["state"])
    tokens[slot:slot + 1] = saved["tokens"].to(tokens.dtype)
    carry["logp"][slot:slot + 1] = saved["logp"].to(torch.float32)
    carry["finished"][slot:slot + 1] = saved["finished"]
    carry["step"][slot:slot + 1] = saved["step"].to(carry["step"].dtype)
    carry["active"][slot] = True
    return carry


def _finalize(tokens: torch.Tensor, logp: torch.Tensor, *, eos: int,
              length_penalty: float):
    """The shared decode epilogue: strip BOS, apply the length penalty,
    sort beams best-first (stable, as JAX's ``argsort``).  ``beam_decode``,
    the slot harvest and ``SequenceGenerator``'s callback path all go
    through this one implementation.  Returns (tokens, scores, order),
    ``order`` [B, K] mapping each output beam to its slot in the input."""
    out = tokens[:, :, 1:]
    if length_penalty > 0:
        lengths = (out != eos).to(torch.float32).sum(-1) + 1.0
        scores = logp / torch.pow(lengths, length_penalty)
    else:
        scores = logp
    order = torch.argsort(-scores, dim=1, stable=True)
    out = torch.gather(out, 1, order[..., None].expand_as(out))
    return out, torch.gather(scores, 1, order), order


def finalize_slots(carry: dict, *, eos: int = 1, length_penalty: float = 0.0):
    """Harvest view of the whole table: ``(tokens [S, K, max_len],
    scores [S, K])`` sorted best-first per slot."""
    return _finalize(carry["tokens"], carry["logp"], eos=eos,
                     length_penalty=length_penalty)[:2]


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
                     length_penalty=length_penalty)[:2]


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
