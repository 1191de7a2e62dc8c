"""Draft proposers for speculative decoding — the port's copy of
``paddle_tpu/ops/speculative.py`` (framework-free host code).

The wide-verify step (:func:`paddle_tpu_torch.ops.decode.spec_verify_step`)
scores k draft tokens per slot in ONE fused call and accepts the longest
prefix the model itself would have emitted greedily.  The verify side
guarantees bit-identity no matter what the drafts are — proposers only
control *acceptance rate*, i.e. how much of each wide step is useful
work.  That makes the proposer a pure host-side heuristic: it runs on
the emission history the scheduler already tracks, costs microseconds,
and needs no device state.

Built-in proposers:

- :class:`NGramProposer` — suffix-match drafting (the "prompt lookup" /
  n-gram speculation trick): find the most recent earlier occurrence of
  the last-n emitted tokens and propose whatever followed it.  Free,
  model-agnostic, and very effective on repetitive output — which is
  exactly what small-vocab greedy decodes produce.
- :class:`CallableDraftProposer` — adapt any ``history, k -> tokens``
  callable; the hook for a small-model draft (run a distilled model on
  host or a second device, return its greedy continuation).
- :class:`AdversarialProposer` — always-wrong drafts, for chaos testing
  (``resilience.chaos.bad_draft``): throughput must degrade to the
  standard ≥1 token/step, never corrupt output.

Protocol: ``propose(history, k) -> list[int]`` of length exactly k,
where ``history`` is the slot's emission history INCLUDING the BOS
token at position 0.  Proposers must be pure host code — no tensor ops —
so drafting never touches the device.

``learn``/``propose_with_confidence`` additionally accept an optional
``key`` — the scheduler's content hash of the request (model
fingerprint + canonical feed bytes + session id).  Greedy decode is
deterministic, so two requests with the same key emit the SAME
sequence: a completed trajectory stored under the key can be replayed
*positionally* (draft ``seq[len(history):]``), which sidesteps the
fundamental ambiguity of n-gram drafting — the same n-gram can occur
at several positions of one trajectory with different successors
(decoder state disambiguates them; a context window cannot), capping
n-gram acceptance well below 1 even on exact repeats.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

__all__ = [
    "DraftProposer",
    "NGramProposer",
    "CallableDraftProposer",
    "AdversarialProposer",
]


class DraftProposer:
    """Base draft proposer: ``propose(history, k)`` returns exactly k
    candidate next tokens for a slot whose emissions so far (BOS
    included) are ``history``.  Default: repeat the last token.

    ``learn(seq)`` is the cross-request feedback hook: the scheduler
    feeds every completed request's emission sequence back to the
    proposer, so session/template traffic (many requests decoding the
    same or similar output) can be drafted from previously seen
    completions, not just the current slot's own history.  Default:
    no-op — stateless proposers simply ignore it."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        last = int(history[-1]) if history else 0
        return [last] * k

    def learn(self, seq: Sequence[int],
              key: Optional[str] = None) -> None:
        """Record a completed emission sequence (BOS included); ``key``
        is the scheduler's request content hash, or None when the
        request is unkeyable.  No-op in the base class."""

    def propose_with_confidence(self, history: Sequence[int], k: int,
                                key: Optional[str] = None,
                                ) -> "tuple[List[int], bool]":
        """``(drafts, confident)`` — ``confident`` tells the scheduler
        whether these drafts come from a real predictive source (learned
        corpus, suffix match, draft model) or are a blind fallback.
        When NO slot in a wide step has a confident draft, the scheduler
        gates speculation off for that step and runs the plain
        one-token path instead of paying the (k+1)-position verify for
        a guaranteed single emission.  Base class: never confident."""
        return self.propose(history, k), False


class NGramProposer(DraftProposer):
    """Suffix-match drafting: for n = order..1, find the most recent
    *earlier* occurrence of the last-n-token suffix in the history and
    propose the tokens that followed it (extending by repeating the
    final proposal when the match runs off the end).  Falls back to
    repeating the last token when no suffix recurs.

    ``learn`` additionally records COMPLETED emission sequences two
    ways.  (1) Keyed positional replay: when the scheduler supplies a
    request content ``key``, the WHOLE sequence is stored under it;
    a later request with the same key drafts ``seq[len(history):]``
    after an exact prefix check.  Greedy decode is deterministic, so
    positional replay is exact on repeat/template traffic — acceptance
    ~1.0 — where pure n-gram drafting tops out far lower (the same
    n-gram recurs within one trajectory with different successors,
    and newest-wins indexing can only keep one of them).  (2) A shared
    n-gram table (suffix tuple -> observed continuation, newest wins),
    consulted when there is no positional hit: near-miss traffic —
    similar but not identical requests — still drafts well from it.
    Both are plain host dicts, ``O(order · len)`` inserts per completed
    request and O(order) lookups per proposal; each self-clears past
    its bound so a long-lived server cannot grow them without limit.

    O(order · len(history)) python per call — negligible next to a
    device dispatch, and the scheduler history is capped at ``max_len``.
    """

    #: continuation tokens stored per indexed suffix (propose() slices k
    #: of them; callers wanting k > this fall back to suffix extension)
    _CONT = 32

    def __init__(self, order: int = 3, max_entries: int = 200_000,
                 max_seqs: int = 4096):
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        self.order = int(order)
        self.max_entries = int(max_entries)
        self.max_seqs = int(max_seqs)
        self._index = {}
        self._seqs = {}   # request content key -> full emission sequence

    def learn(self, seq: Sequence[int],
              key: Optional[str] = None) -> None:
        s = [int(t) for t in seq]
        if key is not None:
            if len(self._seqs) > self.max_seqs:
                self._seqs.clear()   # crude but bounded; relearns fast
            self._seqs[key] = s      # newest completion wins
        if len(self._index) > self.max_entries:
            self._index.clear()
        for n in range(1, self.order + 1):
            for i in range(n, len(s)):
                self._index[(n, tuple(s[i - n:i]))] = s[i:i + self._CONT]

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        return self.propose_with_confidence(history, k)[0]

    def propose_with_confidence(self, history: Sequence[int], k: int,
                                key: Optional[str] = None):
        h = [int(t) for t in history]
        L = len(h)
        # keyed positional replay first: an identical earlier request's
        # completed trajectory.  The O(L) prefix check makes it exact —
        # if this slot's emissions have diverged (it isn't actually the
        # same request, or the model was swapped between learn and now),
        # fall through to the n-gram paths rather than replay garbage.
        if key is not None:
            seq = self._seqs.get(key)
            if seq is not None and len(seq) > L and seq[:L] == h:
                out = seq[L:L + k]
                while len(out) < k:
                    out.append(out[-1])
                return [int(t) for t in out], True
        # learned-corpus lookup first, longest context first: completed
        # requests are whole trajectories, strictly more predictive than
        # this slot's partial history
        for n in range(min(self.order, L), 0, -1):
            out = self._index.get((n, tuple(h[L - n:])))
            if out:
                out = list(out[:k])
                while len(out) < k:
                    out.append(out[-1])
                return [int(t) for t in out], True
        # in-history fallback: one-shot index of the slot's own history
        # (suffix tuple -> most recent continuation offset), then O(order)
        # lookups — O(order * L) per call.  The naive nested scan is
        # O(order * L^2) python per slot per step, which at serving
        # histories costs more than the fused wide step it feeds.
        local = {}
        for n in range(1, min(self.order, L - 1) + 1):
            for i in range(n, L):
                local[(n, tuple(h[i - n:i]))] = i
        for n in range(min(self.order, L - 1), 0, -1):
            i = local.get((n, tuple(h[L - n:])))
            if i is not None:
                out = h[i:i + k]
                while len(out) < k:
                    out.append(out[-1] if out else h[-1])
                return [int(t) for t in out], True
        return DraftProposer.propose(self, h, k), False


class CallableDraftProposer(DraftProposer):
    """Wrap a ``(history, k) -> sequence`` callable as a proposer — the
    small-model draft hook.  The callable's output is truncated/padded
    to exactly k tokens; any model-based drafter (a distilled LM run on
    host, a second-device greedy decode) plugs in here without the
    scheduler knowing."""

    def __init__(self, fn: Callable[[Sequence[int], int], Sequence[int]]):
        self._fn = fn

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        out = [int(t) for t in self._fn(history, k)][:k]
        if not out:
            return DraftProposer.propose(self, history, k)
        while len(out) < k:
            out.append(out[-1])
        return out

    def propose_with_confidence(self, history: Sequence[int], k: int,
                                key: Optional[str] = None):
        # a model-based drafter is a real predictive source: always
        # worth verifying (gating is for blind fallback drafts only)
        return self.propose(history, k), True


class AdversarialProposer(DraftProposer):
    """Always-wrong drafts (chaos hook ``bad_draft``): propose a fixed
    token so verification rejects every draft position.  The wide step
    then degrades to the standard one-token-per-step rate — output must
    stay bit-identical, only throughput suffers (pinned by tests)."""

    def __init__(self, token: int = 0):
        self.token = int(token)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        return [self.token] * k

    def propose_with_confidence(self, history: Sequence[int], k: int,
                                key: Optional[str] = None):
        # claim confidence so the scheduler CANNOT gate these drafts
        # away — the chaos hook must actually exercise the wide-verify
        # reject path, not fall back to the plain step
        return self.propose(history, k), True
