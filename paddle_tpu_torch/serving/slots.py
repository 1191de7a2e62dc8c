"""Slot-based continuous batching — counterpart of the core of
``paddle_tpu/serving/slots.py``.

The unit of scheduling is ONE DECODE STEP: a fixed-capacity decode table of
``S`` slots (each holding one request's ``K`` beams) lives across calls in
``SlotScheduler.carry``; ``decode_step`` advances every occupied slot by
one token; between steps the host harvests finished slots and refills them
from queued requests with ``write_slot``.  Every per-row computation of
the engine is row-independent and frozen slots are held bit for bit, so a
request's output does not depend on its neighbours in the table.

Deadline eviction (``evict_expired``) releases a resident whose deadline
passed mid-generation.  Three options make decode faster without changing
any output bit:

- **speculative decoding** (``spec_k > 0`` over a greedy table): a host
  draft proposer (``ops/speculative.py``) offers ``spec_k`` tokens per slot
  and ``spec_verify_step`` emits the longest prefix the model itself would
  have emitted, 1 to ``spec_k + 1`` tokens a step;
- **the prefix cache** (``prefix_cache_mb``): single-row requests whose
  source was prefilled before skip the encoder (``serving/prefix_cache.py``);
- **host paging** (``page_pool_mb``): a cold resident's whole decode
  context moves to a host pool so a queued request can take its slot, and
  comes back bit for bit (``serving/paging.py``).

``example_slot_backend`` is the compact backend of the ``serve
--serve_continuous`` smoke.  ``prime`` loads the kernel libraries the table
runs (K3 at prefill, K7 at the readout) from a compile cache, by one
synthetic admission cycle (``warm_cycle``) under it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.ops.decode import (LinearReadout, _leaves, _tree_map,
                                         _unflatten, decode_step,
                                         extract_slot, finalize_slots,
                                         init_slot_carry, release_slot,
                                         restore_slot, spec_verify_step,
                                         write_slot)
from paddle_tpu_torch.ops.numerics import compute_dtype
from paddle_tpu_torch.ops.speculative import NGramProposer
from paddle_tpu_torch.serving.batching import (Request, batch_bucket,
                                               merge_feeds)
from paddle_tpu_torch.serving.paging import PagedSlot, SlotPager
from paddle_tpu_torch.serving.prefix_cache import (PrefixCache, feed_key,
                                                   tensor_bytes)
from paddle_tpu_torch.utils.log import logger

__all__ = ["SlotBackend", "Seq2SeqSlotBackend", "SlotScheduler",
           "example_slot_backend"]


class SlotBackend:
    """Protocol of a generation backend servable through the slot table::

        beam_size       K, beams per slot (fixed for the table's lifetime)
        max_len         table depth: the longest decode any slot can run
        vocab_size      target vocabulary
        bos, eos        special token ids
        length_penalty  harvest-time score normalization (0 = off)
        readout         ops.decode readout (e.g. LinearReadout)

        prefill(feed)       canonical request feed -> per-sequence state
                            dict of tensors, leading dim = the feed's rows
        step_fn(tokens, state) -> (readout_input, new_state)
        example_feed(rows)  synthetic one-bucket feed (state template)
    """

    beam_size: int = 3
    max_len: int = 32
    vocab_size: int = 0
    bos: int = 0
    eos: int = 1
    length_penalty: float = 0.0

    def prefill(self, feed: Dict[str, Any]):
        raise NotImplementedError

    def step_fn(self, tokens, state):
        raise NotImplementedError

    def example_feed(self, rows: int = 1) -> Dict[str, Any]:
        raise NotImplementedError

    def fingerprint(self) -> Optional[str]:
        """Identity of the served model: the prefix cache and the draft
        corpus key their entries by it, so it must cover the parameter
        VALUES and every setting that changes an output.  A backend that
        cannot provide one returns None and those requests are not
        keyed."""
        return None


class Seq2SeqSlotBackend(SlotBackend):
    """The flagship, :class:`~paddle_tpu_torch.models.seq2seq
    .Seq2SeqAttention`, behind the slot table.

    The per-slot state is the full decode context: the attention-GRU carry
    ``s`` plus the beam-tiled encoder outputs, projections and mask the
    step re-reads every token.  Prefill runs the encoder at a FIXED source
    length ``src_len`` (requests padded up to it and masked), so every
    admitted request gives state of one shape.  The backend runs on its
    model's device."""

    def __init__(self, model, params, *, src_len: int,
                 beam_size: Optional[int] = None, max_len: int = 32,
                 length_penalty: float = 0.0, feed_name: str = "src"):
        from paddle_tpu_torch.data.feeder import bucket_length
        from paddle_tpu_torch.models.seq2seq import BOS, EOS
        from paddle_tpu_torch.utils.flags import FLAGS

        if src_len != bucket_length(src_len):
            raise ValueError(
                f"src_len {src_len} is not a feeder bucket "
                f"(bucket_length -> {bucket_length(src_len)}); canonical "
                f"request feeds could never fit the slot table")
        self.model, self.params = model, params
        self.device = model.device
        self.src_len = int(src_len)
        self.beam_size = int(FLAGS.beam_size if beam_size is None
                             else beam_size)
        self.max_len = int(max_len)
        self.length_penalty = float(length_penalty)
        self.feed_name = feed_name
        self.vocab_size = int(model.trg_vocab)
        self.bos, self.eos = BOS, EOS
        self.readout = LinearReadout(params["out_w"], params["out_b"])

    @torch.no_grad()
    def prefill(self, feed):
        from paddle_tpu_torch.ops.sequence import mask_from_lengths

        ids, lens = feed[self.feed_name]
        ids = torch.as_tensor(np.asarray(ids), device=self.device).long()
        lens = torch.as_tensor(np.asarray(lens),
                               device=self.device).long().reshape(-1)
        if ids.shape[1] > self.src_len:
            raise ValueError(
                f"request source length {ids.shape[1]} exceeds the slot "
                f"table's fixed src_len {self.src_len}")
        if ids.shape[1] < self.src_len:
            ids = torch.nn.functional.pad(
                ids, (0, self.src_len - ids.shape[1]), value=self.eos)
        mask = mask_from_lengths(lens, self.src_len)
        enc, enc_proj, s0 = self.model.encode(self.params, ids, mask)
        return {"s": s0, "enc": enc, "enc_proj": enc_proj, "mask": mask}

    def step_fn(self, tokens, state):
        from paddle_tpu_torch.ops.embedding import embedding_lookup

        y_emb = embedding_lookup(self.params["trg_emb"], tokens)
        s_new, _ = self.model._dec_step(
            self.params, y_emb, state["s"], state["enc"], state["enc_proj"],
            state["mask"])
        return s_new, dict(state, s=s_new)

    def example_feed(self, rows: int = 1):
        ids = np.full((rows, self.src_len), 3, np.int32)
        lens = np.full((rows,), self.src_len, np.int32)
        return {self.feed_name: (ids, lens)}

    def fingerprint(self) -> str:
        """sha256 over every parameter's name, shape, dtype and bytes (bf16
        through an integer view) and the backend's settings.  Memoised:
        the parameters are fixed for the backend's lifetime, and the hash
        reads every weight back to the host once."""
        fp = getattr(self, "_fingerprint", None)
        if fp is not None:
            return fp
        import hashlib

        h = hashlib.sha256()
        for name in sorted(self.params):
            t = self.params[name]
            h.update(f"{name}:{tuple(t.shape)}:{t.dtype}".encode())
            h.update(tensor_bytes(t))
        h.update(f"{self.src_len}:{self.beam_size}:{self.max_len}:"
                 f"{self.length_penalty}:{self.feed_name}".encode())
        self._fingerprint = "seq2seq:" + h.hexdigest()[:32]
        return self._fingerprint


@dataclass
class _SlotEntry:
    request: Request
    row: int          # which row of its (possibly multi-row) request
    limit: int        # per-request max_len, <= the table depth
    t_admit: float
    admit_step: int = 0   # steps_run at admission: per-request step
    #                       participation stays host-side (no device sync)
    history: List[int] = field(default_factory=list)
    #                       emission history (BOS-seeded): the draft
    #                       proposer's input, kept on the spec path
    tokens_done: int = 0  # emissions so far: the spec budget cap, and the
    #                       pager's remaining-work victim ranking
    pages: int = 0        # page-out round trips (anti-thrash bound)
    corpus_key: Optional[str] = None
    #                       request content hash scoping the draft
    #                       proposer's positional completion corpus


@dataclass
class _PendingRequest:
    request: Request
    rows: int
    results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = field(
        default_factory=list)
    steps: int = 0    # max decode steps across the request's rows




class SlotScheduler:
    """Drive a :class:`SlotBackend` through the slot table.

    Owns the device carry plus the host bookkeeping (slot -> request/row,
    per-request result assembly, free list).  Thread discipline as in the
    reference: one worker drives the scheduler at a time; the short
    bookkeeping sections take ``_lock`` so a supervisor ``reset()`` can never
    interleave with them, and a step's new carry is committed only when the
    caller's ``commit()`` still holds after the device call.

    ``spec_k > 0`` arms speculative decoding (greedy tables only: beam
    search has no greedy verify, so ``beam_size != 1`` turns it off with a
    log line), with ``draft`` as the proposer (default
    :class:`~paddle_tpu_torch.ops.speculative.NGramProposer`);
    ``prefix_cache_mb`` and ``page_pool_mb`` size the prefix cache and the
    host page pool (0 = off)."""

    def __init__(self, backend: SlotBackend, *, slots: int,
                 clock=time.monotonic, spec_k: int = 0,
                 draft: Optional[Any] = None,
                 prefix_cache_mb: float = 0.0,
                 page_pool_mb: float = 0.0):
        if slots < 1:
            raise ValueError("slot table needs at least 1 slot")
        self.backend = backend
        self.slots = int(slots)
        self._clock = clock
        #: compile-cache hits and misses of prime() over the table's life
        self.cache_hits = self.cache_misses = 0
        self._lock = threading.Lock()
        if spec_k > 0 and backend.beam_size != 1:
            logger.info("speculative decoding disabled: beam_size=%d "
                        "(greedy verify needs beam_size=1)",
                        backend.beam_size)
            spec_k = 0
        self.spec_k = int(spec_k)
        self.proposer = None
        if self.spec_k > 0:
            self.proposer = draft if draft is not None else NGramProposer()
        self.spec_drafted = 0    # draft tokens offered to verification
        self.spec_accepted = 0   # draft tokens the model confirmed
        self.spec_steps = 0      # wide verify steps run
        #: (n [S], accepted [S]) of the last drained wide step; None after
        #: a plain (gated) step
        self.last_spec: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: the dispatched wide step whose emissions the host has not read:
        #: (aux, entry snapshot).  The spec path runs one step deep — the
        #: card computes wide step N while the host harvests, admits and
        #: drafts for N+1; N's aux lands in the host accounting at the top
        #: of the next step (``_drain_spec``)
        self._spec_pending: Optional[Tuple[Dict[str, torch.Tensor],
                                           List[Any]]] = None
        self.prefix_cache = (PrefixCache(prefix_cache_mb)
                             if prefix_cache_mb > 0 else None)
        self.pager = SlotPager(page_pool_mb) if page_pool_mb > 0 else None
        # the state template: one prefill of a synthetic one-row feed
        tpl = backend.prefill(backend.example_feed(1))
        self._state_tpl = tpl     # the structure cache hits unflatten to
        # binds the slot count, not ``self``: a scheduler that referred to
        # itself would keep its table and backend alive until the cycle
        # collector runs
        slots = self.slots
        self._init_carry = lambda: init_slot_carry(
            tpl, slots=slots, beam_size=backend.beam_size,
            max_len=backend.max_len, eos=backend.eos)
        self.carry = self._init_carry()
        self._entries: List[Optional[_SlotEntry]] = [None] * self.slots
        self._free: List[int] = list(range(self.slots - 1, -1, -1))
        self._pending: Dict[int, _PendingRequest] = {}
        self.steps_run = 0
        self.recycled = 0       # slots freed (harvest)
        self.admitted = 0       # slots filled

    # -- occupancy ---------------------------------------------------------

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def occupied(self) -> int:
        with self._lock:
            return self.slots - len(self._free)

    def resident_requests(self) -> List[Request]:
        """The distinct requests currently holding slots or parked in the
        host page pool (oldest first) — the server's in-flight set for
        crash attribution."""
        with self._lock:
            return [p.request for p in self._pending.values()]

    def resident_view(self) -> List[Tuple[Request, List[int], int]]:
        """Per-resident ``(request, slots, steps_since_admit)``, from host
        bookkeeping alone (no device read)."""
        with self._lock:
            by_req: Dict[int, List[Any]] = {}
            for slot, e in enumerate(self._entries):
                if e is None:
                    continue
                ent = by_req.setdefault(id(e.request), [e.request, [], 0])
                ent[1].append(slot)
                ent[2] = max(ent[2], self.steps_run - e.admit_step)
            return [(r, s, n) for r, s, n in by_req.values()]

    @staticmethod
    def compiled_programs() -> int:
        """The port's counterpart of the reference's count of jit compiles:
        the kernel libraries (one CUDA extension module per
        ``csrc/<name>.cu``, built by ``nvcc`` or found built and then
        loaded at the first launch) loaded in this process so far.  The
        server's warmup reports the change across its cycle as
        ``warmup_compiles``; on the CPU, where only plain versions run, it
        stays 0."""
        from paddle_tpu_torch.ops.kernels.build import LIBRARIES

        return sum(lib._lib is not None for lib in LIBRARIES.values())

    def warm_cycle(self, feeds: List[Dict[str, Any]],
                   buckets: List[int]) -> None:
        """Run the table once on synthetic one-row requests: admission
        (prefill + write) at every row bucket of every feed shape, then
        one full admit -> step -> harvest cycle; the table is reset after
        each.  On the card this builds (or loads) the kernel libraries and
        warms the allocator before any real request arrives.  The caller
        zeroes the traffic counters afterwards."""
        from paddle_tpu_torch.serving.batching import (ServingFuture,
                                                       canonicalize_feed)

        t0 = self._clock()
        synth = None
        for feed in feeds:
            canon, _, sig = canonicalize_feed(feed)
            one = {name: (tuple(p[:1] for p in v)
                          if isinstance(v, tuple) else v[:1])
                   for name, v in canon.items()}

            def synth(n, one=one, sig=sig):
                return [Request(feed=one, rows=1, signature=sig,
                                future=ServingFuture(), deadline=None,
                                t_submit=t0, max_len=1)
                        for _ in range(n)]

            for bucket in buckets:
                self.admit(synth(min(bucket, self.slots)))
                self.reset()
        # one full cycle: step, finalize and release
        self.admit(synth(1))
        self.step()
        self.harvest()
        self.reset()

    def prime(self, cache, feeds: List[Dict[str, Any]], *,
              buckets: Optional[List[int]] = None) -> Dict[str, Any]:
        """Load-or-build every kernel library the table runs (the
        reference's prefill, step, write, release and finalize closures:
        here K3 for prefill and K7 for the readout) from the compile cache
        ``cache`` (``config/compile_cache.py``), by one ``warm_cycle`` under
        it.  Returns ``{"hits", "misses", "skipped"}`` (``skipped`` when
        no cache is given; nothing runs then).  Priming again against
        another cache stores the resident libraries there."""
        counts = {"hits": 0, "misses": 0, "skipped": cache is None}
        if cache is None:
            return counts
        from paddle_tpu_torch.config.compile_cache import priming

        if buckets is None:
            buckets = sorted({batch_bucket(r, self.slots)
                              for r in range(1, self.slots + 1)})
        with priming(cache) as got:
            self.warm_cycle(feeds, buckets)
        counts["hits"], counts["misses"] = got["hits"], got["misses"]
        self.cache_hits += got["hits"]
        self.cache_misses += got["misses"]
        return counts

    def reset(self) -> List[Request]:
        """Fresh table (worker relaunch): drops every resident request's
        state, parked ones included, and returns those requests so the
        caller can fail them."""
        with self._lock:
            dropped = [p.request for p in self._pending.values()]
            self.carry = self._init_carry()
            self._entries = [None] * self.slots
            self._free = list(range(self.slots - 1, -1, -1))
            self._pending.clear()
            if self.pager is not None:
                self.pager.clear()  # parked requests are in _pending too
            self.last_spec = None
            self._spec_pending = None  # aux of a pre-reset carry: stale
            return dropped

    # -- keys --------------------------------------------------------------

    def _key_parts(self, req: Request) -> Optional[List[Any]]:
        """The content a request's keys hash: the model fingerprint, the
        compute dtype, the chat ``session_id`` when present (chat turns
        never cross sessions) and the canonical feed bytes.  None when the
        backend has no fingerprint."""
        fp = self.backend.fingerprint()
        if fp is None:
            return None
        parts: List[Any] = [fp, f"dtype:{compute_dtype()}"]
        sid = getattr(req, "session_id", None)
        if sid is not None:
            parts.append(f"session:{sid}")
        for name in sorted(req.feed):
            v = req.feed[name]
            parts.append(name)
            if isinstance(v, (tuple, list)):
                parts.extend(np.asarray(x) for x in v)
            else:
                parts.append(np.asarray(v))
        return parts

    def _cache_key(self, req: Request) -> Optional[str]:
        """Prefix-cache key of a request, or None when it is not cached:
        no cache, a multi-row request (its rows would need keys of their
        own), or no fingerprint."""
        if self.prefix_cache is None or getattr(req, "rows", 1) != 1:
            return None
        parts = self._key_parts(req)
        return None if parts is None else self.prefix_cache.key(*parts)

    def _corpus_key(self, req: Request, row: int) -> Optional[str]:
        """Key of the draft proposer's positional completion corpus: the
        request's content plus its row.  Greedy decode is deterministic,
        so a request with the same key emits the same sequence and the
        proposer replays an earlier completion positionally.  The
        fingerprint scopes it to the live model: a hot-swap changes every
        key.  Independent of the prefix cache."""
        if self.spec_k <= 0:
            return None
        parts = self._key_parts(req)
        return None if parts is None else feed_key(f"row:{row}", *parts)

    # -- admission ---------------------------------------------------------

    @torch.no_grad()
    def admit(self, reqs: List[Request], *,
              limit_cap: Optional[int] = None,
              commit: Callable[[], bool] = lambda: True) -> int:
        """Prefill ``reqs`` (same signature) in ONE merged encoder call and
        write each REAL row into a free slot; ``merge_feeds``' replicated
        pad rows never take a slot.  ``limit_cap`` caps the decode budget
        of these requests (the server's degradation ladder).  The caller
        guarantees ``sum(rows) <= free_count()``.  Returns slots filled (0
        when ``commit()`` no longer holds after the prefill: an abandoned
        worker must not write into the fresh worker's table).  Raises on a
        prefill failure, with nothing admitted.

        With the prefix cache, single-row requests whose key was prefilled
        before run NO encoder: their cached state rows are stacked (padded
        by replication to the batch bucket, as a merged prefill is) and
        written straight into slots.  Prefill is row-independent and
        batch-invariant, so a cached row is the fresh row bit for bit.
        The misses are prefilled as one merged call, and their rows fill
        the cache after the commit."""
        if not reqs:
            return 0
        hits: List[Tuple[Request, Dict[str, torch.Tensor]]] = []
        misses: List[Request] = []
        keys: Dict[int, Optional[str]] = {}
        if self.prefix_cache is not None:
            for req in reqs:
                key = keys[id(req)] = self._cache_key(req)
                payload = self.prefix_cache.get(key) if key else None
                if payload is not None:
                    hits.append((req, payload))
                else:
                    misses.append(req)
        else:
            misses = list(reqs)
        state0, slices = None, []
        if misses:
            merged, slices, _rows = merge_feeds(misses, self.slots)
            state0 = self.backend.prefill(merged)
        state_h = None
        if hits:
            dev = self.carry["tokens"].device
            nleaf = len(hits[0][1])
            pad = batch_bucket(len(hits), self.slots) - len(hits)
            cols = []
            for i in range(nleaf):
                rows = [p[f"leaf{i}"] for _, p in hits]
                cols.append(torch.cat(rows + rows[-1:] * pad).to(dev))
            state_h = _unflatten(self._state_tpl, cols)
        now = self._clock()
        n = 0
        with self._lock:
            if not commit():
                return 0
            need = sum(b - a for a, b in slices) + len(hits)
            if need > len(self._free):
                raise RuntimeError(
                    f"admit overflow: {need} rows into "
                    f"{len(self._free)} free slots")
            placed = [(req, a, b, state0) for req, (a, b) in
                      zip(misses, slices)]
            placed += [(req, i, i + 1, state_h)
                       for i, (req, _) in enumerate(hits)]
            for req, a, b, state in placed:
                limit = max(1, min(req.max_len or self.backend.max_len,
                                   self.backend.max_len,
                                   limit_cap or self.backend.max_len))
                self._pending[id(req)] = _PendingRequest(
                    request=req, rows=b - a, results=[None] * (b - a))
                for row in range(a, b):
                    slot = self._free.pop()
                    write_slot(self.carry, slot, state, bos=self.backend.bos,
                               eos=self.backend.eos, row=row)
                    self._entries[slot] = _SlotEntry(
                        req, row - a, limit, now, self.steps_run,
                        history=[self.backend.bos],
                        corpus_key=self._corpus_key(req, row - a))
                    n += 1
            self.admitted += n
        # fill the cache from the rows just prefilled — after the commit,
        # so an abandoned worker's prefill never seeds it
        if self.prefix_cache is not None and misses and n:
            leaves = _leaves(state0)
            for req, (a, b) in zip(misses, slices):
                key = keys.get(id(req))
                if key is None or b - a != 1:
                    continue
                self.prefix_cache.put(key, {
                    f"leaf{i}": leaf[a:a + 1]
                    for i, leaf in enumerate(leaves)})
        return n

    # -- the step ----------------------------------------------------------

    @torch.no_grad()
    def step(self, commit: Callable[[], bool] = lambda: True) -> bool:
        """One decode step for every occupied slot.  The new carry is
        committed only if ``commit()`` still holds after the call.  With
        speculative decoding armed this is the wide step
        (``_spec_step``): up to ``spec_k + 1`` tokens a slot, bit-identical
        to one-token stepping."""
        if self.spec_k > 0:
            return self._spec_step(commit)
        b = self.backend
        new = decode_step(b.step_fn, b.readout, self.carry,
                          vocab_size=b.vocab_size, eos=b.eos)
        with self._lock:
            if not commit():
                return False
            self.carry = new
            self.steps_run += 1
            for e in self._entries:
                if e is not None:
                    e.tokens_done += 1
        return True

    def _spent(self, e: _SlotEntry) -> bool:
        """Host accounting says the slot's request is finished: its budget
        is spent or its drained history holds EOS."""
        return e.tokens_done >= e.limit or self.backend.eos in e.history[1:]

    def _spec_step(self, commit: Callable[[], bool]) -> bool:
        """One speculative step: drain the previous wide step, propose
        ``spec_k`` drafts per occupied slot from its emission history,
        and verify them all in ONE ``spec_verify_step`` call.  The per-slot
        ``cap`` (remaining budget) keeps wide emission inside each
        request's own ``max_len``.

        Speculation is GATED per step: when no occupied slot has a
        *confident* draft (``DraftProposer.propose_with_confidence``), the
        table runs the plain one-token step instead of paying ``k + 1``
        positions for one emission.  Gated steps offer no drafts and leave
        the acceptance counters alone.

        A slot that host accounting, just drained, finds finished (budget
        spent or EOS emitted) is never stepped again: its cap is 0 in the
        wide step, and the gated plain step freezes it as it freezes a
        free slot.  The reference's gated step has no such freeze: after a
        wide step that fills a slot's budget, its ``done_slots`` (reading
        the accounting one step behind) misses the slot, and the plain
        step decodes one token past the budget into its score."""
        k = self.spec_k
        if not self._drain_spec(commit):
            return False
        with self._lock:
            entries = list(self._entries)
        drafts = np.zeros((self.slots, k), np.int64)
        cap = np.zeros((self.slots,), np.int64)
        frozen: List[int] = []
        any_conf = False
        for slot, e in enumerate(entries):
            if e is None:
                continue
            if self._spent(e):
                frozen.append(slot)
            else:
                cap[slot] = e.limit - e.tokens_done
            d, conf = self.proposer.propose_with_confidence(
                e.history, k, key=e.corpus_key)
            drafts[slot] = d
            any_conf = any_conf or conf
        b = self.backend
        if not any_conf:
            # cold table: nothing worth verifying — one-token step.
            # Histories are not extended here (that would cost a host
            # sync); the proposer learns completed trajectories at harvest
            # instead, so a stale in-flight history only lowers acceptance
            carry = self.carry
            if frozen:
                active = carry["active"].clone()
                active[frozen] = False
                carry = dict(carry, active=active)
            new = decode_step(b.step_fn, b.readout, carry,
                              vocab_size=b.vocab_size, eos=b.eos)
            new["active"] = self.carry["active"]
            with self._lock:
                if not commit():
                    return False
                self.carry = new
                self.steps_run += 1
                for slot, e in enumerate(self._entries):
                    if (e is not None and e is entries[slot]
                            and slot not in frozen):
                        e.tokens_done += 1
                self.last_spec = None
            return True
        new, aux = spec_verify_step(b.step_fn, b.readout, self.carry, drafts,
                                    cap, vocab_size=b.vocab_size, eos=b.eos)
        with self._lock:
            if not commit():
                return False
            self.carry = new
            self.steps_run += 1
            self.spec_steps += 1
            self._spec_pending = (aux, entries)
        return True

    def _drain_spec(self, commit: Callable[[], bool] = lambda: True
                    ) -> bool:
        """Land the pending wide step's emissions in the host accounting:
        histories, ``tokens_done``, the acceptance counters, ``last_spec``.
        Called at the top of the next step (the card has finished the
        step by then, so the read-back costs a copy, not a stall) and by
        ``page_out_victim`` (a parked record must describe the carry it
        extracts).

        Every other reader of the accounting is sound against the one-step
        lag: ``done_slots`` under-claims at worst (a finished slot is
        harvested one cycle late), harvest reads tokens and scores from the
        carry, and ``_spec_step`` drains before it sets caps.  A reset
        between dispatch and drain fails ``commit()`` and the stale aux is
        dropped."""
        p = self._spec_pending
        if p is None:
            return True
        self._spec_pending = None
        aux, entries = p
        k = self.spec_k
        n_arr = aux["n"].cpu().numpy()
        em = aux["emitted"].cpu().numpy()
        acc = aux["accepted"].cpu().numpy()
        with self._lock:
            if not commit():
                return False
            for slot, e in enumerate(self._entries):
                # identity check: a slot released (harvest/evict) and maybe
                # re-admitted since dispatch must not receive the old
                # request's emissions
                if e is None or e is not entries[slot]:
                    continue
                ni = int(n_arr[slot])
                e.history.extend(int(t) for t in em[slot, :ni])
                e.tokens_done += ni
                self.spec_drafted += k
            self.spec_accepted += int(acc.sum())
            self.last_spec = (n_arr, acc)
        return True

    # -- harvest + eviction ------------------------------------------------

    def _release(self, slot: int) -> None:
        # callers hold _lock
        release_slot(self.carry, slot)
        self._entries[slot] = None
        self._free.append(slot)
        self.recycled += 1

    def _park(self, slot: int) -> None:
        # callers hold _lock: free the slot WITHOUT counting a recycle — a
        # paged-out request is still in flight, not completed
        release_slot(self.carry, slot)
        self._entries[slot] = None
        self._free.append(slot)

    def _drop_request(self, req: Request) -> int:
        # callers hold _lock: release EVERY slot the request occupies,
        # resident or parked in the host page pool
        n = 0
        for slot, e in enumerate(self._entries):
            if e is not None and e.request is req:
                self._release(slot)
                n += 1
        if self.pager is not None:
            self.pager.drop_request(req)
        self._pending.pop(id(req), None)
        return n

    # -- host paging -------------------------------------------------------

    @torch.no_grad()
    def page_out_victim(self,
                        commit: Callable[[], bool] = lambda: True) -> bool:
        """Move the coldest occupied slot to the host pool: the one with
        the MOST remaining budget (it would hold its slot longest), at
        least one step old and paged fewer than 2 times.  The pending wide
        step is drained first; the slot's whole decode context is copied
        to the host and the slot frees for an admission.  ``page_in``
        restores it bit for bit later.  Returns whether a slot moved."""
        if self.pager is None:
            return False
        if self.spec_k > 0 and not self._drain_spec(commit):
            return False
        with self._lock:
            best, best_rem = None, -1
            for slot, e in enumerate(self._entries):
                if (e is None or e.pages >= 2
                        or self.steps_run - e.admit_step <= 0):
                    continue
                rem = e.limit - e.tokens_done
                if rem > best_rem:
                    best_rem, best = rem, slot
            if best is None:
                return False
            ent = self._entries[best]
        payload = _tree_map(lambda t: t.cpu(),           # device -> host
                            extract_slot(self.carry, best))
        rec = PagedSlot(request=ent.request, row=ent.row, limit=ent.limit,
                        t_admit=ent.t_admit, history=list(ent.history),
                        tokens_done=ent.tokens_done, payload=payload,
                        pages=ent.pages + 1, admit_step=ent.admit_step)
        with self._lock:
            if not commit() or self._entries[best] is not ent:
                return False
            if not self.pager.park(rec):
                return False  # pool full: the slot stays resident
            self._park(best)
        return True

    @torch.no_grad()
    def page_in(self, commit: Callable[[], bool] = lambda: True) -> int:
        """Re-admit parked slots (FIFO, so none starves) while free slots
        remain, each restored bit for bit by ``restore_slot``.  Returns
        the slots restored.  Runs BEFORE new admissions each cycle."""
        if self.pager is None:
            return 0
        n = 0
        while True:
            with self._lock:
                if not self._free:
                    return n
            rec = self.pager.pop()
            if rec is None:
                return n
            with self._lock:
                if not commit():
                    # a reset is in flight: it clears the pager and fails
                    # every pending request, this one included
                    return n
                slot = self._free.pop()
                restore_slot(self.carry, slot, rec.payload)
                self._entries[slot] = _SlotEntry(
                    rec.request, rec.row, rec.limit, rec.t_admit,
                    self.steps_run, history=list(rec.history),
                    tokens_done=rec.tokens_done, pages=rec.pages,
                    corpus_key=self._corpus_key(rec.request, rec.row))
                n += 1

    def evict_expired(self, now: float,
                      commit: Callable[[], bool] = lambda: True
                      ) -> List[Tuple[Request, int]]:
        """Release every slot whose request's deadline has passed
        mid-generation, and drop parked records past theirs; returns
        ``(request, slots_freed)`` pairs (each request once) so the caller
        completes them with ``DeadlineExceeded``.  ``slots_freed`` counts
        the slots released NOW: rows of a multi-row request that already
        harvested, and parked rows, are not counted."""
        with self._lock:
            if not commit():
                return []
            expired: List[Request] = []
            for e in self._entries:
                if (e is not None and e.request.deadline is not None
                        and now > e.request.deadline
                        and not any(r is e.request for r in expired)):
                    expired.append(e.request)
            if self.pager is not None:
                # the paged half of the sweep: a parked request's deadline
                # keeps running in the host pool
                for rec in self.pager.sweep_expired(
                        lambda r: r.request.deadline is not None
                        and now > r.request.deadline):
                    if not any(r is rec.request for r in expired):
                        expired.append(rec.request)
            return [(req, self._drop_request(req)) for req in expired]

    def done_slots(self) -> List[int]:
        """Slots whose request finished: all beams EOS, or the request's own
        ``max_len`` reached.  One host read of two small tensors, skipped on
        an empty table.  On the speculative path the answer comes from the
        host accounting alone (no device read): it never over-claims and
        lags the carry by at most the one undrained wide step."""
        with self._lock:
            if not any(e is not None for e in self._entries):
                return []
            if self.spec_k > 0:
                return [i for i, e in enumerate(self._entries)
                        if e is not None and self._spent(e)]
            fin = self.carry["finished"].all(dim=1).cpu().numpy()
            stepc = self.carry["step"].cpu().numpy()
            return [i for i, e in enumerate(self._entries)
                    if e is not None and (fin[i] or stepc[i] >= e.limit)]

    @torch.no_grad()
    def harvest(self, commit: Callable[[], bool] = lambda: True
                ) -> List[Tuple[Request, Optional[Dict[str, Any]], int]]:
        """Collect finished slots, recycle them, and assemble completed
        requests: ``(request, {"tokens": [rows, K, limit],
        "scores": [rows, K]}, steps)`` sliced to each request's own
        ``max_len``.  On the speculative path each completed trajectory
        (the finalized tokens) is fed back to the draft proposer."""
        done = self.done_slots()
        if not done:
            return []
        with self._lock:
            if not commit():
                return []
            toks_d, scores_d = finalize_slots(
                self.carry, eos=self.backend.eos,
                length_penalty=self.backend.length_penalty)
            toks, scores = toks_d.cpu().numpy(), scores_d.cpu().numpy()
            stepc = self.carry["step"].cpu().numpy()
            out: List[Tuple[Request, Optional[Dict[str, Any]], int]] = []
            for slot in done:
                e = self._entries[slot]
                if e is None:
                    continue
                if self.spec_k > 0 and stepc[slot] > 0:
                    seq = [self.backend.bos] + [
                        int(t) for t in
                        toks[slot][0][:min(int(stepc[slot]), e.limit)]]
                    self.proposer.learn(seq, key=e.corpus_key)
                pend = self._pending.get(id(e.request))
                self._release(slot)
                if pend is None:
                    continue
                pend.results[e.row] = (toks[slot][:, :e.limit],
                                       scores[slot])
                pend.steps = max(pend.steps, int(stepc[slot]))
                if all(r is not None for r in pend.results):
                    self._pending.pop(id(e.request))
                    out.append((
                        pend.request,
                        {"tokens": np.stack([r[0] for r in pend.results]),
                         "scores": np.stack([r[1] for r in pend.results])},
                        pend.steps))
        return out


def example_slot_backend(*, slots: int = 4, beam_size: int = 4,
                         src_len: int = 8, max_len: int = 8,
                         vocab: int = 1024, dim: int = 128,
                         device=None) -> Seq2SeqSlotBackend:
    """A compact flagship-shaped backend (structure, not speed) for the CLI
    continuous smoke: a ``Seq2SeqAttention`` of width ``dim`` over
    ``vocab`` tokens, random weights from seed 0, on ``device`` (``cuda``
    unless the caller asks otherwise).  ``slots`` is accepted for the
    reference's signature; the table's size is the server's."""
    from paddle_tpu_torch.models import Seq2SeqAttention

    m = Seq2SeqAttention(src_vocab=vocab, trg_vocab=vocab, emb_dim=dim,
                         enc_dim=dim, dec_dim=dim, att_dim=dim,
                         device=device)
    return Seq2SeqSlotBackend(m, m.init(0), src_len=src_len,
                              beam_size=beam_size, max_len=max_len)
