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
passed mid-generation.  Speculative decoding, the prefix cache, host paging
and the compile-cache ``prime`` wait for later slices (ROADMAP.md Queue 1
items 2 and 7).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.ops.decode import (LinearReadout, decode_step,
                                         finalize_slots, init_slot_carry,
                                         release_slot, write_slot)
from paddle_tpu_torch.serving.batching import Request, merge_feeds

__all__ = ["SlotBackend", "Seq2SeqSlotBackend", "SlotScheduler"]


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


@dataclass
class _SlotEntry:
    request: Request
    row: int          # which row of its (possibly multi-row) request
    limit: int        # per-request max_len, <= the table depth
    t_admit: float
    admit_step: int = 0   # steps_run at admission: per-request step
    #                       participation stays host-side (no device sync)


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
    caller's ``commit()`` still holds after the device call."""

    def __init__(self, backend: SlotBackend, *, slots: int,
                 clock=time.monotonic):
        if slots < 1:
            raise ValueError("slot table needs at least 1 slot")
        self.backend = backend
        self.slots = int(slots)
        self._clock = clock
        self._lock = threading.Lock()
        # the state template: one prefill of a synthetic one-row feed
        tpl = backend.prefill(backend.example_feed(1))
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
        """The distinct requests currently holding slots (oldest first) —
        the server's in-flight set for crash attribution."""
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

    def reset(self) -> List[Request]:
        """Fresh table (worker relaunch): drops every resident request's
        state and returns those requests so the caller can fail them."""
        with self._lock:
            dropped = [p.request for p in self._pending.values()]
            self.carry = self._init_carry()
            self._entries = [None] * self.slots
            self._free = list(range(self.slots - 1, -1, -1))
            self._pending.clear()
            return dropped

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
        prefill failure, with nothing admitted."""
        if not reqs:
            return 0
        merged, slices, _rows = merge_feeds(reqs, self.slots)
        state0 = self.backend.prefill(merged)
        now = self._clock()
        n = 0
        with self._lock:
            if not commit():
                return 0
            need = sum(b - a for a, b in slices)
            if need > len(self._free):
                raise RuntimeError(
                    f"admit overflow: {need} rows into "
                    f"{len(self._free)} free slots")
            for req, (a, b) in zip(reqs, slices):
                limit = max(1, min(req.max_len or self.backend.max_len,
                                   self.backend.max_len,
                                   limit_cap or self.backend.max_len))
                self._pending[id(req)] = _PendingRequest(
                    request=req, rows=b - a, results=[None] * (b - a))
                for row in range(a, b):
                    slot = self._free.pop()
                    write_slot(self.carry, slot, state0, bos=self.backend.bos,
                               eos=self.backend.eos, row=row)
                    self._entries[slot] = _SlotEntry(req, row - a, limit,
                                                     now, self.steps_run)
                    n += 1
            self.admitted += n
        return n

    # -- the step ----------------------------------------------------------

    @torch.no_grad()
    def step(self, commit: Callable[[], bool] = lambda: True) -> bool:
        """One decode step for every occupied slot.  The new carry is
        committed only if ``commit()`` still holds after the call."""
        b = self.backend
        new = decode_step(b.step_fn, b.readout, self.carry,
                          vocab_size=b.vocab_size, eos=b.eos)
        with self._lock:
            if not commit():
                return False
            self.carry = new
            self.steps_run += 1
        return True

    # -- harvest -----------------------------------------------------------

    def _release(self, slot: int) -> None:
        # callers hold _lock
        release_slot(self.carry, slot)
        self._entries[slot] = None
        self._free.append(slot)
        self.recycled += 1

    def _drop_request(self, req: Request) -> int:
        # callers hold _lock: release EVERY slot the request occupies
        n = 0
        for slot, e in enumerate(self._entries):
            if e is not None and e.request is req:
                self._release(slot)
                n += 1
        self._pending.pop(id(req), None)
        return n

    def evict_expired(self, now: float,
                      commit: Callable[[], bool] = lambda: True
                      ) -> List[Tuple[Request, int]]:
        """Release every slot whose request's deadline has passed
        mid-generation; returns ``(request, slots_freed)`` pairs (each
        request once) so the caller completes them with
        ``DeadlineExceeded``.  ``slots_freed`` counts the slots released
        NOW: rows of a multi-row request that already harvested are not
        counted again."""
        with self._lock:
            if not commit():
                return []
            expired: List[Request] = []
            for e in self._entries:
                if (e is not None and e.request.deadline is not None
                        and now > e.request.deadline
                        and not any(r is e.request for r in expired)):
                    expired.append(e.request)
            return [(req, self._drop_request(req)) for req in expired]

    def done_slots(self) -> List[int]:
        """Slots whose request finished: all beams EOS, or the request's own
        ``max_len`` reached.  One host read of two small tensors, skipped on
        an empty table."""
        with self._lock:
            if not any(e is not None for e in self._entries):
                return []
            fin = self.carry["finished"].all(dim=1).cpu().numpy()
            stepc = self.carry["step"].cpu().numpy()
            return [i for i, e in enumerate(self._entries)
                    if e is not None and (fin[i] or stepc[i] >= e.limit)]

    def harvest(self, commit: Callable[[], bool] = lambda: True
                ) -> List[Tuple[Request, Optional[Dict[str, Any]], int]]:
        """Collect finished slots, recycle them, and assemble completed
        requests: ``(request, {"tokens": [rows, K, limit],
        "scores": [rows, K]}, steps)`` sliced to each request's own
        ``max_len``."""
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
