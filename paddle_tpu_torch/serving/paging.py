"""Host-paged slot state: decode capacity beyond the device slot table —
the port of ``paddle_tpu/serving/paging.py``.

The slot table is a fixed-capacity device resident (``slots`` × per-slot
state).  When every slot is occupied and requests queue, a cold slot (the
request with the most remaining budget) can be *paged out*: its full decode
context (:func:`paddle_tpu_torch.ops.decode.extract_slot` — token buffer,
scores, recurrent state rows, finished mask, step) is copied to a host
pool, the slot frees for an admission, and the parked request is *paged
back in* bit for bit later via
:func:`paddle_tpu_torch.ops.decode.restore_slot`.  The device-to-host and
back copies preserve every bit, so a paged request's completion is
identical to one that never left the table.

The pool is byte-budgeted (``max_mb``, counted over the bytes of every
payload tensor); FIFO re-admission keeps parked requests from starving.
``pages`` counts round trips per record so the scheduler can refuse to
thrash one victim repeatedly.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

__all__ = ["PagedSlot", "SlotPager", "payload_bytes"]


def payload_bytes(payload) -> int:
    """Bytes of the tensors in a nest of dicts, lists and tuples."""
    if isinstance(payload, dict):
        return sum(payload_bytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_bytes(v) for v in payload)
    if isinstance(payload, torch.Tensor):
        return payload.numel() * payload.element_size()
    return 0


@dataclass
class PagedSlot:
    """One parked request: everything needed to re-admit it."""

    request: Any                      # serving.batching.Request
    row: int                          # which row of the request this was
    limit: int                        # per-request decode budget
    t_admit: float                    # original admission time (deadline!)
    history: List[int]                # draft-proposer emission history
    tokens_done: int                  # emissions so far (budget tracking)
    payload: Dict[str, Any]           # extract_slot snapshot, host-side
    nbytes: int = 0
    pages: int = 1                    # page-out round trips so far
    admit_step: int = 0


class SlotPager:
    """FIFO host pool of :class:`PagedSlot` records under a byte budget.

    Thread-safe; the scheduler holds its own lock across page-out/in
    *decisions*, the pager only guards its queue.
    """

    def __init__(self, max_mb: float = 256.0):
        self.max_bytes = int(max_mb * (1 << 20))
        self._lock = threading.Lock()
        self._queue: "deque[PagedSlot]" = deque()
        self._bytes = 0
        self.paged_out = 0
        self.paged_in = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def has_room(self, nbytes: int) -> bool:
        with self._lock:
            return self._bytes + nbytes <= self.max_bytes

    def park(self, record: PagedSlot) -> bool:
        """Enqueue; False (caller keeps the slot resident) when the
        record would bust the byte budget."""
        if record.nbytes <= 0:
            record.nbytes = payload_bytes(record.payload)
        with self._lock:
            if self._bytes + record.nbytes > self.max_bytes:
                return False
            self._queue.append(record)
            self._bytes += record.nbytes
            self.paged_out += 1
            return True

    def pop(self) -> Optional[PagedSlot]:
        """Oldest parked record (FIFO — no starvation), or None."""
        with self._lock:
            if not self._queue:
                return None
            rec = self._queue.popleft()
            self._bytes -= rec.nbytes
            self.paged_in += 1
            return rec

    def sweep_expired(self, expired) -> List[PagedSlot]:
        """Remove and return records for which ``expired(record)`` is
        true — the paged half of the scheduler's deadline sweep."""
        out: List[PagedSlot] = []
        with self._lock:
            keep: "deque[PagedSlot]" = deque()
            for rec in self._queue:
                if expired(rec):
                    self._bytes -= rec.nbytes
                    out.append(rec)
                else:
                    keep.append(rec)
            self._queue = keep
        return out

    def drop_request(self, req) -> bool:
        """Purge a specific request (client abandon / server drop)."""
        dropped = self.sweep_expired(lambda rec: rec.request is req)
        return bool(dropped)

    def clear(self) -> List[PagedSlot]:
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            self._bytes = 0
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "parked": len(self._queue),
                "bytes": self._bytes,
                "paged_out": self.paged_out,
                "paged_in": self.paged_in,
            }
