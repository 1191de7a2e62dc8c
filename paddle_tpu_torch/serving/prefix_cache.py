"""Prefix/session cache: reuse encoder state across requests — the port of
``paddle_tpu/serving/prefix_cache.py``.

Requests that share a source sentence (retries, fan-out, chat turns
re-sending the same context) or a chat ``session_id`` would re-run the
full encoder prefill for state the server just computed.  This cache keys
the *prefill output* (one slot-row of the per-row state, held as host
tensors) by content hash: sha256 over the model fingerprint plus the
canonical feed bytes (plus the session id when present), so an entry can
never be served to a different model or a different source.

Payloads are ``{name: torch.Tensor}`` on the CPU.  Under the bf16 compute
policy some leaves are bf16, which numpy cannot hold, so the bytes of a
leaf are read through an integer view of the tensor itself
(:func:`tensor_bytes`).

Integrity: every entry stores a crc32 over its key and over exactly the
bytes that admission copies back to the device (each leaf's dtype, shape
and raw bytes).  ``get`` re-checks it; a mismatch (bit-rot, or the
``resilience.chaos.corrupt_prefix_cache`` hook) drops the entry, counts a
miss AND a ``poisoned`` detection, and never serves the data.

Eviction is LRU under a byte budget (``max_mb``) in host memory;
hits/misses/evictions/poisoned counts feed the ``prefix_cache_*`` serving
metrics.  Thread-safe: the server's submit path and worker loop touch it
concurrently.
"""

from __future__ import annotations

import hashlib
import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["PrefixCache", "feed_key", "tensor_bytes"]

Payload = Dict[str, torch.Tensor]


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a tensor, any dtype (bf16 and bool included): the
    contiguous host copy viewed as bytes."""
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    return flat.view(torch.uint8).numpy().tobytes()


def feed_key(*parts) -> str:
    """Content-hash key over heterogeneous parts (strings, bytes, numpy
    arrays, tensors — arrays contribute dtype/shape/bytes so e.g. an i32
    and an i64 feed never collide)."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, torch.Tensor):
            h.update(str(p.dtype).encode())
            h.update(str(tuple(p.shape)).encode())
            h.update(tensor_bytes(p))
        elif isinstance(p, np.ndarray):
            h.update(str(p.dtype).encode())
            h.update(str(p.shape).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        elif isinstance(p, bytes):
            h.update(p)
        else:
            h.update(str(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:32]


def _crc(payload: Payload, key: str) -> int:
    c = zlib.crc32(key.encode())
    for name in sorted(payload):
        t = payload[name]
        c = zlib.crc32(f"{name}:{t.dtype}:{tuple(t.shape)}".encode(), c)
        c = zlib.crc32(tensor_bytes(t), c)
    return c


class _Entry:
    __slots__ = ("payload", "nbytes", "crc")

    def __init__(self, payload: Payload, key: str):
        self.payload = payload
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in payload.values())
        self.crc = _crc(payload, key)


class PrefixCache:
    """LRU, byte-budgeted, integrity-checked store of per-row prefill
    state (``{leaf_name: tensor}`` payloads on the host, one slot-row
    each)."""

    def __init__(self, max_mb: float = 64.0):
        self.max_bytes = int(max_mb * (1 << 20))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.poisoned = 0

    def key(self, *parts) -> str:
        return feed_key(*parts)

    def get(self, key: str) -> Optional[Payload]:
        """The payload for ``key``, or None (counted miss).  A corrupt
        entry — crc mismatch — is dropped, counted as a miss and a
        ``poisoned`` detection, and never returned."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            if _crc(e.payload, key) != e.crc:
                self._entries.pop(key)
                self._bytes -= e.nbytes
                self.poisoned += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e.payload

    def put(self, key: str, payload: Payload) -> bool:
        """Insert (idempotent; refreshes LRU position).  The entry holds
        its own host copy of each tensor (a later write to the caller's
        tensor never reaches it).  Returns False when the payload alone
        exceeds the whole budget."""
        e = _Entry({k: v.detach().to("cpu", copy=True).contiguous()
                    for k, v in payload.items()}, key)
        if e.nbytes > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = e
            self._bytes += e.nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1
            return True

    def clear(self) -> None:
        """Drop everything — called on model hot-swap (a new fingerprint
        would never hit anyway; clearing frees the bytes immediately)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._entries.keys())

    def peek(self, key: str) -> Optional[Payload]:
        """The raw payload WITHOUT the crc check or LRU touch — the
        chaos hook's window for in-place corruption."""
        with self._lock:
            e = self._entries.get(key)
            return e.payload if e is not None else None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "poisoned": self.poisoned,
            }
