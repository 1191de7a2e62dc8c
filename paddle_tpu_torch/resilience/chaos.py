"""Serving faults of the chaos harness — the port's copy of the serving
subset of ``paddle_tpu/resilience/chaos.py``.

Each tool produces one fault the serving runtime must survive, typed and
without a silent drop (docs/serving.md):

- ``nan_feed`` poisons every float array of a request feed with NaN;
- ``kill_worker`` crashes the supervised inference worker with the next
  batch (or decode step) in flight;
- ``latency_injection`` wraps a model callable to stall chosen calls (the
  slow backend that must surface as ``DeadlineExceeded``);
- ``crash_calls`` makes chosen calls raise (the breaker-tripping backend);
- ``straggler_request`` marks a generation request never-EOS (the
  batch-hostage request continuous batching must contain);
- ``slow_client`` paces a feed stream (the trickling client admission
  control must not starve);
- ``bad_draft`` swaps a speculative scheduler's proposer for an
  always-wrong one (throughput may drop, output must not change);
- ``corrupt_prefix_cache`` flips bits inside cached prefill state (the
  cache's crc must catch it and the request must prefill afresh).
"""

from __future__ import annotations

import functools
import time as _time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

__all__ = ["nan_feed", "kill_worker", "latency_injection", "crash_calls",
           "straggler_request", "slow_client", "bad_draft",
           "corrupt_prefix_cache"]


def nan_feed(batch: Any) -> Any:
    """Recursively replace every float array's values with NaN (ints and
    non-arrays pass through)."""
    if isinstance(batch, dict):
        return {k: nan_feed(v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(nan_feed(v) for v in batch)
    if isinstance(batch, list):
        return [nan_feed(v) for v in batch]
    if isinstance(batch, np.ndarray) and batch.dtype.kind == "f":
        return np.full_like(batch, np.nan)
    return batch


def kill_worker(server) -> None:
    """Crash the server's supervised inference worker with the NEXT popped
    batch (bucket mode) or decode step (generation mode) in flight: the
    in-flight requests must fail with a typed ``WorkerCrashed`` and the
    supervisor must restart the worker within its backoff budget."""
    server.chaos_kill_worker()


def _windowed(fn: Callable, at: int, times: int,
              action: Callable[[int], None]) -> Callable:
    """Count calls (0-based) across the wrapper's lifetime and run
    ``action(i)`` before calls in ``[at, at+times)``.  ``functools.wraps``
    matters: the server dispatches tier options by inspecting the
    callable's signature, and ``inspect.signature`` follows
    ``__wrapped__``."""
    calls = [0]

    @functools.wraps(fn)
    def wrapped(feed, *rest):
        i = calls[0]
        calls[0] += 1
        if at <= i < at + times:
            action(i)
        return fn(feed, *rest)

    return wrapped


def latency_injection(fn: Callable, *, at: int = 0, times: int = 1,
                      delay_s: float = 0.2, sleep=_time.sleep) -> Callable:
    """Wrap a model callable: calls ``at .. at+times-1`` stall ``delay_s``
    before executing."""
    return _windowed(fn, at, times, lambda i: sleep(delay_s))


def crash_calls(fn: Callable, *, at: int = 0, times: int = 1,
                exc: Callable[..., Exception] = RuntimeError) -> Callable:
    """Wrap a model callable: calls ``at .. at+times-1`` raise ``exc``."""
    def action(i):
        raise exc(f"chaos: injected model failure on call {i}")

    return _windowed(fn, at, times, action)


def straggler_request(feed: dict, *, bias: float = -1e9,
                      key: str = "eos_bias") -> dict:
    """A copy of generation request ``feed`` whose per-request EOS-logit
    bias (``feed[key]``, ``[rows, 1]`` float) is pinned to the kill score,
    so no beam can emit EOS and the request decodes to its full
    ``max_len``.  Backends opt in by adding the bias in their step."""
    out = dict(feed)
    first = next(iter(out.values()))
    arr = first[0] if isinstance(first, tuple) else first
    rows = int(np.asarray(arr).shape[0])
    out[key] = np.full((rows, 1), float(bias), np.float32)
    return out


def slow_client(feeds: Iterable, *, delay_s: float = 0.05,
                sleep=_time.sleep) -> Iterable:
    """Yield request feeds with ``delay_s`` between them."""
    for f in feeds:
        yield f
        sleep(delay_s)


def bad_draft(scheduler, *, token: Optional[int] = None):
    """Sabotage speculative decoding with an ALWAYS-WRONG draft proposer:
    every draft position gets one constant token (default ``vocab - 1``),
    so the wide verify rejects essentially every draft and each step
    degrades to the baseline of >= 1 emitted token.  A wrong draft can slow
    decoding but never change it: outputs stay bit-identical to solo
    decode.  Returns the displaced proposer so the caller can restore
    it."""
    from paddle_tpu_torch.ops.speculative import AdversarialProposer

    if scheduler.spec_k <= 0:
        raise ValueError("bad_draft needs a speculative scheduler "
                         "(spec_k > 0)")
    if token is None:
        token = int(scheduler.backend.vocab_size) - 1
    prev = scheduler.proposer
    scheduler.proposer = AdversarialProposer(token)
    return prev


def corrupt_prefix_cache(scheduler, *, key: Optional[str] = None) -> int:
    """Flip bits inside resident prefix-cache payloads (one entry when
    ``key`` is given, else every entry): the bit-rot / torn-write fault of
    the host-side prefill cache.  The cache's crc over the key and the
    payload bytes must catch it at ``get``: the entry is dropped, counted
    as a miss AND a ``poisoned`` detection, and the request prefills
    afresh.  Returns the number of entries corrupted."""
    cache = scheduler.prefix_cache
    if cache is None:
        raise ValueError("corrupt_prefix_cache needs a scheduler with a "
                         "prefix cache (prefix_cache_mb > 0)")
    keys = [key] if key is not None else cache.keys()
    n = 0
    for k in keys:
        payload = cache.peek(k)
        if not payload:
            continue
        name = sorted(payload)[0]
        # damage a copy and splice it into the entry's own payload dict,
        # so the entry now holds bytes that no longer match its crc
        t = payload[name].clone()
        flat = t.reshape(-1)
        if flat.dtype == torch.bool:
            flat[: max(1, flat.numel() // 997)] ^= True
        else:
            raw = flat.view(torch.uint8)
            raw[: max(1, raw.numel() // 997)] ^= 0xFF
        payload[name] = t
        n += 1
    return n
