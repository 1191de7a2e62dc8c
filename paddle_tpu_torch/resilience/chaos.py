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

and the training faults the trainer must survive:

- ``corrupt_file``, ``truncate_file`` and ``corrupt_checkpoint`` damage a
  checkpoint (validation must refuse it; resume must skip it);
- ``inject_nan_batches`` poisons chosen batches of a reader (the bad-step
  guard must skip them);
- ``flaky_reader`` makes a reader raise at a chosen sample
  (``resilient_reader`` must absorb it, or the trainer attribute it);
- ``preempt_at`` requests a preemption at a chosen batch (the trainer must
  checkpoint there and resume to the same losses);
- ``corrupt_shard``, ``truncate_shard`` and ``slow_shard`` damage or pace
  an indexed record shard set (``paddle_tpu_torch.datapipe``: a damaged
  record must raise a typed ``ShardCorruptError`` naming the file and
  record, a cut shard must fail to open, a slow one must not hang).
"""

from __future__ import annotations

import functools
import os
import signal as _signal
import time as _time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

__all__ = ["nan_feed", "kill_worker", "latency_injection", "crash_calls",
           "straggler_request", "slow_client", "bad_draft",
           "corrupt_prefix_cache", "corrupt_file", "truncate_file",
           "corrupt_checkpoint", "inject_nan_batches", "flaky_reader",
           "preempt_at", "corrupt_shard", "truncate_shard", "slow_shard",
           "corrupt_publish", "corrupt_compile_cache", "tenant_flood",
           "poison_tenant", "kill_canary"]


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


# ---------------------------------------------------------------------------
# training faults: storage, numerics, input pipeline, preemption
# ---------------------------------------------------------------------------


def corrupt_file(path: str, *, offset: Optional[int] = None,
                 nbytes: int = 64) -> None:
    """Bit-flip ``nbytes`` bytes in place (default: the middle of the
    file) — the silent-corruption model CRC validation must catch."""
    size = os.path.getsize(path)
    if size == 0:
        return
    if offset is None:
        offset = max(0, size // 2 - nbytes // 2)
    n = min(nbytes, size - offset)
    with open(path, "r+b") as f:
        f.seek(offset)
        chunk = f.read(n)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))


def truncate_file(path: str, *, keep_bytes: Optional[int] = None,
                  frac: float = 0.5) -> None:
    """Cut the file to ``keep_bytes`` (or ``frac`` of its size) — the
    torn-write / full-disk model."""
    size = os.path.getsize(path)
    keep = keep_bytes if keep_bytes is not None else int(size * frac)
    with open(path, "r+b") as f:
        f.truncate(max(0, keep))


def corrupt_checkpoint(ckpt_dir: str, *, target: str = "params.npz",
                       mode: str = "corrupt") -> None:
    """Damage one file of a checkpoint dir: ``corrupt`` (bit-flip),
    ``truncate``, or ``delete``."""
    path = os.path.join(ckpt_dir, target)
    if mode == "corrupt":
        corrupt_file(path)
    elif mode == "truncate":
        truncate_file(path)
    elif mode == "delete":
        os.remove(path)
    else:
        raise ValueError(f"unknown chaos mode {mode!r}")


def inject_nan_batches(reader: Callable, batches: Iterable[int]) -> Callable:
    """Wrap a reader creator: batch indices in ``batches`` (per epoch) are
    delivered NaN-poisoned via ``nan_feed``."""
    bad = frozenset(batches)

    def creator():
        for i, b in enumerate(reader()):
            yield nan_feed(b) if i in bad else b

    return creator


def flaky_reader(reader: Callable, *, fail_at: int, times: int = 1,
                 exc: Callable[..., Exception] = IOError) -> Callable:
    """Raise ``exc`` instead of yielding sample ``fail_at``, for the first
    ``times`` attempts across re-creations.  The failing ``__next__``
    consumes the underlying record (the corrupt-record-in-a-file model),
    so ``resilient_reader(..., skip_bad=True)`` can iterate past it."""
    remaining = [times]

    class _Flaky:
        def __init__(self):
            self._it = iter(reader())
            self._i = 0

        def __iter__(self):
            return self

        def __next__(self):
            i = self._i
            self._i += 1
            if i == fail_at and remaining[0] > 0:
                remaining[0] -= 1
                next(self._it)  # the bad record is consumed regardless
                raise exc(f"chaos: injected reader failure at sample {i}")
            return next(self._it)

    return _Flaky


def preempt_at(handler, *, batch: int, pass_id: int = 0,
               inner: Optional[Callable] = None,
               use_signal: bool = False) -> Callable:
    """Event handler that delivers a preemption when batch ``batch`` of
    pass ``pass_id`` begins (the trainer then checkpoints at that batch
    boundary, before stepping it).  ``handler`` is a PreemptionHandler;
    with ``use_signal=True`` a real SIGTERM is sent to this process
    instead.  ``inner`` chains the user's own event handler."""
    from paddle_tpu_torch.trainer import events as ev

    def event_handler(e):
        if (isinstance(e, ev.BeginIteration) and e.pass_id == pass_id
                and e.batch_id == batch):
            if use_signal:
                os.kill(os.getpid(), _signal.SIGTERM)
            else:
                handler.request()
        if inner is not None:
            inner(e)

    return event_handler


# ---------------------------------------------------------------------------
# data-pipeline faults (indexed record shards, ``paddle_tpu_torch.datapipe``)
# ---------------------------------------------------------------------------


def _shard_files(root: str):
    names = sorted(n for n in os.listdir(root) if n.endswith(".ptshard"))
    if not names:
        raise ValueError(f"no .ptshard files under {root!r}")
    return [os.path.join(root, n) for n in names]


def corrupt_shard(root: str, *, shard: int = 0,
                  record: Optional[int] = None) -> str:
    """Bit-flip one record's payload in place (``record=None`` flips the
    middle of the file, which still lands inside some record).  The next
    CRC-checked read of that record must raise a typed
    ``ShardCorruptError`` naming the file and record.  Returns the damaged
    path."""
    path = _shard_files(root)[shard]
    if record is None:
        corrupt_file(path)
        return path
    from paddle_tpu_torch.datapipe.shards import ShardReader

    r = ShardReader(path)
    try:
        off = int(r._offsets[record])
    finally:
        r.close()
    # past the 8-byte record header, so the length stays sane and the
    # failure is a payload CRC mismatch at exactly this record
    corrupt_file(path, offset=off + 8, nbytes=8)
    return path


def truncate_shard(root: str, *, shard: int = 0, frac: float = 0.5) -> str:
    """Cut a shard file (torn write, full disk): its footer and index are
    gone, so opening it must fail with a typed ``ShardCorruptError``,
    never a short read."""
    path = _shard_files(root)[shard]
    truncate_file(path, frac=frac)
    return path


def slow_shard(source, *, delay_s: float = 0.05) -> None:
    """Pace every record read of a ``ShardSource``/``ShardDataset`` by
    ``delay_s`` (a cold network file system, a throttled object store)."""
    ds = getattr(source, "dataset", source)
    ds._read_delay = float(delay_s)


# ---------------------------------------------------------------------------
# continuous delivery: publish dirs, compile caches, the fleet
# ---------------------------------------------------------------------------


def corrupt_publish(publish_dir: str, *, version: Optional[int] = None,
                    member: str = "model.ptz", mode: str = "corrupt",
                    nbytes: int = 64) -> Optional[str]:
    """Damage one member of a published model version (default: the
    NEWEST version's bundle) — the torn or bit-rotted publish the
    hot-reload path must skip: the reload manager journals
    ``publish_skipped_corrupt`` and the previous version keeps serving.
    Returns the damaged version dir, or None when nothing is published."""
    from paddle_tpu_torch.publish import latest_version, version_dir

    v = latest_version(publish_dir) if version is None else int(version)
    if v <= 0:
        return None
    vdir = version_dir(publish_dir, v)
    path = os.path.join(vdir, member)
    if mode == "corrupt":
        corrupt_file(path, nbytes=nbytes)
    elif mode == "truncate":
        truncate_file(path)
    elif mode == "delete":
        os.remove(path)
    else:
        raise ValueError(f"unknown chaos mode {mode!r}")
    return vdir


def corrupt_compile_cache(target: str, *, key: Optional[str] = None,
                          mode: str = "corrupt") -> Optional[str]:
    """Damage one compile-cache entry (``config/compile_cache.py``) — the
    stale-NFS / torn-write / bit-rot model the cache must absorb: a load
    that meets a damaged entry is a logged miss and a fresh build, never a
    crash or a wrong library.

    ``target`` is a ``--compile_cache_dir`` directory (damages the
    ``<key>.aotx`` file, or the first one when ``key`` is None) or a
    ``.ptz`` bundle (rewrites the archive with the matching ``aot/``
    member's payload bit-flipped or truncated).  Returns the damaged file
    or member name, or None when there was nothing to damage."""
    if os.path.isdir(target):
        names = sorted(n for n in os.listdir(target) if n.endswith(".aotx"))
        if key is not None:
            names = [n for n in names if n.startswith(key)]
        if not names:
            return None
        path = os.path.join(target, names[0])
        (corrupt_file if mode == "corrupt" else truncate_file)(path)
        return path
    # a bundle: zip members cannot be damaged in place — rewrite the
    # archive with the target member's payload mangled
    import zipfile

    with zipfile.ZipFile(target) as z:
        members = [(i.filename, z.read(i.filename)) for i in z.infolist()]
    victim = None
    for name, _ in members:
        if name.startswith("aot/") and (key is None or key in name):
            victim = name
            break
    if victim is None:
        return None
    with zipfile.ZipFile(target, "w", zipfile.ZIP_DEFLATED) as z:
        for name, data in members:
            if name == victim:
                mid = len(data) // 2
                data = (data[:mid] + bytes(b ^ 0xFF for b in data[mid:])
                        if mode == "corrupt" else data[:mid])
            z.writestr(name, data)
    return victim


def tenant_flood(fleet, feed: dict, *, tenant: str,
                 model: Optional[str] = None, factor: float = 2.5,
                 requests: Optional[int] = None,
                 timeout_s: float = 30.0) -> dict:
    """Flood ONE tenant of a :class:`~paddle_tpu_torch.serving.fleet
    .ModelFleet` with more than ``factor``x its configured capacity (burst
    + one second of rate), submitted back to back — the noisy-neighbour
    fault the tenancy tier contains.  The flooding tenant's overflow is
    rejected with a typed ``QuotaExceeded`` naming it (counted here), and
    every other tenant's traffic is untouched.  Returns the flood's
    outcome counts."""
    from paddle_tpu_torch.serving.errors import QuotaExceeded, ServingError

    spec = fleet.admission.specs[tenant]
    n = requests if requests is not None else \
        max(2, int(factor * (spec.burst + spec.rate)))
    out = {"submitted": n, "completed": 0, "quota_rejected": 0,
           "fair_share_shed": 0, "other_errors": 0}
    futs = []
    for _ in range(n):
        try:
            futs.append(fleet.submit(feed, model=model, tenant=tenant))
        except QuotaExceeded as e:
            out["fair_share_shed" if e.fair_share
                else "quota_rejected"] += 1
        except ServingError:
            out["other_errors"] += 1
    for f in futs:
        try:
            f.result(timeout_s)
            out["completed"] += 1
        except ServingError:
            out["other_errors"] += 1
    return out


def poison_tenant(fleet, tenant: str):
    """NaN-poison ONE tenant's traffic: every feed ``tenant`` submits
    through the fleet is replaced with ``nan_feed`` before admission, all
    other tenants' feeds pass through untouched.  With
    ``nonfinite='error'`` the entry serving that tenant fails its requests
    typed (``InferenceFailed``) and trips ITS OWN breaker.  Returns a
    restore() callable that removes the poison."""
    orig = fleet.submit

    def poisoned(feed, **kw):
        if kw.get("tenant") == tenant:
            feed = nan_feed(feed)
        return orig(feed, **kw)

    fleet.submit = poisoned

    def restore():
        if getattr(orig, "__func__", None) is type(fleet).submit:
            # drop the instance attribute: the fleet keeps no reference
            # cycle through its own bound method
            del fleet.submit
        else:
            fleet.submit = orig

    return restore


def kill_canary(fleet, model: str, *, mode: str = "nan"):
    """Corrupt a model's CANARY mid-rollout: the candidate entry's
    forward goes bad under live traffic — ``mode="nan"`` swaps in a
    forward that emits NaN (the poisoned-weights model; with
    ``nonfinite='error'`` every canary request fails typed),
    ``mode="crash"`` one that raises (trips the canary's breaker).  The
    fleet must roll back within probation, journaling
    ``publish_rollback`` naming the entry, while the INCUMBENT arm is never
    interrupted and no request is dropped.  Returns the displaced model."""
    route = fleet.route(model)
    if route["candidate"] is None:
        raise ValueError(f"model {model!r} has no canary/shadow candidate "
                         f"to kill")
    entry = fleet.entry(model, route["candidate"])
    prev = entry.server.model

    def bad_forward(feed, *rest):
        if mode == "crash":
            raise RuntimeError("chaos: canary forward wedged")
        outs = (prev.infer(feed) if hasattr(prev, "infer")
                else prev(feed, *rest))
        return {k: (np.full_like(v, np.nan)
                    if np.asarray(v).dtype.kind == "f" else v)
                for k, v in outs.items()}

    entry.server.swap_model(bad_forward)
    return prev
