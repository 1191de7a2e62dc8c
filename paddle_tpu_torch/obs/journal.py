"""Rank-tagged structured event journal — the port's copy of
``paddle_tpu/obs/journal.py`` (framework-free; the port keeps its own copy
and imports nothing of the JAX package).

Every rank writes an append-only JSONL journal whose records carry the
sticky ``pass`` / ``batch`` / ``epoch`` / ``world_size`` context, and
``merge_journals`` interleaves per-rank journals into ONE causal timeline.
The publish, reload and fleet tiers write their ``publish_commit``,
``publish_refused``, ``reload_commit``, ``probation_passed``,
``publish_rollback``, ``publish_skipped_corrupt``, ``fleet_rollout``,
``shadow_divergence`` and ``scrub_fail`` records here.

Crash safety contract:

- the writer is line-buffered append: a record is either a whole line or
  a torn final fragment, never interleaved garbage;
- ``fsync=True`` records (checkpoint commits, publish commits) flush AND
  fsync before returning — the durable anchor points of a postmortem;
- the reader tolerates a torn final line (and counts it), so one rank's
  SIGKILL mid-write can never make the merged timeline unreadable.

Ordering: records are sorted by (wall-clock ``t``, rank, per-writer
``seq``).  Within one rank, ``seq`` is authoritative even when the clock
steps backwards.

The process journal is armed by ``--obs_journal=DIR``; its rank comes from
``PADDLE_TPU_TORCH_PROCESS_ID`` (default 0) and its world size from
``PADDLE_TPU_TORCH_GANG_SIZE`` (default 1).
"""

from __future__ import annotations

import glob as _glob
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["EventJournal", "journal_path", "read_journal", "merge_journals",
           "journal_files", "get_journal", "journal_event", "close_journal",
           "set_journal_context"]

#: per-rank journal file pattern inside a journal directory
_PATTERN = "events-r*.jsonl"


def journal_path(journal_dir: str, rank: int) -> str:
    """events-r00000.jsonl — the supervisor (rank -1) writes
    ``events-rsup.jsonl`` so a shared dir never collides."""
    tag = "sup" if rank < 0 else f"{rank:05d}"
    return os.path.join(journal_dir, f"events-r{tag}.jsonl")


class EventJournal:
    """Append-only JSONL writer for ONE process/rank.

    ``set_context`` merges sticky fields (pass/batch/epoch/world_size)
    into every subsequent record — call sites then journal just the
    event-specific payload.  Thread-safe: serving workers and the train
    loop may share one journal.
    """

    def __init__(self, path: str, *, rank: int = 0,
                 world_size: int = 1) -> None:
        self.path = path
        self.rank = int(rank)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # line-buffered text append: one record == one write == one line
        self._f = open(path, "a", buffering=1, encoding="utf-8")
        self._lock = threading.Lock()
        self._seq = 0
        self._ctx: Dict[str, Any] = {"world_size": int(world_size)}

    def set_context(self, **fields: Any) -> None:
        """Update the sticky fields stamped onto every record (pass_id ->
        ``pass``, batch_id -> ``batch`` for record compactness)."""
        with self._lock:
            for k, v in fields.items():
                k = {"pass_id": "pass", "batch_id": "batch"}.get(k, k)
                if v is None:
                    self._ctx.pop(k, None)
                else:
                    self._ctx[k] = v

    def record(self, kind: str, *, fsync: bool = False,
               **fields: Any) -> Dict[str, Any]:
        """Append one record; with ``fsync`` the line is durable on
        return (checkpoint-commit / resize anchors)."""
        with self._lock:
            rec = {**self._ctx, **fields}
            # the envelope is the writer's, always: a payload field named
            # rank/t/seq would corrupt attribution and merge order
            rec.update(t=time.time(), rank=self.rank, seq=self._seq,
                       kind=kind)
            self._seq += 1
            try:
                self._f.write(json.dumps(rec, default=str,
                                         separators=(",", ":")) + "\n")
                if fsync:
                    self._f.flush()
                    os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass  # a full disk / closed fd must never kill training
            return rec

    def record_batch(self, kind: str, payloads: Iterable[Dict[str, Any]],
                     *, fsync: bool = False) -> None:
        """Append many records of one kind in ONE write: each payload
        is still its own line/record with its own envelope and ``seq``,
        the single write just amortizes the per-line syscall.  The crash
        contract is unchanged: whole lines or one torn tail."""
        with self._lock:
            lines = []
            for fields in payloads:
                rec = {**self._ctx, **fields}
                rec.update(t=time.time(), rank=self.rank, seq=self._seq,
                           kind=kind)
                self._seq += 1
                lines.append(json.dumps(rec, default=str,
                                        separators=(",", ":")))
            if not lines:
                return
            try:
                self._f.write("\n".join(lines) + "\n")
                if fsync:
                    self._f.flush()
                    os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass  # a full disk / closed fd must never kill the caller

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# reading + merging
# ---------------------------------------------------------------------------


def read_journal(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse one journal; returns ``(records, torn)`` where ``torn``
    counts unparseable lines (a SIGKILL mid-write leaves at most one —
    the final fragment; anything else is real corruption, still skipped
    rather than fatal)."""
    records: List[Dict[str, Any]] = []
    torn = 0
    try:
        f = open(path, "r", encoding="utf-8", errors="replace")
    except OSError:
        return records, torn
    with f:
        pending = ""
        for line in f:
            if not line.endswith("\n"):
                pending = line  # torn final fragment (no newline)
                break
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                torn += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                torn += 1
        if pending.strip():
            torn += 1
    return records, torn


def journal_files(target: str) -> List[str]:
    """Expand a journal dir (its ``events-r*.jsonl`` members, sorted) or
    pass a file through."""
    if os.path.isdir(target):
        return sorted(_glob.glob(os.path.join(target, _PATTERN)))
    return [target]


def merge_journals(targets: Iterable[str]) -> Tuple[List[Dict[str, Any]], int]:
    """Interleave per-rank journals into one causal timeline: records
    sorted by (t, rank, seq).  ``targets`` may mix directories and files;
    returns ``(timeline, torn_total)``."""
    paths: List[str] = []
    for t in targets:
        paths.extend(journal_files(t))
    merged: List[Dict[str, Any]] = []
    torn_total = 0
    for p in paths:
        recs, torn = read_journal(p)
        merged.extend(recs)
        torn_total += torn
    merged.sort(key=lambda r: (r.get("t", 0.0), r.get("rank", 0),
                               r.get("seq", 0)))
    return merged, torn_total


# ---------------------------------------------------------------------------
# process journal (armed by --obs_journal)
# ---------------------------------------------------------------------------

_journal: Optional[EventJournal] = None
_journal_key: Optional[Tuple[str, int]] = None
_journal_lock = threading.Lock()


def get_journal(*, rank: Optional[int] = None,
                world_size: Optional[int] = None) -> Optional[EventJournal]:
    """The process journal, opened lazily under ``FLAGS.obs_journal``
    (a directory; '' = journaling off -> None).  ``rank`` defaults to
    ``PADDLE_TPU_TORCH_PROCESS_ID`` so every rank lands in its own file of
    the shared dir."""
    global _journal, _journal_key
    from paddle_tpu_torch.utils.flags import FLAGS

    d = getattr(FLAGS, "obs_journal", "") or ""
    if not d:
        return None
    if rank is None:
        rank = int(os.environ.get("PADDLE_TPU_TORCH_PROCESS_ID", "0") or 0)
    with _journal_lock:
        key = (d, int(rank))
        if _journal is None or _journal_key != key:
            if _journal is not None:
                _journal.close()
            _journal = EventJournal(
                journal_path(d, rank), rank=rank,
                world_size=(world_size if world_size is not None else int(
                    os.environ.get("PADDLE_TPU_TORCH_GANG_SIZE", "1") or 1)))
            _journal_key = key
        if world_size is not None:
            _journal.set_context(world_size=int(world_size))
        return _journal


def journal_event(kind: str, *, fsync: bool = False, **fields: Any) -> None:
    """Fire-and-forget convenience for call sites that must stay cheap
    when journaling is off: no-op unless ``--obs_journal`` armed."""
    j = get_journal()
    if j is not None:
        j.record(kind, fsync=fsync, **fields)


def set_journal_context(**fields: Any) -> None:
    j = get_journal()
    if j is not None:
        j.set_context(**fields)


def close_journal() -> None:
    global _journal, _journal_key
    with _journal_lock:
        if _journal is not None:
            _journal.close()
        _journal = None
        _journal_key = None
