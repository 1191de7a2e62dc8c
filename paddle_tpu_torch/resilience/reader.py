"""Resilient reader wrapper — bounded retry with exponential backoff; the
port's own copy of the framework-free ``paddle_tpu/resilience/reader.py``.
It retries on the caller's thread (no thread of its own).

The reference's data tier (PyDataProvider2's async pool) dies with its
first exception and takes the pass down with it.  On preemptible fleets
the input pipeline is the flakiest tier (network filesystems, remote
shards, transient decoders), so ``resilient_reader`` wraps any reader
creator with:

- **bounded retry**: on an exception from iterator creation or ``next()``,
  the source is re-created and fast-forwarded past the samples already
  consumed (readers are assumed deterministic per epoch, which every
  ``paddle_tpu_torch.data`` reader is); after ``max_retries`` consecutive
  failures the original exception is re-raised wrapped in ``ReaderError``
  so the trainer attributes the crash to the data tier;
- **exponential backoff**: ``backoff * 2**k`` capped at ``max_backoff``
  between attempts (``sleep`` is injectable for tests);
- **skip-bad-batch**: with ``skip_bad=True``, once the retry budget for
  ONE sample is exhausted that sample is dropped and iteration continues,
  trading one lost batch for a live run.  Skipping assumes the failing
  ``next()`` advances the source's cursor past the bad record (an
  iterator reading records from a file — the corrupt-record model); a
  plain generator dies with its first raise, so for generator sources a
  skipped sample ends the epoch early (logged) rather than hanging.

A successful yield resets the retry budget — the bound is on consecutive
failures, not per epoch.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator, Optional

from paddle_tpu_torch.resilience.errors import ReaderError
from paddle_tpu_torch.utils.log import logger

__all__ = ["resilient_reader"]

Reader = Callable[[], Iterator[Any]]


def resilient_reader(
    reader: Reader,
    *,
    max_retries: int = 3,
    backoff: float = 0.1,
    max_backoff: float = 30.0,
    skip_bad: bool = False,
    sleep: Callable[[float], None] = time.sleep,
    on_error: Optional[Callable[[Exception, int], None]] = None,
) -> Reader:
    """Wrap a reader creator; see module docstring for the policy.

    ``on_error(exc, sample_index)`` is invoked on every absorbed failure —
    the hook the chaos tests use to count recoveries.
    """

    def creator():
        consumed = 0       # source slots consumed (delivered + skipped)
        failures = 0       # consecutive failures (any tier)
        sample_fail = 0    # consecutive failures at the CURRENT sample
        skipped = set()    # slots dropped by the skip-bad policy

        def _absorb(e: Exception) -> None:
            nonlocal failures
            failures += 1
            if failures > max_retries:
                raise ReaderError(
                    f"reader failed {failures} consecutive times at sample "
                    f"{consumed}: {type(e).__name__}: {e}") from e
            if on_error is not None:
                on_error(e, consumed)
            delay = min(backoff * (2.0 ** (failures - 1)), max_backoff)
            logger.warning(
                "reader error at sample %d (attempt %d/%d), retrying in "
                "%.2fs: %s: %s", consumed, failures, max_retries, delay,
                type(e).__name__, e)
            sleep(delay)

        while True:
            # (re)create the source and fast-forward past consumed slots;
            # a slot the skip-bad policy already dropped may raise again on
            # replay (it is the known-bad record) — absorb exactly those;
            # a fresh failure at any other slot goes through the normal
            # retry/backoff path so transient errors never drop samples
            try:
                it = reader()
                ended = False
                slot = 0
                while slot < consumed:
                    try:
                        next(it)
                    except StopIteration:
                        ended = True
                        break
                    except Exception:
                        if slot not in skipped:
                            raise
                    slot += 1
            except StopIteration:
                return  # source shrank below the resume point
            except Exception as e:
                _absorb(e)
                continue
            if ended:
                return
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    return
                except Exception as e:
                    sample_fail += 1
                    if skip_bad and sample_fail > max_retries:
                        logger.warning(
                            "reader: skipping bad sample %d after %d "
                            "attempts: %s", consumed, sample_fail,
                            type(e).__name__)
                        skipped.add(consumed)
                        consumed += 1  # the failed next() consumed the slot
                        failures = 0
                        sample_fail = 0
                        continue  # same iterator: resume past the record
                    _absorb(e)
                    break  # re-create the source and retry this sample
                yield item
                consumed += 1
                failures = 0
                sample_fail = 0

    return creator
