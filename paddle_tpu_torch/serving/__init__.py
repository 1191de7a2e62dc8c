"""``paddle_tpu_torch.serving`` — the overload-safe inference runtime of the
port (the reference's ``paddle_tpu/serving``; docs/serving.md):

- **deploy bundles** — bucket mode serves an ``InferenceModel`` loaded
  from a ``.ptz`` bundle (``config/deploy.py``) with no model code: warmup
  primes every batch bucket, a zero-row request replies empty inline;
  ``python -m paddle_tpu_torch serve`` (``serving/cli.py``) runs it from
  the command line;
- **batching** — a bounded, deadline-aware micro-batching queue that
  coalesces requests into power-of-two row buckets (``BatchQueue``);
- **admission control** — queue-overflow and infeasible-deadline requests
  are rejected immediately with typed ``ShedError`` / ``DeadlineExceeded``;
  every accepted request is guaranteed a reply or a typed error;
- **breaker** — a circuit breaker around the served forward;
- **worker** — a supervised worker thread: crash/hang -> bounded-backoff
  restart, behind a warmup/readiness gate;
- **degradation** — under overload, requests step down the configured
  tier ladder (e.g. a shorter ``max_len``) before shedding;
- **continuous batching** — ``InferenceServer(mode="generation")`` over
  the persistent decode slot table (``SlotScheduler``), finished requests'
  slots recycled to queued requests between steps, expired residents
  evicted mid-generation;
- **decode speed** — speculative decoding over a greedy table (the draft
  proposers of ``ops/speculative.py``), the prefix cache of prefill state
  (``PrefixCache``) and host paging of slots (``SlotPager``), none of which
  changes an answer;
- **observability** — ``ServerMetrics`` over the shared metrics registry
  (``paddle_tpu_torch.obs``), behind ``InferenceServer.healthz()``;
- **continuous delivery** — ``start(compile_cache=)`` loads the warmup's
  kernel libraries from a compile cache; ``reload.HotSwapManager`` swaps
  in newly published versions with probation and rollback;
  ``ModelFleet`` serves a model table with tenancy (``TenantAdmission``),
  canary, shadow and rollback; ``FleetRouter`` spreads tenants across
  servers by rendezvous hashing, health-gated.

Preflight and request tracing are not ported yet (ROADMAP.md Queue 1
item 9).
"""

from paddle_tpu_torch.serving.errors import (CircuitOpenError,
                                             DeadlineExceeded,
                                             InferenceFailed,
                                             InvalidRequestError,
                                             QuotaExceeded, ServerClosed,
                                             ServingError, ShedError,
                                             WorkerCrashed)
from paddle_tpu_torch.serving.batching import (BatchQueue, Request,
                                               ServingFuture, batch_bucket,
                                               canonicalize_feed,
                                               merge_feeds, split_outputs,
                                               warmup_bucket_feeds)
from paddle_tpu_torch.serving.breaker import CircuitBreaker
from paddle_tpu_torch.serving.metrics import ServerMetrics
from paddle_tpu_torch.serving.server import InferenceServer
from paddle_tpu_torch.serving.worker import WorkerSupervisor
from paddle_tpu_torch.serving.slots import (Seq2SeqSlotBackend, SlotBackend,
                                            SlotScheduler,
                                            example_slot_backend)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache, feed_key
from paddle_tpu_torch.serving.paging import PagedSlot, SlotPager
from paddle_tpu_torch.serving import feeds
from paddle_tpu_torch.serving.tenancy import (TenantAdmission, TenantSpec,
                                              TokenBucket)
from paddle_tpu_torch.serving.fleet import ModelFleet, canary_arm
from paddle_tpu_torch.serving.router import (FleetRouter,
                                             RouterDrainingError,
                                             rendezvous_rank)
from paddle_tpu_torch.serving.reload import (HotSwapManager, error_baseline,
                                             load_published)
from paddle_tpu_torch.ops.speculative import (AdversarialProposer,
                                              CallableDraftProposer,
                                              DraftProposer, NGramProposer)

__all__ = [
    "ServingError", "InvalidRequestError", "ShedError", "DeadlineExceeded",
    "CircuitOpenError", "WorkerCrashed", "InferenceFailed", "ServerClosed",
    "QuotaExceeded", "ServingFuture", "Request", "BatchQueue",
    "canonicalize_feed", "merge_feeds", "split_outputs", "batch_bucket",
    "warmup_bucket_feeds", "CircuitBreaker", "ServerMetrics",
    "InferenceServer", "WorkerSupervisor", "SlotBackend",
    "Seq2SeqSlotBackend", "SlotScheduler", "example_slot_backend",
    "PrefixCache", "feed_key",
    "PagedSlot", "SlotPager", "DraftProposer", "NGramProposer",
    "CallableDraftProposer", "AdversarialProposer", "feeds",
    "TenantSpec", "TokenBucket", "TenantAdmission", "ModelFleet",
    "canary_arm", "FleetRouter", "RouterDrainingError", "rendezvous_rank",
    "HotSwapManager", "error_baseline", "load_published",
]
