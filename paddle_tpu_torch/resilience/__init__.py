"""``paddle_tpu_torch.resilience`` — the port's resilience tier (the
reference's ``paddle_tpu/resilience``).  Ported so far:

- **errors** — the typed failure classes (a copy);
- **checkpoint_io** — atomic, CRC-verified ``pass-%05d`` checkpoints in the
  reference's format (either package reads the other's), retention, a
  validating ``latest_pass``;
- **guard** — the bad-step guard: finite checks on the device, every
  write of the update selected with ``torch.where``, and ``--amp``'s
  loss-scaled guard (``init_loss_scale``, ``scaled_guarded_update``);
- **reader** — ``resilient_reader`` retry/backoff/skip-bad;
- **signals** — ``PreemptionHandler`` (SIGTERM/SIGINT -> checkpoint at a
  batch boundary);
- **chaos** — the serving faults (``nan_feed``, ``kill_worker``,
  ``latency_injection``, ``crash_calls``, ``straggler_request``,
  ``slow_client``), the decode faults (``bad_draft``,
  ``corrupt_prefix_cache``), the training faults and the data-pipeline
  faults (``corrupt_shard``, ``truncate_shard``, ``slow_shard``) and the
  delivery faults (``corrupt_publish``, ``corrupt_compile_cache``,
  ``tenant_flood``, ``poison_tenant``, ``kill_canary``);
- **integrity** — the at-rest scrub (``scrub_paths``, quarantine,
  ``latest_verified_pass``, ``ScrubDaemon``).

The gang supervisor, the integrity fingerprint and SDC vote, and the rest
of the chaos harness wait for ROADMAP.md Queue 1 item 9."""

from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.checkpoint_io import (MANIFEST_VERSION,
                                                       latest_pass,
                                                       latest_valid_pass,
                                                       load_checkpoint,
                                                       load_pytree, npz_safe,
                                                       pass_dir,
                                                       prune_checkpoints,
                                                       quarantine_checkpoint,
                                                       read_manifest,
                                                       save_checkpoint,
                                                       save_pytree,
                                                       validate_checkpoint)
from paddle_tpu_torch.resilience.errors import (CheckpointError, ReaderError,
                                                TooManyBadSteps)
from paddle_tpu_torch.resilience.guard import (global_grad_norm,
                                               guarded_update,
                                               init_loss_scale,
                                               scaled_guarded_update)
from paddle_tpu_torch.resilience.reader import resilient_reader
from paddle_tpu_torch.resilience.signals import PreemptionHandler

__all__ = ["chaos", "CheckpointError", "ReaderError", "TooManyBadSteps",
           "MANIFEST_VERSION", "npz_safe", "save_pytree", "load_pytree",
           "save_checkpoint", "load_checkpoint", "read_manifest",
           "validate_checkpoint", "quarantine_checkpoint", "latest_pass",
           "latest_valid_pass", "prune_checkpoints", "pass_dir",
           "global_grad_norm", "guarded_update", "init_loss_scale",
           "scaled_guarded_update", "resilient_reader", "PreemptionHandler"]
