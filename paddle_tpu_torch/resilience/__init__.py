"""``paddle_tpu_torch.resilience`` — the port's resilience tier (the
reference's ``paddle_tpu/resilience``).  Ported so far: the serving faults
of ``chaos`` (``nan_feed``, ``kill_worker``, ``latency_injection``,
``crash_calls``, ``straggler_request``, ``slow_client``) and its decode
faults (``bad_draft``, ``corrupt_prefix_cache``).  The gang
supervisor, checkpoint I/O, the guard and the rest of the chaos harness
wait for ROADMAP.md Queue 1 items 4 and 9."""

from paddle_tpu_torch.resilience import chaos

__all__ = ["chaos"]
