"""``paddle_tpu_torch.obs`` — the port's telemetry tier (the reference's
``paddle_tpu/obs``).  Ported so far: the process-wide metrics registry
(counters, gauges, histograms; Prometheus and JSON exposition; the
``/metrics`` HTTP endpoint), which ``serving.metrics.ServerMetrics`` is a
view over, and the rank-tagged structured event journal
(``--obs_journal``), which the publish, reload, fleet and scrub tiers
write.  Request tracing, the step timeline, the profiler capture, the
audit and the ``obs`` command line wait for ROADMAP.md Queue 1 item 9."""

from paddle_tpu_torch.obs.journal import (EventJournal, close_journal,
                                          get_journal, journal_event,
                                          journal_files, journal_path,
                                          merge_journals, read_journal,
                                          set_journal_context)
from paddle_tpu_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           get_registry, reset_registry,
                                           start_metrics_server)

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS", "get_registry", "reset_registry",
           "start_metrics_server", "EventJournal", "journal_path",
           "journal_files", "read_journal", "merge_journals", "get_journal",
           "journal_event", "set_journal_context", "close_journal"]
