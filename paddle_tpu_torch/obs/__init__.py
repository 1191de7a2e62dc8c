"""``paddle_tpu_torch.obs`` — the port's telemetry tier (the reference's
``paddle_tpu/obs``).  Ported so far: the process-wide metrics registry
(counters, gauges, histograms; Prometheus and JSON exposition; the
``/metrics`` HTTP endpoint), which ``serving.metrics.ServerMetrics`` is a
view over.  The event journal, request tracing, the step timeline and the
profiler capture wait for ROADMAP.md Queue 1 item 9."""

from paddle_tpu_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           get_registry, reset_registry,
                                           start_metrics_server)

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS", "get_registry", "reset_registry",
           "start_metrics_server"]
