"""Process-wide metrics registry — the port's own copy of the framework-free
``paddle_tpu/obs/registry.py``.

Counters, gauges and histograms with optional labels, lock-protected,
exposed as Prometheus text (``prometheus_text()``), a JSON snapshot
(``snapshot()``), and an optional HTTP endpoint (``start_metrics_server``,
serving ``/metrics`` and ``/metrics.json``).

``serving.metrics.ServerMetrics`` is a view over this registry: it creates
labeled children here instead of keeping a private counter dict, so the
scrape endpoint and ``InferenceServer.healthz()`` can never tell different
stories.

Everything is host-side Python: nothing here reads a device tensor.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "reset_registry", "start_metrics_server",
           "DEFAULT_BUCKETS"]

#: default histogram bucket upper bounds, in seconds — spans data-wait
#: microseconds to multi-minute checkpoint writes
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0,
                   5.0, 10.0, 60.0, 300.0)


class _Child:
    """One (metric, labelvalues) time series."""

    __slots__ = ("_lock",)

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock


class Counter(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock) -> None:
        super().__init__(lock)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set_to(self, v: float) -> None:
        """Atomically mirror an externally-owned monotonic value (the
        serving supervisor owns worker_restarts) — a read-then-inc delta
        would race concurrent mirrors into a wrong total."""
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock) -> None:
        super().__init__(lock)
        self._value: Optional[float] = None

    def set(self, v: Optional[float]) -> None:
        with self._lock:
            self._value = None if v is None else float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram(_Child):
    __slots__ = ("buckets", "counts", "sum", "count", "min", "max",
                 "exemplars")

    def __init__(self, lock, buckets: Sequence[float]) -> None:
        super().__init__(lock)
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = 0.0
        #: bucket index -> most recent (exemplar id, value, t): a
        #: dashboard spike in one bucket links to a CONCRETE trace
        #: (docs/observability.md "Request tracing" — exemplars)
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if exemplar is not None:
                self.exemplars[i] = (str(exemplar), v, time.time())

    def _bucket_label(self, i: int) -> str:
        return ("+Inf" if i >= len(self.buckets)
                else repr(float(self.buckets[i])))

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.sum / self.count if self.count else None


class _Family:
    """A named metric family: one child per labelvalues tuple."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...], buckets=None) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()

    def child(self, labelvalues: Tuple[str, ...]):
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {labelvalues!r}")
        with self._lock:
            c = self._children.get(labelvalues)
            if c is None:
                if self.kind == "counter":
                    c = Counter(self._lock)
                elif self.kind == "gauge":
                    c = Gauge(self._lock)
                else:
                    c = Histogram(self._lock, self.buckets)
                self._children[labelvalues] = c
            return c

    def items(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    def remove(self, labelvalues: Tuple[str, ...]) -> None:
        with self._lock:
            self._children.pop(labelvalues, None)


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class MetricsRegistry:
    """Lock-protected family store with Prometheus + JSON exposition."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # -- registration ----------------------------------------------------

    def _family(self, name: str, kind: str, help: str,
                labels: Sequence[str], buckets=None) -> _Family:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, labels, buckets)
                self._families[name] = fam
            elif fam.kind != kind or fam.labelnames != labels:
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}{labels} "
                    f"(was {fam.kind}{fam.labelnames})")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = (), **labelvalues) -> Counter:
        return self._labeled(self._family(name, "counter", help, labels),
                             labels, labelvalues)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = (), **labelvalues) -> Gauge:
        return self._labeled(self._family(name, "gauge", help, labels),
                             labels, labelvalues)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labelvalues) -> Histogram:
        return self._labeled(
            self._family(name, "histogram", help, labels, tuple(buckets)),
            labels, labelvalues)

    @staticmethod
    def _labeled(fam: _Family, labels: Sequence[str], labelvalues):
        values = tuple(str(labelvalues[n]) for n in labels)
        return fam.child(values)

    def remove_series(self, name: str, **labelvalues) -> None:
        """Drop one (metric, labels) series from exposition — a retired
        server's counters must not be scraped forever.  The child object
        itself keeps working for holders of a reference (a closed
        server's ``healthz()`` still reads its final numbers)."""
        with self._lock:
            fam = self._families.get(name)
        if fam is not None:
            fam.remove(tuple(str(labelvalues[n]) for n in fam.labelnames))

    # -- exposition ------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view: {name: {kind, help, series: [{labels, ...}]}}."""
        out: Dict[str, dict] = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            series = []
            for values, child in fam.items():
                entry: dict = {"labels": dict(zip(fam.labelnames, values))}
                if fam.kind == "histogram":
                    # one consistent cut: count/sum/min/max must describe
                    # the SAME set of observations even mid-observe
                    with child._lock:
                        count, total = child.count, child.sum
                        lo, hi = child.min, child.max
                        exemplars = dict(child.exemplars)
                    entry.update(count=count,
                                 sum=round(total, 9),
                                 mean=(total / count if count else None),
                                 min=(None if count == 0 else lo),
                                 max=(hi if count else None))
                    if exemplars:
                        # JSON exposition only: the classic Prometheus
                        # text format has no exemplar syntax (that is
                        # OpenMetrics), and a suffix would corrupt
                        # strict v0.0.4 parsers
                        entry["exemplars"] = {
                            child._bucket_label(i): {
                                "trace": ex[0],
                                "value": round(ex[1], 6),
                                "t": round(ex[2], 3),
                            }
                            for i, ex in sorted(exemplars.items())
                        }
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in fam.items():
                ls = _label_str(fam.labelnames, values)
                if fam.kind == "histogram":
                    # snapshot under the lock: a scrape racing observe()
                    # must never emit +Inf < a finite bucket, or a count
                    # inconsistent with sum
                    with child._lock:
                        counts = list(child.counts)
                        count, total = child.count, child.sum
                    acc = 0
                    for b, c in zip(child.buckets, counts):
                        acc += c
                        le = _label_str(fam.labelnames + ("le",),
                                        values + (repr(float(b)),))
                        lines.append(f"{fam.name}_bucket{le} {acc}")
                    le = _label_str(fam.labelnames + ("le",),
                                    values + ("+Inf",))
                    lines.append(f"{fam.name}_bucket{le} {count}")
                    lines.append(f"{fam.name}_sum{ls} {total}")
                    lines.append(f"{fam.name}_count{ls} {count}")
                else:
                    v = child.value
                    if v is None:
                        # Prometheus convention: omit the sample for a
                        # never-set gauge — 0 would read as a real value
                        # (train_mfu 0 is "0% utilization", not "no data")
                        continue
                    lines.append(f"{fam.name}{ls} {v}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry — what ``start_metrics_server`` exposes
    by default."""
    return _REGISTRY


def reset_registry() -> None:
    """Drop every family from the global registry (tests)."""
    _REGISTRY.reset()


# ---------------------------------------------------------------------------
# HTTP exposition
# ---------------------------------------------------------------------------


def start_metrics_server(port: int, registry: Optional[MetricsRegistry] = None):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` on a
    daemon thread; returns the HTTPServer (``.server_port`` for port 0,
    ``.shutdown()`` to stop)."""
    import http.server

    reg = registry or _REGISTRY

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — stdlib handler contract
            if self.path.startswith("/metrics.json"):
                body = json.dumps(reg.snapshot()).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = reg.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes must not spam the train log
            pass

    srv = http.server.ThreadingHTTPServer(("", int(port)), Handler)
    t = threading.Thread(target=srv.serve_forever, name="obs-metrics",
                         daemon=True)
    t.start()
    return srv
