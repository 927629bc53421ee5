"""Prometheus-format metrics (dependency-free).

TPU-native stand-in for the reference's monitor package (reference:
internal/monitor/monitor_service.go:77 Register — request duration/count
histograms labelled by op/code, cluster gauges, /metrics on every role).
Counter/Gauge/Histogram with label support, rendered in the Prometheus
text exposition format; every JsonRpcServer mounts a /metrics route and
auto-instruments request count + latency per (method, path, code).
"""

from __future__ import annotations

import logging
import threading
from typing import Iterable

_log = logging.getLogger("vearch.internal")

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)

# power-of-two buckets for count/size-shaped histograms (WAL batch
# entries, docs per write) where the latency-shaped defaults would put
# every sample in +Inf
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)  # lint: allow[bucket-drift] histogram boundaries, not device batch shapes


def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{v}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = ()):
        self.name, self.help, self.labels = name, help_, labels
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        lv = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[lv] = self._values.get(lv, 0.0) + by

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for lv, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_fmt_labels(self.labels, lv)} {v}")
        return "\n".join(lines)


class Gauge(Counter):
    def set(self, value: float, *label_values: str) -> None:
        lv = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[lv] = value

    def render(self) -> str:
        return super().render().replace(" counter", " gauge", 1)


class CallbackGauge:
    """Gauge whose samples are computed at scrape time (reference:
    monitor_service.go:51-73 cluster gauges are refreshed from master +
    etcd state on collection — pull-time evaluation gives the same
    freshness without a scrape loop). `fn` returns
    {label_values_tuple: value}; unlabelled gauges return {(): value}."""

    def __init__(self, name: str, help_: str, labels: tuple[str, ...], fn):
        self.name, self.help, self.labels, self.fn = name, help_, labels, fn

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        try:
            values = self.fn() or {}
        except Exception:  # a scrape must never 500 the /metrics page
            values = {}
        for lv, v in sorted(values.items()):
            lv = tuple(str(x) for x in lv)
            lines.append(f"{self.name}{_fmt_labels(self.labels, lv)} {v}")
        return "\n".join(lines)


class CallbackCounter(CallbackGauge):
    """Counter sampled at scrape time from an existing monotonic source
    (e.g. raft election totals, the OTLP exporter's dropped-span count)
    — avoids double-bookkeeping a value the owner already maintains.
    `fn` has the CallbackGauge contract: {label_values_tuple: value}."""

    def render(self) -> str:
        return super().render().replace(" gauge", " counter", 1)


class Histogram:
    def __init__(
        self,
        name: str,
        help_: str,
        labels: tuple[str, ...] = (),
        buckets: Iterable[float] = _DEFAULT_BUCKETS,
    ):
        self.name, self.help, self.labels = name, help_, labels
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, *label_values: str) -> None:
        lv = tuple(str(v) for v in label_values)
        with self._lock:
            counts = self._counts.setdefault(lv, [0] * (len(self.buckets) + 1))
            self._sums[lv] = self._sums.get(lv, 0.0) + value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for lv, counts in sorted(self._counts.items()):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(self.labels + ('le',), lv + (str(b),))} {cum}"
                )
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.labels + ('le',), lv + ('+Inf',))} "
                f"{counts[-1]}"
            )
            lines.append(
                f"{self.name}_sum{_fmt_labels(self.labels, lv)} "
                f"{self._sums[lv]}"
            )
            lines.append(
                f"{self.name}_count{_fmt_labels(self.labels, lv)} {counts[-1]}"
            )
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def counter(self, name, help_, labels=()) -> Counter:
        m = Counter(name, help_, labels)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name, help_, labels=()) -> Gauge:
        m = Gauge(name, help_, labels)
        with self._lock:
            self._metrics.append(m)
        return m

    def callback_gauge(self, name, help_, labels, fn) -> CallbackGauge:
        m = CallbackGauge(name, help_, labels, fn)
        with self._lock:
            self._metrics.append(m)
        return m

    def callback_counter(self, name, help_, labels, fn) -> CallbackCounter:
        m = CallbackCounter(name, help_, labels, fn)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, name, help_, labels=(), buckets=_DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(name, help_, labels, buckets)
        with self._lock:
            self._metrics.append(m)
        return m

    def attach(self, metric) -> None:
        """Expose an externally-owned metric (e.g. the process-wide
        internal-error counter) on this registry's /metrics page."""
        with self._lock:
            if metric not in self._metrics:
                self._metrics.append(metric)

    def render(self) -> str:
        with self._lock:
            return "\n".join(m.render() for m in self._metrics) + "\n"


# process-wide swallowed-exception counter (lint rule VL302: a broad
# except in a replication-critical path must raise, log, or count).
# Lives outside any server's registry — raft nodes and WALs are not
# servers — and is attach()ed to every JsonRpcServer registry so each
# role's /metrics page exposes it.
_internal_registry = Registry()
INTERNAL_ERRORS = _internal_registry.counter(
    "vearch_internal_errors_total",
    "exceptions deliberately swallowed at non-fatal sites, by site",
    ("site",))


def internal_error(site: str, exc: BaseException | None = None) -> None:
    """Count + log an exception a caller chose not to propagate.

    The contract for 'this failure must not break the caller' paths
    (observer hooks, best-effort notifications): swallowing is allowed
    only if the event is counted per site and logged — a replica that
    diverges silently is the incident the obs stack exists to catch.
    """
    INTERNAL_ERRORS.inc(site)
    if exc is not None:
        _log.warning("internal error at %s: %s: %s",
                     site, type(exc).__name__, exc)


def register_tracer_metrics(registry: "Registry", tracer) -> None:
    """OTLP exporter health counters on every traced role: a dead or
    slow collector costs dropped batches, never request latency — these
    make that loss visible instead of silent. Zero when no collector is
    configured (the exporter is absent)."""

    def _read(attr: str):
        def read() -> dict[tuple, float]:
            exp = getattr(tracer, "exporter", None)
            return {(): float(getattr(exp, attr, 0) or 0) if exp else 0.0}
        return read

    registry.callback_counter(
        "tracing_dropped_spans_total",
        "spans lost to queue overflow or a dead collector",
        (), _read("dropped"))
    registry.callback_counter(
        "tracing_exported_spans_total",
        "spans successfully shipped to the collector",
        (), _read("exported"))


def register_process_gauges(registry: "Registry") -> None:
    """Node/process system gauges on every role (reference:
    pkg/metrics/mserver system stats feeding the monitor registry):
    RSS, virtual size, CPU seconds, open fds, threads, uptime — read
    from /proc (zero-dep; silently absent off Linux)."""
    import os
    import time as _time

    start = _time.monotonic()  # clock steps must not bend uptime
    tick = float(os.sysconf("SC_CLK_TCK")) if hasattr(os, "sysconf") else 100.0
    page = float(os.sysconf("SC_PAGE_SIZE")) if hasattr(os, "sysconf") else 4096.0

    def read() -> dict[tuple, float]:
        out: dict[tuple, float] = {}
        try:
            with open("/proc/self/stat") as f:
                parts = f.read().rsplit(")", 1)[1].split()
            # fields after comm: utime=11 stime=12 num_threads=17
            # vsize=20 rss=21 (0-based in this post-comm slice)
            out[("cpu_seconds",)] = (float(parts[11]) + float(parts[12])) / tick
            out[("threads",)] = float(parts[17])
            out[("vsize_bytes",)] = float(parts[20])
            out[("rss_bytes",)] = float(parts[21]) * page
        except (OSError, IndexError, ValueError):
            pass
        try:
            out[("open_fds",)] = float(len(os.listdir("/proc/self/fd")))
        except OSError:
            pass
        out[("uptime_seconds",)] = _time.monotonic() - start
        return out

    registry.callback_gauge(
        "vearch_process", "process/system stats", ("stat",), read,
    )
