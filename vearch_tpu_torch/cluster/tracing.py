"""Distributed tracing: spans, cross-process propagation, local store,
and an OTLP-HTTP exporter to a real collector.

The reference wires Jaeger/opentracing end-to-end (reference:
cmd/vearch/startup.go:66-85 initJaeger; ps/handler_document.go:123-126
extracts the span context from rpcx metadata; router request-id
middleware, router/server.go:63-80). Each process keeps a bounded ring
of finished spans, queryable via `GET /debug/traces` on every role, an
optional JSONL file export, and — when `[tracer] collector_endpoint` is
set — ships batches as OTLP/HTTP JSON (`POST {endpoint}/v1/traces`),
the wire shape Jaeger >=1.35 and every OTel collector ingest natively
(the modern equivalent of the reference's jaeger-agent UDP path).

Propagation rides the request envelope (`_trace_ctx` in the RPC body) —
the envelope is this framework's rpcx-metadata equivalent; handlers
never see transport headers.

A span is sampled when the client asked (`trace: true`) or the role's
`trace_sample` probability fires (reference: sampler type/param from the
[tracer] config block).
"""

from __future__ import annotations

import json
import random
import threading
import time

from vearch_tpu_torch.utils import mono_us
import uuid
from collections import deque
from typing import Any


class Span:
    __slots__ = (
        "tracer", "trace_id", "span_id", "parent_id", "name", "service",
        "start_us", "dur_us", "tags", "status", "_t0",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str | None, tags: dict | None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.name = name
        self.service = tracer.service
        self._t0 = time.monotonic()
        self.start_us = mono_us(self._t0)
        self.dur_us = 0
        self.tags: dict[str, Any] = dict(tags or {})
        self.status = "ok"

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def ctx(self) -> dict:
        """The propagation payload for downstream RPC bodies."""
        return {"trace_id": self.trace_id, "parent": self.span_id}

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.status = f"error: {type(exc).__name__}"
        self.dur_us = int((time.monotonic() - self._t0) * 1e6)
        self.tracer._finish(self)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start_us": self.start_us,
            "duration_us": self.dur_us,
            "tags": self.tags,
            "status": self.status,
        }


def _otlp_attr(key: str, value: Any) -> dict:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def span_to_otlp(d: dict) -> dict:
    """Ring-form span dict -> OTLP JSON span object."""
    start_ns = d["start_us"] * 1000
    return {
        "traceId": d["trace_id"],
        "spanId": d["span_id"],
        "parentSpanId": d.get("parent_id") or "",
        "name": d["name"],
        "kind": 2,  # SPAN_KIND_SERVER
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(start_ns + d["duration_us"] * 1000),
        "attributes": [
            _otlp_attr(k, v) for k, v in (d.get("tags") or {}).items()
        ],
        "status": (
            {"code": 1} if d.get("status") == "ok"
            else {"code": 2, "message": str(d.get("status"))}
        ),
    }


class OtlpHttpExporter:
    """Batching OTLP/HTTP JSON shipper (stdlib urllib, background
    thread). Export never blocks the request path: spans are queued and
    flushed every `flush_interval` seconds or `max_batch` spans; a dead
    collector costs a dropped batch and a counter, not latency."""

    def __init__(self, endpoint: str, service: str,
                 flush_interval: float = 2.0, max_batch: int = 512,
                 timeout: float = 5.0):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service = service
        self.flush_interval = float(flush_interval)
        self.max_batch = int(max_batch)
        self.timeout = float(timeout)
        self.dropped = 0
        self.exported = 0
        self._q: deque[dict] = deque(maxlen=8192)
        self._cond = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"otlp-export-{service}",
        )
        self._thread.start()

    def export(self, span_dict: dict) -> None:
        with self._cond:
            if len(self._q) == self._q.maxlen:
                self.dropped += 1  # eviction is loss too, count it
            self._q.append(span_dict)
            if len(self._q) >= self.max_batch:
                self._cond.notify()

    def _loop(self) -> None:
        while True:
            with self._cond:
                self._cond.wait(self.flush_interval)
                batch = list(self._q)
                self._q.clear()
                if self._stop and not batch:
                    return
            if batch:
                self._send(batch)

    def _send(self, batch: list[dict]) -> None:
        import urllib.request

        body = json.dumps({
            "resourceSpans": [{
                "resource": {"attributes": [
                    _otlp_attr("service.name", self.service),
                ]},
                "scopeSpans": [{
                    "scope": {"name": "vearch_tpu"},
                    "spans": [span_to_otlp(d) for d in batch],
                }],
            }],
        }).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
            self.exported += len(batch)
        except Exception:
            self.dropped += len(batch)

    def flush(self) -> None:
        """Synchronous drain for shutdown/tests (bounded by the
        constructor's send timeout)."""
        with self._cond:
            batch = list(self._q)
            self._q.clear()
        if batch:
            self._send(batch)

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        # the loop thread may be mid-_send with spans it already drained
        # from the queue — join it (bounded) or shutdown kills the POST
        self._thread.join(self.timeout + 1.0)
        self.flush()


class Tracer:
    """Per-process span factory + bounded finished-span store."""

    def __init__(self, service: str, max_spans: int = 2048,
                 sample_rate: float = 0.0, export_path: str | None = None,
                 collector_endpoint: str | None = None):
        self.service = service
        self.sample_rate = float(sample_rate)
        self.export_path = export_path
        self.exporter = (
            OtlpHttpExporter(collector_endpoint, service)
            if collector_endpoint else None
        )
        self._spans: deque[dict] = deque(maxlen=max_spans)
        self._lock = threading.Lock()

    def should_sample(self, explicit: bool) -> bool:
        return explicit or (
            self.sample_rate > 0 and random.random() < self.sample_rate
        )

    def span(self, name: str, ctx: dict | None = None,
             tags: dict | None = None) -> Span:
        """Start a span; `ctx` is an incoming `_trace_ctx` payload (or
        None for a root span)."""
        trace_id = (ctx or {}).get("trace_id") or uuid.uuid4().hex
        parent = (ctx or {}).get("parent")
        return Span(self, name, trace_id, parent, tags)

    def record(self, name: str, ctx: dict | None = None,
               start_us: int | None = None, dur_us: int = 0,
               tags: dict | None = None, status: str = "ok") -> Span:
        """Emit an already-measured span retroactively.

        The engine measures its phase windows inline (no tracer in
        scope) and ships them up as `[name, start_us, dur_us]` rows; the
        PS replays them here as child spans with their REAL wall
        windows, so /debug/traces shows coarse-quantize/scan/rerank
        timing nested under ps.search. Also used for rare raft events
        (elections, snapshot installs) that have no request context."""
        trace_id = (ctx or {}).get("trace_id") or uuid.uuid4().hex
        parent = (ctx or {}).get("parent")
        sp = Span(self, name, trace_id, parent, tags)
        if start_us is not None:
            sp.start_us = int(start_us)
        sp.dur_us = max(int(dur_us), 0)
        sp.status = status
        self._finish(sp)
        return sp

    def _finish(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            self._spans.append(d)
        if self.exporter is not None:
            self.exporter.export(d)
        if self.export_path:
            try:
                # lint: allow[serving-blocking] opt-in debug sink (export_path unset in serving configs); sampled spans only
                with open(self.export_path, "a") as f:
                    f.write(json.dumps(d) + "\n")
            except OSError:
                pass

    def spans(self, trace_id: str | None = None,
              limit: int = 200) -> list[dict]:
        with self._lock:
            items = list(self._spans)
        if trace_id:
            items = [s for s in items if s["trace_id"] == trace_id]
        return items[-limit:]


class SlowLog:
    """Per-role bounded ring of slow-request records, served at
    `GET /debug/slowlog` (reference: the PS slow-request marking around
    engine slow_search_time + the router access log's slow entries —
    here a structured ring instead of grep-able text).

    `threshold_ms <= 0` disables slow capture; killed requests are
    force-recorded regardless (a request the operator or a deadline had
    to abort is exactly what the slowlog exists to explain). Entries
    carry the PR-2 phase breakdown when the role has one in hand —
    schema in docs/OBSERVABILITY.md."""

    def __init__(self, maxlen: int = 256, threshold_ms: float = 0.0):
        self.threshold_ms = float(threshold_ms)
        self._entries: deque[dict] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def should_log(self, elapsed_ms: float, killed: bool = False) -> bool:
        return killed or (
            self.threshold_ms > 0 and elapsed_ms > self.threshold_ms
        )

    def add(self, entry: dict) -> None:
        e = dict(entry)
        e.setdefault("ts", time.time())  # lint: allow[wall-clock] operator-facing slowlog stamp, display-only
        with self._lock:
            self._entries.append(e)

    def entries(self, limit: int = 100) -> list[dict]:
        with self._lock:
            items = list(self._entries)
        return items[-max(int(limit), 0):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class NullSpan:
    """No-op stand-in so call sites stay branch-free."""

    trace_id = ""
    span_id = ""

    def set_tag(self, key, value):
        pass

    def ctx(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


NULL_SPAN = NullSpan()
