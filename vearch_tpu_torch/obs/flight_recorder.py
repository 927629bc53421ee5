"""Compile flight recorder, the port of vearch_tpu/obs/flight_recorder.py:
serving-path compile events after warmup, live.

On the card a compile event is what ops/perf_model.py tracks as a new
program (`note_program`): the build or load of a native library
(`build.<source>`, with its seconds), or the first call of a registered
op or kernel wrapper at a new shape signature. The recorder, installed
as perf_model's compile observer, keeps:

- a bounded ring of post-warmup events (program, shape signature, wall
  time of the triggering call, active trace id);
- per-program counts of them (`counts`, `total`);
- a `warmup()` scope, entered by `Engine.build_index` and
  `Engine.warmup`, inside which events are expected: they are counted in
  `warmup_compiles` and kept out of the ring. "Zero new programs after
  warmup" then means no build and no unseen launch shape once
  `Engine.warmup` has run.

The recorder is process-global, as the program registry it audits is.
Trace attribution stays per request through a contextvar, which the
batch scheduler re-binds on its dispatcher thread.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from typing import Iterator

from vearch_tpu_torch.ops import perf_model

_active_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "vearch_obs_active_trace", default=None
)


def set_active_trace(trace_id: str | None) -> contextvars.Token:
    """Bind the request's trace id for compile attribution; returns a
    token for :func:`reset_active_trace`."""
    return _active_trace.set(trace_id)


def reset_active_trace(token: contextvars.Token) -> None:
    _active_trace.reset(token)


def current_trace() -> str | None:
    """The calling context's bound trace id, if any — used to carry
    attribution across thread hops (the microbatch dispatcher runs the
    device call on its own thread, where the contextvar is unset)."""
    return _active_trace.get()


class CompileFlightRecorder:
    """Ring buffer + counters for serving-path compile events."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=self.capacity)
        self._counts: dict[str, int] = {}  # program -> post-warmup n
        # (program, shape_sig) pairs already recorded: one compile per
        # specialisation, and a shield against the benign race where
        # two threads watch the same cache-size step
        self._seen: set[tuple[str, str]] = set()
        self._warmup_depth = 0  # int; reads/writes under _lock
        self.warmup_compiles = 0

    @contextlib.contextmanager
    def warmup(self) -> Iterator[None]:
        """Scope for expected compile events: index builds and explicit
        warmup passes. Re-entrant (refcounted)."""
        with self._lock:
            self._warmup_depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._warmup_depth -= 1

    def in_warmup(self) -> bool:
        with self._lock:
            return self._warmup_depth > 0

    def on_compile(
        self, program: str, shape_sig: str, elapsed_ms: float
    ) -> None:
        """Compile observer installed into ``ops.perf_model``."""
        trace_id = _active_trace.get()
        with self._lock:
            if self._warmup_depth > 0:
                self.warmup_compiles += 1
                return
            key = (program, shape_sig)
            if key in self._seen:
                return
            self._seen.add(key)
            self._counts[program] = self._counts.get(program, 0) + 1
            self._events.append({
                # operator-facing stamp for log correlation, not math
                "ts": time.time(),
                "path": program,
                "shapes": shape_sig,
                "elapsed_ms": round(float(elapsed_ms), 3),
                "trace_id": trace_id,
            })

    def events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def reset(self) -> None:
        """Drop recorded state (the program registry is untouched)."""
        with self._lock:
            self._events.clear()
            self._counts.clear()
            self._seen.clear()
            self.warmup_compiles = 0


#: process-global recorder, one per process like the program registry
RECORDER = CompileFlightRecorder()


def install() -> CompileFlightRecorder:
    """Hook the recorder into ops/perf_model's program tracking
    (idempotent)."""
    perf_model.set_compile_observer(RECORDER.on_compile)
    return RECORDER
