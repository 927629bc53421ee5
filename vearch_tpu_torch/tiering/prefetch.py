"""Async next-probe prefetch for the tiered storage engine, a copy of
vearch_tpu/tiering/prefetch.py with the port's own logger.

The coarse quantizer tells us which buckets a query touches *before*
the scan dispatch runs, and successive queries in a steady workload
repeat probe sequences. `SequencePredictor` learns a successor map
over probe-set keys; `PrefetchWorker` pages the predicted next probe
set host→device on a background thread while the current scan runs on
the previous probe set. `HbmBucketCache` (index/hbm_cache.py) writes
uploads into its pools in place, but never into a slot a search has
acquired and not yet launched its scan on, so the prefetch never
changes a slab an in-flight scan reads and never changes a shape — it
only moves the H2D cost off the query's critical path.

The worker is deliberately lossy: a bounded queue that drops the
*stale* job when a new one arrives (prefetching the probe set from two
queries ago is pure waste). Prefetch failures are logged and counted,
never propagated — the demand path pays the miss instead.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Hashable

_log = logging.getLogger("vearch_tpu_torch.tiering.prefetch")


class SequencePredictor:
    """First-order successor model over probe-set keys.

    `observe(key)` records that `key` followed the previously observed
    key and returns the learned successor of `key` (the predicted next
    probe set), or None when this key has never been followed yet. The
    map is LRU-capped so an adversarial key stream cannot grow it
    without bound.
    """

    def __init__(self, capacity: int = 512):
        self.capacity = max(int(capacity), 1)
        self._succ: dict[Hashable, Hashable] = {}
        self._order: list[Hashable] = []
        self._prev: Hashable | None = None

    def observe(self, key: Hashable) -> Hashable | None:
        if self._prev is not None and self._prev != key:
            if self._prev not in self._succ:
                self._order.append(self._prev)
                if len(self._order) > self.capacity:
                    evict = self._order.pop(0)
                    self._succ.pop(evict, None)
            self._succ[self._prev] = key
        self._prev = key
        return self._succ.get(key)

    def __len__(self) -> int:
        return len(self._succ)


class PrefetchWorker:
    """Single background thread running `fn(job)` for submitted jobs.

    `submit(job)` enqueues and returns immediately; when the queue is
    full the *oldest* queued job is dropped (counted) in favour of the
    fresh one. `drain()` blocks until all accepted jobs have finished —
    tests use it to make prefetch effects deterministic. The thread is
    started lazily on first submit and torn down by `close()`.
    """

    def __init__(self, fn: Callable[[Any], None], depth: int = 2):
        self._fn = fn
        self._q: queue.Queue[Any] = queue.Queue(maxsize=max(int(depth), 1))
        self._idle = threading.Condition()
        self._pending = 0
        self._thread: threading.Thread | None = None
        self._closed = False
        self.submitted = 0
        self.completed = 0
        self.dropped = 0
        self.errors = 0

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="vearch-tier-prefetch"
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                self._fn(job)
                self.completed += 1
            except Exception:
                self.errors += 1
                _log.warning("prefetch job failed", exc_info=True)
            finally:
                with self._idle:
                    self._pending -= 1
                    self._idle.notify_all()

    def submit(self, job: Any) -> None:
        """Enqueue a prefetch job, dropping the stalest queued one if
        the queue is full. No-op after close()."""
        if job is None or self._closed:
            return
        self._ensure_thread()
        with self._idle:
            self._pending += 1
        self.submitted += 1
        while True:
            try:
                self._q.put_nowait(job)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                    with self._idle:
                        self._pending -= 1
                        self._idle.notify_all()
                except queue.Empty:
                    continue

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every accepted job has completed (or been
        dropped). Returns False on timeout."""
        with self._idle:
            return self._idle.wait_for(
                lambda: self._pending == 0, timeout=timeout
            )

    def close(self) -> None:
        self._closed = True
        t = self._thread
        if t is not None and t.is_alive():
            self._q.put(None)
            t.join(timeout=5.0)
        self._thread = None

    def stats(self) -> dict[str, int]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "dropped": self.dropped,
            "errors": self.errors,
        }
