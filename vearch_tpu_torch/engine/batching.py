"""Continuous-batching scheduler, the port of vearch_tpu/engine/batching.py:
concurrent searches pack into padded shape buckets and ride shared
device dispatches.

1. **Fetch-k tiers.** The engine raises every request's candidate depth
   to the next declared tier (ops/perf_model.FETCH_K_TIERS) before it
   reaches the index, and trims each caller back to its own k on the
   host. Solo and batched runs therefore scan at the same tier depth, so
   co-batching requests whose k differs within one tier is bit-identical
   to running them alone.
2. **Continuous admission.** Requests land in per-compat-key buckets; a
   bucket dispatches the moment it fills (max_rows) or its age bound
   expires, and the next bucket keeps filling while the previous one is
   in flight: the dispatcher pops one bucket at a time and runs the
   device call outside the lock. With no age bound the dispatcher drains
   whatever is queued the moment it is free, so an idle engine adds no
   latency.

Sorted and score-bounded requests co-batch only on exact k: their result
shaping (bounds window, scalar sort) applies at the group's k, so
trimming a deeper candidate list afterwards would diverge from the solo
run. The compat key encodes that rule. A killed sub-request is dropped
at result-split time; its company still gets answers.

The dispatcher thread calls `Engine._search_direct`, so the kernels
launch from it: `Engine.warmup` builds them first, and their wrappers'
lazy builds and launch counters are safe under several threads.

Accounting and compile attribution cross the thread hop with the
request: `_Pending` captures the caller's trace id
(obs/flight_recorder) and space (obs/accounting) at submit, and
`_run_bucket` charges each pending its `queue_wait_us`, re-binds both
around every `_search_direct` call (solo, grouped, and the per-request
retry of a failed group), charges `device_us` after a solo or retried
run, and after a grouped run splits the group's wall time by row share
(`apportion_device_us`), so the slices sum to it exactly. Discrete
events of a grouped run (dispatches, H2D bytes) bill to the head's
space.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any

import numpy as np

from vearch_tpu_torch.obs import accounting as _acct
from vearch_tpu_torch.obs import flight_recorder as _flightrec
from vearch_tpu_torch.ops import perf_model

if TYPE_CHECKING:  # pragma: no cover
    from vearch_tpu_torch.engine.engine import (
        Engine, SearchRequest, SearchResult,
    )


class _Pending:
    __slots__ = ("req", "rows", "done", "results", "error", "t_enqueue",
                 "trace_id", "space")

    def __init__(self, req: "SearchRequest", rows: int):
        self.req = req
        self.rows = rows
        self.done = threading.Event()
        self.results: "list[SearchResult] | None" = None
        self.error: Exception | None = None
        # stamped at submit, read by _run_bucket for the queue wait
        self.t_enqueue = time.monotonic()
        # the caller's trace id and space, re-bound on the dispatcher
        # thread (contextvars do not cross the hop)
        self.trace_id = _flightrec.current_trace()
        self.space = _acct.current_space()


def _note_queue_wait(p: _Pending, t_dequeue: float) -> None:
    """Record the scheduler queue wait on a traced pending request."""
    from vearch_tpu_torch.engine.engine import mono_us

    if p.req.trace is None:
        return
    wait_ms = max(0.0, (t_dequeue - p.t_enqueue) * 1e3)
    p.req.trace["queue_ms"] = round(wait_ms, 3)
    # copy-on-write: the group trace dict (and its _phase_spans list) is
    # shared by every pending in the group
    spans = list(p.req.trace.get("_phase_spans") or [])
    spans.append(["microbatch.queue", mono_us(p.t_enqueue),
                  int(wait_ms * 1e3)])
    p.req.trace["_phase_spans"] = spans


def _rows_of(req: "SearchRequest") -> int:
    q = np.asarray(next(iter(req.vectors.values())))
    return 1 if q.ndim == 1 else int(q.shape[0])


def _request_fetch_k(req: "SearchRequest") -> int:
    # must mirror Engine._search_direct's candidate-depth formula: the
    # tier this computes is the tier the engine will scan at
    return req.k if len(req.vectors) == 1 else max(req.k * 4, 50)


def _compat_key(req: "SearchRequest", tiered: bool = True) -> str:
    """Bucket identity: requests sharing a key may ride one dispatch.

    With `tiered` (the engine raises fetch-k to the declared tiers),
    plain requests co-batch across differing k within one fetch-k tier.
    Sorted and score-bounded requests keep exact k in the key."""
    mix_k = tiered and not req.sort and not req.score_bounds
    return json.dumps({
        "fields": sorted(req.vectors),
        "k": perf_model.bucket_fetch_k(_request_fetch_k(req))
        if mix_k else req.k,
        # every shape-bearing serving knob (rerank, nprobe, r0/r1, ...)
        "params": req.index_params or {},
        "weights": req.field_weights or {},
        "include": sorted(req.include_fields)
        if req.include_fields is not None else None,
        # the group request is built from the head: bounded and
        # unbounded searches must not share a dispatch
        "bounds": {f: list(b) for f, b in sorted(req.score_bounds.items())}
        if req.score_bounds else None,
        "sort": req.sort or None,
    }, sort_keys=True, default=str)


class _Bucket:
    """One shape bucket being filled: compatible pendings accumulate
    until the bucket seals (capacity) or its age bound expires."""

    __slots__ = ("key", "pendings", "rows", "t_open")

    def __init__(self, key: str):
        self.key = key
        self.pendings: list[_Pending] = []
        self.rows = 0
        self.t_open = time.monotonic()


class BatchScheduler:
    """Continuous-batching scheduler for one engine.

    Callers enqueue and block; a dispatcher thread pops one ready bucket
    at a time and runs the device call outside the scheduler lock.
    `max_delay_ms` == 0 (default) dispatches whatever is ready the moment
    the dispatcher is free; > 0 holds partial buckets up to that age
    waiting for company (counted in `age_timeout_fires`)."""

    def __init__(self, engine: "Engine", max_rows: int = 1024,
                 max_delay_ms: float = 0.0):
        self.engine = engine
        self.max_rows = max_rows
        self.max_delay_ms = float(max_delay_ms)
        self._lock = threading.Lock()
        self._open: dict[str, _Bucket] = {}
        self._sealed: deque[_Bucket] = deque()
        self._wake = threading.Event()
        self._stopped = False
        self.dispatches = 0  # every bucket run, solo or grouped
        self.batches = 0
        self.batched_requests = 0  # requests that shared a dispatch
        self.age_timeout_fires = 0
        self.full_dispatches = 0
        self.dispatch_rows = 0      # real rows across all dispatches
        self.dispatch_capacity = 0  # padded tier rows across dispatches
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="vearch-batch-scheduler")
        self._thread.start()

    # -- caller side ---------------------------------------------------------

    def submit(self, req: "SearchRequest") -> "list[SearchResult]":
        p = _Pending(req, _rows_of(req))
        key = _compat_key(req, tiered=self.engine.shape_buckets)
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine closed")
            b = self._open.get(key)
            if b is not None and b.rows + p.rows > self.max_rows:
                # the arrival would overflow: seal the current bucket
                # and open a fresh one for this request
                self._sealed.append(self._open.pop(key))
            b = self._open.get(key)
            if b is None:
                b = self._open[key] = _Bucket(key)
            b.pendings.append(p)
            b.rows += p.rows
            if b.rows >= self.max_rows:
                self._sealed.append(self._open.pop(key))
        self._wake.set()
        p.done.wait()
        if p.error is not None:
            raise p.error
        assert p.results is not None
        return p.results

    def stop(self) -> None:
        """Drain on close: every waiting caller is errored at once, and
        the dispatcher thread exits."""
        with self._lock:
            self._stopped = True
            pending: list[_Pending] = []
            for b in self._sealed:
                pending.extend(b.pendings)
            for b in self._open.values():
                pending.extend(b.pendings)
            self._sealed.clear()
            self._open.clear()
        for p in pending:
            p.error = RuntimeError("engine closed")
            p.done.set()
        self._wake.set()

    def stats(self) -> dict[str, Any]:
        """Occupancy and dispatch mix."""
        with self._lock:
            open_buckets = len(self._open) + len(self._sealed)
            open_rows = sum(b.rows for b in self._open.values()) + \
                sum(b.rows for b in self._sealed)
        cap = max(self.dispatch_capacity, 1)
        return {
            "dispatches": self.dispatches,
            "batches": self.batches,
            "batched_requests": self.batched_requests,
            "open_buckets": open_buckets,
            "open_rows": open_rows,
            "age_timeout_fires": self.age_timeout_fires,
            "full_dispatches": self.full_dispatches,
            "dispatch_rows": self.dispatch_rows,
            "dispatch_capacity": self.dispatch_capacity,
            "occupancy_pct": round(100.0 * self.dispatch_rows / cap, 2),
        }

    # -- dispatcher ----------------------------------------------------------

    def _pop_ready(self) -> _Bucket | None:
        """Under lock: next bucket to dispatch. Sealed (full) buckets
        first, then the oldest open bucket whose age bound expired, or
        any open bucket when no age bound is set."""
        if self._sealed:
            self.full_dispatches += 1
            return self._sealed.popleft()
        if not self._open:
            return None
        oldest_key = min(self._open, key=lambda k: self._open[k].t_open)
        if self.max_delay_ms <= 0.0:
            return self._open.pop(oldest_key)
        b = self._open[oldest_key]
        if (time.monotonic() - b.t_open) * 1e3 >= self.max_delay_ms:
            self.age_timeout_fires += 1
            return self._open.pop(oldest_key)
        return None

    def _wait_timeout(self) -> float | None:
        """Under lock: how long the dispatcher may sleep: until the
        oldest open bucket's age bound, or until woken when nothing is
        held back."""
        if self._sealed or self.max_delay_ms <= 0.0 or not self._open:
            return None
        t_oldest = min(b.t_open for b in self._open.values())
        remain = self.max_delay_ms / 1e3 - (time.monotonic() - t_oldest)
        return max(remain, 0.0)

    def _loop(self) -> None:
        while True:
            with self._lock:
                timeout = self._wait_timeout()
            self._wake.wait(timeout)
            while True:
                with self._lock:
                    if self._stopped and not self._sealed and not self._open:
                        return
                    self._wake.clear()
                    bucket = self._pop_ready()
                if bucket is None:
                    break
                # device call outside the lock: submits keep packing the
                # next buckets while this one is in flight
                self._run_bucket(bucket)

    def _run_one(self, p: _Pending) -> None:
        """Serve one pending on its own (a solo bucket, or the retry of a
        failed group) under its trace and space, and charge it the run's
        wall time; a killed request gets its abort, not a run."""
        from vearch_tpu_torch.engine.types import RequestKilled

        tok = _flightrec.set_active_trace(p.trace_id)
        stok = _acct.set_space(p.space)
        t_run0 = time.monotonic()
        try:
            if p.req.ctx is not None and p.req.ctx.killed:
                p.error = RequestKilled(p.req.ctx.reason or "request killed")
            else:
                p.results = self.engine._search_direct(p.req)
        except Exception as e:
            p.error = e
        finally:
            _acct.ACCOUNTANT.charge(
                "device_us", int((time.monotonic() - t_run0) * 1e6),
                space=p.space)
            _acct.reset_space(stok)
            _flightrec.reset_active_trace(tok)
            p.done.set()

    def _run_bucket(self, bucket: _Bucket) -> None:
        group = bucket.pendings
        t_dequeue = time.monotonic()
        rows = sum(p.rows for p in group)
        self.dispatches += 1
        self.dispatch_rows += rows
        self.dispatch_capacity += min(
            perf_model.bucket_rows(rows), max(self.max_rows, rows))
        for p in group:
            # a killed request is still charged the wait it sat through
            _acct.ACCOUNTANT.charge(
                "queue_wait_us",
                int(max(0.0, t_dequeue - p.t_enqueue) * 1e6), space=p.space)
        if len(group) == 1:
            _note_queue_wait(group[0], t_dequeue)
            self._run_one(group[0])
            return

        from vearch_tpu_torch.engine.engine import SearchRequest, mono_us
        from vearch_tpu_torch.engine.types import RequestKilled

        self.batches += 1
        self.batched_requests += len(group)
        try:
            t_pack0 = time.monotonic()
            head = group[0].req
            stacked = {
                name: np.concatenate(
                    [np.atleast_2d(np.asarray(p.req.vectors[name]))
                     for p in group], axis=0)
                for name in head.vectors
            }
            k = max(p.req.k for p in group)
            trace: dict[str, Any] | None = (
                {} if any(p.req.trace is not None for p in group) else None)
            big = SearchRequest(
                vectors=stacked, k=k, filters=None,
                include_fields=head.include_fields,
                brute_force=False,
                field_weights=head.field_weights,
                index_params=head.index_params,
                score_bounds=head.score_bounds,
                # sort is part of the compat key: each query row sorts
                # independently, as every solo run would
                sort=head.sort,
                trace=trace,
            )
            t_pack1 = time.monotonic()
            # a shared run has many originators: compile attribution and
            # discrete events go to the head; its wall time is split by
            # row share, so the slices sum to it exactly
            tok = _flightrec.set_active_trace(group[0].trace_id)
            stok = _acct.set_space(group[0].space)
            t_run0 = time.monotonic()
            try:
                results = self.engine._search_direct(big)
            finally:
                _acct.ACCOUNTANT.apportion_device_us(
                    [(p.space, p.rows) for p in group],
                    int((time.monotonic() - t_run0) * 1e6))
                _acct.reset_space(stok)
                _flightrec.reset_active_trace(tok)
            if trace is not None:
                spans = list(trace.get("_phase_spans") or [])
                spans.append(["batch.pack", mono_us(t_pack0),
                              int((t_pack1 - t_pack0) * 1e6)])
                trace["_phase_spans"] = spans
        except Exception:
            # one bad co-batched request (wrong dim, NaNs, ...) must not
            # fail its company: retry each pending alone so only the bad
            # ones error
            for p in group:
                self._run_one(p)
            return
        off = 0
        for p in group:
            sub = results[off: off + p.rows]
            off += p.rows
            if p.req.ctx is not None and p.req.ctx.killed:
                # best-effort kill: the shared dispatch already ran, but
                # the killed caller still gets its abort
                p.error = RequestKilled(p.req.ctx.reason or "request killed")
                p.done.set()
                continue
            if p.req.k < k:
                # the group kept the group's max k at the shared fetch-k
                # tier; each caller's prefix is its solo result
                for r in sub:
                    r.items = r.items[: p.req.k]
            if p.req.trace is not None and trace is not None:
                p.req.trace.update(trace)
                p.req.trace["micro_batch_rows"] = rows
                _note_queue_wait(p, t_dequeue)
            p.results = sub
            p.done.set()
