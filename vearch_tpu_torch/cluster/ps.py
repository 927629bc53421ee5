"""Partition server (data plane): hosts one Engine + RaftNode per partition.

TPU-native re-design of the reference's PS role (reference:
internal/ps/server.go:76 lifecycle + partition registry;
handler_document.go:64 data RPC; handler_admin.go:90 admin RPC;
partition_service.go:154 create/recover). Every write flows through a
per-partition replicated log (cluster/raft.py — the analogue of
raftstore/store_writer.go:77): WAL fsync + quorum ack before the client
ack, follower apply from the log, snapshot catch-up for laggards. A
periodic flush job checkpoints the engine with its applied index and
truncates the log behind it (reference: store_raft_job.go:97,40).

The port's copy of vearch_tpu/cluster/ps.py: the same server over the
port's Engine, with two departures. `PSServer(device=None)` resolves the
device every engine of the server runs on once, at construction (the
card unless the caller asks for the CPU; no GPU and no device raises),
and passes it to each Engine and Engine.open. And a restarting server
refuses /ps/partition/create (503) until it has reopened the partitions
on its disk: the reference serves it from registration on, so the
master's re-add of the returning replica can write an empty engine over
a partition the server is still reopening, whose raft log then counts
as applied (seen on the card, where reopening takes seconds).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tarfile
import threading
import time

import numpy as np
from collections import deque
from typing import Any

from vearch_tpu_torch.engine.engine import Engine, SearchRequest
from vearch_tpu_torch.engine.types import DataType, TableSchema
from vearch_tpu_torch.cluster import rpc
from vearch_tpu_torch.cluster.entities import Partition
from vearch_tpu_torch.cluster.metrics import (
    SIZE_BUCKETS,
    internal_error,
    register_tracer_metrics,
)
from vearch_tpu_torch.cluster.raft import RaftNode
from vearch_tpu_torch.obs import accounting
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.cluster.rpc import (
    ERR_REQUEST_KILLED,
    JsonRpcServer,
    RpcError,
)
from vearch_tpu_torch.tools import lockcheck
from vearch_tpu_torch.utils import log

_log = log.get("ps")

# log entries retained behind the flushed/applied horizon so a briefly
# lagging follower catches up by replay instead of full snapshot
# (reference: raft_truncate_count)
WAL_KEEP_ENTRIES = 10_000

# split copy batch size: bounds both the per-forward RPC payload and
# how long the mirror queue waits between drain opportunities
SPLIT_COPY_BATCH = 256


class _SplitAborted(Exception):
    """Internal control flow for the split worker: the job must end in
    status=error (master garbage-collects the children and may retry)."""


def _profile_from_timing(timing: dict) -> dict:
    """Shape the engine's flat trace dict into the structured
    profile=true breakdown one partition contributes (the
    Elasticsearch-profile / EXPLAIN analogue; schema documented in
    docs/OBSERVABILITY.md). Phase keys lose their `_ms` suffix; per-
    dispatch timings and the perf-model prediction are grouped under
    `dispatches` so measured-vs-documented drift reads off directly."""
    phases = {
        k[: -len("_ms")]: v for k, v in timing.items()
        if k.endswith("_ms") and not k.startswith("dispatch_")
        and k != "stream_ms"
    }
    per_dispatch = {
        k[len("dispatch_"): -len("_ms")]: v for k, v in timing.items()
        if k.startswith("dispatch_") and k.endswith("_ms")
    }
    out: dict = {
        "phases": phases,
        "dispatches": {
            "tags": timing.get("dispatches", []),
            "count": timing.get("dispatch_count", 0),
            "path": timing.get("perf_path"),
            "predicted": timing.get("predicted_dispatches"),
            "predicted_scan_bytes": timing.get("predicted_scan_bytes"),
            "per_dispatch_ms": per_dispatch,
        },
    }
    if "doc_count" in timing:
        out["doc_count"] = timing["doc_count"]
    if "micro_batch_rows" in timing:
        out["micro_batch_rows"] = timing["micro_batch_rows"]
    if "mesh" in timing:
        out["mesh"] = timing["mesh"]
    if "stream_ms" in timing:
        out["stream_ms"] = timing["stream_ms"]
    return out


def _write_profile_from_timing(timing: dict) -> dict:
    """Write-side profile=true breakdown: the raft proposal's phase
    windows (propose-wait / wal append+fsync / commit-wait / apply),
    shaped like the search profile so the router merges both the same
    way (schema in docs/OBSERVABILITY.md)."""
    out: dict = {
        "phases": {
            k[: -len("_ms")]: v for k, v in timing.items()
            if k.endswith("_ms")
        },
    }
    for k in ("doc_count", "entries"):
        if k in timing:
            out[k] = timing[k]
    return out


@lockcheck.guarded
class PSServer:
    # lock discipline (lint VL201 + runtime lockcheck): the partition
    # registries mutate under _lock; the in-flight request registry and
    # its kill counter under _inflight_lock; async backup jobs under
    # _backup_jobs_lock; the small hot-path caches/counters under a
    # dedicated _stats_lock so stats updates never contend with
    # partition registry operations.
    _guarded_by = {
        "engines": "_lock",
        "partitions": "_lock",
        "raft_nodes": "_lock",
        "_flushed": "_lock",
        "_flush_locks": "_lock",
        "_inflight": "_inflight_lock",
        "killed_requests": "_inflight_lock",
        "_backup_jobs": "_backup_jobs_lock",
        "_peer_cache": "_stats_lock",
        "_mem_cache": "_stats_lock",
        "_mem_dirty": "_stats_lock",
        "replication_errors": "_stats_lock",
        "slow_routed": "_stats_lock",
        "_search_ewma": "_stats_lock",
        "_op_counts": "_stats_lock",
        "_op_inflight": "_stats_lock",
        "_op_waiting": "_stats_lock",
        "_split_jobs": "_split_lock",
    }

    def __init__(
        self,
        data_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        master_addr: str | None = None,
        heartbeat_interval: float = 2.0,
        max_concurrent_searches: int = 256,
        memory_limit_mb: int = 0,
        master_auth: tuple[str, str] | None = None,
        backup_roots: list[str] | None = None,
        backup_endpoints: list[str] | None = None,
        flush_interval: float = 5.0,
        raft_tick: float = 0.4,
        labels: dict[str, str] | None = None,
        trace_collector: str | None = None,
        search_cache_entries: int = 256,
        device_sample_interval: float = 5.0,
        hbm_drift_tolerance: float = 0.5,
        hbm_drift_slack_mb: int = 64,
        admission_queue_limit: int = 0,
        device=None,
    ):
        from vearch_tpu_torch.device import resolve_device

        # every engine of this server runs here: the card unless the
        # caller asks for the CPU; resolved now, so a PS on a box with no
        # GPU raises at start, not at its first create_partition
        self.device = resolve_device(device)
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.engines: dict[int, Engine] = {}
        self.partitions: dict[int, Partition] = {}
        self.raft_nodes: dict[int, RaftNode] = {}
        self._flushed: dict[int, int] = {}  # pid -> applied idx at last flush
        # one checkpoint at a time per partition: concurrent flushes
        # (flush loop + /ps/flush + snapshot sends) would interleave
        # writes to the same snapshot files
        self._flush_locks: dict[int, Any] = {}
        self._lock = lockcheck.make_lock("ps._lock")
        self.master_addr = master_addr
        # service credentials for master calls when the cluster runs with
        # auth (replication metadata reads would otherwise 401 silently)
        self.master_auth = master_auth
        self.node_id: int | None = None
        self.heartbeat_interval = heartbeat_interval
        self.flush_interval = flush_interval
        self.raft_tick = raft_tick
        self._stop = threading.Event()
        # set once start() has reopened the partitions on disk
        self._recovered = threading.Event()
        # concurrency gate (reference: RequestConcurrentController,
        # search/engine.h:197; rpcx request concurrency, ps/server.go:89)
        self._search_gate = threading.BoundedSemaphore(max_concurrent_searches)
        self.max_concurrent_searches = max_concurrent_searches
        # 0 = unlimited (reference: resource-limit write guard,
        # store_writer.go:82-95 -> partition flips read-only)
        self.memory_limit_mb = memory_limit_mb
        # operator allowlist for backup/restore store roots: when set,
        # /ps/backup and /ps/restore refuse store_root paths outside it
        # (anyone reaching the PS port could otherwise read/write
        # arbitrary filesystem paths through the object store)
        self.backup_roots = (
            [os.path.abspath(r) for r in backup_roots] if backup_roots
            else None
        )
        # s3 counterpart of backup_roots: allowed endpoint hosts. When
        # EITHER allowlist is configured, the other destination type is
        # default-denied — a confined operator setup must not be
        # escapable by just switching store types (exfiltration/SSRF)
        self.backup_endpoints = backup_endpoints
        # small hot-path counters/caches (guard map above) — their own
        # lock so stats writes never queue behind registry operations
        self._stats_lock = lockcheck.make_lock("ps._stats_lock")
        self.replication_errors = 0  # surfaced in /ps/stats
        # topology labels (host/rack/zone) for placement anti-affinity
        self.labels = dict(labels or {})
        self._peer_cache: tuple[float, dict[int, str]] = (0.0, {})
        # in-flight request registry (reference: handler_document.go:96
        # Rqueue registration for kill + ps/schedule_job.go:252 slow-
        # request killer). 0 disables the automatic killer.
        self._inflight: dict[str, dict] = {}
        self._inflight_lock = lockcheck.make_lock("ps._inflight_lock")
        # async shard-backup jobs (reference: PSShardManager state)
        self._backup_jobs: dict[str, dict] = {}
        self._backup_jobs_lock = lockcheck.make_lock(
            "ps._backup_jobs_lock")
        # online partition-split jobs (elastic data plane): pid -> job
        # dict owned by one named worker thread; write handlers enqueue
        # mirror entries under the same lock so the lock never nests
        # with the partition registry's
        self._split_jobs: dict[int, dict] = {}
        self._split_lock = lockcheck.make_lock("ps._split_lock")
        self._split_cv = threading.Condition(self._split_lock)
        # per-partition cumulative search/write counters riding the
        # heartbeat — the master's rebalance planner scores hotness
        # from the deltas
        self._op_counts: dict[int, dict[str, int]] = {}
        # admission observability for ROADMAP item 5: requests waiting
        # on a gate vs executing, per op. Both render as gauges from
        # the first scrape (fixed op label set) — cardinality-soak safe.
        self._op_waiting: dict[str, int] = {"search": 0, "write": 0}
        self._op_inflight: dict[str, int] = {"search": 0, "write": 0}
        self.slow_request_ms = 0
        self.killed_requests = 0
        # per-request deadline default (ms); a search may override via
        # its own deadline_ms option. 0 disables. Arms RequestContext so
        # expiry aborts between dispatches (reference: the timeout the
        # reference's rpcx layer enforces per handler).
        self.request_deadline_ms = 0
        # cached cross-engine memory accounting: _h_upsert used to
        # re-sum memory_usage_bytes() over every engine per request —
        # O(partitions) host walks on the hot write path. Applies mark
        # the cache dirty; a dirty read refreshes at most every
        # _mem_min_interval seconds, a clean one every _mem_max_age.
        self._mem_cache: tuple[float, int] = (0.0, 0)
        self._mem_dirty = True
        self._mem_min_interval = 0.02
        self._mem_max_age = 5.0
        # slow-query isolation (reference: dedicated slow-search channel
        # pool, ps/server.go:95 + engine slow_search_time marking): each
        # partition keeps an EWMA of its search latency; partitions
        # whose history exceeds slow_route_ms are routed through a
        # small separate semaphore so a hot/expensive space cannot
        # occupy every fast-path slot. 0 disables routing.
        self.slow_route_ms = 0
        self._slow_gate = threading.BoundedSemaphore(
            max(1, max_concurrent_searches // 4)
        )
        self._search_ewma: dict[int, float] = {}  # pid -> ms
        self.slow_routed = 0
        # admission control (tail-latency tentpole): bounded wait queue
        # in front of the search gates — when more than
        # admission_queue_limit requests are already waiting, new
        # arrivals shed with 429 + Retry-After instead of queueing past
        # the point anyone will wait. 0 disables (default). Runtime-
        # tunable via /ps/engine/config {"admission_queue_limit": n}.
        from vearch_tpu_torch.cluster.admission import AdmissionController

        self._admission = AdmissionController(admission_queue_limit)
        # fault injection for tail-latency tests/bench: every search
        # sleeps this long (killable, in deadline-check chunks) before
        # touching the engine. Set via /ps/engine/config.
        self.debug_search_delay_ms = 0
        # PS-tier result cache + coalescing (perf tentpole: the
        # cheapest dispatch is the one never issued). Keys embed
        # (partition, canonical query, raft apply index, engine data
        # version), so any applied write makes every prior entry for
        # that partition unreachable — exact invalidation without a
        # flush pass; superseded keys simply age out of the LRU.
        # SingleFlight collapses N concurrent identical searches into
        # one engine dispatch set. Runtime-tunable via /ps/engine/
        # config {"search_cache_entries": n}; 0 disables.
        from vearch_tpu_torch.cluster.querycache import (
            SingleFlight, VersionedLRUCache,
        )

        self.search_cache = VersionedLRUCache(
            max_entries=search_cache_entries)
        self._search_flight = SingleFlight()

        from vearch_tpu_torch.cluster.tracing import NULL_SPAN, SlowLog, Tracer

        # spans join the router's trace via the _trace_ctx envelope
        # (reference: PS extracts span context from rpcx metadata,
        # ps/handler_document.go:123-126)
        self.tracer = Tracer("ps", collector_endpoint=trace_collector)
        # slow/killed request ring at GET /debug/slowlog; threshold via
        # /ps/engine/config {"slow_log_ms": ...}
        self.slowlog = SlowLog()

        # runtime truth layer (obs tentpole): compile-audit flight
        # recorder (process-global, like the jit cache it watches),
        # per-(partition, op) latency quantile sketches, and the
        # device-runtime sampler measuring live HBM against the
        # footprint model
        from vearch_tpu_torch.obs import flight_recorder as _flightrec
        from vearch_tpu_torch.obs.quantiles import QuantileRegistry, _qlabel
        from vearch_tpu_torch.obs.sampler import DeviceSampler

        self.flight_recorder = _flightrec.install()
        self.latency_quantiles = QuantileRegistry(name="ps.quantiles")
        self.device_sampler = DeviceSampler(
            self._model_device_bytes,
            interval_s=device_sample_interval,
            drift_tolerance=hbm_drift_tolerance,
            drift_slack_bytes=int(hbm_drift_slack_mb) << 20,
        )
        # search-quality truth layer (docs/QUALITY.md): shadow exact-
        # rerank recall sampling + index-health drift gauges. Per-node,
        # not process-global — in-process multi-node tests host the
        # same partition id on several PSServers.
        from vearch_tpu_torch.obs.quality import QualityMonitor

        self._quality = QualityMonitor(
            get_engines=lambda: self.engines,
            pid_space=self._space_key,
            admission=self._admission,
        )

        self.server = JsonRpcServer(host, port)
        self.server.tracer = self.tracer
        s = self.server
        s.route("POST", "/ps/partition/create", self._h_create_partition)
        s.route("POST", "/ps/partition/delete", self._h_delete_partition)
        s.route("POST", "/ps/doc/upsert", self._h_upsert)
        s.route("POST", "/ps/doc/delete", self._h_delete)
        s.route("POST", "/ps/doc/get", self._h_get)
        s.route("POST", "/ps/doc/search", self._h_search)
        s.route("POST", "/ps/doc/query", self._h_query)
        s.route("POST", "/ps/index/build", self._h_build)
        s.route("POST", "/ps/field_index", self._h_field_index)
        s.route("POST", "/ps/schema/field", self._h_schema_field)
        s.route("POST", "/ps/index/rebuild", self._h_rebuild)
        s.route("POST", "/ps/flush", self._h_flush)
        s.route("POST", "/ps/engine/config", self._h_engine_config)
        s.route("POST", "/ps/backup", self._h_backup)
        s.route("GET", "/ps/backup/progress", self._h_backup_progress)
        s.route("POST", "/ps/restore", self._h_restore)
        s.route("GET", "/ps/stats", self._h_stats)
        s.route("POST", "/ps/kill", self._h_kill)
        s.route("GET", "/ps/requests", self._h_requests)
        s.route("GET", "/ps/jobs", self._h_jobs)
        s.route("GET", "/debug/slowlog", self._h_slowlog)
        # compile-audit flight recorder: post-warmup serving compiles
        s.route("GET", "/debug/compiles", self._h_compiles)
        s.route("POST", "/debug/compiles/reset", self._h_compiles_reset)
        # online partition split (elastic data plane): the master drives
        # start -> poll progress -> finish(commit|abort) on the parent's
        # leader; the double-write mirror lives here
        s.route("POST", "/ps/partition/split/start", self._h_split_start)
        s.route("GET", "/ps/partition/split/progress",
                self._h_split_progress)
        s.route("POST", "/ps/partition/split/finish", self._h_split_finish)
        # raft transport (reference: raftstore/server.go heartbeat +
        # replicate ports; here routes on the one RPC server)
        s.route("POST", "/ps/raft/append", self._h_raft_append)
        s.route("POST", "/ps/raft/fence", self._h_raft_fence)
        s.route("POST", "/ps/raft/lead", self._h_raft_lead)
        s.route("POST", "/ps/raft/members", self._h_raft_members)
        s.route("POST", "/ps/raft/snapshot", self._h_raft_snapshot)
        s.route("GET", "/ps/raft/state", self._h_raft_state)

        # per-partition gauges on this node's /metrics (reference:
        # monitor_service.go partition gauges; VERDICT r2 missing #2)
        def _gauges(field: str):
            def fn():
                return {
                    (str(pid),): float(st[field])
                    for pid, st in self._partition_stats().items()
                }
            return fn

        m = s.metrics
        m.callback_gauge("vearch_ps_partition_docs",
                         "docs per partition on this node",
                         ("partition",), _gauges("doc_count"))
        m.callback_gauge("vearch_ps_partition_size_bytes",
                         "engine memory per partition on this node",
                         ("partition",), _gauges("size_bytes"))
        m.callback_gauge("vearch_ps_partition_status",
                         "engine index status per partition",
                         ("partition",), _gauges("status"))
        m.callback_gauge("vearch_ps_partition_leader",
                         "1 when this node leads the partition",
                         ("partition",), _gauges("leader"))
        m.callback_gauge("vearch_ps_partitions",
                         "partitions hosted on this node", (),
                         lambda: {(): float(len(self.engines))})
        m.callback_gauge("vearch_ps_memory_used_bytes",
                         "engine memory across all partitions "
                         "(cached accounting, feeds the write limit)",
                         (),
                         lambda: {(): float(self.memory_used_bytes())})

        def _mesh_devices():
            # devices the mesh data plane spans, per partition; 0 when
            # the partition serves single-device (mesh_serving off, one
            # visible device, or a disk-store field)
            out = {}
            for pid, eng in list(self.engines.items()):
                try:
                    info = eng.mesh_info()
                except Exception:
                    info = None
                out[(str(pid),)] = float(
                    (info or {}).get("devices", 0)
                )
            return out

        m.callback_gauge("vearch_engine_mesh_devices",
                         "devices the mesh serving data plane spans "
                         "per partition (0 = single-device path)",
                         ("partition",), _mesh_devices)

        # write path (tentpole: ingest observability symmetric with the
        # read path) — throughput counters per partition, kill counters
        # by reason, WAL durability histograms fed by the Wal observer
        self._write_docs_total = m.counter(
            "vearch_ps_write_docs_total",
            "documents written per partition (op: upsert/delete)",
            ("partition", "op"))
        self._killed_total = m.counter(
            "vearch_requests_killed_total",
            "in-flight requests aborted, by reason "
            "(deadline/slow/operator) and tenant space",
            ("reason", "space"))
        self._shed_total = m.counter(
            "vearch_ps_admission_shed_total",
            "requests shed (429) by admission control before any "
            "device work, per op and tenant space",
            ("op", "space"))
        # render from 1st scrape; no tenant has been admitted yet
        self._shed_total.inc(  # lint: allow[space-attr] zero-fill render
            "search", accounting.OTHER_LABEL, by=0.0)

        # -- per-tenant cost accounting (docs/ACCOUNTING.md) -----------
        # The process-global accountant hooks the dispatch + H2D
        # ledgers; these callback metrics render its meters under the
        # fixed top-K + "other" label policy, so series stay bounded no
        # matter how many spaces this node hosts. Exact per-space
        # numbers ride /ps/stats and the heartbeat usage block.
        self._accountant = accounting.install()

        def _usage(meter: str, scale: float = 1.0):
            return lambda: self._accountant.labelled(meter, scale)

        m.callback_counter("vearch_space_requests_total",
                           "search RPCs billed per space (won hedges "
                           "bill once)", ("space",), _usage("requests"))
        m.callback_counter("vearch_space_dispatches_total",
                           "device dispatches attributed per space "
                           "(reconciles with the dispatch ledger)",
                           ("space",), _usage("dispatches"))
        m.callback_counter("vearch_space_h2d_bytes_total",
                           "host->device bytes attributed per space "
                           "(reconciles with vearch_ps_h2d_bytes_total)",
                           ("space",), _usage("h2d_bytes"))
        m.callback_counter("vearch_space_device_ms_total",
                           "engine device wall-time per space, ms "
                           "(co-batched buckets split by row share)",
                           ("space",), _usage("device_us", 1e-3))
        m.callback_counter("vearch_space_queue_wait_ms_total",
                           "admission-gate + scheduler queue wait per "
                           "space, ms", ("space",),
                           _usage("queue_wait_us", 1e-3))
        m.callback_counter("vearch_space_cache_hits_total",
                           "result-cache hits per space (zero device "
                           "cost)", ("space",), _usage("cache_hits"))
        m.callback_gauge("vearch_space_hbm_bytes",
                         "modelled device-memory residency per space "
                         "on this node", ("space",),
                         self._space_hbm_labelled)
        self._wal_fsync_hist = m.histogram(
            "vearch_wal_fsync_latency_seconds",
            "WAL fsync wall time per append batch",
            ("partition",))
        self._wal_batch_hist = m.histogram(
            "vearch_wal_append_batch_entries",
            "log entries per WAL append batch",
            ("partition",), buckets=SIZE_BUCKETS)

        # index-build jobs (tentpole: background-job telemetry)
        self._build_hist = m.histogram(
            "vearch_index_build_duration_seconds",
            "index build wall time (op: build/rebuild)",
            ("partition", "op"),
            buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))

        def _build_progress():
            # one series per hosted partition regardless of job state:
            # 0.0 before any build, fraction while running, 1.0 done —
            # a mid-soak build must not mint a new series
            out = {}
            for pid, eng in list(self.engines.items()):
                job = getattr(eng, "build_job", None)
                if job is None:
                    out[(str(pid),)] = 0.0
                else:
                    total = max(int(job.get("docs_total") or 0), 1)
                    frac = float(job.get("docs_done", 0)) / total
                    if job.get("status") in ("done", "error"):
                        frac = 1.0
                    out[(str(pid),)] = min(frac, 1.0)
            return out

        m.callback_gauge("vearch_index_build_progress",
                         "docs processed / total for the current or "
                         "last index build",
                         ("partition",), _build_progress)

        # split-job progress gauges: one series per hosted partition
        # with 0.0 when idle (same cardinality discipline as the build
        # gauge — a split starting mid-soak must not mint a new series)
        def _split_progress():
            with self._split_lock:
                jobs = {pid: (job.get("docs_done", 0),
                              job.get("docs_total", 0),
                              job.get("status"))
                        for pid, job in self._split_jobs.items()}
            out = {}
            for pid in list(self.engines):
                done, total, status = jobs.get(pid, (0, 0, None))
                if status in ("done", "error"):
                    out[(str(pid),)] = 1.0
                else:
                    out[(str(pid),)] = min(
                        float(done) / max(int(total or 0), 1), 1.0)
            return out

        def _split_queue():
            with self._split_lock:
                depth = {pid: len(job["_queue"])
                         for pid, job in self._split_jobs.items()
                         if job.get("status") == "running"}
            return {(str(pid),): float(depth.get(pid, 0))
                    for pid in list(self.engines)}

        m.callback_gauge("vearch_ps_split_progress",
                         "copied docs / total for the current or last "
                         "partition split on this node",
                         ("partition",), _split_progress)
        m.callback_gauge("vearch_ps_split_mirror_queue",
                         "pending double-write mirror entries for the "
                         "active partition split",
                         ("partition",), _split_queue)

        # -- search-quality truth layer (docs/QUALITY.md) --------------
        # Recall/RBO render under the accountant's top-K + "other" space
        # label policy and the fixed RECALL_K_TIERS depth grid; health
        # gauges are one series per hosted partition with 0.0 until the
        # first health pass — the cardinality soak must see no series
        # growth as sampling warms up mid-soak. Exact per-space numbers
        # ride /ps/stats; these series exist for alerting.
        from vearch_tpu_torch.ops.perf_model import RECALL_K_TIERS

        def _quality_space_labels() -> set[str]:
            labels = {
                self._accountant.label(self._space_key(pid))
                for pid in list(self.engines)
            }
            labels.add(accounting.OTHER_LABEL)
            return labels

        def _recall_gauge():
            snap = self._quality.recall_snapshot()["spaces"]
            out = {(str(kt), lbl): 0.0
                   for kt in RECALL_K_TIERS
                   for lbl in _quality_space_labels()}
            for space, sp in snap.items():
                lbl = self._accountant.label(space)
                for kt, rec in (sp.get("recall") or {}).items():
                    if rec.get("estimate") is not None:
                        out[(str(kt), lbl)] = float(rec["estimate"])
            return out

        def _rbo_gauge():
            snap = self._quality.recall_snapshot()["spaces"]
            out = {(lbl,): 0.0 for lbl in _quality_space_labels()}
            for space, sp in snap.items():
                if sp.get("rbo") is not None:
                    out[(self._accountant.label(space),)] = float(sp["rbo"])
            return out

        def _breach_gauge():
            hit = {self._accountant.label(s)
                   for s in self._quality.breach_spaces()}
            return {(lbl,): (1.0 if lbl in hit else 0.0)
                    for lbl in _quality_space_labels()}

        m.callback_gauge("vearch_ps_search_recall",
                         "shadow-sampled recall@k vs the exact FLAT "
                         "path, decayed estimate (0 until sampled)",
                         ("k", "space"), _recall_gauge)
        m.callback_gauge("vearch_ps_search_rbo",
                         "rank-biased overlap of served vs exact "
                         "ordering, decayed (0 until sampled)",
                         ("space",), _rbo_gauge)
        m.callback_gauge("vearch_ps_search_recall_floor_breach",
                         "1 while the Wilson-upper recall bound sits "
                         "under the space's recall floor",
                         ("space",), _breach_gauge)
        m.callback_counter("vearch_ps_quality_shadow_total",
                           "shadow recall-sampling pipeline events "
                           "(sampled/executed/shed/stale/dropped/error)",
                           ("event",),
                           lambda: {(e,): float(n) for e, n in
                                    self._quality.counters().items()})

        # progressive-refinement serving: fixed label topology straight
        # from the ops-layer counters (ops/binary_scan.py), zero-filled
        # from first scrape — path/stage sets are module constants, so
        # the series count is flat regardless of traffic
        from vearch_tpu_torch.ops import binary_scan as _binary_scan

        m.callback_counter("vearch_ps_refine_searches_total",
                           "three-stage (binary->int8->exact) searches "
                           "served, by serving path",
                           ("path",),
                           lambda: {(p,): float(n) for p, n in
                                    _binary_scan.refine_search_counts()
                                    .items()})
        m.callback_counter("vearch_ps_refine_stage_rows_total",
                           "candidate rows scored per refinement stage "
                           "(binary=full scan, int8=r0, exact=r1)",
                           ("stage",),
                           lambda: {(s,): float(n) for s, n in
                                    _binary_scan.refine_stage_rows()
                                    .items()})

        def _health_gauge(metric: str, field_level: bool):
            def read():
                h = self._quality.health_snapshot()
                out = {}
                for pid in list(self.engines):
                    info = h.get(pid) or {}
                    if not field_level:
                        out[(str(pid),)] = float(info.get(metric) or 0.0)
                        continue
                    vals = [f[metric]
                            for f in (info.get("fields") or {}).values()
                            if f.get(metric) is not None]
                    # worst field per partition: the gauge answers "does
                    # this partition need attention", not "which field"
                    out[(str(pid),)] = float(max(vals)) if vals else 0.0
                return out
            return read

        m.callback_gauge("vearch_ps_index_health_recon_error",
                         "quantization reconstruction error, worst "
                         "vector field (relative L2)", ("partition",),
                         _health_gauge("recon_error", True))
        m.callback_gauge("vearch_ps_index_health_cell_imbalance",
                         "IVF cell-population coefficient of variation, "
                         "worst vector field", ("partition",),
                         _health_gauge("cell_imbalance_cv", True))
        m.callback_gauge("vearch_ps_index_health_deleted_frac",
                         "deleted-doc fraction of the partition",
                         ("partition",),
                         _health_gauge("deleted_frac", False))
        m.callback_gauge("vearch_ps_index_health_unindexed_frac",
                         "tail appends not yet absorbed into the ANN "
                         "index, worst vector field", ("partition",),
                         _health_gauge("unindexed_frac", True))

        def _retrain_gauge():
            h = self._quality.health_snapshot()
            return {
                (str(pid),): (
                    1.0 if (h.get(pid) or {}).get("needs_retrain")
                    else 0.0)
                for pid in list(self.engines)
            }

        m.callback_gauge("vearch_ps_index_health_needs_retrain",
                         "1 when drift gauges say the partition should "
                         "retrain (reasons in /ps/stats quality block)",
                         ("partition",), _retrain_gauge)

        # raft replication observability (tentpole: VERDICT weak #2 was
        # undiagnosable because raft exposed no lag/latency/election
        # series). Histograms are fed by the per-node observer hook
        # (_raft_observer); everything else is sampled from node state
        # at scrape time, so idle partitions cost nothing.
        self._raft_commit_hist = m.histogram(
            "vearch_raft_commit_latency_seconds",
            "append -> quorum-commit wall time per proposal",
            ("partition",))
        self._raft_apply_hist = m.histogram(
            "vearch_raft_apply_latency_seconds",
            "state-machine apply wall time per log entry",
            ("partition",))

        def _per_node(fn):
            def read():
                return {
                    (str(pid),): float(fn(node))
                    for pid, node in list(self.raft_nodes.items())
                }
            return read

        def _per_peer(field: str):
            def read():
                out = {}
                for pid, node in list(self.raft_nodes.items()):
                    for peer, info in node.state()["peers"].items():
                        out[(str(pid), peer)] = float(info[field])
                return out
            return read

        m.callback_gauge("vearch_raft_peer_lag",
                         "entries this peer trails the leader log end",
                         ("partition", "peer"), _per_peer("lag"))
        m.callback_gauge("vearch_raft_peer_next_index",
                         "leader next_index per peer",
                         ("partition", "peer"), _per_peer("next"))
        m.callback_gauge("vearch_raft_peer_ack_age_seconds",
                         "seconds since this peer acked an append",
                         ("partition", "peer"), _per_peer("ack_age"))
        m.callback_gauge("vearch_raft_commit_index",
                         "raft commit index", ("partition",),
                         _per_node(lambda n: n.commit))
        m.callback_gauge("vearch_raft_applied_index",
                         "raft applied index", ("partition",),
                         _per_node(lambda n: n.applied))
        m.callback_gauge("vearch_raft_apply_lag",
                         "committed-but-unapplied entries "
                         "(commit - applied)", ("partition",),
                         _per_node(
                             lambda n: max(n.commit - n.applied, 0)))
        m.callback_gauge("vearch_raft_term",
                         "raft term", ("partition",),
                         _per_node(lambda n: n.term))
        m.callback_gauge("vearch_raft_is_leader",
                         "1 when this node leads the raft group",
                         ("partition",),
                         _per_node(lambda n: 1.0 if n.is_leader else 0.0))
        m.callback_gauge("vearch_raft_heartbeat_age_seconds",
                         "seconds since replication liveness was proven "
                         "(leader: oldest peer ack; follower: leader "
                         "contact)", ("partition",),
                         _per_node(lambda n: n.heartbeat_age()))

        def _elections():
            out = {}
            for pid, node in list(self.raft_nodes.items()):
                out[(str(pid), "started")] = float(node.elections_started)
                out[(str(pid), "won")] = float(node.elections_won)
            return out

        def _snapshots():
            out = {}
            for pid, node in list(self.raft_nodes.items()):
                out[(str(pid), "sent")] = float(node.snapshots_sent)
                out[(str(pid), "installed")] = float(
                    node.snapshots_installed)
            return out

        m.callback_counter("vearch_raft_elections_total",
                           "raft elections by outcome",
                           ("partition", "event"), _elections)
        m.callback_counter("vearch_raft_snapshots_total",
                           "raft snapshots by direction",
                           ("partition", "direction"), _snapshots)

        # serving-cache observability (caching tentpole). Callback
        # metrics read the cache's pre-initialized stats dict, so the
        # full event label set exists from the first scrape — a cache
        # warming up mid-soak must not mint new series.
        def _search_cache_events():
            return {(e,): float(v)
                    for e, v in self.search_cache.stats.items()}

        m.callback_counter("vearch_ps_search_cache_events_total",
                           "partition result-cache events "
                           "(hit/miss/coalesced/bypass/eviction/"
                           "invalidated)",
                           ("event",), _search_cache_events)
        m.callback_gauge("vearch_ps_search_cache_entries",
                         "live entries in the partition result cache",
                         (),
                         lambda: {(): float(len(self.search_cache))})

        def _filter_cache_events():
            hits = misses = 0
            for eng in list(self.engines.values()):
                hits += getattr(eng, "filter_cache_hits", 0)
                misses += getattr(eng, "filter_cache_misses", 0)
            return {("hit",): float(hits), ("miss",): float(misses)}

        m.callback_counter("vearch_ps_filter_cache_events_total",
                           "scalar-filter bitmap cache events summed "
                           "across hosted engines",
                           ("event",), _filter_cache_events)

        # tiered storage observability (tiering tentpole): both
        # callbacks render the FULL fixed (tier, event) label set from
        # the first scrape, zero-filled — an engine whose disk tier
        # warms up mid-soak must not mint new series.
        m.callback_counter("vearch_ps_tier_events_total",
                           "tiered-storage events summed across hosted "
                           "engines: HBM slab cache "
                           "(hit/miss/eviction/pin_hit/prefetch_hit/"
                           "prefetched), host-RAM slab tier and rerank "
                           "row cache (hit/miss/eviction/admitted/"
                           "rejected), prefetch worker "
                           "(submitted/completed/dropped/error)",
                           ("tier", "event"),
                           lambda: self._tier_snapshot()[0])
        m.callback_gauge("vearch_ps_tier_resident_bytes",
                         "resident bytes per storage tier summed "
                         "across hosted engines",
                         ("tier",),
                         lambda: self._tier_snapshot()[1])

        # runtime truth layer (obs tentpole). Device labels are bounded
        # by the local device count, op/q labels by fixed tuples — all
        # rendered from the first scrape, so the cardinality soak sees
        # zero growth. The compile counter only mints a series when a
        # post-warmup compile actually happens, which is precisely the
        # regression it exists to expose.
        def _device_bytes():
            snap = self.device_sampler.snapshot()
            return {(lbl,): float(b)
                    for lbl, b in snap["devices"].items()}

        m.callback_gauge("vearch_ps_device_hbm_live_bytes",
                         "live device buffer bytes per local device, "
                         "as sampled from the JAX runtime",
                         ("device",), _device_bytes)
        m.callback_counter("vearch_ps_h2d_bytes_total",
                           "host->device transfer bytes accumulated by "
                           "the absorb/upload paths (process-wide)",
                           (),
                           lambda: {(): float(perf_model.h2d_bytes_total())})
        m.callback_gauge("vearch_ps_compiled_programs",
                         "live jit-cache entries across registered "
                         "serving programs",
                         (),
                         lambda: {(): float(
                             perf_model.total_compiled_programs())})
        m.callback_gauge("vearch_ps_hbm_model_drift_bytes",
                         "measured live device bytes in excess of the "
                         "footprint model + start baseline (worst "
                         "device)",
                         (),
                         lambda: {(): float(
                             self.device_sampler.snapshot()["drift_bytes"])})
        m.callback_gauge("vearch_ps_hbm_model_drift",
                         "1 when measured HBM exceeds the footprint "
                         "model beyond tolerance (degrades "
                         "/cluster/health)",
                         (),
                         lambda: {(): float(
                             1.0 if self.device_sampler.snapshot()["drift"]
                             else 0.0)})
        m.callback_counter("vearch_serving_compiles_total",
                           "post-warmup XLA compilations on serving "
                           "paths, by registered program",
                           ("path",),
                           lambda: {(p,): float(n) for p, n in
                                    self.flight_recorder.counts().items()})

        def _latency_quantiles():
            snap = self.latency_quantiles.snapshot()
            out = {}
            for op in ("search", "write"):
                node_q = (snap.get(("_node", op)) or {}).get("q", {})
                for q in self.latency_quantiles.quantiles:
                    lbl = _qlabel(q)
                    out[(op, lbl)] = float(node_q.get(lbl, 0.0))
            return out

        m.callback_gauge("vearch_ps_latency_quantile",
                         "streaming latency quantiles (ms) per op, "
                         "node-level P2 sketch",
                         ("op", "q"), _latency_quantiles)

        def _queue_depth():
            with self._stats_lock:
                return {(op,): float(n)
                        for op, n in self._op_waiting.items()}

        def _inflight_ops():
            with self._stats_lock:
                return {(op,): float(n)
                        for op, n in self._op_inflight.items()}

        m.callback_gauge("vearch_ps_queue_depth",
                         "requests waiting on the admission gate, "
                         "per op",
                         ("op",), _queue_depth)
        m.callback_gauge("vearch_ps_inflight",
                         "requests currently executing, per op",
                         ("op",), _inflight_ops)

        # continuous-batching scheduler: fixed event universe, node-
        # level sums across hosted engines — zero-filled every scrape so
        # the cardinality soak sees no series growth as traffic mixes
        def _sched_events():
            out = {(e,): 0.0 for e in
                   ("batch", "batched_request", "full_dispatch",
                    "age_timeout")}
            for eng in list(self.engines.values()):
                mb = eng._microbatcher
                if mb is None:
                    continue
                out[("batch",)] += float(mb.batches)
                out[("batched_request",)] += float(mb.batched_requests)
                out[("full_dispatch",)] += float(mb.full_dispatches)
                out[("age_timeout",)] += float(mb.age_timeout_fires)
            return out

        def _pad_waste_bytes():
            total = 0
            for eng in list(self.engines.values()):
                total += int(getattr(eng, "pad_waste_bytes", 0))
            return {(): float(total)}

        def _bucket_occupancy():
            rows = cap = 0
            for eng in list(self.engines.values()):
                mb = eng._microbatcher
                if mb is None:
                    continue
                rows += mb.dispatch_rows
                cap += mb.dispatch_capacity
            return {(): round(100.0 * rows / max(cap, 1), 2)}

        m.callback_counter("vearch_ps_batch_sched_events_total",
                           "continuous-batching scheduler events: "
                           "multi-request dispatches (batch), requests "
                           "that shared one (batched_request), buckets "
                           "dispatched full vs on age-bound expiry",
                           ("event",), _sched_events)
        m.callback_counter("vearch_ps_batch_padding_waste_bytes",
                           "bytes of padding rows added to reach the "
                           "declared shape buckets, summed across "
                           "hosted engines",
                           (), _pad_waste_bytes)
        m.callback_gauge("vearch_ps_batch_occupancy_pct",
                         "real rows as a share of padded bucket "
                         "capacity across all scheduler dispatches "
                         "(100 = perfectly packed)",
                         (), _bucket_occupancy)
        register_tracer_metrics(m, self.tracer)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        if self.master_addr:
            self._register()
        # engine open/recovery compiles are expected — keep them out of
        # the serving-compile audit
        with self.flight_recorder.warmup():
            self._recover_partitions()
        self._recovered.set()
        self.device_sampler.start()
        self._quality.start()
        if self.master_addr:
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="ps-heartbeat").start()
        threading.Thread(target=self._flush_loop, daemon=True,
                         name="ps-flush").start()
        threading.Thread(target=self._raft_tick_loop, daemon=True,
                         name="ps-raft-tick").start()
        threading.Thread(target=self._slow_killer_loop, daemon=True,
                         name="ps-slow-killer").start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        self.device_sampler.stop()
        self._quality.stop()
        for pid in list(self.raft_nodes):
            if flush:
                try:
                    self.flush_partition(pid)
                except Exception:
                    pass
            self.raft_nodes[pid].close()
        for eng in self.engines.values():
            eng.close()
        self.server.stop()
        if self.tracer.exporter is not None:
            self.tracer.exporter.close()  # ship the last buffered spans

    @property
    def addr(self) -> str:
        return self.server.addr

    def _register(self) -> None:
        """Register with the master, retrying forever (reference:
        ps/server.go:228 lease-backed registration). Node identity is
        persisted locally so a restarted PS keeps its node_id — the
        partitions on disk are addressed by it (reference:
        ps/psutil/meta.go:40 InitMeta local meta file)."""
        meta_path = os.path.join(self.data_dir, "node_meta.json")
        if self.node_id is None and os.path.exists(meta_path):
            with open(meta_path) as f:
                self.node_id = int(json.load(f)["node_id"])
        while not self._stop.is_set():
            try:
                data = rpc.call(
                    self.master_addr, "POST", "/register",
                    {"rpc_addr": self.addr, "node_id": self.node_id,
                     "labels": self.labels},
                    auth=self.master_auth,
                )
                self.node_id = data["node_id"]
                tmp = meta_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"node_id": self.node_id}, f)
                os.replace(tmp, meta_path)
                return
            except RpcError:
                time.sleep(0.5)

    def _partition_stats(self) -> dict[str, dict]:
        """Per-partition stats riding the heartbeat so the master can
        export cluster-level doc/size gauges (reference: master scrapes
        partition stats into monitor_service.go:51-73 gauges)."""
        with self._split_lock:
            split_status = {pid: job.get("status")
                            for pid, job in self._split_jobs.items()}
        with self._stats_lock:
            ops = {pid: dict(c) for pid, c in self._op_counts.items()}
        out = {}
        for pid, eng in list(self.engines.items()):
            try:
                job = eng.build_job
                part = self.partitions.get(pid)
                out[str(pid)] = {
                    "doc_count": eng.doc_count,
                    "size_bytes": eng.memory_usage_bytes(),
                    "status": int(eng.status),
                    "leader": (
                        bool(self.raft_nodes[pid].state().get("is_leader"))
                        if pid in self.raft_nodes else True
                    ),
                    # cumulative op counters: the master's rebalance
                    # planner derives hotness from scrape-to-scrape
                    # deltas of these
                    "searches_total": ops.get(pid, {}).get("searches", 0),
                    "writes_total": ops.get(pid, {}).get("writes", 0),
                    # elastic-job state rides the heartbeat so
                    # /cluster/health rolls up splits and learner
                    # catch-ups without polling every PS
                    "split_status": split_status.get(pid),
                    "learner": bool(
                        part is not None
                        and self.node_id in getattr(part, "learners", [])
                    ),
                    # index-build job state rides the heartbeat so the
                    # master's /cluster/health can roll up in-flight and
                    # failed builds cluster-wide
                    "build_status": job.get("status") if job else None,
                    # data-version signal for the router result cache:
                    # the raft apply index (or the engine's own version
                    # counter off-raft) piggybacks on heartbeats so
                    # cache entries can be revalidated out-of-band of
                    # the search path
                    "apply_version": (
                        int(self.raft_nodes[pid].applied)
                        if pid in self.raft_nodes
                        else int(eng.data_version)
                    ),
                    # index-health drift block (recon error, cell
                    # imbalance, deleted/unindexed fractions,
                    # needs_retrain + reasons) — elastic.compute_plan
                    # reads it out of the master's node stats
                    "quality": self._quality.partition_stats(pid),
                }
            except Exception:
                continue
        return out

    def _space_key(self, pid: int) -> str:
        """The billing key ("db/space") for a hosted partition; the
        `_system` bucket when the partition record is unknown (e.g.
        a dev-mode engine opened outside the metastore)."""
        part = self.partitions.get(pid)
        if part is None or not getattr(part, "space_name", None):
            return accounting.SYSTEM_SPACE
        return f"{part.db_name}/{part.space_name}"

    def _usage_summary(self) -> dict:
        """Per-tenant meter snapshot riding the heartbeat: the process
        accountant's exact per-space dict (never label-collapsed) plus
        this node's per-space HBM residency split. The master rolls
        these up into GET /cluster/usage, deduplicating accountant
        scopes shared by co-located nodes."""
        snap = self._accountant.snapshot()
        return {
            "scope_id": snap["scope_id"],
            "spaces": snap["spaces"],
            "totals": snap["totals"],
            "hbm_bytes": {
                sp: int(n) for sp, n in self._space_device_bytes().items()
            },
        }

    def _obs_summary(self) -> dict:
        """Drift + compile + search-quality digest riding the
        heartbeat (master: _node_obs -> /cluster/health)."""
        samp = self.device_sampler.snapshot()
        return {
            "hbm_drift": bool(samp.get("drift")),
            "drift_bytes": int(samp.get("drift_bytes") or 0),
            "compiles_post_warmup": self.flight_recorder.total(),
            # spaces whose shadow-sampled recall sits statistically
            # under their floor, and partitions whose drift gauges say
            # retrain — the master degrades /cluster/health on these
            **self._quality.obs_summary(),
        }

    def _load_summary(self) -> dict:
        """Search-path load digest riding the heartbeat: queue depth,
        inflight, and node latency quantiles. The master merges it into
        /servers (in-memory only) so routers can score replicas for
        least-loaded read routing without polling each PS."""
        with self._stats_lock:
            waiting = int(self._op_waiting.get("search", 0))
            inflight = int(self._op_inflight.get("search", 0))
        q = (self.latency_quantiles.snapshot()
             .get(("_node", "search")) or {}).get("q", {})
        return {
            "waiting": waiting,
            "inflight": inflight,
            "q50_ms": float(q.get("0.5", 0.0)),
            "q95_ms": float(q.get("0.95", 0.0)),
        }

    def _retry_after_s(self) -> float:
        """Backpressure hint for 429 sheds: a rough time-to-drain —
        median search latency times queue depth over service capacity,
        clamped so clients neither hammer (floor) nor give up (cap)."""
        q = (self.latency_quantiles.snapshot()
             .get(("_node", "search")) or {}).get("q", {})
        q50_s = float(q.get("0.5", 0.0)) / 1e3 or 0.05
        with self._stats_lock:
            waiting = int(self._op_waiting.get("search", 0))
        est = q50_s * (waiting + 1) / max(1, self.max_concurrent_searches)
        return round(min(5.0, max(0.05, est)), 3)

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.heartbeat_interval)
            try:
                resp = rpc.call(
                    self.master_addr, "POST", "/register",
                    {"rpc_addr": self.addr, "node_id": self.node_id,
                     "labels": self.labels,
                     "partitions": self._partition_stats(),
                     # runtime-truth digest: the master's health
                     # rollup degrades on drift without polling us
                     "obs": self._obs_summary(),
                     # load digest for least-loaded replica routing
                     "load": self._load_summary(),
                     # per-tenant meters; scope_id lets the master
                     # dedup co-located nodes sharing one process
                     # accountant (docs/ACCOUNTING.md)
                     "usage": self._usage_summary()},
                    auth=self.master_auth,
                )
            except RpcError:
                continue
            try:
                self._reconcile_schema_fields(
                    resp.get("schema_fields") or {}
                )
                self._reconcile_field_indexes(
                    resp.get("field_indexes") or {}
                )
            except Exception:
                _log.exception("field-index reconcile failed")
            try:
                # per-space recall floors from Space.slo ride the
                # register response; replace-not-merge, so dropping a
                # floor from the space config clears it here too
                if "recall_floors" in resp:
                    self._quality.set_floors(
                        resp.get("recall_floors") or {})
            except Exception:
                _log.exception("recall-floor apply failed")

    def _reconcile_schema_fields(
        self, expect: dict[str, list]
    ) -> None:
        """Add scalar fields the master's schema has but this engine
        lacks (missed /ps/schema/field fan-out or a restart from a
        pre-addition local schema). Runs before the index reconcile so
        a brand-new indexed field gets its column first."""
        from vearch_tpu_torch.engine.types import FieldSchema

        for pid_s, flds in expect.items():
            eng = self.engines.get(int(pid_s))
            if eng is None:
                continue
            names = {f.name for f in eng.schema.fields}
            for d in flds:
                if d["name"] not in names:
                    eng.add_schema_field(FieldSchema.from_dict(d))

    def _reconcile_field_indexes(
        self, expect: dict[str, dict[str, str]]
    ) -> None:
        """Converge each engine's scalar-index flags onto the master's
        expectations riding the heartbeat response. This is the repair
        path for replicas that missed a /field_index fan-out — an alive
        node that hit a transient RPC failure, or one that restarted
        from a local schema.json persisted before the change."""
        for pid_s, flags in expect.items():
            eng = self.engines.get(int(pid_s))
            if eng is None:
                continue
            for f in eng.schema.fields:
                if f.data_type is DataType.VECTOR:
                    continue
                desired = flags.get(f.name, "NONE")
                if f.scalar_index.value != desired:
                    eng.add_field_index(f.name, desired)

    # -- recovery (reference: partition_service.go:275 recoverPartitions:
    #    re-Build engine, gamma Load, rejoin raft) ---------------------------

    def _recover_partitions(self) -> None:
        # the master's metadata wins over the locally persisted
        # partition.json: leadership may have moved while we were down
        current: dict[int, dict] = {}
        if self.master_addr:
            try:
                for p in rpc.call(self.master_addr, "GET", "/partitions",
                                  auth=self.master_auth)["partitions"]:
                    current[int(p["id"])] = p
            except RpcError:
                pass
        import re as _re

        for name in sorted(os.listdir(self.data_dir)):
            pdir = os.path.join(self.data_dir, name)
            # a crashed restore leaves partition_<pid>.restore.* staging
            # dirs: reclaim them at startup or they accumulate shard-
            # sized garbage across crash/restore cycles
            if _re.fullmatch(r"partition_\d+\.restore\..*", name):
                shutil.rmtree(pdir, ignore_errors=True)
                continue
            if not (_re.fullmatch(r"partition_\d+", name)
                    and os.path.isdir(pdir)):
                continue
            pid = int(name.split("_")[1])
            try:
                with open(os.path.join(pdir, "partition.json")) as f:
                    part = Partition.from_dict(json.load(f))
                if pid in current:
                    part = Partition.from_dict(current[pid])
                    self._persist_partition_meta(part)
                eng = Engine.open(pdir, device=self.device)
                eng.start_refresh_loop()
                self._wire_engine(pid, eng)
                applied = 0
                ap = os.path.join(pdir, "applied.json")
                if os.path.exists(ap):
                    with open(ap) as f:
                        applied = int(json.load(f)["applied"])
                node = self._make_raft_node(part, pdir)
                # lock-fix note: applied is raft-lock-guarded state and
                # _flushed was written outside _lock — both race the
                # flush loop once earlier partitions started it
                with node._lock:
                    node.applied = applied
                with self._lock:
                    self._flushed[pid] = applied
                    self.engines[pid] = eng
                    self.partitions[pid] = part
                    self.raft_nodes[pid] = node
                # replay the committed tail into the engine; single-
                # member groups treat every fsync'd entry as committed
                node.recover_singleton_commit()
                node._apply_to_commit()
            except Exception as e:
                _log.error("ps %s: recover partition %s failed: %s: %s",
                           self.node_id, pid, type(e).__name__, e)

    # -- raft plumbing -------------------------------------------------------

    def _make_raft_node(self, part: Partition, pdir: str) -> RaftNode:
        pid = part.id
        members = part.replicas or [self.node_id or 0]
        node = RaftNode(
            pid=pid,
            node_id=self.node_id if self.node_id is not None else 0,
            wal_dir=os.path.join(pdir, "raft"),
            apply_fn=lambda op, _pid=pid: self._apply(_pid, op),
            send_fn=self._raft_send,
            members=members,
            # leader iff the metadata says so, or this node is the sole
            # member (a directly-created local partition). A node NOT in
            # the member list (e.g. removed while down) is never leader.
            is_leader=(part.leader == self.node_id
                       or members == [self.node_id]),
            snapshot_fn=lambda _pid=pid: self._take_snapshot(_pid),
            install_fn=lambda data, idx, _pid=pid: self._install_snapshot(
                _pid, data, idx),
            observer=self._raft_observer(pid),
            learners=list(getattr(part, "learners", []) or []),
        )
        node.wal.observer = self._wal_observer(pid)
        return node

    def _wal_observer(self, pid: int):
        """WAL event sink feeding the durability histograms: fsync
        latency tells you when the disk (not the quorum) is the write
        bottleneck; batch entries show whether group-commit batching is
        actually happening. Fires under the WAL lock — keep it cheap."""

        def observe(event: str, info: dict) -> None:
            if event == "append":
                self._wal_fsync_hist.observe(
                    float(info.get("fsync_seconds", 0.0)), str(pid))
                self._wal_batch_hist.observe(
                    float(info.get("entries", 0)), str(pid))
        return observe

    def _raft_observer(self, pid: int):
        """Raft event sink: latency events feed the /metrics histograms;
        rare state transitions (elections, leadership changes, snapshot
        transfers) become spans so they show up in /debug/traces next to
        the searches they disturbed. Must stay cheap + non-blocking —
        it can fire under raft locks."""

        def observe(event: str, info: dict) -> None:
            p = str(pid)
            if event == "commit":
                self._raft_commit_hist.observe(info["seconds"], p)
            elif event == "apply":
                self._raft_apply_hist.observe(info["seconds"], p)
            else:
                self.tracer.record(
                    f"raft.{event}",
                    tags={"partition": pid, "node": self.node_id, **info},
                )
        return observe

    def _apply(self, pid: int, op: dict) -> Any:
        """State-machine apply (reference: raft_state_machine.go:124
        innerApply -> gammacb writer). Deterministic: every replica
        applies identical ops in identical log order."""
        eng = self._engine(pid)
        t = op["type"]
        if t == "upsert":
            with self._stats_lock:
                self._mem_dirty = True  # cached memory accounting is stale
            try:
                return eng.upsert(op["documents"])
            except ValueError as e:
                # data-dependent rejection (e.g. a partial update whose
                # base row vanished between propose and apply). Applies
                # must NEVER raise: the entry is already committed, and
                # an exception here would wedge the apply loop retrying
                # it forever on every replica. Same state -> same error
                # marker on every replica, so determinism holds.
                return {"_rejected": str(e)}
        if t == "delete":
            with self._stats_lock:
                self._mem_dirty = True
            return eng.delete(op["keys"])
        raise RpcError(500, f"unknown log op {t!r}")

    def _peer_addr(self, peer: int) -> str:
        now = time.monotonic()  # cache TTL is a duration
        ts, cache = self._peer_cache
        if now - ts > 2.0 or peer not in cache:
            servers = rpc.call(self.master_addr, "GET", "/servers",
                               auth=self.master_auth)["servers"]
            cache = {s["node_id"]: s["rpc_addr"] for s in servers}
            # lock-fix note: concurrent refreshers raced the rebind;
            # last-writer-wins is fine but the write itself is guarded
            with self._stats_lock:
                self._peer_cache = (now, cache)
        if peer not in cache:
            raise RpcError(503, f"no address for node {peer}")
        return cache[peer]

    def _raft_send(self, peer: int, path: str, body: dict) -> dict:
        try:
            return rpc.call(self._peer_addr(peer), "POST", path, body,
                            timeout=30.0)
        except RpcError:
            # lock-fix note: unlocked += from concurrent sync threads
            # dropped increments (read-modify-write race)
            with self._stats_lock:
                self.replication_errors += 1
            raise

    def _node(self, pid: int) -> RaftNode:
        node = self.raft_nodes.get(int(pid))
        if node is None:
            raise RpcError(404, f"partition {pid} not on this node")
        return node

    def _h_raft_append(self, body: dict, _parts) -> dict:
        return self._node(body["pid"]).handle_append(body)

    def _h_raft_fence(self, body: dict, _parts) -> dict:
        return self._node(body["pid"]).handle_fence(int(body["term"]))

    def _h_raft_lead(self, body: dict, _parts) -> dict:
        pid = int(body["pid"])
        node = self._node(pid)
        out = node.become_leader(int(body["term"]), body["members"],
                                 learners=body.get("learners"))
        self._update_partition_meta(pid, leader=self.node_id,
                                    term=int(body["term"]),
                                    replicas=body["members"],
                                    learners=body.get("learners"))
        return out

    def _h_raft_members(self, body: dict, _parts) -> dict:
        pid = int(body["pid"])
        node = self._node(pid)
        out = node.set_members(int(body["term"]), body["members"],
                               learners=body.get("learners"))
        self._update_partition_meta(pid, term=int(body["term"]),
                                    replicas=body["members"],
                                    leader=body.get("leader"),
                                    learners=body.get("learners"))
        return out

    def _h_raft_snapshot(self, body: dict, _parts) -> dict:
        return self._node(body["pid"]).handle_install_snapshot(body)

    def _h_raft_state(self, body, parts) -> dict:
        if parts:
            return self._node(int(parts[0])).state()
        return {str(pid): n.state() for pid, n in self.raft_nodes.items()}

    def _update_partition_meta(self, pid: int, leader=None, term=None,
                               replicas=None, learners=None) -> None:
        part = self.partitions.get(pid)
        if part is None:
            return
        if leader is not None:
            part.leader = leader
        if term is not None:
            part.term = term
        if replicas is not None:
            part.replicas = list(replicas)
        if learners is not None:
            part.learners = [int(x) for x in learners]
        self._persist_partition_meta(part)

    def _persist_partition_meta(self, part: Partition) -> None:
        pdir = os.path.join(self.data_dir, f"partition_{part.id}")
        os.makedirs(pdir, exist_ok=True)
        tmp = os.path.join(pdir, "partition.json.tmp")
        with open(tmp, "w") as f:
            json.dump(part.to_dict(), f)
        os.replace(tmp, os.path.join(pdir, "partition.json"))

    # -- flush job (reference: store_raft_job.go:97 flush job records the
    #    applied SN; :40 truncate job trims the log behind it) --------------

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.flush_interval)
            for pid in list(self.raft_nodes):
                try:
                    node = self.raft_nodes.get(pid)
                    if node is None:
                        continue
                    if node.applied > self._flushed.get(pid, 0):
                        self.flush_partition(pid)
                except Exception as e:
                    # a silently failing flush would stop checkpointing
                    # AND WAL truncation — always loud
                    _log.error("ps %s: flush partition %s failed: %s: %s",
                               self.node_id, pid, type(e).__name__, e)

    def _flush_lock(self, pid: int):
        # lock-fix note: flush locks were minted via bare setdefault
        # from the flush loop, /ps/flush, snapshot sends and restore
        # concurrently — two callers could each get a DIFFERENT lock
        # for the same pid and checkpoint over each other. The dict
        # mutation now happens under _lock.
        with self._lock:
            return self._flush_locks.setdefault(
                pid, lockcheck.make_lock(f"ps.flush{pid}"))

    def flush_partition(self, pid: int) -> int:
        """Checkpoint the engine with its applied index, then truncate
        the WAL behind it (keeping a catch-up tail). Returns the flushed
        applied index."""
        node = self._node(pid)
        eng = self._engine(pid)
        pdir = os.path.join(self.data_dir, f"partition_{pid}")
        with self._flush_lock(pid):
            # capture under the apply mutex so the engine snapshot
            # matches node.applied exactly; disk writes happen outside
            # it (but inside the flush lock — one checkpoint at a time)
            with node._apply_lock:
                applied = node.applied
                snap = eng.snapshot_state()
            eng.write_snapshot(snap, pdir)
            tmp = os.path.join(pdir, "applied.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"applied": applied, "term": node.term}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(pdir, "applied.json"))
            # lock-fix note: _flushed is read by the flush loop under
            # no lock at all; writes now consistently go through _lock
            with self._lock:
                self._flushed[pid] = applied
            node.wal.save_meta(fsync=True)
            node.wal.truncate_prefix(
                max(node.wal.first_index, applied - WAL_KEEP_ENTRIES + 1)
            )
        return applied

    def _raft_tick_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.raft_tick)
            for node in list(self.raft_nodes.values()):
                # also tick single-voter groups that carry learners:
                # the migration catch-up stream rides the tick
                if node.is_leader and (len(node.members) > 1
                                       or node.learners):
                    node.tick()

    # -- snapshot transfer (reference: gammacb/snapshot.go:26 streams the
    #    engine's on-disk files in chunks) ----------------------------------

    def _take_snapshot(self, pid: int) -> tuple[bytes, int]:
        applied = self.flush_partition(pid)
        pdir = os.path.join(self.data_dir, f"partition_{pid}")
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            for name in sorted(os.listdir(pdir)):
                # raft log + local membership are per-replica, not state
                if name in ("raft", "partition.json") or \
                        name.endswith(".tmp"):
                    continue
                tar.add(os.path.join(pdir, name), arcname=name)
        return buf.getvalue(), applied

    def _install_snapshot(self, pid: int, data: bytes, snap_index: int
                          ) -> None:
        pdir = os.path.join(self.data_dir, f"partition_{pid}")
        old = self.engines.get(pid)
        if old is not None:
            old.close()
        for name in list(os.listdir(pdir)):
            if name in ("raft", "partition.json"):
                continue
            p = os.path.join(pdir, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
            tar.extractall(pdir, filter="data")
        eng = Engine.open(pdir, device=self.device)
        eng.start_refresh_loop()
        self._wire_engine(pid, eng)
        with self._lock:
            self.engines[pid] = eng
            self._flushed[pid] = snap_index
        with self._stats_lock:
            self._mem_dirty = True

    # -- handlers ------------------------------------------------------------

    def _engine(self, pid: int) -> Engine:
        eng = self.engines.get(int(pid))
        if eng is None:
            raise RpcError(404, f"partition {pid} not on this node")
        return eng

    def memory_used_bytes(self) -> int:
        """Total engine memory across partitions, from a short-TTL /
        dirty-flag cache: a clean read serves the cached sum for up to
        _mem_max_age seconds; applies mark it dirty, and a dirty read
        refreshes at most every _mem_min_interval seconds so a write
        burst pays one O(engines) walk per interval, not per request."""
        now = time.monotonic()  # cache age is a duration
        ts, val = self._mem_cache
        age = now - ts
        if (age > self._mem_max_age
                or (self._mem_dirty and age > self._mem_min_interval)):
            val = sum(
                e.memory_usage_bytes() for e in list(self.engines.values())
            )
            # the O(engines) walk stays outside the lock (concurrent
            # refreshers waste a walk, never corrupt); the cache rebind
            # + dirty-flag clear are what must be atomic
            with self._stats_lock:
                self._mem_cache = (now, val)
                self._mem_dirty = False
        return val

    def _wire_engine(self, pid: int, eng: Engine) -> None:
        """Attach the per-engine observability hooks every creation
        path (create / recover / snapshot install / restore) needs:
        terminal build states feed the build-duration histogram — this
        covers background auto-builds the request handlers never see."""
        def on_build_done(job: dict, _pid: int = pid) -> None:
            self._build_hist.observe(
                float(job.get("duration_seconds") or 0.0),
                str(_pid), str(job.get("op", "build")))
            if job.get("status") == "done":
                # a finished (re)build replaced the serving index: reset
                # the recall estimators and the train-time recon
                # baseline (staleness hook, lint VL105) — this covers
                # background auto-builds no request handler ever sees
                self._quality.note_index_mutation(
                    _pid, self._space_key(_pid),
                    op=str(job.get("op", "build")))
        eng.build_observer = on_build_done

    def _h_create_partition(self, body: dict, _parts) -> dict:
        if not self._recovered.is_set():
            # the partitions on this server's disk are not reopened yet:
            # a create now would dump an empty engine over one of them
            # (the master's re-add of a returning replica); the master
            # retries on its next pass
            raise RpcError(503, "partition server is still reopening its "
                                "partitions")
        part = Partition.from_dict(body["partition"])
        pid = part.id
        with self._lock:
            if pid in self.engines:
                raise RpcError(409, f"partition {pid} already exists")
            schema = TableSchema.from_dict(body["schema"])
            pdir = os.path.join(self.data_dir, f"partition_{pid}")
            with self.flight_recorder.warmup():
                eng = Engine(schema, data_dir=pdir, device=self.device)
                eng.dump()  # schema on disk immediately: crash-openable
            eng.start_refresh_loop()
            self._wire_engine(pid, eng)
            self.engines[pid] = eng
            self.partitions[pid] = part
            self._persist_partition_meta(part)
            node = self._make_raft_node(part, pdir)
            if part.term > node.wal.term:
                node.wal.term = part.term
                node.wal.save_meta()
            self.raft_nodes[pid] = node
        return {"partition_id": pid}

    def _h_delete_partition(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        space = self._space_key(pid)  # before the registry pop below
        # an active split ends here: for a committed split this IS the
        # normal finalization (the master deletes the parent last); the
        # teardown drains the mirror queue while the engine still lives
        self._split_teardown(pid)
        with self._lock:
            node = self.raft_nodes.pop(pid, None)
            if node is not None:
                node.close()
            eng = self.engines.pop(pid, None)
            if eng is not None:
                eng.close()
            self.partitions.pop(pid, None)
            self._flushed.pop(pid, None)
        shutil.rmtree(
            os.path.join(self.data_dir, f"partition_{pid}"), ignore_errors=True
        )
        # drop quality state keyed by the gone partition (warm keys,
        # health, recall cells for its space — VL105 staleness hook)
        self._quality.note_index_mutation(pid, space, op="")
        return {"partition_id": pid}

    # -- writes: every mutation is a log proposal ---------------------------

    def _observed_write(self, body: dict, fn, parts) -> dict:
        """Write-op observability shim: inflight gauge + latency
        quantile sketch around the real handler (mirrors what the
        search path does inline)."""
        pid = int(body["partition_id"])
        t0 = time.monotonic()
        with self._stats_lock:
            self._op_inflight["write"] += 1
        # write-path H2D bytes (appends pushing rows to device) bill to
        # the owning space, not the _system bucket
        _space_token = accounting.set_space(self._space_key(pid))
        try:
            return fn(body, parts)
        finally:
            accounting.reset_space(_space_token)
            with self._stats_lock:
                self._op_inflight["write"] -= 1
            ms = (time.monotonic() - t0) * 1e3
            self.latency_quantiles.observe((pid, "write"), ms)
            self.latency_quantiles.observe(("_node", "write"), ms)

    def _h_upsert(self, body: dict, _parts) -> dict:
        return self._observed_write(body, self._h_upsert_inner, _parts)

    def _h_upsert_inner(self, body: dict, _parts) -> dict:
        import uuid

        from vearch_tpu_torch.cluster.tracing import NULL_SPAN

        pid = int(body["partition_id"])
        self._engine(pid)  # 404 before proposing
        if self.memory_limit_mb:
            # cached accounting: the old inline sum walked every engine
            # on EVERY upsert — O(partitions) per request
            used = self.memory_used_bytes() >> 20
            if used >= self.memory_limit_mb:
                raise RpcError(
                    403,
                    f"resource_exhausted: {used}MB >= "
                    f"limit {self.memory_limit_mb}MB (writes rejected, "
                    f"reads still served)",
                )
        # assign ids BEFORE the log so replicas apply identical ops.
        # NOTE on retries: propose may 503 while the entry later commits
        # (at-least-once); a retry is safe because the router assigns
        # _ids before fan-out, so the replayed upsert is an idempotent
        # update. Direct-PS callers should pass _id themselves — the
        # uuid fallback here makes a blind retry mint a second document.
        docs = [
            doc if "_id" in doc else {**doc, "_id": uuid.uuid4().hex}
            for doc in body["documents"]
        ]
        # partial updates (docs omitting vector fields) must reference an
        # existing row — reject BEFORE proposing so a bad request never
        # enters the replicated log (a rare post-propose race degrades to
        # a deterministic _rejected apply marker instead)
        eng = self._engine(pid)
        vf = [f.name for f in eng.schema.vector_fields()]
        batch_ids = set()
        for doc in docs:
            # None == omitted (a JSON null vector is the natural "keep
            # the stored one" idiom); an _id provided earlier in this
            # batch is a valid inheritance source too
            missing = [n for n in vf if doc.get(n) is None]
            if missing and str(doc["_id"]) not in batch_ids \
                    and eng.table.docid_of(str(doc["_id"])) is None:
                raise RpcError(
                    400,
                    f"document {doc['_id']!r} omits vector field(s) "
                    f"{missing} and does not exist yet",
                )
            if not missing:
                batch_ids.add(str(doc["_id"]))
        tctx = body.get("_trace_ctx")
        profile = bool(body.get("profile"))
        # write-side timing mirrors the search path: raft fills per-phase
        # windows (propose-wait / wal append+fsync / commit-wait / apply)
        # which become child spans and the profile:true breakdown
        timing: dict | None = {} if (profile or tctx) else None
        span = (
            self.tracer.span("ps.upsert", ctx=tctx,
                             tags={"partition": pid, "node": self.node_id,
                                   "docs": len(docs)})
            if tctx else NULL_SPAN
        )
        node = self._node(pid)
        with span:
            keys = node.propose(
                [{"type": "upsert", "documents": docs}], timing=timing)[0]
            if timing is not None:
                timing["doc_count"] = len(docs)
                self._replay_write_spans(span, timing, pid)
        if isinstance(keys, dict) and "_rejected" in keys:
            raise RpcError(400, keys["_rejected"])
        self._write_docs_total.inc(str(pid), "upsert", by=float(len(docs)))
        self._count_op(pid, "writes")
        # double-write mirror for an active split: in the sync window
        # this blocks until the children hold the write, so the ack the
        # client sees is as durable post-cutover as pre-cutover
        self._split_mirror(pid, "upsert",
                           [str(d["_id"]) for d in docs])
        # propose() returns only after the entry applied locally, so
        # this applied index covers the write just acknowledged — the
        # router bumps its version map from it, which is exactly what
        # keeps read-your-writes through the result cache
        out = {"keys": keys, "count": len(keys),
               "apply_version": int(node.applied),
               "map_version": self._map_version(pid)}
        if profile:
            out["profile"] = _write_profile_from_timing(timing or {})
        return out

    def _replay_write_spans(self, span, timing: dict, pid: int) -> None:
        """Replay raft's measured phase windows as child spans under the
        sampled ps.upsert/ps.delete span, and tag the parent with the
        flat `*_ms` breakdown (same contract as the search path)."""
        from vearch_tpu_torch.cluster.tracing import NULL_SPAN

        pspans = timing.pop("_phase_spans", None) or []
        if span is NULL_SPAN:
            return
        sctx = span.ctx()
        for name, start_us, dur_us in pspans:
            self.tracer.record(name, ctx=sctx, start_us=start_us,
                               dur_us=dur_us, tags={"partition": pid})
        for phase, ms in timing.items():
            span.set_tag(phase, ms)

    def _h_delete(self, body: dict, _parts) -> dict:
        return self._observed_write(body, self._h_delete_inner, _parts)

    def _h_delete_inner(self, body: dict, _parts) -> dict:
        from vearch_tpu_torch.cluster.tracing import NULL_SPAN

        pid = int(body["partition_id"])
        eng = self._engine(pid)
        node = self._node(pid)
        tctx = body.get("_trace_ctx")
        profile = bool(body.get("profile"))
        span = (
            self.tracer.span("ps.delete", ctx=tctx,
                             tags={"partition": pid, "node": self.node_id})
            if tctx else NULL_SPAN
        )
        if body.get("keys"):
            timing: dict | None = {} if (profile or tctx) else None
            with span:
                deleted = node.propose(
                    [{"type": "delete", "keys": body["keys"]}],
                    timing=timing)[0]
                if timing is not None:
                    self._replay_write_spans(span, timing, pid)
            self._write_docs_total.inc(str(pid), "delete",
                                       by=float(deleted or 0))
            self._count_op(pid, "writes")
            self._split_mirror(pid, "delete",
                               [str(k) for k in body["keys"]])
            out = {"deleted": deleted,
                   "apply_version": int(node.applied),
                   "map_version": self._map_version(pid)}
            if profile:
                out["profile"] = _write_profile_from_timing(timing or {})
            return out
        # delete-by-filter (reference: /document/delete with filters).
        # Drain in batches until no matches remain — a single capped
        # query would silently delete only the first 10k of a larger
        # match set (r1 VERDICT weak-8). An explicit client `limit`
        # still bounds the total.
        limit = int(body["limit"]) if body.get("limit") is not None else None
        batch = 10_000
        deleted = 0
        while True:
            want = batch if limit is None else min(batch, limit - deleted)
            if want <= 0:
                break
            docs = eng.query(body.get("filters"), limit=want,
                             include_fields=[], order_by_key=False)
            if not docs:
                break
            keys = [d["_id"] for d in docs]
            deleted += node.propose([{"type": "delete", "keys": keys}])[0]
            self._split_mirror(pid, "delete", [str(k) for k in keys])
            if len(docs) < want:
                break
        self._write_docs_total.inc(str(pid), "delete", by=float(deleted))
        self._count_op(pid, "writes")
        return {"deleted": deleted, "apply_version": int(node.applied),
                "map_version": self._map_version(pid)}

    def _h_get(self, body: dict, _parts) -> dict:
        eng = self._engine(body["partition_id"])
        return {"documents": eng.get(body["keys"], body.get("fields"),
                                      bool(body.get("vector_value", False)))}

    # -- kill switch / slow-request isolation (reference: Set/Delete
    #    KillStatus c_api + Rqueue, handler_document.go:96; slow-request
    #    killer, ps/schedule_job.go:252) ------------------------------------

    def _slow_killer_loop(self) -> None:
        while not self._stop.is_set():
            # tick fast enough to catch requests near the limit, but
            # never busier than 20Hz; re-read the limit AFTER sleeping
            # so a runtime config change takes effect within one tick
            time.sleep(max(0.05, min(0.5,
                                     (self.slow_request_ms or 2000) / 4000.0)))
            limit = self.slow_request_ms
            # monotonic, matching the request start stamps: a clock
            # step must not mass-kill (or never kill) in-flight work
            now = time.monotonic()
            with self._inflight_lock:
                for rid, info in self._inflight.items():
                    ctx = info["ctx"]
                    if ctx.killed:
                        continue
                    # per-request deadlines arm even when the slow-killer
                    # limit is off; ctx.check() also self-enforces them
                    # between dispatches, this loop just makes the kill
                    # prompt for requests parked off-device
                    dl = info.get("deadline")
                    if dl is not None and now > dl:
                        ctx.kill("deadline exceeded", code="deadline")
                        self.killed_requests += 1
                    elif limit and (now - info["start"]) * 1e3 > limit:
                        ctx.kill(
                            f"slow request killed after {limit}ms",
                            code="slow",
                        )
                        self.killed_requests += 1

    def _h_kill(self, body: dict, _parts) -> dict:
        """Kill in-flight request(s) by id (reference: SetKillStatus).
        A retried request may share its id with the original — kill
        every matching entry (the registry is keyed by a unique token
        so duplicates never shadow each other). An optional "attempt"
        narrows the kill to one hedged-scatter attempt: the rid is
        shared across a whole fan-out, so the router cancelling a
        hedge loser must not take out the sibling partitions' RPCs."""
        rid = str(body["request_id"])
        att = body.get("attempt")
        killed = 0
        with self._inflight_lock:
            for info in self._inflight.values():
                if info["rid"] != rid or info["ctx"].killed:
                    continue
                if att is not None and info.get("attempt") != att:
                    continue
                info["ctx"].kill("killed by operator", code="operator")
                killed += 1
            self.killed_requests += killed
        if not killed:
            raise RpcError(404, f"request {rid!r} not in flight")
        return {"request_id": rid, "killed": killed}

    def _h_requests(self, _body, _parts) -> dict:
        now = time.monotonic()  # elapsed_ms against monotonic starts
        with self._inflight_lock:
            return {"requests": [
                {"request_id": i["rid"],
                 "elapsed_ms": round((now - i["start"]) * 1e3, 1),
                 "killed": i["ctx"].killed}
                for i in self._inflight.values()
            ]}

    def _check_read_consistency(self, body: dict) -> None:
        """raft_consistent reads (reference: client honors the replica's
        raft_consistent lag status, client/client.go:1316): a follower
        serving a consistent read must have applied everything it knows
        to be committed; otherwise the router retries on the leader."""
        if not body.get("raft_consistent"):
            return
        node = self.raft_nodes.get(int(body.get("partition_id", -1)))
        if node is None:
            return
        st = node.state()
        if not st["is_leader"] and st["applied"] < st["commit"]:
            raise RpcError(
                421,
                f"partition {node.pid}: replica lags (applied "
                f"{st['applied']} < commit {st['commit']}) for a "
                f"raft_consistent read",
            )

    def _h_search(self, body: dict, _parts) -> dict:
        import uuid

        import numpy as np

        from vearch_tpu_torch.engine.engine import RequestContext, RequestKilled

        eng = self._engine(body["partition_id"])
        self._check_read_consistency(body)
        vectors = {
            name: np.asarray(v, dtype=np.float32)  # lint: allow[host-sync] host-side input normalization of wire payloads, no device work exists yet
            for name, v in body["vectors"].items()
        }
        pid = int(body["partition_id"])
        self._count_op(pid, "searches")
        # tenant resolution happens before admission so even a shed 429
        # is attributable (docs/ACCOUNTING.md)
        space_key = self._space_key(pid)
        space_lbl = self._accountant.label(space_key)
        # the router marks its duplicate hedge attempt: device work it
        # causes bills honestly, but the logical request bills once
        hedge_extra = bool(body.get("_hedge_extra"))
        q0 = next(iter(vectors.values()))
        qrows = 1 if q0.ndim == 1 else int(q0.shape[0])
        # slow-channel routing: partitions with a slow recent history go
        # through the small slow gate; everyone else uses the fast gate
        slow = bool(
            self.slow_route_ms
            and self._search_ewma.get(pid, 0.0) > self.slow_route_ms
        )
        gate = self._slow_gate if slow else self._search_gate
        if slow:
            with self._stats_lock:
                self.slow_routed += 1
        # admission control: shed before joining a wait queue that is
        # already past the bound — the request does zero device work and
        # the 429 carries a Retry-After estimate for the SDK's backoff
        if not self._admission.try_admit(
                priority=int(body.get("priority") or 0)):
            self._shed_total.inc("search", space_lbl)
            self._accountant.charge("sheds", 1, space=space_key)
            raise RpcError(
                429,
                f"partition server shedding: admission queue full "
                f"(limit {self._admission.queue_limit})",
                retry_after=self._retry_after_s(),
            )
        t_gate = time.monotonic()
        with self._stats_lock:
            self._op_waiting["search"] += 1
        try:
            acquired = gate.acquire(timeout=30.0)
        finally:
            with self._stats_lock:
                self._op_waiting["search"] -= 1
            self._admission.leave()
        if not acquired:
            raise RpcError(
                429,
                "partition server %s queue full"
                % ("slow-search" if slow else "search"),
                retry_after=self._retry_after_s(),
            )
        with self._stats_lock:
            self._op_inflight["search"] += 1
        gate_wait_ms = round((time.monotonic() - t_gate) * 1e3, 3)
        self._accountant.charge("queue_wait_us", int(gate_wait_ms * 1e3),
                                space=space_key)
        rid = str(body.get("request_id") or uuid.uuid4().hex)
        token = uuid.uuid4().hex  # unique even when clients reuse rids
        # per-request deadline: the search option wins, else the PS-wide
        # config default; 0/absent leaves the request unbounded
        deadline_ms = float(
            body.get("deadline_ms") or self.request_deadline_ms or 0
        )
        t_start = time.monotonic()
        # wall anchor for span epochs; all measurement stays monotonic
        wall0 = time.time() - t_start  # lint: allow[wall-clock] span epoch anchor, correlates with collector time
        ctx = RequestContext(
            rid,
            deadline=(t_start + deadline_ms / 1e3) if deadline_ms else None,
        )
        with self._inflight_lock:
            self._inflight[token] = {"rid": rid, "start": t_start,
                                     "ctx": ctx, "slow": slow,
                                     "deadline": ctx.deadline,
                                     # hedged-scatter attempt id: lets
                                     # the router cancel one attempt of
                                     # a fan-out without killing the
                                     # sibling that shares the rid
                                     "attempt": body.get("_hedge_attempt")}
        from vearch_tpu_torch.cluster.tracing import NULL_SPAN

        tctx = body.get("_trace_ctx")
        span = (
            self.tracer.span("ps.search", ctx=tctx,
                             tags={"partition": pid, "node": self.node_id,
                                   "slow_channel": slow})
            if tctx else NULL_SPAN
        )
        want_trace = bool(body.get("trace") or body.get("profile"))
        # slowlog/deadline observability needs the phase breakdown even
        # when the client didn't ask for one — force the engine trace on
        # so a killed or slow request can explain where its time went
        # (the dict is stripped from the response below unless asked for)
        trace: dict | None = (
            {} if (want_trace or ctx.deadline is not None
                   or self.slowlog.threshold_ms > 0) else None
        )
        # compile attribution: a serving-path compilation during this
        # request's dispatches lands in /debug/compiles carrying this id
        from vearch_tpu_torch.obs import flight_recorder as _flightrec

        _trace_token = _flightrec.set_active_trace(span.trace_id or rid)
        # cost attribution: every dispatch / H2D byte / device slice the
        # engine produces for this request bills to this space (the
        # batch scheduler carries the binding across its thread hop)
        _space_token = accounting.set_space(space_key)
        try:
            with span:
                if self.debug_search_delay_ms:
                    # injected straggler (tests/bench): sleep in small
                    # chunks so a hedged loser's kill aborts it fast
                    end = t_start + float(self.debug_search_delay_ms) / 1e3
                    while True:
                        ctx.check()
                        rem = end - time.monotonic()
                        if rem <= 0:
                            break
                        # lint: allow[serving-blocking] env-gated test-only delay, sliced 5ms so ctx.check() keeps it killable
                        time.sleep(min(0.005, rem))
                # apply version captured BEFORE the search runs: a
                # write landing mid-search makes the resulting cache
                # entry *older*-labeled, so it can never serve a state
                # the writer was already acknowledged for
                rnode = self.raft_nodes.get(pid)
                applied = (int(rnode.applied) if rnode is not None
                           else int(eng.data_version))
                out, cache_status, timing = self._cached_search(
                    eng, pid, applied, body, vectors, ctx, trace
                )
                # every response carries the partition's apply version
                # — the router's entry-validation signal
                out["apply_version"] = applied
                # ... and the partition-map epoch, so a router holding a
                # stale map learns of a split cutover from any response
                out["map_version"] = self._map_version(pid)
                span.set_tag("cache", cache_status)
                if cache_status in ("hit", "coalesced"):
                    # served from memo: billed to the hitting space at
                    # zero device cost (no engine work ran for it)
                    self._accountant.charge("cache_hits", 1,
                                            space=space_key)
                if timing is not None:
                    timing["gate_wait_ms"] = gate_wait_ms
                    # engine phase windows -> real child spans under
                    # ps.search (gate wait included), so /debug/traces
                    # shows where the partition's time went
                    pspans = timing.pop("_phase_spans", None) or []
                    if span is not NULL_SPAN:
                        sctx = span.ctx()
                        self.tracer.record(
                            "ps.gate_wait", ctx=sctx,
                            start_us=int((wall0 + t_gate) * 1e6),
                            dur_us=int(gate_wait_ms * 1e3),
                            tags={"partition": pid},
                        )
                        for name, start_us, dur_us in pspans:
                            self.tracer.record(
                                name, ctx=sctx, start_us=start_us,
                                dur_us=dur_us, tags={"partition": pid},
                            )
                    for phase, ms in timing.items():
                        span.set_tag(phase, ms)
                if body.get("profile"):
                    prof = _profile_from_timing(timing or {})
                    prof["cache"] = cache_status
                    if timing is None and cache_status in (
                            "hit", "coalesced"):
                        # no engine work happened for THIS response;
                        # the zero-dispatch claim is explicit, not an
                        # absence the reader must infer
                        prof["dispatches"]["path"] = "cache_hit"
                    out["profile"] = prof
                if want_trace and timing is not None:
                    # _cached_search detaches timing from the shared
                    # payload; re-attach only when the client asked
                    out["timing"] = timing
                return out
        except RequestKilled as e:
            reason = ctx.reason_code or "operator"
            self._killed_total.inc(reason, space_lbl)
            # force-sample killed requests: even an untraced request
            # leaves a span in /debug/traces explaining the abort
            if span is NULL_SPAN:
                self.tracer.record(
                    "ps.search",
                    start_us=int((wall0 + t_start) * 1e6),
                    dur_us=int((time.monotonic() - t_start) * 1e6),
                    tags={"partition": pid, "request_id": rid,
                          "kill_reason": reason},
                    status="error: RequestKilled",
                )
            # terminal abort code — the router must NOT retry this as a
            # failover (the kill exists to shed this exact work)
            raise RpcError(ERR_REQUEST_KILLED,
                           f"request_killed: request {rid}: {e}") from e
        finally:
            _flightrec.reset_active_trace(_trace_token)
            accounting.reset_space(_space_token)
            # per-tenant billing: one logical request (the router's
            # duplicate hedge attempt meters separately so a won hedge
            # bills once), its query rows, and any abort
            self._accountant.charge(
                "hedge_extras" if hedge_extra else "requests", 1,
                space=space_key)
            self._accountant.charge("rows", qrows, space=space_key)
            if ctx.killed:
                self._accountant.charge("kills", 1, space=space_key)
            with self._inflight_lock:
                self._inflight.pop(token, None)
            gate.release()
            with self._stats_lock:
                self._op_inflight["search"] -= 1
            ms = (time.monotonic() - t_start) * 1e3
            self.latency_quantiles.observe((pid, "search"), ms)
            self.latency_quantiles.observe(("_node", "search"), ms)
            # lock-fix note: the EWMA read-modify-write was documented
            # as benignly racy, but a torn read-modify-write pair can
            # resurrect a stale latency forever — _stats_lock is cheap
            with self._stats_lock:
                prev = self._search_ewma.get(pid, ms)
                self._search_ewma[pid] = 0.8 * prev + 0.2 * ms
            if self.slowlog.should_log(ms, killed=ctx.killed):
                t = trace or {}
                self.slowlog.add({
                    "request_id": rid, "partition": pid, "op": "search",
                    "space": space_key,
                    "elapsed_ms": round(ms, 3),
                    "killed": ctx.killed, "reason": ctx.reason,
                    "phases": {k[:-len("_ms")]: v for k, v in t.items()
                               if k.endswith("_ms") and k != "stream_ms"},
                    "dispatches": t.get("dispatches"),
                    "trace_id": span.trace_id or None,
                })

    def _cached_search(self, eng, pid, applied, body, vectors, ctx,
                       trace):
        """Result-cache + single-flight wrapper around _do_search.

        Returns ``(out, cache_status, timing)``: `out` is a fresh
        top-level dict per caller (hit/coalesced responses share the
        row payload but never the envelope, so later mutation of one
        response cannot leak into another), `cache_status` is one of
        hit/miss/coalesced/bypass, and `timing` is the engine trace of
        the request that actually computed (None for hit/coalesced —
        they did no engine work to explain). A coalesced follower also
        counts a `miss` (it did miss the cache) plus `coalesced`.
        """
        from vearch_tpu_torch.cluster.querycache import canonical_query_key

        cacheable = (
            self.search_cache.max_entries > 0
            and body.get("cache", True) is not False
            and not body.get("raft_consistent")
            # trace:true promises a real phase/dispatch breakdown and
            # a replayed span tree — a hit has neither to offer;
            # profile:true is a measurement of the engine path, so
            # serving it a memoized envelope would be lying
            and not body.get("trace")
            and not body.get("profile")
        )
        if not cacheable:
            if body.get("cache", True) is False:
                self.search_cache.note("bypass")
            out = self._do_search(eng, body, vectors, ctx, trace)
            return out, "bypass", out.pop("timing", None)
        ckey = canonical_query_key(
            str(pid), vectors, int(body.get("k", 10)),
            {
                "filters": body.get("filters"),
                "include_fields": body.get("include_fields"),
                "columnar_wire": bool(body.get("columnar_wire")),
                "sort": body.get("sort"),
                "index_params": body.get("index_params"),
                "brute_force": bool(body.get("brute_force", False)),
                "score_bounds": body.get("score_bounds"),
                "field_weights": body.get("field_weights"),
            },
        )
        # raft apply index AND engine data version are part of the
        # key: any applied write bumps one of them, so every prior
        # entry for this partition becomes unreachable (exact
        # invalidation) and ages out of the LRU under pressure
        key = (pid, ckey, applied, eng.data_version)
        ent = self.search_cache.get(key)
        if ent is not None:
            return dict(ent), "hit", None

        def compute():
            out = self._do_search(eng, body, vectors, ctx, trace)
            timing = out.pop("timing", None)
            self.search_cache.put(key, out)
            return out, timing

        (out, timing), coalesced = self._search_flight.do(key, compute)
        if coalesced:
            self.search_cache.note("coalesced")
            return dict(out), "coalesced", None
        return dict(out), "miss", timing

    def _do_search(self, eng, body, vectors, ctx=None,
                   trace: dict | None = None) -> dict:
        columnar = bool(
            body.get("columnar_wire") and body.get("include_fields") == []
        )
        # raw_results skips the microbatcher, so only take the columnar
        # engine shape when the batch is big enough that per-item
        # shaping (not coalescing) is the cost that matters — small
        # concurrent queries keep micro-batching (review r5)
        first = next(iter(vectors.values())) if vectors else None
        rows = (first.shape[0] if first is not None and first.ndim > 1
                else 1)  # router ships [b, d]; a flat array is one query
        raw = columnar and rows >= 32
        req = SearchRequest(
            vectors=vectors,
            k=int(body.get("k", 10)),
            filters=body.get("filters"),
            include_fields=body.get("include_fields"),
            brute_force=bool(body.get("brute_force", False)),
            field_weights=body.get("field_weights") or {},
            index_params=body.get("index_params") or {},
            score_bounds={
                f: tuple(b) for f, b in body["score_bounds"].items()
            } if body.get("score_bounds") else None,
            sort=body.get("sort") or None,
            # columnar wire consumes the engine's columnar shape
            # directly — no per-item objects anywhere on the path
            raw_results=raw,
            trace=trace,
            ctx=ctx,
        )
        results = eng.search(req)
        # shadow recall sampling (docs/QUALITY.md): offer every served
        # row to the deterministic sampler BEFORE wire shaping, so what
        # gets scored is exactly what the client saw. Exact searches are
        # their own ground truth; sort reorders by non-score keys, so
        # recall-vs-score-truth would be meaningless for them. Hooked
        # here (not in _h_search) so cache hits/coalesced followers —
        # which re-serve an already-offered result — never double-count.
        if not req.brute_force and not body.get("sort"):
            try:
                from vearch_tpu_torch.engine.types import ColumnarSearchResults

                pid_q = int(body["partition_id"])
                self._quality.observe_search(
                    pid_q, self._space_key(pid_q), vectors,
                    int(body.get("k", 10)),
                    (results.keys
                     if isinstance(results, ColumnarSearchResults)
                     else results),
                    int(eng.data_version),
                    index_params=body.get("index_params") or {},
                    filters=body.get("filters"),
                    field_weights=body.get("field_weights") or {},
                )
            except Exception as e:  # sampling must never fail a search
                internal_error("ps.quality_sample", e)
        metric = eng.indexes[next(iter(vectors))].metric.value
        if columnar:
            from vearch_tpu_torch.engine.types import ColumnarSearchResults

            # fields-free searches ride columnar: keys as string lists,
            # scores as ONE ndarray over the binary tensor codec —
            # per-item JSON dicts for b=1024*k results were a measured
            # chunk of the e2e batch latency
            if isinstance(results, ColumnarSearchResults):
                out = {
                    "metric": metric,
                    "columnar": True,
                    "keys": results.keys,
                    "scores": np.asarray(results.scores, dtype=np.float32),  # lint: allow[host-sync] terminal result materialization for the wire codec
                }
            else:
                # engine fell back to the item shape (e.g. sort rode in)
                out = {
                    "metric": metric,
                    "columnar": True,
                    "keys": [[it.key for it in r.items] for r in results],
                    "scores": np.asarray(  # lint: allow[host-sync] terminal result materialization for the wire codec
                        [it.score for r in results for it in r.items],
                        dtype=np.float32,
                    ),
                }
        else:
            out = {
                "metric": metric,
                "results": [
                    [
                        {"_id": it.key, "_score": it.score,
                         **({"_sort": it.sort_values}
                            if it.sort_values is not None else {}),
                         **it.fields}
                        for it in r.items
                    ]
                    for r in results
                ],
            }
        if trace is not None:
            out["timing"] = trace
        return out

    def _h_query(self, body: dict, _parts) -> dict:
        eng = self._engine(body["partition_id"])
        self._check_read_consistency(body)
        vv = bool(body.get("vector_value", False))
        if body.get("document_ids"):
            docs = eng.get(body["document_ids"], body.get("fields"), vv)
        else:
            docs = eng.query(
                body.get("filters"),
                limit=int(body.get("limit", 50)),
                offset=int(body.get("offset", 0)),
                include_fields=body.get("fields"),
                vector_value=vv,
                sort=body.get("sort") or None,
            )
        return {"documents": docs}

    def _h_build(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        eng = self._engine(pid)
        if body.get("background"):
            # observable job mode: return immediately, progress and the
            # terminal state are readable at GET /ps/jobs
            threading.Thread(
                target=self._run_build, args=(pid, eng, False),
                daemon=True, name=f"build-p{pid}",
            ).start()
            return {"partition_id": pid, "status": int(eng.status),
                    "background": True}
        self._run_build(pid, eng, False)
        return {"status": int(eng.status)}

    def _run_build(self, pid: int, eng: Engine, rebuild: bool) -> None:
        """Run a build/rebuild and replay its phase windows (train /
        assign / publish / warmup) as spans, so /debug/traces shows the
        job next to the searches it competed with."""
        job = None
        try:
            # index (re)builds legitimately compile: train/assign/
            # publish kernels plus the post-publish warmup pass all
            # specialize here, none of it is a serving-path regression
            with self.flight_recorder.warmup():
                if rebuild:
                    eng.rebuild_index()
                else:
                    eng.build_index()
            # estimator staleness (lint VL105): the serving snapshot
            # just changed under any queued shadow samples
            self._quality.note_index_mutation(
                pid, self._space_key(pid),
                op="rebuild" if rebuild else "build")
        finally:
            job = eng.build_job
            if job is not None:
                op = str(job.get("op", "build"))
                for name, start_us, dur_us in job.get("_phase_spans") or []:
                    tags = {"partition": pid, "op": op}
                    if name == "build.train" and job.get("train_mesh"):
                        # mesh-sharded k-means ran: record the build-time
                        # mesh shape so traces tell sharded trains from
                        # single-device ones
                        tags["train_mesh"] = str(job["train_mesh"])
                    self.tracer.record(
                        name, start_us=start_us, dur_us=dur_us, tags=tags,
                    )

    def _h_jobs(self, _body, _parts) -> dict:
        """Background-job registry: index builds, partition splits, and
        synthesized learner-catchup entries (one per partition this node
        leads that is streaming a raft learner up to date). Internal
        keys (`_phase_spans`, the split mirror queue) are stripped."""
        jobs = []
        for pid, eng in sorted(self.engines.items()):
            job = eng.build_job
            if job is None:
                continue
            jobs.append({
                "partition_id": pid,
                **{k: v for k, v in job.items() if not k.startswith("_")},
            })
        with self._split_lock:
            for pid in sorted(self._split_jobs):
                jobs.append(self._split_public(self._split_jobs[pid]))
        # learner catch-up is raft state, not a registry entry — shape
        # it like a job so one /ps/jobs poll shows every phase of a
        # migration (reference: the master's job rollup reads this)
        for pid, node in sorted(self.raft_nodes.items()):
            if not node.is_leader or not node.learners:
                continue
            st = node.state()
            for learner in node.learners:
                info = st["peers"].get(str(learner))
                if info is None:
                    continue
                jobs.append({
                    "op": "learner_catchup", "partition_id": pid,
                    "status": "running" if info["lag"] else "caught_up",
                    "learner": learner, "lag": info["lag"],
                    "next": info["next"],
                })
        return {"jobs": jobs}

    def _h_slowlog(self, _body, _parts) -> dict:
        return {"threshold_ms": self.slowlog.threshold_ms,
                "entries": self.slowlog.entries()}

    def _h_compiles(self, _body, _parts) -> dict:
        """GET /debug/compiles — the compile-audit flight recorder's
        view: every post-warmup serving-path compilation with its shape
        signature, wall time, and originating trace id."""
        rec = self.flight_recorder
        return {
            "total": rec.total(),
            "counts": rec.counts(),
            "warmup_compiles": rec.warmup_compiles,
            "events": rec.events(),
        }

    def _h_compiles_reset(self, _body, _parts) -> dict:
        """POST /debug/compiles/reset — operator marks 'warmed now':
        after deliberate warmup traffic, zero the recorder so the
        doctor's post-warmup invariant measures only what follows."""
        before = self.flight_recorder.total()
        self.flight_recorder.reset()
        return {"reset": True, "dropped_events": before}

    def _model_device_bytes(self) -> int:
        """Footprint-model side of the drift gauge: modeled per-device
        resident bytes summed over hosted engines' indexes."""
        total = 0
        for eng in list(self.engines.values()):
            for idx in list(getattr(eng, "indexes", {}).values()):
                try:
                    total += int(idx.device_footprint_per_device_bytes())
                except Exception:
                    continue
        return total

    def _space_device_bytes(self) -> dict[str, int]:
        """Per-space split of :meth:`_model_device_bytes` — the same
        engines grouped by owning space, so the values sum to the node
        total exactly (partitions without a known space accrue to the
        `_system` bucket, keeping the conservation identity)."""
        out: dict[str, int] = {}
        for pid, eng in list(self.engines.items()):
            sp = self._space_key(pid)
            n = 0
            for idx in list(getattr(eng, "indexes", {}).values()):
                try:
                    n += int(idx.device_footprint_per_device_bytes())
                except Exception:
                    continue
            out[sp] = out.get(sp, 0) + n
        return out

    def _space_hbm_labelled(self) -> dict[tuple[str, ...], float]:
        """vearch_space_hbm_bytes callback: the per-space residency
        split collapsed under the accountant's top-K label policy."""
        out: dict[tuple[str, ...], float] = {}
        for sp, n in self._space_device_bytes().items():
            key = (self._accountant.label(sp),)
            out[key] = out.get(key, 0.0) + float(n)
        return out

    # -- online partition split (elastic data plane) -------------------------
    #
    # The master drives the lifecycle against the parent's leader:
    #   start -> poll progress until phase=cutover_ready -> flip the
    #   space's partition map (metastore) -> finish{commit} -> delete
    #   the parent everywhere (which finalizes the job here).
    #
    # Correctness contract: from the moment the job enters the sync
    # window, every write the parent acknowledges blocks until the
    # children hold it too (double-write), so cutover_ready means the
    # children are a superset-in-time of the parent. The parent KEEPS
    # sync-mirroring after commit until it is deleted — a router on a
    # stale map may still write through it during the flip window.

    def _count_op(self, pid: int, kind: str) -> None:
        with self._stats_lock:
            c = self._op_counts.setdefault(pid, {"searches": 0,
                                                 "writes": 0})
            c[kind] = c.get(kind, 0) + 1

    def _map_version(self, pid: int) -> int:
        part = self.partitions.get(int(pid))
        return int(getattr(part, "map_version", 0) or 0) \
            if part is not None else 0

    def _split_public(self, job: dict) -> dict:
        """Operator view of a split job: internal keys stripped, queue
        depth surfaced. Callers hold _split_lock."""
        out = {k: v for k, v in job.items() if not k.startswith("_")}
        out["queue"] = len(job["_queue"])
        return out

    def _h_split_start(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        self._engine(pid)
        node = self._node(pid)
        if not node.is_leader:
            raise RpcError(421, f"partition {pid}: split must start on "
                                f"the leader")
        children = [
            {"id": int(c["id"]), "slot_lo": int(c["slot_lo"]),
             "slot_hi": int(c["slot_hi"]), "leader": int(c["leader"])}
            for c in body["children"]
        ]
        if len(children) != 2:
            raise RpcError(400, "split takes exactly two children")
        with self._split_lock:
            existing = self._split_jobs.get(pid)
            if existing is not None and existing["status"] == "running":
                raise RpcError(
                    409, f"split already running for partition {pid}")
            job = {
                "op": "split", "status": "running", "phase": "copy",
                "partition_id": pid, "children": children,
                "docs_total": 0, "docs_done": 0, "mirrored": 0,
                "started": time.time(),  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
                "updated": time.time(),  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
                "phases_ms": {}, "error": None,
                "_queue": deque(), "_sync": False, "_finish": None,
                "_teardown": False,
            }
            self._split_jobs[pid] = job
        threading.Thread(target=self._run_split, args=(pid, job),
                         daemon=True, name=f"split-p{pid}").start()
        return {"partition_id": pid, "status": "running",
                "children": [c["id"] for c in children]}

    def _h_split_progress(self, body, _parts) -> dict:
        q = ((body or {}).get("_query") or {})
        pid = int(q.get("partition_id")
                  or (body or {}).get("partition_id"))
        with self._split_lock:
            job = self._split_jobs.get(pid)
            if job is None:
                raise RpcError(404, f"no split job for partition {pid}")
            return self._split_public(job)

    def _h_split_finish(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        commit = bool(body.get("commit", True))
        with self._split_lock:
            job = self._split_jobs.get(pid)
            if job is None:
                raise RpcError(404, f"no split job for partition {pid}")
            if job["status"] == "running" and job["_finish"] is None:
                if commit and job["phase"] != "cutover_ready":
                    raise RpcError(
                        409, f"split for partition {pid} is not "
                             f"cutover-ready (phase {job['phase']})")
                job["_finish"] = "commit" if commit else "abort"
                self._split_cv.notify_all()
        if commit:
            # cutover moves the space's rows to the children: the
            # parent's accumulated recall stream no longer describes
            # what the space serves (staleness hook, lint VL105)
            self._quality.note_index_mutation(
                pid, self._space_key(pid), op="split")
        # wait for the worker to acknowledge: commit -> phase
        # "committed" (mirror stays open until the parent is deleted);
        # abort -> terminal status
        deadline = time.monotonic() + 30.0  # bounded RPC, not a job clock
        while time.monotonic() < deadline:
            with self._split_lock:
                if ((commit and job["phase"] == "committed")
                        or job["status"] != "running"):
                    return self._split_public(job)
            time.sleep(0.02)
        with self._split_lock:
            return self._split_public(job)

    def _split_teardown(self, pid: int) -> None:
        """Called by partition delete BEFORE the engine goes away: tell
        the worker the parent is being removed and wait for it to drain
        the mirror queue (acked writes must reach the children while
        the parent engine can still be read)."""
        with self._split_lock:
            job = self._split_jobs.get(pid)
            if job is None or job["status"] != "running":
                return
            job["_teardown"] = True
            self._split_cv.notify_all()
        deadline = time.monotonic() + 15.0  # bounded wait, not a job clock
        while time.monotonic() < deadline:
            with self._split_lock:
                if job["status"] != "running":
                    return
            time.sleep(0.02)

    def _split_mirror(self, pid: int, kind: str,
                      keys: list[str]) -> None:
        """Hand a just-committed write's keys to the active split's
        mirror worker. Pre-sync phases enqueue asynchronously (the
        worker drains between copy batches); in the sync/cutover window
        the caller blocks until the entry is forwarded, so the ack the
        client sees implies the children hold the write."""
        ev = None
        with self._split_lock:
            job = self._split_jobs.get(pid)
            if job is None or job["status"] != "running":
                return
            if job["_sync"]:
                ev = threading.Event()
            job["_queue"].append((kind, list(keys), ev))
            self._split_cv.notify_all()
        if ev is not None and not ev.wait(timeout=30.0):
            raise RpcError(
                503, f"partition {pid}: split mirror stalled; write is "
                     f"committed here but not yet on the children — retry")

    def _run_split(self, pid: int, job: dict) -> None:
        t0 = time.monotonic()
        # wall anchor for span epochs; measurement stays monotonic
        wall0 = time.time() - t0  # lint: allow[wall-clock] span epoch anchor, correlates with collector time
        state = {"phase": "copy", "t": t0}

        def enter_phase(name: str) -> None:
            now = time.monotonic()
            prev, t_prev = state["phase"], state["t"]
            self.tracer.record(
                f"split.{prev}",
                start_us=int((wall0 + t_prev) * 1e6),
                dur_us=int((now - t_prev) * 1e6),
                tags={"partition": pid},
            )
            with self._split_lock:
                job["phases_ms"][prev] = round((now - t_prev) * 1e3, 3)
                if name is not None:
                    job["phase"] = name
                job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            state["phase"], state["t"] = name, now

        err: str | None = None
        try:
            eng = self._engine(pid)
            node = self._node(pid)
            # copy: one key snapshot, then batched re-read + forward.
            # Keys only — the docs are re-read at forward time, so a
            # doc updated after the snapshot forwards its LATEST state
            keys = [d["_id"] for d in eng.query(
                None, limit=max(eng.doc_count * 2, 1024),
                include_fields=[], order_by_key=False)]
            with self._split_lock:
                job["docs_total"] = len(keys)
            for i in range(0, len(keys), SPLIT_COPY_BATCH):
                self._split_check_live(pid, job, node)
                self._split_forward(pid, job, "copy",
                                    keys[i:i + SPLIT_COPY_BATCH])
                with self._split_lock:
                    job["docs_done"] = min(i + SPLIT_COPY_BATCH,
                                           len(keys))
                    job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
                # drain concurrent-write mirror entries between batches
                # so the queue stays bounded during a long copy; bounded
                # by the backlog at entry — steady writers refill the
                # queue as fast as we forward, so drain-to-empty would
                # never return (only the sync window's per-write
                # blocking can actually beat a sustained write rate)
                self._split_drain(pid, job, node, block_s=0.0,
                                  max_n=self._split_backlog(job))
            enter_phase("catchup")
            self._split_drain(pid, job, node, block_s=0.0,
                              max_n=self._split_backlog(job))
            # sync window opens: from here every acked write blocks on
            # its own mirror forward; draining the backlog once more
            # makes the children a superset-in-time of the parent
            with self._split_lock:
                job["_sync"] = True
            enter_phase("sync")
            self._split_drain(pid, job, node, block_s=0.0)
            enter_phase("cutover_ready")
            # hold the double-write open until the master commits (the
            # parent's deletion finalizes the job) or aborts (children
            # are garbage-collected by the master)
            while True:
                with self._split_lock:
                    fin = job["_finish"]
                    teardown = job["_teardown"]
                if fin == "abort":
                    raise _SplitAborted("aborted by master")
                if fin == "commit" and state["phase"] == "cutover_ready":
                    enter_phase("committed")
                if teardown or self.engines.get(pid) is None:
                    self._split_drain(pid, job, node, block_s=0.0)
                    if state["phase"] == "committed":
                        break  # normal finalization: parent retired
                    raise _SplitAborted("parent partition removed")
                if self._stop.is_set():
                    raise _SplitAborted("partition server stopping")
                if not node.is_leader:
                    raise _SplitAborted("lost leadership")
                self._split_drain(pid, job, node, block_s=0.25)
        except _SplitAborted as e:
            err = str(e)
        except RpcError as e:
            err = f"rpc {e.code}: {e}"
        except Exception as e:  # job must land terminal, never wedge
            internal_error("ps.split", e)
            err = f"{type(e).__name__}: {e}"
        finally:
            enter_phase(None)  # close the last phase span/window
            with self._split_lock:
                job["status"] = "done" if err is None else "error"
                job["error"] = err
                job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
                # wake every writer still blocked on a sync mirror:
                # their entries are committed on the parent; on abort
                # the children are garbage-collected anyway
                for _, _, ev in job["_queue"]:
                    if ev is not None:
                        ev.set()
                job["_queue"].clear()
                self._split_cv.notify_all()

    def _split_check_live(self, pid: int, job: dict, node) -> None:
        if self._stop.is_set():
            raise _SplitAborted("partition server stopping")
        if self.engines.get(pid) is None:
            raise _SplitAborted("parent partition removed")
        if not node.is_leader:
            raise _SplitAborted("lost leadership")
        with self._split_lock:
            if job["_finish"] == "abort":
                raise _SplitAborted("aborted by master")

    def _split_backlog(self, job: dict) -> int:
        with self._split_lock:
            return len(job["_queue"])

    def _split_drain(self, pid: int, job: dict, node,
                     block_s: float, max_n: int | None = None) -> int:
        """Forward queued mirror entries FIFO. With block_s > 0, waits
        up to that long for a first entry (cutover idle loop); with 0,
        drains whatever is queued and returns. `max_n` bounds the pass
        (pre-sync callers: sustained writers refill as fast as we
        forward, so drain-to-empty would not terminate — once _sync is
        on, writers block per entry and the queue drains for real).
        Entries are popped under _split_lock but forwarded outside it —
        a slow child RPC must not block the write handlers enqueueing
        behind us."""
        n = 0
        while max_n is None or n < max_n:
            with self._split_lock:
                if not job["_queue"] and n == 0 and block_s > 0:
                    self._split_cv.wait(timeout=block_s)
                if not job["_queue"]:
                    return n
                kind, keys, ev = job["_queue"].popleft()
            try:
                self._split_forward(pid, job, kind, keys)
            finally:
                if ev is not None:
                    ev.set()
            with self._split_lock:
                job["mirrored"] += 1
                job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            n += 1

    def _split_forward(self, pid: int, job: dict, kind: str,
                       keys: list[str]) -> None:
        """Route keys to their child by hash slot and forward. Upserts
        RE-READ the parent engine at forward time rather than carrying
        a payload from enqueue: the queue is FIFO per key, so the last
        forward for any key ships the parent's current row (or, for a
        key deleted meanwhile, skips it and lets the queued delete do
        the removal) — re-reading makes reordering impossible by
        construction."""
        from vearch_tpu_torch.cluster.hashing import key_slot

        children = job["children"]

        def child_of(key: str) -> dict:
            slot = key_slot(str(key))
            for c in children:
                if c["slot_lo"] <= slot < c["slot_hi"]:
                    return c
            # the two ranges partition the parent's range; a slot
            # outside both means the caller routed a foreign key here
            raise RpcError(
                500, f"split: key {key!r} (slot {slot}) outside both "
                     f"child ranges of partition {pid}")

        if kind == "delete":
            by_child: dict[int, list[str]] = {}
            for k in keys:
                by_child.setdefault(child_of(k)["id"], []).append(k)
            for c in children:
                ks = by_child.get(c["id"])
                if ks:
                    self._split_rpc(c, "/ps/doc/delete",
                                    {"partition_id": c["id"],
                                     "keys": ks})
            return
        eng = self._engine(pid)
        docs = eng.get(keys, None, vector_value=True)
        by_pid: dict[int, list[dict]] = {}
        for d in docs:
            by_pid.setdefault(child_of(str(d["_id"]))["id"], []).append(d)
        for c in children:
            ds = by_pid.get(c["id"])
            if ds:
                self._split_rpc(c, "/ps/doc/upsert",
                                {"partition_id": c["id"],
                                 "documents": ds})

    def _split_rpc(self, child: dict, path: str, body: dict) -> dict:
        """Forward to a child's leader with bounded retries. 400/404
        are structural (bad payload / child gone — the chaos case) and
        fail fast so the master can garbage-collect; transient codes
        retry with a fresh address in case the child's PS moved."""
        last: RpcError | None = None
        for attempt in range(3):
            try:
                addr = (self.addr if child["leader"] == self.node_id
                        else self._peer_addr(child["leader"]))
                return rpc.call(addr, "POST", path, body, timeout=30.0)
            except RpcError as e:
                last = e
                if e.code in (400, 404):
                    break
                time.sleep(0.2 * (attempt + 1))
        raise RpcError(
            503, f"split forward to child {child['id']} failed: {last}")

    def _h_field_index(self, body: dict, _parts) -> dict:
        """Master fan-out target for online scalar field-index add/remove
        (reference: gammacb/gamma.go:538,591 — the PS seam that hands
        AddFieldIndex/RemoveFieldIndex to the engine)."""
        eng = self._engine(body["partition_id"])
        itype = str(body.get("index_type", "INVERTED")).upper()
        if itype == "NONE":
            eng.remove_field_index(body["field"])
        else:
            eng.add_field_index(
                body["field"], itype,
                background=bool(body.get("background", True)),
            )
        return {"field": body["field"], "index_type": itype}

    def _h_schema_field(self, body: dict, _parts) -> dict:
        """Master fan-out target for online scalar-field addition
        (reference: updateSpaceFields -> engine schema update)."""
        from vearch_tpu_torch.engine.types import FieldSchema

        eng = self._engine(body["partition_id"])
        added = []
        for d in body.get("fields", []):
            f = FieldSchema.from_dict(d)
            try:
                eng.add_schema_field(f)
            except ValueError as e:
                raise RpcError(400, str(e)) from None
            added.append(f.name)
        return {"added": added}

    def _h_rebuild(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        eng = self._engine(pid)
        if body.get("background"):
            threading.Thread(
                target=self._run_build, args=(pid, eng, True),
                daemon=True, name=f"rebuild-p{pid}",
            ).start()
            return {"partition_id": pid, "status": int(eng.status),
                    "background": True}
        self._run_build(pid, eng, True)
        return {"status": int(eng.status)}

    def _h_flush(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        applied = self.flush_partition(pid)
        return {"doc_count": self._engine(pid).doc_count,
                "applied": applied}

    def _h_engine_config(self, body: dict, _parts) -> dict:
        cfg = body.get("config") or {}
        if "log_level" in cfg:
            # validate before mutating ANY key — a bad level must not
            # leave the handler half-applied
            try:
                log.parse_level(str(cfg["log_level"]))
            except ValueError as e:
                raise RpcError(400, str(e)) from None
        if "memory_limit_mb" in cfg:
            self.memory_limit_mb = int(cfg["memory_limit_mb"])
        if "slow_request_ms" in cfg:
            # reference: slow_search_time runtime config -> slow killer
            self.slow_request_ms = int(cfg["slow_request_ms"])
        if "slow_route_ms" in cfg:
            # reference: slow-channel isolation threshold (ps/server.go:95)
            self.slow_route_ms = int(cfg["slow_route_ms"])
        if "slow_log_ms" in cfg:
            # slow-query log capture threshold (<=0 disables); killed
            # requests are force-logged regardless
            self.slowlog.threshold_ms = float(cfg["slow_log_ms"])
        if "request_deadline_ms" in cfg:
            # default per-request deadline; a search's own deadline_ms
            # option overrides it per request
            self.request_deadline_ms = int(cfg["request_deadline_ms"])
        if "search_cache_entries" in cfg:
            # runtime-resizable result cache; 0 disables AND drops the
            # live entries (an operator turning the cache off expects
            # no further hits, not a slow drain)
            n = int(cfg["search_cache_entries"])
            self.search_cache.max_entries = n
            if n <= 0:
                self.search_cache.clear()
        if "admission_queue_limit" in cfg:
            # runtime-tunable shed bound; 0 disables shedding
            n = int(cfg["admission_queue_limit"])
            if n < 0:
                raise RpcError(400,
                               "admission_queue_limit must be >= 0")
            self._admission.queue_limit = n
        if "debug_search_delay_ms" in cfg:
            # fault injection (tail-latency tests/bench): per-search
            # killable sleep before any engine work
            self.debug_search_delay_ms = int(cfg["debug_search_delay_ms"])
        if "quality" in cfg:
            # shadow-sampling knobs (docs/QUALITY.md): sample_rate,
            # decay, min_samples, health cadence + drift thresholds
            q = dict(cfg["quality"] or {})
            if "sample_rate" in q and not (
                    0.0 <= float(q["sample_rate"]) <= 1.0):
                raise RpcError(400,
                               "quality.sample_rate must be in [0, 1]")
            self._quality.configure(**q)
        if "log_level" in cfg:
            # runtime log-level flip, fanned out by the master's /config
            # (reference: log-level runtime config in pkg/log)
            log.set_level(str(cfg["log_level"]))
        eng = self._engine(body["partition_id"])
        return eng.apply_config(cfg)

    # -- backup/restore (reference: ps/backup/ps_backup_service.go:77
    #    PSShardManager — shard dump streamed to object storage) -------------

    def _backup_store(self, body: dict):
        """Resolve the object store from the request: legacy store_root
        strings stay local-filesystem; a `store` spec may select s3
        (reference: minio client configured from master config). The
        operator allowlists gate BOTH destination types."""
        from vearch_tpu_torch.cluster.objectstore import is_within, make_object_store

        confined = (self.backup_roots is not None
                    or self.backup_endpoints is not None)
        spec = body.get("store") or body["store_root"]
        if isinstance(spec, str) or spec.get("type", "local") == "local":
            root = spec if isinstance(spec, str) else spec["root"]
            if confined and not any(
                is_within(allowed, root)
                for allowed in (self.backup_roots or [])
            ):
                raise RpcError(403, f"store_root {root!r} not in the "
                                    f"operator backup_roots allowlist")
        else:
            from vearch_tpu_torch.cluster.objectstore import s3_endpoint_host

            host = s3_endpoint_host(str(spec.get("endpoint", "")))
            allowed = {s3_endpoint_host(e)
                       for e in (self.backup_endpoints or [])}
            if confined and host not in allowed:
                raise RpcError(
                    403, f"s3 endpoint {host!r} not in the operator "
                         f"backup_endpoints allowlist"
                )
        return make_object_store(spec)

    def _h_backup(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        self._engine(pid)  # partition must exist before we accept a job
        store = self._backup_store(body)
        job_id = body.get("job_id")
        if job_id is None:
            # synchronous shard backup (original path; the master's
            # async create passes a job_id instead)
            return self._run_shard_backup(pid, store, body, None)
        # async shard backup with progress (reference: PSShardManager
        # jobs, ps/backup/ps_backup_service.go:77,113 — the shard
        # manager tracks per-shard state the progress route reports)
        job = {"job_id": job_id, "partition_id": pid, "status": "dumping",
               "files_done": 0, "files_total": None,
               "started": time.time(),  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
               "updated": time.time(),  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
               "result": None, "error": None}
        from vearch_tpu_torch.utils import prune_job_registry

        with self._backup_jobs_lock:
            jobs = self._backup_jobs
            if job_id in jobs and jobs[job_id]["status"] in (
                    "dumping", "uploading"):
                raise RpcError(409, f"backup job {job_id} already running")
            jobs[job_id] = job
            prune_job_registry(jobs)

        def run():
            try:
                out = self._run_shard_backup(pid, store, body, job)
                job.update(status="done", result=out,
                           updated=time.time())  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            except Exception as e:
                job.update(status="error", error=f"{type(e).__name__}: {e}",
                           updated=time.time())  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally

        threading.Thread(target=run, daemon=True,
                         name=f"backup-{job_id}").start()
        return {"partition_id": pid, "job_id": job_id, "status": "dumping"}

    def _run_shard_backup(self, pid: int, store, body: dict,
                          job: dict | None) -> dict:
        import tempfile

        eng = self._engine(pid)

        def progress(done_files: int, total: int) -> None:
            if job is not None:
                job.update(status="uploading", files_done=done_files,
                           files_total=total,
                           updated=time.time())  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally

        with tempfile.TemporaryDirectory() as tmp:
            eng.dump(tmp)
            if body.get("pool_prefix"):
                # content-addressed dedup across versions (reference:
                # ref_count_manager.go ref-counted shard files)
                out = store.put_tree_dedup(
                    body["key_prefix"], tmp, body["pool_prefix"],
                    progress=progress,
                )
                return {"partition_id": pid, **out}
            n = store.put_tree(body["key_prefix"], tmp, progress=progress)
        return {"partition_id": pid, "files": n}

    def _h_backup_progress(self, body: dict, _parts) -> dict:
        """Per-shard job state (reference: PS backup progress route,
        ps_backup_service.go:180)."""
        job_id = ((body or {}).get("_query") or {}).get("job_id") \
            or (body or {}).get("job_id")
        with self._backup_jobs_lock:
            if job_id:
                job = self._backup_jobs.get(str(job_id))
                if job is None:
                    raise RpcError(404, f"no backup job {job_id}")
                return dict(job)
            return {"jobs": [dict(j) for j in self._backup_jobs.values()]}

    def _h_restore(self, body: dict, _parts) -> dict:
        pid = int(body["partition_id"])
        eng = self._engine(pid)  # partition must exist (space created first)
        node = self._node(pid)
        store = self._backup_store(body)
        import tempfile

        data_dir = os.path.join(self.data_dir, f"partition_{pid}")
        # download + CRC-verify into a staging dir FIRST: a network
        # failure or integrity error must leave the live partition
        # untouched, not bricked with a wiped directory. Unique staging
        # per call + the flush lock serialise concurrent restores (and
        # keep the flush job from interleaving writes during the swap).
        stage = tempfile.mkdtemp(prefix=f"partition_{pid}.restore.",
                                 dir=self.data_dir)
        try:
            if body.get("pool_prefix"):
                n = store.get_tree_dedup(
                    body["key_prefix"], stage, body["pool_prefix"]
                )
            else:
                n = store.get_tree(body["key_prefix"], stage)
            with self._flush_lock(pid), \
                    node._apply_lock:
                old_version = int(eng.data_version)
                eng.close()
                for name in list(os.listdir(data_dir)):
                    if name in ("raft", "partition.json"):
                        continue
                    p = os.path.join(data_dir, name)
                    shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
                for name in os.listdir(stage):
                    os.replace(os.path.join(stage, name),
                               os.path.join(data_dir, name))
                with self.flight_recorder.warmup():
                    restored = Engine.open(data_dir, device=self.device)
                # restore is a data rewrite the version counters must
                # not hide: a fresh Engine.open restarts data_version
                # at/below the pre-restore value, which would leave
                # version-exact cache keys (PS search cache) and the
                # router's apply-version validity maps believing their
                # pre-restore entries still describe this partition.
                # Force it strictly past everything ever served.
                restored.data_version = (
                    max(int(restored.data_version), old_version) + 1
                )
                restored.start_refresh_loop()
                self._wire_engine(pid, restored)
                with self._lock:
                    self.engines[pid] = restored
                with self._stats_lock:
                    self._mem_dirty = True
                # the restore rewrote the corpus AND the quantizers:
                # reset recall estimators + the train-time recon
                # baseline (staleness hook, lint VL105)
                self._quality.note_index_mutation(
                    pid, self._space_key(pid), op="restore")
                # restored state supersedes the log: reset it at the
                # current applied horizon (a point-in-time rewind).
                # last_term is the term AT last_index, so the horizon
                # stays term-verifiable for subsequent appends
                horizon_term = node.wal.term_at(node.wal.last_index)
                node.wal.reset(node.wal.last_index + 1,
                               horizon_term=horizon_term)
                # lock-fix note: applied is raft-lock-guarded; the old
                # bare write raced the apply loop's applied+1 read
                with node._lock:
                    node.applied = node.wal.last_index
                    node.wal.commit_index = node.wal.last_index
                node.wal.save_meta(fsync=True)
        finally:
            shutil.rmtree(stage, ignore_errors=True)
        return {"partition_id": pid, "files": n,
                "doc_count": restored.doc_count}

    def _h_stats(self, _body, _parts) -> dict:
        with self._stats_lock:
            op_load = {
                "queue_depth": dict(self._op_waiting),
                "inflight": dict(self._op_inflight),
            }
        return {
            "node_id": self.node_id,
            "replication_errors": self.replication_errors,
            "killed_requests": self.killed_requests,
            "slow_routed": self.slow_routed,
            "search_cache": {
                "entries": len(self.search_cache),
                **self.search_cache.stats,
            },
            # runtime truth: last device sample (live HBM, h2d bytes,
            # compiled-program count, footprint-model drift verdict)
            "device_sampler": self.device_sampler.snapshot(),
            # per-(partition, op) streaming tail quantiles; "_node" is
            # the node-level sketch the Prometheus gauge renders
            "latency_quantiles": {
                f"{key[0]}/{key[1]}": rec
                for key, rec in self.latency_quantiles.snapshot().items()
            },
            "op_load": op_load,
            # admission-control counters (sheds, waiters, limit) — the
            # doctor's shed-rate check reads these
            "admission": self._admission.snapshot(),
            # search-quality truth layer: shadow-sampling counters,
            # per-space recall/RBO estimators + floors, index-health
            # drift — the doctor's search_quality check reads this
            "quality": self._quality.stats(),
            # per-tenant cost meters (exact keys, never label-collapsed)
            # + this node's per-space HBM residency split — the same
            # block the heartbeat carries (docs/ACCOUNTING.md)
            "usage": self._usage_summary(),
            # snapshot under no lock: stale reads are fine for stats
            "search_ewma_ms": {
                str(pid): round(ms, 2)
                for pid, ms in dict(self._search_ewma).items()
            },
            "partitions": {
                str(pid): {
                    "doc_count": eng.doc_count,
                    "status": int(eng.status),
                    "memory_bytes": eng.memory_usage_bytes(),
                    "micro_batches": (
                        mb.batches if (mb := eng._microbatcher) is not None
                        else 0
                    ),
                    "micro_batched_requests": (
                        mb.batched_requests if mb is not None else 0
                    ),
                    # continuous-batching scheduler: bucket occupancy,
                    # dispatch mix, padding waste — the doctor's
                    # batch_padding_waste check reads this block
                    "scheduler": self._scheduler_info_safe(eng),
                    "raft": self.raft_nodes[pid].state()
                    if pid in self.raft_nodes else None,
                    "mesh": self._mesh_info_safe(eng),
                    # tiered storage (HBM slab cache / host-RAM tiers /
                    # prefetch) — the doctor's prefetch-effectiveness
                    # check reads these blocks
                    "tiering": self._tiering_info_safe(eng),
                }
                for pid, eng in self.engines.items()
            },
        }

    @staticmethod
    def _mesh_info_safe(eng) -> dict | None:
        try:
            return eng.mesh_info()
        except Exception:
            return None

    @staticmethod
    def _tiering_info_safe(eng) -> dict | None:
        try:
            return eng.tiering_info()
        except Exception:
            return None

    @staticmethod
    def _scheduler_info_safe(eng) -> dict | None:
        try:
            mb = eng._microbatcher
            if mb is None:
                return None
            info = mb.stats()
            real = int(getattr(eng, "pad_real_rows", 0))
            padded = int(getattr(eng, "pad_padded_rows", 0))
            info["pad_real_rows"] = real
            info["pad_padded_rows"] = padded
            info["pad_waste_bytes"] = int(getattr(eng, "pad_waste_bytes", 0))
            info["padding_waste_pct"] = round(
                100.0 * max(padded - real, 0) / max(padded, 1), 2
            )
            return info
        except Exception:
            return None

    # fixed (tier, event) label universe for vearch_ps_tier_events_total
    # — rendered zero-filled every scrape so the cardinality soak sees
    # no series growth as disk tiers warm up
    _TIER_EVENT_KEYS = (
        ("hbm", "hit"), ("hbm", "miss"), ("hbm", "eviction"),
        ("hbm", "pin_hit"), ("hbm", "prefetch_hit"), ("hbm", "prefetched"),
        ("ram", "hit"), ("ram", "miss"), ("ram", "eviction"),
        ("ram", "admitted"), ("ram", "rejected"),
        ("row", "hit"), ("row", "miss"), ("row", "eviction"),
        ("row", "admitted"), ("row", "rejected"),
        ("prefetch", "submitted"), ("prefetch", "completed"),
        ("prefetch", "dropped"), ("prefetch", "error"),
    )
    _CACHE_EVENT_MAP = (
        ("hits", "hit"), ("misses", "miss"), ("evictions", "eviction"),
        ("admitted", "admitted"), ("rejected", "rejected"),
    )

    def _tier_snapshot(self) -> tuple[dict, dict]:
        """(events, resident-bytes) label maps for the tier metrics
        callbacks, summed across hosted engines."""
        events = {k: 0.0 for k in self._TIER_EVENT_KEYS}
        resident = {("hbm",): 0.0, ("ram",): 0.0, ("row",): 0.0}

        def bump(tier: str, stats: dict, mapping) -> None:
            for src, dst in mapping:
                events[(tier, dst)] += float(stats.get(src, 0))

        for eng in list(self.engines.values()):
            info = self._tiering_info_safe(eng)
            if not info:
                continue
            for f in (info.get("fields") or {}).values():
                hbm = f.get("hbm") or {}
                bump("hbm", hbm, (
                    ("hits", "hit"), ("misses", "miss"),
                    ("evictions", "eviction"), ("pin_hits", "pin_hit"),
                    ("prefetch_hits", "prefetch_hit"),
                    ("prefetched", "prefetched"),
                ))
                resident[("hbm",)] += float(hbm.get("resident_bytes", 0))
                ram = f.get("ram") or {}
                bump("ram", ram, self._CACHE_EVENT_MAP)
                resident[("ram",)] += float(ram.get("resident_bytes", 0))
                row = f.get("row_cache") or {}
                bump("row", row, self._CACHE_EVENT_MAP)
                resident[("row",)] += float(row.get("resident_bytes", 0))
                pf = f.get("prefetch") or {}
                bump("prefetch", pf, (
                    ("submitted", "submitted"), ("completed", "completed"),
                    ("dropped", "dropped"), ("errors", "error"),
                ))
        return events, resident
