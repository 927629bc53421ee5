"""Per-partition engine, the port of vearch_tpu/engine/engine.py: table +
raw vector stores + indexes + deletion bitmap + scalar indexes.

Write model (as in the reference): everything is append-only. An update
soft-deletes the old docid and appends a new row, so device buffers never
mutate rows; deletions are masked inside the scan.

Search: `search` sends every unfiltered, non-brute-force, non-columnar
request through the continuous-batching scheduler (engine/batching.py),
which co-batches compatible requests into padded row buckets; the rest go
to `_search_direct`. Rows are padded to the declared row buckets and the
candidate depth raised to the fetch-k tiers; the alive mask and each
filter's alive-and-filter mask are cached on the device per data version.
Filters plan through the scalar-index manager (scalar/manager.py) where a
field or composite is indexed. `SearchRequest.trace` collects per-phase
wall times and `ctx` is checked at the phase boundaries.

Persistence is the reference's segmented format 2 (`dump`, `open`): a
dump that either package wrote opens in the other, index state passing
through `convert.index_state_from_reference`.

Disk tier: a field with `store_type` "Disk" or "RocksDB", or a DISKANN /
DISKANN_STATIC index, keeps its rows in an mmap'd DiskRawVectorStore
under `data_dir/disk_<field>` (engine/disk_vector.py; a temporary
directory without a data_dir). A dump into the engine's own data_dir
writes no vector segment for such a field: the store's file is the
payload, and `flush_disk` records its durable row count; a load rolls
the store back to that count. `tiering_info` gathers the indexes' and
row caches' tier counters.

Runtime truth (obs/): a direct search charges its wall time to the bound
space as `device_us` (the scheduler apportions shared runs itself);
`build_index` and `warmup` run inside the flight recorder's warmup scope
and `build_index` keeps a `build_job` record for `build_observer`;
`rebuild_index` calls `note_index_mutation` (the `mutation_observer`
hook); a traced search captures its dispatches into
`trace["dispatches"]` beside the documented path's; `pad_real_rows`,
`pad_padded_rows` and `pad_waste_bytes` count the row padding, and
`filter_cache_hits` / `_misses` the filter-mask cache; `quality_info`
gives the quality monitor its health numbers, `device_footprint_bytes`
the device sampler its model. Names are the reference's.

Not ported yet: `mesh_serving: on` (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from vearch_tpu_torch.device import resolve_device
from vearch_tpu_torch.engine.bitmap import BitmapManager
from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.table import Table
from vearch_tpu_torch.engine.types import (  # noqa: F401 (re-exported)
    DataType,
    IndexParams,
    IndexStatus,
    MetricType,
    RequestContext,
    RequestKilled,
    ScalarIndexType,
    SearchResult,
    SearchResultItem,
    TableSchema,
    _FieldBuild,
)
from vearch_tpu_torch.index.base import VectorIndex
from vearch_tpu_torch.index.registry import create_index
from vearch_tpu_torch.obs import accounting as _acct
from vearch_tpu_torch.obs.errors import internal_error
from vearch_tpu_torch.obs.flight_recorder import RECORDER
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.distance import score_to_metric

_log = logging.getLogger("vearch_tpu_torch.engine")

# wall-clock epoch of time.monotonic() zero: phase spans carry
# epoch microseconds while every duration is measured monotonically
MONO_EPOCH_OFFSET = time.time() - time.monotonic()


def mono_us(t_monotonic: float) -> int:
    """Monotonic seconds -> wall-anchored epoch microseconds (the
    reference's span `start_us` convention)."""
    return int((MONO_EPOCH_OFFSET + t_monotonic) * 1e6)


@dataclass
class SearchRequest:
    """One batched vector search (the reference's SearchRequest).

    vectors: field name -> [B, d] query matrix; several fields merge with
    `field_weights`. filters: a scalar-filter AST (scalar/filter.py) or
    None."""

    vectors: dict[str, np.ndarray]
    k: int = 10
    filters: Any = None
    include_fields: list[str] | None = None
    brute_force: bool = False  # exact flat scan even when indexed
    field_weights: dict[str, float] = field(default_factory=dict)
    index_params: dict[str, Any] = field(default_factory=dict)  # rerank etc.
    # {field: (min_score, max_score)} on each field's metric-oriented score
    score_bounds: dict[str, tuple] | None = None
    # normalized scalar-field sort specs (engine/sort.py parse_sort)
    sort: list[dict] | None = None
    # fields-free columnar result shape (ColumnarSearchResults); skips
    # the scheduler
    raw_results: bool = False
    # when not None, the engine records per-phase wall times into it
    # ({phase}_ms keys and `_phase_spans` [name, start_us, dur_us])
    trace: dict[str, float] | None = None
    # cooperative cancellation, checked at phase boundaries: a killed
    # request aborts before its next device dispatch, never mid-kernel
    ctx: RequestContext | None = None


class Engine:
    def __init__(self, schema: TableSchema, device=None,
                 data_dir: str | None = None):
        self.device = resolve_device(device)
        self.schema = schema
        self.data_dir = data_dir
        self.table = Table(schema)
        self.bitmap = BitmapManager()
        self.vector_stores: dict[str, RawVectorStore] = {}
        self.indexes: dict[str, VectorIndex] = {}
        self.status = IndexStatus.UNINDEXED
        self.last_build_error: BaseException | None = None
        # the current or last index-build job (build_index fills it)
        self.build_job: dict | None = None
        # optional sink of a build's terminal job record
        self.build_observer = None
        # optional staleness sink for the quality monitor, fired on
        # every wholesale index replacement (note_index_mutation)
        self.mutation_observer = None
        self._write_lock = threading.Lock()
        # monotone data version: bumped under _write_lock by every
        # mutation that can change search results (upsert, delete, schema
        # and scalar-index changes); keys the filter-mask caches
        self.data_version = 0
        # (filter json, data_version, n) -> host alive-and-filter mask,
        # and the same key -> that mask on the device, so a repeated
        # filtered search neither re-evaluates nor re-uploads it
        self._filter_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._device_filter_cache: OrderedDict[tuple, torch.Tensor] = \
            OrderedDict()
        self._filter_cache_lock = threading.Lock()
        self._filter_cache_max = 128
        self._device_filter_cache_max = 16
        # a hit is a mask served from either cache; a miss an evaluation
        self.filter_cache_hits = 0
        self.filter_cache_misses = 0
        # (bitmap version, n) and the alive mask on the device, replaced
        # as one tuple so a concurrent reader never pairs a key with
        # another key's mask
        self._mask_cache: tuple | None = None
        self._build_thread: threading.Thread | None = None
        self._refresh_thread: threading.Thread | None = None
        self._closed: threading.Event | None = None
        # field -> in-flight scalar index build marker: lets synchronous
        # callers join an identical in-flight build, and gates publish on
        # the marker still being current (a remove or a newer build
        # cancels it)
        self._field_builds: dict[str, _FieldBuild] = {}
        # continuous batching (engine/batching.py): started lazily on the
        # first qualifying search, so an idle engine spawns no thread
        self.micro_batch = True
        self.micro_batch_max_rows = 1024
        # age bound on a partially filled shape bucket (ms); 0 dispatches
        # the moment the dispatcher is free
        self.batch_delay_ms = 0.0
        self._microbatcher = None
        # padded shape buckets (ops/perf_model.py): every dispatch is
        # raised to the declared row and fetch-k grid, so mixed-k traffic
        # co-batches; off reverts to free-form shapes
        self.shape_buckets = True
        # row-padding counters of the shape buckets
        self.pad_real_rows = 0
        self.pad_padded_rows = 0
        self.pad_waste_bytes = 0
        self._scalar_manager = None
        if schema.composite_indexes or any(
            f.scalar_index is not ScalarIndexType.NONE
            for f in schema.scalar_fields()
        ):
            from vearch_tpu_torch.scalar.manager import ScalarIndexManager

            self._scalar_manager = ScalarIndexManager(schema)
        for f in schema.vector_fields():
            params = f.index or IndexParams()
            dtype = params.get("store_dtype", "float32")
            store_type = str(params.get("store_type", "MemoryOnly"))
            disk_index = params.index_type.upper() in (
                "DISKANN", "DISKANN_STATIC")
            if store_type in ("Disk", "RocksDB") or disk_index:
                # disk tier: rows live in an mmap, not in host RAM
                from vearch_tpu_torch.engine.disk_vector import (
                    DiskRawVectorStore,
                )

                base = data_dir or tempfile.mkdtemp(prefix="vearch_disk_")
                store: RawVectorStore = DiskRawVectorStore(
                    f.dimension,
                    directory=os.path.join(base, f"disk_{f.name}"),
                    store_dtype=dtype,
                    row_cache_mb=int(params.get("row_cache_mb", 64)),
                    device=self.device,
                )
            else:
                store = RawVectorStore(f.dimension, store_dtype=dtype,
                                       device=self.device)
            self.vector_stores[f.name] = store
            self.indexes[f.name] = create_index(params, store)

    # -- writes --------------------------------------------------------------

    def upsert(self, docs: list[dict[str, Any]]) -> list[str]:
        """Add-or-update a batch; returns assigned doc keys. An existing
        key is an update: the old docid is soft-deleted and a new row
        appended; omitted fields carry forward from the replaced row."""
        vf = self.schema.vector_fields()
        keys: list[str] = []
        with self._write_lock:
            # all resolution and validation before any mutation: a bad
            # batch fails whole and docid == row id holds everywhere
            for doc in docs:
                self.table.validate(
                    {k: v for k, v in doc.items() if k != "_id"}
                )
            # wire-format vectors decode through the index (packed
            # binary fields unpack to 0/1 floats)
            mats = {}
            for f in vf:
                idx = self.indexes[f.name]
                store = self.vector_stores[f.name]
                have = [i for i, d in enumerate(docs)
                        if d.get(f.name) is not None]
                if len(have) == len(docs):
                    mats[f.name] = idx.decode_input(np.asarray(
                        [d[f.name] for d in docs]
                    ).reshape(len(docs), idx.input_dim))
                    continue
                out = np.zeros((len(docs), store.dimension), np.float32)
                if have:
                    out[have] = idx.decode_input(np.asarray(
                        [docs[i][f.name] for i in have]
                    ).reshape(len(have), idx.input_dim))
                latest: dict[str, int] = {}  # key -> out row in this batch
                for i, d in enumerate(docs):
                    key = str(d["_id"]) if "_id" in d else None
                    if d.get(f.name) is not None:
                        if key is not None:
                            latest[key] = i
                        continue
                    src = latest.get(key) if key is not None else None
                    if src is not None:
                        out[i] = out[src]
                        latest[key] = i
                        continue
                    old = (self.table.docid_of(key)
                           if key is not None else None)
                    if old is None:
                        raise ValueError(
                            f"document {key!r} omits vector field "
                            f"{f.name!r} and has no existing row to "
                            f"inherit it from"
                        )
                    out[i] = np.asarray(store.get(old), dtype=np.float32)
                    latest[key] = i
                mats[f.name] = out
            merged_docs = []
            for doc in docs:
                key = str(doc["_id"]) if "_id" in doc else uuid.uuid4().hex
                fields = {k: v for k, v in doc.items() if k != "_id"}
                prev_id = self.table.docid_of(key)
                if prev_id is not None:
                    # only fields the previous doc actually set carry
                    # forward (fixed columns materialize 0-defaults)
                    prev_set = self.table.set_fields_of(prev_id)
                    for name, val in self.table.get_fields(
                            prev_id, list(prev_set)).items():
                        fields.setdefault(name, val)
                _docid, old = self.table.add(key, fields)
                if old is not None:
                    self.bitmap.set_deleted(old)
                keys.append(key)
                merged_docs.append(fields)
            for f in vf:
                self.vector_stores[f.name].add(mats[f.name])
            if self._scalar_manager is not None:
                self._scalar_manager.add_docs(
                    merged_docs, self.table.doc_count - len(docs))
            self.data_version += 1
        self._maybe_start_build()
        return keys

    def delete(self, keys: list[str]) -> int:
        n = 0
        with self._write_lock:
            for key in keys:
                docid = self.table.delete(key)
                if docid is not None:
                    self.bitmap.set_deleted(docid)
                    n += 1
            if n:
                self.data_version += 1
        return n

    # -- reads ---------------------------------------------------------------

    def _vector_payload(self, doc: dict, docid: int, vector_value: bool,
                        fields: list[str] | None) -> None:
        """Vector payloads ride only when `vector_value` is set or a vector
        field is named in `fields`."""
        for name, store in self.vector_stores.items():
            if vector_value or (fields is not None and name in fields):
                doc[name] = store.get(docid).tolist()

    def get(
        self,
        keys: list[str],
        fields: list[str] | None = None,
        vector_value: bool = False,
    ) -> list[dict]:
        """Fetch alive docs by key (absent and deleted keys are skipped)."""
        out = []
        for key in keys:
            docid = self.table.docid_of(key)
            if docid is None or self.bitmap.is_deleted(docid):
                continue
            doc = {"_id": key, **self.table.get_fields(docid, fields)}
            self._vector_payload(doc, docid, vector_value, fields)
            out.append(doc)
        return out

    @property
    def doc_count(self) -> int:
        """Alive docs."""
        return self.table.doc_count - self.bitmap.deleted_count

    def memory_usage_bytes(self) -> int:
        """Host memory of the durable structures (raw vectors, quantized
        mirrors and codes), the reference's formula: it drives the
        resource-limit write guard."""
        total = 0
        for store in self.vector_stores.values():
            if getattr(store, "durable_on_disk", False):
                total += store.memory_usage_bytes()  # page cache, not RSS
            else:
                total += store.host_view().nbytes  # used rows, not capacity
        for index in self.indexes.values():
            mirror = getattr(index, "_mirror", None)
            if mirror is not None:
                total += mirror.count * (mirror.dimension + 8)
            codes = getattr(index, "_codes", None)
            if codes is not None:
                total += codes.nbytes
        return total

    def query(
        self,
        filters: Any = None,
        limit: int = 50,
        offset: int = 0,
        include_fields: list[str] | None = None,
        vector_value: bool = False,
        order_by_key: bool = True,
        sort: list[dict] | None = None,
    ) -> list[dict]:
        """Scalar-only query: filter docs without a vector search.

        Matches come in _id order by default (so a merge-then-slice over
        partitions pages correctly); order_by_key=False skips that sort.
        With `sort` (normalized specs, engine/sort.py) matches order by
        the sort keys, _id breaking ties, and each doc carries its
        "_sort" values."""
        from vearch_tpu_torch.scalar.filter import evaluate_filter

        n = self.table.doc_count
        valid = self.bitmap.valid_mask(n)
        if filters is not None:
            valid = valid & evaluate_filter(filters, self, n)
        matched = np.nonzero(valid)[0]
        sort_rows: list[list] | None = None
        if sort and matched.size:
            matched, sort_rows = self._sorted_matches(matched, sort)
        elif order_by_key and matched.size:
            keys = np.array(
                [self.table.key_of(int(i)) for i in matched], dtype=object)
            matched = matched[np.argsort(keys, kind="stable")]
        hits = matched[offset: offset + limit]
        out = []
        for pos, docid in enumerate(hits):
            docid = int(docid)
            doc = {"_id": self.table.key_of(docid)}
            doc.update(self.table.get_fields(docid, include_fields))
            self._vector_payload(doc, docid, vector_value, include_fields)
            if sort_rows is not None:
                doc["_sort"] = sort_rows[offset + pos]
            out.append(doc)
        return out

    def _sorted_matches(
        self, matched: np.ndarray, specs: list[dict]
    ) -> tuple[np.ndarray, list[list]]:
        """Order matched docids by the sort specs (stable, _id tie-break).
        Returns (ordered docids, their sort values in the same order).
        Fixed numeric columns ride one np.lexsort; string or missing-
        capable fields fall back to a comparison sort."""
        from vearch_tpu_torch.engine.sort import (
            ID_FIELD, SCORE_FIELD, row_sort_key,
        )

        ids = matched.tolist()
        keys = [self.table.key_of(int(i)) for i in ids]
        value_cols: list[list] = []
        all_fixed = True
        for s in specs:
            f = s["field"]
            if f == ID_FIELD:
                value_cols.append(keys)
                all_fixed = False
                continue
            if f == SCORE_FIELD:
                # no vector score in a scalar query: None values sort last
                value_cols.append([None] * len(ids))
                all_fixed = False
                continue
            try:
                col = self.table.column(f)
                value_cols.append(col[matched].tolist())
            except KeyError:
                all_fixed = False
                try:
                    scol = self.table.string_column(f)
                    value_cols.append([scol[i] for i in ids])
                except KeyError:
                    value_cols.append([None] * len(ids))
        if all_fixed and value_cols:
            # least-significant key first: the _id tie-break, then the
            # spec columns in reverse (keys as unicode: np.lexsort rejects
            # object arrays)
            lex_keys = [np.asarray(keys)]
            for s, col in zip(reversed(specs), reversed(value_cols)):
                arr = np.asarray(col)
                if arr.dtype == bool or arr.dtype.kind == "u":
                    arr = arr.astype(np.int64)  # negate-safe
                lex_keys.append(-arr if s["desc"] else arr)
            order = np.lexsort(lex_keys)
        else:
            rows = list(range(len(ids)))
            rows.sort(key=row_sort_key(
                specs,
                lambda r: [value_cols[c][r] for c in range(len(specs))],
                tie_key=lambda r: keys[r],
            ))
            order = rows
        ordered = matched[np.asarray(order, dtype=np.int64)]
        sort_rows = [
            [value_cols[c][r] for c in range(len(specs))] for r in order
        ]
        return ordered, sort_rows

    # -- index lifecycle -----------------------------------------------------

    def _training_threshold(self, index: VectorIndex) -> int:
        """Docs required before auto-build starts; explicit build_index()
        ignores it."""
        return int(index.params.get(
            "training_threshold", self.schema.training_threshold or 100_000))

    def _maybe_start_build(self) -> None:
        """Start a background train+absorb once the training threshold is
        crossed (IDLE->TRAINING guard as in the reference)."""
        needs = [
            name for name, idx in self.indexes.items()
            if idx.needs_training and not idx.trained
            and self.vector_stores[name].count >= self._training_threshold(idx)
        ]
        if not needs or self.status != IndexStatus.UNINDEXED:
            return
        self.status = IndexStatus.TRAINING
        t = threading.Thread(target=self.build_index, daemon=True,
                             name="engine-build")
        t.start()
        self._build_thread = t

    def wait_for_index(self, timeout: float | None = None) -> None:
        """Join an in-flight background build."""
        t = self._build_thread
        if t is not None:
            t.join(timeout)

    def build_index(self, field_name: str | None = None,
                    op: str = "build") -> None:
        """Train (where needed) and absorb all current rows, then warm the
        configured batch sizes (`warmup_batches`; none by default). After
        `open` the indexes are trained and absorbed, so this only absorbs
        rows that arrived since.

        The build is an observable job: `self.build_job` tracks its phase
        (train / assign / publish / warmup), docs_done of docs_total, the
        milliseconds of each phase and its terminal status; its phase
        windows are kept as `_phase_spans` rows ([name, start_us,
        dur_us]). Builds and warmup run inside the flight recorder's
        warmup scope: their compile events are expected."""
        t_start = time.monotonic()
        targets = [(name, idx) for name, idx in self.indexes.items()
                   if field_name is None or name == field_name]
        job: dict[str, Any] = {
            "op": op, "status": "running", "phase": "train",
            "docs_total": sum(self.vector_stores[n].count
                              for n, _ in targets),
            "docs_done": 0,
            "started": MONO_EPOCH_OFFSET + t_start,
            "updated": MONO_EPOCH_OFFSET + t_start,
            "phases_ms": {}, "error": None, "_phase_spans": [],
        }
        self.build_job = job

        def mark(phase: str, t0: float, t1: float) -> None:
            job["_phase_spans"].append(
                (f"build.{phase}", mono_us(t0), int((t1 - t0) * 1e6)))
            job["phases_ms"][phase] = round(
                job["phases_ms"].get(phase, 0.0) + (t1 - t0) * 1e3, 3)
            job["phase"] = phase
            job["updated"] = MONO_EPOCH_OFFSET + t1

        self.status = IndexStatus.TRAINING
        try:
            with RECORDER.warmup():
                for name, index in targets:
                    store = self.vector_stores[name]
                    if index.needs_training and not index.trained:
                        t0 = time.monotonic()
                        index.train(store.host_view())
                        mark("train", t0, time.monotonic())
                    t0 = time.monotonic()
                    index.absorb(store.count)
                    mark("assign", t0, time.monotonic())
                    job["docs_done"] += store.count
        except Exception as e:
            # a failed build must not wedge the engine in TRAINING
            self.last_build_error = e
            self.status = IndexStatus.UNINDEXED
            now = time.monotonic()
            job.update(status="error", error=f"{type(e).__name__}: {e}",
                       duration_seconds=round(now - t_start, 3),
                       updated=MONO_EPOCH_OFFSET + now)
            self._notify_build(job)
            raise
        t0 = time.monotonic()
        self.status = IndexStatus.INDEXED
        mark("publish", t0, time.monotonic())
        t0 = time.monotonic()
        self.warmup(field_name=field_name)
        mark("warmup", t0, time.monotonic())
        now = time.monotonic()
        job.update(status="done", phase="done",
                   duration_seconds=round(now - t_start, 3),
                   updated=MONO_EPOCH_OFFSET + now)
        self._notify_build(job)

    def _notify_build(self, job: dict) -> None:
        obs = self.build_observer
        if obs is not None:
            try:
                obs(job)
            except Exception as e:  # observability never fails a build
                internal_error("engine.build_observer", e)

    def note_index_mutation(self, op: str = "") -> None:
        """Forward a wholesale index replacement to the wired quality
        observer; a failing observer never fails the mutation."""
        obs = self.mutation_observer
        if obs is not None:
            try:
                obs(op)
            except Exception as e:
                internal_error("engine.mutation_observer", e)

    def rebuild_index(self) -> None:
        """Retrain from scratch: fresh indexes over the same stores."""
        for name, index in self.indexes.items():
            self.indexes[name] = create_index(index.params,
                                              self.vector_stores[name])
        self.status = IndexStatus.UNINDEXED
        self.build_index(op="rebuild")
        # the retrain replaced the quantizers and every mirror wholesale
        self.note_index_mutation(op="rebuild")

    def warmup(
        self,
        batches: list[int] | None = None,
        k: int = 10,
        field_name: str | None = None,
    ) -> dict[str, list[int]]:
        """Real searches through each index at the given query-batch sizes
        (default: each index's "warmup_batches" param), raised to the row
        and fetch-k buckets serving dispatches, so the kernels are built
        and first launched at the serving shapes before the first
        request: inside the flight recorder's warmup scope, their
        compile events are expected. Returns the batch sizes run per
        field."""
        with RECORDER.warmup():
            return self._warmup_inner(batches, k, field_name)

    def _warmup_inner(self, batches, k, field_name) -> dict[str, list[int]]:
        done: dict[str, list[int]] = {}
        for name, index in self.indexes.items():
            if field_name is not None and name != field_name:
                continue
            store = self.vector_stores[name]
            if store.count == 0:
                continue
            b_list = batches if batches is not None else list(
                index.params.get("warmup_batches", []) or [])
            if not b_list:
                continue
            # a live row, not zeros: cosine normalisation of an all-zero
            # query would exercise a degenerate path
            row = np.asarray(store.host_view()[:1], dtype=np.float32)
            valid = self._device_alive_mask(self.table.doc_count)
            kk = max(1, min(int(k), store.count))
            b_set = {int(x) for x in b_list if int(x) > 0}
            if self.shape_buckets:
                kk = perf_model.bucket_fetch_k(kk)
                b_set = {perf_model.bucket_rows(b) for b in b_set}
            for b in sorted(b_set):
                q = np.repeat(row, b, axis=0)
                if index.trained:
                    index.search(q, kk, valid)
                else:
                    from vearch_tpu_torch.index.flat import FlatIndex

                    FlatIndex(IndexParams(metric_type=index.metric),
                              store).search(q, kk, valid)
                done.setdefault(name, []).append(b)
        return done

    def start_refresh_loop(self) -> None:
        """Background realtime pump: absorb new rows into every trained
        index every refresh interval, so searches do not pay the absorb
        inline."""
        with self._write_lock:  # ordered against close()'s _closed write
            if self._refresh_thread is not None:
                return
            if self._closed is not None and self._closed.is_set():
                return  # closed engines stay closed
            self._closed = threading.Event()
            closed = self._closed

        def loop():
            while not closed.wait(
                    max(self.schema.refresh_interval_ms, 50) / 1e3):
                for name, index in self.indexes.items():
                    if index.trained:
                        try:
                            index.absorb(self.vector_stores[name].count)
                        except Exception as e:
                            self.last_build_error = e

        self._refresh_thread = threading.Thread(
            target=loop, daemon=True, name="engine-refresh")
        self._refresh_thread.start()

    def close(self) -> None:
        """Stop the scheduler (its waiting callers are errored) and the
        refresh loop; later searches serve directly."""
        # under _write_lock, as the scheduler's lazy creation in search():
        # a concurrent search must not start a fresh scheduler after the
        # stop
        with self._write_lock:
            if self._closed is None:
                # no refresh loop ever started; still record closedness
                # so apply_config cannot re-enable micro-batching
                self._closed = threading.Event()
            self._closed.set()
            self.micro_batch = False
            mb, self._microbatcher = self._microbatcher, None
        if mb is not None:
            mb.stop()
            mb._thread.join(timeout=60)
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=60)
        # outside _write_lock: an index's close only stops its background
        # tier workers (prefetchers)
        for index in self.indexes.values():
            try:
                index.close()
            except Exception as e:
                _log.warning("index close failed: %s", e)

    def quality_info(self) -> dict[str, Any]:
        """Index-health numbers for the quality monitor's drift gauges
        (obs/quality.py collect_health): deleted and unindexed fractions,
        and per field the reconstruction error and the cell-population
        imbalance. Host work only."""
        total = int(self.table.doc_count)
        deleted = int(self.bitmap.deleted_count)
        info: dict[str, Any] = {
            "doc_count": total - deleted,
            "deleted_count": deleted,
            "deleted_frac": deleted / total if total else 0.0,
            "data_version": int(self.data_version),
            "fields": {},
        }
        for name, index in self.indexes.items():
            n = int(index.store.count)
            if index.needs_training and n:
                unindexed = (n - min(int(index.indexed_count), n)) / n
            else:
                # FLAT-family indexes scan the raw store: the tail is
                # always searched
                unindexed = 0.0
            f: dict[str, Any] = {
                "index_type": index.params.index_type,
                "trained": bool(index.trained),
                "indexed_count": int(index.indexed_count),
                "unindexed_frac": unindexed,
            }
            try:
                f["recon_error"] = index.reconstruction_error()
            except Exception as e:
                internal_error("engine.quality_info", e)
                f["recon_error"] = None
            pops = index.cell_populations()
            if pops:
                arr = np.asarray(pops, dtype=np.float64)
                mean = float(arr.mean())
                f["ncells"] = len(pops)
                f["cell_min"] = int(arr.min())
                f["cell_max"] = int(arr.max())
                f["cell_imbalance_cv"] = (
                    float(arr.std() / mean) if mean > 0 else 0.0)
            info["fields"][name] = f
        return info

    def device_footprint_bytes(self) -> int:
        """Modelled resident device bytes (the device sampler's model
        side): every field's index, plus the masks the engine keeps on
        the device (the alive mask and the cached filter masks), which
        the reference's model leaves out."""
        total = sum(int(index.device_footprint_per_device_bytes())
                    for index in list(self.indexes.values()))
        cached = self._mask_cache
        masks = [cached[1]] if cached is not None else []
        with self._filter_cache_lock:
            masks += list(self._device_filter_cache.values())
        return total + sum(m.numel() * m.element_size() for m in masks)

    def mesh_info(self) -> dict[str, Any] | None:
        """Mesh placement summary over the fields: None, as the port
        serves one device."""
        return None

    def tiering_info(self) -> dict[str, Any] | None:
        """Tiered-storage summary over the vector fields (each index's
        tiers, and a disk store's row cache); None when no field serves
        through the storage tiers."""
        fields: dict[str, Any] = {}
        for name, index in self.indexes.items():
            info = index.tiering_info()
            row_cache = getattr(self.vector_stores[name], "row_cache", None)
            if row_cache is not None:
                info = dict(info or {"kind": "disk_store"})
                info["row_cache"] = row_cache.stats()
            if info is not None:
                fields[name] = info
        return {"fields": fields} if fields else None

    def apply_config(self, cfg: dict[str, Any]) -> dict[str, Any]:
        """Runtime-mutable engine config: refresh_interval_ms,
        training_threshold, micro_batch, micro_batch_max_rows,
        batch_delay_ms, shape_buckets, mesh_shape / mesh_serving (fanned
        into every vector field's index params), per-field index_params,
        and warmup (re-run `warmup`)."""
        if "refresh_interval_ms" in cfg:
            self.schema.refresh_interval_ms = int(cfg["refresh_interval_ms"])
        if "training_threshold" in cfg:
            self.schema.training_threshold = int(cfg["training_threshold"])
        if "micro_batch" in cfg:
            # under _write_lock, ordered against close(): a closed engine
            # must not re-enable batching
            with self._write_lock:
                if self._closed is None or not self._closed.is_set():
                    self.micro_batch = bool(cfg["micro_batch"])
        if "micro_batch_max_rows" in cfg:
            self.micro_batch_max_rows = int(cfg["micro_batch_max_rows"])
            mb = self._microbatcher
            if mb is not None:
                mb.max_rows = self.micro_batch_max_rows
        if "batch_delay_ms" in cfg:
            self.batch_delay_ms = float(cfg["batch_delay_ms"])
            mb = self._microbatcher
            if mb is not None:
                mb.max_delay_ms = self.batch_delay_ms
        if "shape_buckets" in cfg:
            self.shape_buckets = bool(cfg["shape_buckets"])
        for key in ("mesh_shape", "mesh_serving"):
            # written as the reference writes them; mesh_serving "on"
            # raises at search time (ROADMAP queue 1 item 10)
            if key in cfg:
                for index in self.indexes.values():
                    index.params.params[key] = cfg[key]
        for name, params in (cfg.get("index_params") or {}).items():
            if name in self.indexes:
                self.indexes[name].params.params.update(params)
        if cfg.get("warmup"):
            self.warmup()
        return {
            "refresh_interval_ms": self.schema.refresh_interval_ms,
            "training_threshold": self.schema.training_threshold,
        }

    # -- online scalar field indexes -----------------------------------------

    def add_field_index(
        self, field: str, index_type: str = "INVERTED",
        background: bool = True,
    ) -> None:
        """Build a scalar index on a live field. The bulk build reads the
        append-only column without the write lock (searches keep
        scanning), then catches up and publishes atomically under the
        lock; from that moment filters use the index."""
        f = self.schema.field(field)
        if f.data_type is DataType.VECTOR:
            raise ValueError(f"{field} is a vector field")
        itype = ScalarIndexType(index_type.upper())
        if itype is ScalarIndexType.NONE:
            return self.remove_field_index(field)
        with self._write_lock:
            cur = self._field_builds.get(field)
            if cur is not None and cur.value == itype.value:
                if background:
                    return  # identical background build already in flight
                # synchronous: the index must be live on return
                pending = cur
            else:
                pending = None
                marker = _FieldBuild(itype.value)
                self._field_builds[field] = marker
        if pending is not None:
            pending.done.wait()
            if pending.error is not None:
                raise pending.error
            return

        def build() -> None:
            from vearch_tpu_torch.scalar.indexes import (
                BitmapScalarIndex, InvertedScalarIndex,
            )
            from vearch_tpu_torch.scalar.manager import _NUMERIC

            if itype is ScalarIndexType.BITMAP:
                index = BitmapScalarIndex()
            else:
                dtype = _NUMERIC.get(f.data_type)
                index = InvertedScalarIndex(
                    np.dtype(dtype) if dtype else np.dtype(object))

            def rows(lo: int, hi: int):
                try:
                    return self.table.column(field)[lo:hi]
                except KeyError:
                    return self.table.string_column(field)[lo:hi]

            def index_rows(lo: int, hi: int) -> None:
                # presence-gated: fixed-column 0-defaults of never-set
                # fields must not become filterable values
                for docid, value in enumerate(rows(lo, hi), start=lo):
                    if (value is not None
                            and field in self.table.set_fields_of(docid)):
                        index.add(value, docid)

            built = 0
            while True:  # bulk phase, lock-free
                hi = self.table.doc_count
                if hi <= built:
                    break
                index_rows(built, hi)
                built = hi
            with self._write_lock:
                if self._field_builds.get(field) is not marker:
                    return  # superseded (a remove, or a different build)
                index_rows(built, self.table.doc_count)  # exact catch-up
                if self._scalar_manager is None:
                    from vearch_tpu_torch.scalar.manager import (
                        ScalarIndexManager,
                    )

                    self._scalar_manager = ScalarIndexManager(self.schema)
                self._scalar_manager.add_field(field, index)
                f.scalar_index = itype  # dumps persist the new schema
                self.data_version += 1

        def run() -> None:
            try:
                build()
            except BaseException as e:
                marker.error = e
                if not background:
                    raise
            finally:
                with self._write_lock:
                    # pop only our marker: a newer build replaced it
                    if self._field_builds.get(field) is marker:
                        self._field_builds.pop(field)
                marker.done.set()

        if background:
            threading.Thread(target=run, daemon=True,
                             name=f"vearch-field-index-{field}").start()
        else:
            run()

    def add_schema_field(self, f) -> None:
        """Online schema evolution: add a new scalar field (additions
        only). Idempotent; vector fields are refused."""
        if f.data_type is DataType.VECTOR:
            raise ValueError("vector fields cannot be added to a live space")
        target = f.scalar_index
        with self._write_lock:
            if any(x.name == f.name for x in self.schema.fields):
                return
            # appended with no index flag: it flips when the build
            # publishes
            f.scalar_index = ScalarIndexType.NONE
            self.schema.fields.append(f)
            self.table.add_field(f)
            self.data_version += 1
        if target is not ScalarIndexType.NONE:
            self.add_field_index(f.name, target.value)

    def remove_field_index(self, field: str) -> None:
        """Drop a field's scalar index; filters fall back to the column
        scan."""
        f = self.schema.field(field)
        with self._write_lock:
            # orphaning an in-flight build's marker makes its publish
            # refuse, so the dropped index cannot come back
            self._field_builds.pop(field, None)
            if self._scalar_manager is not None:
                self._scalar_manager.remove_field(field)
            f.scalar_index = ScalarIndexType.NONE
            self.data_version += 1

    # -- search --------------------------------------------------------------

    def _device_alive_mask(self, n: int) -> torch.Tensor:
        key = (self.bitmap.version, n)
        cached = self._mask_cache
        if cached is None or cached[0] != key:
            cached = self._mask_cache = (key, torch.from_numpy(
                self.bitmap.valid_mask(n).copy()).to(self.device))
        return cached[1]

    @staticmethod
    def _filter_key(filters: Any) -> str | None:
        try:
            return json.dumps(filters, sort_keys=True, default=str)
        except (TypeError, ValueError):
            return None  # un-canonicalizable filter object: no caching

    def _filtered_mask(self, filters: Any, n: int) -> np.ndarray:
        """Alive-and-filter host mask for the first `n` rows, cached on
        (filter expression, data_version, n). The version is read before
        evaluation: a write landing meanwhile keys the mask to the old
        version, and the next search recomputes."""
        from vearch_tpu_torch.scalar.filter import evaluate_filter

        version = self.data_version
        fkey = self._filter_key(filters)
        key = (fkey, version, n)
        if fkey is not None:
            with self._filter_cache_lock:
                mask = self._filter_cache.get(key)
                if mask is not None:
                    self._filter_cache.move_to_end(key)
                    self.filter_cache_hits += 1
                    return mask
                self.filter_cache_misses += 1
        mask = self.bitmap.valid_mask(n) & evaluate_filter(filters, self, n)
        if fkey is not None:
            with self._filter_cache_lock:
                self._filter_cache[key] = mask
                self._filter_cache.move_to_end(key)
                while len(self._filter_cache) > self._filter_cache_max:
                    self._filter_cache.popitem(last=False)
        return mask

    def _device_filtered_mask(self, filters: Any, n: int) -> torch.Tensor:
        """`_filtered_mask` on the device, uploaded once per (filter,
        data_version, n) as the alive mask is once per bitmap version."""
        fkey = self._filter_key(filters)
        key = (fkey, self.data_version, n)
        if fkey is not None:
            with self._filter_cache_lock:
                mask = self._device_filter_cache.get(key)
                if mask is not None:
                    self._device_filter_cache.move_to_end(key)
                    self.filter_cache_hits += 1
                    return mask
        mask = torch.from_numpy(
            np.ascontiguousarray(self._filtered_mask(filters, n))
        ).to(self.device)
        if fkey is not None:
            with self._filter_cache_lock:
                self._device_filter_cache[key] = mask
                while (len(self._device_filter_cache)
                       > self._device_filter_cache_max):
                    self._device_filter_cache.popitem(last=False)
        return mask

    def search(self, req: SearchRequest) -> list[SearchResult]:
        """Search entry: compatible concurrent requests pack into padded
        shape buckets and share one dispatch (engine/batching.py);
        filtered, brute-force, columnar and batching-disabled requests
        run directly."""
        if (self.micro_batch and req.filters is None and not req.brute_force
                and not req.raw_results and req.vectors):
            mb = self._microbatcher
            if mb is None:
                with self._write_lock:
                    mb = self._microbatcher
                    # re-check under the lock: close() clears micro_batch
                    # before it stops the scheduler
                    if mb is None and self.micro_batch:
                        from vearch_tpu_torch.engine.batching import (
                            BatchScheduler,
                        )

                        mb = self._microbatcher = BatchScheduler(
                            self, max_rows=self.micro_batch_max_rows,
                            max_delay_ms=self.batch_delay_ms)
            if mb is not None:
                return mb.submit(req)
        # a direct search bills its whole wall time to the bound space
        # (the scheduler apportions shared runs in _run_bucket)
        t0 = time.monotonic()
        try:
            return self._search_direct(req)
        finally:
            _acct.ACCOUNTANT.charge(
                "device_us", int((time.monotonic() - t0) * 1e6))

    def _search_direct(self, req: SearchRequest) -> list[SearchResult]:
        if not req.vectors:
            raise ValueError("search needs at least one vector field")
        phases: list[tuple[str, float, float]] = []
        # a traced search captures the search programs it runs
        capture = ivf_ops.begin_capture() if req.trace is not None else None
        try:
            return self._search_phases(req, phases)
        finally:
            if capture is not None:
                ivf_ops.end_capture()
                self._record_dispatch_trace(req, capture, phases)

    def _search_phases(self, req: SearchRequest,
                       phases: list[tuple[str, float, float]]
                       ) -> list[SearchResult]:
        trace = req.trace
        t_start = time.monotonic()
        n = self.table.doc_count
        if req.filters is not None:
            valid = self._device_filtered_mask(req.filters, n)
        else:
            # the alive mask changes only on writes: keep it on the device
            valid = self._device_alive_mask(n)
        if trace is not None:
            t_filter = time.monotonic()
            trace["filter_ms"] = round((t_filter - t_start) * 1e3, 3)
            phases.append(("engine.filter", t_start, t_filter))
        metrics = {self.indexes[name].metric for name in req.vectors}
        if len(metrics) > 1:
            raise ValueError(
                "multi-field search requires a single metric across "
                f"fields; got {[m.value for m in metrics]}"
            )
        per_field: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        queries_by_field: dict[str, np.ndarray] = {}
        fetch_k = req.k if len(req.vectors) == 1 else max(req.k * 4, 50)
        if self.shape_buckets:
            # raise the candidate depth to the declared tier, solo and
            # batched alike, so co-batched requests of differing k stay
            # bit-identical to solo runs (k=10 scans at fetch-k 16)
            fetch_k = perf_model.bucket_fetch_k(fetch_k)
        for name, queries in req.vectors.items():
            if req.ctx is not None:
                req.ctx.check()
            t_field = time.monotonic()
            index = self.indexes[name]
            store = self.vector_stores[name]
            queries = np.asarray(queries)
            if queries.ndim == 1:
                queries = queries[None, :]
            queries = index.decode_input(
                queries.reshape(queries.shape[0], index.input_dim))
            queries_by_field[name] = queries
            b_rows = int(queries.shape[0])
            q_run = queries
            if self.shape_buckets:
                # pad rows up to the declared bucket with a REAL row (a
                # zero row is degenerate under cosine); every scan path
                # is per-row, so the pad rows change nothing for real rows
                bb = perf_model.bucket_rows(b_rows)
                if bb != b_rows:
                    q_run = np.concatenate(
                        [queries, np.repeat(queries[-1:], bb - b_rows, 0)])
                self.pad_real_rows += b_rows
                self.pad_padded_rows += bb
                self.pad_waste_bytes += perf_model.padding_waste_bytes(
                    b_rows, bb, int(queries.shape[1]))
            if index.trained and not req.brute_force:
                if index.indexed_count < store.count:
                    index.absorb(store.count)  # realtime pump
                scores, ids = index.search(
                    q_run, fetch_k, valid, req.index_params or None)
            else:
                # the exact flat scan: asked for, or below the training
                # threshold
                from vearch_tpu_torch.index.flat import FlatIndex

                flat = FlatIndex(IndexParams(metric_type=index.metric), store)
                scores, ids = flat.search(q_run, fetch_k, valid)
            per_field[name] = (scores[:b_rows], ids[:b_rows])
            if trace is not None:
                # the field's search is done (its results are on the
                # host): close the open dispatch window
                ivf_ops.capture_mark()
                t_done = time.monotonic()
                trace[f"search_{name}_ms"] = round(
                    (t_done - t_field) * 1e3, 3)
                phases.append((f"engine.search.{name}", t_field, t_done))
        if req.ctx is not None:
            req.ctx.check()
        t_merge = time.monotonic()
        merged = self._merge_fields(per_field, queries_by_field, req)
        t_shape = time.monotonic()
        results = self._shape_results(merged, req)
        if trace is not None:
            t_end = time.monotonic()
            trace["merge_ms"] = round((t_shape - t_merge) * 1e3, 3)
            trace["shape_ms"] = round((t_end - t_shape) * 1e3, 3)
            phases += [("engine.merge", t_merge, t_shape),
                       ("engine.shape", t_shape, t_end)]
            trace["total_ms"] = round((t_end - t_start) * 1e3, 3)
            trace["doc_count"] = self.doc_count
        return results

    def _record_dispatch_trace(self, req, capture, phases) -> None:
        """Fold the dispatch capture and the phase windows into req.trace:
        the measured dispatches (tags, host ms per tag) beside the perf
        model's prediction for the matched serving path, and the
        `_phase_spans` rows ([name, start_us, dur_us]; engine.*, kernel.*,
        tier.*, stage.*)."""
        trace = req.trace
        tags = capture.tags
        trace["dispatches"] = tags
        trace["dispatch_count"] = len(tags)
        for tag, t0, t1 in capture.events:
            if t1 is not None:
                key = f"dispatch_{tag}_ms"
                trace[key] = round(trace.get(key, 0.0) + (t1 - t0) * 1e3, 3)
        path = perf_model.path_for_dispatches(tags)
        if path is not None:
            trace["perf_path"] = path
            trace["predicted_dispatches"] = list(
                perf_model.DOCUMENTED_DISPATCHES[path])
        trace["predicted_scan_bytes"] = sum(
            self._predicted_scan_bytes(name) for name in req.vectors)
        # extend, not replace: the scheduler may have noted its queue
        # wait on this trace before the search ran
        spans = list(trace.get("_phase_spans") or [])
        spans += [[name, mono_us(t0), int((t1 - t0) * 1e6)]
                  for name, t0, t1 in phases]
        spans += [[f"kernel.{tag}", mono_us(t0), int((t1 - t0) * 1e6)]
                  for tag, t0, t1 in capture.events if t1 is not None]
        for prefix, windows in (("tier", capture.tier_phases),
                                ("stage", capture.stage_phases)):
            spans += [[f"{prefix}.{name}", mono_us(t0),
                       int((t1 - t0) * 1e6)] for name, t0, t1 in windows]
        trace["_phase_spans"] = spans
        if capture.tier_phases:
            tinfo = self.tiering_info()
            if tinfo is not None:
                trace["tiering"] = tinfo

    def _predicted_scan_bytes(self, name: str) -> int:
        """Modelled stage-1 scan read bytes of one field
        (perf_model.scan_traffic_bytes): the mirror when the index keeps
        one, else the raw store's rows."""
        index = self.indexes[name]
        store = self.vector_stores[name]
        mirror = getattr(index, "_mirror", None)
        if mirror is not None:
            return perf_model.scan_traffic_bytes(
                1, int(mirror._h8.shape[0]), store.dimension, "xla_full")
        return int(store.count) * store.dimension * int(
            store.store_dtype.itemsize)

    def _exact_score(self, name: str, query: np.ndarray,
                     docids: list[int]) -> np.ndarray:
        """Host-side exact similarity for a small candidate set (union
        rescoring in the multi-field merge)."""
        store = self.vector_stores[name]
        vecs = np.stack([store.get(i) for i in docids])
        metric = self.indexes[name].metric
        dots = vecs @ query
        if metric is MetricType.INNER_PRODUCT:
            return dots
        if metric is MetricType.COSINE:
            qn = max(float(np.linalg.norm(query)), 1e-15)
            vn = np.maximum(np.linalg.norm(vecs, axis=1), 1e-15)
            return dots / (qn * vn)
        return -(np.sum((vecs - query) ** 2, axis=1))

    def _merge_fields(
        self,
        per_field: dict[str, tuple[np.ndarray, np.ndarray]],
        queries_by_field: dict[str, np.ndarray],
        req: SearchRequest,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Multi-vector-field rank merge with weights: candidates are the
        union of per-field top lists, each rescored exactly in every
        field."""
        if len(per_field) == 1:
            return next(iter(per_field.values()))
        names = list(per_field)
        b = per_field[names[0]][0].shape[0]
        out_scores, out_ids = [], []
        for qi in range(b):
            union: set[int] = set()
            for name in names:
                scores, ids = per_field[name]
                union.update(
                    int(i) for s, i in zip(scores[qi], ids[qi])
                    if i >= 0 and np.isfinite(s)
                )
            cand = sorted(union)
            if not cand:
                out_ids.append([-1] * req.k)
                out_scores.append([float("-inf")] * req.k)
                continue
            total = np.zeros(len(cand), dtype=np.float64)
            keep = np.ones(len(cand), dtype=bool)
            for name in names:
                w = req.field_weights.get(name, 1.0)
                sf = self._exact_score(name, queries_by_field[name][qi], cand)
                if req.score_bounds and name in req.score_bounds:
                    lo, hi = req.score_bounds[name]
                    mf = np.asarray(score_to_metric(
                        np.asarray(sf), self.indexes[name].metric))
                    if lo is not None:
                        keep &= mf >= lo
                    if hi is not None:
                        keep &= mf <= hi
                total += w * sf
            total = np.where(keep, total, -np.inf)
            order = np.argsort(-total)[: req.k]
            ids_row = [cand[i] if np.isfinite(total[i]) else -1 for i in order]
            sc_row = [float(total[i]) for i in order]
            pad = req.k - len(ids_row)
            out_ids.append(ids_row + [-1] * pad)
            out_scores.append(sc_row + [float("-inf")] * pad)
        return np.asarray(out_scores), np.asarray(out_ids)

    def _shape_results(
        self, merged: tuple[np.ndarray, np.ndarray], req: SearchRequest
    ) -> list[SearchResult]:
        scores, ids = merged
        metric = self.indexes[next(iter(req.vectors))].metric
        scores = np.asarray(scores)
        ids = np.asarray(ids)
        k = min(req.k, scores.shape[1])
        scores, ids = scores[:, :k], ids[:, :k]
        metric_scores = np.asarray(score_to_metric(scores, metric))
        want_fields = req.include_fields is None or bool(req.include_fields)
        ok = (ids >= 0) & np.isfinite(scores)
        if req.score_bounds and len(req.vectors) == 1:
            los = [b[0] for b in req.score_bounds.values() if b[0] is not None]
            his = [b[1] for b in req.score_bounds.values() if b[1] is not None]
            if los:
                ok &= metric_scores >= max(los)
            if his:
                ok &= metric_scores <= min(his)
        flat_ids = ids[ok].astype(np.int64)
        keys = self.table.keys_for(flat_ids)
        counts = ok.sum(axis=1).tolist()
        if req.raw_results and not req.sort and not want_fields:
            from vearch_tpu_torch.engine.types import ColumnarSearchResults

            out_keys, pos = [], 0
            for c in counts:
                out_keys.append(keys[pos:pos + c])
                pos += c
            return ColumnarSearchResults(
                keys=out_keys,
                scores=np.ascontiguousarray(metric_scores[ok],
                                            dtype=np.float32),
            )
        fields_list = (
            self.table.gather_rows(flat_ids, req.include_fields)
            if want_fields else [{}] * len(keys)
        )
        flat_scores = metric_scores[ok].tolist()
        sort_rows = self._sort_value_rows(
            req.sort, flat_ids, keys, flat_scores,
            fields_list if want_fields else None, req.include_fields)
        results, pos = [], 0
        for c in counts:
            items = [
                SearchResultItem(key=keys[j], score=float(flat_scores[j]),
                                 fields=fields_list[j],
                                 sort_values=sort_rows[j]
                                 if sort_rows is not None else None)
                for j in range(pos, pos + c)
            ]
            if req.sort:
                self._order_items(items, req.sort, metric)
            results.append(SearchResult(items=items))
            pos += c
        return results

    def _sort_value_rows(
        self, specs: list[dict] | None, flat_ids: np.ndarray,
        keys: list[str], flat_scores: list[float],
        fields_list: list[dict] | None,
        include_fields: list[str] | None,
    ) -> list[list] | None:
        """Per-hit sort-value lists (spec order) for the flat batch."""
        if not specs:
            return None
        from vearch_tpu_torch.engine.sort import ID_FIELD, SCORE_FIELD

        scalar_fields = [s["field"] for s in specs
                         if s["field"] not in (ID_FIELD, SCORE_FIELD)]
        covered = (fields_list is not None
                   and (include_fields is None
                        or set(include_fields).issuperset(scalar_fields)))
        if covered:
            field_rows = fields_list
        else:
            field_rows = (self.table.gather_rows(flat_ids, scalar_fields)
                          if scalar_fields else [{}] * len(keys))
        out = []
        for j in range(len(keys)):
            row = []
            for s in specs:
                f = s["field"]
                if f == SCORE_FIELD:
                    row.append(flat_scores[j])
                elif f == ID_FIELD:
                    row.append(keys[j])
                else:
                    row.append(field_rows[j].get(f))
            out.append(row)
        return out

    def _order_items(self, items: list, specs: list[dict], metric) -> None:
        """In-place order of one query's hits by the sort spec; ties break
        on metric-oriented score then key."""
        from vearch_tpu_torch.engine.sort import row_sort_key

        l2 = metric is MetricType.L2
        items.sort(key=row_sort_key(
            specs,
            lambda it: it.sort_values,
            tie_key=lambda it: ((it.score if l2 else -it.score), it.key),
        ))

    # -- persistence (the reference's segmented format 2) -------------------

    def snapshot_state(self) -> dict:
        """Phase 1 of a dump: a consistent point-in-time view, captured
        under the write lock (pointer copies and stable views of the
        append-only arrays). write_snapshot() then persists it without
        the lock."""
        with self._write_lock:
            return {
                "table": self.table.snapshot(),
                "bits": self.bitmap.snapshot(self.table.doc_count),
                "vecs": {name: store.host_view()
                         for name, store in self.vector_stores.items()},
                "status": int(self.status),
            }

    # rows per segment before the tail compaction kicks in, and the most
    # undersized trailing segments tolerated before they are merged: a
    # flush costs O(new rows), and every MAX_SMALL_SEGMENTS-th small
    # flush pays one merge
    SEGMENT_TARGET_ROWS = 100_000
    MAX_SMALL_SEGMENTS = 8

    def _read_manifest(self, dirpath: str) -> list[dict]:
        """Validated, contiguous-from-zero segment list (or empty)."""
        path = os.path.join(dirpath, "MANIFEST.json")
        if not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                segs = json.load(f)["segments"]
        except Exception:
            return []
        segs = sorted(segs, key=lambda s: s["start"])
        out, expect = [], 0
        for s in segs:
            if s["start"] != expect or not os.path.isdir(
                    os.path.join(dirpath, "segments", s["name"])):
                break
            out.append(s)
            expect = s["end"]
        return out

    def _write_segment(self, snap: dict, dirpath: str, start: int,
                       end: int, in_place: bool) -> dict:
        name = f"seg_{start:010d}_{end:010d}"
        final = os.path.join(dirpath, "segments", name)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        if os.path.isdir(final):
            # orphan of a crash between the rename and the manifest
            # commit: same rows, but a rename cannot land on a non-empty
            # directory
            shutil.rmtree(final)
        os.makedirs(tmp)
        tsnap = snap["table"]
        np.savez(os.path.join(tmp, "table.npz"),
                 **{n: arr[start:end] for n, arr in tsnap["fixed"].items()})
        with open(os.path.join(tmp, "table.json"), "w") as f:
            json.dump({
                "keys": tsnap["keys"][start:end],
                "strings": {k: v[start:end]
                            for k, v in tsnap["strings"].items()},
            }, f)
        for fname, view in snap["vecs"].items():
            if in_place and getattr(self.vector_stores[fname],
                                    "durable_on_disk", False):
                continue  # the store's own mmap is the durable payload
            # the host rows read as f32 for every store_dtype (a bf16
            # store widens its bits), so the file loads without pickle
            np.save(os.path.join(tmp, f"vectors_{fname}.npy"),
                    np.asarray(view[start:end], dtype=np.float32))
        os.replace(tmp, final)
        return {"name": name, "start": start, "end": end}

    def write_snapshot(self, snap: dict, dirpath: str) -> None:
        """Phase 2: persist a snapshot_state() capture, without any engine
        lock (stores never mutate rows in place).

        Segmented and append-only: rows are immutable once appended, so a
        flush writes one new segment for the rows since the last seal,
        rewrites only the small mutable files (bitmap, index state,
        schema) and commits by an atomic MANIFEST.json replace; a crash
        mid-flush leaves the previous manifest pointing at intact
        files."""
        os.makedirs(os.path.join(dirpath, "segments"), exist_ok=True)
        count = len(snap["table"]["keys"])
        in_place = bool(
            self.data_dir
            and os.path.commonpath(
                [os.path.abspath(dirpath), os.path.abspath(self.data_dir)]
            ) == os.path.abspath(self.data_dir)
        )
        segs = self._read_manifest(dirpath)
        while segs and segs[-1]["end"] > count:
            segs.pop()  # rewind (restore or truncation): reseal the tail
        sealed = segs[-1]["end"] if segs else 0
        # compaction: merge the undersized trailing run into this flush
        # once it grows long, so the count stays ~count/target + 8
        small = 0
        while (small < len(segs)
               and (segs[-1 - small]["end"] - segs[-1 - small]["start"])
               < self.SEGMENT_TARGET_ROWS):
            small += 1
        if small > self.MAX_SMALL_SEGMENTS:
            sealed = segs[len(segs) - small]["start"]
            del segs[len(segs) - small:]
        if sealed < count:
            segs.append(self._write_segment(snap, dirpath, sealed, count,
                                            in_place))
        with open(os.path.join(dirpath, "schema.json"), "w") as f:
            json.dump(self.schema.to_dict(), f)
        np.save(os.path.join(dirpath, "bitmap.npy"), snap["bits"])
        for name, view in snap["vecs"].items():
            store = self.vector_stores[name]
            if in_place and getattr(store, "durable_on_disk", False):
                # a disk store dumping into its own data_dir: msync and
                # record the durable count instead of copying the file
                store.flush_disk(n=view.shape[0])
        for name, index in self.indexes.items():
            state = index.dump_state()
            if state:
                np.savez(os.path.join(dirpath, f"index_{name}.npz"), **state)
        with open(os.path.join(dirpath, "engine.json"), "w") as f:
            json.dump({"status": snap["status"]}, f)
        tmp = os.path.join(dirpath, "MANIFEST.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"format": 2, "doc_count": count, "segments": segs}, f)
        os.replace(tmp, os.path.join(dirpath, "MANIFEST.json"))
        # drop segment directories the committed manifest no longer names
        keep = {s["name"] for s in segs}
        segroot = os.path.join(dirpath, "segments")
        for nm in os.listdir(segroot):
            if nm not in keep:
                shutil.rmtree(os.path.join(segroot, nm), ignore_errors=True)

    def dump(self, dirpath: str | None = None) -> None:
        dirpath = dirpath or self.data_dir
        if not dirpath:
            raise ValueError("no dump directory given and no data_dir set")
        self.write_snapshot(self.snapshot_state(), dirpath)

    def load(self, dirpath: str | None = None) -> None:
        """Restore a dump (segmented, or the legacy flat layout) into this
        engine. Index state passes through
        `convert.index_state_from_reference`, so a dump either package
        wrote loads; loading re-absorbs every row."""
        from vearch_tpu_torch.convert import index_state_from_reference

        dirpath = dirpath or self.data_dir
        if not dirpath or not os.path.exists(dirpath):
            raise FileNotFoundError(f"no dump at {dirpath}")
        if os.path.exists(os.path.join(dirpath, "MANIFEST.json")):
            self._load_segmented(dirpath)
        else:  # legacy flat dump (pre-segment backups)
            self.table.load(os.path.join(dirpath, "table"))
            self.bitmap.load(os.path.join(dirpath, "bitmap.npy"))
            for name, store in self.vector_stores.items():
                store.load(os.path.join(dirpath, f"vectors_{name}.npy"))
        for name, index in self.indexes.items():
            p = os.path.join(dirpath, f"index_{name}.npz")
            if os.path.exists(p):
                with np.load(p, allow_pickle=False) as data:
                    index.load_state(index_state_from_reference(dict(data)))
        with open(os.path.join(dirpath, "engine.json")) as f:
            self.status = IndexStatus(json.load(f)["status"])
        if self._scalar_manager is not None:
            self._scalar_manager.rebuild_from_table(self.table)
        self.data_version += 1

    def _load_segmented(self, dirpath: str) -> None:
        segs = self._read_manifest(dirpath)
        self.bitmap.load(os.path.join(dirpath, "bitmap.npy"))
        keys: list[str] = []
        strings: dict[str, list] = {n: [] for n in self.table._strings}
        fixed_parts: dict[str, list[np.ndarray]] = {
            n: [] for n in self.table._fixed}
        for s in segs:
            sd = os.path.join(dirpath, "segments", s["name"])
            with open(os.path.join(sd, "table.json")) as f:
                meta = json.load(f)
            keys.extend(meta["keys"])
            for n in strings:
                part = meta["strings"].get(n)
                if part is None:
                    # the segment predates this column (e.g. the hidden
                    # presence column): pad so lengths stay row-aligned
                    part = [None] * len(meta["keys"])
                strings[n].extend(part)
            with np.load(os.path.join(sd, "table.npz")) as data:
                for n in fixed_parts:
                    fixed_parts[n].append(data[n])
        fixed = {
            n: (np.concatenate(parts) if parts
                else np.zeros(0, self.table._fixed[n].dtype))
            for n, parts in fixed_parts.items()
        }
        self.table.load_from_segments(
            keys, strings, fixed, self.bitmap.valid_mask(len(keys)))
        for name, store in self.vector_stores.items():
            paths = [
                p for s in segs
                if os.path.exists(p := os.path.join(
                    dirpath, "segments", s["name"], f"vectors_{name}.npy"))
            ]
            if paths:
                store.load_parts(paths)
            else:  # in-place disk store: roll back via its meta barrier
                store.load(os.path.join(dirpath, f"vectors_{name}.npy"))

    @classmethod
    def open(cls, dirpath: str, device=None) -> "Engine":
        """An engine restored from a dump directory (which becomes its
        data_dir), on `device` (default cuda)."""
        with open(os.path.join(dirpath, "schema.json")) as f:
            schema = TableSchema.from_dict(json.load(f))
        eng = cls(schema, device=device, data_dir=dirpath)
        eng.load(dirpath)
        return eng
