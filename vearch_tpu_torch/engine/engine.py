"""Per-partition engine, the port of vearch_tpu/engine/engine.py: table +
raw vector stores + indexes + deletion bitmap.

Write model (as in the reference): everything is append-only. An update
soft-deletes the old docid and appends a new row, so device buffers never
mutate rows; deletions are masked inside the scan.

This slice keeps the reference's direct search path (`_search_direct`):
rows padded to the declared row buckets, candidate depth raised to the
fetch-k tiers, the alive mask cached on the device per bitmap version,
and per-request filter masks. Not ported yet: the BatchScheduler
(`search` goes straight to `_search_direct`), dump/open, scalar indexes,
accounting and observability hooks (ROADMAP queue 1 item 2).
"""

from __future__ import annotations

import json
import threading
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
from vearch_tpu_torch.engine.types import (
    IndexParams,
    IndexStatus,
    MetricType,
    SearchResult,
    SearchResultItem,
    TableSchema,
)
from vearch_tpu_torch.index.base import VectorIndex
from vearch_tpu_torch.index.registry import create_index
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.distance import score_to_metric


@dataclass
class SearchRequest:
    """One batched vector search (the reference's SearchRequest without
    its tracing and cancellation fields).

    vectors: field name -> [B, d] query matrix; several fields merge with
    `field_weights`. filters: a scalar-filter AST (scalar/filter.py) or
    None."""

    vectors: dict[str, np.ndarray]
    k: int = 10
    filters: Any = None
    include_fields: list[str] | None = None
    field_weights: dict[str, float] = field(default_factory=dict)
    index_params: dict[str, Any] = field(default_factory=dict)  # rerank etc.
    # {field: (min_score, max_score)} on each field's metric-oriented score
    score_bounds: dict[str, tuple] | None = None
    # normalized scalar-field sort specs (engine/sort.py parse_sort)
    sort: list[dict] | None = None
    # fields-free columnar result shape (ColumnarSearchResults)
    raw_results: bool = False


class Engine:
    def __init__(self, schema: TableSchema, device=None):
        self.device = resolve_device(device)
        if schema.composite_indexes or any(
            f.scalar_index.value != "NONE" for f in schema.scalar_fields()
        ):
            raise NotImplementedError(
                "scalar indexes are not ported yet (ROADMAP queue 1 item 2); "
                "filters evaluate against the table's columns")
        self.schema = schema
        self.table = Table(schema)
        self.bitmap = BitmapManager()
        self.vector_stores: dict[str, RawVectorStore] = {}
        self.indexes: dict[str, VectorIndex] = {}
        self.status = IndexStatus.UNINDEXED
        self.last_build_error: BaseException | None = None
        self._write_lock = threading.Lock()
        # monotone data version: bumped by every mutation that can change
        # search results; keys the filter-mask cache
        self.data_version = 0
        self._filter_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._filter_cache_lock = threading.Lock()
        self._filter_cache_max = 128
        self._mask_cache = None
        self._mask_cache_key = None
        self._build_thread: threading.Thread | None = None
        for f in schema.vector_fields():
            params = f.index or IndexParams()
            store_type = str(params.get("store_type", "MemoryOnly"))
            if store_type in ("Disk", "RocksDB") or params.index_type.upper() \
                    in ("DISKANN", "DISKANN_STATIC"):
                raise NotImplementedError(
                    "disk stores are not ported yet (ROADMAP queue 1 item 7)")
            store = RawVectorStore(
                f.dimension, store_dtype=params.get("store_dtype", "float32"),
                device=self.device,
            )
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
            for doc in docs:
                key = str(doc["_id"]) if "_id" in doc else uuid.uuid4().hex
                fields = {k: v for k, v in doc.items() if k != "_id"}
                prev_id = self.table.docid_of(key)
                if prev_id is not None:
                    prev_set = self.table.set_fields_of(prev_id)
                    for name, val in self.table.get_fields(
                            prev_id, list(prev_set)).items():
                        fields.setdefault(name, val)
                _docid, old = self.table.add(key, fields)
                if old is not None:
                    self.bitmap.set_deleted(old)
                keys.append(key)
            for f in vf:
                self.vector_stores[f.name].add(mats[f.name])
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

    def build_index(self, field_name: str | None = None) -> None:
        """Train (where needed) and absorb all current rows."""
        self.status = IndexStatus.TRAINING
        try:
            for name, index in self.indexes.items():
                if field_name is not None and name != field_name:
                    continue
                store = self.vector_stores[name]
                if index.needs_training and not index.trained:
                    index.train(store.host_view())
                index.absorb(store.count)
        except Exception as e:
            # a failed build must not wedge the engine in TRAINING
            self.last_build_error = e
            self.status = IndexStatus.UNINDEXED
            raise
        self.status = IndexStatus.INDEXED

    # -- search --------------------------------------------------------------

    def _device_alive_mask(self, n: int) -> torch.Tensor:
        key = (self.bitmap.version, n)
        if self._mask_cache_key != key:
            self._mask_cache = torch.from_numpy(
                self.bitmap.valid_mask(n).copy()).to(self.device)
            self._mask_cache_key = key
        return self._mask_cache

    def _filtered_mask(self, filters: Any, n: int) -> np.ndarray:
        """Alive-and-filter mask for the first `n` rows, cached on
        (filter expression, data_version, n)."""
        from vearch_tpu_torch.scalar.filter import evaluate_filter

        version = self.data_version
        try:
            fkey = json.dumps(filters, sort_keys=True, default=str)
        except (TypeError, ValueError):
            fkey = None  # un-canonicalizable filter object: no caching
        key = (fkey, version, n)
        if fkey is not None:
            with self._filter_cache_lock:
                mask = self._filter_cache.get(key)
                if mask is not None:
                    self._filter_cache.move_to_end(key)
                    return mask
        mask = self.bitmap.valid_mask(n) & evaluate_filter(
            filters, self.table, n)
        if fkey is not None:
            with self._filter_cache_lock:
                self._filter_cache[key] = mask
                while len(self._filter_cache) > self._filter_cache_max:
                    self._filter_cache.popitem(last=False)
        return mask

    def search(self, req: SearchRequest) -> list[SearchResult]:
        """Search entry. The reference batches compatible requests here
        (engine/batching.py); this slice serves every request directly."""
        return self._search_direct(req)

    def _search_direct(self, req: SearchRequest) -> list[SearchResult]:
        if not req.vectors:
            raise ValueError("search needs at least one vector field")
        n = self.table.doc_count
        if req.filters is not None:
            valid = self._filtered_mask(req.filters, n)
        else:
            # the alive mask changes only on writes: keep it on the device
            valid = self._device_alive_mask(n)
        metrics = {self.indexes[name].metric for name in req.vectors}
        if len(metrics) > 1:
            raise ValueError(
                "multi-field search requires a single metric across "
                f"fields; got {[m.value for m in metrics]}"
            )
        per_field: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        queries_by_field: dict[str, np.ndarray] = {}
        # padded shape buckets (ops/perf_model.py), as the reference pads
        # every serving dispatch: k=10 scans at fetch-k 16
        fetch_k = perf_model.bucket_fetch_k(
            req.k if len(req.vectors) == 1 else max(req.k * 4, 50))
        for name, queries in req.vectors.items():
            index = self.indexes[name]
            store = self.vector_stores[name]
            queries = np.asarray(queries)
            if queries.ndim == 1:
                queries = queries[None, :]
            queries = index.decode_input(
                queries.reshape(queries.shape[0], index.input_dim))
            queries_by_field[name] = queries
            b_rows = int(queries.shape[0])
            # pad rows up to the declared bucket with a REAL row (a zero
            # row is degenerate under cosine); every scan path is per-row,
            # so the pad rows change nothing for real rows
            q_run = queries
            bb = perf_model.bucket_rows(b_rows)
            if bb != b_rows:
                q_run = np.concatenate(
                    [queries, np.repeat(queries[-1:], bb - b_rows, 0)])
            if index.trained:
                if index.indexed_count < store.count:
                    index.absorb(store.count)  # realtime pump
                scores, ids = index.search(
                    q_run, fetch_k, valid, req.index_params or None)
            else:
                # brute-force fallback below the training threshold
                from vearch_tpu_torch.index.flat import FlatIndex

                flat = FlatIndex(IndexParams(metric_type=index.metric), store)
                scores, ids = flat.search(q_run, fetch_k, valid)
            per_field[name] = (scores[:b_rows], ids[:b_rows])
        merged = self._merge_fields(per_field, queries_by_field, req)
        return self._shape_results(merged, req)

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
