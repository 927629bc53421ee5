"""HNSW index type, the port of vearch_tpu/index/hnsw.py.

Two serving modes behind the one type (param `graph`):

- **scan**: the int8 mirror scanned whole, the top `efSearch` candidates
  selected (block-max through the Hopper kernel on a GPU once the mirror
  holds enough blocks) and reranked exactly against the raw store:
  approximate, with efSearch as the recall knob, realtime inserts and
  deletes honoured;
- **graph**: the host HNSW graph (native/hnsw_graph.py), exact f32
  scores, deletes and nodes past `indexed_count` masked.

"auto" picks the graph for a disk store (engine/disk_vector.py: the scan
would read the raw rows through host gathers) and the scan otherwise,
as the reference does. `graph: true` forces the graph, `graph: false`
the scan. Where the reference's "auto" also needs its native library to
load, the port builds its own and raises if that fails.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams, MetricType
from vearch_tpu_torch.index._store_paths import (
    is_disk_store,
    rerank_against_store,
)
from vearch_tpu_torch.index.base import VectorIndex
from vearch_tpu_torch.index.int8_mirror import Int8Mirror
from vearch_tpu_torch.index.registry import register_index
from vearch_tpu_torch.native.hnsw_graph import HnswGraph
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops.distance import to_device_mask


@register_index("HNSW")
class HNSWIndex(VectorIndex):
    needs_training = False

    def __init__(self, params: IndexParams, store: RawVectorStore):
        super().__init__(params, store)
        self.ef_search = int(params.get("efSearch", params.get("ef_search", 64)))
        self.m = int(params.get("nlinks", params.get("M", 16)))
        self.ef_construction = int(
            params.get("efConstruction", params.get("ef_construction", 200))
        )
        self._mirror = Int8Mirror(store.dimension, device=self.device)
        mode = params.get("graph", "auto")
        self.use_graph = is_disk_store(store) if mode == "auto" \
            else bool(mode)
        self._graph = self._new_graph() if self.use_graph else None

    def device_footprint_bytes(self) -> int:
        # the raw store and the scan mode's int8 mirror (empty in graph
        # mode); the reference's model leaves the mirror out
        return super().device_footprint_bytes() + self._mirror.device_bytes()

    def _new_graph(self) -> HnswGraph:
        return HnswGraph(self.store.dimension, m=self.m,
                         ef_construction=self.ef_construction,
                         ip=self.metric is not MetricType.L2)

    def _maybe_normalize(self, x: np.ndarray) -> np.ndarray:
        if self.metric is MetricType.COSINE:
            n = np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-15)
            return (x / n).astype(np.float32)
        return x

    def absorb(self, upto: int) -> None:
        with self._absorb_lock:
            if upto <= self.indexed_count:
                return
            start = self.indexed_count
            rows = self._maybe_normalize(
                np.asarray(self.store.host_view()[start:upto],
                           dtype=np.float32))
            if self._graph is not None:
                self._graph.add(rows)
            else:
                self._mirror.append(rows, start=start)
            self.indexed_count = upto

    def search(
        self,
        queries: np.ndarray,
        k: int,
        valid_mask,
        params: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        self.absorb(self.store.count)
        p = params or {}
        ef = max(int(p.get("efSearch", p.get("ef_search", self.ef_search))), k)
        q = self._maybe_normalize(np.asarray(queries, np.float32))
        if self._graph is not None:
            return self._search_graph(q, k, ef, valid_mask)
        return self._search_scan(q, k, ef, valid_mask)

    def _search_graph(
        self, q: np.ndarray, k: int, ef: int, valid_mask
    ) -> tuple[np.ndarray, np.ndarray]:
        mask = None
        n = self._graph.count
        if valid_mask is not None:
            if isinstance(valid_mask, torch.Tensor):
                valid_mask = valid_mask.cpu().numpy()
            mask = np.asarray(valid_mask, dtype=np.uint8)
            if mask.shape[0] < n:
                mask = np.pad(mask, (0, n - mask.shape[0]))
        elif n > self.indexed_count:
            # a crash-rollback load can leave nodes past the durable
            # count; mask them rather than serve them
            mask = np.zeros(n, dtype=np.uint8)
            mask[: self.indexed_count] = 1
        scores, ids = self._graph.search(q, k, ef, mask)
        # the graph holds full-precision rows: the scores are final (-L2^2,
        # or the dot on normalized rows)
        return scores, ids.astype(np.int64)

    def _search_scan(
        self, q: np.ndarray, k: int, ef: int, valid_mask
    ) -> tuple[np.ndarray, np.ndarray]:
        a8, scale, vsq = self._mirror.flush()
        metric = (
            MetricType.INNER_PRODUCT
            if self.metric is MetricType.COSINE
            else self.metric
        )
        valid = to_device_mask(valid_mask, self.indexed_count, a8.shape[0],
                               self.device)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        _, cand_i = ivf_ops.int8_scan_candidates(
            qt, a8, scale, vsq, valid, min(ef, max(self.indexed_count, 1)),
            metric,
        )
        scores, ids = rerank_against_store(self.store, q, cand_i, k,
                                           self.metric)
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        if scores.shape[1] < k:
            pad = k - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)),
                            constant_values=float("-inf"))
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return scores[:, :k], ids[:, :k]

    # -- state ---------------------------------------------------------------

    def dump_state(self) -> dict[str, Any]:
        """The graph as the native library saves it (the reference's
        blob: a graph either package saved loads in the other), and the
        indexed count. Scan mode keeps no state: it re-absorbs."""
        if self._graph is None or self._graph.count == 0:
            return {}
        fd, tmp = tempfile.mkstemp(suffix=".hnsw")
        os.close(fd)
        try:
            self._graph.save(tmp)
            with open(tmp, "rb") as f:
                blob = np.frombuffer(f.read(), dtype=np.uint8)
        finally:
            os.unlink(tmp)
        return {"graph_blob": blob,
                "indexed_count": np.int64(self.indexed_count)}

    def load_state(self, state: dict[str, Any]) -> None:
        if "graph_blob" not in state or self._graph is None:
            return  # scan mode re-absorbs from the raw vectors on demand
        fd, tmp = tempfile.mkstemp(suffix=".hnsw")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                f.write(np.asarray(state["graph_blob"]).tobytes())
            self._graph = HnswGraph.load(
                tmp, self.store.dimension, m=self.m,
                ef_construction=self.ef_construction,
                ip=self.metric is not MetricType.L2)
        except ValueError:
            # a corrupt blob: the raw vectors are the durable source of
            # truth, rebuild from them below
            self._graph = self._new_graph()
        finally:
            os.unlink(tmp)
        saved = int(state.get("indexed_count", self._graph.count))
        if saved != self._graph.count or saved > self.store.count:
            # graph ids must equal docids: a snapshot that does not match
            # the store would misalign every later append — rebuild
            self._graph = self._new_graph()
            self.indexed_count = 0
        else:
            self.indexed_count = saved
        self.absorb(self.store.count)  # rows past the snapshot
