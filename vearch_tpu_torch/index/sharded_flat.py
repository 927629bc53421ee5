"""FLAT_SHARDED: one exact partition spanning a device mesh, the port of
vearch_tpu/index/sharded_flat.py.

`FLAT_SHARDED`, or `FLAT` with `{"sharded": true}`, row-shards the
partition's vectors over a (data x query) mesh of the visible devices of
the store's type (`mesh_shape`, or `n_devices` / `query_axis`) and merges
the per-shard top-k on the mesh's first device
(parallel/sharded.sharded_flat_search).

Absorb tail-appends per shard: one copy of only the new rows to each
shard they touch (parallel/mesh.ShardedRowCache); a full re-place
happens only when the sharded capacity grows. The deletion and filter
mask is sharded per mask identity.
"""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams, MetricType
from vearch_tpu_torch.index.base import VectorIndex
from vearch_tpu_torch.index.registry import register_index
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.parallel import mesh as mesh_lib
from vearch_tpu_torch.parallel.sharded import sharded_flat_search


@register_index("FLAT_SHARDED")
class ShardedFlatIndex(VectorIndex):
    """Exact search over a device mesh (index_type FLAT_SHARDED, or FLAT
    with params {"sharded": true} through the registry's alias)."""

    needs_training = False

    def __init__(self, params: IndexParams, store: RawVectorStore):
        super().__init__(params, store)
        kind = self.device.type
        shape = params.get("mesh_shape")
        if shape is not None:
            self.mesh = mesh_lib.mesh_from_shape(shape, kind)
        else:
            n_dev = int(params.get("n_devices", 0)) or len(
                mesh_lib.visible_devices(kind))
            self.mesh = mesh_lib.make_mesh(
                n_dev, query_axis=int(params.get("query_axis", 1)),
                device_type=kind)
        self._sh_cache = mesh_lib.ShardedRowCache(align=128, sqnorm_of=0)
        self._placed_rows = 0
        self._valid_cache = mesh_lib.ShardedMaskCache()

    def _maybe_normalize(self, x: np.ndarray) -> np.ndarray:
        if self.metric is MetricType.COSINE:
            n = np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-15)
            return (x / n).astype(np.float32)
        return x

    def _place(self):
        """The sharded base and its |v|^2 column, tail-appended when rows
        merely grew within capacity. Normalization is per row, so an
        append window places the rows a full rebuild would."""
        n = self.store.count
        d = self.store.dimension
        dtype = self.store.store_dtype

        def build(cap):
            host = np.zeros((cap, d), dtype=np.float32)
            host[:n] = self._maybe_normalize(
                self.store.host_view()[:n].astype(np.float32))
            return (torch.from_numpy(host).to(dtype),)

        def append(lo, hi):
            win = np.zeros((hi - lo, d), dtype=np.float32)
            m = min(hi, n) - lo
            if m > 0:
                win[:m] = self._maybe_normalize(np.asarray(
                    self.store.host_view()[lo: lo + m], np.float32))
            return (torch.from_numpy(win).to(dtype),)

        (base,), _ = self._sh_cache.get(self.mesh, n, build, append)
        self._placed_rows = n
        return base, self._sh_cache.sqnorm

    def absorb(self, upto: int) -> None:
        with self._absorb_lock:
            self.indexed_count = max(self.indexed_count, upto)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        valid_mask,
        params: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        base, sqnorm = self._place()
        q = self._maybe_normalize(np.asarray(queries, np.float32))
        metric = (MetricType.INNER_PRODUCT
                  if self.metric is MetricType.COSINE else self.metric)
        n = min(self._placed_rows, base.shape[0])
        valid_dev = self._valid_cache.get(self.mesh, valid_mask, n,
                                         base.shape[0])
        qd, b = mesh_lib.shard_queries(
            self.mesh, torch.from_numpy(q).to(self.store.store_dtype))
        ivf_ops.note_dispatch("sharded_flat_scan")
        scores, ids = sharded_flat_search(
            self.mesh, base, sqnorm, valid_dev, qd, min(k, max(n, 1)),
            metric)
        scores = scores[:b].cpu().numpy()
        ids = ids[:b].cpu().numpy()
        if scores.shape[1] < k:
            pad = k - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)),
                            constant_values=float("-inf"))
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return scores[:, :k], ids[:, :k]

    def placement_stats(self) -> dict:
        """Rebuild / append / host-to-device counters of the placement."""
        return dict(self._sh_cache.stats)

    def mesh_info(self) -> dict | None:
        return {
            "devices": int(self.mesh.size),
            "data_shards": int(self.mesh.shape["data"]),
            "query_shards": int(self.mesh.shape["query"]),
            "per_device_bytes": self.device_footprint_per_device_bytes(),
            "placement": self.placement_stats(),
        }

    def device_footprint_bytes(self) -> int:
        """The sharded base and its |v|^2 column at the sharded capacity
        (the store's own device buffer is never flushed by this index)."""
        cap = self._sh_cache.capacity(self.mesh, self.store.count)
        return perf_model.raw_store_footprint_bytes(
            cap, self.store.dimension, self.store.store_dtype.itemsize)

    def device_footprint_per_device_bytes(self) -> int:
        return perf_model.per_device_bytes(
            self.device_footprint_bytes(), 0, int(self.mesh.shape["data"]))
