"""IVFFLAT and IVFPQ indexes, the port of vearch_tpu/index/ivf.py
(`_IVFBase`, `IVFFlatIndex`, `IVFPQIndex`).

- host side keeps per-cluster docid lists and, for IVFPQ, the [n, m] PQ
  codes; absorb assigns rows to coarse cells and marks the buckets dirty;
- the probe regime packs the lists into padded [nlist, cap, ...] device
  tensors (cap = the longest list rounded up to 128) on the first search
  after an absorb; deletes never republish, the validity mask is applied
  per slot;
- IVFFLAT scans its buckets of raw vectors (exact scores, no rerank);
- IVFPQ has two regimes (`scan_mode`, "auto" = full while the row count
  fits `full_scan_limit`): the full scan over the docid-ordered int8
  mirror (block-max selection through the Hopper kernel on a GPU), and
  the probe scan over int8 residual buckets (the probe-dots Hopper
  kernel on a GPU, whatever `probe_kernel` says; on the CPU its plain
  version with "pallas" and the reference's XLA loop with "xla"). Both
  rerank their candidates exactly against the raw store, unless
  `_exact_rerank_enabled` says no (SCANN's `reordering: false`). On a
  disk store (engine/disk_vector.py) the full scan is never fused with
  the rerank: the scan selects its candidates on the device and the
  rerank gathers their raw rows on the host (`_store_paths`);
- `quantizer_type: hnsw` puts a host HNSW graph over the centroids
  (native/hnsw_graph.py): absorb assigns rows by a graph walk, and the
  probe regime takes its probe cells from the graph (`probes=`), -1
  slots included. Where the reference falls back to the flat quantizer
  with a warning when the native build fails, the port raises;
- `_fit_codebooks` / `_encode_rows` are the codebook hooks SCANN
  overrides;
- IVFPQ's `mirror_dtype: "int4"` keeps the full-scan mirror as packed
  int4 rows (half the resident bytes), scanned by
  `ops/ivf.int4_scan_candidates`; `opq: true` learns an orthonormal
  rotation R before PQ (alternating PQ training on rotated residuals
  with the Procrustes update R = U V^T from svd(resid^T decoded), host
  numpy, `opq_iters` rounds): codes live in the rotated space, and the
  mirror and the probe buckets hold the approximations rotated back, so
  neither scan sees R;
- `reconstruction_error` (the quality monitor's drift gauge) decodes the
  stored codes on the host: 0.0 for IVFFLAT, whose buckets hold the raw
  rows.

Device footprint (`device_footprint_bytes`): the raw store, the
centroids, the published bucket tensors and, for IVFPQ, the codebooks
and the mirror, as in the reference; the port also keeps
`_bucket_lens` ([nlist] int32) beside the probe buckets and counts it.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: mesh serving and mesh training.
"""

from __future__ import annotations

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
from vearch_tpu_torch.ops import kmeans as km
from vearch_tpu_torch.ops import pq as pq_ops
from vearch_tpu_torch.ops.blockmax_scan import int8_blockmax_scan
from vearch_tpu_torch.ops.distance import sqnorms, to_device_mask
from vearch_tpu_torch.ops.probe_dots import ivfpq_probe_search


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _IVFBase(VectorIndex):
    needs_training = True

    def __init__(self, params: IndexParams, store: RawVectorStore):
        super().__init__(params, store)
        self.nlist = int(params.get("ncentroids", params.get("nlist", 256)))
        self.default_nprobe = int(params.get("nprobe", 16))
        self.train_sample = int(params.get("training_sample", 262_144))
        self.train_iters = int(params.get("train_iters", 10))
        # coarse quantizer: the [B, nlist] product ("flat") or a host HNSW
        # graph over the centroids ("hnsw", the reference's
        # quantizer_type_), which keeps probe selection on the host
        self.quantizer_type = str(params.get("quantizer_type", "flat")).lower()
        self._coarse_graph = None
        if bool(params.get("mesh_train", False)):
            raise NotImplementedError(
                "mesh_train is not ported yet (ROADMAP queue 1 item 10)")
        self.centroids: torch.Tensor | None = None  # [nlist, d] f32
        self._members: list[list[int]] = []  # per-cluster docid lists
        self._dirty = True
        # published probe-regime state
        self._bucket_ids: torch.Tensor | None = None  # [nlist, cap] int32
        self._cap = 0

    def _device_state_arrays(self) -> tuple:
        """Device tensors this index keeps beyond the raw store (the
        footprint model's input; subclasses extend)."""
        return (self.centroids, self._bucket_ids)

    def device_footprint_bytes(self) -> int:
        return super().device_footprint_bytes() + sum(
            a.numel() * a.element_size()
            for a in self._device_state_arrays() if a is not None)

    # -- training ------------------------------------------------------------

    def _sample(self, x: np.ndarray) -> np.ndarray:
        if x.shape[0] <= self.train_sample:
            return x
        idx = np.random.default_rng(0).choice(
            x.shape[0], self.train_sample, replace=False
        )
        return x[idx]

    def _maybe_normalize(self, x: np.ndarray) -> np.ndarray:
        """Cosine rides the IP machinery on normalized vectors."""
        if self.metric is MetricType.COSINE:
            n = np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-15)
            return (x / n).astype(np.float32)
        return x

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(x, np.float32)
        if not a.flags.writeable:  # e.g. arrays handed over from JAX
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def train(self, sample: np.ndarray) -> None:
        x = self._maybe_normalize(self._sample(np.asarray(sample, np.float32)))
        self.centroids = km.train_kmeans(
            self._to_device(x), k=self.nlist, iters=self.train_iters
        )
        self._members = [[] for _ in range(self.nlist)]
        self._build_coarse_graph()
        self._train_extra(x)
        self.trained = True

    def _build_coarse_graph(self) -> None:
        """The HNSW graph over the centroids (M=16, efConstruction=200,
        the graph's fixed seed), for quantizer_type=hnsw. A failed native
        build raises: the reference would serve the flat quantizer
        instead, which hides what ran."""
        if self.quantizer_type != "hnsw":
            return
        g = HnswGraph(self.store.dimension, m=16, ef_construction=200,
                      ip=False)
        g.add(_host(self.centroids))
        self._coarse_graph = g

    def _assign(self, rows: np.ndarray) -> np.ndarray:
        """Cell of each row: nearest centroid by the bf16 product, as the
        reference assigns, or the host graph's walk (quantizer_type=hnsw,
        ef 96)."""
        if self._coarse_graph is not None:
            _s, ids = self._coarse_graph.search(rows, 1, ef=96)
            return ids[:, 0].astype(np.int64)
        return _host(km.assign_clusters(self._to_device(rows),
                                        self.centroids))

    def _host_probes(self, q: np.ndarray, nprobe: int
                     ) -> torch.Tensor | None:
        """[B, nprobe] int32 probe cells from the host graph, on the
        device, or None for the product's selection. A -1 slot (the graph
        came up short) passes through: the scans mask that step, where
        clamping it to a real cell would scan that cell twice and
        duplicate its docids."""
        if self._coarse_graph is None:
            return None
        _s, ids = self._coarse_graph.search(
            q, min(nprobe, self.nlist), ef=max(2 * nprobe, 64))
        return torch.from_numpy(ids.astype(np.int32)).to(self.device)

    def _train_extra(self, sample: np.ndarray) -> None:
        pass

    # -- realtime absorb -----------------------------------------------------

    def absorb(self, upto: int) -> None:
        with self._absorb_lock:
            if not self.trained or upto <= self.indexed_count:
                self.indexed_count = max(self.indexed_count, upto)
                return
            start = self.indexed_count
            rows = self._maybe_normalize(
                self.store.host_view()[start:upto].astype(np.float32)
            )
            assign = self._assign(rows)
            self._absorb_rows(rows, assign, start)
            # vectorised bucket grouping: argsort by cluster + split
            order = np.argsort(assign, kind="stable")
            sorted_assign = assign[order]
            docids = order.astype(np.int64) + start
            boundaries = np.searchsorted(
                sorted_assign, np.arange(self.nlist + 1)
            )
            for c in np.unique(sorted_assign):
                lo, hi = boundaries[c], boundaries[c + 1]
                self._members[int(c)].extend(docids[lo:hi].tolist())
            self.indexed_count = upto
            self._dirty = True

    def _absorb_rows(
        self, rows: np.ndarray, assign: np.ndarray, start_docid: int
    ) -> None:
        pass

    # -- publish -------------------------------------------------------------

    def _bucket_shape(self) -> int:
        longest = max((len(mm) for mm in self._members), default=0)
        return max(128, -(-longest // 128) * 128)

    def _publish_ids(self) -> np.ndarray:
        cap = self._bucket_shape()
        ids = np.full((self.nlist, cap), -1, dtype=np.int32)
        for c, mm in enumerate(self._members):
            if mm:
                ids[c, : len(mm)] = mm
        self._cap = cap
        self._bucket_ids = torch.from_numpy(ids).to(self.device)
        return ids

    def _publish(self) -> None:
        """Rebuild the bucket tensors if an absorb changed the lists since
        the last publish. Under the absorb lock: an absorb would grow the
        lists between the capacity sizing and the fill loop."""
        with self._absorb_lock:
            if self._dirty or self._bucket_ids is None:
                self._publish_buckets(self._publish_ids())
                self._dirty = False

    def _publish_buckets(self, ids: np.ndarray) -> None:
        """Fill the subclass's bucket tensors for the published ids."""
        raise NotImplementedError

    def _valid_device(self, valid_mask, n: int) -> torch.Tensor:
        # padded to the store's capacity, which bounds every docid in the
        # buckets and changes only when the store doubles
        return to_device_mask(valid_mask, n, max(self.store.capacity, 1),
                              self.device)

    def _nprobe(self, params: dict | None) -> int:
        p = params or {}
        return min(int(p.get("nprobe", self.default_nprobe)), self.nlist)

    # -- search helpers ------------------------------------------------------

    def _rerank_depth(self, k: int, params: dict | None) -> int:
        """Exact-rerank candidate depth, the recall knob on top of the
        quantized scan."""
        p = params or {}
        r = int(p.get("rerank", self.params.get("rerank", max(10 * k, 128))))
        return max(r, k)

    def _exact_rerank_enabled(self, params: dict | None) -> bool:
        """Whether the exact raw-store rerank runs after the quantized
        scan (SCANN's reordering=false turns it off)."""
        return True

    def _pad_to_k(
        self, scores: np.ndarray, ids: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        if scores.shape[1] >= k:
            return scores[:, :k], ids[:, :k]
        pad = k - scores.shape[1]
        return (
            np.pad(scores, ((0, 0), (0, pad)), constant_values=float("-inf")),
            np.pad(ids, ((0, 0), (0, pad)), constant_values=-1),
        )

    # -- state ---------------------------------------------------------------

    def cell_populations(self) -> list[int] | None:
        """Live per-cell member counts."""
        with self._absorb_lock:
            if not self.trained:
                return None
            return [len(mm) for mm in self._members]

    def dump_state(self) -> dict[str, Any]:
        if not self.trained:
            return {}
        return {
            "centroids": _host(self.centroids),
            "indexed_count": np.int64(self.indexed_count),
        }

    def load_state(self, state: dict[str, Any]) -> None:
        """Adopt trained quantizers and re-absorb every stored row (the
        raw vectors are the durable source of truth)."""
        if "centroids" not in state:
            return
        self.centroids = self._to_device(state["centroids"])
        self._build_coarse_graph()  # rebuilt, not carried: cheap
        self.trained = True
        self._members = [[] for _ in range(self.nlist)]
        self.indexed_count = 0
        if "codebooks" in state:
            self._load_codebooks(state)
        self.absorb(self.store.count)

    def _load_codebooks(self, state: dict[str, Any]) -> None:
        pass


@register_index("IVFFLAT")
class IVFFlatIndex(_IVFBase):
    """IVF over the raw vectors: buckets hold the rows in `store_dtype`,
    so the probe scan's scores are exact and need no rerank."""

    def __init__(self, params: IndexParams, store: RawVectorStore):
        super().__init__(params, store)
        self._bucket_vecs: torch.Tensor | None = None    # [nlist, cap, d]
        self._bucket_sqnorm: torch.Tensor | None = None  # [nlist, cap] f32

    def _device_state_arrays(self) -> tuple:
        return super()._device_state_arrays() + (
            self._bucket_vecs, self._bucket_sqnorm)

    def reconstruction_error(self, sample: int = 256,
                             seed: int = 0) -> float | None:
        # the buckets hold the raw rows: scoring is exact
        return 0.0 if self.trained else None

    def _publish_buckets(self, ids: np.ndarray) -> None:
        host = self.store.host_view()
        vecs = np.zeros((self.nlist, ids.shape[1], self.store.dimension),
                        dtype=np.float32)
        for c, mm in enumerate(self._members):
            if mm:
                vecs[c, : len(mm)] = self._maybe_normalize(
                    host[np.asarray(mm, dtype=np.int64)])
        self._bucket_vecs = torch.from_numpy(vecs).to(
            self.store.store_dtype).to(self.device)
        self._bucket_sqnorm = sqnorms(self._bucket_vecs)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        valid_mask,
        params: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        assert self.trained, "IVFFLAT search before training"
        self._publish()
        nprobe = self._nprobe(params)
        r = min(self._rerank_depth(k, params), self._cap * nprobe)
        q = self._maybe_normalize(np.asarray(queries, np.float32))
        metric = (
            MetricType.INNER_PRODUCT
            if self.metric is MetricType.COSINE
            else self.metric
        )
        valid = self._valid_device(valid_mask, self.store.count)
        probes = self._host_probes(q, nprobe)
        ivf_ops.note_dispatch("ivfflat_scan")
        scores, ids = ivf_ops.ivfflat_candidates(
            self._to_device(q).to(self.store.store_dtype), self.centroids,
            self._bucket_vecs, self._bucket_sqnorm, self._bucket_ids, valid,
            nprobe, min(max(r, k), 2048), metric, probes=probes,
        )
        # the scores are exact: no rerank (cosine rides IP on normalized
        # vectors, which is the cosine itself)
        return self._pad_to_k(_host(scores), _host(ids), k)


@register_index("IVFPQ")
class IVFPQIndex(_IVFBase):
    """IVFPQ with residual PQ encoding, a docid-ordered int8 full-scan
    mirror, int8 residual buckets for the probe regime, and exact rerank
    against the raw store."""

    def __init__(self, params: IndexParams, store: RawVectorStore):
        super().__init__(params, store)
        self.m = int(params.get("nsubvector", params.get("m", 16)))
        if store.dimension % self.m != 0:
            raise ValueError(
                f"IVFPQ nsubvector={self.m} must divide dimension="
                f"{store.dimension}"
            )
        self.ksub = 1 << int(params.get("nbits_per_idx", params.get("nbits", 8)))
        # optional learned rotation before PQ
        self.opq = bool(params.get("opq", False))
        self.opq_iters = int(params.get("opq_iters", 5))
        self._opq_R: np.ndarray | None = None  # [d, d] orthonormal, host
        self.scan_mode = str(params.get("scan_mode", "auto"))
        self.full_scan_limit = int(params.get("full_scan_limit", 16_000_000))
        self._check_mesh(params.get("mesh_serving",
                                    params.get("data_parallel", "auto")))
        self.codebooks: torch.Tensor | None = None  # [m, ksub, dsub]
        self._codes: np.ndarray | None = None  # [n_indexed, m] host codes
        # row -> cell, docid-ordered (reconstruction_error reads it)
        self._assign_host = np.zeros(0, dtype=np.int32)
        # probe-regime state (bucket-grouped)
        self._bucket_resid8: torch.Tensor | None = None  # [nlist, cap, d]
        self._bucket_scale: torch.Tensor | None = None   # [nlist] f32
        self._bucket_vsq: torch.Tensor | None = None     # [nlist, cap] f32
        self._bucket_lens: torch.Tensor | None = None    # [nlist] int32
        self.mirror_storage = str(params.get("mirror_dtype", "int8")).lower()
        self._mirror = Int8Mirror(store.dimension, storage=self.mirror_storage,
                                  device=self.device)

    @staticmethod
    def _check_mesh(value) -> None:
        """The port serves one device: `mesh_serving` "auto"/"off" mean
        the single-device path (as "auto" does on one chip in the
        reference); "on" is refused."""
        if value in (True, "on", "true", "1"):
            raise NotImplementedError(
                "mesh_serving is not ported yet (ROADMAP queue 1 item 10)")

    def _device_state_arrays(self) -> tuple:
        return super()._device_state_arrays() + (
            self.codebooks, self._bucket_resid8, self._bucket_scale,
            self._bucket_vsq, self._bucket_lens)

    def device_footprint_bytes(self) -> int:
        # bucket and centroid state and the raw store (super), plus the
        # docid-ordered mirror the full scan serves from
        return super().device_footprint_bytes() + self._mirror.device_bytes()

    def _train_extra(self, sample: np.ndarray) -> None:
        assign = _host(km.assign_clusters(self._to_device(sample),
                                          self.centroids))
        resid = sample - _host(self.centroids)[assign]
        if self.opq:
            # OPQ: alternate PQ training on the rotated residuals with the
            # Procrustes update R = U V^T from svd(resid^T decoded)
            R = np.eye(resid.shape[1], dtype=np.float32)
            for _ in range(self.opq_iters):
                z = self._to_device(resid @ R)
                codebooks = pq_ops.train_pq(
                    z, m=self.m, ksub=self.ksub,
                    iters=max(self.train_iters // 2, 2))
                decoded = pq_ops.decode_pq_np(
                    _host(pq_ops.encode_pq(z, codebooks)), codebooks)
                u, _s, vt = np.linalg.svd(resid.T @ decoded)
                R = (u @ vt).astype(np.float32)
            self._opq_R = R
            resid = resid @ R
        self.codebooks = self._fit_codebooks(resid, sample)
        self._codes = np.zeros((0, self.m), dtype=np.uint8)

    def _fit_codebooks(self, resid: np.ndarray, sample: np.ndarray
                       ) -> torch.Tensor:
        """Codebook trainer hook (SCANN trains anisotropic codebooks;
        `sample` is the rows the residuals came from)."""
        return pq_ops.train_pq(self._to_device(resid), m=self.m,
                               ksub=self.ksub, iters=self.train_iters)

    def _encode_rows(self, resid: np.ndarray, rows: np.ndarray
                     ) -> np.ndarray:
        """Encoder hook (the same seam as `_fit_codebooks`): [n, m] uint8
        codes of the residuals."""
        return _host(pq_ops.encode_pq(self._to_device(resid),
                                      self.codebooks))

    def _absorb_rows(
        self, rows: np.ndarray, assign: np.ndarray, start_docid: int
    ) -> None:
        cents = _host(self.centroids)
        resid = rows - cents[assign]
        if self._opq_R is not None:
            resid = resid @ self._opq_R  # encode in the rotated space
        codes = self._encode_rows(resid, rows)
        if self._codes is None:
            self._codes = np.zeros((0, self.m), dtype=np.uint8)
        need = start_docid + rows.shape[0]
        if self._codes.shape[0] < need:
            grown = np.zeros((max(need, self._codes.shape[0] * 2), self.m),
                             dtype=np.uint8)
            grown[: self._codes.shape[0]] = self._codes
            self._codes = grown
        self._codes[start_docid:need] = codes
        if self._assign_host.shape[0] < need:
            ga = np.zeros(max(need, self._assign_host.shape[0] * 2),
                          dtype=np.int32)
            ga[: self._assign_host.shape[0]] = self._assign_host
            self._assign_host = ga
        self._assign_host[start_docid:need] = assign.astype(np.int32)
        # docid-ordered mirror: decode the PQ approximation, rotate it
        # back (OPQ), add the centroid, quantize per row, append
        approx = cents[assign] + self._decode(codes)
        if self.metric is MetricType.COSINE:
            # re-normalize: PQ error perturbs the norm, and the IP scan
            # would rank by (1 +- err) * cos
            approx = approx / np.maximum(
                np.linalg.norm(approx, axis=1, keepdims=True), 1e-12)
        self._mirror.append(approx, start=start_docid)

    def _decode(self, codes: np.ndarray) -> np.ndarray:
        """PQ codes -> residual approximations in the original space."""
        decoded = pq_ops.decode_pq_np(codes, self.codebooks)
        if self._opq_R is not None:
            decoded = decoded @ self._opq_R.T
        return decoded

    def reconstruction_error(self, sample: int = 256,
                             seed: int = 0) -> float | None:
        """Decode the stored codes (the serving representation) back to
        full vectors and compare them with the raw rows: host numpy only.
        Covers SCANN too (the same stored-code layout)."""
        with self._absorb_lock:
            n = int(self.indexed_count)
            if not self.trained or n == 0 or self._codes is None:
                return None
            rng = np.random.default_rng(seed)
            ids = np.sort(rng.choice(n, size=min(int(sample), n),
                                     replace=False))
            raw = self._maybe_normalize(
                np.asarray(self.store.host_view()[ids], dtype=np.float32))
            approx = (_host(self.centroids)[self._assign_host[ids]]
                      + self._decode(self._codes[ids]))
            if self.metric is MetricType.COSINE:
                approx = approx / np.maximum(
                    np.linalg.norm(approx, axis=1, keepdims=True), 1e-12)
            num = np.linalg.norm(raw - approx, axis=1)
            den = np.maximum(np.linalg.norm(raw, axis=1), 1e-12)
            return float(np.mean(num / den))

    def search(
        self,
        queries: np.ndarray,
        k: int,
        valid_mask,
        params: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        assert self.trained, "IVFPQ search before training"
        p = params or {}
        q = self._maybe_normalize(np.asarray(queries, np.float32))
        metric = (
            MetricType.INNER_PRODUCT
            if self.metric is MetricType.COSINE
            else self.metric
        )
        self._check_mesh(p.get("mesh_serving",
                               self.params.get("mesh_serving", "auto")))
        scan_kernel = p.get("scan_kernel",
                            self.params.get("scan_kernel", "xla"))
        if scan_kernel not in ("xla", "pallas"):
            raise ValueError(f"scan_kernel must be xla|pallas, got "
                             f"{scan_kernel!r}")
        mode = p.get("scan_mode", self.scan_mode)
        if mode == "auto":
            mode = ("full" if self.indexed_count <= self.full_scan_limit
                    else "probe")
        qt = self._to_device(q)
        rerank = self._exact_rerank_enabled(p)
        if mode != "full":
            cand_s, cand_i = self._probe_candidates(q, qt, k, valid_mask, p,
                                                    metric)
        else:
            approx8, scale, vsq = self._mirror.flush()
            valid = to_device_mask(valid_mask, self.indexed_count,
                                   approx8.shape[0], self.device)
            r = min(self._rerank_depth(k, p), max(self.indexed_count, 1))
            topk_mode = p.get("topk_mode",
                              self.params.get("topk_mode", "auto"))
            fused = p.get("fused_rerank",
                          self.params.get("fused_rerank", True))
            if scan_kernel == "pallas" and self.mirror_storage == "int8":
                # the reference's one-pass block-max entry point; on a
                # GPU both scan_kernel values reach the same Hopper kernel
                ivf_ops.note_dispatch("pallas_blockmax_scan")
                cand_s, cand_i = int8_blockmax_scan(
                    qt, approx8, scale, vsq, valid, max(r, k),
                    metric is MetricType.L2,
                )
            elif fused and rerank and not is_disk_store(self.store):
                base, base_sqnorm, _ = self.store.device_buffer()
                ivf_ops.note_dispatch("fused_scan_rerank")
                scores, ids = ivf_ops.int8_scan_rerank(
                    qt, approx8, scale, vsq, valid, base, base_sqnorm,
                    max(r, k), k, scan_metric=metric,
                    rerank_metric=self.metric, topk_mode=topk_mode,
                    storage=self.mirror_storage,
                )
                return self._pad_to_k(_host(scores), _host(ids), k)
            else:
                scan = (ivf_ops.int8_scan_candidates
                        if self.mirror_storage == "int8"
                        else ivf_ops.int4_scan_candidates)
                ivf_ops.note_dispatch("scan")
                cand_s, cand_i = scan(
                    qt, approx8, scale, vsq, valid, max(r, k), metric,
                    topk_mode,
                )
        if not rerank:
            # the quantized scores as they are, best first: no raw-store
            # gather
            return self._pad_to_k(_host(cand_s[:, :k]), _host(cand_i[:, :k]),
                                  k)
        return self._rerank(q, cand_i, k)

    def _probe_candidates(self, q: np.ndarray, qt: torch.Tensor, k: int,
                          valid_mask, p: dict, metric: MetricType
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """Probe regime: ([B, r] scores, [B, r] docids, -1 for masked)
        from the bucket-grouped int8 residuals, republished after any
        absorb."""
        self._publish()
        nprobe = self._nprobe(p)
        r = min(self._rerank_depth(k, p), self._cap * nprobe, 2048)
        valid = self._valid_device(valid_mask, self.store.count)
        # the reference takes its Pallas kernel on the accelerator and its
        # XLA loop elsewhere. On a GPU both values launch the kernel, as
        # both scan_kernel values do; on the CPU "pallas" runs the
        # kernel's plain version and "xla" (the default) the loop
        kernel = p.get("probe_kernel", self.params.get(
            "probe_kernel", "pallas" if self.device.type == "cuda" else "xla"))
        if kernel not in ("xla", "pallas"):
            raise ValueError(f"probe_kernel must be xla|pallas, got "
                             f"{kernel!r}")
        # host probes (quantizer_type=hnsw) reach either arm as `probes`
        probes = self._host_probes(q, nprobe)
        ivf_ops.note_dispatch("probe_scan")
        args = (qt, self.centroids, self._bucket_resid8, self._bucket_scale,
                self._bucket_vsq, self._bucket_ids, valid, nprobe, max(r, k))
        if kernel == "pallas" or self.device.type == "cuda":
            return ivfpq_probe_search(*args, metric is MetricType.L2,
                                      self._bucket_lens, probes)
        return ivf_ops.ivfpq_candidates(*args, metric, probes)

    def _rerank(self, q: np.ndarray, cand_i: torch.Tensor, k: int
                ) -> tuple[np.ndarray, np.ndarray]:
        ivf_ops.note_dispatch("rerank")
        scores, ids = rerank_against_store(
            self.store, q, cand_i, min(k, int(cand_i.shape[1])), self.metric,
        )
        return self._pad_to_k(_host(scores), _host(ids), k)

    def _publish_buckets(self, ids: np.ndarray) -> None:
        """Decode the PQ codes per cluster into int8 residual buckets with
        one dequant scale per bucket (host numpy, as the reference does),
        then move them to the device."""
        cap = ids.shape[1]
        cents = _host(self.centroids)
        codebooks = _host(self.codebooks)
        resid8 = np.zeros((self.nlist, cap, self.store.dimension),
                          dtype=np.int8)
        scales = np.ones(self.nlist, dtype=np.float32)
        vsq = np.zeros((self.nlist, cap), dtype=np.float32)
        for c, mm in enumerate(self._members):
            if not mm:
                continue
            rows = np.asarray(mm, dtype=np.int64)
            decoded = pq_ops.decode_pq_np(self._codes[rows], codebooks)
            if self._opq_R is not None:
                decoded = decoded @ self._opq_R.T  # back to the original
            if self.metric is MetricType.COSINE:
                # the residual against the normalized approximation, so
                # cent_c + s*r8 reconstructs a unit-norm vector (the
                # mirror's re-normalization)
                full = cents[c][None, :] + decoded
                full /= np.maximum(
                    np.linalg.norm(full, axis=1, keepdims=True), 1e-12)
                decoded = full - cents[c][None, :]
            scale = max(float(np.abs(decoded).max()) / 127.0, 1e-12)
            q8 = np.clip(np.rint(decoded / scale), -127, 127).astype(np.int8)
            approx = cents[c][None, :] + scale * q8.astype(np.float32)
            resid8[c, : len(mm)] = q8
            scales[c] = scale
            vsq[c, : len(mm)] = np.sum(approx * approx, axis=1)
        self._bucket_resid8 = torch.from_numpy(resid8).to(self.device)
        self._bucket_scale = torch.from_numpy(scales).to(self.device)
        self._bucket_vsq = torch.from_numpy(vsq).to(self.device)
        # each cell's members sit at the front of its bucket: the kernel
        # reads no row past this length
        self._bucket_lens = torch.tensor(
            [len(mm) for mm in self._members], dtype=torch.int32,
            device=self.device)

    def dump_state(self) -> dict[str, Any]:
        state = super().dump_state()
        if state and self.codebooks is not None:
            state["codebooks"] = _host(self.codebooks)
            if self._opq_R is not None:
                state["opq_R"] = self._opq_R
        return state

    def _load_codebooks(self, state: dict[str, Any]) -> None:
        self.codebooks = self._to_device(state["codebooks"])
        if "opq_R" in state:
            self._opq_R = np.asarray(state["opq_R"], dtype=np.float32)
        self._codes = np.zeros((0, self.m), dtype=np.uint8)
