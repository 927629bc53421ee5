"""IVFPQ index, the port of vearch_tpu/index/ivf.py (`_IVFBase`,
`IVFPQIndex`) in its full-scan regime.

- host side keeps per-cluster docid lists and the [n, m] PQ codes;
- absorb assigns rows to coarse cells, PQ-encodes their residuals, and
  appends the decoded approximation (centroid + residual), int8-quantized
  per row, to the docid-ordered mirror;
- search scans the mirror (block-max selection through the Hopper kernel
  on a GPU), then reranks the candidates exactly against the raw store.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: the probe regime (bucket-grouped scan, the reference's path past
`full_scan_limit` and its `ivf_probe_dots` kernel), mesh serving and mesh
training, OPQ, the HNSW coarse quantizer, int4 mirrors and disk stores.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams, MetricType
from vearch_tpu_torch.index.base import VectorIndex
from vearch_tpu_torch.index.int8_mirror import Int8Mirror
from vearch_tpu_torch.index.registry import register_index
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops import kmeans as km
from vearch_tpu_torch.ops import pq as pq_ops
from vearch_tpu_torch.ops.blockmax_scan import int8_blockmax_scan
from vearch_tpu_torch.ops.distance import to_device_mask

_PROBE_TODO = ("the IVFPQ probe regime is not ported yet (ROADMAP queue 1 "
               "item 5, kernel ivf_probe_dots in queue 2 item 2)")


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
        if str(params.get("quantizer_type", "flat")).lower() != "flat":
            raise NotImplementedError(
                "quantizer_type=hnsw is not ported yet (ROADMAP queue 1 "
                "item 5)")
        if bool(params.get("mesh_train", False)):
            raise NotImplementedError(
                "mesh_train is not ported yet (ROADMAP queue 1 item 10)")
        self.centroids: torch.Tensor | None = None  # [nlist, d] f32
        self._members: list[list[int]] = []  # per-cluster docid lists

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
        self._train_extra(x)
        self.trained = True

    def _assign(self, rows: np.ndarray) -> np.ndarray:
        """Nearest-centroid cell of each row (bf16 product, as the
        reference assigns)."""
        return _host(km.assign_clusters(self._to_device(rows),
                                        self.centroids))

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

    def _absorb_rows(
        self, rows: np.ndarray, assign: np.ndarray, start_docid: int
    ) -> None:
        pass

    # -- search helpers ------------------------------------------------------

    def _rerank_depth(self, k: int, params: dict | None) -> int:
        """Exact-rerank candidate depth, the recall knob on top of the
        quantized scan."""
        p = params or {}
        r = int(p.get("rerank", self.params.get("rerank", max(10 * k, 128))))
        return max(r, k)

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

    def load_state(self, state: dict[str, Any]) -> None:
        """Adopt trained quantizers and re-absorb every stored row (the
        raw vectors are the durable source of truth)."""
        if "centroids" not in state:
            return
        self.centroids = self._to_device(state["centroids"])
        self.trained = True
        self._members = [[] for _ in range(self.nlist)]
        self.indexed_count = 0
        if "codebooks" in state:
            self._load_codebooks(state)
        self.absorb(self.store.count)

    def _load_codebooks(self, state: dict[str, Any]) -> None:
        pass


@register_index("IVFPQ")
class IVFPQIndex(_IVFBase):
    """IVFPQ with residual PQ encoding, a docid-ordered int8 full-scan
    mirror and exact rerank against the raw store."""

    def __init__(self, params: IndexParams, store: RawVectorStore):
        super().__init__(params, store)
        self.m = int(params.get("nsubvector", params.get("m", 16)))
        if store.dimension % self.m != 0:
            raise ValueError(
                f"IVFPQ nsubvector={self.m} must divide dimension="
                f"{store.dimension}"
            )
        self.ksub = 1 << int(params.get("nbits_per_idx", params.get("nbits", 8)))
        if bool(params.get("opq", False)):
            raise NotImplementedError(
                "OPQ is not ported yet (ROADMAP queue 1 item 3)")
        self.scan_mode = str(params.get("scan_mode", "auto"))
        self.full_scan_limit = int(params.get("full_scan_limit", 16_000_000))
        self._check_mesh(params.get("mesh_serving",
                                    params.get("data_parallel", "auto")))
        self.codebooks: torch.Tensor | None = None  # [m, ksub, dsub]
        self._codes: np.ndarray | None = None  # [n_indexed, m] host codes
        self._mirror = Int8Mirror(
            store.dimension, storage=str(params.get("mirror_dtype", "int8")),
            device=self.device,
        )

    @staticmethod
    def _check_mesh(value) -> None:
        """The port serves one device: `mesh_serving` "auto"/"off" mean
        the single-device path (as "auto" does on one chip in the
        reference); "on" is refused."""
        if value in (True, "on", "true", "1"):
            raise NotImplementedError(
                "mesh_serving is not ported yet (ROADMAP queue 1 item 10)")

    def _train_extra(self, sample: np.ndarray) -> None:
        x = self._to_device(sample)
        assign = km.assign_clusters(x, self.centroids)
        resid = x - self.centroids[assign]
        self.codebooks = pq_ops.train_pq(
            resid, m=self.m, ksub=self.ksub, iters=self.train_iters)
        self._codes = np.zeros((0, self.m), dtype=np.uint8)

    def _absorb_rows(
        self, rows: np.ndarray, assign: np.ndarray, start_docid: int
    ) -> None:
        cents = _host(self.centroids)
        resid = rows - cents[assign]
        codes = _host(pq_ops.encode_pq(self._to_device(resid),
                                       self.codebooks))
        if self._codes is None:
            self._codes = np.zeros((0, self.m), dtype=np.uint8)
        need = start_docid + rows.shape[0]
        if self._codes.shape[0] < need:
            grown = np.zeros((max(need, self._codes.shape[0] * 2), self.m),
                             dtype=np.uint8)
            grown[: self._codes.shape[0]] = self._codes
            self._codes = grown
        self._codes[start_docid:need] = codes
        # docid-ordered int8 mirror: decode the PQ approximation, add the
        # centroid, quantize per row, append
        approx = cents[assign] + pq_ops.decode_pq_np(codes, self.codebooks)
        if self.metric is MetricType.COSINE:
            # re-normalize: PQ error perturbs the norm, and the IP scan
            # would rank by (1 +- err) * cos
            approx = approx / np.maximum(
                np.linalg.norm(approx, axis=1, keepdims=True), 1e-12)
        self._mirror.append(approx, start=start_docid)

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
        if mode != "full":
            raise NotImplementedError(_PROBE_TODO)
        approx8, scale, vsq = self._mirror.flush()
        valid = to_device_mask(valid_mask, self.indexed_count,
                               approx8.shape[0], self.device)
        r = min(self._rerank_depth(k, params), max(self.indexed_count, 1))
        topk_mode = p.get("topk_mode", self.params.get("topk_mode", "auto"))
        fused = p.get("fused_rerank", self.params.get("fused_rerank", True))
        qt = self._to_device(q)
        if scan_kernel == "pallas":
            # the reference's one-pass block-max entry point; on a GPU
            # both scan_kernel values reach the same Hopper kernel
            ivf_ops.note_dispatch("pallas_blockmax_scan")
            _, cand_i = int8_blockmax_scan(
                qt, approx8, scale, vsq, valid, max(r, k),
                metric is MetricType.L2,
            )
        elif fused:
            base, base_sqnorm, _ = self.store.device_buffer()
            ivf_ops.note_dispatch("fused_scan_rerank")
            scores, ids = ivf_ops.int8_scan_rerank(
                qt, approx8, scale, vsq, valid, base, base_sqnorm,
                max(r, k), k, scan_metric=metric, rerank_metric=self.metric,
                topk_mode=topk_mode,
            )
            return self._pad_to_k(_host(scores), _host(ids), k)
        else:
            ivf_ops.note_dispatch("scan")
            _, cand_i = ivf_ops.int8_scan_candidates(
                qt, approx8, scale, vsq, valid, max(r, k), metric, topk_mode,
            )
        from vearch_tpu_torch.index._store_paths import rerank_against_store

        ivf_ops.note_dispatch("rerank")
        scores, ids = rerank_against_store(
            self.store, q, cand_i, min(k, int(cand_i.shape[1])), self.metric,
        )
        return self._pad_to_k(_host(scores), _host(ids), k)

    def _load_codebooks(self, state: dict[str, Any]) -> None:
        if "opq_R" in state:
            raise NotImplementedError(
                "OPQ is not ported yet (ROADMAP queue 1 item 3)")
        self.codebooks = self._to_device(state["codebooks"])
        self._codes = np.zeros((0, self.m), dtype=np.uint8)
