"""BINARYIVF and IVFRABITQ index types, the port of
vearch_tpu/index/binary.py.

BINARYIVF: binary vectors arrive packed as dimension/8 uint8 bytes and
are unpacked to 0/1 floats. For bit vectors the squared L2 distance is
the Hamming distance ((a - b)^2 == |a - b| for a, b in {0, 1}), so the
IVFFLAT machinery serves them unchanged and the reported L2 score is the
exact Hamming distance.

IVFRABITQ: a three-stage chain over two compressed views of every row on
the device — packed sign planes (1 bit a dimension, the stage-0 tier,
ops/binary_scan.py) and the int8 RaBitQ reconstruction
centroid + mean|resid| * sign(resid) (the stage-1 tier, the int8
mirror) — and the raw rows in the store: binary scan -> top r0 -> int8
rescore -> top r1 -> exact rerank -> top k (`binary_refine_rerank`, tag
binary_refine_rerank). r0/r1 come from the request, then the index
params, then `perf_model.refine_depths`. `stage0: "off"` serves the
int8-only full-scan chain of IVFPQ instead. On a disk store stages 0
and 1 run on the device (`binary_refine_candidates`, tag
binary_refine_scan) and the exact rerank gathers the raw rows on the
host (`_store_paths.rerank_against_store`), counted as the "disk" path
of `note_refine_search`. `mirror_dtype: "int4"` keeps the stage-1 tier
as packed int4 rows. Under the mesh (`mesh_serving`, index/ivf.py) the
planes, the mirror and the raw base shard row-wise in lockstep and the
chain runs as `parallel/sharded.sharded_binary_refine` (tag
sharded_binary_refine_rerank, the "mesh" path of `note_refine_search`).
"""

from __future__ import annotations

import numpy as np

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams, MetricType
from vearch_tpu_torch.index._store_paths import (
    is_disk_store,
    rerank_against_store,
)
from vearch_tpu_torch.index.int8_mirror import Int8Mirror
from vearch_tpu_torch.index.ivf import IVFFlatIndex, IVFPQIndex, _host
from vearch_tpu_torch.index.registry import register_index
from vearch_tpu_torch.ops import binary_scan as binary_ops
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.distance import to_device_mask
from vearch_tpu_torch.parallel import mesh as mesh_lib
from vearch_tpu_torch.parallel.sharded import sharded_binary_refine


@register_index("BINARYIVF")
class BinaryIVFIndex(IVFFlatIndex):
    """Hamming-metric IVF over packed binary vectors."""

    def __init__(self, params: IndexParams, store: RawVectorStore):
        if store.dimension % 8 != 0:
            raise ValueError(
                f"BINARYIVF dimension {store.dimension} must be a multiple "
                f"of 8")
        super().__init__(params, store)

    @property
    def input_dim(self) -> int:
        return self.store.dimension // 8  # packed bytes on the wire

    def decode_input(self, batch: np.ndarray) -> np.ndarray:
        """[b, d/8] uint8 -> [b, d] 0/1 float32 (MSB first)."""
        bits = np.unpackbits(np.asarray(batch, dtype=np.uint8), axis=1,
                             count=self.store.dimension)
        return bits.astype(np.float32)


@register_index("IVFRABITQ")
class IVFRaBitQIndex(IVFPQIndex):
    """1-bit stage-0 tier and the three-stage chain. No codebooks: the
    coarse quantizer is trained, then each row is stored as its sign
    planes (stage 0) and as its RaBitQ reconstruction in the int8 mirror
    (stage 1). `nsubvector`/`nbits` are ignored. Its state is the
    centroids alone (`dump_state` carries no codebooks while they are
    None)."""

    def __init__(self, params: IndexParams, store: RawVectorStore):
        # no subvectors: skip IVFPQ's m-divides-d check
        params = IndexParams(
            index_type=params.index_type,
            metric_type=params.metric_type,
            params={**params.params, "nsubvector": 1},
        )
        super().__init__(params, store)
        self._bits = Int8Mirror(store.dimension, storage="bits",
                                device=self.device)

    def device_footprint_bytes(self) -> int:
        # IVFPQ's (raw store, centroids, stage-1 mirror) plus the planes
        return super().device_footprint_bytes() + self._bits.device_bytes()

    def reconstruction_error(self, sample: int = 256,
                             seed: int = 0) -> float | None:
        """None: the chain stores no PQ codes to decode. The reference's
        inherited IVFPQ method also returns None for a loaded index, and
        raises IndexError on one it trained itself (ROADMAP queue 3)."""
        return None

    def _train_extra(self, sample: np.ndarray) -> None:
        pass  # no codebooks: only the coarse quantizer is trained

    def _absorb_rows(
        self, rows: np.ndarray, assign: np.ndarray, start_docid: int
    ) -> None:
        cents = _host(self.centroids)
        resid = rows - cents[assign]
        scale = np.maximum(
            np.abs(resid).mean(axis=1), 1e-12
        ).astype(np.float32)
        recon = cents[assign] + scale[:, None] * np.sign(resid)
        self._mirror.append(recon.astype(np.float32), start=start_docid)
        # the planes quantize the row itself, not its residual: stage 0
        # scans every row, so its estimate carries no per-row centroid
        self._bits.append(rows, start=start_docid)

    # -- three-stage serving -------------------------------------------------

    def _stage0_enabled(self, params: dict | None) -> bool:
        mode = str((params or {}).get(
            "stage0", self.params.get("stage0", "binary"))).lower()
        if mode not in ("binary", "off"):
            raise ValueError(f"stage0 must be binary|off, got {mode!r}")
        return mode == "binary"

    def _stage_depths(self, k: int, params: dict | None) -> tuple[int, int]:
        """(r0, r1): request params win, then index params, then the
        auto depths of `perf_model.refine_depths`."""
        p = params or {}
        n = max(self.indexed_count, 1)
        auto_r0, auto_r1 = perf_model.refine_depths(k, n)
        r1 = int(p.get("r1", p.get(
            "rerank", self.params.get(
                "r1", self.params.get("rerank", auto_r1)))))
        r0 = int(p.get("r0", self.params.get("r0", auto_r0)))
        r1 = min(max(r1, k), n)
        r0 = min(max(r0, r1), n)
        return r0, r1

    def search(self, queries, k, valid_mask, params=None):
        if not self._stage0_enabled(params):
            # the int8-only full-scan chain over the stage-1 mirror: the
            # A/B baseline of the three-stage chain
            return super().search(queries, k, valid_mask,
                                  dict(params or {}, scan_mode="full"))
        assert self.trained, "IVFRABITQ search before training"
        p = params or {}
        q = self._maybe_normalize(np.asarray(queries, np.float32))
        metric = (
            MetricType.INNER_PRODUCT
            if self.metric is MetricType.COSINE
            else self.metric
        )
        r0, r1 = self._stage_depths(k, params)
        topk_mode = p.get("topk_mode", self.params.get("topk_mode", "auto"))
        if self._mesh_enabled(p) and not is_disk_store(self.store):
            return self._search_binary_mesh(q, k, valid_mask, p, metric,
                                            r0, r1, topk_mode)
        disk = is_disk_store(self.store)
        with ivf_ops.span("index.prepare"):
            # host windows of the chain: the reference's stage.* rows
            with ivf_ops.span("stage.flush"):
                planes, p_scale, p_vsq = self._bits.flush()
                approx8, m_scale, m_vsq = self._mirror.flush()
                valid = to_device_mask(valid_mask, self.indexed_count,
                                       planes.shape[0], self.device)
            qt = self._to_device(q)
            if not disk:
                base, base_sqnorm, _ = self.store.device_buffer()
        if disk:
            # stages 0-1 on the device; the stage-2 rows gathered on the
            # host through the mmap (the raw base never enters the card)
            with ivf_ops.span("stage.scan"):
                ivf_ops.note_dispatch("binary_refine_scan")
                _, cand_i = binary_ops.binary_refine_candidates(
                    qt, planes, p_scale, p_vsq, approx8, m_scale, m_vsq,
                    valid, r0, r1, metric, topk_mode, self.mirror_storage,
                )
            with ivf_ops.span("stage.rerank"):
                ivf_ops.note_dispatch("rerank")
                scores, ids = rerank_against_store(
                    self.store, q, cand_i, min(k, int(cand_i.shape[1])),
                    self.metric,
                )
                out = self._fetch(scores, ids, k)
            binary_ops.note_refine_search(
                "disk", self.indexed_count, r0, r1, k, q.shape[0])
            return out
        with ivf_ops.span("stage.refine"):
            ivf_ops.note_dispatch("binary_refine_rerank")
            scores, ids = binary_ops.binary_refine_rerank(
                qt, planes, p_scale, p_vsq, approx8, m_scale, m_vsq, valid,
                base, base_sqnorm, r0, r1, k,
                scan_metric=metric, rerank_metric=self.metric,
                topk_mode=topk_mode, storage=self.mirror_storage,
            )
            out = self._fetch(scores, ids, k)
        binary_ops.note_refine_search(
            "fused", self.indexed_count, r0, r1, k, q.shape[0])
        return out

    def _search_binary_mesh(
        self, q: np.ndarray, k: int, valid_mask, params, metric,
        r0: int, r1: int, topk_mode: str,
    ) -> tuple[np.ndarray, np.ndarray]:
        """The chain over the mesh: planes, mirror and raw base sharded
        in lockstep (the same 512 alignment for planes and mirror), stages
        0-1 shard-local, one gather, the owner rerank."""
        with ivf_ops.span("mesh.place"):
            mesh = self._serving_mesh(params)
            planes, p_scale, p_vsq = self._bits.flush_sharded(mesh)
            a8, m_scale, m_vsq = self._mirror.flush_sharded(mesh)
            n = self.indexed_count
            cap = self._bits._sh_cache.capacity(mesh, n)
            valid_sh = self._mesh_valid_cache.get(mesh, valid_mask, n, cap)
            base, base_sqn, _ = self.store.device_buffer_sharded(mesh)
            qd, b = mesh_lib.shard_queries(mesh, np.asarray(q, np.float32))
        with ivf_ops.span("stage.refine"):
            ivf_ops.note_dispatch("sharded_binary_refine_rerank")
            scores, ids = sharded_binary_refine(
                mesh, planes, p_scale, p_vsq, a8, m_scale, m_vsq, valid_sh,
                base, base_sqn, qd, r0, r1, min(k, r1),
                scan_metric=metric, rerank_metric=self.metric,
                topk_mode=topk_mode, storage=self.mirror_storage,
            )
            scores, ids = _host(scores)[:b], _host(ids)[:b]
        binary_ops.note_refine_search("mesh", n, r0, r1, k, b)
        return self._pad_to_k(scores, ids, k)

    def device_footprint_per_device_bytes(self) -> int:
        if not self._mesh_enabled(None):
            return self.device_footprint_bytes()
        # the planes shard row-wise with the mirror: their payload joins
        # the sharded term of IVFPQ's per-device model
        base = super().device_footprint_per_device_bytes()
        n_shards = int(self._serving_mesh(None).shape["data"])
        return base + -(-self._bits.device_bytes() // max(n_shards, 1))

    def _publish(self) -> None:
        # no probe regime for 1-bit codes: both mirrors fill at absorb
        self._dirty = False
