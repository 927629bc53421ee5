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
as packed int4 rows. Not ported yet: the mesh branch (mesh_serving "on"
raises, ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import time

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
        self._check_mesh(p.get("mesh_serving",
                               self.params.get("mesh_serving", "auto")))
        q = self._maybe_normalize(np.asarray(queries, np.float32))
        metric = (
            MetricType.INNER_PRODUCT
            if self.metric is MetricType.COSINE
            else self.metric
        )
        r0, r1 = self._stage_depths(k, params)
        topk_mode = p.get("topk_mode", self.params.get("topk_mode", "auto"))
        # host windows of the chain (stage.* spans of a traced search)
        t_flush0 = time.monotonic()
        planes, p_scale, p_vsq = self._bits.flush()
        approx8, m_scale, m_vsq = self._mirror.flush()
        valid = to_device_mask(valid_mask, self.indexed_count,
                               planes.shape[0], self.device)
        ivf_ops.note_stage_phase("flush", t_flush0, time.monotonic())
        if is_disk_store(self.store):
            # stages 0-1 on the device; the stage-2 rows gathered on the
            # host through the mmap (the raw base never enters the card)
            t0 = time.monotonic()
            ivf_ops.note_dispatch("binary_refine_scan")
            _, cand_i = binary_ops.binary_refine_candidates(
                self._to_device(q), planes, p_scale, p_vsq,
                approx8, m_scale, m_vsq, valid, r0, r1, metric, topk_mode,
                self.mirror_storage,
            )
            ivf_ops.note_stage_phase("scan", t0, time.monotonic())
            t2 = time.monotonic()
            ivf_ops.note_dispatch("rerank")
            scores, ids = rerank_against_store(
                self.store, q, cand_i, min(k, int(cand_i.shape[1])),
                self.metric,
            )
            scores, ids = _host(scores), _host(ids)
            ivf_ops.note_stage_phase("rerank", t2, time.monotonic())
            binary_ops.note_refine_search(
                "disk", self.indexed_count, r0, r1, k, q.shape[0])
            return self._pad_to_k(scores, ids, k)
        base, base_sqnorm, _ = self.store.device_buffer()
        t0 = time.monotonic()
        ivf_ops.note_dispatch("binary_refine_rerank")
        scores, ids = binary_ops.binary_refine_rerank(
            self._to_device(q), planes, p_scale, p_vsq,
            approx8, m_scale, m_vsq, valid, base, base_sqnorm, r0, r1, k,
            scan_metric=metric, rerank_metric=self.metric,
            topk_mode=topk_mode, storage=self.mirror_storage,
        )
        scores, ids = _host(scores), _host(ids)
        ivf_ops.note_stage_phase("refine", t0, time.monotonic())
        binary_ops.note_refine_search(
            "fused", self.indexed_count, r0, r1, k, q.shape[0])
        return self._pad_to_k(scores, ids, k)

    def _publish(self) -> None:
        # no probe regime for 1-bit codes: both mirrors fill at absorb
        self._dirty = False
