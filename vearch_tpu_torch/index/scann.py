"""SCANN index type (also registered as VEARCH), the port of
vearch_tpu/index/scann.py: score-aware quantization.

The coarse partitioning, realtime absorb, int8 mirror, probe buckets and
both scan regimes are IVFPQ's; only the PQ codebooks are trained, and
rows encoded, under the anisotropic loss (`ops/scann.py`). Params as the
reference's VEARCH type: ncentroids, nsubvector (default 64, halved until
it divides the dimension), ns_threshold (default 0.2) or eta directly,
and reordering (default true: the exact rerank; false returns the
quantized scores at candidate depth k, unless a rerank depth is asked
for). OPQ is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams
from vearch_tpu_torch.index.ivf import IVFPQIndex, _host
from vearch_tpu_torch.index.registry import register_index
from vearch_tpu_torch.ops import scann as scann_ops


@register_index("SCANN")
@register_index("VEARCH")
class ScannIndex(IVFPQIndex):
    def __init__(self, params: IndexParams, store: RawVectorStore):
        if bool(params.get("opq", False)):
            raise ValueError("SCANN does not take the opq option")
        if "nsubvector" not in params.params and "m" not in params.params:
            # the reference's default nsubvector=64, clamped to a divisor
            # of the dimension (a copy: the caller's schema is not mutated)
            m = 64
            while store.dimension % m != 0:
                m //= 2
            params = IndexParams(
                params.index_type, params.metric_type,
                {**params.params, "nsubvector": m},
            )
        super().__init__(params, store)
        t = float(params.get("ns_threshold", 0.2))
        self.eta = float(
            params.get("eta", scann_ops.eta_from_threshold(t, store.dimension))
        )
        self.reordering = bool(params.get("reordering", True))

    def _unit_dirs(self, rows: np.ndarray) -> torch.Tensor:
        n = np.linalg.norm(rows, axis=-1, keepdims=True)
        return self._to_device(rows / np.maximum(n, 1e-15))

    def _fit_codebooks(self, resid: np.ndarray, sample: np.ndarray
                       ) -> torch.Tensor:
        return scann_ops.train_anisotropic_pq(
            self._to_device(resid), self._unit_dirs(sample), m=self.m,
            ksub=self.ksub, eta=self.eta, iters=self.train_iters,
        )

    def _encode_rows(self, resid: np.ndarray, rows: np.ndarray
                     ) -> np.ndarray:
        return _host(scann_ops.encode_anisotropic(
            self._to_device(resid), self._unit_dirs(rows), self.codebooks,
            self.eta,
        ))

    def _exact_rerank_enabled(self, params: dict | None) -> bool:
        # reordering=false returns the quantized scores with no exact
        # pass; an explicit rerank depth (request or index) turns it on
        if self.reordering:
            return True
        return bool((params or {}).get("rerank") or self.params.get("rerank"))

    def _rerank_depth(self, k: int, params: dict | None) -> int:
        if not self._exact_rerank_enabled(params):
            return k  # no rerank pass reads more than k candidates
        return super()._rerank_depth(k, params)
