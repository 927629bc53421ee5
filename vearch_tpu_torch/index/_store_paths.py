"""Store-aware search primitives shared by the index types, the port of
vearch_tpu/index/_store_paths.py. Only the device-mirrored memory store
is ported; disk stores wait for a later slice (ROADMAP queue 1)."""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.engine.types import MetricType
from vearch_tpu_torch.ops import ivf as ivf_ops


def rerank_against_store(
    store,
    q: np.ndarray,          # [B, d] f32 (normalized upstream if cosine)
    cand_i: torch.Tensor,   # [B, r] int32 on the store's device
    k: int,
    metric: MetricType,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank of candidate ids against the raw device buffer."""
    k = min(k, int(cand_i.shape[1]))
    base, base_sqnorm, _ = store.device_buffer()
    qt = torch.from_numpy(np.ascontiguousarray(q, np.float32))
    return ivf_ops.exact_rerank(
        qt.to(store.device).to(base.dtype), cand_i, base, base_sqnorm,
        k, metric,
    )
