"""Batch distance ops, the port of vearch_tpu/ops/distance.py.

Scores are "similarity" oriented — higher is always better:

    L2:   score = -(||q||^2 - 2 q.x + ||x||^2)
    IP:   score = q.x
    COS:  score = (q/||q||) . (x/||x||)

`score_to_metric` converts back to the user-facing value (L2 distance is
`-score`).

Exactness contract (the reference's `dot_precision` HIGHEST): a float32
product here is a full float32 product. TF32 is switched off for both
matmul and cuDNN when this module is imported; bf16 and int8 operands are
widened to float32 first, which is exact, so only the summation order
differs from the reference.

Top-k ties: `jax.lax.top_k` returns the lower index first among equal
scores, `torch.topk` promises no order. `stable_topk` (a stable
descending sort, then a slice) reproduces the reference's order, and
every selection in the port goes through it.
"""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.engine.types import MetricType
from vearch_tpu_torch.ops.perf_model import register_op

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG_INF = float("-inf")


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by the lower index (the
    `jax.lax.top_k` order). Returns (values, indices int64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, accumulated in f32. Shape [n]."""
    xf = x.float()
    return torch.sum(xf * xf, dim=-1)


def host_sqnorms(x: np.ndarray) -> np.ndarray:
    """Host-side sqnorms for derived device columns (raw-base sqnorm):
    numpy's fixed-length pairwise sum is deterministic, so every
    placement path lands the same column."""
    xf = np.asarray(x).astype(np.float32)
    return np.sum(xf * xf, axis=-1)


def to_device_mask(valid_mask, n: int, cap: int,
                   device: torch.device | str) -> torch.Tensor:
    """Normalise a validity mask to a device bool tensor of length `cap`.

    `valid_mask` may be a host numpy array (per-request filter result),
    an engine-cached device tensor of length n, or None (all alive).
    Rows in [n, cap) are padding and always False.
    """
    if isinstance(valid_mask, torch.Tensor):
        m = valid_mask[:n].to(device=device, dtype=torch.bool)
        if m.shape[0] < cap:
            m = torch.cat([m, torch.zeros(cap - m.shape[0], dtype=torch.bool,
                                          device=m.device)])
        return m
    v = np.zeros(cap, dtype=np.bool_)
    if valid_mask is not None:
        vm = np.asarray(valid_mask)[:n]
        v[: vm.shape[0]] = vm
    else:
        v[:n] = True
    return torch.from_numpy(v).to(device)


@register_op("distance.similarity_scores")
def similarity_scores(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: MetricType = MetricType.L2,
    base_sqnorm: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense [B, N] similarity matrix (higher = better).

    queries [B, d] and base [N, d] in any float dtype; the product runs
    in f32 (exact for bf16 operands)."""
    dots = torch.matmul(queries.float(), base.float().T)  # [B, N]
    if metric is MetricType.INNER_PRODUCT:
        return dots
    if base_sqnorm is None:
        base_sqnorm = sqnorms(base)
    if metric is MetricType.COSINE:
        qn = torch.sqrt(torch.clamp(sqnorms(queries), min=1e-30))[:, None]
        bn = torch.sqrt(torch.clamp(base_sqnorm, min=1e-30))[None, :]
        return dots / (qn * bn)
    d2 = sqnorms(queries)[:, None] - 2.0 * dots + base_sqnorm[None, :]
    return -torch.clamp(d2, min=0.0)


def score_to_metric(scores, metric: MetricType):
    """Convert internal similarity scores to user-facing metric values."""
    if metric is MetricType.L2:
        return -scores
    return scores


@register_op("distance.masked_topk")
def masked_topk(
    scores: torch.Tensor, valid: torch.Tensor | None, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over [B, N] scores with an optional [N] or [B, N] validity
    mask; invalid slots score -inf. When k > N the result is padded with
    (-inf, -1) columns so the output is always [B, k]."""
    if valid is not None:
        if valid.ndim == 1:
            valid = valid[None, :]
        scores = torch.where(valid, scores,
                             torch.full_like(scores, NEG_INF))
    n = scores.shape[-1]
    top_s, top_i = stable_topk(scores, min(k, n))
    if k > n:
        pad = k - n
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_s, top_i


@register_op("distance.brute_force_search")
def brute_force_search(
    queries: torch.Tensor,
    base: torch.Tensor,
    valid: torch.Tensor | None,
    k: int,
    metric: MetricType = MetricType.L2,
    base_sqnorm: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact search: distance matmul + masked top-k (the FLAT index and
    the below-training-threshold fallback)."""
    scores = similarity_scores(queries, base, metric, base_sqnorm)
    return masked_topk(scores, valid, k)
