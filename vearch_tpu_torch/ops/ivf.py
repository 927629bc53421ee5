"""IVFPQ full-scan search ops, the port of the full-scan half of
vearch_tpu/ops/ivf.py.

The full scan reads the docid-ordered int8 mirror (per-row scaled
approximations of the PQ-decoded vectors), selects top-r candidates and
reranks them exactly against the raw store:

- `int8_scan_candidates` / `_select_topk`: top-r over the int8 scores.
  The block-max branch (topk_mode "blockmax", or "auto" when the mirror
  has at least 4x as many 512-row blocks as it selects) runs stage 1
  through `ops/blockmax_scan.int8_blockmax_stage1` — the Hopper kernel
  on a CUDA tensor — so the [B, N] score matrix is never built. The
  "exact" branch keeps the reference's plain top-k over a full score
  matrix (`torch.matmul`, as the reference left that product to XLA).
- `exact_rerank`: candidate rows gathered from the raw store and
  re-scored at f32.
- `int8_scan_rerank`: both, the reference's fused default path.

All selections take the lower index first among ties (`stable_topk`),
which is the `jax.lax.top_k` order.
"""

from __future__ import annotations

import torch

from vearch_tpu_torch.engine.types import MetricType
from vearch_tpu_torch.ops.blockmax_scan import (
    BLOCK,
    blockmax_stage2,
    int8_blockmax_stage1,
)
from vearch_tpu_torch.ops.distance import NEG_INF, sqnorms, stable_topk

# Optional dispatch ledger: when a list is installed here, index call
# sites append one tag per search program they run, with the reference's
# tag names (fused_scan_rerank, pallas_blockmax_scan, rerank, flat_scan)
# so the two packages' ledgers compare line by line.
_dispatch_ledger: list | None = None


def set_dispatch_ledger(ledger: list | None) -> None:
    global _dispatch_ledger
    _dispatch_ledger = ledger


def note_dispatch(tag: str) -> None:
    if _dispatch_ledger is not None:
        _dispatch_ledger.append(tag)


def _int8_scores(queries, approx8, scale, vsq, valid, l2: bool):
    """Full [B, N_pad] int8-mirror score matrix (exact-selection branch)."""
    dots = torch.matmul(queries.to(torch.bfloat16).float(),
                        approx8.float().T) * scale[None, :]
    if l2:
        scores = -(sqnorms(queries)[:, None] - 2.0 * dots + vsq[None, :])
    else:
        scores = dots
    return torch.where(valid[None, :], scores,
                       torch.full_like(scores, NEG_INF))


def _select_topk(
    queries: torch.Tensor,
    approx8: torch.Tensor,
    scale: torch.Tensor,
    vsq: torch.Tensor,
    valid: torch.Tensor,
    r: int,
    topk_mode: str,
    l2: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-max / exact top-r selection over the int8 scores. The
    reference takes a materialised score matrix; here the block-max
    branch computes its stage 1 in the kernel instead, with the same
    gate, over-selection (2x+8 blocks) and bf16 block maxima."""
    n_pad = approx8.shape[0]
    r = min(r, n_pad)
    nb = max(32, r // 4)
    nblk = n_pad // BLOCK
    use_block = (
        n_pad % BLOCK == 0
        and nblk >= 1
        and (topk_mode == "blockmax"
             or (topk_mode == "auto" and nblk >= nb * 4))
    )
    if not use_block:
        top_s, ids = stable_topk(
            _int8_scores(queries, approx8, scale, vsq, valid, l2), r)
        ids = ids.to(torch.int32)
        # masked slots (filtered/deleted/padding) carry -inf: id -1 so the
        # rerank cannot resurrect them
        return top_s, torch.where(torch.isfinite(top_s), ids,
                                  torch.full_like(ids, -1))
    nb = min(2 * nb + 8, nblk)
    bmax = int8_blockmax_stage1(
        queries.to(torch.bfloat16).contiguous(), approx8, scale, vsq,
        valid, sqnorms(queries).contiguous(), l2)
    return blockmax_stage2(queries, approx8, scale, vsq, valid, bmax, nb,
                           min(r, nb * BLOCK), l2)


def int8_scan_candidates(
    queries: torch.Tensor,  # [B, d] f32
    approx8: torch.Tensor,  # [N_pad, d] int8 docid-ordered mirror
    scale: torch.Tensor,    # [N_pad] f32 per-row dequant scale
    vsq: torch.Tensor,      # [N_pad] f32 ||approx||^2
    valid: torch.Tensor,    # [N_pad] bool
    r: int,
    metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed full scan + top-r: ([B, r] f32 scores, [B, r] int32
    docids, -1 for masked)."""
    return _select_topk(queries.float(), approx8, scale, vsq, valid, r,
                        topk_mode, metric is MetricType.L2)


def exact_rerank(
    queries: torch.Tensor,      # [B, d] (store dtype)
    cand_ids: torch.Tensor,     # [B, r] int32 (-1 padding)
    base: torch.Tensor,         # [capacity, d] store dtype
    base_sqnorm: torch.Tensor,  # [capacity] f32
    k: int,
    metric: MetricType = MetricType.L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of candidate docids against the raw device
    buffer: one row gather + a batched f32 product."""
    safe = torch.clamp(cand_ids, min=0).long()
    vecs = base[safe].float()  # [B, r, d]
    vsq = base_sqnorm[safe]    # [B, r]
    dots = torch.bmm(vecs, queries.float()[:, :, None])[..., 0]
    if metric is MetricType.L2:
        scores = -(sqnorms(queries)[:, None] - 2.0 * dots + vsq)
    elif metric is MetricType.COSINE:
        qn = torch.sqrt(torch.clamp(sqnorms(queries), min=1e-30))[:, None]
        vn = torch.sqrt(torch.clamp(vsq, min=1e-30))
        scores = dots / (qn * vn)
    else:
        scores = dots
    scores = torch.where(cand_ids >= 0, scores,
                         torch.full_like(scores, NEG_INF))
    top_s, pos = stable_topk(scores, min(k, scores.shape[1]))
    return top_s, torch.gather(cand_ids, 1, pos)


def int8_scan_rerank(
    queries: torch.Tensor,      # [B, d] f32
    approx8: torch.Tensor,
    row_scale: torch.Tensor,
    row_vsq: torch.Tensor,
    valid: torch.Tensor,
    base: torch.Tensor,         # [capacity, d] raw store buffer
    base_sqnorm: torch.Tensor,  # [capacity] f32
    r: int,
    k: int,
    scan_metric: MetricType = MetricType.L2,
    rerank_metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed scan + exact rerank; only the final [B, k] pair leaves
    the device. scan_metric is the compressed-domain metric (cosine scans
    as IP on pre-normalized rows), rerank_metric the user-facing one."""
    _, cand_i = int8_scan_candidates(queries, approx8, row_scale, row_vsq,
                                     valid, r, scan_metric, topk_mode)
    return exact_rerank(queries.to(base.dtype), cand_i, base, base_sqnorm,
                        k, rerank_metric)
