"""Packed 1-bit stage-0 scan and the three-stage refinement chain, the
port of vearch_tpu/ops/binary_scan.py.

A row is stored as its sign bits plus a per-row magnitude scale
(row ~= scale * sign(row)): a packed bit plane of ceil(d/8) bytes, 1/8
of the int8 mirror's row payload. Scoring unpacks the planes to +-1 bf16
and takes one product with the bf16-rounded queries at f32 accumulation:
q . (scale * sign(row)) = scale * (q . (2 bit - 1)). On a CUDA tensor
that is one bf16 `torch.mm` with an f32 output; on the CPU the same
exact products summed in f32. The reference left this program to XLA
(not Pallas), so it stays PyTorch here.

The chain over three representations of the same rows:

    stage 0  binary scan over every row           -> top r0
    stage 1  int8/int4 mirror rescore of the r0 rows -> top r1
    stage 2  exact rerank against the raw base    -> top k

`binary_refine_candidates` runs stages 0-1, `binary_refine_rerank` all
three. Stage 0 selects through `ops/ivf.select_topk_scores` over the
[B, N] score matrix: at B=1024 x 1M rows that matrix is 4.1 GB, which the
reference also materialises (its note at ops/ivf.py:385-389 found
chunking slower). Each step runs inside a device span (`ops/ivf.span`)
named in STAGE_RANGES, so a profiler trace splits a search's device time
by stage and a traced request's `stream_ms` times each on the stream;
with neither a span costs one check.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F
from vearch_tpu_torch.engine.types import MetricType
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.distance import NEG_INF, sqnorms, stable_topk
from vearch_tpu_torch.ops.ivf import (
    exact_rerank,
    select_topk_scores,
    unpack_int4,
)

#: spans of the chain's steps, in order (stage 0 is the first four)
STAGE_RANGES = ("scan.unpack", "scan.matmul", "scan.epilogue",
                "scan.select", "scan.rescore", "scan.rerank")


def pack_sign_rows(
    rows: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Float rows -> (planes [n, ceil(d/8)] uint8, scale [n] f32, vsq [n]
    f32). The stored approximation is scale * (2 bit - 1) per dimension,
    so vsq = |approx|^2 = d * scale^2. Bits are MSB-first (np.packbits);
    the last byte pads with 0-bits, and queries pad with zeros, so the
    padding adds nothing to a dot product."""
    rows = np.asarray(rows, dtype=np.float32)
    d = rows.shape[1]
    scale = np.maximum(
        np.abs(rows).mean(axis=1), 1e-12
    ).astype(np.float32)
    planes = np.packbits(rows > 0.0, axis=1)  # MSB-first, byte-padded
    vsq = (float(d) * scale * scale).astype(np.float32)
    return planes, scale, vsq


def unpack_bits_pm1(planes: torch.Tensor) -> torch.Tensor:
    """[N, d/8] uint8 bit planes -> [N, d] bf16 in {-1, +1}; bit 7 (MSB)
    of byte j is dimension 8 j."""
    n, nb = planes.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=planes.device)
    bits = (planes[:, :, None] >> shifts) & 1
    return bits.reshape(n, nb * 8).to(torch.bfloat16) * 2 - 1


def _bf16_product(qb: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[B, N] f32 = qb @ rows.T for bf16 operands with f32 accumulation
    (the reference's preferred_element_type=float32): one bf16 GEMM with
    an f32 output on a CUDA tensor; the same exact products widened to
    f32 on the CPU, which has no bf16 GEMM with an f32 output."""
    if qb.device.type == "cuda":
        return torch.mm(qb, rows.T, out_dtype=torch.float32)
    return torch.matmul(qb.float(), rows.float().T)


def _binary_scores(
    queries: torch.Tensor,    # [B, d] f32
    planes: torch.Tensor,     # [N_pad, d/8] uint8
    row_scale: torch.Tensor,  # [N_pad] f32
    row_vsq: torch.Tensor,    # [N_pad] f32
    valid: torch.Tensor,      # [N_pad] bool
    metric: MetricType,
) -> torch.Tensor:
    """[B, N_pad] f32 stage-0 scores, -inf where masked. The epilogue
    runs in place on the product, so the [B, N] matrix exists once; each
    step rounds as the reference's -(|q|^2 - 2 dots + vsq) does."""
    with ivf_ops.span("scan.unpack", device=True):
        signs = unpack_bits_pm1(planes)  # [N, d_pad] bf16 (transient)
    with ivf_ops.span("scan.matmul", device=True):
        qp = F.pad(queries.float(), (0, signs.shape[1] - queries.shape[1]))
        scores = _bf16_product(qp.to(torch.bfloat16), signs)
    del signs
    with ivf_ops.span("scan.epilogue", device=True):
        scores.mul_(row_scale[None, :])
        if metric is MetricType.L2:
            scores.mul_(-2.0).add_(sqnorms(queries)[:, None])
            scores.add_(row_vsq[None, :]).neg_()
        return scores.masked_fill_(~valid[None, :], NEG_INF)


@perf_model.register_op("binary.scan_candidates")
def binary_scan_candidates(
    queries: torch.Tensor,    # [B, d] f32
    planes: torch.Tensor,     # [N_pad, d/8] uint8 packed sign planes
    row_scale: torch.Tensor,  # [N_pad] f32 per-row magnitude scale
    row_vsq: torch.Tensor,    # [N_pad] f32 |approx|^2 (= d * scale^2)
    valid: torch.Tensor,      # [N_pad] bool
    r: int,
    metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 0: the binary full scan and its top-r ([B, r] scores, [B, r]
    int32 ids, -1 for masked). The scores are a first-order estimate,
    good for selection only; the next stages restore the order."""
    scores = _binary_scores(queries.float(), planes, row_scale, row_vsq,
                            valid, metric)
    with ivf_ops.span("scan.select", device=True):
        return select_topk_scores(scores, r, topk_mode)


def _mirror_rescore(
    queries: torch.Tensor,  # [B, d] f32
    cand_i: torch.Tensor,   # [B, r0] int32 (-1 padding)
    approx8: torch.Tensor,  # [N_pad, d] int8
    m_scale: torch.Tensor,  # [N_pad] f32
    m_vsq: torch.Tensor,    # [N_pad] f32
    r1: int,
    metric: MetricType,
    storage: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: rescore the stage-0 candidates against their int8 mirror
    rows, or their packed int4 rows unpacked (gather, widen, batched
    product with the bf16-rounded queries at f32: exact products) and
    keep the top r1."""
    with ivf_ops.span("scan.rescore", device=True):
        safe = torch.clamp(cand_i, 0, approx8.shape[0] - 1).long()
        rows = approx8[safe]  # [B, r0, w]
        rows = (rows if storage == "int8" else unpack_int4(rows)).float()
        qb = queries.to(torch.bfloat16).float()
        dots = torch.bmm(rows, qb[:, :, None])[..., 0] * m_scale[safe]
        if metric is MetricType.L2:
            scores = -(sqnorms(queries)[:, None] - 2.0 * dots + m_vsq[safe])
        else:
            scores = dots
        scores = torch.where(cand_i >= 0, scores,
                             torch.full_like(scores, NEG_INF))
        top_s, pos = stable_topk(scores, min(r1, scores.shape[1]))
        ids = torch.gather(cand_i, 1, pos)
        return top_s, torch.where(torch.isfinite(top_s), ids,
                                  torch.full_like(ids, -1))


@perf_model.register_op("binary.refine_candidates")
def binary_refine_candidates(
    queries: torch.Tensor,    # [B, d] f32
    planes: torch.Tensor,     # [N_pad, d/8] uint8
    row_scale: torch.Tensor,  # [N_pad] f32
    row_vsq: torch.Tensor,    # [N_pad] f32
    approx8: torch.Tensor,    # [N_pad, d] int8
    m_scale: torch.Tensor,    # [N_pad] f32 mirror dequant scale
    m_vsq: torch.Tensor,      # [N_pad] f32 mirror |approx|^2
    valid: torch.Tensor,      # [N_pad] bool
    r0: int,
    r1: int,
    metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
    storage: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages 0 and 1: binary scan -> top r0 -> int8 rescore -> top r1."""
    queries = queries.float()
    _, cand_i = binary_scan_candidates(
        queries, planes, row_scale, row_vsq, valid, r0, metric, topk_mode)
    return _mirror_rescore(queries, cand_i, approx8, m_scale, m_vsq, r1,
                           metric, storage)


@perf_model.register_op("binary.refine_rerank")
def binary_refine_rerank(
    queries: torch.Tensor,      # [B, d] f32
    planes: torch.Tensor,       # [N_pad, d/8] uint8
    row_scale: torch.Tensor,    # [N_pad] f32
    row_vsq: torch.Tensor,      # [N_pad] f32
    approx8: torch.Tensor,      # [N_pad, d] int8
    m_scale: torch.Tensor,      # [N_pad] f32
    m_vsq: torch.Tensor,        # [N_pad] f32
    valid: torch.Tensor,        # [N_pad] bool
    base: torch.Tensor,         # [capacity, d] raw store buffer
    base_sqnorm: torch.Tensor,  # [capacity] f32
    r0: int,
    r1: int,
    k: int,
    scan_metric: MetricType = MetricType.L2,
    rerank_metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
    storage: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """All three stages; only the final [B, k] pair leaves the device.
    scan_metric is the compressed-domain metric (cosine scans as IP on
    normalized rows), rerank_metric the user-facing one."""
    _, cand_i = binary_refine_candidates(
        queries, planes, row_scale, row_vsq, approx8, m_scale, m_vsq,
        valid, r0, r1, scan_metric, topk_mode, storage)
    with ivf_ops.span("scan.rerank", device=True):
        return exact_rerank(queries.to(base.dtype), cand_i, base,
                            base_sqnorm, k, rerank_metric)


# -- per-stage serving counters ----------------------------------------------
#
# Process-wide totals of three-stage serving work, as the reference keeps
# them for its vearch_ps_refine_* metrics.

#: serving shapes of the three-stage chain (the reference's label set)
REFINE_PATHS: tuple[str, ...] = ("fused", "disk", "mesh")
#: refinement stages
REFINE_STAGES: tuple[str, ...] = ("binary", "int8", "exact")

_stage_lock = threading.Lock()
_refine_searches: dict[str, int] = {p: 0 for p in REFINE_PATHS}
_refine_stage_rows: dict[str, int] = {s: 0 for s in REFINE_STAGES}


def note_refine_search(path: str, n_rows: int, r0: int, r1: int,
                       k: int, batch: int) -> None:
    """Account one three-stage search: stage 0 scores every row, stage 1
    r0 rows and stage 2 r1 rows, each times the query batch."""
    with _stage_lock:
        _refine_searches[path] = _refine_searches.get(path, 0) + 1
        _refine_stage_rows["binary"] += int(n_rows) * int(batch)
        _refine_stage_rows["int8"] += int(r0) * int(batch)
        _refine_stage_rows["exact"] += int(r1) * int(batch)


def refine_search_counts() -> dict[str, int]:
    with _stage_lock:
        return dict(_refine_searches)


def refine_stage_rows() -> dict[str, int]:
    with _stage_lock:
        return dict(_refine_stage_rows)
