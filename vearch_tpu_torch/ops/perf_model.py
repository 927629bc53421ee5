"""Serving shape buckets and the three-stage auto depths, the parts of
vearch_tpu/ops/perf_model.py that search and the scheduler
(engine/batching.py) need.

The engine pads every search to a declared row tier and raises its
candidate depth to a declared fetch-k tier (k=10 scans at 16); results
depend on that, so the port keeps the same grid.
"""

from __future__ import annotations

#: declared row tiers for batched serving dispatches
ROW_BUCKETS: tuple[int, ...] = (8, 64, 256, 1024)
#: declared fetch-k tiers (candidate depth handed to the index)
FETCH_K_TIERS: tuple[int, ...] = (16, 64, 256, 1024)


def bucket_rows(b: int) -> int:
    """Smallest declared row tier holding `b` rows; above the top tier
    returns `b` unchanged."""
    for t in ROW_BUCKETS:
        if b <= t:
            return t
    return int(b)


def bucket_fetch_k(k: int) -> int:
    """Smallest declared fetch-k tier covering depth `k`; above the top
    tier returns `k` unchanged."""
    for t in FETCH_K_TIERS:
        if k <= t:
            return t
    return int(k)


def refine_depths(k: int, n: int) -> tuple[int, int]:
    """Auto candidate depths (r0, r1) of IVFRABITQ's three-stage chain:
    r1 = max(10k, 128), the int8 rerank default, and r0 = max(3.2 r1,
    512) for the selection-grade 1-bit stage 0; both clamp to the row
    count. Request and index params `r0`/`r1` override them."""
    n = max(int(n), 1)
    r1 = min(max(10 * int(k), 128), n)
    r0 = min(max(32 * r1 // 10, 512), n)
    return max(r0, r1), r1
