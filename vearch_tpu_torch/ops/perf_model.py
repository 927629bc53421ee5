"""Serving shape buckets, the part of vearch_tpu/ops/perf_model.py that
search needs.

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
