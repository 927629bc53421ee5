"""Serving shape buckets, the three-stage auto depths and the PCIe ledger
of the tiered storage engine: the parts of vearch_tpu/ops/perf_model.py
that search, the scheduler (engine/batching.py) and the HBM bucket cache
(index/hbm_cache.py) need.

The engine pads every search to a declared row tier and raises its
candidate depth to a declared fetch-k tier (k=10 scans at 16); results
depend on that, so the port keeps the same grid.
"""

from __future__ import annotations

import threading

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


# -- host -> device bytes ledger (tiered storage engine) --------------------
#
# With a warm cache the disk tier moves ZERO bytes host -> device a
# search: a hit serves from the resident slab pools. A miss pays exactly
# one slab upload, four arrays of fixed shape [cap, ...]:
#
#     int8 rows   cap * d   bytes
#     scale f32   cap * 4
#     vsq   f32   cap * 4
#     docids i32  cap * 4
#
# so slab_bytes(cap, d) = cap * (d + 12), and a resolve with `m` misses
# moves tier_h2d_bytes(m, cap, d) = m * slab_bytes. HbmBucketCache notes
# the bytes it uploads through note_h2d_bytes. The per-slot live-row
# count the port keeps beside the pools (`pool_lens`, 4 B a slot) is not
# part of the model, so the ledger stays the reference's.

_h2d_lock = threading.Lock()
_h2d_bytes_total = 0


def note_h2d_bytes(n: int) -> None:
    """Record `n` bytes copied host -> device."""
    global _h2d_bytes_total
    with _h2d_lock:
        _h2d_bytes_total += int(n)


def h2d_bytes_total() -> int:
    with _h2d_lock:
        return _h2d_bytes_total


def slab_bytes(cap: int, d: int) -> int:
    """H2D bytes one bucket-slab upload moves (int8 rows + scale + vsq
    + docids at the cache's fixed row capacity `cap`)."""
    return int(cap) * (int(d) + 12)


def tier_h2d_bytes(misses: int, cap: int, d: int) -> int:
    """Modelled bytes for a resolve with `misses` slab misses: zero on a
    full hit, one slab_bytes per missed bucket otherwise."""
    return int(misses) * slab_bytes(cap, d)
