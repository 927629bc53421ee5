"""Device staging for the tiered storage engine, the port of
vearch_tpu/tiering/staging.py.

`scatter_slabs` lands a batch of uploaded bucket slabs in their pool
slots. The reference's jitted `.at[slots].set(...)` returns new pool
arrays that the cache swaps in by reference; here the slabs are copied
into the pools in place (`index_copy_`), since a copy of the whole pool
per upload would move the pool's size (2.35 GB at 2048 slots of 8192 x
128 rows) for every batch of misses. In-place writes are safe because
`HbmBucketCache` never claims a slot that a search has acquired and not
yet launched its scan on, and every upload and scan of a cache runs on
one stream (index/hbm_cache.py). The H2D cost of an upload stays exactly
`ops/perf_model.slab_bytes(cap, d)` a slab.
"""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.ops import perf_model


@perf_model.register_op("tiering.scatter_slabs")
def scatter_slabs(
    pools: tuple[torch.Tensor, ...],  # (pool8, scale, vsq, ids), in place
    slabs: tuple[np.ndarray, ...],    # host [m, cap, ...], pools' order
    slots: np.ndarray,                # [m] slot ids
    pool_lens: torch.Tensor,          # [slots] int32 live rows, in place
) -> None:
    """Copy m host slabs into their pool slots: one upload and one
    `index_copy_` a pool, all on the current stream. Each slot's live-row
    count (ids >= 0; rows are packed at the front of a slab) is counted
    from the uploaded ids on the device, so it adds no H2D bytes."""
    dev = pools[0].device
    idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(dev)
    for pool, slab in zip(pools, slabs):
        pool.index_copy_(0, idx, torch.from_numpy(slab).to(dev))
    pool_lens.index_copy_(
        0, idx, (pools[3][idx] >= 0).sum(1, dtype=torch.int32))
