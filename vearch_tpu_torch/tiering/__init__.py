"""Tiered storage engine: HBM <-> host RAM <-> NVMe, the port of
vearch_tpu/tiering/.

    NVMe   approx8.i8 / meta2.f32 / raw.<dtype> mmaps (index/disk.py,
           engine/disk_vector.py) — durable, page-cache backed
    RAM    HostRamSlabTier / HostRowCache (ram_tier.py) — frequency-
           admitted slab and row copies, so an HBM miss costs a memcpy,
           not a page fault storm
    HBM    HbmBucketCache (index/hbm_cache.py) — fixed-shape slab
           pools, hot-bucket pinning, LRU for the rest

`staging.py` scatters uploaded slabs into their pool slots in place;
`prefetch.py` pages predicted next-probe slabs on a background thread;
`readahead.py` advises the kernel before strided mmap gathers. The PCIe
ledger is ops/perf_model.py (`slab_bytes`, `tier_h2d_bytes`,
`note_h2d_bytes`): a warmed hot working set moves zero H2D bytes, and a
cold miss exactly the modelled slab bytes.
"""

from vearch_tpu_torch.tiering.prefetch import PrefetchWorker, SequencePredictor
from vearch_tpu_torch.tiering.ram_tier import HostRamSlabTier, HostRowCache
from vearch_tpu_torch.tiering.readahead import advise_rows
from vearch_tpu_torch.tiering.staging import scatter_slabs

__all__ = [
    "HostRamSlabTier",
    "HostRowCache",
    "PrefetchWorker",
    "SequencePredictor",
    "advise_rows",
    "scatter_slabs",
]
