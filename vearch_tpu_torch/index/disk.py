"""Disk-resident ANN index (DISKANN, DISKANN_STATIC), the port of
vearch_tpu/index/disk.py.

    disk   raw.f32       full vectors, docid-ordered mmap (rerank tier)
           approx8.i8    per-row int8 approximations (scan tier)
           meta2.f32     per-row (scale, ||approx||^2)
           assign.i32    per-row coarse assignment (bucket rebuild)
    RAM    per-bucket docid lists, and a frequency-admitted slab tier
           (tiering/HostRamSlabTier) so a device miss costs a memcpy,
           not a page-fault walk
    device coarse centroids (always resident) and a bucket slab cache
           with hot-bucket pinning (index/hbm_cache.HbmBucketCache)

Search: coarse top-nprobe on the device -> resolve the probed buckets
against the slab cache (misses page slabs RAM -> device; RAM misses
gather from the mmap behind read-ahead) -> the int8 bucket scan
(ops/ivf.cached_bucket_scan: the probe-dots Hopper kernel on a GPU) ->
exact rerank of the top candidates against host-gathered raw rows. The
coarse probes also feed a successor predictor whose predicted next
probe set is paged in on a background thread (tiering/prefetch.py). A
probe set larger than the evictable slots is scanned in several passes
and the per-pass top lists are folded.

The files are the reference's, byte for byte, so either package reopens
the other's directory: a reopened index rebuilds its bucket lists from
`assign.i32` and absorbs only the rows past the durable count.

Where the port departs from the reference: `cache_mb` is read from the
index params when the cache is (re)built, so `apply_config`'s
`index_params` can change the device budget of a live index; and the
cache leases the slots a search resolved until its scan is launched
(index/hbm_cache.py).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams, MetricType
from vearch_tpu_torch.index._store_paths import rerank_against_store
from vearch_tpu_torch.index.base import VectorIndex
from vearch_tpu_torch.index.hbm_cache import HbmBucketCache
from vearch_tpu_torch.index.int8_mirror import quantize_rows
from vearch_tpu_torch.index.registry import register_index
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops import kmeans as km
from vearch_tpu_torch.ops.distance import stable_topk, to_device_mask
from vearch_tpu_torch.ops.probe_dots import MAX_SEGMENTS
from vearch_tpu_torch.tiering import (
    HostRamSlabTier,
    PrefetchWorker,
    SequencePredictor,
    readahead,
)

_ABSORB_CHUNK = 262_144  # rows per device assignment batch


@register_index("DISKANN")
@register_index("DISKANN_STATIC")
class DiskANNIndex(VectorIndex):
    needs_training = True

    def __init__(self, params: IndexParams, store: RawVectorStore):
        super().__init__(params, store)
        self.nlist = int(params.get("ncentroids", params.get("nlist", 1024)))
        self.default_nprobe = int(params.get("nprobe", 32))
        self.train_sample = int(params.get("training_sample", 262_144))
        self.train_iters = int(params.get("train_iters", 10))
        # tiered-storage knobs: host-RAM slab tier budget, prefetch
        # on/off, hot-bucket pin share of the device slots, RAM-tier
        # admission threshold
        self.ram_mb = int(params.get("ram_mb", 256))
        self.prefetch_enabled = bool(params.get("prefetch", True))
        self._pin_slots_param = params.get("pin_slots")
        admit_after = int(params.get("admit_after", 2))
        self.centroids: torch.Tensor | None = None  # [nlist, d] f32
        self._members: list[list[int]] = []
        self._gens: dict[int, int] = {}
        self._cache: HbmBucketCache | None = None
        self._ram_tier = HostRamSlabTier(
            self.ram_mb << 20, admit_after=admit_after
        )
        self._predictor = SequencePredictor()
        self._prefetcher = PrefetchWorker(self._prefetch_job)
        self._pf_lock = threading.Lock()
        directory = params.get("index_dir") or getattr(
            store, "directory", None
        )
        if directory is None:
            # memory-backed store + disk index: keep the scan files in a
            # scratch dir (tests, ad-hoc use); durable deployments pair
            # DISKANN with a DiskRawVectorStore so both tiers co-locate
            directory = tempfile.mkdtemp(prefix="vearch_diskann_")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._a8_path = os.path.join(directory, "approx8.i8")
        self._m2_path = os.path.join(directory, "meta2.f32")
        self._as_path = os.path.join(directory, "assign.i32")
        self._a8: np.memmap | None = None
        self._m2: np.memmap | None = None
        self._assign: np.memmap | None = None

    @property
    def cache_mb(self) -> int:
        """The device budget of the slab cache, a hard limit."""
        return int(self.params.get("cache_mb", 512))

    # -- disk scan-tier files ------------------------------------------------

    def _map_files(self, capacity: int) -> None:
        d = self.store.dimension
        for path, row_bytes in (
            (self._a8_path, d),
            (self._m2_path, 8),
            (self._as_path, 4),
        ):
            want = capacity * row_bytes
            have = os.path.getsize(path) if os.path.exists(path) else 0
            if have < want:
                with open(path, "ab") as f:
                    f.truncate(want)
        # capacity = min across the three files: a crash between the
        # truncates above must not brick reopen (rows beyond the durable
        # indexed_count are garbage either way)
        cap = min(
            os.path.getsize(self._a8_path) // d,
            os.path.getsize(self._m2_path) // 8,
            os.path.getsize(self._as_path) // 4,
        )
        self._a8 = np.memmap(
            self._a8_path, dtype=np.int8, mode="r+", shape=(cap, d)
        )
        self._m2 = np.memmap(
            self._m2_path, dtype=np.float32, mode="r+", shape=(cap, 2)
        )
        self._assign = np.memmap(
            self._as_path, dtype=np.int32, mode="r+", shape=(cap,)
        )

    def _ensure_capacity(self, n: int) -> None:
        if self._a8 is None or self._a8.shape[0] < n:
            cap = max(n, 4096,
                      0 if self._a8 is None else self._a8.shape[0] * 2)
            self._map_files(cap)

    # -- training ------------------------------------------------------------

    def _maybe_normalize(self, x: np.ndarray) -> np.ndarray:
        if self.metric is MetricType.COSINE:
            n = np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-15)
            return (x / n).astype(np.float32)
        return x

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            self.device)

    def train(self, sample: np.ndarray) -> None:
        x = np.asarray(sample, np.float32)
        if x.shape[0] > self.train_sample:
            idx = np.random.default_rng(0).choice(
                x.shape[0], self.train_sample, replace=False
            )
            x = x[idx]
        x = self._maybe_normalize(x)
        self.centroids = km.train_kmeans(
            self._to_device(x), k=self.nlist, iters=self.train_iters
        )
        self._members = [[] for _ in range(self.nlist)]
        self._gens = {}
        self.trained = True

    # -- realtime absorb -----------------------------------------------------

    def absorb(self, upto: int) -> None:
        with self._absorb_lock:
            if not self.trained or upto <= self.indexed_count:
                self.indexed_count = max(self.indexed_count, upto)
                return
            self._ensure_capacity(upto)
            start = self.indexed_count
            host = self.store.host_view()
            for lo in range(start, upto, _ABSORB_CHUNK):
                hi = min(lo + _ABSORB_CHUNK, upto)
                rows = self._maybe_normalize(
                    np.asarray(host[lo:hi], dtype=np.float32)
                )
                assign = km.assign_clusters(
                    self._to_device(rows), self.centroids
                ).cpu().numpy().astype(np.int32)
                q8, scale, vsq = quantize_rows(rows)
                self._a8[lo:hi] = q8
                self._m2[lo:hi, 0] = scale
                self._m2[lo:hi, 1] = vsq
                self._assign[lo:hi] = assign
                self._extend_members(assign, lo)
            self.indexed_count = upto

    def cell_populations(self) -> list[int] | None:
        with self._absorb_lock:
            if not self.trained:
                return None
            return [len(mm) for mm in self._members]

    def reconstruction_error(self, sample: int = 256,
                             seed: int = 0) -> float | None:
        """Dequantize stored int8 scan rows (a8 * scale) against the raw
        store, reading the mmaps directly: no device work."""
        with self._absorb_lock:
            n = int(self.indexed_count)
            if not self.trained or n == 0 or self._a8 is None:
                return None
            rng = np.random.default_rng(seed)
            ids = np.sort(rng.choice(n, size=min(int(sample), n),
                                     replace=False))
            raw = self._maybe_normalize(
                np.asarray(self.store.host_view()[ids], dtype=np.float32))
            approx = (np.asarray(self._a8[ids], dtype=np.float32)
                      * np.asarray(self._m2[ids, 0],
                                   dtype=np.float32)[:, None])
            num = np.linalg.norm(raw - approx, axis=1)
            den = np.maximum(np.linalg.norm(raw, axis=1), 1e-12)
            return float(np.mean(num / den))

    def device_footprint_bytes(self) -> int:
        """The centroids, the slab pools at the cache_mb budget and their
        per-slot live lengths (the port's `pool_lens`, [slots] int32), and
        the raw store's device buffer when the store is not on disk. The
        reference's model counts the raw store as device-resident and no
        pools."""
        total = self._raw_store_device_bytes()
        if self.centroids is not None:
            total += self.centroids.numel() * self.centroids.element_size()
        cache = self._cache
        if cache is not None:
            total += cache.hbm_bytes + cache.slots * 4
        return total

    def _extend_members(self, assign: np.ndarray, start: int) -> None:
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        docids = order.astype(np.int64) + start
        bounds = np.searchsorted(sorted_assign, np.arange(self.nlist + 1))
        for c in np.unique(sorted_assign):
            lo, hi = bounds[c], bounds[c + 1]
            self._members[int(c)].extend(docids[lo:hi].tolist())
            self._gens[int(c)] = self._gens.get(int(c), 0) + 1

    # -- cache ---------------------------------------------------------------

    def _slab_cap(self) -> int:
        """Slab width: next power of two >= longest bucket (floor 128), so
        cache rebuilds stay O(log n) under steady ingest."""
        longest = max((len(mm) for mm in self._members), default=0)
        cap = 128
        while cap < longest:
            cap *= 2
        return cap

    def _ensure_cache(self) -> HbmBucketCache:
        cap = self._slab_cap()
        d = self.store.dimension
        slab_bytes = cap * (d + 12)
        # cache_mb is a hard device budget, never exceeded; a probe set
        # that cannot fit one pass takes several (plan_passes / acquire)
        slots = max(1, min(self.nlist, (self.cache_mb << 20) // slab_bytes))
        if slots + 1 > MAX_SEGMENTS:
            raise ValueError(
                f"{slots} cache slots exceed the probe-dots kernel's "
                f"{MAX_SEGMENTS - 1}; lower cache_mb or ncentroids")
        if (
            self._cache is None
            or self._cache.cap < cap
            or self._cache.slots != slots
        ):
            old = self._cache
            self._cache = HbmBucketCache(
                d, slots, cap, pin_slots=self._pin_slots_param,
                device=self.device,
            )
            if old is not None:
                # capacity regrow, not a reset: keep operator-facing
                # lifetime counters continuous across the rebuild
                self._cache.seed_counters(old.stats())
        return self._cache

    def _make_fetch(
        self, gens: dict[int, int], n_snap: int
    ) -> Callable[[int], tuple[np.ndarray, ...]]:
        """Slab fetch closure for a consistent (gens, indexed_count)
        snapshot. A device miss goes to the host-RAM slab tier first; a
        RAM miss pays the mmap gather. Safe outside the absorb lock:
        absorb writes mmap rows before publishing bucket membership, and
        appended docids only grow past `n_snap` (filtered here, masked by
        the validity snapshot on the device)."""

        def fetch(b: int):
            def loader():
                ids = np.asarray(self._members[b], dtype=np.int64)
                ids = ids[ids < n_snap]
                a8, m2 = self._a8, self._m2
                ids = ids[ids < a8.shape[0]]
                # read-ahead before the strided mmap gathers: a cold slab
                # faults its rows as a few batched reads instead of one
                # synchronous fault per page (page cache only, zero H2D)
                readahead.advise_rows(a8, ids)
                readahead.advise_rows(m2, ids)
                return (
                    np.asarray(a8[ids]),
                    np.asarray(m2[ids, 0]),
                    np.asarray(m2[ids, 1]),
                    ids.astype(np.int32),
                )

            return self._ram_tier.get(b, gens.get(b, 0), loader)

        return fetch

    def _fetch_bucket(self, b: int):
        """Single-bucket slab fetch at the live snapshot."""
        return self._make_fetch(dict(self._gens), self.indexed_count)(b)

    # -- search --------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int,
        valid_mask,
        params: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        assert self.trained, "DISKANN search before training"
        p = params or {}
        q = self._maybe_normalize(np.asarray(queries, np.float32))
        nprobe = min(
            int(p.get("nprobe", self.default_nprobe)), self.nlist
        )
        r = int(p.get("rerank", self.params.get("rerank", max(10 * k, 128))))
        r = max(min(r, max(self.indexed_count, 1)), k)
        metric = (
            MetricType.INNER_PRODUCT
            if self.metric is MetricType.COSINE
            else self.metric
        )
        # the absorb lock guards only the snapshot (cache shape,
        # generation map, durable row count); the coarse probe, slab
        # resolution and scan run outside it
        with self._absorb_lock:
            cache = self._ensure_cache()
            gens = dict(self._gens)
            n_indexed = self.indexed_count
        qd = self._to_device(q)
        probes = ivf_ops._coarse_probes(qd, self.centroids, nprobe
                                        ).cpu().numpy()  # [B, nprobe]
        self._schedule_prefetch(probes, gens)
        fetch = self._make_fetch(gens, n_indexed)
        n_pad = max(self.store.capacity, 1)
        valid = to_device_mask(valid_mask, n_indexed, n_pad, self.device)
        groups = cache.plan_passes(probes)

        def scan(restrict):
            slots, (p8, psc, psq, pid, plens) = cache.acquire(
                probes, gens, fetch, restrict=restrict)
            try:
                return ivf_ops.cached_bucket_scan(
                    qd, p8, psc, psq, pid,
                    torch.from_numpy(slots).to(self.device), valid, r,
                    metric, pool_lens=plens)
            finally:
                # the scan is on the cache's stream: its slots may now
                # be written by the next upload
                cache.release()

        with cache.on_stream():
            if len(groups) == 1:
                cand_s, cand_i = scan(None)
            else:
                # the probe set exceeds the evictable slots: scan it in
                # several passes (deferred probes ride as slot -1) and
                # fold the per-pass top lists; buckets are disjoint
                # across passes, so the fold sees no docid twice
                parts = [scan(group) for group in groups]
                cat_s = torch.cat([s for s, _ in parts], dim=1)
                cat_i = torch.cat([i for _, i in parts], dim=1)
                cand_s, pos = stable_topk(cat_s, r)
                cand_i = torch.gather(cat_i, 1, pos)
        # rerank tier: raw rows fault in from the mmap'd store (or the
        # device buffer when paired with a memory store)
        scores, ids = rerank_against_store(
            self.store, np.asarray(queries, np.float32), cand_i, k,
            self.metric,
        )
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        if scores.shape[1] >= k:
            return scores[:, :k], ids[:, :k]
        pad = k - scores.shape[1]
        return (
            np.pad(scores, ((0, 0), (0, pad)), constant_values=float("-inf")),
            np.pad(ids, ((0, 0), (0, pad)), constant_values=-1),
        )

    # -- tiering: prefetch + observability -----------------------------------

    def _schedule_prefetch(
        self, probes: np.ndarray, gens: dict[int, int]
    ) -> None:
        """Feed this query's probe set to the successor predictor and hand
        the predicted next probe set to the background worker."""
        if not self.prefetch_enabled:
            return
        t0 = time.monotonic()
        key = tuple(sorted({int(b) for b in np.ravel(probes)}))
        with self._pf_lock:
            predicted = self._predictor.observe(key)
        if predicted is not None:
            self._prefetcher.submit((predicted, gens))
        ivf_ops.note_tier_phase("prefetch", t0, time.monotonic())

    def _prefetch_job(self, job: tuple[tuple[int, ...], dict[int, int]]):
        buckets, gens = job
        cache = self._cache
        if cache is None:
            return
        fetch = self._make_fetch(gens, self.indexed_count)
        cache.prefetch(buckets, gens, fetch)

    def tiering_info(self) -> dict[str, Any]:
        cache = self._cache
        return {
            "kind": "diskann",
            "hbm": cache.stats() if cache is not None else None,
            "ram": self._ram_tier.stats(),
            "prefetch": {
                "enabled": self.prefetch_enabled,
                "predictor_keys": len(self._predictor),
                **self._prefetcher.stats(),
            },
        }

    def close(self) -> None:
        self._prefetcher.close()

    # -- persistence ---------------------------------------------------------

    def dump_state(self) -> dict[str, Any]:
        if not self.trained:
            return {}
        with self._absorb_lock:
            if self._a8 is not None:
                self._a8.flush()
                self._m2.flush()
                self._assign.flush()
            return {
                "centroids": self.centroids.cpu().numpy(),
                "indexed_count": np.int64(self.indexed_count),
            }

    def load_state(self, state: dict[str, Any]) -> None:
        if "centroids" not in state:
            return
        self.centroids = self._to_device(state["centroids"])
        self.trained = True
        self._members = [[] for _ in range(self.nlist)]
        self._gens = {}
        self.indexed_count = 0
        n = int(state.get("indexed_count", 0))
        n = min(n, self.store.count)
        if n > 0 and os.path.exists(self._as_path):
            # the scan-tier mmaps are durable: rebuild the bucket lists
            # from the persisted assignment column instead of re-encoding
            self._ensure_capacity(n)
            self._extend_members(np.asarray(self._assign[:n]), 0)
            self.indexed_count = n
        if self._cache is not None:
            self._cache.invalidate()
        self._ram_tier.clear()
        # tail rows past the durable count absorb from the raw vectors
        self.absorb(self.store.count)
