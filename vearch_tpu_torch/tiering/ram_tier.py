"""Host-RAM tier: frequency-admitted caches between NVMe and HBM, a copy
of vearch_tpu/tiering/ram_tier.py with plain locks.

Two consumers, one policy engine:

- :class:`HostRamSlabTier` — prepared bucket slabs (int8 rows + scale +
  vsq + docids) for the DISKANN scan tier. An HBM bucket-cache miss
  that hits here costs one memcpy into the staging upload instead of a
  page-fault walk over the mmap gather.
- :class:`HostRowCache` — raw f32 rows for the rerank tier
  (engine/disk_vector.py `get_rows`): hot candidate rows stop
  re-faulting mmap pages on every rerank gather.

Admission is frequency-based, not admit-on-first-touch: a one-shot
scan over a cold working set must not evict the resident hot set, so a
key is only admitted once its decayed access count reaches
``admit_after`` (default 2 — i.e. proven reuse). Decay is epoch-based:
every ``decay_every`` lookups the effective count of every key halves
lazily, so yesterday's hot bucket does not stay pinned in the
admission race forever. Eviction within the byte budget is plain LRU.

Thread-safe: the prefetch worker, search threads and rerank gathers
all go through one lock per cache.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable

import numpy as np


class _FreqLruBytes:
    """Byte-budgeted LRU with decayed-frequency admission.

    Values are opaque; the caller supplies each entry's byte size. A
    lookup miss records frequency; `offer` admits only keys whose
    effective frequency has reached ``admit_after``.
    """

    def __init__(
        self,
        budget_bytes: int,
        admit_after: int = 2,
        decay_every: int = 4096,
        name: str = "tier_ram",
    ):
        self.budget_bytes = int(budget_bytes)
        self.admit_after = max(int(admit_after), 1)
        self.decay_every = max(int(decay_every), 1)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admitted = 0
        self.rejected = 0
        self.resident_bytes = 0
        self.name = name
        self._lock = threading.Lock()
        self._entries: OrderedDict[Any, tuple[Any, int]] = OrderedDict()
        # key -> (raw count, epoch recorded); effective count halves
        # per elapsed epoch, applied lazily on touch
        self._freq: dict[Any, tuple[float, int]] = {}
        self._epoch = 0
        self._lookups = 0

    # internal helpers assume self._lock is held by the public entry
    # points below

    def _touch_freq(self, key: Any) -> float:
        self._lookups += 1
        if self._lookups % self.decay_every == 0:
            self._epoch += 1
            if len(self._freq) > 4 * max(len(self._entries), 64):
                # shed keys decayed below admission relevance so the
                # frequency map cannot grow with the whole keyspace
                self._freq = {
                    k: cf for k, cf in self._freq.items()
                    if cf[0] * 0.5 ** (self._epoch - cf[1]) >= 0.5
                }
        count, epoch = self._freq.get(key, (0.0, self._epoch))
        count = count * (0.5 ** (self._epoch - epoch)) + 1.0
        self._freq[key] = (count, self._epoch)
        return count

    def _evict_to(self, want_free: int) -> None:
        while (
            self._entries
            and self.resident_bytes + want_free > self.budget_bytes
        ):
            _key, (_val, nbytes) = self._entries.popitem(last=False)
            self.resident_bytes -= nbytes
            self.evictions += 1

    def get(self, key: Any) -> Any | None:
        """Cached value or None; records frequency either way."""
        with self._lock:
            self._touch_freq(key)
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit[0]
            self.misses += 1
            return None

    def offer(self, key: Any, value: Any, nbytes: int) -> bool:
        """Admit `value` if the key's decayed frequency proves reuse
        and it fits the budget. Returns whether it was admitted."""
        with self._lock:
            count, epoch = self._freq.get(key, (0.0, self._epoch))
            eff = count * (0.5 ** (self._epoch - epoch))
            if eff < self.admit_after or nbytes > self.budget_bytes:
                self.rejected += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self.resident_bytes -= old[1]
            self._evict_to(nbytes)
            self._entries[key] = (value, nbytes)
            self.resident_bytes += nbytes
            self.admitted += 1
            return True

    def invalidate(self, key: Any) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.resident_bytes -= old[1]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._freq.clear()
            self.resident_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "entries": len(self._entries),
                "resident_bytes": self.resident_bytes,
                "budget_bytes": self.budget_bytes,
            }


class HostRamSlabTier:
    """Bucket-slab cache keyed (bucket, generation).

    `get(bucket, gen, loader)` returns the slab tuple (q8 [nb, d] int8,
    scale [nb] f32, vsq [nb] f32, docids [nb] i32), from RAM when the
    cached generation matches, else via `loader()` (the NVMe mmap
    gather) with frequency-based admission. A generation bump (realtime
    absorb appended rows to the bucket) turns the stale copy into a
    miss — same invalidation discipline as the HBM pool.
    """

    def __init__(self, budget_bytes: int, admit_after: int = 2):
        self._cache = _FreqLruBytes(
            budget_bytes, admit_after=admit_after, name="tier_ram_slab"
        )

    def get(
        self,
        bucket: int,
        gen: int,
        loader: Callable[[], tuple[np.ndarray, ...]],
    ) -> tuple[np.ndarray, ...]:
        hit = self._cache.get(bucket)
        if hit is not None and hit[0] == gen:
            return hit[1]
        if hit is not None:  # stale generation: a miss, not a hit
            self._cache.invalidate(bucket)
            with self._cache._lock:
                self._cache.hits -= 1
                self._cache.misses += 1
        slab = loader()
        nbytes = int(sum(a.nbytes for a in slab))
        self._cache.offer(bucket, (gen, slab), nbytes)
        return slab

    def clear(self) -> None:
        self._cache.clear()

    def stats(self) -> dict[str, int]:
        return self._cache.stats()


class HostRowCache:
    """Raw-row cache for disk-store rerank gathers.

    `get_rows(docids, loader)` returns [len(docids), d] float32; hot
    rows come from RAM, the rest from `loader(missing_ids)` (the mmap
    gather) and are admitted per decayed frequency. Rows are immutable
    once written (append-only stores, docid == row id), so entries
    never go stale; `clear()` exists for store rollback paths.
    """

    def __init__(self, dimension: int, budget_bytes: int,
                 admit_after: int = 2):
        self.dimension = int(dimension)
        self._row_bytes = self.dimension * 4
        self._cache = _FreqLruBytes(
            budget_bytes, admit_after=admit_after, name="tier_ram_row"
        )

    def get_rows(
        self,
        docids: np.ndarray,
        loader: Callable[[np.ndarray], np.ndarray],
    ) -> np.ndarray:
        ids = np.asarray(docids, dtype=np.int64)
        out = np.empty((ids.shape[0], self.dimension), dtype=np.float32)
        missing_pos: list[int] = []
        for j, docid in enumerate(ids.tolist()):
            row = self._cache.get(docid)
            if row is not None:
                out[j] = row
            else:
                missing_pos.append(j)
        if missing_pos:
            miss_ids = ids[missing_pos]
            rows = np.asarray(loader(miss_ids), dtype=np.float32)
            for j, docid, row in zip(
                missing_pos, miss_ids.tolist(), rows
            ):
                out[j] = row
                self._cache.offer(docid, np.array(row), self._row_bytes)
        return out

    def clear(self) -> None:
        self._cache.clear()

    def stats(self) -> dict[str, int]:
        return self._cache.stats()
