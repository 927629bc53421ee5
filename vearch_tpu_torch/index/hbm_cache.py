"""HBM bucket cache: on-demand device paging for disk-resident indexes,
the port of vearch_tpu/index/hbm_cache.py.

The unit of paging is an IVF bucket slab. Device memory holds a
fixed-shape pool of `slots` slabs

    pool8     [slots, cap, d] int8    quantized rows
    pool_sc   [slots, cap]    f32     per-row dequant scale
    pool_sq   [slots, cap]    f32     ||approx||^2
    pool_id   [slots, cap]    int32   docid per row (-1 padding)
    pool_lens [slots]         int32   live rows (ids >= 0, packed first)

and an LRU map bucket -> slot. A search resolves its probed buckets:
hits cost nothing; misses land in evicted slots (tiering/staging.py).
Appends to a bucket bump its generation, turning stale slabs into
misses. `pool_lens` is the port's addition: it lets the probe-dots
kernel skip each slab's padding, and changes no result and no ledger
byte (it is counted on the device from the uploaded ids).

- **Hot-bucket pinning**: the top `pin_slots` buckets by decayed access
  frequency are exempt from LRU eviction.
- **Prefetch**: `prefetch()` uploads predicted next-probe slabs from a
  background thread; demand hits on them count in `prefetch_hits`.
- **Multi-pass**: `plan_passes()` splits a probe set that exceeds the
  evictable slots into groups; `acquire(restrict=...)` resolves one
  group, giving slot -1 to the deferred probes.
- **PCIe ledger**: every upload notes its bytes through
  ops/perf_model.note_h2d_bytes, exactly `tier_h2d_bytes(m, cap, d)`.

**Slot leases** (where the port departs from the reference). The
reference never writes a pool in place: each upload builds new arrays
and swaps them in, so a scan holds the old ones. Here uploads write the
pools in place (a whole-pool copy per upload would move gigabytes), so
`acquire` leases the slots it resolved to the calling thread until that
thread calls `release()` — after it has launched its scan — or acquires
again. No upload claims a leased slot: a prefetch skips it, a demand
resolve waits for the lease to go, and `invalidate` waits for every
lease. Uploads and scans of a cache run on one stream (`stream`), so a
slab written after a lease is released is written after the scan that
read it. With a single search thread no lease is ever held during a
resolve, so the slot map is the reference's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Iterable

import numpy as np
import torch

from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.tiering.staging import scatter_slabs

FetchFn = Callable[
    [int], tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
]

# decayed-frequency bookkeeping: every _DECAY_EVERY resolved buckets the
# effective count of every bucket halves (applied lazily), so pinning
# tracks the current hot set rather than all-time access totals
_DECAY_EVERY = 1024
_PIN_MIN_FREQ = 2.0  # a bucket must prove reuse before it can pin


class HbmBucketCache:
    def __init__(
        self,
        dimension: int,
        slots: int,
        cap: int,
        pin_slots: int | None = None,
        device=None,
    ):
        self.dimension = dimension
        self.slots = slots
        self.cap = cap
        # at least one evictable slot must remain or demand resolves of
        # unpinned buckets could never claim space
        self.pin_slots = max(
            0,
            min(slots // 4 if pin_slots is None else int(pin_slots),
                slots - 1),
        )
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.pin_hits = 0
        self.prefetch_hits = 0
        self.prefetched = 0
        self.h2d_bytes = 0
        self._lock = threading.Lock()
        # notified whenever a lease is released
        self._released = threading.Condition(self._lock)
        self._lru: OrderedDict[int, int] = OrderedDict()  # bucket -> slot
        self._slot_gen: dict[int, int] = {}  # bucket -> generation cached
        self._free = list(range(slots - 1, -1, -1))
        self._pinned: set[int] = set()
        self._from_prefetch: set[int] = set()
        self._freq: dict[int, tuple[float, int]] = {}
        self._epoch = 0
        self._lookups = 0
        self._last_resolved: set[int] = set()
        self._leased: dict[int, int] = {}  # slot -> lease count
        self._leases: dict[int, list[int]] = {}  # thread -> leased slots
        dev = torch.device("cpu" if device is None else device)
        self.device = dev
        self.stream = (torch.cuda.current_stream(dev)
                       if dev.type == "cuda" else None)
        self._pool8 = torch.zeros((slots, cap, dimension), dtype=torch.int8,
                                  device=dev)
        self._pool_sc = torch.zeros((slots, cap), dtype=torch.float32,
                                    device=dev)
        self._pool_sq = torch.zeros((slots, cap), dtype=torch.float32,
                                    device=dev)
        self._pool_id = torch.full((slots, cap), -1, dtype=torch.int32,
                                   device=dev)
        self._pool_lens = torch.zeros(slots, dtype=torch.int32, device=dev)

    @property
    def slab_bytes(self) -> int:
        """H2D bytes one slab upload moves (= perf_model.slab_bytes)."""
        return perf_model.slab_bytes(self.cap, self.dimension)

    @property
    def hbm_bytes(self) -> int:
        return self.slots * self.slab_bytes

    @contextlib.contextmanager
    def on_stream(self):
        """Run the enclosed uploads or scans on the cache's stream, ordered
        after the caller's stream's work so far and before its later
        work."""
        caller = (torch.cuda.current_stream(self.device)
                  if self.stream is not None else None)
        if caller is None or caller == self.stream:
            yield
            return
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)

    # -- demand path --------------------------------------------------

    def resolve(
        self,
        buckets: np.ndarray,
        gens: dict[int, int],
        fetch: FetchFn,
    ) -> np.ndarray:
        """Map unique bucket ids -> device slots, uploading misses.

        `gens[b]` is bucket b's current generation; `fetch(b)` returns
        host (q8 [nb, d], scale [nb], vsq [nb], docids [nb]) with
        nb <= cap. Returns slot ids aligned with `buckets`. Raises when
        the probe set cannot fit one pass (multi-pass callers use
        `plan_passes` and `acquire(restrict=...)`). Takes no lease."""
        uniq = np.unique(buckets)
        if len(uniq) > self.slots:
            raise ValueError(
                f"probe set ({len(uniq)} buckets) exceeds cache "
                f"capacity ({self.slots} slots); raise cache_mb or "
                f"lower nprobe*batch"
            )
        with self._lock:
            self._release_locked(threading.get_ident())
            return self._resolve_locked(buckets, gens, fetch, None)

    def acquire(
        self,
        buckets: np.ndarray,
        gens: dict[int, int],
        fetch: FetchFn,
        restrict: Iterable[int] | None = None,
    ) -> tuple[np.ndarray, tuple[torch.Tensor, ...]]:
        """Resolve and take the pools as one step, leasing the resolved
        slots to the calling thread until it calls `release()` (or
        acquires again): no upload writes them meanwhile. With
        `restrict`, only that bucket subset is resolved; other probes get
        slot -1. Returns (slots, (pool8, pool_sc, pool_sq, pool_id,
        pool_lens))."""
        with self._lock:
            me = threading.get_ident()
            self._release_locked(me)
            slots = self._resolve_locked(
                buckets, gens, fetch,
                None if restrict is None else set(restrict),
            )
            held = sorted({int(s) for s in np.ravel(slots) if s >= 0})
            for s in held:
                self._leased[s] = self._leased.get(s, 0) + 1
            self._leases[me] = held
            return slots, self.pools()

    def release(self) -> None:
        """Drop the calling thread's lease (after its scan launched)."""
        with self._lock:
            self._release_locked(threading.get_ident())

    def plan_passes(self, buckets: np.ndarray) -> list[list[int]]:
        """Split a probe set into groups that each fit one fixed-shape
        pass: pinned buckets keep their slots (cost 0), every other
        bucket needs one of the `slots - len(pinned)` evictable slots.
        One group for the common case; never raises."""
        uniq = [int(b) for b in np.unique(buckets)]
        with self._lock:
            limit = max(1, self.slots - len(self._pinned))
            groups: list[list[int]] = []
            cur: list[int] = []
            cost = 0
            for b in uniq:
                c = 0 if b in self._pinned else 1
                if cur and cost + c > limit:
                    groups.append(cur)
                    cur, cost = [], 0
                cur.append(b)
                cost += c
            if cur:
                groups.append(cur)
            return groups

    # -- internals (lock held) ----------------------------------------

    def _release_locked(self, thread: int) -> None:
        held = self._leases.pop(thread, None)
        if not held:
            return
        for s in held:
            left = self._leased[s] - 1
            if left:
                self._leased[s] = left
            else:
                del self._leased[s]
        self._released.notify_all()

    def _resident(self, b: int, gens: dict[int, int]) -> bool:
        return (b in self._lru
                and self._slot_gen.get(b) == gens.get(b, 0))

    def _must_wait(self, active: list[int], gens: dict[int, int]) -> bool:
        """Whether resolving `active` now would have to write a leased
        slot: a stale resident bucket re-uploads into its own slot, and
        every other miss needs a free slot or an unleased victim outside
        the active set."""
        active_set = set(active)
        need = 0
        for b in active:
            if self._resident(b, gens):
                continue
            if b in self._lru:
                if self._lru[b] in self._leased:
                    return True
            else:
                need += 1
        if need <= len(self._free):
            return False
        spare = sum(1 for b, s in self._lru.items()
                    if b not in active_set and s not in self._leased)
        return len(self._free) + spare < need

    def _resolve_locked(self, buckets, gens, fetch, restrict):
        uniq = [int(b) for b in np.unique(buckets)]
        active = (
            uniq if restrict is None
            else [b for b in uniq if b in restrict]
        )
        while self._leased and self._must_wait(active, gens):
            self._released.wait()
        missing: list[int] = []
        for b in active:
            self._touch_freq(b)
            if self._resident(b, gens):
                self._lru.move_to_end(b)
                self.hits += 1
                if b in self._pinned:
                    self.pin_hits += 1
                elif b in self._from_prefetch:
                    self.prefetch_hits += 1
            else:
                missing.append(b)
                self.misses += 1
        if missing:
            t0 = time.monotonic()
            # the reference protects nothing here; protecting the
            # resolved set only differs where the reference would evict
            # a bucket it is about to return a slot for
            self._upload(missing, gens, fetch, protect=frozenset(active),
                         prefetch=False)
            ivf_ops.note_tier_phase("fetch", t0, time.monotonic())
        self._last_resolved = set(active)
        self._recompute_pins()
        active_set = set(active)
        slot_of = self._lru
        return np.asarray(
            [
                slot_of[b] if b in active_set else -1
                for b in (int(x) for x in np.ravel(buckets))
            ],
            dtype=np.int32,
        ).reshape(np.shape(buckets))

    # -- prefetch path ------------------------------------------------

    def prefetch(
        self, buckets: Iterable[int], gens: dict[int, int], fetch: FetchFn
    ) -> int:
        """Upload predicted next-probe slabs ahead of demand. Already-
        resident buckets are marked prefetch-confirmed (their next
        demand hit counts in prefetch_hits); misses upload without
        evicting pinned buckets, the most recently resolved set or a
        leased slot, and without touching the demand hit/miss/frequency
        accounting. Returns the number of slabs uploaded."""
        with self._lock:
            missing: list[int] = []
            for b in {int(b) for b in buckets}:
                if self._resident(b, gens):
                    self._from_prefetch.add(b)
                elif self._lru.get(b) not in self._leased:
                    missing.append(b)
            if not missing:
                return 0
            n = self._upload(
                missing, gens, fetch,
                protect=frozenset(self._last_resolved), prefetch=True,
            )
            self.prefetched += n
            return n

    def _touch_freq(self, bucket: int) -> None:
        self._lookups += 1
        if self._lookups % _DECAY_EVERY == 0:
            self._epoch += 1
            if len(self._freq) > 8 * self.slots:
                # shed fully-decayed buckets so the frequency map stays
                # O(slots), not O(nlist)
                self._freq = {
                    b: cf for b, cf in self._freq.items()
                    if cf[0] * 0.5 ** (self._epoch - cf[1]) >= 0.5
                }
        count, epoch = self._freq.get(bucket, (0.0, self._epoch))
        self._freq[bucket] = (
            count * (0.5 ** (self._epoch - epoch)) + 1.0,
            self._epoch,
        )

    def _recompute_pins(self) -> None:
        if self.pin_slots <= 0:
            return
        t0 = time.monotonic()
        scored: list[tuple[float, int]] = []
        for b in self._lru:
            cf = self._freq.get(b)
            if cf is None:
                continue
            eff = cf[0] * 0.5 ** (self._epoch - cf[1])
            if eff >= _PIN_MIN_FREQ:
                scored.append((eff, b))
        scored.sort(reverse=True)
        new = {b for _, b in scored[: self.pin_slots]}
        if new != self._pinned:
            self._pinned = new
            ivf_ops.note_tier_phase("pin", t0, time.monotonic())

    def _upload(self, missing, gens, fetch, protect, prefetch) -> int:
        staged: list[tuple[int, int]] = []  # (bucket, slot)
        for b in missing:
            slot = self._claim(b, protect, allow_pin_evict=not prefetch)
            if slot is None:  # prefetch found nothing evictable: skip
                continue
            staged.append((b, slot))
        if not staged:
            return 0
        m = len(staged)
        h8 = np.zeros((m, self.cap, self.dimension), dtype=np.int8)
        hsc = np.zeros((m, self.cap), dtype=np.float32)
        hsq = np.zeros((m, self.cap), dtype=np.float32)
        hid = np.full((m, self.cap), -1, dtype=np.int32)
        slots = np.zeros(m, dtype=np.int32)
        for j, (b, slot) in enumerate(staged):
            q8, sc, sq, ids = fetch(b)
            nb = q8.shape[0]
            assert nb <= self.cap, f"bucket {b} ({nb} rows) > cap {self.cap}"
            h8[j, :nb] = q8
            hsc[j, :nb] = sc
            hsq[j, :nb] = sq
            hid[j, :nb] = ids
            slots[j] = slot
            self._slot_gen[b] = gens.get(b, 0)
            if prefetch:
                self._from_prefetch.add(b)
            else:
                self._from_prefetch.discard(b)
        nbytes = h8.nbytes + hsc.nbytes + hsq.nbytes + hid.nbytes
        self.h2d_bytes += nbytes
        perf_model.note_h2d_bytes(nbytes)
        with self.on_stream():
            scatter_slabs(
                (self._pool8, self._pool_sc, self._pool_sq, self._pool_id),
                (h8, hsc, hsq, hid), slots, self._pool_lens)
        return m

    def _claim(self, bucket, protect, allow_pin_evict) -> int | None:
        old = self._lru.pop(bucket, None)
        if old is not None:  # stale-generation re-upload: keep the slot
            self._lru[bucket] = old
            return old
        if self._free:
            slot = self._free.pop()
            self._lru[bucket] = slot
            return slot
        leased = self._leased
        victim = next(
            (b for b, s in self._lru.items()
             if b not in protect and b not in self._pinned
             and s not in leased),
            None,
        )
        if victim is None and allow_pin_evict:
            # demand must succeed: fall back to evicting a pinned (then
            # any unleased) bucket rather than failing the search
            victim = next(
                (b for b, s in self._lru.items()
                 if b not in protect and s not in leased), None
            )
            if victim is None:
                victim = next(
                    (b for b, s in self._lru.items() if s not in leased),
                    None)
        if victim is None:
            return None
        slot = self._lru.pop(victim)
        self._slot_gen.pop(victim, None)
        self._from_prefetch.discard(victim)
        self._pinned.discard(victim)
        self.evictions += 1
        self._lru[bucket] = slot
        return slot

    # -- introspection ------------------------------------------------

    def pools(self) -> tuple[torch.Tensor, ...]:
        """(pool8, pool_sc, pool_sq, pool_id, pool_lens)."""
        return (self._pool8, self._pool_sc, self._pool_sq, self._pool_id,
                self._pool_lens)

    def stats(self) -> dict[str, int]:
        """Tiering counters (the reference's keys)."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "pin_hits": self.pin_hits,
                "prefetch_hits": self.prefetch_hits,
                "prefetched": self.prefetched,
                "h2d_bytes": self.h2d_bytes,
                "pinned": len(self._pinned),
                "pin_slots": self.pin_slots,
                "resident": len(self._lru),
                "slots": self.slots,
                "cap": self.cap,
                "slab_bytes": self.slab_bytes,
                "resident_bytes": len(self._lru) * self.slab_bytes,
                "hbm_bytes": self.hbm_bytes,
            }

    def seed_counters(self, stats: dict[str, int]) -> None:
        """Carry lifetime counters across a cache rebuild (capacity
        regrow) so operator-facing hit rates don't reset mid-flight."""
        with self._lock:
            self.hits += int(stats.get("hits", 0))
            self.misses += int(stats.get("misses", 0))
            self.evictions += int(stats.get("evictions", 0))
            self.pin_hits += int(stats.get("pin_hits", 0))
            self.prefetch_hits += int(stats.get("prefetch_hits", 0))
            self.prefetched += int(stats.get("prefetched", 0))
            self.h2d_bytes += int(stats.get("h2d_bytes", 0))

    def invalidate(self) -> None:
        """Forget every slab (after every lease is released)."""
        with self._lock:
            self._release_locked(threading.get_ident())
            self._released.wait_for(lambda: not self._leased)
            self._lru.clear()
            self._slot_gen.clear()
            self._free = list(range(self.slots - 1, -1, -1))
            self._pinned.clear()
            self._from_prefetch.clear()
            self._freq.clear()
            self._last_resolved = set()
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self.pin_hits = 0
            self.prefetch_hits = 0
            self.prefetched = 0
