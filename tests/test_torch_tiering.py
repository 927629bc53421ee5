"""The port's tiering machinery against vearch_tpu's on the CPU.

- `_FreqLruBytes`, `HostRamSlabTier`, `HostRowCache`, `SequencePredictor`
  and `PrefetchWorker` (vearch_tpu_torch/tiering/) take the same seeded
  sequences of calls as the reference's (vearch_tpu/tiering/): every
  return value and every `stats()` equal.
- `HbmBucketCache` (vearch_tpu_torch/index/hbm_cache.py) on CPU tensors
  and the reference's take the same resolve / acquire / prefetch /
  invalidate sequences: equal slot maps, `stats()`, ledger bytes and
  pool contents. A cold miss costs exactly `tier_h2d_bytes`, a warmed
  hot set adds 0 bytes, and `pool_lens` counts each slot's live rows.
- The slot leases the port adds (the reference swaps whole pools
  instead of writing them in place): a prefetch or a second search
  running between one search's `acquire` and its `release` never writes
  a slot the first one holds.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from vearch_tpu.index import hbm_cache as ref_cache  # noqa: E402
from vearch_tpu.ops import perf_model as ref_pm  # noqa: E402
from vearch_tpu.tiering import prefetch as ref_pf  # noqa: E402
from vearch_tpu.tiering import ram_tier as ref_rt  # noqa: E402
from vearch_tpu.tiering import readahead as ref_ra  # noqa: E402
from vearch_tpu_torch.index import hbm_cache as pt_cache  # noqa: E402
from vearch_tpu_torch.ops import perf_model as pt_pm  # noqa: E402
from vearch_tpu_torch.tiering import prefetch as pt_pf  # noqa: E402
from vearch_tpu_torch.tiering import ram_tier as pt_rt  # noqa: E402
from vearch_tpu_torch.tiering import readahead as pt_ra  # noqa: E402


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


# -- host tiers --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_freq_lru_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(budget_bytes=600, admit_after=2, decay_every=16)
    ref, port = ref_rt._FreqLruBytes(**kw), pt_rt._FreqLruBytes(**kw)
    for _ in range(600):
        op = rng.integers(0, 10)
        key = int(rng.zipf(1.3)) % 40
        if op < 6:
            assert ref.get(key) == port.get(key)
        elif op < 9:
            nbytes = int(rng.integers(10, 200))
            assert ref.offer(key, f"v{key}", nbytes) == \
                port.offer(key, f"v{key}", nbytes)
        else:
            ref.invalidate(key)
            port.invalidate(key)
        assert ref.stats() == port.stats()
    ref.clear()
    port.clear()
    assert ref.stats() == port.stats() and len(ref) == len(port) == 0


def _slab(b, gen, d=8):
    n = 3 + b % 4
    return (np.full((n, d), (b + gen) % 127, np.int8),
            np.full(n, 0.5 + b, np.float32), np.full(n, 1.0 + gen, np.float32),
            np.arange(n, dtype=np.int32) + 10 * b)


@pytest.mark.parametrize("seed", [0, 1])
def test_ram_slab_tier_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref = ref_rt.HostRamSlabTier(1500, admit_after=2)
    port = pt_rt.HostRamSlabTier(1500, admit_after=2)
    gens: dict[int, int] = {}
    loads = {"ref": 0, "port": 0}

    def loader(who, b, g):
        def f():
            loads[who] += 1
            return _slab(b, g)
        return f

    for _ in range(400):
        b = int(rng.zipf(1.4)) % 24
        if rng.random() < 0.05:
            gens[b] = gens.get(b, 0) + 1  # a realtime absorb's bump
        g = gens.get(b, 0)
        a = ref.get(b, g, loader("ref", b, g))
        c = port.get(b, g, loader("port", b, g))
        for x, y in zip(a, c):
            np.testing.assert_array_equal(x, y)
        assert ref.stats() == port.stats()
    assert loads["ref"] == loads["port"]


@pytest.mark.parametrize("seed", [0, 1])
def test_host_row_cache_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    d = 16
    rows = rng.standard_normal((300, d)).astype(np.float32)
    ref = ref_rt.HostRowCache(d, 40 * d * 4, admit_after=2)
    port = pt_rt.HostRowCache(d, 40 * d * 4, admit_after=2)
    calls = {"ref": [], "port": []}

    def loader(who):
        def f(ids):
            calls[who].append(np.array(ids))
            return rows[ids]
        return f

    for _ in range(60):
        ids = (rng.zipf(1.2, size=int(rng.integers(1, 30))) % 300)
        a = ref.get_rows(ids, loader("ref"))
        b = port.get_rows(ids, loader("port"))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, rows[ids])
        assert ref.stats() == port.stats()
    assert len(calls["ref"]) == len(calls["port"])
    for x, y in zip(calls["ref"], calls["port"]):
        np.testing.assert_array_equal(x, y)
    ref.clear()
    port.clear()
    assert ref.stats() == port.stats()


@pytest.mark.parametrize("capacity", [3, 512])
def test_sequence_predictor_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    ref = ref_pf.SequencePredictor(capacity)
    port = pt_pf.SequencePredictor(capacity)
    for _ in range(500):
        key = tuple(sorted(rng.choice(20, 3, replace=False).tolist())) \
            if rng.random() < 0.3 else (int(rng.integers(0, 6)),)
        assert ref.observe(key) == port.observe(key)
        assert len(ref) == len(port)


def _worker_run(cls, jobs, depth):
    gate = threading.Event()
    ran = []

    def fn(job):
        gate.wait(timeout=10.0)
        if job == "boom":
            raise RuntimeError("boom")
        ran.append(job)

    w = cls(fn, depth=depth)
    try:
        w.submit(jobs[0])
        deadline = time.monotonic() + 5.0
        while w._q.qsize() and time.monotonic() < deadline:
            time.sleep(0.005)  # the worker holds the first job
        for j in jobs[1:]:
            w.submit(j)
        gate.set()
        assert w.drain(timeout=10.0)
        return ran, w.stats()
    finally:
        w.close()
        w.submit("after-close")


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_worker_matches_reference(depth):
    jobs = ["first", "a", "boom", "b", "c", None, "d"]
    ran_ref, st_ref = _worker_run(ref_pf.PrefetchWorker, jobs, depth)
    ran_pt, st_pt = _worker_run(pt_pf.PrefetchWorker, jobs, depth)
    assert ran_ref == ran_pt
    assert st_ref == st_pt


def test_readahead_copy_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 5000, 400)
    assert ref_ra._coalesce(ids) == pt_ra._coalesce(ids)
    arr = np.memmap(tmp_path / "m.i8", dtype=np.int8, mode="w+",
                    shape=(5000, 64))
    assert ref_ra.advise_rows(arr, ids) == pt_ra.advise_rows(arr, ids)
    assert pt_ra.advise_rows(np.zeros((5, 4)), np.arange(3)) == 0


def test_pcie_model_matches_reference():
    for cap, d, m in ((128, 8, 0), (8192, 128, 930), (512, 96, 3)):
        assert pt_pm.slab_bytes(cap, d) == ref_pm.slab_bytes(cap, d)
        assert pt_pm.tier_h2d_bytes(m, cap, d) == \
            ref_pm.tier_h2d_bytes(m, cap, d)


# -- HbmBucketCache ------------------------------------------------------------


D, CAP = 8, 16


def _fetch(b):
    """A bucket slab, 1..CAP rows by bucket id, distinct contents."""
    n = 1 + (b * 7) % CAP
    rng = np.random.default_rng(b)
    return (rng.integers(-127, 128, (n, D)).astype(np.int8),
            rng.random(n).astype(np.float32),
            rng.random(n).astype(np.float32),
            (np.arange(n) + 100 * b).astype(np.int32))


def _same_cache(ref, port):
    assert ref.stats() == port.stats()
    assert list(ref._lru.items()) == list(port._lru.items())
    assert ref._pinned == port._pinned
    for a, b in zip(ref.pools(), port.pools()):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    lens = port.pools()[4].numpy()
    ids = port.pools()[3].numpy()
    np.testing.assert_array_equal(lens, (ids >= 0).sum(1))


@pytest.mark.parametrize("seed,pin_slots", [(0, None), (1, 0), (2, 2)])
def test_cache_sequence_matches_reference(seed, pin_slots):
    """Seeded resolve / acquire(restrict) / prefetch / invalidate calls
    with generation bumps: equal slot maps, counters, pools and ledger
    bytes at every step."""
    rng = np.random.default_rng(seed)
    slots = 6
    ref = ref_cache.HbmBucketCache(D, slots, CAP, pin_slots=pin_slots)
    port = pt_cache.HbmBucketCache(D, slots, CAP, pin_slots=pin_slots,
                                   device="cpu")
    gens: dict[int, int] = {}
    for step in range(120):
        op = rng.random()
        if op < 0.05:
            b = int(rng.integers(0, 20))
            gens[b] = gens.get(b, 0) + 1
            continue
        probes = (rng.zipf(1.5, size=(3, 2)) % 20).astype(np.int64)
        r0, p0 = ref_pm.h2d_bytes_total(), pt_pm.h2d_bytes_total()
        m0 = ref.misses
        if op < 0.5:
            # a one-pass resolve wider than the evictable slots is what
            # plan_passes exists for (the reference would evict a bucket
            # it is about to return)
            if len(np.unique(probes)) > slots - ref.pin_slots:
                continue
            a = ref.resolve(probes, dict(gens), _fetch)
            b = port.resolve(probes, dict(gens), _fetch)
            np.testing.assert_array_equal(a, b)
            moved = ref_pm.h2d_bytes_total() - r0
            assert moved == ref_pm.tier_h2d_bytes(ref.misses - m0, CAP, D)
        elif op < 0.8:
            groups_r = ref.plan_passes(probes)
            assert groups_r == port.plan_passes(probes)
            for g in groups_r:
                a, _ = ref.acquire(probes, dict(gens), _fetch, restrict=g)
                b, _ = port.acquire(probes, dict(gens), _fetch, restrict=g)
                port.release()
                np.testing.assert_array_equal(a, b)
        elif op < 0.97:
            want = rng.integers(0, 20, 3).tolist()
            assert ref.prefetch(want, dict(gens), _fetch) == \
                port.prefetch(want, dict(gens), _fetch)
        else:
            ref.invalidate()
            port.invalidate()
        assert ref_pm.h2d_bytes_total() - r0 == pt_pm.h2d_bytes_total() - p0
        _same_cache(ref, port)


def test_cache_cold_miss_costs_model_bytes_and_warm_set_zero():
    port = pt_cache.HbmBucketCache(D, 8, CAP, pin_slots=0, device="cpu")
    probes = np.array([[0, 1], [1, 2], [3, 0]])
    p0 = pt_pm.h2d_bytes_total()
    port.resolve(probes, {}, _fetch)
    assert pt_pm.h2d_bytes_total() - p0 == pt_pm.tier_h2d_bytes(4, CAP, D)
    assert port.h2d_bytes == pt_pm.tier_h2d_bytes(4, CAP, D)
    p1 = pt_pm.h2d_bytes_total()
    for _ in range(3):
        port.acquire(probes, {}, _fetch)
        port.release()
    assert pt_pm.h2d_bytes_total() == p1  # warmed: zero H2D bytes
    assert port.stats()["hits"] == 12


def test_prefetch_never_writes_a_leased_slot():
    """Search A holds buckets 0 and 1 between its acquire and its scan;
    search B resolves 2 and 3 meanwhile. The worker's prefetch of bucket
    5 would evict 0 (the reference's LRU victim, outside B's protected
    set) but must wait for A's release; afterwards it evicts."""
    port = pt_cache.HbmBucketCache(D, 4, CAP, pin_slots=0, device="cpu")
    held, go = threading.Event(), threading.Event()
    seen = {}

    def search_a():
        slots, pools = port.acquire(np.array([[0, 1]]), {}, _fetch)
        mine = slots.ravel().tolist()
        seen["before"] = [p[mine].clone() for p in pools]
        held.set()
        go.wait(timeout=10)
        seen["after"] = [p[mine].clone() for p in pools]
        port.release()

    t = threading.Thread(target=search_a)
    t.start()
    assert held.wait(timeout=10)
    port.resolve(np.array([[2, 3]]), {}, _fetch)  # search B
    assert port.prefetch([5], {}, _fetch) == 0  # only leased victims
    go.set()
    t.join(timeout=10)
    for a, b in zip(seen["before"], seen["after"]):
        assert bool((a == b).all())
    assert port.prefetch([5], {}, _fetch) == 1
    assert 0 not in port._lru and 5 in port._lru


def test_concurrent_demand_waits_for_the_lease():
    """A second search that needs the first one's slots waits until the
    first releases them; the first scans unchanged pools meanwhile."""
    port = pt_cache.HbmBucketCache(D, 2, CAP, pin_slots=0, device="cpu")
    first = np.array([[0, 1]])
    slots, pools = port.acquire(first, {}, _fetch)
    snap = [p.clone() for p in pools]
    got = []
    t = threading.Thread(target=lambda: got.append(
        port.acquire(np.array([[2, 3]]), {}, _fetch)[0]))
    t.start()
    time.sleep(0.2)
    assert t.is_alive() and not got  # waiting on the first lease
    for a, b in zip(snap, pools):
        assert bool((a == b).all())  # nothing was written under the lease
    port.release()
    t.join(timeout=10)
    assert got and sorted(got[0].ravel().tolist()) == [0, 1]
    ids = port.pools()[3].numpy()
    assert set(ids[ids >= 0] // 100) == {2, 3}
