"""The port's disk tier against vearch_tpu's on the CPU.

- Scan and rerank: `cached_bucket_scan` (the per-probe loop) and
  `cached_bucket_scan_dots` (the kernel's route, through the probe
  dots' plain version) and
  `exact_rerank_gathered` against the reference's on the same pools and
  rows: ids equal, scores within (rtol, atol) = (1e-5, 1e-4) (the dots
  are the same exact products summed in another order). Covers slot -1,
  empty slabs, masked rows, L2, IP and cosine.
- Store files: `DiskRawVectorStore` writes `raw.f32` and `meta.json`
  byte-equal to the reference's for f32 and bf16 rows, and each package
  opens the other's directory and reads the same rows.
- DISKANN: the reference trains, the port loads its centroids through
  `convert.index_state_from_reference`; both write byte-equal scan-tier
  files and search with equal ids, in one pass and in many (cache_mb 0:
  a one-slot cache), with equal tier counters when prefetch is off.
- Recovery: an in-place `Engine.dump` / `Engine.open` round trip (the
  bucket lists rebuilt from assign.i32, only the tail absorbed), and
  each package opening the other's data_dir.
- The other index types on a disk store (IVFPQ, IVFRABITQ, FLAT, HNSW
  "auto"): ids equal to the reference's, and the disk branches taken.
  The HNSW case first makes sure the reference's native graph loaded
  whole in this worker (`ref_hnsw_native`).
"""

import fcntl
import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from vearch_tpu.engine import disk_vector as ref_dv  # noqa: E402
from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import disk_vector as pt_dv  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.ops import binary_scan as pt_bs  # noqa: E402
from vearch_tpu_torch.ops import ivf as pt_ivf  # noqa: E402
from vearch_tpu_torch.ops import perf_model as pt_pm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4
D, N = 32, 3000


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- scan and rerank ---------------------------------------------------------


def _pools(seed, slots=6, cap=32, d=16, n_docs=400):
    """Slab pools as the cache packs them: rows at the front of each
    slab, -1 ids past them; slab 2 empty, slab 4 full."""
    rng = np.random.default_rng(seed)
    p8 = np.zeros((slots, cap, d), np.int8)
    sc = np.zeros((slots, cap), np.float32)
    sq = np.zeros((slots, cap), np.float32)
    ids = np.full((slots, cap), -1, np.int32)
    docs = rng.permutation(n_docs)
    at = 0
    for s in range(slots):
        n = 0 if s == 2 else cap if s == 4 else int(rng.integers(1, cap))
        p8[s, :n] = rng.integers(-127, 128, (n, d))
        sc[s, :n] = rng.uniform(0.01, 0.05, n)
        approx = p8[s, :n].astype(np.float32) * sc[s, :n, None]
        sq[s, :n] = (approx * approx).sum(1)
        ids[s, :n] = docs[at:at + n]
        at += n
    valid = rng.random(n_docs) > 0.1
    return p8, sc, sq, ids, valid


SCAN_CASES = [  # (seed, r, metric, probe slots with -1 for deferred)
    (0, 8, "L2", [[0, 1, 3, -1], [4, 5, 2, 0], [-1, -1, 1, 4]]),
    (1, 200, "L2", [[4, 0, 1, 5], [2, 2, -1, 3], [5, 4, 3, 1]]),
    (2, 16, "InnerProduct", [[1, 3, 5, 0], [-1, 4, 2, 1], [0, 0, 0, 0]]),
    (3, 40, "InnerProduct", [[-1, -1, -1, -1], [3, 1, 4, 2], [5, 0, 2, 1]]),
]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("case", range(len(SCAN_CASES)))
def test_cached_bucket_scan_matches_reference(case, kernel):
    seed, r, metric, slots = SCAN_CASES[case]
    p8, sc, sq, ids, valid = _pools(seed)
    rng = np.random.default_rng(seed + 10)
    q = rng.standard_normal((3, p8.shape[2])).astype(np.float32)
    slots = np.asarray(slots, np.int32)
    rs, ri = ref_ivf.cached_bucket_scan(
        jnp.asarray(q), jnp.asarray(p8), jnp.asarray(sc), jnp.asarray(sq),
        jnp.asarray(ids), jnp.asarray(slots), jnp.asarray(valid), r,
        rt.MetricType(metric))
    lens = _t((ids >= 0).sum(1).astype(np.int32))
    # the kernel's route runs here through the probe dots' plain version
    scan = pt_ivf.cached_bucket_scan_dots if kernel \
        else pt_ivf.cached_bucket_scan
    ps, pi = scan(_t(q), _t(p8), _t(sc), _t(sq), _t(ids), _t(slots),
                  _t(valid), r, pt.MetricType(metric), pool_lens=lens)
    assert ps.shape == (3, r) and pi.dtype == torch.int32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=RTOL,
                               atol=ATOL)
    # no masked row, deferred slot or padding comes back
    got = pi.numpy()
    live = {int(x) for s in slots.ravel() if s >= 0 for x in ids[s]
            if x >= 0 and valid[x]}
    assert {int(x) for x in got.ravel() if x >= 0} <= live


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_exact_rerank_gathered_matches_reference(metric):
    rng = np.random.default_rng(7)
    b, r, d = 4, 24, 16
    q = rng.standard_normal((b, d)).astype(np.float32)
    cand = rng.integers(0, 500, (b, r)).astype(np.int32)
    cand[:, -5:] = -1
    vecs = rng.standard_normal((b, r, d)).astype(np.float32)
    for k in (5, 30):
        rs, ri = ref_ivf.exact_rerank_gathered(
            jnp.asarray(q), jnp.asarray(cand), jnp.asarray(vecs), k,
            rt.MetricType(metric))
        ps, pi = pt_ivf.exact_rerank_gathered(
            _t(q), _t(cand), _t(vecs), k, pt.MetricType(metric))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=RTOL,
                                   atol=ATOL)


def test_tier_phase_ledger_records_the_fetch(tmp_path):
    """A cold DISKANN search notes its slab fetch (and its prefetch
    scheduling) in the tier-phase ledger; a warm one no fetch."""
    docs, queries = _docs(n=1200)
    port = Engine(_schema(pt, "DISKANN"), device="cpu",
                  data_dir=str(tmp_path / "l"))
    port.upsert(docs)
    port.build_index()
    idx = port.indexes["emb"]
    for expect_fetch in (True, False):
        ledger: list = []
        pt_ivf.set_tier_phase_ledger(ledger)
        try:
            idx.search(queries, 10, None)
        finally:
            pt_ivf.set_tier_phase_ledger(None)
        names = [name for name, t0, t1 in ledger if t1 >= t0]
        assert len(names) == len(ledger)
        assert ("fetch" in names) == expect_fetch
        assert "prefetch" in names
    port.close()


# -- store files ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disk_store_files_byte_equal_and_cross_open(tmp_path, dtype):
    rng = np.random.default_rng(11)
    rows = (rng.standard_normal((700, 24)) * 3).astype(np.float32)
    rows[5, :4] = [1e-40, -0.0, 65504.5, 1.0 + 2 ** -8]  # rounding edges
    dirs = {k: str(tmp_path / k) for k in ("ref", "port")}
    ref = ref_dv.DiskRawVectorStore(24, dirs["ref"], init_capacity=256,
                                    store_dtype=dtype)
    port = pt_dv.DiskRawVectorStore(24, dirs["port"], init_capacity=256,
                                    store_dtype=dtype, device="cpu")
    for lo in range(0, 700, 300):
        assert ref.add(rows[lo:lo + 300]) == port.add(rows[lo:lo + 300])
    ref.flush_disk()
    port.flush_disk(n=700)
    for name in ("raw.f32", "meta.json"):
        with open(os.path.join(dirs["ref"], name), "rb") as a, \
                open(os.path.join(dirs["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(dirs["port"], "meta.json")) as f:
        assert json.load(f) == {"n": 700, "dimension": 24, "dtype": dtype}
    ids = rng.integers(0, 700, 50)
    want = np.asarray(ref.get_rows(ids), np.float32)
    np.testing.assert_array_equal(port.get_rows(ids), want)
    np.testing.assert_array_equal(
        np.asarray(port.host_view(), np.float32),
        np.asarray(ref.host_view(), np.float32))
    # each package opens the other's directory
    p2 = pt_dv.DiskRawVectorStore(24, dirs["ref"], store_dtype=dtype,
                                  device="cpu")
    r2 = ref_dv.DiskRawVectorStore(24, dirs["port"], store_dtype=dtype)
    assert p2.count == r2.count == 700
    np.testing.assert_array_equal(p2.get_rows(ids), want)
    np.testing.assert_array_equal(np.asarray(r2.get_rows(ids), np.float32),
                                  want)
    with pytest.raises(RuntimeError, match="cannot be mirrored"):
        port.device_buffer()
    with pytest.raises(ValueError, match="written as"):
        pt_dv.DiskRawVectorStore(
            24, dirs["ref"], device="cpu",
            store_dtype="float32" if dtype == "bfloat16" else "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disk_store_load_paths_match_reference(tmp_path, dtype):
    rng = np.random.default_rng(12)
    rows = rng.standard_normal((500, 8)).astype(np.float32)
    np.save(tmp_path / "a.npy", rows[:200])
    np.save(tmp_path / "b.npy", rows[200:])
    stores = {}
    for name, mod, kw in (("ref", ref_dv, {}), ("port", pt_dv,
                                                {"device": "cpu"})):
        s = mod.DiskRawVectorStore(8, str(tmp_path / name),
                                   init_capacity=64, store_dtype=dtype, **kw)
        s.add(rows[:50])
        s.flush_disk()
        s.add(rows[50:90])
        s.load(str(tmp_path / "missing.npy"))  # in place: roll back
        assert s.count == 50
        s.load_parts([str(tmp_path / "a.npy"), str(tmp_path / "b.npy")])
        assert s.count == 500
        s.dump(str(tmp_path / f"{name}_dump.npy"))
        stores[name] = s
    with open(tmp_path / "ref" / "raw.f32", "rb") as a, \
            open(tmp_path / "port" / "raw.f32", "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(np.load(tmp_path / "ref_dump.npy"),
                                  np.load(tmp_path / "port_dump.npy"))


# -- engines -------------------------------------------------------------------


def _schema(t, index_type, metric="L2", extra=None):
    base = {"ncentroids": 12, "nprobe": 5, "train_iters": 3,
            "training_threshold": 10 ** 9, "mesh_serving": "off",
            "nsubvector": 8}
    return t.TableSchema("t", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams(index_type, t.MetricType(metric),
                                          dict(base, **(extra or {})))),
        t.FieldSchema("tag", t.DataType.INT),
    ])


def _docs(seed=31, n=N):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 30, n)]
            + 0.6 * rng.standard_normal((n, D))).astype(np.float32)
    docs = [{"_id": f"d{i:05d}", "emb": vecs[i], "tag": int(i % 4)}
            for i in range(n)]
    return docs, (vecs[rng.choice(n, 8, replace=False)] + 0.05
                  ).astype(np.float32)


def _pair(tmp_path, index_type, metric="L2", extra=None, docs=None):
    """A reference and a port engine, each on its own data_dir; the port
    holds the reference's trained state."""
    if docs is None:
        docs, _ = _docs()
    ref = RefEngine(_schema(rt, index_type, metric, extra),
                    data_dir=str(tmp_path / "ref"))
    ref.micro_batch = False
    port = Engine(_schema(pt, index_type, metric, extra), device="cpu",
                  data_dir=str(tmp_path / "port"))
    for lo in range(0, len(docs), 1000):
        ref.upsert(docs[lo:lo + 1000])
        port.upsert(docs[lo:lo + 1000])
    ref.build_index()
    port.indexes["emb"].load_state(
        index_state_from_reference(ref.indexes["emb"].dump_state()))
    return ref, port


def _tied(a, b):
    return abs(a - b) <= TIE_ATOL + TIE_RTOL * abs(b)


def _same(ref_res, port_res):
    """Keys equal in order, except where a score tie explains a swap;
    scores allclose position by position."""
    rk = [[it.key for it in r.items] for r in ref_res]
    rs = [[it.score for it in r.items] for r in ref_res]
    pk = [[it.key for it in r.items] for r in port_res]
    ps = [[it.score for it in r.items] for r in port_res]
    assert [len(r) for r in pk] == [len(r) for r in rk]
    for rkeys, rsc, pkeys, psc in zip(rk, rs, pk, ps):
        np.testing.assert_allclose(psc, rsc, rtol=RTOL, atol=1e-3)
        where = {k: j for j, k in enumerate(rkeys)}
        for i, (a, b) in enumerate(zip(rkeys, pkeys)):
            if a != b:
                j = where.get(b)
                assert _tied(psc[i], rsc[i]), (a, b)
                assert (_tied(rsc[j], rsc[i]) if j is not None
                        else _tied(psc[i], rsc[-1])), (a, b)
    return pk


def _search(engine, cls, queries, params=None, **kw):
    return engine.search(cls(vectors={"emb": queries}, k=10,
                             index_params=params or {}, **kw))


def _close(*engines):
    for e in engines:
        e.close()


def _files_equal(a_dir, b_dir, names):
    for name in names:
        with open(os.path.join(a_dir, name), "rb") as a, \
                open(os.path.join(b_dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("index_type,metric,extra", [
    ("DISKANN", "L2", {"prefetch": False}),
    ("DISKANN_STATIC", "InnerProduct", {"prefetch": False}),
    ("DISKANN", "Cosine", {"prefetch": False, "cache_mb": 0}),
    ("DISKANN", "L2", {"prefetch": False, "cache_mb": 0, "nprobe": 12}),
    ("DISKANN", "L2", {"cache_mb": 0}),
])
def test_diskann_matches_reference(tmp_path, index_type, metric, extra):
    """Single-pass (the default 512 MB budget) and multi-pass (cache_mb 0:
    one slot, so every probed bucket is its own pass) searches."""
    ref, port = _pair(tmp_path, index_type, metric, extra)
    _, queries = _docs()
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    assert type(pi).__name__ == "DiskANNIndex"
    _files_equal(ri.directory, pi.directory,
                 ("approx8.i8", "meta2.f32", "assign.i32"))
    assert pi.cell_populations() == ri.cell_populations()
    for params in ({}, {"rerank": 40}, {"nprobe": 3}):
        h0 = pt_pm.h2d_bytes_total()
        _same(_search(ref, RefRequest, queries, params),
              _search(port, SearchRequest, queries, params))
        hbm_r = ref.tiering_info()["fields"]["emb"]["hbm"]
        hbm_p = port.tiering_info()["fields"]["emb"]["hbm"]
        if not pi.prefetch_enabled:
            assert hbm_p == hbm_r
        assert pt_pm.h2d_bytes_total() - h0 <= hbm_p["h2d_bytes"]
    if extra.get("cache_mb") == 0:
        assert pi._cache.slots == 1
    tp = port.tiering_info()["fields"]["emb"]
    assert set(tp) == {"kind", "hbm", "ram", "prefetch", "row_cache"}
    assert tp["kind"] == "diskann"
    _close(ref, port)


def test_diskann_warm_search_moves_no_bytes(tmp_path):
    ref, port = _pair(tmp_path, "DISKANN", extra={"prefetch": False})
    _, queries = _docs()
    _search(port, SearchRequest, queries)  # cold: uploads the probed set
    cold = port.tiering_info()["fields"]["emb"]["hbm"]
    assert cold["h2d_bytes"] == pt_pm.tier_h2d_bytes(
        cold["misses"], cold["cap"], D)
    h0 = pt_pm.h2d_bytes_total()
    _search(port, SearchRequest, queries)
    assert pt_pm.h2d_bytes_total() == h0
    warm = port.tiering_info()["fields"]["emb"]["hbm"]
    assert warm["misses"] == cold["misses"] and warm["hits"] > cold["hits"]
    _close(ref, port)


def test_diskann_deletes_filters_and_realtime_rows(tmp_path):
    docs, queries = _docs()
    ref, port = _pair(tmp_path, "DISKANN", docs=docs[:2500])
    for e in (ref, port):  # realtime rows: absorbed by the next search
        e.upsert(docs[2500:])
    gone = [f"d{i:05d}" for i in range(0, N, 9)]
    assert ref.delete(gone) == port.delete(gone)
    keys = _same(_search(ref, RefRequest, queries),
                 _search(port, SearchRequest, queries))
    assert not set(gone) & {k for row in keys for k in row}
    flt = {"operator": "AND", "conditions": [
        {"field": "tag", "operator": "IN", "value": [1, 2]}]}
    _same(_search(ref, RefRequest, queries, filters=flt),
          _search(port, SearchRequest, queries, filters=flt))
    assert port.indexes["emb"].indexed_count == N
    _close(ref, port)


def test_diskann_recovery_in_place_and_across_packages(tmp_path):
    docs, queries = _docs()
    ref, port = _pair(tmp_path, "DISKANN", docs=docs[:2600])
    before = _same(_search(ref, RefRequest, queries),
                   _search(port, SearchRequest, queries))
    # rows past the index's durable count: the reopen absorbs only them
    for e in (ref, port):
        e.upsert(docs[2600:])
        e.dump()
        e.close()
    reopened = Engine.open(str(tmp_path / "port"), device="cpu")
    pi = reopened.indexes["emb"]
    assert pi.indexed_count == N and pi.trained
    fresh_ref = RefEngine.open(str(tmp_path / "ref"))
    fresh_ref.micro_batch = False
    after = _same(_search(fresh_ref, RefRequest, queries),
                  _search(reopened, SearchRequest, queries))
    assert reopened.indexes["emb"].cell_populations() == \
        fresh_ref.indexes["emb"].cell_populations()
    # the vector store wrote no segment: its mmap is the payload
    segs = os.listdir(tmp_path / "port" / "segments")
    assert segs and not any(
        f.startswith("vectors_")
        for s in segs for f in os.listdir(tmp_path / "port" / "segments" / s))
    assert len(after) == len(before)
    # each package opens the other's data_dir
    cross_p = Engine.open(str(tmp_path / "ref"), device="cpu")
    cross_r = RefEngine.open(str(tmp_path / "port"))
    cross_r.micro_batch = False
    _same(_search(cross_r, RefRequest, queries),
          _search(cross_p, SearchRequest, queries))
    _same(_search(fresh_ref, RefRequest, queries),
          _search(cross_p, SearchRequest, queries))
    _close(reopened, fresh_ref, cross_p, cross_r)


def test_concurrent_searches_with_prefetch_equal_serial(tmp_path):
    """Four threads search a one-slot cache at once, with the prefetch
    worker paging predicted slabs in: every slab write waits for the
    lease of the search that resolved that slot, so each result equals
    the same search run alone."""
    import threading

    docs, queries = _docs()
    port = Engine(_schema(pt, "DISKANN", extra={"cache_mb": 0}),
                  device="cpu", data_dir=str(tmp_path / "c"))
    port.upsert(docs)
    port.build_index()
    idx = port.indexes["emb"]
    want = [idx.search(queries[i::4], 10, None) for i in range(4)]
    got: dict[int, list] = {}

    def run(i):
        got[i] = [idx.search(queries[i::4], 10, None) for _ in range(3)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i in range(4):
        for s, ids in got[i]:
            np.testing.assert_array_equal(ids, want[i][1])
            np.testing.assert_array_equal(s, want[i][0])
    assert idx.tiering_info()["prefetch"]["submitted"] > 0
    port.close()


def test_in_place_load_rolls_back_to_the_barrier(tmp_path):
    docs, queries = _docs(n=1500)
    port = Engine(_schema(pt, "FLAT", extra={"store_type": "Disk"}),
                  device="cpu", data_dir=str(tmp_path / "p"))
    port.upsert(docs[:1000])
    port.dump()
    port.upsert(docs[1000:])
    assert port.doc_count == 1500
    port.load()
    assert port.doc_count == 1000
    assert port.vector_stores["emb"].count == 1000
    res = _search(port, SearchRequest, queries)
    assert all(int(it.key[1:]) < 1000 for r in res for it in r.items)
    port.close()


# -- the other index types on a disk store ---------------------------------------


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_flat_on_disk_store_matches_reference(tmp_path, metric):
    ref, port = _pair(tmp_path, "FLAT", metric, {"store_type": "Disk"})
    _, queries = _docs()
    keys = _same(_search(ref, RefRequest, queries),
                 _search(port, SearchRequest, queries))
    # exact: the port's own brute force on the same rows agrees
    bf = _search(port, SearchRequest, queries, brute_force=True)
    assert keys == [[it.key for it in r.items] for r in bf]
    _close(ref, port)


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_ivfpq_on_disk_store_matches_reference(tmp_path, store_dtype):
    extra = {"store_type": "Disk", "store_dtype": store_dtype}
    ref, port = _pair(tmp_path, "IVFPQ", "L2", extra)
    _, queries = _docs()
    ledger: list = []
    pt_ivf.set_dispatch_ledger(ledger)
    try:
        for params in ({}, {"rerank": 64}, {"scan_mode": "probe"}):
            _same(_search(ref, RefRequest, queries, params),
                  _search(port, SearchRequest, queries, params))
    finally:
        pt_ivf.set_dispatch_ledger(None)
    # never the fused scan + rerank: the rerank gathers on the host
    assert "fused_scan_rerank" not in ledger
    assert ledger.count("rerank") == 3
    _close(ref, port)


def test_ivfrabitq_on_disk_store_matches_reference(tmp_path):
    ref, port = _pair(tmp_path, "IVFRABITQ", "L2", {"store_type": "Disk"})
    _, queries = _docs()
    before = pt_bs.refine_search_counts()["disk"]
    ledger: list = []
    pt_ivf.set_dispatch_ledger(ledger)
    try:
        for params in ({}, {"r0": 600, "r1": 120}):
            _same(_search(ref, RefRequest, queries, params),
                  _search(port, SearchRequest, queries, params))
    finally:
        pt_ivf.set_dispatch_ledger(None)
    assert ledger == ["binary_refine_scan", "rerank"] * 2
    assert pt_bs.refine_search_counts()["disk"] == before + 2
    _close(ref, port)


def _ref_hnsw_build_done(ref_hnsw) -> bool:
    """Whether the reference's build wrote its source hash, which it
    does only once g++ has finished the library."""
    with open(ref_hnsw._SRC, "rb") as f:
        want = hashlib.sha256(f.read()).hexdigest()
    try:
        with open(ref_hnsw._HASH) as f:
            return f.read().strip() == want
    except OSError:
        return False


@pytest.fixture(scope="module")
def ref_hnsw_native(tmp_path_factory):
    """The reference's native HNSW loader (vearch_tpu/native/
    hnsw_graph.py) links straight onto its final path, so a process
    that loads while another still writes the file gets a half-written
    library, and the loader keeps None for the rest of that process.
    Serialise this build across the test workers with a file lock; where
    this worker's first load failed, wait for the build in flight to
    finish, then load again."""
    from vearch_tpu.native import hnsw_graph as ref_hnsw

    lock = tmp_path_factory.getbasetemp().parent / "ref_hnsw_build.lock"
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not ref_hnsw.available():
                deadline = time.monotonic() + 200  # the loader's g++ limit
                while (os.path.exists(ref_hnsw._SO)
                       and not _ref_hnsw_build_done(ref_hnsw)
                       and time.monotonic() < deadline):
                    time.sleep(0.5)
                ref_hnsw._tried = False
                ref_hnsw.available()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_hnsw_auto_on_disk_store_is_the_graph(tmp_path, metric,
                                              ref_hnsw_native):
    extra = {"store_type": "Disk", "nlinks": 12, "efConstruction": 64,
             "efSearch": 48}
    docs, queries = _docs(n=1500)
    ref, port = _pair(tmp_path, "HNSW", metric, extra, docs=docs)
    assert ref.indexes["emb"].use_graph and port.indexes["emb"].use_graph
    assert port.indexes["emb"]._graph.count == 1500
    _same(_search(ref, RefRequest, queries),
          _search(port, SearchRequest, queries))
    _close(ref, port)


def test_memory_usage_counts_a_disk_store_as_page_cache(tmp_path):
    docs, _ = _docs(n=500)
    eng = Engine(_schema(pt, "FLAT", extra={"store_type": "Disk"}),
                 device="cpu", data_dir=str(tmp_path / "m"))
    mem = Engine(_schema(pt, "FLAT"), device="cpu")
    for e in (eng, mem):
        e.upsert(docs)
    assert eng.memory_usage_bytes() == 0
    assert mem.memory_usage_bytes() == 500 * D * 4
    assert mem.tiering_info() is None
    info = eng.tiering_info()["fields"]["emb"]
    assert info["kind"] == "disk_store" and "row_cache" in info
    _close(eng, mem)
