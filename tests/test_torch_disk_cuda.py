"""The disk tier on the card: `cached_bucket_scan` through the probe-dots
kernel against its plain per-probe loop, DISKANN in one pass and in many
(cache_mb 0, a one-slot cache) against the same index on the CPU,
concurrent searches with the prefetch worker paging slabs in, and a
bf16 disk store's rows reaching the card's rerank unchanged.

Ids must be equal except where an f32 score tie explains a swap (the
kernel sums the same exact products in another order); scores agree to
(rtol, atol) = (1e-5, 1e-4). The kernel has no CPU mode, so these tests
are marked `cuda` and skip where no card is visible. This file imports
no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_disk_cuda.py -m cuda --noconftest
"""

import threading

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-4
D, N = 32, 3000


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")


def _tied_ids_equal(s_a, i_a, s_b, i_b):
    """Equal ids row by row, except a swap between f32-tied scores."""
    np.testing.assert_allclose(s_a, s_b, rtol=RTOL, atol=ATOL)
    for sa, ia, sb, ib in zip(s_a, i_a, s_b, i_b):
        for j in np.nonzero(ia != ib)[0]:
            tied = np.abs(sb - sa[j]) <= ATOL + RTOL * np.abs(sa[j])
            assert ia[j] in ib[tied] or not np.isfinite(sa[j]), (j, ia, ib)


def _pools(seed, slots=40, cap=256, d=D, n_docs=6000):
    rng = np.random.default_rng(seed)
    p8 = np.zeros((slots, cap, d), np.int8)
    sc = np.zeros((slots, cap), np.float32)
    sq = np.zeros((slots, cap), np.float32)
    ids = np.full((slots, cap), -1, np.int32)
    docs = rng.permutation(n_docs)
    at = 0
    for s in range(slots):
        n = 0 if s % 7 == 3 else int(rng.integers(1, cap + 1))
        p8[s, :n] = rng.integers(-127, 128, (n, d))
        sc[s, :n] = rng.uniform(0.01, 0.05, n)
        approx = p8[s, :n].astype(np.float32) * sc[s, :n, None]
        sq[s, :n] = (approx * approx).sum(1)
        ids[s, :n] = docs[at:at + n]
        at += n
    return p8, sc, sq, ids, rng.random(n_docs) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
@pytest.mark.parametrize("r", [16, 300])
def test_cached_bucket_scan_kernel_matches_plain(metric, r):
    _need_cuda()
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.ops import ivf as ivf_ops
    from vearch_tpu_torch.ops import probe_dots as pd

    p8, sc, sq, ids, valid = _pools(3)
    rng = np.random.default_rng(4)
    b, nprobe = 70, 12
    q = rng.standard_normal((b, D)).astype(np.float32)
    slots = rng.integers(0, p8.shape[0], (b, nprobe)).astype(np.int32)
    slots[::5, -3:] = -1  # deferred probes of a multi-pass resolve
    lens = (ids >= 0).sum(1).astype(np.int32)
    args = [torch.from_numpy(x) for x in (q, p8, sc, sq, ids, slots, valid)]
    s_cpu, i_cpu = ivf_ops.cached_bucket_scan(*args, r, MetricType(metric))
    before = pd.ivf_probe_dots.launches
    s_gpu, i_gpu = ivf_ops.cached_bucket_scan(
        *[a.cuda() for a in args], r, MetricType(metric),
        pool_lens=torch.from_numpy(lens).cuda())
    assert pd.ivf_probe_dots.launches == before + 1
    _tied_ids_equal(s_gpu.cpu().numpy(), i_gpu.cpu().numpy(),
                    s_cpu.numpy(), i_cpu.numpy())


def _docs(seed=31, n=N):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 30, n)]
            + 0.6 * rng.standard_normal((n, D))).astype(np.float32)
    queries = vecs[rng.choice(n, 64, replace=False)] + 0.05
    return vecs, queries.astype(np.float32)


def _engine(device, data_dir, index_type="DISKANN", extra=None):
    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema,
    )

    params = dict({"ncentroids": 12, "nprobe": 5, "train_iters": 3,
                   "training_threshold": 10 ** 9, "nsubvector": 8},
                  **(extra or {}))
    schema = TableSchema("t", [FieldSchema(
        "emb", DataType.VECTOR, dimension=D,
        index=IndexParams(index_type, MetricType.L2, params))])
    return Engine(schema, device=device, data_dir=str(data_dir))


def _pair(tmp_path, index_type="DISKANN", extra=None):
    """A CPU and a CUDA engine over the same rows; the CUDA one holds the
    CPU one's trained state."""
    vecs, queries = _docs()
    cpu = _engine("cpu", tmp_path / "cpu", index_type, extra)
    gpu = _engine("cuda", tmp_path / "gpu", index_type, extra)
    for e in (cpu, gpu):
        e.upsert([{"_id": f"d{i}", "emb": vecs[i]} for i in range(N)])
    cpu.build_index()
    gpu.indexes["emb"].load_state(cpu.indexes["emb"].dump_state())
    return cpu, gpu, queries


def _raw(engine, queries, params=None):
    from vearch_tpu_torch.engine.engine import SearchRequest

    res = engine.search(SearchRequest(
        vectors={"emb": queries}, k=10, include_fields=[], raw_results=True,
        index_params=params or {}))
    ids = np.array([[int(k[1:]) for k in row] for row in res.keys])
    return (np.asarray(res.scores, dtype=np.float32).reshape(ids.shape),
            ids)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_mb", [512, 0])
def test_diskann_on_cuda_matches_cpu(tmp_path, cache_mb):
    _need_cuda()
    from vearch_tpu_torch.ops import perf_model
    from vearch_tpu_torch.ops import probe_dots as pd

    cpu, gpu, queries = _pair(tmp_path, extra={"cache_mb": cache_mb,
                                               "prefetch": False})
    for params in ({}, {"rerank": 40}):
        want = _raw(cpu, queries, params)
        pd.ivf_probe_dots.launches = 0
        got = _raw(gpu, queries, params)
        assert pd.ivf_probe_dots.launches > 0
        _tied_ids_equal(got[0], got[1], want[0], want[1])
    hbm = gpu.tiering_info()["fields"]["emb"]["hbm"]
    if cache_mb == 0:
        assert hbm["slots"] == 1  # every probed bucket was its own pass
    else:  # the second search found every slab resident
        assert hbm["misses"] <= 12 and hbm["hits"] > 0
    assert hbm["h2d_bytes"] == perf_model.tier_h2d_bytes(
        hbm["misses"], hbm["cap"], D)
    cpu.close()
    gpu.close()


@pytest.mark.cuda
def test_diskann_concurrent_searches_with_prefetch_on_cuda(tmp_path):
    """Four threads search a one-slot cache at once with the prefetch
    worker on: each result equals the same search run alone."""
    _need_cuda()
    vecs, queries = _docs()
    gpu = _engine("cuda", tmp_path / "g", extra={"cache_mb": 0})
    gpu.upsert([{"_id": f"d{i}", "emb": vecs[i]} for i in range(N)])
    gpu.build_index()
    idx = gpu.indexes["emb"]
    want = [idx.search(queries[i::4], 10, None) for i in range(4)]
    got: dict[int, list] = {}

    def run(i):
        got[i] = [idx.search(queries[i::4], 10, None) for _ in range(3)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i in range(4):
        for s, ids in got[i]:
            np.testing.assert_array_equal(ids, want[i][1])
            np.testing.assert_array_equal(s, want[i][0])
    gpu.close()


@pytest.mark.cuda
@pytest.mark.parametrize("index_type", ["IVFPQ", "DISKANN"])
def test_bf16_disk_store_upload_path_on_cuda(tmp_path, index_type):
    """A bf16 disk store: its rows widen to f32 on the host and reach the
    card's rerank as the CPU engine's do."""
    _need_cuda()
    extra = {"store_type": "Disk", "store_dtype": "bfloat16",
             "prefetch": False}
    cpu, gpu, queries = _pair(tmp_path, index_type, extra)
    store = gpu.vector_stores["emb"]
    rows = store.get_rows(np.arange(0, N, 97))
    vecs, _ = _docs()
    np.testing.assert_array_equal(
        rows, torch.from_numpy(vecs[::97]).bfloat16().float().numpy())
    want = _raw(cpu, queries, {"rerank": 64})
    got = _raw(gpu, queries, {"rerank": 64})
    _tied_ids_equal(got[0], got[1], want[0], want[1])
    cpu.close()
    gpu.close()
