"""The engine's new surface on the card:

- requests that the batch scheduler co-batches on its own thread return
  bit-identical results to the same requests served one at a time
  through `_search_direct`, and the block-max kernel launches from that
  thread;
- a filtered search (scalar-index masks, uploaded and cached on the
  device) returns equal ids on cuda and on the CPU, in the full scan
  (block-max kernel) and the probe regime (probe-dots kernel), ties
  aside; 8192 rows, so every block is selected and the kernel's one-ulp
  maxima cannot change the candidates;
- a dump written on cuda opens on the CPU and back on cuda with equal
  ids.

The kernels have no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX:

    python -m pytest tests/test_torch_engine_cuda.py -m cuda --noconftest
"""

import threading

import numpy as np
import pytest
import torch

D, N = 32, 8192
FILTER = {"operator": "AND", "conditions": [
    {"field": "tag", "operator": "=", "value": "t3"},
    {"field": "cat", "operator": "<", "value": 40}]}
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _schema():
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, ScalarIndexType,
        TableSchema)

    return TableSchema("c", [
        FieldSchema("emb", DataType.VECTOR, dimension=D,
                    index=IndexParams("IVFPQ", MetricType.L2, {
                        "ncentroids": 32, "nsubvector": 8, "train_iters": 3,
                        "nprobe": 8, "training_threshold": 10 ** 9,
                        "store_dtype": "bfloat16"})),
        FieldSchema("cat", DataType.INT,
                    scalar_index=ScalarIndexType.INVERTED),
        FieldSchema("tag", DataType.STRING,
                    scalar_index=ScalarIndexType.BITMAP),
    ], composite_indexes=[["tag", "cat"]])


def _docs(seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, D)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 64, N)]
            + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    docs = [{"_id": f"d{i}", "emb": vecs[i],
             "cat": int(rng.integers(0, 100)),
             "tag": f"t{int(rng.integers(0, 8))}"} for i in range(N)]
    queries = vecs[rng.choice(N, 128, replace=False)] + 0.05
    return docs, queries.astype(np.float32)


def _engine(device, docs):
    from vearch_tpu_torch.engine.engine import Engine

    eng = Engine(_schema(), device=device)
    for lo in range(0, N, 4096):
        eng.upsert(docs[lo:lo + 4096])
    eng.delete([f"d{i}" for i in range(0, N, 50)])
    return eng


def _request(queries, params, **kw):
    from vearch_tpu_torch.engine.engine import SearchRequest

    return SearchRequest(vectors={"emb": queries}, k=10, include_fields=[],
                         index_params=params, **kw)


def _tied(a, b):
    return abs(a - b) <= TIE_ATOL + TIE_RTOL * abs(b)


def _same(want_res, got_res):
    """Keys equal in order except where a score tie explains a swap."""
    for w, g in zip(want_res, got_res):
        wk = [it.key for it in w.items]
        gk = [it.key for it in g.items]
        ws = [it.score for it in w.items]
        gs = [it.score for it in g.items]
        assert len(wk) == len(gk)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-3)
        for i, (a, b) in enumerate(zip(wk, gk)):
            if a != b:
                assert _tied(gs[i], ws[i]), (a, b)


@pytest.mark.cuda
def test_scheduled_requests_bit_identical_to_direct_on_cuda():
    _need_cuda()
    from vearch_tpu_torch.ops import blockmax_scan as bms

    docs, queries = _docs()
    eng = _engine("cuda", docs)
    eng.build_index()
    eng.warmup([64, 256])
    rng = np.random.default_rng(4)
    reqs = [_request(queries[rng.choice(128, 32, replace=False)],
                     {"rerank": 128, "topk_mode": "blockmax"},
                     raw_results=False) for _ in range(8)]
    direct = [eng._search_direct(r) for r in reqs]
    out, errs = [None] * 8, []
    gate = threading.Barrier(8)
    bms.int8_blockmax_stage1.launches = 0

    def worker(i):
        try:
            gate.wait()
            out[i] = eng.search(reqs[i])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert bms.int8_blockmax_stage1.launches > 0
    for got, want in zip(out, direct):
        assert [[(it.key, it.score) for it in r.items] for r in got] == \
            [[(it.key, it.score) for it in r.items] for r in want]
    assert eng._microbatcher.stats()["dispatches"] >= 1
    eng.close()
    assert not any(t.name == "vearch-batch-scheduler" and t.is_alive()
                   and t._target.__self__.engine is eng
                   for t in threading.enumerate())


@pytest.mark.cuda
def test_filtered_search_equal_on_cuda_and_cpu():
    _need_cuda()
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops import probe_dots as pd

    docs, queries = _docs()
    gpu, cpu = _engine("cuda", docs), _engine("cpu", docs)
    gpu.build_index()
    # the same trained state on both
    cpu.indexes["emb"].load_state(gpu.indexes["emb"].dump_state())
    cpu.build_index()
    for params, counter in (
            ({"rerank": 128, "topk_mode": "blockmax"},
             bms.int8_blockmax_stage1),
            ({"scan_mode": "probe", "nprobe": 8, "rerank": 128},
             pd.ivf_probe_dots)):
        counter.launches = 0
        got = gpu.search(_request(queries, params, filters=FILTER))
        assert counter.launches == 1
        want = cpu.search(_request(queries, params, filters=FILTER))
        _same(want, got)
        for r in got:
            for it in r.items:
                fields = gpu.get([it.key])[0]
                assert fields["tag"] == "t3" and fields["cat"] < 40
    # the filter mask stays on the device: a repeat uploads nothing new
    n = gpu.table.doc_count
    key = (gpu._filter_key(FILTER), gpu.data_version, n)
    mask = gpu._device_filter_cache[key]
    assert mask.device.type == "cuda"
    gpu.search(_request(queries, {"rerank": 128}, filters=FILTER))
    assert gpu._device_filter_cache[key] is mask


@pytest.mark.cuda
def test_dump_on_cuda_opens_on_cpu_and_back(tmp_path):
    _need_cuda()
    from vearch_tpu_torch.engine.engine import Engine

    docs, queries = _docs()
    gpu = _engine("cuda", docs)
    gpu.build_index()
    params = {"rerank": 128, "topk_mode": "blockmax"}
    want = gpu.search(_request(queries, params, filters=FILTER))
    gpu.dump(str(tmp_path / "a"))
    on_cpu = Engine.open(str(tmp_path / "a"), device="cpu")
    assert on_cpu.device.type == "cpu"
    _same(want, on_cpu.search(_request(queries, params, filters=FILTER)))
    on_cpu.dump(str(tmp_path / "b"))
    back = Engine.open(str(tmp_path / "b"))  # the default: cuda
    assert back.device.type == "cuda"
    back.build_index()
    got = back.search(_request(queries, params, filters=FILTER))
    assert [[it.key for it in r.items] for r in got] == \
        [[it.key for it in r.items] for r in want]
    assert back.doc_count == gpu.doc_count
    keys = [f"d{i}" for i in range(0, 400, 7)]
    assert back.get(keys) == gpu.get(keys)
