"""The index family's paths on the card: the binary stage 0 (a bf16 GEMM
with an f32 output there, f32 products on the CPU) against its CPU run,
and which hand kernel each search path launches:

- SCANN's full scan, HNSW's scan mode and IVFRABITQ's `stage0: "off"`
  launch the block-max kernel; IVFRABITQ's three-stage chain does not;
- SCANN's probe regime and IVFPQ with the HNSW coarse quantizer launch
  the probe-dots kernel;
- the binary stage 0 and the three-stage chain do not synchronise with
  the host.

The kernels have no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_family_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

D = 16


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _chain_arrays(n=6000, d=64, b=12, seed=3):
    """Bit planes, int8 mirror and raw rows of clustered data, padded to
    the 512-row capacity, a mask and queries near rows (numpy)."""
    from vearch_tpu_torch.index.int8_mirror import quantize_rows
    from vearch_tpu_torch.ops.binary_scan import pack_sign_rows

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, d)).astype(np.float32) * 2
    rows = (centers[rng.integers(0, 30, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    cap = -(-n // 512) * 512

    def pad(a):
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out

    arrays = [pad(a) for a in (*pack_sign_rows(rows), *quantize_rows(rows))]
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) > 0.1
    q = rows[rng.choice(n, b, replace=False)] + 0.1 * rng.standard_normal(
        (b, d)).astype(np.float32)
    base = pad(rows)
    return [q, *arrays, valid, base, (base * base).sum(1).astype(np.float32)]


def _on(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "blockmax"])
def test_binary_stage0_on_cuda_matches_its_cpu_run(mode):
    _need_cuda()
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.ops import binary_scan as bs

    arrays = _chain_arrays()
    for metric in (MetricType.L2, MetricType.INNER_PRODUCT):
        got = bs.binary_scan_candidates(*_on(arrays[:4], "cuda"),
                                        _on(arrays[7:8], "cuda")[0], 400,
                                        metric, mode)
        want = bs.binary_scan_candidates(*_on(arrays[:4], "cpu"),
                                         _on(arrays[7:8], "cpu")[0], 400,
                                         metric, mode)
        assert torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5,
                                   atol=1e-3)
        got = bs.binary_refine_rerank(*_on(arrays, "cuda"), 512, 128, 10,
                                      metric, metric, mode)
        want = bs.binary_refine_rerank(*_on(arrays, "cpu"), 512, 128, 10,
                                       metric, metric, mode)
        assert torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.cuda
def test_binary_stage0_does_not_synchronise_on_cuda():
    _need_cuda()
    from vearch_tpu_torch.ops import binary_scan as bs

    args = _on(_chain_arrays(), "cuda")
    bs.binary_refine_rerank(*args, 512, 128, 10)  # warm the libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode in ("exact", "blockmax"):
            bs.binary_scan_candidates(*args[:4], args[7], 300, topk_mode=mode)
            bs.binary_refine_rerank(*args, 512, 128, 10, topk_mode=mode)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _engine(index_type, params, n, metric="L2", seed=7):
    """A CUDA engine of n clustered rows, built; and 16 queries."""
    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema)

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, D)).astype(np.float32) * 3
    rows = (centers[rng.integers(0, 64, n)]
            + 0.5 * rng.standard_normal((n, D))).astype(np.float32)
    schema = TableSchema("t", [FieldSchema(
        "emb", DataType.VECTOR, dimension=D,
        index=IndexParams(index_type, MetricType(metric), dict(
            {"ncentroids": 32, "nsubvector": 4, "train_iters": 3,
             "training_threshold": 10 ** 9}, **params)))])
    eng = Engine(schema)
    assert eng.device.type == "cuda"
    for lo in range(0, n, 20000):
        eng.upsert([{"_id": f"d{i}", "emb": rows[i]}
                    for i in range(lo, min(lo + 20000, n))])
    eng.build_index()
    return eng, rows[rng.choice(n, 16, replace=False)] + 0.05


def _launches(eng, queries, params=None):
    """(block-max, probe-dots) launches of one search."""
    from vearch_tpu_torch.engine.engine import SearchRequest
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops import probe_dots as pd

    b0, p0 = bms.int8_blockmax_stage1.launches, pd.ivf_probe_dots.launches
    res = eng.search(SearchRequest(vectors={"emb": queries}, k=10,
                                   index_params=params or {}))
    assert all(len(r.items) == 10 for r in res)
    return (bms.int8_blockmax_stage1.launches - b0,
            pd.ivf_probe_dots.launches - p0)


@pytest.mark.cuda
def test_scann_paths_launch_their_kernels_on_cuda():
    _need_cuda()
    eng, q = _engine("SCANN", {"nprobe": 8}, 20000, "InnerProduct")
    assert _launches(eng, q, {"topk_mode": "blockmax"}) == (1, 0)
    assert _launches(eng, q, {"scan_mode": "probe"}) == (0, 1)


@pytest.mark.cuda
def test_hnsw_scan_mode_launches_the_blockmax_kernel():
    _need_cuda()
    # 70,000 rows: 137 blocks, enough for "auto" to pick the block-max
    # selection at efSearch 64
    eng, q = _engine("HNSW", {"efSearch": 64}, 70000)
    assert eng.indexes["emb"]._graph is None
    assert _launches(eng, q) == (1, 0)


@pytest.mark.cuda
def test_ivfrabitq_paths_launch_as_designed():
    _need_cuda()
    from vearch_tpu_torch.ops import binary_scan as bs

    eng, q = _engine("IVFRABITQ", {}, 20000)
    before = bs.refine_search_counts()["fused"]
    assert _launches(eng, q) == (0, 0)  # the three-stage chain: torch
    assert bs.refine_search_counts()["fused"] == before + 1
    assert _launches(eng, q, {"stage0": "off", "topk_mode": "blockmax"}) \
        == (1, 0)


@pytest.mark.cuda
def test_hnsw_coarse_quantizer_launches_the_probe_kernel():
    _need_cuda()
    eng, q = _engine("IVFPQ", {"quantizer_type": "hnsw", "nprobe": 8,
                               "scan_mode": "probe"}, 20000)
    idx = eng.indexes["emb"]
    assert idx._coarse_graph is not None
    for kernel in ("xla", "pallas"):
        assert _launches(eng, q, {"probe_kernel": kernel}) == (0, 1)
    # the host probes equal the graph's own answer, on the device
    probes = idx._host_probes(q, 8)
    assert probes.device.type == "cuda" and probes.dtype == torch.int32
