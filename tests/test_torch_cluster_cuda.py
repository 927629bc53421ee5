"""The port's cluster on the card: a StandaloneCluster with no device
argument serves its partition servers' engines on cuda, and searches
through the router launch both hand kernels (the block-max kernel on the
full scan, probe dots in the probe regime) with the same ids as a CPU
cluster of the same docs, ties aside.

The kernels have no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX:

    python -m pytest tests/test_torch_cluster_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

D, N = 32, 4096
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4
SPACE = {
    "name": "s", "partition_num": 2, "replica_num": 3,
    "fields": [
        {"name": "emb", "data_type": "vector", "dimension": D,
         "index": {"index_type": "IVFPQ", "metric_type": "L2",
                   "params": {"ncentroids": 32, "nsubvector": 8,
                              "train_iters": 3, "nprobe": 8,
                              "training_threshold": 10 ** 9,
                              "store_dtype": "bfloat16"}}},
        {"name": "cat", "data_type": "integer",
         "scalar_index": "INVERTED"},
    ],
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _docs(seed=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, D)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 64, N)]
            + rng.standard_normal((N, D))).astype(np.float32)
    q = (vecs[rng.choice(N, 64, replace=False)]
         + 0.1 * rng.standard_normal((64, D))).astype(np.float32)
    docs = [{"_id": f"d{i}", "emb": vecs[i], "cat": int(i % 10)}
            for i in range(N)]
    return docs, q


def _serve(ps_kwargs, docs):
    from vearch_tpu_torch.cluster import rpc
    from vearch_tpu_torch.cluster.standalone import StandaloneCluster
    from vearch_tpu_torch.sdk.client import VearchClient

    c = StandaloneCluster(n_ps=3, ps_kwargs=dict(heartbeat_interval=0.3,
                                                 **ps_kwargs))
    c.start()
    cl = VearchClient(c.router_addr)
    cl.create_database("db")
    cl.create_space("db", SPACE)
    for i in range(0, N, 1024):
        cl.upsert("db", "s", docs[i:i + 1024])
    for ps in c.ps_nodes:
        for pid in list(ps.engines):
            out = rpc.call(ps.addr, "POST", "/ps/index/build",
                           {"partition_id": pid}, timeout=300.0)
            assert out["status"] == 3
    return c, cl


def _search(cl, q, params, **kw):
    out = cl.search("db", "s", [{"field": "emb", "feature": q}], limit=10,
                    fields=[], columnar=True, cache=False,
                    index_params=params, **kw)
    return ([[h["_id"] for h in row] for row in out],
            np.asarray([[h["_score"] for h in row] for row in out]))


def _same_ties_aside(got, want):
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-3)
    for r in range(len(gi)):
        for j in range(len(gi[r])):
            if gi[r][j] != wi[r][j]:
                assert np.isclose(gs[r, j], ws[r, j], rtol=TIE_RTOL,
                                  atol=TIE_ATOL)


@pytest.mark.cuda
def test_cluster_searches_launch_both_kernels():
    _need_cuda()
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops import probe_dots as pd

    docs, q = _docs()
    flt = {"operator": "AND", "conditions": [
        {"field": "cat", "operator": "<", "value": 4}]}
    # "blockmax" selects by block maxima at this size too ("auto" takes
    # them from 4 x nb blocks a partition on); every block is selected,
    # so the kernel's one-ulp maxima cannot change the candidates
    full = {"rerank": 512, "topk_mode": "blockmax"}
    requests = {"full": (full, {}),
                "probe": ({"scan_mode": "probe", "nprobe": 8,
                           "rerank": 512}, {}),
                "filtered": (full, {"filters": flt})}
    got, want = {}, {}
    c, cl = _serve({}, docs)
    try:
        for ps in c.ps_nodes:
            assert ps.device.type == "cuda"
            for eng in ps.engines.values():
                assert eng.device.type == "cuda"
        for name, (params, kw) in requests.items():
            _search(cl, q, params, **kw)  # warm-up (publishes buckets)
            bms.int8_blockmax_stage1.launches = 0
            pd.ivf_probe_dots.launches = 0
            got[name] = _search(cl, q, params, **kw)
            launched = (pd.ivf_probe_dots.launches if name == "probe"
                        else bms.int8_blockmax_stage1.launches)
            assert launched > 0, name
    finally:
        c.stop()
    c, cl = _serve({"device": "cpu"}, docs)
    try:
        for name, (params, kw) in requests.items():
            want[name] = _search(cl, q, params, **kw)
    finally:
        c.stop()
    for name in requests:
        _same_ties_aside(got[name], want[name])
    for row in got["filtered"][0]:
        assert all(int(k[1:]) % 10 < 4 for k in row)
