"""The Hopper probe-dots kernel against its plain PyTorch version, on the
card: the cases of chip_smoke.probe_cases() and probe_lens_cases()
(ragged and poisoned bucket lengths, a skewed probe table, every query
on one bucket, nprobe = nlist, padded and >= nlist ids, d = 30 and 100,
B = 1 to 70), checked as chip_smoke.py checks them (every dot within
2*d f32 ulps of the sum of the absolute products, zeros for padded
probe slots, for ids past nlist and for rows past a bucket's length),
plus the probe-mode search on both probe_kernel arms, a CUDA engine
whose probe_kernel values both launch the kernel, and both kernel
wrappers launching without a host synchronisation.

The kernel has no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_probe_cuda.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

CASES = {c[0]: c[1:] for c in chip_smoke.probe_cases()}
LENS_CASES = {c[0]: c[1:] for c in chip_smoke.probe_lens_cases()}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_kernel_matches_plain_on_cuda(name):
    _need_cuda()
    from vearch_tpu_torch.ops import probe_dots as pd

    q, probes, buckets = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
                          for x in CASES[name])
    before = pd.ivf_probe_dots.launches
    chip_smoke.compare_probe_case(name, q, probes, buckets, timing=False)
    assert pd.ivf_probe_dots.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LENS_CASES))
def test_probe_kernel_with_lens_matches_plain_on_cuda(name):
    _need_cuda()
    from vearch_tpu_torch.ops import probe_dots as pd

    q, probes, buckets, lens = (
        torch.from_numpy(np.ascontiguousarray(x)).cuda()
        for x in LENS_CASES[name])
    before = pd.ivf_probe_dots.launches
    res = chip_smoke.compare_probe_case(name, q, probes, buckets, lens,
                                        timing=False)
    assert pd.ivf_probe_dots.launches == before + 1
    assert res["entries_past_lens"] > 0


@pytest.mark.cuda
def test_kernel_wrappers_do_not_synchronise_on_cuda():
    """Neither wrapper waits for the card: no .item(), .tolist() or
    bool() of a CUDA tensor sizes a launch."""
    _need_cuda()
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops import probe_dots as pd

    q, probes, buckets, lens = (
        torch.from_numpy(np.ascontiguousarray(x)).cuda()
        for x in LENS_CASES["skewed_b70"])
    qb = q.to(torch.bfloat16).contiguous()
    bq, a8, sc, vs, va = (
        torch.from_numpy(np.ascontiguousarray(x)).cuda()
        for x in chip_smoke.small_cases()[0][1:6])
    bqb = bq.float().to(torch.bfloat16).contiguous()
    qsq = (bq.float() ** 2).sum(1).contiguous()
    pd.ivf_probe_dots(qb, probes, buckets, lens)  # build before the check
    bms.int8_blockmax_stage1(bqb, a8, sc, vs, va, qsq, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pd.ivf_probe_dots(qb, probes, buckets, lens)
        pd.ivf_probe_dots(qb, probes, buckets)
        bms.int8_blockmax_stage1(bqb, a8, sc, vs, va, qsq, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_probe_search_arms_agree_on_cuda():
    """The kernel arm (`ivfpq_probe_search`) and the XLA-loop arm
    (`ivfpq_candidates`) return the same candidate ids on the card."""
    _need_cuda()
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.ops import ivf as ivf_ops
    from vearch_tpu_torch.ops import probe_dots as pd

    rng = np.random.default_rng(51)
    nlist, cap, d = 16, 128, 32
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    resid8 = rng.integers(-127, 128, (nlist, cap, d)).astype(np.int8)
    scale = ((0.01 + rng.random(nlist)) * 0.01).astype(np.float32)
    ids = np.arange(nlist * cap).reshape(nlist, cap).astype(np.int32)
    approx = cents[:, None, :] + scale[:, None, None] * resid8.astype(
        np.float32)
    vsq = (approx ** 2).sum(-1).astype(np.float32)
    valid = rng.random(nlist * cap) > 0.2
    q = rng.standard_normal((6, d)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
            for x in (q, cents, resid8, scale, vsq, ids, valid)]
    before = pd.ivf_probe_dots.launches
    ks, ki = pd.ivfpq_probe_search(*args, 6, 40, True)
    xs, xi = ivf_ops.ivfpq_candidates(*args, 6, 40, MetricType.L2)
    assert pd.ivf_probe_dots.launches == before + 1
    assert torch.equal(ki, xi)
    torch.testing.assert_close(ks, xs, rtol=1e-3, atol=1e-2)


@pytest.mark.cuda
def test_probe_kernel_zeros_ids_past_nlist_on_cuda():
    """The wrapper does not read the ids back on the card: the kernel
    writes zeros for an id >= nlist, as for a padded slot."""
    _need_cuda()
    from vearch_tpu_torch.ops import probe_dots as pd

    q, probes, buckets = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
                          for x in CASES["b4"])
    qb = q.to(torch.bfloat16).contiguous()
    bad = probes.clone()
    bad[0, 1] = buckets.shape[0]
    bad[2, 3] = 2 ** 31 - 1
    got = pd.ivf_probe_dots(qb, bad, buckets)
    want = pd.ivf_probe_dots(qb, probes, buckets)
    torch.cuda.synchronize()
    assert bool((got[0, 1] == 0).all()) and bool((got[2, 3] == 0).all())
    keep = torch.ones(bad.shape, dtype=torch.bool, device=bad.device)
    keep[0, 1] = keep[2, 3] = False
    assert torch.equal(got[keep], want[keep])


@pytest.mark.cuda
def test_both_probe_kernel_values_launch_the_kernel_on_cuda():
    """On a CUDA engine, probe_kernel "xla" serves through the kernel as
    "pallas" does, with the same keys."""
    _need_cuda()
    from vearch_tpu_torch.engine.engine import Engine, SearchRequest
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema,
    )
    from vearch_tpu_torch.ops import probe_dots as pd

    rng = np.random.default_rng(53)
    d, n = 32, 2048
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    params = {"ncentroids": 16, "nsubvector": 8, "train_iters": 4,
              "training_threshold": 10 ** 9, "scan_mode": "probe",
              "nprobe": 4}
    eng = Engine(TableSchema("t", [FieldSchema(
        "emb", DataType.VECTOR, dimension=d,
        index=IndexParams("IVFPQ", MetricType.L2, params))]))
    assert eng.device.type == "cuda"
    eng.upsert([{"_id": f"d{i}", "emb": vecs[i]} for i in range(n)])
    eng.build_index()
    keys = {}
    for kernel in ("xla", "pallas"):
        before = pd.ivf_probe_dots.launches
        res = eng.search(SearchRequest(vectors={"emb": vecs[:8]}, k=10,
                                       index_params={"probe_kernel": kernel}))
        assert pd.ivf_probe_dots.launches == before + 1, kernel
        keys[kernel] = [[it.key for it in r.items] for r in res]
    assert keys["xla"] == keys["pallas"]
    assert [row[0] for row in keys["xla"]] == [f"d{i}" for i in range(8)]
