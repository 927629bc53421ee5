"""The storage modes and the runtime truth layer on the card:

- the int4 full scan on cuda against its CPU run on the same mirror:
  ids equal except where two f32 scores tie, scores allclose at rtol
  1e-5, atol 1e-3 (exact products in another summation order), and
  TF32 off;
- the footprint model of a small IVFPQ index (int8 and int4 mirrors,
  full scan, then the probe buckets published) against what the caching
  allocator holds for it: the live bytes past the baseline taken before
  the engine existed are at least the model (every modelled tensor is
  resident) and at most the sampler's 64 MiB slack above it;
- zero compile events after `Engine.warmup`: searches at the warmed
  row buckets record no new program signature and no library build.

The kernels have no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX:

    python -m pytest tests/test_torch_runtime_cuda.py -m cuda --noconftest
"""

import gc

import numpy as np
import pytest
import torch

D, N = 64, 20_000
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _rows(seed=5, n=N, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 3
    rows = (centers[rng.integers(0, 64, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    queries = (rows[rng.choice(n, 64, replace=False)]
               + 0.05 * rng.standard_normal((64, d))).astype(np.float32)
    return rows, queries


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
def test_int4_scan_on_the_card_matches_cpu(l2):
    _need_cuda()
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.index.int8_mirror import Int8Mirror
    from vearch_tpu_torch.ops import ivf as ivf_ops

    assert not torch.backends.cuda.matmul.allow_tf32
    rows, queries = _rows()
    metric = MetricType.L2 if l2 else MetricType.INNER_PRODUCT
    mirror = Int8Mirror(D, "int4", "cpu")
    mirror.append(rows)
    packed, scale, vsq = mirror.flush()
    valid = torch.rand(packed.shape[0], generator=torch.Generator().
                       manual_seed(1)) >= 0.2
    valid[N:] = False
    q = torch.from_numpy(queries)
    want_s, want_i = ivf_ops.int4_scan_candidates(
        q, packed, scale, vsq, valid, 200, metric)
    dev = torch.device("cuda")
    got_s, got_i = ivf_ops.int4_scan_candidates(
        q.to(dev), packed.to(dev), scale.to(dev), vsq.to(dev),
        valid.to(dev), 200, metric)
    got_s, got_i = got_s.cpu().numpy(), got_i.cpu().numpy()
    want_s, want_i = want_s.numpy(), want_i.numpy()
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=1e-5,
                               atol=1e-3)
    for r, i in zip(*np.nonzero(got_i != want_i)):
        assert abs(got_s[r, i] - want_s[r, i]) <= \
            TIE_ATOL + TIE_RTOL * abs(want_s[r, i])


def _engine(mirror_dtype, topk_mode="auto"):
    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema)

    return Engine(TableSchema("f", [FieldSchema(
        "emb", DataType.VECTOR, dimension=D,
        index=IndexParams("IVFPQ", MetricType.L2, {
            "ncentroids": 64, "nsubvector": 8, "train_iters": 3,
            "training_threshold": 10 ** 9, "scan_mode": "full",
            "mirror_dtype": mirror_dtype, "warmup_batches": [64],
            "store_dtype": "bfloat16", "topk_mode": topk_mode}))]))


@pytest.mark.cuda
@pytest.mark.parametrize("mirror_dtype", ["int8", "int4"])
def test_footprint_model_against_the_allocator(mirror_dtype):
    _need_cuda()
    from vearch_tpu_torch.engine.engine import SearchRequest
    from vearch_tpu_torch.obs.sampler import DeviceSampler

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    holder = {}
    sampler = DeviceSampler(
        lambda: holder["eng"].device_footprint_bytes() if holder else 0)
    sampler.sample_now()  # the baseline, before the engine exists
    rows, queries = _rows()
    eng = _engine(mirror_dtype)
    eng.upsert([{"_id": f"d{i}", "emb": rows[i]} for i in range(N)])
    eng.build_index()  # trains, absorbs and warms the 64-row bucket
    holder["eng"] = eng
    for params in ({}, {"scan_mode": "probe", "nprobe": 8}):
        eng.search(SearchRequest(vectors={"emb": queries}, k=10,
                                 include_fields=[], raw_results=True,
                                 index_params=params))
        torch.cuda.synchronize()
        snap = sampler.sample_now()
        base = snap["baseline_per_device_bytes"]["cuda:0"]
        model = snap["model_per_device_bytes"]
        live = snap["devices"]["cuda:0"] - base
        assert model <= live <= model + (64 << 20), (params, model, live)
        assert not snap["drift"], snap
    index = eng.indexes["emb"]
    width = D if mirror_dtype == "int8" else D // 2
    assert index._mirror.device_bytes() == \
        index._mirror._h8.shape[0] * (width + 8)
    eng.close()


@pytest.mark.cuda
def test_no_compile_event_after_warmup():
    _need_cuda()
    from vearch_tpu_torch.engine.engine import SearchRequest
    from vearch_tpu_torch.obs import flight_recorder
    from vearch_tpu_torch.ops import perf_model

    recorder = flight_recorder.install()
    rows, queries = _rows(seed=9)
    eng = _engine("int8", topk_mode="blockmax")  # the kernel launches
    eng.upsert([{"_id": f"d{i}", "emb": rows[i]} for i in range(N)])
    eng.build_index()
    total, programs = recorder.total(), perf_model.total_compiled_programs()
    for b in (64, 40, 64, 33):
        eng.search(SearchRequest(vectors={"emb": queries[:b]}, k=10,
                                 include_fields=[]))
    torch.cuda.synchronize()
    assert recorder.total() == total, recorder.events()[-3:]
    assert perf_model.total_compiled_programs() == programs
    counts = perf_model.compiled_program_counts()
    assert counts["build.blockmax_scan"] == 1
    assert counts["kernel.int8_blockmax_stage1"] >= 1
    eng.close()
