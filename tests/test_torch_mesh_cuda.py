"""The mesh layer on the card: an IVFPQ index on cuda serving through a
1x1 mesh and a 4x1 mesh of virtual shards on the one card
(`parallel/mesh.set_virtual_device_count(4)`).

- the mesh full scan launches the block-max kernel once per shard
  (topk_mode "blockmax": at these sizes "auto" selects exactly);
- ids of the 1x1 and 4x1 meshes equal the single-device path's (the
  kernel's block maxima and the exact rerank are per row, so a shard
  boundary moves no candidate);
- a CUDA index's `mesh_serving: "auto"` stays off on one card.

The kernels have no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX:

    python -m pytest tests/test_torch_mesh_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

D, N = 64, 8192
PARAMS = {"ncentroids": 32, "nsubvector": 8, "train_iters": 3,
          "topk_mode": "blockmax", "rerank": 128}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _index(mesh_serving):
    from vearch_tpu_torch.engine.raw_vector import RawVectorStore
    from vearch_tpu_torch.engine.types import IndexParams, MetricType
    from vearch_tpu_torch.index.ivf import IVFPQIndex

    rng = np.random.default_rng(31)
    centers = rng.standard_normal((64, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 64, N)]
         + rng.standard_normal((N, D))).astype(np.float32)
    store = RawVectorStore(D, device="cuda")
    store.add(x)
    idx = IVFPQIndex(IndexParams("IVFPQ", MetricType.L2, dict(
        PARAMS, mesh_serving=mesh_serving)), store)
    idx.train(x)
    idx.absorb(N)
    q = (x[rng.choice(N, 64, replace=False)]
         + 0.1 * rng.standard_normal((64, D))).astype(np.float32)
    return idx, q


@pytest.fixture
def four_shards():
    from vearch_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.set_virtual_device_count(4)
    yield
    mesh_lib.set_virtual_device_count(None)


@pytest.mark.cuda
def test_mesh_full_scan_launches_blockmax_once_per_shard(four_shards):
    _need_cuda()
    from vearch_tpu_torch.ops.blockmax_scan import int8_blockmax_stage1

    idx, q = _index("on")
    for shape, shards in (("1x1", 1), ("4x1", 4)):
        idx.search(q, 10, None, {"mesh_shape": shape})  # place
        int8_blockmax_stage1.launches = 0
        idx.search(q, 10, None, {"mesh_shape": shape})
        assert int8_blockmax_stage1.launches == shards, shape


@pytest.mark.cuda
def test_mesh_ids_equal_the_single_device_path(four_shards):
    _need_cuda()
    idx, q = _index("on")
    single = idx.search(q, 10, None, {"mesh_serving": "off"})
    for shape in ("1x1", "4x1"):
        got = idx.search(q, 10, None, {"mesh_shape": shape})
        np.testing.assert_array_equal(got[1], single[1])
        np.testing.assert_allclose(got[0], single[0], rtol=1e-6, atol=1e-5)
    mask = np.ones(N, dtype=bool)
    mask[single[1][:, :3].ravel()] = False
    got = idx.search(q, 10, mask, {"mesh_shape": "4x1"})
    np.testing.assert_array_equal(
        got[1], idx.search(q, 10, mask, {"mesh_serving": "off"})[1])


@pytest.mark.cuda
def test_cuda_auto_stays_off_on_one_card(four_shards):
    _need_cuda()
    from vearch_tpu_torch.ops import ivf as ivf_ops
    from vearch_tpu_torch.parallel import mesh as mesh_lib

    if mesh_lib.physical_device_count("cuda") != 1:
        pytest.skip("one card only: with more, auto turns the mesh on")
    idx, q = _index("auto")
    assert not idx.data_parallel and idx.mesh_info() is None
    led: list = []
    ivf_ops.set_dispatch_ledger(led)
    try:
        idx.search(q, 10, None)
    finally:
        ivf_ops.set_dispatch_ledger(None)
    assert led == ["fused_scan_rerank"]
