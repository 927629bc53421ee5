"""The Hopper block-max kernels against their plain PyTorch versions, on
the card: the cases of tests/test_torch_blockmax.py, checked as
chip_smoke.py checks them.

- Stage 1: block maxima within one bf16 ulp, candidate ids equal except
  where a score tie or a block selection flipped at the bf16 rounding
  boundary explains the difference.
- Stage 2 (`compare_stage2`), from the same stage-1 maxima, over those
  cases and `stage2_cases()` (one query, a batch no tile width divides,
  IP, whole blocks masked out, every block selected): every re-scored
  entry within its f32 bound of the exact float64 score, which holds
  whatever the summation order: d exact bf16 x int8 products summed
  within 2*d f32 ulps of the sum of their absolute values, then one
  rounding per epilogue step (scale; |q|^2 - 2x and + |v|^2 for L2).
  Masked rows score -inf; the top-r ids equal the plain version's
  except where the two scores tie (chip_smoke.SCORE_TOL); ids are -1
  exactly where the score is not finite; each call launches the stage-2
  kernel once and leaves stage 1's launch counter alone.
- Both stages at GIST1M's width (`wide_cases()`: d=960, B=1024 and
  B=64), where the query tile narrows to 64 and K runs 15 steps. Stage
  1's maxima are also held to their exact float64 values
  (`compare_stage1_exact`): within the f32 bound of the block's scores
  plus one bf16 ulp. That is the check for queries next to a row, whose
  best block maximum is a small difference of sums near 2,000: there
  the plain version's f32 maxima may themselves lie more than one bf16
  ulp from the exact ones, so the one-ulp check against the plain
  version runs only on the queries drawn apart from the rows.
- The engine at d=960 (50,000 rows of the benchmark's recipe, IVFPQ with
  32 subvectors, bf16 store), in the full scan (both block-max kernels)
  and the probe regime (the probe-dots kernel), against the exact search
  as tests/test_torch_wide_rows.py holds the CPU's answers; the full
  scan's spans carry the 64-query tile and the mirror bytes that the
  shapes and the tile map say.

The kernel has no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_blockmax_cuda.py -m cuda --noconftest
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

# the repository's root (chip_smoke.py, benchmark/) and this directory
# (test_torch_wide_rows.py's helpers, shared with the CPU's case)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

SMALL = {c[0]: c for c in chip_smoke.small_cases()
         + chip_smoke.stage2_cases()}
# chip_smoke.wide_cases(), built when a test first asks (a 51,200 x 960
# mirror); the one-ulp check against the plain version holds where the
# block maxima are far from 0, but next to a row (`_near`) the plain
# version's own f32 sum may be off by more
# (test_stage1_at_d960_within_its_bound_on_cuda)
WIDE = ["d960_b1024", "d960_b64"]
WIDE_NEAR = [n + "_near" for n in WIDE]
CASES = sorted(c[0] for c in chip_smoke.small_cases()) + WIDE
STAGE2_CASES = sorted(SMALL) + WIDE + WIDE_NEAR


@functools.cache
def _wide_cases() -> dict:
    return {c[0]: c for c in chip_smoke.wide_cases()}


def _tensors(name):
    case = SMALL[name] if name in SMALL else _wide_cases()[name]
    _, q, q8, sc, vs, va, r, l2 = case
    t = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
         for x in (q.astype(np.float32), q8, sc, vs, va)]
    return t, r, l2


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from vearch_tpu_torch.ops import blockmax_scan as bms

    t, r, l2 = _tensors(name)
    before = bms.int8_blockmax_stage1.launches
    res = chip_smoke.compare_case(name, *t, r, l2, timing=False)
    assert bms.int8_blockmax_stage1.launches == before + 1
    assert res["unexplained_mismatches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", STAGE2_CASES)
def test_stage2_kernel_matches_plain_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms

    (q, a8, sc, vs, va), r, l2 = _tensors(name)
    bmax = bms.int8_blockmax_stage1(q.to(torch.bfloat16).contiguous(), a8,
                                    sc, vs, va, sqnorms(q).contiguous(), l2)
    n1 = bms.int8_blockmax_stage1.launches
    n2 = bms.blockmax_stage2_rescore.launches
    res = chip_smoke.compare_stage2(name, q, a8, sc, vs, va, bmax, r, l2,
                                    timing=False)
    # one blockmax_stage2 call and one direct call of the kernel's wrapper
    assert bms.blockmax_stage2_rescore.launches == n2 + 2
    assert bms.int8_blockmax_stage1.launches == n1
    assert res["unexplained_mismatches"] == 0
    assert res["worst_share_of_bound"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE + WIDE_NEAR)
def test_stage1_at_d960_within_its_bound_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    t, r, l2 = _tensors(name)
    res = chip_smoke.compare_stage1_exact(name, *t, l2)
    assert res["worst_share_of_bound"] <= 1.0


@pytest.fixture(scope="module")
def wide_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from test_torch_wide_rows import wide_data, wide_engine

    data = wide_data(50_000, "cuda")
    eng = wide_engine(data, "cuda", ncentroids=128)
    yield data, eng
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["full", "probe"])
def test_engine_at_d960_matches_the_exact_search_on_cuda(wide_case, regime):
    from test_torch_wide_rows import REGIMES, check_answers, search
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.probe_dots import ivf_probe_dots

    data, eng = wide_case
    search(eng, data.queries, REGIMES[regime])  # first launches
    n1, n2 = bms.int8_blockmax_stage1.launches, ivf_probe_dots.launches
    trace: dict = {}
    result = search(eng, data.queries, REGIMES[regime], trace)
    assert check_answers(data, result) >= 0.95
    if regime == "probe":
        assert ivf_probe_dots.launches == n2 + 1
        assert bms.int8_blockmax_stage1.launches == n1
        assert "span_attrs" not in trace
        return
    assert bms.int8_blockmax_stage1.launches == n1 + 1
    b = len(data.queries)
    n_pad = eng.indexes["emb"]._mirror._h8.shape[0]  # the rows it walks
    (s1, a1), (s2, a2) = trace["span_attrs"]
    assert (s1, a1["query_tile"]) == ("scan.blockmax", 64)
    assert (s2, a2["query_tile"]) == ("scan.refine", 64)
    assert a1["mirror_bytes"] == bms.stage1_mirror_bytes(b, n_pad, 960)
    # one 64-wide tile: the blocks some query selected, 512 rows each
    assert 0 < a2["mirror_bytes"] <= a1["mirror_bytes"]
    assert a2["mirror_bytes"] % (bms.BLOCK * 968) == 0
