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

The kernel has no CPU mode, so these tests are marked `cuda` and skip
where no card is visible. This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_blockmax_cuda.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

CASES = {c[0]: c for c in chip_smoke.small_cases()}
STAGE2_CASES = {c[0]: c for c in chip_smoke.small_cases()
                + chip_smoke.stage2_cases()}


def _tensors(case):
    _, q, q8, sc, vs, va, r, l2 = case
    t = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
         for x in (q.astype(np.float32), q8, sc, vs, va)]
    return t, r, l2


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from vearch_tpu_torch.ops import blockmax_scan as bms

    t, r, l2 = _tensors(CASES[name])
    before = bms.int8_blockmax_stage1.launches
    res = chip_smoke.compare_case(name, *t, r, l2, timing=False)
    assert bms.int8_blockmax_stage1.launches == before + 1
    assert res["unexplained_mismatches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STAGE2_CASES))
def test_stage2_kernel_matches_plain_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms

    (q, a8, sc, vs, va), r, l2 = _tensors(STAGE2_CASES[name])
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
