"""The Hopper block-max kernel against its plain PyTorch version, on the
card: the cases of tests/test_torch_blockmax.py, checked as chip_smoke.py
checks them (block maxima within one bf16 ulp, candidate ids equal
except where a score tie or a block selection flipped at the bf16
rounding boundary explains the difference).

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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    from vearch_tpu_torch.ops import blockmax_scan as bms

    _, q, q8, sc, vs, va, r, l2 = CASES[name]
    t = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
         for x in (q.astype(np.float32), q8, sc, vs, va)]
    before = bms.int8_blockmax_stage1.launches
    res = chip_smoke.compare_case(name, *t, r, l2, timing=False)
    assert bms.int8_blockmax_stage1.launches == before + 1
    assert res["unexplained_mismatches"] == 0
