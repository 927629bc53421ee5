"""Product quantization: codebook training, encoding, host decode — the
port of vearch_tpu/ops/pq.py.

codebooks are [m, ksub, dsub] f32; codes are [n, m] uint8. Encoding is
the per-subspace `assign_clusters` (bf16 operands, f32 accumulation,
first index on ties), so given the reference's codebooks both packages
produce the same codes.
"""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.ops import kmeans as km


def train_pq(x: torch.Tensor, m: int, ksub: int = 256, iters: int = 10,
             seed: int = 0) -> torch.Tensor:
    """Train m subquantizer codebooks on x [n, d]; returns [m, ksub, dsub]."""
    n, d = x.shape
    assert d % m == 0, f"dim {d} not divisible by m={m}"
    assert 2 <= ksub <= 256, f"ksub={ksub} must fit uint8 codes"
    sub = x.float().reshape(n, m, d // m)
    return torch.stack([
        km.train_kmeans(sub[:, j].contiguous(), k=ksub, iters=iters,
                        seed=seed)
        for j in range(m)
    ])


def encode_pq(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Encode x [n, d] -> codes [n, m] uint8."""
    n, d = x.shape
    m, ksub, dsub = codebooks.shape
    assert ksub <= 256, f"ksub={ksub} would wrap around in uint8 codes"
    sub = x.float().reshape(n, m, dsub)
    codes = [km.assign_clusters(sub[:, j].contiguous(), codebooks[j])
             for j in range(m)]
    return torch.stack(codes, dim=1).to(torch.uint8)


def decode_pq_np(codes: np.ndarray, codebooks) -> np.ndarray:
    """Numpy PQ decode for the host-side absorb path: [n, m] -> [n, d]."""
    cb = (codebooks.detach().cpu().numpy()
          if isinstance(codebooks, torch.Tensor) else np.asarray(codebooks))
    m = cb.shape[0]
    return cb[
        np.arange(m)[None, :], np.asarray(codes).astype(np.int64), :
    ].reshape(codes.shape[0], -1)
