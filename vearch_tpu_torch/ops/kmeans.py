"""Lloyd's k-means for the IVF coarse quantizer and PQ codebooks, the
port of vearch_tpu/ops/kmeans.py.

- Assignment is a [chunk, k] product plus argmax, chunked so the full
  [n, k] distance matrix never exists. Both operands are rounded to bf16
  and the product accumulates in f32, exactly as the reference's
  assignment does; argmax returns the first index among ties, as
  `jnp.argmax` does. Given the same centroids the two packages assign the
  same rows.
- Centroid updates are full f32 (`index_add_` of the rows per cluster).
- Empty clusters reseed from a fixed random sample of the data.
- `kmeans_partials` / `centroids_from_partials` split one Lloyd round
  into per-shard statistics and the update, for the mesh's trainer
  (parallel/sharded.py), as the reference splits them.
- Randomness comes from a `torch.Generator` seeded with `seed`. It cannot
  reproduce JAX's PRNG, so training is held to objective and recall, not
  to bits.
"""

from __future__ import annotations

import torch

from vearch_tpu_torch.ops.distance import sqnorms


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (round-to-nearest-even) and widen back to f32."""
    return x.to(torch.bfloat16).float()


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor,
                    chunk: int = 16384) -> torch.Tensor:
    """Nearest-centroid assignment [n] int64 (L2 geometry)."""
    c_sq = sqnorms(centroids)
    cb = _bf16_f32(centroids)
    out = []
    for lo in range(0, x.shape[0], chunk):
        dots = _bf16_f32(x[lo:lo + chunk]) @ cb.T  # [chunk, k]
        out.append(torch.argmax(2.0 * dots - c_sq[None, :], dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=x.device)
    return torch.cat(out)


def kmeanspp_init(x: torch.Tensor, k: int,
                  generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: each next centroid is drawn with probability
    proportional to the squared distance to the nearest chosen one."""
    n, d = x.shape
    xf = x.float()
    x_sq = sqnorms(xf)
    i0 = torch.randint(0, n, (1,), generator=generator, device=x.device)
    cents = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    c = xf[i0[0]]
    cents[0] = c
    min_d2 = torch.clamp(x_sq - 2.0 * (xf @ c) + torch.dot(c, c), min=0.0)
    for i in range(1, k):
        idx = torch.multinomial(torch.clamp(min_d2, min=1e-12), 1,
                                generator=generator)
        c = xf[idx[0]]
        cents[i] = c
        d2 = torch.clamp(x_sq - 2.0 * (xf @ c) + torch.dot(c, c), min=0.0)
        min_d2 = torch.minimum(min_d2, d2)
    return cents


def train_kmeans(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0,
                 chunk: int = 16384) -> torch.Tensor:
    """k-means++ init, then `iters` Lloyd rounds; returns [k, d] f32."""
    n, d = x.shape
    x = x.float()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    centroids = kmeanspp_init(x, k, gen)
    if n >= k:
        pick = torch.randperm(n, generator=gen, device=x.device)[:k]
    else:
        pick = torch.randint(0, n, (k,), generator=gen, device=x.device)
    reseed = x[pick]
    valid = torch.ones(n, dtype=torch.bool, device=x.device)
    for _ in range(iters):
        sums, counts = kmeans_partials(x, valid, centroids, chunk)
        centroids = centroids_from_partials(sums, counts, reseed)
    return centroids


def kmeans_partials(x: torch.Tensor, valid: torch.Tensor,
                    centroids: torch.Tensor, chunk: int = 16384
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One assignment pass over [n, d] rows: (sums [k, d], counts [k])
    of the rows `valid` keeps, by nearest centroid (bf16 assignment, f32
    sums)."""
    k, d = centroids.shape
    x = x.float()
    w = valid.float()
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], chunk):
        xc, wc = x[lo:lo + chunk], w[lo:lo + chunk]
        a = assign_clusters(xc, centroids, chunk)
        sums.index_add_(0, a, xc * wc[:, None])
        counts.index_add_(0, a, wc)
    return sums, counts


def centroids_from_partials(sums: torch.Tensor, counts: torch.Tensor,
                            reseed: torch.Tensor) -> torch.Tensor:
    """New centroids from summed partial statistics; an empty cluster
    takes its reseed row."""
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where((counts < 0.5)[:, None], reseed, new).to(reseed.dtype)
