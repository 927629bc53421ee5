"""SIFT1M-shaped synthetic rows, queries and deletes, made from the seed.

Frozen copy of the recipe of `build_data` in the repository's bench.py
and chip_smoke.py (the JAX package's headline workload): `clusters`
gaussian centres scaled by `center_scale`, each row a random centre plus
`row_noise` gaussian noise, each query a base row plus `query_noise`
noise. Widened to a pool of `query_pool` distinct queries (distinct
source rows) and a seeded set of deleted rows (`delete_share` of them).

The rows are one fixed set, drawn from `rows_seed`, as SIFT1M is one
fixed set: the index built over them, and so the work a search does
(the probe regime pads every probed cell to the longest cell), is the
same for every run. The run's seed draws the queries and the deletes.

Made on the device with one `torch.Generator` in a few large calls, so
set-up does not wait on the host's random numbers, then copied to the
host: the program is handed host arrays, and the device copies are freed
so that they add nothing to the program's peak memory. One seed gives
the same data on one device type and PyTorch build; the CPU and the GPU
give different numbers from one seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Data:
    rows: np.ndarray      # [n, d] f32
    queries: np.ndarray   # [pool, d] f32, the query pool
    deleted: np.ndarray   # [n_del] int64 row numbers, sorted

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dim(self) -> int:
        return int(self.rows.shape[1])

    def alive(self) -> np.ndarray:
        """[n] bool: rows not deleted."""
        out = np.ones(self.n, dtype=bool)
        out[self.deleted] = False
        return out


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make(params: dict, seed: int, device) -> Data:
    n, d = int(params["rows"]), int(params["dim"])
    nc, pool = int(params["clusters"]), int(params["query_pool"])
    g = generator(int(params["rows_seed"]), device)
    centers = torch.randn(nc, d, generator=g, device=device) \
        * float(params["center_scale"])
    which = torch.randint(0, nc, (n,), generator=g, device=device)
    rows = centers[which]
    rows += float(params["row_noise"]) * torch.randn(
        n, d, generator=g, device=device)
    del centers, which
    g = generator(seed, device)
    src = torch.randperm(n, generator=g, device=device)[:pool]
    queries = rows[src] + float(params["query_noise"]) * torch.randn(
        pool, d, generator=g, device=device)
    n_del = int(round(n * float(params["delete_share"])))
    deleted = torch.randperm(n, generator=g, device=device)[:n_del]
    return Data(rows=rows.cpu().numpy(), queries=queries.cpu().numpy(),
                deleted=np.sort(deleted.cpu().numpy().astype(np.int64)))
