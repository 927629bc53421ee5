"""Plain exact nearest-neighbour search: the yardstick that decides
whether what `Engine.search` returned is right.

It takes the rows, the deletes and the queries that the harness made
from the seed, as the program was handed them, and works the answers out
again with plain PyTorch; it imports nothing of the program and takes
nothing the program made. On the card it computes in f32 with TF32 off;
the finalists of each query, and every distance it is asked to judge,
are summed in f64 from the f32 inputs.

`int8_topk` is the control: the same search with rows and queries
rounded to int8 (one symmetric scale a vector, max |x| / 127), the step
below the bfloat16 store that the configurations state. A comparison
that this control passes could not tell a lower precision from the
program's.
"""

from __future__ import annotations

import numpy as np
import torch

ROW_CHUNK = 262_144  # rows a scoring pass holds ([QUERY_CHUNK, chunk] f32)
QUERY_CHUNK = 1024  # queries a scoring pass holds
FINALISTS = 32  # extra candidates a query keeps for the f64 re-sort


def strict_f32() -> None:
    """Full-precision f32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_topk(rows: torch.Tensor, alive: torch.Tensor,
               queries: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The `k` nearest live rows of each query by squared L2: ([Q, k]
    int64 row numbers, [Q, k] f64 squared distances), nearest first and
    the lower row first among equal distances. `rows` [N, d] f32,
    `alive` [N] bool, `queries` [Q, d] f32, all on one device.

    A pass over the rows in f32 keeps k + FINALISTS candidates a query;
    the candidates' distances are then summed in f64 from the inputs and
    sorted, so an f32 rounding of the expansion cannot swap two
    neighbours whose distances differ by more than it."""
    strict_f32()
    if queries.shape[0] > QUERY_CHUNK:
        parts = [exact_topk(rows, alive, queries[lo:lo + QUERY_CHUNK], k)
                 for lo in range(0, queries.shape[0], QUERY_CHUNK)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    m = min(k + FINALISTS, int(alive.sum()))
    qsq = (queries * queries).sum(1)
    best_s = best_i = None
    for lo in range(0, rows.shape[0], ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, rows.shape[0])
        part = rows[lo:hi]
        s = qsq[:, None] - 2.0 * (queries @ part.T) \
            + (part * part).sum(1)[None, :]
        s = torch.where(alive[None, lo:hi], s,
                        torch.full_like(s, float("inf")))
        top_s, top_i = torch.topk(s, min(m, hi - lo), dim=1, largest=False)
        top_i = top_i + lo
        if best_s is not None:
            top_s = torch.cat([best_s, top_s], 1)
            top_i = torch.cat([best_i, top_i], 1)
            top_s, pos = torch.topk(top_s, m, dim=1, largest=False)
            top_i = torch.gather(top_i, 1, pos)
        best_s, best_i = top_s, top_i
    dist = pair_sqdist(rows, queries, best_i)
    # order by (distance, row): sort by row first, then stably by distance
    by_row = torch.argsort(best_i, dim=1)
    best_i = torch.gather(best_i, 1, by_row)
    dist = torch.gather(dist, 1, by_row)
    order = torch.argsort(dist, dim=1, stable=True)[:, :k]
    return torch.gather(best_i, 1, order), torch.gather(dist, 1, order)


def pair_sqdist(rows: torch.Tensor, queries: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """[Q, m] f64 squared L2 distances between query i and rows
    ids[i, j], summed in f64 from the f32 inputs."""
    diff = queries.double()[:, None, :] - rows[ids].double()
    return (diff * diff).sum(-1)


def int8_round(x: torch.Tensor) -> torch.Tensor:
    """Each vector rounded to int8 with one symmetric scale (max |x| /
    127), returned as the f32 values the int8 codes stand for."""
    scale = torch.clamp(x.abs().amax(1, keepdim=True) / 127.0, min=1e-30)
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def int8_topk(rows: torch.Tensor, alive: torch.Tensor,
              queries: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The control: exact search over int8-rounded rows and queries
    ([Q, k] row numbers, [Q, k] f64 squared distances between the
    rounded vectors). The products of int8 codes are exact in f32, as an
    int8 kernel's are in int32."""
    strict_f32()
    r8 = torch.empty_like(rows)
    for lo in range(0, rows.shape[0], ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, rows.shape[0])
        r8[lo:hi] = int8_round(rows[lo:hi])
    return exact_topk(r8, alive, int8_round(queries), k)


def to_device(data_rows: np.ndarray, queries: np.ndarray,
              alive: np.ndarray, device) -> tuple:
    """The harness's host arrays on `device` for the searches above."""
    return (torch.from_numpy(np.ascontiguousarray(data_rows)).to(device),
            torch.from_numpy(np.ascontiguousarray(alive)).to(device),
            torch.from_numpy(np.ascontiguousarray(queries)).to(device))
