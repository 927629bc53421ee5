"""Sharded search and sharded k-means over a mesh, the port of
vearch_tpu/parallel/sharded.py.

The reference runs each program as one `shard_map` over its mesh. Here
each is a plain torch function over the shards, in the reference's
operation order, so ids are equal to its mesh path and to the port's
single-device path bit for bit:

- a shard's work runs on its device (`MeshArray.local(i, j)`: row shard
  i, query shard j);
- `all_gather(..., tiled=True)` over "data" is a `torch.cat` along the
  candidate axis, `pmax` an elementwise max across shards, `psum` a sum,
  and `axis_index("data")` the shard's index. The operands of every
  merge move to the mesh's first device, where the merge runs (with
  shards on several cards that copy is the cross-card traffic; no NCCL);
- the per-shard int8 full scan goes through `ops/ivf._select_topk`, so
  on a CUDA mesh it launches the block-max kernel whenever the topk
  mode resolves to block-max (each shard's rows are 512-aligned). The
  probe gate is a [B, N] mask, which the kernel (a [N] mask) cannot
  take, so the gated scan builds the score matrix in plain PyTorch and
  selects through `select_topk_scores`, as the reference's XLA does; so
  do the int4 mirror's scan and the binary stage 0.

Layouts (parallel/mesh.py): rows [N_pad, ...] sharded over "data",
queries [B_pad, d] over "query"; outputs [B_pad, k] on the first device.
Each program notes a compile event (`ops/perf_model.note_program`) at a
new (mesh, shape signature), as the reference registers its programs.
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from vearch_tpu_torch.engine.types import MetricType
from vearch_tpu_torch.ops import kmeans as km
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.binary_scan import _binary_scores, _mirror_rescore
from vearch_tpu_torch.ops.distance import (
    NEG_INF,
    brute_force_search,
    sqnorms,
    stable_topk,
)
from vearch_tpu_torch.ops.ivf import (
    _coarse_probes,
    _select_topk,
    int4_scan_candidates,
    rerank_scores,
    select_topk_scores,
    unpack_int4,
)
from vearch_tpu_torch.parallel import mesh as mesh_lib
from vearch_tpu_torch.parallel.mesh import Mesh, MeshArray


def _program(name: str):
    """Note a compile event at each new (mesh, shape signature) of the
    decorated program."""

    def deco(fn):
        @functools.wraps(fn)
        def run(mesh: Mesh, *args, **kwargs):
            sig = (f"{mesh_lib.mesh_tag(mesh)},{mesh.device_type}|"
                   + perf_model.shape_signature(args, kwargs))
            t0 = time.perf_counter()
            out = fn(mesh, *args, **kwargs)
            perf_model.note_program(name, sig,
                                    (time.perf_counter() - t0) * 1e3)
            return out

        return run

    return deco


def _on(dev: torch.device):
    """Make `dev` the current card while a shard's work is queued, so a
    kernel wrapper launches on that card's stream."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _global_ids(ids: torch.Tensor, shard: int, local_n: int) -> torch.Tensor:
    # masked candidates stay -1 globally (a bare shard offset would turn
    # them into real foreign docids)
    return torch.where(ids >= 0, ids + shard * local_n,
                       torch.full_like(ids, -1))


def _gather_topk(mesh: Mesh, scores: list, ids: list, r: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """all_gather over "data" and the global top-r, on the first
    device: lower shard, then lower rank, first among ties."""
    all_s = torch.cat([s.to(mesh.first) for s in scores], dim=1)
    all_i = torch.cat([i.to(mesh.first) for i in ids], dim=1)
    top_s, pos = stable_topk(all_s, min(r, all_s.shape[1]))
    return top_s, torch.gather(all_i, 1, pos)


def _pmax(mesh: Mesh, parts: list) -> torch.Tensor:
    out = parts[0].to(mesh.first)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(mesh.first))
    return out


def _query_rows(mesh: Mesh, j: int, queries: MeshArray) -> slice:
    local = queries.shape[0] // mesh.shape["query"]
    return slice(j * local, (j + 1) * local)


def _owner_rerank(mesh: Mesh, j: int, q: MeshArray, cand_i: torch.Tensor,
                  base: MeshArray, base_sqnorm: MeshArray, k: int,
                  metric: MetricType) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank against the row-sharded raw base: each shard scores
    the candidates it owns (-inf elsewhere), the pmax merge recovers the
    owner's score, then one top-k. Ownership uses the base slab's own
    rows: the mirror and the raw buffer pad to different alignments."""
    parts = []
    for i in range(mesh.shape["data"]):
        dev = mesh.devices[i][j]
        with _on(dev):
            b = base.local(i, j)
            local_nb = b.shape[0]
            cids = cand_i.to(dev)
            local = cids - i * local_nb
            mine = (cids >= 0) & (local >= 0) & (local < local_nb)
            scores = rerank_scores(
                q.local(i, j).to(b.dtype), torch.clamp(local, 0, local_nb - 1),
                b, base_sqnorm.local(i, j), metric)
            parts.append(torch.where(mine, scores,
                                     torch.full_like(scores, NEG_INF)))
    scores = _pmax(mesh, parts)
    top_s, pos = stable_topk(scores, min(k, scores.shape[1]))
    ids = torch.gather(cand_i.to(mesh.first), 1, pos)
    return top_s, torch.where(torch.isfinite(top_s), ids,
                              torch.full_like(ids, -1))


def _per_query_shard(mesh: Mesh, queries: MeshArray, fn
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run fn(j) -> (scores, ids) for each query shard and stack the
    shards' rows back into the [B_pad, ...] batch."""
    outs = [fn(j) for j in range(mesh.shape["query"])]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


@_program("sharded.flat")
def sharded_flat_search(
    mesh: Mesh,
    base: MeshArray,         # [N_pad, d] rows over "data"
    base_sqnorm: MeshArray,  # [N_pad]
    valid: MeshArray,        # [N_pad] bool
    queries: MeshArray,      # [B_pad, d] over "query"
    k: int,
    metric: MetricType = MetricType.L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact search over a row-sharded base: local top-k per shard, then
    the gather and the global top-k."""

    def shard(j):
        ss, ii = [], []
        for i in range(mesh.shape["data"]):
            with _on(mesh.devices[i][j]):
                b = base.local(i, j)
                local_k = min(k, b.shape[0])
                s, ids = brute_force_search(
                    queries.local(i, j), b, valid.local(i, j), local_k,
                    metric, base_sqnorm.local(i, j))
                ss.append(s)
                ii.append(_global_ids(ids, i, b.shape[0]))
        return _gather_topk(mesh, ss, ii, k)

    return _per_query_shard(mesh, queries, shard)


def _scan_shard(q, a8, sc, vsq, v, r, metric, topk_mode, storage,
                gate=None):
    """One shard's compressed scan and top-r ([B, r] scores, local ids,
    -1 where masked). Ungated int8 goes through `_select_topk` (the
    block-max kernel on a CUDA tensor); a gate ([B, N] bool) or int4 rows
    take the score matrix and `select_topk_scores`."""
    q = q.float()
    if gate is None:
        if storage == "int8":
            return _select_topk(q, a8, sc, vsq, v, r, topk_mode,
                                metric is MetricType.L2)
        return int4_scan_candidates(q, a8, sc, vsq, v, r, metric, topk_mode)
    rows = a8 if storage == "int8" else unpack_int4(a8)
    dots = torch.matmul(q.to(torch.bfloat16).float(),
                        rows.float().T) * sc[None, :]
    if metric is MetricType.L2:
        scores = -(sqnorms(q)[:, None] - 2.0 * dots + vsq[None, :])
    else:
        scores = dots
    scores = torch.where(v[None, :] & gate, scores,
                         torch.full_like(scores, NEG_INF))
    return select_topk_scores(scores, r, topk_mode)


@_program("sharded.int8")
def sharded_int8_search(
    mesh: Mesh,
    approx8: MeshArray,    # [N_pad, d] int8 / [N_pad, d/2] packed int4
    row_scale: MeshArray,  # [N_pad] f32
    row_vsq: MeshArray,    # [N_pad] f32
    valid: MeshArray,      # [N_pad] bool
    queries: MeshArray,    # [B_pad, d] f32 over "query"
    r: int,
    metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
    storage: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded compressed scan and the merged top-r candidates."""

    def shard(j):
        ss, ii = [], []
        for i in range(mesh.shape["data"]):
            with _on(mesh.devices[i][j]):
                a8 = approx8.local(i, j)
                local_n = row_scale.local(i, j).shape[0]
                s, ids = _scan_shard(
                    queries.local(i, j), a8, row_scale.local(i, j),
                    row_vsq.local(i, j), valid.local(i, j),
                    min(r, local_n), metric, topk_mode, storage)
                ss.append(s)
                ii.append(_global_ids(ids, i, local_n))
        return _gather_topk(mesh, ss, ii, r)

    return _per_query_shard(mesh, queries, shard)


@_program("sharded.rerank")
def sharded_exact_rerank(
    mesh: Mesh,
    queries: MeshArray,      # [B_pad, d] over "query"
    cand_ids: torch.Tensor,  # [B_pad, r] global docids (-1 padding)
    base: MeshArray,         # [cap, d] raw rows over "data"
    base_sqnorm: MeshArray,  # [cap] f32
    k: int,
    metric: MetricType = MetricType.L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring against the row-sharded raw base (the mesh form
    of ops/ivf.exact_rerank)."""
    return _per_query_shard(mesh, queries, lambda j: _owner_rerank(
        mesh, j, queries, cand_ids[_query_rows(mesh, j, queries)], base,
        base_sqnorm, k, metric))


@_program("sharded.ivf_fused")
def sharded_ivf_search(
    mesh: Mesh,
    centroids: MeshArray | None,  # [nlist, d] f32 replicated (None: no gate)
    assign: MeshArray | None,     # [N_pad] i32 row -> cell, over "data"
    approx8: MeshArray,           # [N_pad, d] int8 / [N_pad, d/2] int4
    row_scale: MeshArray,
    row_vsq: MeshArray,
    valid: MeshArray,
    base: MeshArray,              # [cap, d] raw rows over "data"
    base_sqnorm: MeshArray,
    queries: MeshArray,           # [B_pad, d] f32 over "query"
    r: int,
    k: int,
    scan_metric: MetricType = MetricType.L2,
    rerank_metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
    storage: str = "int8",
    nprobe: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The mesh's IVF serving program: optional coarse gate -> per-shard
    compressed scan -> gathered top-r -> exact rerank against the
    sharded raw base -> pmax merge and the final top-k.

    nprobe=0 is the ungated full scan; nprobe>0 masks every shard's rows
    to the probed cells, from the replicated coarse quantizer (each shard
    recomputes the probes, as the reference's shards do)."""
    def shard(j):
        ss, ii = [], []
        for i in range(mesh.shape["data"]):
            dev = mesh.devices[i][j]
            with _on(dev):
                q = queries.local(i, j)
                sc = row_scale.local(i, j)
                local_n = sc.shape[0]
                gate = None
                if nprobe > 0:
                    cents = centroids.local(i, j)
                    probes = _coarse_probes(q, cents,
                                            min(nprobe, cents.shape[0]))
                    cell = torch.zeros((q.shape[0], cents.shape[0]),
                                       dtype=torch.bool, device=dev)
                    cell.scatter_(1, probes, True)
                    gate = cell[:, torch.clamp(assign.local(i, j), min=0)
                                .long()]
                s, ids = _scan_shard(
                    q, approx8.local(i, j), sc, row_vsq.local(i, j),
                    valid.local(i, j), min(r, local_n), scan_metric,
                    topk_mode, storage, gate)
                ss.append(s)
                ii.append(_global_ids(ids, i, local_n))
        _, cand_i = _gather_topk(mesh, ss, ii, r)
        return _owner_rerank(mesh, j, queries, cand_i, base, base_sqnorm,
                             min(k, cand_i.shape[1]), rerank_metric)

    return _per_query_shard(mesh, queries, shard)


@_program("sharded.binary_refine")
def sharded_binary_refine(
    mesh: Mesh,
    planes: MeshArray,       # [N_pad, d/8] uint8 over "data"
    p_scale: MeshArray,
    p_vsq: MeshArray,
    approx8: MeshArray,      # [N_pad, d] int8 / [N_pad, d/2] int4
    m_scale: MeshArray,
    m_vsq: MeshArray,
    valid: MeshArray,
    base: MeshArray,         # [cap, d] raw rows over "data"
    base_sqnorm: MeshArray,
    queries: MeshArray,      # [B_pad, d] f32 over "query"
    r0: int,
    r1: int,
    k: int,
    scan_metric: MetricType = MetricType.L2,
    rerank_metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
    storage: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The mesh's three-stage chain: planes, mirror and raw base sharded
    in lockstep; stages 0-1 shard-local (a shard's stage-0 survivors are
    rows it owns), one gather of the per-shard top-r1, then the owner
    rerank and its pmax merge."""
    def shard(j):
        ss, ii = [], []
        for i in range(mesh.shape["data"]):
            with _on(mesh.devices[i][j]):
                q = queries.local(i, j).float()
                psc = p_scale.local(i, j)
                local_n = psc.shape[0]
                scores = _binary_scores(q, planes.local(i, j), psc,
                                        p_vsq.local(i, j), valid.local(i, j),
                                        scan_metric)
                _, c0 = select_topk_scores(scores, min(r0, local_n),
                                           topk_mode)
                del scores
                s, ids = _mirror_rescore(
                    q, c0, approx8.local(i, j), m_scale.local(i, j),
                    m_vsq.local(i, j), min(r1, local_n), scan_metric,
                    storage)
                ss.append(s)
                ii.append(_global_ids(ids, i, local_n))
        _, cand_i = _gather_topk(mesh, ss, ii, r1)
        return _owner_rerank(mesh, j, queries, cand_i, base, base_sqnorm,
                             min(k, cand_i.shape[1]), rerank_metric)

    return _per_query_shard(mesh, queries, shard)


def sharded_kmeans_partials(
    mesh: Mesh,
    x: MeshArray,          # [N_pad, d] over "data"
    valid: MeshArray,      # [N_pad] bool over "data"
    centroids: MeshArray,  # [k, d] replicated
    chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard (sums, counts) of one Lloyd round, psum'd over "data"
    (inputs are replicated over "query", so query column 0 suffices)."""
    sums = counts = None
    for i in range(mesh.shape["data"]):
        with _on(mesh.devices[i][0]):
            xs = x.local(i, 0)
            s, c = km.kmeans_partials(
                xs, valid.local(i, 0), centroids.local(i, 0),
                chunk=min(chunk, max(256, xs.shape[0])))
        s, c = s.to(mesh.first), c.to(mesh.first)
        sums = s if sums is None else sums + s
        counts = c if counts is None else counts + c
    return sums, counts


@_program("sharded.kmeans_step")
def sharded_kmeans_step(
    mesh: Mesh,
    x: MeshArray,
    valid: MeshArray,
    centroids: MeshArray,  # [k, d] replicated
    reseed: MeshArray,     # [k, d] replicated
    chunk: int = 16384,
) -> MeshArray:
    """One Lloyd round over sharded data: per-shard partial statistics,
    summed over "data", one centroid update (replicated)."""
    sums, counts = sharded_kmeans_partials(mesh, x, valid, centroids, chunk)
    new = km.centroids_from_partials(sums, counts, reseed.local(0, 0))
    return MeshArray(mesh, [new], None, tuple(new.shape))


def train_kmeans_sharded(
    mesh: Mesh, x_host: np.ndarray, k: int, iters: int = 10, seed: int = 0
) -> torch.Tensor:
    """Multi-device k-means: k-means++ init on a host sample (the
    reference's sample; the init draws from a torch generator, not JAX's
    PRNG), then `iters` sharded Lloyd rounds. Returns [k, d] f32 on the
    mesh's first device."""
    n = x_host.shape[0]
    x_host = np.asarray(x_host, dtype=np.float32)
    sample = x_host[
        np.random.default_rng(seed).choice(n, min(n, 65_536), replace=False)
    ]
    gen = torch.Generator(device=mesh.first)
    gen.manual_seed(seed)
    init = km.kmeanspp_init(torch.from_numpy(sample).to(mesh.first), k, gen)
    reseed_rows = x_host[
        np.random.default_rng(seed + 1).choice(n, k, replace=n < k)
    ]
    x_dev, n_orig = mesh_lib.shard_rows(mesh, x_host)
    valid_dev, _ = mesh_lib.shard_rows(
        mesh, np.arange(x_dev.shape[0]) < n_orig)
    cents = mesh_lib.replicate(mesh, init)
    reseed = mesh_lib.replicate(mesh, reseed_rows)
    for _ in range(iters):
        cents = sharded_kmeans_step(mesh, x_dev, valid_dev, cents, reseed)
    return cents.local(0, 0)


class ShardedFlatSearcher:
    """A row-sharded database on a mesh serving exact search: the
    multi-device deployment of a FLAT partition."""

    def __init__(
        self,
        mesh: Mesh,
        base: np.ndarray,
        metric: MetricType = MetricType.L2,
        store_dtype: str = "bfloat16",
    ):
        self.mesh = mesh
        self.metric = metric
        self.n = base.shape[0]
        self.store_dtype = getattr(torch, store_dtype)
        rows = torch.from_numpy(np.asarray(base, dtype=np.float32)).to(
            self.store_dtype)
        self.base, _ = mesh_lib.shard_rows(mesh, rows)
        sq = [sqnorms(p) for p in self.base.parts]
        self.sqnorm = MeshArray(mesh, sq, "data", (self.base.shape[0],))
        valid = np.arange(self.base.shape[0]) < self.n
        self.valid, _ = mesh_lib.shard_rows(mesh, valid)

    def search(self, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(
            self.store_dtype)
        qd, b = mesh_lib.shard_queries(self.mesh, q)
        scores, ids = sharded_flat_search(
            self.mesh, self.base, self.sqnorm, self.valid, qd, k, self.metric)
        return scores[:b].cpu().numpy(), ids[:b].cpu().numpy()
