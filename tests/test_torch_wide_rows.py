"""The port's IVFPQ engine at GIST1M's row width (d=960, 32 subvectors of
30 dimensions) against the benchmark's plain exact search
(`benchmark/reference/exact.py`), on the CPU: the full scan (block-max
stages 1 and 2 and the fused rerank; their plain versions here) and the
probe regime, over 20,000 rows of the benchmark's recipe with 1% of
them deleted.

Each answer is held to what the `gist1m-ivfpq` configuration states:
k distinct live rows, scores ascending, recall@10 against the exact
search of at least 0.95, and every score within the bfloat16 store's
bound of the exact squared distance of its row. That bound: the query
and the row are each rounded to bf16 (each value within 2^-9 of itself,
relative), so the rounding moves |q - v|^2 by at most
2 |q - v| e + e^2, with e = 2^-9 (|q| + |v|) and |q - v| = sqrt(d);
f32 round-off of the three D-term sums adds at most 2 D 2^-24
(|q|^2 + |v|^2).

The helpers are shared with the card's case in
tests/test_torch_blockmax_cuda.py, which runs the same checks at 50,000
rows through the Hopper kernels.
"""

import numpy as np
import pytest
import torch

from benchmark.data import gaussian_clusters
from benchmark.reference import exact

D = 960
K = 10
BF16_REL = 2.0 ** -9  # a bf16 rounding's largest relative error
F32_U = 2.0 ** -24
# the full scan names topk_mode "blockmax": at these row counts "auto"
# would select exactly (blocks < 4 x max(32, rerank / 4)), where a
# 1M-row deployment selects by block maxima
REGIMES = {"full": {"scan_mode": "full", "rerank": 512,
                    "topk_mode": "blockmax"},
           "probe": {"scan_mode": "probe", "nprobe": 16, "rerank": 512}}


def wide_data(rows: int, device, seed: int = 4_000_000_021):
    """The benchmark's recipe at d=960 (gaussian_clusters), `rows` rows,
    a pool of 64 queries, 1% of the rows deleted."""
    return gaussian_clusters.make({
        "rows": rows, "dim": D, "rows_seed": 0, "clusters": rows // 200,
        "center_scale": 3.0, "row_noise": 0.7, "query_noise": 0.1,
        "query_pool": 64, "delete_share": 0.01}, seed, device)


def wide_engine(data, device, ncentroids: int):
    """An Engine with `gist1m-ivfpq`'s index (IVFPQ, L2, 32 subvectors,
    8 k-means iterations, bf16 raw store) over the data's rows, the
    deletes applied."""
    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema)

    eng = Engine(TableSchema("gist", [FieldSchema(
        "emb", DataType.VECTOR, dimension=D,
        index=IndexParams("IVFPQ", MetricType.L2, {
            "ncentroids": ncentroids, "nsubvector": 32, "train_iters": 8,
            "store_dtype": "bfloat16", "training_threshold": 10 ** 9}))]),
        device=device)
    for lo in range(0, data.n, 10_000):
        eng.upsert([{"_id": str(j), "emb": data.rows[j]}
                    for j in range(lo, min(lo + 10_000, data.n))])
    eng.build_index()
    assert eng.delete([str(j) for j in data.deleted]) == len(data.deleted)
    return eng


def search(eng, queries: np.ndarray, params: dict, trace=None):
    """The benchmark's request: k=10, columnar results, `params`."""
    from vearch_tpu_torch.engine.engine import SearchRequest

    return eng.search(SearchRequest(
        vectors={"emb": queries}, k=K, include_fields=[], raw_results=True,
        index_params=dict(params), trace=trace))


def check_answers(data, result) -> float:
    """Hold a columnar answer for every pool query to the exact search;
    returns its recall@10."""
    rows = torch.from_numpy(data.rows)
    queries = torch.from_numpy(data.queries)
    alive = torch.from_numpy(data.alive())
    want, _ = exact.exact_topk(rows, alive, queries, K)
    assert [len(k) for k in result.keys] == [K] * len(data.queries)
    ids = torch.tensor([[int(key) for key in keys] for keys in result.keys])
    scores = torch.from_numpy(np.asarray(result.scores, np.float64)).view(
        len(data.queries), K)
    assert bool(alive[ids].all()), "a deleted row came back"
    assert all(len(set(r)) == K for r in ids.tolist())
    assert bool((scores[:, 1:] >= scores[:, :-1]).all())
    dist = exact.pair_sqdist(rows, queries, ids)
    qn = queries.double().norm(dim=1)[:, None]
    vn = rows[ids].double().norm(dim=2)
    e = BF16_REL * (qn + vn)
    tol = 2 * dist.sqrt() * e + e * e + 2 * D * F32_U * (qn * qn + vn * vn)
    worst = float(((scores - dist).abs() / tol).max())
    assert worst <= 1.0, f"a score {worst:.3f} of the bf16 bound off"
    hits = sum(len(set(a) & set(b))
               for a, b in zip(ids.tolist(), want.tolist()))
    return hits / want.numel()


@pytest.fixture(scope="module")
def cpu_case():
    data = wide_data(20_000, "cpu")
    eng = wide_engine(data, "cpu", ncentroids=64)
    yield data, eng
    eng.close()


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_wide_rows_match_the_exact_search(cpu_case, regime):
    data, eng = cpu_case
    result = search(eng, data.queries, REGIMES[regime])
    assert check_answers(data, result) >= 0.95
