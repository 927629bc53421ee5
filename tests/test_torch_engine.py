"""The port's slice as a whole: vearch_tpu_torch's Engine against
vearch_tpu's Engine on the CPU (IVFPQ, d=64, 4096 rows, 16 centroids,
8 subvectors).

The reference trains; its `dump_state()` is carried through
`vearch_tpu_torch.convert` into the port's index, which re-absorbs the
same upserted rows. Both then serve the same trained index, and their
results are held equal:
- the same keys in the same order;
- scores allclose at rtol 1e-5, atol 1e-3: the products are exact in f32
  on both sides and only the summation order differs, but an L2 score is
  |q|^2 - 2 q.x + |x|^2 with |q|^2 and |x|^2 near 300 here, so a few
  f32 ulps of those terms (3e-5 each) move a distance near 0 or 35 by up
  to a few 1e-4;
for a plain search (on every scan path: the auto/exact selection, the
block-max selection and the Pallas entry point), a search after deletes,
and a filtered search.

Training itself cannot match JAX's PRNG, so the port's own training is
held to recall@10 against exact search, within 0.05 of the reference's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402

D = 64
N = 4096
PARAMS = {"ncentroids": 16, "nsubvector": 8, "train_iters": 4,
          "training_threshold": 10 ** 9}
PATHS = {"auto": {}, "blockmax": {"topk_mode": "blockmax"},
         "pallas": {"scan_kernel": "pallas"}}
TAG_FILTER = {"operator": "AND", "conditions": [
    {"field": "tag", "operator": "IN", "value": [1, 2]},
    {"field": "price", "operator": ">=", "value": 0.25}]}


def _schema(t, metric="L2", store_dtype="float32"):
    params = dict(PARAMS, store_dtype=store_dtype)
    return t.TableSchema("t", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams("IVFPQ", t.MetricType(metric),
                                          params)),
        t.FieldSchema("tag", t.DataType.INT),
        t.FieldSchema("price", t.DataType.FLOAT),
    ])


def _data(seed=21):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 40, N)]
            + 0.6 * rng.standard_normal((N, D))).astype(np.float32)
    docs = [{"_id": f"d{i:05d}", "emb": vecs[i], "tag": int(i % 4),
             "price": float(rng.random())} for i in range(N)]
    queries = vecs[rng.choice(N, 12, replace=False)] + 0.05
    return docs, vecs, queries.astype(np.float32)


def _engines(metric, store_dtype):
    docs, vecs, queries = _data()
    ref = RefEngine(_schema(rt, metric, store_dtype))
    ref.micro_batch = False
    for lo in range(0, N, 1024):
        ref.upsert(docs[lo:lo + 1024])
    ref.build_index()
    port = Engine(_schema(pt, metric, store_dtype), device="cpu")
    for lo in range(0, N, 1024):
        port.upsert(docs[lo:lo + 1024])
    state = index_state_from_reference(ref.indexes["emb"].dump_state())
    port.indexes["emb"].load_state(state)
    return ref, port, vecs, queries


def _rows(results):
    return ([[it.key for it in r.items] for r in results],
            np.asarray([[it.score for it in r.items] for r in results]))


def _same(ref_res, port_res):
    rk, rs = _rows(ref_res)
    pk, ps = _rows(port_res)
    assert pk == rk
    np.testing.assert_allclose(ps, rs, rtol=1e-5, atol=1e-3)
    return pk


@pytest.mark.parametrize("metric,store_dtype", [
    ("L2", "float32"), ("L2", "bfloat16"), ("InnerProduct", "float32")])
def test_port_engine_serves_reference_state(metric, store_dtype):
    ref, port, _vecs, queries = _engines(metric, store_dtype)
    for name, extra in PATHS.items():
        rr = ref.search(RefRequest(vectors={"emb": queries}, k=10,
                                   index_params=extra))
        pr = port.search(SearchRequest(vectors={"emb": queries}, k=10,
                                       index_params=extra))
        keys = _same(rr, pr)
        assert all(len(row) == 10 for row in keys), name
    # deletes: a tenth of the docs, including most plain-search hits
    gone = sorted({k for row in keys for k in row[:6]}
                  | {f"d{i:05d}" for i in range(0, N, 10)})
    assert ref.delete(gone) == port.delete(gone) == len(gone)
    rr = ref.search(RefRequest(vectors={"emb": queries}, k=10))
    pr = port.search(SearchRequest(vectors={"emb": queries}, k=10))
    keys = _same(rr, pr)
    assert not set(gone) & {k for row in keys for k in row}
    # filtered search (alive AND filter mask)
    rr = ref.search(RefRequest(vectors={"emb": queries}, k=10,
                               filters=TAG_FILTER, include_fields=["tag"]))
    pr = port.search(SearchRequest(vectors={"emb": queries}, k=10,
                                   filters=TAG_FILTER,
                                   include_fields=["tag"]))
    _same(rr, pr)
    assert all(it.fields["tag"] in (1, 2) for r in pr for it in r.items)


def _recall(engine_results, vecs, queries, alive):
    d2 = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    d2[:, ~alive] = np.inf
    truth = np.argsort(d2, axis=1, kind="stable")[:, :10]
    hits = 0
    for r, t in zip(engine_results, truth):
        got = {int(it.key[1:]) for it in r.items}
        hits += len(got & set(t.tolist()))
    return hits / truth.size


def test_port_training_recall():
    docs, vecs, queries = _data(seed=22)
    ref = RefEngine(_schema(rt))
    ref.micro_batch = False
    ref.upsert(docs)
    ref.build_index()
    port = Engine(_schema(pt), device="cpu")
    port.upsert(docs)
    # below the threshold the port serves exact brute force
    flat = port.search(SearchRequest(vectors={"emb": queries}, k=10))
    alive = np.ones(N, bool)
    assert _recall(flat, vecs, queries, alive) == 1.0
    port.build_index()
    assert port.indexes["emb"].trained
    req = dict(vectors={"emb": queries}, k=10, index_params={"rerank": 64})
    port_recall = _recall(port.search(SearchRequest(**req)), vecs, queries,
                          alive)
    ref_recall = _recall(ref.search(RefRequest(**req)), vecs, queries, alive)
    assert port_recall >= ref_recall - 0.05
    assert port_recall >= 0.8
