"""The port engine's read surface against vearch_tpu's engine on the same
documents, on the CPU (IVFPQ, d=32, 2048 rows, the reference's trained
state carried into the port): `get` (fields, vector payloads, deleted
and absent keys), `doc_count`, `query` (filtered, paged in _id order,
unordered, sorted by scalar fields with `_sort` values),
`memory_usage_bytes` (the reference's formula, so a resource guard
reads the same number), and a `brute_force` search (the exact flat scan
on an indexed engine; keys equal, scores allclose at rtol 1e-5,
atol 1e-3 as in tests/test_torch_engine.py)."""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402

D, N = 32, 2048
PARAMS = {"ncentroids": 16, "nsubvector": 8, "train_iters": 3,
          "training_threshold": 10 ** 9, "mesh_serving": "off"}
FILTER = {"operator": "OR", "conditions": [
    {"field": "cat", "operator": "<", "value": 8},
    {"field": "tag", "operator": "=", "value": "t2"}]}


def _schema(t, store_dtype):
    return t.TableSchema("r", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams("IVFPQ", t.MetricType.L2,
                                          dict(PARAMS,
                                               store_dtype=store_dtype))),
        t.FieldSchema("cat", t.DataType.INT,
                      scalar_index=t.ScalarIndexType.INVERTED),
        t.FieldSchema("tag", t.DataType.STRING),
        t.FieldSchema("price", t.DataType.DOUBLE),
    ])


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def engines(request):
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    # keys out of insertion order, so _id order is not docid order
    ids = [f"k{int(x):06d}" for x in rng.permutation(10 * N)[:N]]
    docs = [{"_id": ids[i], "emb": vecs[i], "cat": int(rng.integers(0, 40)),
             "tag": f"t{int(rng.integers(0, 5))}",
             "price": float(np.round(rng.random(), 2))} for i in range(N)]
    ref = RefEngine(_schema(rt, request.param))
    ref.micro_batch = False
    port = Engine(_schema(pt, request.param), device="cpu")
    for e in (ref, port):
        for lo in range(0, N, 512):
            e.upsert(docs[lo:lo + 512])
        e.upsert([{"_id": ids[i], "price": 9.5} for i in range(0, 50, 5)])
        e.delete(ids[100:160])
    ref.build_index()
    port.indexes["emb"].load_state(
        index_state_from_reference(ref.indexes["emb"].dump_state()))
    port.build_index()
    queries = vecs[rng.choice(N, 6, replace=False)] + 0.05
    return ref, port, ids, queries.astype(np.float32)


def test_get_and_doc_count(engines):
    ref, port, ids, _q = engines
    assert port.doc_count == ref.doc_count == N - 60
    keys = ids[:200:3] + ["absent", ids[120]]
    assert port.get(keys) == ref.get(keys)
    assert port.get(keys, fields=["cat"]) == ref.get(keys, fields=["cat"])
    got = port.get(ids[:5], vector_value=True)
    assert got == ref.get(ids[:5], vector_value=True)
    assert port.get(ids[:3], fields=["emb", "tag"]) == \
        ref.get(ids[:3], fields=["emb", "tag"])


@pytest.mark.parametrize("kw", [
    dict(), dict(filters=FILTER), dict(filters=FILTER, limit=17, offset=30),
    dict(filters=FILTER, order_by_key=False, limit=1000),
    dict(include_fields=["tag"], limit=5, offset=7),
    dict(filters=FILTER, sort=[{"field": "price", "desc": True,
                                "missing_first": False},
                               {"field": "cat", "desc": False,
                                "missing_first": False}], limit=25),
    dict(sort=[{"field": "tag", "desc": False, "missing_first": False}],
         limit=30, offset=10),
    dict(filters=FILTER, vector_value=True, limit=3),
], ids=["all", "filtered", "paged", "unordered", "fields", "sorted_fixed",
        "sorted_string", "vectors"])
def test_query_equal_to_reference(engines, kw):
    ref, port, _ids, _q = engines
    assert port.query(**kw) == ref.query(**kw)


def test_memory_usage_bytes_equal_to_reference(engines):
    ref, port, _ids, _q = engines
    assert port.memory_usage_bytes() == ref.memory_usage_bytes()
    assert port.memory_usage_bytes() > port.vector_stores[
        "emb"].host_view().nbytes


def test_brute_force_search_equal_to_reference(engines):
    ref, port, _ids, queries = engines
    for kw in ({}, {"filters": FILTER, "include_fields": ["cat", "tag"]}):
        rr = ref.search(RefRequest(vectors={"emb": queries}, k=10,
                                   brute_force=True, **kw))
        pr = port.search(SearchRequest(vectors={"emb": queries}, k=10,
                                       brute_force=True, **kw))
        assert [[it.key for it in r.items] for r in pr] == \
            [[it.key for it in r.items] for r in rr]
        assert [[it.fields for it in r.items] for r in pr] == \
            [[it.fields for it in r.items] for r in rr]
        np.testing.assert_allclose(
            [[it.score for it in r.items] for r in pr],
            [[it.score for it in r.items] for r in rr], rtol=1e-5, atol=1e-3)
    assert port._microbatcher is None  # brute force never queues


def test_brute_force_is_the_exact_scan(engines):
    """On the indexed engine, brute_force returns the exact top-k of the
    rows as stored, which the quantized path need not."""
    _ref, port, _ids, queries = engines
    res = port.search(SearchRequest(vectors={"emb": queries}, k=10,
                                    brute_force=True, include_fields=[]))
    store = port.vector_stores["emb"]
    rows = torch.from_numpy(store.host_view().copy()).to(
        store.store_dtype).float().numpy()
    alive = port.bitmap.valid_mask(port.table.doc_count)
    q = torch.from_numpy(queries).to(store.store_dtype).float().numpy()
    d2 = ((q[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    d2[:, ~alive] = np.inf
    want = np.argsort(d2, axis=1, kind="stable")[:, :10]
    keys = [[port.table.key_of(int(j)) for j in row] for row in want]
    assert [[it.key for it in r.items] for r in res] == keys


def _small_ivfpq(n=600):
    rng = np.random.default_rng(23)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    eng = Engine(_schema(pt, "float32"), device="cpu")
    eng.upsert([{"_id": f"s{i}", "emb": vecs[i], "cat": i % 40,
                 "tag": "t1", "price": 0.5} for i in range(n)])
    return eng, vecs


def test_admin_surface_warmup_rebuild_refresh_and_mesh():
    eng, vecs = _small_ivfpq()
    eng.build_index()
    assert eng.status is pt.IndexStatus.INDEXED
    # warmup runs the bucketed batch sizes through the serving path
    assert eng.warmup([3, 64]) == {"emb": [8, 64]}
    eng.apply_config({"index_params": {"emb": {"warmup_batches": [1]}}})
    assert eng.apply_config({"warmup": True})["refresh_interval_ms"] == 1000
    req = SearchRequest(vectors={"emb": vecs[:4]}, k=5, include_fields=[])
    before = [[it.key for it in r.items] for r in eng.search(req)]
    assert [r[0] for r in before] == [f"s{i}" for i in range(4)]
    # rebuild: fresh indexes over the same rows, trained and absorbed
    old = eng.indexes["emb"]
    eng.rebuild_index()
    assert eng.indexes["emb"] is not old
    assert eng.indexes["emb"].trained
    assert eng.indexes["emb"].indexed_count == 600
    assert [r.items[0].key for r in eng.search(req)] == \
        [f"s{i}" for i in range(4)]
    # the refresh loop absorbs new rows without a search
    eng.apply_config({"refresh_interval_ms": 50})
    eng.start_refresh_loop()
    eng.upsert([{"_id": "late", "emb": vecs[0] * 3, "cat": 1, "tag": "t1",
                 "price": 0.1}])
    for _ in range(100):
        if eng.indexes["emb"].indexed_count == 601:
            break
        threading.Event().wait(0.05)
    assert eng.indexes["emb"].indexed_count == 601
    # mesh settings fan into the index params: "on" serves through the
    # 1x1 mesh with the single-device keys
    eng.apply_config({"mesh_shape": "1x1", "mesh_serving": "on"})
    assert eng.indexes["emb"].params.get("mesh_shape") == "1x1"
    assert [r.items[0].key for r in eng._search_direct(req)] == \
        [f"s{i}" for i in range(4)]
    assert eng.mesh_info()["fields"]["emb"]["data_shards"] == 1
    eng.apply_config({"mesh_serving": "off"})
    eng.close()
    assert not eng._refresh_thread.is_alive()
    assert [r.items[0].key for r in eng.search(req)] == \
        [f"s{i}" for i in range(4)]


def test_open_defaults_to_cuda(tmp_path):
    eng, _vecs = _small_ivfpq(50)
    eng.dump(str(tmp_path / "e"))
    if torch.cuda.is_available():  # pragma: no cover (a card is visible)
        assert Engine.open(str(tmp_path / "e")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine.open(str(tmp_path / "e"))
    assert Engine.open(str(tmp_path / "e"), device="cpu").doc_count == 50
