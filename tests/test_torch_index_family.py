"""The rest of the in-memory index family on the port, engine to engine
against vearch_tpu on the CPU (d=32, 4096 rows, 16 centroids):
IVFRABITQ, BINARYIVF, HNSW, the HNSW coarse quantizer on IVFPQ, SCANN
and IVFFLAT, and the registry.

The reference trains; its `dump_state()` goes through
`vearch_tpu_torch.convert` into the port's index, which re-absorbs the
same rows. Then searches return the same keys in the same order (two
keys may change places only where their scores tie within a few f32
ulps), scores allclose at rtol 1e-5, atol 1e-3 (exact products on both
sides in another summation order; an L2 score is |q|^2 - 2 q.x + |x|^2
with terms near 300, so a few f32 ulps of those move it by up to a few
1e-4), on plain, post-delete and filtered searches. Reference engines
run with mesh_serving off: conftest gives JAX eight CPU devices, where
the reference's "auto" would serve IVFRABITQ and the probe regime
through its mesh programs.

The reference's three-stage perf gates (tests/test_perf_gates.py) fail
on their own tree (ROADMAP queue 3); the chain's numbers are held here
and in tests/test_torch_binary_scan.py against the reference's
`binary_refine_rerank` instead.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu.engine.raw_vector import RawVectorStore as RefStore  # noqa: E402
from vearch_tpu.index import registry as ref_registry  # noqa: E402
from vearch_tpu.native import hnsw_graph as ref_hnsw  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.engine.raw_vector import RawVectorStore  # noqa: E402
from vearch_tpu_torch.index import registry  # noqa: E402
from vearch_tpu_torch.native import hnsw_graph  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops.probe_dots import ivfpq_probe_search  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N = 32, 4096
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4
TAG_FILTER = {"operator": "AND", "conditions": [
    {"field": "tag", "operator": "IN", "value": [1, 2]},
    {"field": "price", "operator": ">=", "value": 0.25}]}
BASE = {"ncentroids": 16, "nsubvector": 8, "train_iters": 3,
        "training_threshold": 10 ** 9, "nprobe": 6, "mesh_serving": "off"}


def _schema(t, index_type, metric, extra=None, d=D):
    return t.TableSchema("t", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=d,
                      index=t.IndexParams(index_type, t.MetricType(metric),
                                          dict(BASE, **(extra or {})))),
        t.FieldSchema("tag", t.DataType.INT),
        t.FieldSchema("price", t.DataType.FLOAT),
    ])


def _docs(seed=51, n=N, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 40, n)]
            + 0.6 * rng.standard_normal((n, d))).astype(np.float32)
    docs = [{"_id": f"d{i:05d}", "emb": vecs[i], "tag": int(i % 4),
             "price": float(rng.random())} for i in range(n)]
    queries = vecs[rng.choice(n, 8, replace=False)] + 0.05
    return docs, queries.astype(np.float32)


def _engines(index_type, metric, extra=None, docs=None, queries=None, d=D):
    if docs is None:
        docs, queries = _docs(d=d)
    ref = RefEngine(_schema(rt, index_type, metric, extra, d))
    ref.micro_batch = False
    port = Engine(_schema(pt, index_type, metric, extra, d), device="cpu")
    for lo in range(0, len(docs), 1024):
        ref.upsert(docs[lo:lo + 1024])
        port.upsert(docs[lo:lo + 1024])
    ref.build_index()
    port.indexes["emb"].load_state(
        index_state_from_reference(ref.indexes["emb"].dump_state()))
    return ref, port, queries


def _tied(a, b):
    return abs(a - b) <= TIE_ATOL + TIE_RTOL * abs(b)


def _same(ref_res, port_res):
    """Keys equal in order, except where a score tie explains a swap;
    scores allclose position by position."""
    rk = [[it.key for it in r.items] for r in ref_res]
    rs = [[it.score for it in r.items] for r in ref_res]
    pk = [[it.key for it in r.items] for r in port_res]
    ps = [[it.score for it in r.items] for r in port_res]
    assert [len(r) for r in pk] == [len(r) for r in rk]
    for rkeys, rsc, pkeys, psc in zip(rk, rs, pk, ps):
        np.testing.assert_allclose(psc, rsc, rtol=1e-5, atol=1e-3)
        where = {k: j for j, k in enumerate(rkeys)}
        for i, (a, b) in enumerate(zip(rkeys, pkeys)):
            if a != b:
                j = where.get(b)
                assert _tied(psc[i], rsc[i]), (a, b)
                assert (_tied(rsc[j], rsc[i]) if j is not None
                        else _tied(psc[i], rsc[-1])), (a, b)
    return pk


def _search(engine, cls, queries, params=None, **kw):
    return engine.search(cls(vectors={"emb": queries}, k=10,
                             index_params=params or {}, **kw))


def _deletes_and_filter(ref, port, queries, keys, params=None):
    """A tenth of the docs and most plain-search hits deleted, then a
    filtered search: equal, and no deleted key comes back."""
    gone = sorted({k for row in keys for k in row[:6]}
                  | {f"d{i:05d}" for i in range(0, N, 10)})
    assert ref.delete(gone) == port.delete(gone) == len(gone)
    keys = _same(_search(ref, RefRequest, queries, params),
                 _search(port, SearchRequest, queries, params))
    assert not set(gone) & {k for row in keys for k in row}
    _same(_search(ref, RefRequest, queries, params, filters=TAG_FILTER),
          _search(port, SearchRequest, queries, params, filters=TAG_FILTER))


# -- registry -------------------------------------------------------------------

def _store():
    return RawVectorStore(D, device="cpu")


@pytest.mark.parametrize("name", ["BINARYIVF", "IVFRABITQ", "SCANN",
                                  "VEARCH", "HNSW"])
def test_registry_resolves_new_types(name):
    idx = registry.create_index(pt.IndexParams(name, pt.MetricType.L2),
                                _store())
    ref = ref_registry.create_index(rt.IndexParams(name, rt.MetricType.L2),
                                    RefStore(D))
    assert type(idx).__name__ == type(ref).__name__


@pytest.mark.parametrize("name,item", [("DISKANN", "item 7"),
                                       ("DISKANN_STATIC", "item 7"),
                                       ("FLAT_SHARDED", "item 10")])
def test_not_ported_types_raise(name, item):
    """Every type the reference registers now resolves to the reference's
    class: DISKANN and DISKANN_STATIC came with item 7
    (tests/test_torch_disk.py holds them to it), FLAT_SHARDED with item
    10 (tests/test_torch_mesh.py)."""
    idx = registry.create_index(pt.IndexParams(name), _store())
    ref = ref_registry.create_index(rt.IndexParams(name), RefStore(D))
    assert type(idx).__name__ == type(ref).__name__ == {
        "item 7": "DiskANNIndex", "item 10": "ShardedFlatIndex"}[item]
    assert registry.registered_types() == ref_registry.registered_types()


def test_sharded_flat_and_unknown_types():
    idx = registry.create_index(pt.IndexParams("FLAT", params={"sharded": 1}),
                                _store())
    assert type(idx).__name__ == "ShardedFlatIndex"
    with pytest.raises(ValueError, match="unknown index_type"):
        registry.create_index(pt.IndexParams("NOPE"), _store())


# -- IVFRABITQ -------------------------------------------------------------------

THREE_STAGE = [{}, {"r0": 1024, "r1": 256}, {"r1": 64}, {"rerank": 96},
               {"topk_mode": "blockmax"}]


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_ivfrabitq_three_stage_matches_reference(metric):
    ref, port, queries = _engines("IVFRABITQ", metric)
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    ledger: list = []
    port_ivf.set_dispatch_ledger(ledger)
    try:
        for params in THREE_STAGE:
            keys = _same(_search(ref, RefRequest, queries, params),
                         _search(port, SearchRequest, queries, params))
            assert all(len(row) == 10 for row in keys), params
    finally:
        port_ivf.set_dispatch_ledger(None)
    assert ledger == ["binary_refine_rerank"] * len(THREE_STAGE)
    # both mirrors as the reference flushes them
    for mirror in ("_bits", "_mirror"):
        for want, got in zip(getattr(ri, mirror).flush(),
                             getattr(pi, mirror).flush()):
            assert got.numpy().tobytes() == np.asarray(want).tobytes(), \
                mirror
    assert pi._stage_depths(16, None) == ri._stage_depths(16, None)
    assert pi.dump_state().keys() == ri.dump_state().keys()
    _deletes_and_filter(ref, port, queries, keys)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_ivfrabitq_stage0_off_matches_reference(metric):
    ref, port, queries = _engines("IVFRABITQ", metric)
    ledger: list = []
    port_ivf.set_dispatch_ledger(ledger)
    try:
        for params in ({"stage0": "off"}, {"stage0": "off", "rerank": 256}):
            keys = _same(_search(ref, RefRequest, queries, params),
                         _search(port, SearchRequest, queries, params))
    finally:
        port_ivf.set_dispatch_ledger(None)
    assert ledger == ["fused_scan_rerank"] * 2
    _deletes_and_filter(ref, port, queries, keys, {"stage0": "off"})


def test_ivfrabitq_refuses_what_is_not_ported():
    # int4 mirrors are served now (tests/test_torch_storage_modes.py)
    eng = Engine(_schema(pt, "IVFRABITQ", "L2", {"mirror_dtype": "int4"}),
                 device="cpu")
    assert eng.indexes["emb"]._mirror.storage == "int4"
    ref, port, queries = _engines("IVFRABITQ", "L2")
    # the mesh branch serves now (tests/test_torch_mesh.py holds it to
    # the reference's): a 1x1 mesh returns the single-device keys
    keys = [[it.key for it in r.items] for r in _search(
        port, SearchRequest, queries, {"mesh_serving": "on",
                                       "mesh_shape": "1x1"})]
    assert keys == [[it.key for it in r.items]
                    for r in _search(port, SearchRequest, queries)]
    with pytest.raises(ValueError, match="stage0"):
        _search(port, SearchRequest, queries, {"stage0": "ternary"})


# -- BINARYIVF -------------------------------------------------------------------

def _binary_docs(d=64, n=1024, seed=61):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n, d)).astype(np.uint8)
    packed = np.packbits(bits, axis=1)
    docs = [{"_id": f"d{i:05d}", "emb": packed[i], "tag": int(i % 4),
             "price": float(rng.random())} for i in range(n)]
    return bits, packed, docs


def test_binaryivf_hamming_matches_reference():
    bits, packed, docs = _binary_docs()
    queries = packed[[3, 17, 400, 1000]]
    ref, port, _ = _engines("BINARYIVF", "L2", {"nprobe": 16}, docs=docs,
                            queries=queries, d=64)
    assert port.indexes["emb"].input_dim == 8
    for params in ({}, {"nprobe": 4}):
        rr = _search(ref, RefRequest, queries, params)
        pr = _search(port, SearchRequest, queries, params)
        keys = _same(rr, pr)
    # a stored row finds itself at Hamming 0; every score is the exact
    # Hamming distance
    for qi, r in zip((3, 17, 400, 1000), pr):
        assert r.items[0].key == f"d{qi:05d}" and r.items[0].score == 0.0
        for it in r.items:
            assert it.score == float((bits[qi] != bits[int(it.key[1:])]).sum())
    # a single packed query as one row
    one = port.search(SearchRequest(vectors={"emb": packed[5]}, k=1))
    assert one[0].items[0].key == "d00005"
    gone = sorted({row[0] for row in keys})
    assert ref.delete(gone) == port.delete(gone)
    _same(_search(ref, RefRequest, queries), _search(port, SearchRequest,
                                                     queries))


def test_binaryivf_wire_width_is_checked():
    f = pt.FieldSchema("emb", pt.DataType.VECTOR, dimension=64,
                       index=pt.IndexParams("BINARYIVF"))
    assert f.wire_dim == 8
    assert pt.FieldSchema("emb", pt.DataType.VECTOR, dimension=64,
                          index=pt.IndexParams("FLAT")).wire_dim == 64
    _bits, packed, docs = _binary_docs(n=16)
    port = Engine(_schema(pt, "BINARYIVF", "L2", d=64), device="cpu")
    with pytest.raises(ValueError):  # 64 floats where 8 bytes belong
        port.upsert([{"_id": "x", "emb": np.zeros(64, np.float32)}])
    assert port.table.doc_count == 0
    port.upsert(docs)
    with pytest.raises(ValueError):
        port.search(SearchRequest(vectors={"emb": packed[:2, :7]}, k=3))
    with pytest.raises(ValueError, match="multiple of 8"):
        Engine(_schema(pt, "BINARYIVF", "L2", d=60), device="cpu")


# -- the HNSW coarse quantizer ---------------------------------------------------

@pytest.mark.parametrize("index_type,metric", [
    ("IVFPQ", "L2"), ("IVFPQ", "InnerProduct"), ("SCANN", "InnerProduct"),
    ("IVFFLAT", "L2")])
def test_hnsw_quantizer_matches_reference(index_type, metric):
    extra = {"quantizer_type": "hnsw", "scan_mode": "probe"}
    ref, port, queries = _engines(index_type, metric, extra)
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    # the same graph over the same centroids: the same cells for every
    # row, and the same probes for every query
    assert pi.cell_populations() == ri.cell_populations()
    q = pi._maybe_normalize(queries)
    for nprobe in (1, 6, 16):
        np.testing.assert_array_equal(pi._host_probes(q, nprobe).numpy(),
                                      ri._host_probes(q, nprobe))
    arms = ([{"probe_kernel": "xla"}, {"probe_kernel": "pallas"}]
            if index_type != "IVFFLAT" else [{}])
    ledger: list = []
    port_ivf.set_dispatch_ledger(ledger)
    try:
        rr = _search(ref, RefRequest, queries)
        for arm in arms:
            keys = _same(rr, _search(port, SearchRequest, queries, arm))
    finally:
        port_ivf.set_dispatch_ledger(None)
    want_tag = "ivfflat_scan" if index_type == "IVFFLAT" else "probe_scan"
    assert ledger.count(want_tag) == len(arms)
    _deletes_and_filter(ref, port, queries, keys)


def test_host_probes_with_missing_slots_match_the_reference_loop():
    """A -1 probe (the graph came up short) reaches the kernel's arm as it
    is: its slots score -inf, and no cell is scanned twice."""
    ref, port, queries = _engines("IVFPQ", "L2", {"scan_mode": "probe"})
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    _search(ref, RefRequest, queries)
    _search(port, SearchRequest, queries)
    rng = np.random.default_rng(5)
    probes = np.stack([rng.permutation(16)[:6] for _ in queries]).astype(
        np.int32)
    probes[:, 4:] = -1
    probes[0, :] = -1
    probes[1, 1:] = -1
    valid = np.ones(pi.store.capacity, bool)
    valid[::7] = False
    args = (pi.centroids, pi._bucket_resid8, pi._bucket_scale,
            pi._bucket_vsq, pi._bucket_ids, torch.from_numpy(valid), 6, 200)
    for l2 in (True, False):
        rm = rt.MetricType.L2 if l2 else rt.MetricType.INNER_PRODUCT
        ws, wi = ref_ivf.ivfpq_candidates(
            jax.numpy.asarray(queries), ri.centroids, ri._bucket_resid8,
            ri._bucket_scale, ri._bucket_vsq, ri._bucket_ids,
            jax.numpy.asarray(valid), 6, 200, rm,
            probes=jax.numpy.asarray(probes))
        gs, gi = ivfpq_probe_search(torch.from_numpy(queries), *args, l2,
                                    pi._bucket_lens, torch.from_numpy(probes))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        fin = np.isfinite(np.asarray(ws))
        np.testing.assert_allclose(gs.numpy()[fin], np.asarray(ws)[fin],
                                   rtol=1e-5, atol=1e-3)
        assert not np.isfinite(gs.numpy()[0]).any()
        row = gi.numpy()[2]
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)


# -- HNSW ---------------------------------------------------------------------------

def test_hnsw_source_is_the_reference_source():
    with open(os.path.join(REPO, "csrc", "vearch_hnsw.cpp"), "rb") as f:
        want = f.read()
    assert hnsw_graph.LIBRARY.source.read_bytes() == want
    hnsw_graph.LIBRARY.load()
    assert os.path.dirname(hnsw_graph.LIBRARY.path) == os.path.join(
        REPO, "vearch_tpu_torch", "_build")


@pytest.mark.parametrize("ip", [False, True])
def test_hnsw_graph_matches_reference_graph(ip):
    rng = np.random.default_rng(71)
    rows = rng.standard_normal((3000, D)).astype(np.float32)
    if ip:
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rows[:20] + 0.05
    mine = hnsw_graph.HnswGraph(D, m=12, ef_construction=80, ip=ip)
    theirs = ref_hnsw.HnswGraph(D, m=12, ef_construction=80, ip=ip)
    for lo in range(0, 3000, 700):  # incremental adds
        mine.add(rows[lo:lo + 700])
        theirs.add(rows[lo:lo + 700])
    valid = rng.random(3000) > 0.3
    for mask in (None, valid):
        got = mine.search(queries, 10, 48, mask)
        want = theirs.search(queries, 10, 48, mask)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_hnsw_scan_mode_matches_reference(metric):
    ref, port, queries = _engines("HNSW", metric, {"efSearch": 48})
    assert port.indexes["emb"]._graph is None  # "auto" on a memory store
    for params in ({}, {"efSearch": 200}):
        keys = _same(_search(ref, RefRequest, queries, params),
                     _search(port, SearchRequest, queries, params))
    _deletes_and_filter(ref, port, queries, keys)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_hnsw_graph_mode_matches_reference(metric):
    extra = {"graph": True, "nlinks": 12, "efConstruction": 64,
             "efSearch": 48}
    ref, port, queries = _engines("HNSW", metric, extra)
    pi = port.indexes["emb"]
    # the reference's graph, carried as its saved blob
    assert pi._graph.count == N and pi.indexed_count == N
    keys = _same(_search(ref, RefRequest, queries),
                 _search(port, SearchRequest, queries))
    _deletes_and_filter(ref, port, queries, keys)
    # the port's own graph over the same rows is the same graph
    fresh = Engine(_schema(pt, "HNSW", metric, extra), device="cpu")
    docs, _ = _docs()
    for lo in range(0, N, 1024):
        fresh.upsert(docs[lo:lo + 1024])
    alive = [k for k in (d["_id"] for d in docs)
             if port.table.docid_of(k) is not None]
    fresh.delete(sorted(set(d["_id"] for d in docs) - set(alive)))
    _same(_search(ref, RefRequest, queries),
          _search(fresh, SearchRequest, queries))


def test_hnsw_graph_state_round_trip_and_phantom_nodes():
    extra = {"graph": True, "nlinks": 12, "efConstruction": 64}
    docs, queries = _docs(n=1200)
    port = Engine(_schema(pt, "HNSW", "L2", extra), device="cpu")
    port.upsert(docs)
    before = _search(port, SearchRequest, queries)
    state = port.indexes["emb"].dump_state()
    assert int(state["indexed_count"]) == 1200
    other = Engine(_schema(pt, "HNSW", "L2", extra), device="cpu")
    other.upsert(docs)
    other.indexes["emb"].load_state(state)
    _same(before, _search(other, SearchRequest, queries))
    # nodes past the indexed count are never served
    idx = other.indexes["emb"]
    idx.indexed_count = 600
    _s, ids = idx._search_graph(queries, 10, 64, None)
    assert ids.max() < 600
