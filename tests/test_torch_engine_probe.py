"""The port's probe regime and IVFFLAT, engine to engine: vearch_tpu_torch's
Engine against vearch_tpu's Engine on the CPU (d=64, 4096 rows, 16
centroids).

The reference trains; its `dump_state()` goes through
`vearch_tpu_torch.convert` into the port's index, which re-absorbs the
same rows. Then:
- the published bucket tensors (int8 residuals, per-bucket scale, |v|^2,
  docids) are byte-equal: the publish is the same host numpy arithmetic;
- searches return the same keys in the same order (two keys may change
  places only where their scores tie within a few f32 ulps, as a
  summation order can flip a near-tie), with scores allclose
  at rtol 1e-5, atol 1e-3 (exact products, another summation order; an L2
  score is |q|^2 - 2 q.x + |x|^2 with terms near 300, so a few f32 ulps of
  those move it by up to a few 1e-4), on plain, post-delete and filtered
  searches, with both `probe_kernel` values of the port held against the
  reference's XLA arm (the two reference arms agree, tests/test_pallas.py)
  and its Pallas arm run in interpret mode on 8-row batches.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops import probe_dots as pd  # noqa: E402

D = 64
N = 4096
# mesh_serving off: the test harness gives JAX eight CPU devices, where
# the reference's "auto" would serve the probe regime through its mesh
# program (a probe-gated full scan) instead of the bucket layout
PROBE = {"ncentroids": 16, "nsubvector": 8, "train_iters": 4,
         "training_threshold": 10 ** 9, "scan_mode": "probe", "nprobe": 6,
         "mesh_serving": "off"}
# a score tie: two keys may change places only within a few f32 ulps of
# the score's largest term (|q|^2 near 300 in L2, 1 in cosine)
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4
TAG_FILTER = {"operator": "AND", "conditions": [
    {"field": "tag", "operator": "IN", "value": [1, 2]},
    {"field": "price", "operator": ">=", "value": 0.25}]}


def _schema(t, index_type, metric, extra=None, store_dtype="float32"):
    params = dict(PROBE, store_dtype=store_dtype, **(extra or {}))
    return t.TableSchema("t", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams(index_type, t.MetricType(metric),
                                          params)),
        t.FieldSchema("tag", t.DataType.INT),
        t.FieldSchema("price", t.DataType.FLOAT),
    ])


def _docs(seed=31, n=N):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 40, n)]
            + 0.6 * rng.standard_normal((n, D))).astype(np.float32)
    docs = [{"_id": f"d{i:05d}", "emb": vecs[i], "tag": int(i % 4),
             "price": float(rng.random())} for i in range(n)]
    queries = vecs[rng.choice(n, 8, replace=False)] + 0.05
    return docs, queries.astype(np.float32)


def _engines(index_type, metric, extra=None, store_dtype="float32"):
    docs, queries = _docs()
    ref = RefEngine(_schema(rt, index_type, metric, extra, store_dtype))
    ref.micro_batch = False
    port = Engine(_schema(pt, index_type, metric, extra, store_dtype),
                  device="cpu")
    for lo in range(0, N, 1024):
        ref.upsert(docs[lo:lo + 1024])
        port.upsert(docs[lo:lo + 1024])
    ref.build_index()
    state = index_state_from_reference(ref.indexes["emb"].dump_state())
    port.indexes["emb"].load_state(state)
    return ref, port, queries


def _rows(results):
    return ([[it.key for it in r.items] for r in results],
            [[it.score for it in r.items] for r in results])


def _tied(a, b):
    return abs(a - b) <= TIE_ATOL + TIE_RTOL * abs(b)


def _same(ref_res, port_res):
    """Keys equal in order, except where a score tie explains it; scores
    allclose position by position."""
    rk, rs = _rows(ref_res)
    pk, ps = _rows(port_res)
    assert [len(r) for r in pk] == [len(r) for r in rk]
    for rkeys, rsc, pkeys, psc in zip(rk, rs, pk, ps):
        np.testing.assert_allclose(psc, rsc, rtol=1e-5, atol=1e-3)
        where = {k: j for j, k in enumerate(rkeys)}
        for i, (a, b) in enumerate(zip(rkeys, pkeys)):
            if a == b:
                continue
            # b sits where the reference has a: the two must tie, and b
            # must be in the reference's row at a tied score, or tie the
            # reference's last score (a swap across the k-th place)
            j = where.get(b)
            assert _tied(psc[i], rsc[i]), (a, b)
            assert (_tied(rsc[j], rsc[i]) if j is not None
                    else _tied(psc[i], rsc[-1])), (a, b)
    return pk


def _search(engine, request_cls, queries, **kw):
    return engine.search(request_cls(vectors={"emb": queries}, k=10, **kw))


@pytest.mark.parametrize("metric", ["L2", "Cosine", "InnerProduct"])
def test_probe_buckets_byte_equal(metric):
    ref, port, queries = _engines("IVFPQ", metric)
    _search(ref, RefRequest, queries)
    _search(port, SearchRequest, queries)
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    for name in ("_bucket_resid8", "_bucket_scale", "_bucket_vsq",
                 "_bucket_ids"):
        want = np.asarray(getattr(ri, name))
        got = getattr(pi, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    assert pi._cap == ri._cap
    assert pi.cell_populations() == ri.cell_populations()
    assert sum(pi.cell_populations()) == N
    # the port's state is the reference's state it was given
    mine, theirs = pi.dump_state(), ri.dump_state()
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert np.asarray(mine[key]).tobytes() == \
            np.asarray(theirs[key]).tobytes(), key


@pytest.mark.parametrize("metric", ["L2", "Cosine", "InnerProduct"])
def test_probe_search_matches_reference(metric):
    ref, port, queries = _engines("IVFPQ", metric)
    xla = {"probe_kernel": "xla"}
    rr = _search(ref, RefRequest, queries, index_params=xla)
    for kernel in ("xla", "pallas"):
        pr = _search(port, SearchRequest, queries,
                     index_params={"probe_kernel": kernel})
        keys = _same(rr, pr)
        assert all(len(row) == 10 for row in keys)
    # the reference's own kernel arm (interpret mode, 8-row batch)
    _same(_search(ref, RefRequest, queries,
                  index_params={"probe_kernel": "pallas"}), pr)
    # deletes: most plain-search hits and a tenth of the docs
    gone = sorted({k for row in keys for k in row[:6]}
                  | {f"d{i:05d}" for i in range(0, N, 10)})
    assert ref.delete(gone) == port.delete(gone) == len(gone)
    rr = _search(ref, RefRequest, queries, index_params=xla)
    for kernel in ("xla", "pallas"):
        pr = _search(port, SearchRequest, queries,
                     index_params={"probe_kernel": kernel})
        keys = _same(rr, pr)
        assert not set(gone) & {k for row in keys for k in row}
    # filtered search (alive AND filter mask)
    rr = _search(ref, RefRequest, queries, filters=TAG_FILTER,
                 include_fields=["tag"], index_params=xla)
    for kernel in ("xla", "pallas"):
        pr = _search(port, SearchRequest, queries, filters=TAG_FILTER,
                     include_fields=["tag"],
                     index_params={"probe_kernel": kernel})
        _same(rr, pr)
        assert all(it.fields["tag"] in (1, 2) for r in pr for it in r.items)


def test_deleted_keys_never_return_on_the_probe_path():
    """Fewer live rows in the probed cells than the rerank depth: every
    masked slot then reaches the candidate list, and none may come back
    through the rerank."""
    ref, port, queries = _engines("IVFPQ", "L2")
    keep = {f"d{i:05d}" for i in range(0, N, 97)}
    gone = [f"d{i:05d}" for i in range(N) if f"d{i:05d}" not in keep]
    assert port.delete(gone) == ref.delete(gone) == len(gone)
    rr = _search(ref, RefRequest, queries, index_params={"nprobe": 2})
    for kernel in ("xla", "pallas"):
        pr = _search(port, SearchRequest, queries,
                     index_params={"nprobe": 2, "probe_kernel": kernel})
        keys = _same(rr, pr)
        assert {k for row in keys for k in row} <= keep
        assert any(len(row) < 10 for row in keys)


def test_auto_switches_to_probe_past_full_scan_limit():
    extra = {"scan_mode": "auto", "full_scan_limit": 1000}
    ref, port, queries = _engines("IVFPQ", "L2", extra)
    ref_ledger, port_ledger = [], []
    launches = pd.ivf_probe_dots.launches
    ref_ivf.set_dispatch_ledger(ref_ledger)
    port_ivf.set_dispatch_ledger(port_ledger)
    try:
        rr = _search(ref, RefRequest, queries)
        pr = _search(port, SearchRequest, queries)
    finally:
        ref_ivf.set_dispatch_ledger(None)
        port_ivf.set_dispatch_ledger(None)
    assert port_ledger == ref_ledger == ["probe_scan", "rerank"]
    _same(rr, pr)
    # on the CPU the kernel's plain version runs: no launch is counted
    assert pd.ivf_probe_dots.launches == launches


@pytest.mark.parametrize("kernel,arm", [
    ("pallas", "ivfpq_probe_search"), ("xla", "ivfpq_candidates")])
def test_probe_kernel_picks_its_arm_on_the_cpu(monkeypatch, kernel, arm):
    """On the CPU "pallas" runs the kernel's arm (its plain version there)
    and "xla" the reference's loop; on a GPU both take the kernel
    (tests/test_torch_probe_cuda.py)."""
    import vearch_tpu_torch.index.ivf as port_index

    _, port, queries = _engines("IVFPQ", "L2")
    calls = []
    for name, owner in (("ivfpq_probe_search", port_index),
                        ("ivfpq_candidates", port_ivf)):
        fn = getattr(owner, name)

        def spy(*a, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*a)

        monkeypatch.setattr(owner, name, spy)
    _search(port, SearchRequest, queries,
            index_params={"probe_kernel": kernel})
    assert calls == [arm]


def test_probe_republishes_after_absorb():
    ref, port, queries = _engines("IVFPQ", "L2")
    _same(_search(ref, RefRequest, queries),
          _search(port, SearchRequest, queries))
    first_cap = port.indexes["emb"]._cap
    # new rows right on top of the queries: they must be found at once
    docs = [{"_id": f"new{i}", "emb": q, "tag": 0, "price": 0.5}
            for i, q in enumerate(queries)]
    ref.upsert(docs)
    port.upsert(docs)
    rr = _search(ref, RefRequest, queries)
    pr = _search(port, SearchRequest, queries)
    keys = _same(rr, pr)
    assert [row[0] for row in keys] == [f"new{i}" for i in range(8)]
    index = port.indexes["emb"]
    assert not index._dirty and index._cap >= first_cap
    assert sum(index.cell_populations()) == N + 8


@pytest.mark.parametrize("metric,store_dtype", [
    ("L2", "float32"), ("InnerProduct", "float32"), ("Cosine", "float32"),
    ("L2", "bfloat16")])
def test_ivfflat_matches_reference(metric, store_dtype):
    ref, port, queries = _engines("IVFFLAT", metric, None, store_dtype)
    state = ref.indexes["emb"].dump_state()
    assert "codebooks" not in index_state_from_reference(state)
    ref_ledger, port_ledger = [], []
    ref_ivf.set_dispatch_ledger(ref_ledger)
    port_ivf.set_dispatch_ledger(port_ledger)
    try:
        keys = _same(_search(ref, RefRequest, queries),
                     _search(port, SearchRequest, queries))
    finally:
        ref_ivf.set_dispatch_ledger(None)
        port_ivf.set_dispatch_ledger(None)
    assert port_ledger == ref_ledger == ["ivfflat_scan"]
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    assert pi._bucket_ids.numpy().tobytes() == \
        np.asarray(ri._bucket_ids).tobytes()
    np.testing.assert_allclose(pi._bucket_sqnorm.numpy(),
                               np.asarray(ri._bucket_sqnorm), rtol=1e-6)
    gone = sorted({k for row in keys for k in row[:4]})
    assert ref.delete(gone) == port.delete(gone) == len(gone)
    keys = _same(_search(ref, RefRequest, queries),
                 _search(port, SearchRequest, queries))
    assert not set(gone) & {k for row in keys for k in row}
    _same(_search(ref, RefRequest, queries, filters=TAG_FILTER),
          _search(port, SearchRequest, queries, filters=TAG_FILTER))


def test_hnsw_quantizer_is_refused(monkeypatch):
    """quantizer_type=hnsw is served (tests/test_torch_index_family.py);
    what is refused is a fall back to the flat quantizer: when the native
    graph cannot be built, training raises."""
    from vearch_tpu_torch.native import hnsw_graph

    def broken():
        raise RuntimeError("g++ failed building vearch_hnsw.cpp")

    monkeypatch.setattr(hnsw_graph.LIBRARY, "load", broken)
    eng = Engine(_schema(pt, "IVFPQ", "L2", {"quantizer_type": "hnsw"}),
                 device="cpu")
    eng.upsert(_docs(n=512)[0])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        eng.build_index()
    assert not eng.indexes["emb"].trained
