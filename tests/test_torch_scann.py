"""SCANN / VEARCH on the port: vearch_tpu_torch.ops.scann and the SCANN
index against vearch_tpu's on the CPU.

- `encode_anisotropic` given the reference's trained codebooks: the same
  codes, with one and two coordinate passes, and the mean score-aware
  loss of the decoded rows within a relative 1e-6 of the reference's
  (it is a function of the codes; only float64 summation order differs).
- `_update_codebooks` given the same codes: codewords within 1e-5 of the
  reference's (f32 segment sums in another order, then the same solve).
- The port's own training beats plain PQ on the score-aware loss, the
  port of tests/test_scann.py:24 (training is seeded with torch and
  cannot match JAX's PRNG, so it is held to the objective).
- Engines (IP, the metric ScaNN is for, and L2), the reference's trained
  state carried through `convert`: the same keys in the same order, up
  to score ties within a few f32 ulps, scores allclose at rtol 1e-5,
  atol 1e-3, on the full scan, the probe regime, and `reordering: false`
  (quantized scores, no exact pass) on both; and with a rerank depth
  asked for, which turns the exact pass back on.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu.ops import pq as ref_pq  # noqa: E402
from vearch_tpu.ops import scann as ref_scann  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops import pq as port_pq  # noqa: E402
from vearch_tpu_torch.ops import scann as port_scann  # noqa: E402

D, N = 32, 4096
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-15)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def trained():
    """Rows, unit directions and the reference's anisotropic codebooks."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4000, D)).astype(np.float32)
    u = _unit(x)
    eta = ref_scann.eta_from_threshold(0.2, D)
    cb = np.asarray(ref_scann.train_anisotropic_pq(x, u, m=8, ksub=64,
                                                   eta=eta, iters=4))
    return x, u, eta, cb


@pytest.mark.parametrize("t,d", [(0.0, 128), (0.2, 128), (0.2, 32),
                                 (0.5, 64), (1.0, 16)])
def test_eta_from_threshold_equal(t, d):
    assert port_scann.eta_from_threshold(t, d) == \
        ref_scann.eta_from_threshold(t, d)


@pytest.mark.parametrize("passes", [1, 2])
def test_encode_anisotropic_codes_equal(trained, passes):
    x, u, eta, cb = trained
    want = np.asarray(ref_scann.encode_anisotropic(x, u, jnp.asarray(cb),
                                                   eta, passes=passes))
    got = port_scann.encode_anisotropic(_t(x), _t(u), _t(cb), eta,
                                        passes=passes)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    dec = ref_pq.decode_pq_np(want, cb)
    want_loss = ref_scann.anisotropic_loss(x, u, dec, eta)
    got_loss = port_scann.anisotropic_loss(
        x, u, port_pq.decode_pq_np(got.numpy(), cb), eta)
    assert got_loss == pytest.approx(want_loss, rel=1e-6)


def test_update_codebooks_matches_reference(trained):
    x, u, eta, cb = trained
    codes = np.asarray(ref_scann.encode_anisotropic(x, u, jnp.asarray(cb),
                                                    eta))
    want = np.asarray(ref_scann._update_codebooks(
        ref_scann._split(jnp.asarray(x), 8), ref_scann._split(
            jnp.asarray(u), 8), jnp.asarray(cb),
        jnp.asarray(codes.astype(np.int32)), jnp.float32(eta), ksub=64))
    got = port_scann._update_codebooks(
        port_scann._split(_t(x), 8), port_scann._split(_t(u), 8), _t(cb),
        _t(codes.astype(np.int64)), eta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_anisotropic_training_beats_plain_pq_on_score_loss():
    rng = np.random.default_rng(3)
    n, d, m = 8_000, 32, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    u = _unit(x)
    eta = port_scann.eta_from_threshold(0.2, d)
    plain = port_pq.train_pq(_t(x), m=m, ksub=64, iters=8)
    plain_dec = port_pq.decode_pq_np(port_pq.encode_pq(_t(x), plain).numpy(),
                                     plain)
    aniso = port_scann.train_anisotropic_pq(_t(x), _t(u), m=m, ksub=64,
                                            eta=eta, iters=8)
    codes = port_scann.encode_anisotropic(_t(x), _t(u), aniso, eta)
    aniso_dec = port_pq.decode_pq_np(codes.numpy(), aniso)
    l_plain = port_scann.anisotropic_loss(x, u, plain_dec, eta)
    l_aniso = port_scann.anisotropic_loss(x, u, aniso_dec, eta)
    assert l_aniso < l_plain, (l_aniso, l_plain)
    par_plain = float(np.mean(np.sum((x - plain_dec) * u, axis=-1) ** 2))
    par_aniso = float(np.mean(np.sum((x - aniso_dec) * u, axis=-1) ** 2))
    assert par_aniso < par_plain, (par_aniso, par_plain)


# -- engines -------------------------------------------------------------------

def _schema(t, metric, extra=None, index_type="SCANN"):
    params = {"ncentroids": 16, "nsubvector": 8, "train_iters": 3,
              "training_threshold": 10 ** 9, "nprobe": 6,
              "mesh_serving": "off", **(extra or {})}
    return t.TableSchema("s", [
        t.FieldSchema("v", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams(index_type, t.MetricType(metric),
                                          params))])


def _docs(seed=41):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, D)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 30, N)]
            + 0.7 * rng.standard_normal((N, D))).astype(np.float32)
    queries = vecs[rng.choice(N, 8, replace=False)] + 0.1 * \
        rng.standard_normal((8, D)).astype(np.float32)
    return [{"_id": f"d{i:05d}", "v": vecs[i]} for i in range(N)], queries


def _engines(metric, extra=None, index_type="SCANN"):
    docs, queries = _docs()
    ref = RefEngine(_schema(rt, metric, extra, index_type))
    ref.micro_batch = False
    port = Engine(_schema(pt, metric, extra, index_type), device="cpu")
    for lo in range(0, N, 1024):
        ref.upsert(docs[lo:lo + 1024])
        port.upsert(docs[lo:lo + 1024])
    ref.build_index()
    port.indexes["v"].load_state(
        index_state_from_reference(ref.indexes["v"].dump_state()))
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


def _search(engine, cls, queries, params=None):
    return engine.search(cls(vectors={"v": queries}, k=10,
                             index_params=params or {}))


@pytest.mark.parametrize("index_type", ["SCANN", "VEARCH"])
@pytest.mark.parametrize("metric", ["InnerProduct", "L2"])
def test_scann_engine_serves_reference_state(metric, index_type):
    ref, port, queries = _engines(metric, index_type=index_type)
    ri, pi = ref.indexes["v"], port.indexes["v"]
    assert type(pi).__name__ == "ScannIndex" and pi.eta == ri.eta
    # the same anisotropic codes for every row
    np.testing.assert_array_equal(pi._codes[:N], ri._codes[:N])
    for params in ({}, {"rerank": 64}, {"scan_mode": "probe"},
                   {"scan_mode": "probe", "probe_kernel": "pallas"}):
        keys = _same(_search(ref, RefRequest, queries, params),
                     _search(port, SearchRequest, queries, params))
        assert all(len(row) == 10 for row in keys), params


@pytest.mark.parametrize("metric", ["InnerProduct", "L2"])
def test_scann_reordering_off_serves_quantized_scores(metric, monkeypatch):
    import vearch_tpu_torch.index.ivf as port_index

    ref, port, queries = _engines(metric, {"reordering": False})
    ledger: list = []
    port_ivf.set_dispatch_ledger(ledger)
    try:
        for params in ({}, {"scan_mode": "probe"}):
            _same(_search(ref, RefRequest, queries, params),
                  _search(port, SearchRequest, queries, params))
    finally:
        port_ivf.set_dispatch_ledger(None)
    # no exact pass: the full scan's unfused "scan", the probe scan, no
    # rerank
    assert ledger == ["scan", "probe_scan"]

    def forbidden(*a, **k):
        raise AssertionError("exact rerank ran with reordering=false")

    monkeypatch.setattr(port_index.IVFPQIndex, "_rerank", forbidden)
    _search(port, SearchRequest, queries)
    # an explicit rerank depth turns the exact pass back on
    monkeypatch.undo()
    _same(_search(ref, RefRequest, queries, {"rerank": 48}),
          _search(port, SearchRequest, queries, {"rerank": 48}))


def test_scann_default_nsubvector_and_opq():
    schema = pt.TableSchema("s", [pt.FieldSchema(
        "v", pt.DataType.VECTOR, dimension=48,
        index=pt.IndexParams("SCANN", pt.MetricType.L2,
                             {"ncentroids": 16}))])
    eng = Engine(schema, device="cpu")
    assert eng.indexes["v"].m == 16  # 64 halved until it divides 48
    assert "nsubvector" not in schema.fields[0].index.params
    bad = pt.TableSchema("s", [pt.FieldSchema(
        "v", pt.DataType.VECTOR, dimension=48,
        index=pt.IndexParams("SCANN", pt.MetricType.L2, {"opq": True}))])
    with pytest.raises(ValueError, match="opq"):
        Engine(bad, device="cpu")


def _recall(results, vecs, queries):
    ip = queries @ vecs.T
    truth = np.argsort(-ip, axis=1, kind="stable")[:, :10]
    hits = sum(len({int(it.key[1:]) for it in r.items} & set(t.tolist()))
               for r, t in zip(results, truth))
    return hits / truth.size


def test_scann_port_training_recall():
    docs, queries = _docs(seed=42)
    vecs = np.stack([d["v"] for d in docs])
    ref = RefEngine(_schema(rt, "InnerProduct"))
    ref.micro_batch = False
    ref.upsert(docs)
    ref.build_index()
    port = Engine(_schema(pt, "InnerProduct"), device="cpu")
    port.upsert(docs)
    port.build_index()
    req = dict(vectors={"v": queries}, k=10, index_params={"rerank": 32})
    port_recall = _recall(port.search(SearchRequest(**req)), vecs, queries)
    ref_recall = _recall(ref.search(RefRequest(**req)), vecs, queries)
    assert port_recall >= ref_recall - 0.05, (port_recall, ref_recall)
    assert port_recall >= 0.8
