"""The build side's last storage modes on the port, against vearch_tpu on
the CPU: int4 mirrors, OPQ and `reconstruction_error`.

- `quantize_rows_int4` byte-equal (numpy on both sides), `unpack_int4`
  equal value for value, an odd dimension refused.
- `int4_scan_candidates` and `int8_scan_rerank(storage="int4")` on the
  same packed mirror: ids equal, except where two scores tie within a
  few f32 ulps; scores allclose at rtol 1e-5, atol 1e-3. Both sides take
  exact products (bf16 queries times int4 values, |v| <= 8) and differ
  only in the order of the sums over d; an L2 score is
  |q|^2 - 2 q.v + |v|^2 with terms near 100 here.
- IVFPQ with `mirror_dtype: "int4"` and IVFRABITQ with an int4 stage-1
  tier, engine to engine from the reference's trained state.
- OPQ: the reference trains (its k-means draws from the JAX PRNG, so the
  port cannot match its bits); the port loads that state through
  `convert.py` and must then hold equal codes, equal mirror and bucket
  bytes, equal ids in both regimes and survive a dump/open. The port's
  own training is held to bounds: R orthonormal, and a lower
  reconstruction error than plain PQ on correlated data.
- `reconstruction_error` equal to the reference's for IVFFLAT, IVFPQ,
  OPQ, SCANN, IVFRABITQ and DISKANN given the same state (rtol 1e-5).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu.engine.types import MetricType as RefMetric  # noqa: E402
from vearch_tpu.index import int8_mirror as ref_mirror  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.engine.types import MetricType  # noqa: E402
from vearch_tpu_torch.index import int8_mirror as port_mirror  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402

RTOL, ATOL = 1e-5, 1e-3
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4
D, N = 32, 4096
BASE = {"ncentroids": 16, "nsubvector": 8, "train_iters": 3,
        "training_threshold": 10 ** 9, "nprobe": 6, "mesh_serving": "off"}


def _t(x):
    return torch.from_numpy(np.array(x))


# -- int4 quantization and unpack ------------------------------------------------


@pytest.mark.parametrize("d", [8, 64, 128])
def test_quantize_rows_int4_and_unpack_equal(d):
    rows = np.random.default_rng(d).standard_normal((300, d)).astype(
        np.float32) * 3
    rows[:3] = 0.0  # the scale floor
    want = ref_mirror.quantize_rows_int4(rows)
    got = port_mirror.quantize_rows_int4(rows)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    # every byte value, so both nibbles take all 16 codes
    packed = np.arange(256, dtype=np.uint8).reshape(-1, 1).repeat(d // 2, 1)
    for p in (want[0], packed):
        ref_vals = np.asarray(ref_ivf.unpack_int4(jnp.asarray(p)),
                              dtype=np.float32)
        port_vals = port_ivf.unpack_int4(_t(p))
        assert port_vals.dtype == torch.int8
        np.testing.assert_array_equal(port_vals.float().numpy(), ref_vals)


def test_odd_dimension_is_refused():
    with pytest.raises(ValueError, match="even"):
        port_mirror.quantize_rows_int4(np.ones((2, 7), np.float32))
    with pytest.raises(ValueError, match="even"):
        port_mirror.Int8Mirror(7, "int4", "cpu")
    with pytest.raises(ValueError):
        ref_mirror.Int8Mirror(7, "int4")


def _int4_case(metric_name, seed, n=80 * 512 - 200, d=32, b=6):
    """A flushed int4 mirror of clustered rows (80 blocks, so the
    block-max branch prunes), queries near rows, a mask that drops a
    fifth of the rows, and a raw base for the rerank."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((20, d)).astype(np.float32) * 2
    rows = (centers[rng.integers(0, 20, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    if metric_name == "IP":
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    mirror = ref_mirror.Int8Mirror(d, storage="int4")
    mirror.append(rows)
    packed, scale, vsq = (np.asarray(a) for a in mirror.flush())
    cap = packed.shape[0]
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) >= 0.2
    q = (rows[rng.choice(n, b, replace=False)]
         + 0.05 * rng.standard_normal((b, d))).astype(np.float32)
    base = np.zeros((cap, d), np.float32)
    base[:n] = rows
    base_sq = np.sum(base * base, axis=1).astype(np.float32)
    return q, packed, scale, vsq, valid, base, base_sq


def _metrics(name):
    return ((RefMetric.L2, MetricType.L2) if name == "L2"
            else (RefMetric.INNER_PRODUCT, MetricType.INNER_PRODUCT))


def _tied(a, b):
    return abs(a - b) <= TIE_ATOL + TIE_RTOL * abs(b)


def _same_candidates(want, got):
    """Equal ids row by row, except where a score tie explains a swap;
    scores allclose position by position; -1 exactly where masked."""
    ws, wi = (np.asarray(x) for x in want)
    gs, gi = (x.numpy() for x in got)
    assert gi.shape == wi.shape
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    for row in range(wi.shape[0]):
        for i in np.flatnonzero(gi[row] != wi[row]):
            assert _tied(gs[row, i], ws[row, i]), (row, i)


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("mode", ["auto", "exact", "blockmax"])
def test_int4_scan_candidates_match_reference(metric, mode):
    q, packed, scale, vsq, valid, _b, _s = _int4_case(metric, 3)
    rm, pm = _metrics(metric)
    want = ref_ivf.int4_scan_candidates(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(scale),
        jnp.asarray(vsq), jnp.asarray(valid), 200, rm, mode)
    got = port_ivf.int4_scan_candidates(
        _t(q), _t(packed), _t(scale), _t(vsq), _t(valid), 200, pm, mode)
    assert got[1].dtype == torch.int32
    _same_candidates(want, got)
    assert not set(got[1].numpy().ravel()) & set(np.flatnonzero(~valid))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_int4_scan_rerank_matches_reference(metric):
    q, packed, scale, vsq, valid, base, base_sq = _int4_case(metric, 4)
    rm, pm = _metrics(metric)
    want = ref_ivf.int8_scan_rerank(
        *(jnp.asarray(a) for a in (q, packed, scale, vsq, valid, base,
                                   base_sq)),
        128, 10, scan_metric=rm, rerank_metric=rm, storage="int4")
    got = port_ivf.int8_scan_rerank(
        *(_t(a) for a in (q, packed, scale, vsq, valid, base, base_sq)),
        128, 10, scan_metric=pm, rerank_metric=pm, storage="int4")
    _same_candidates(want, got)


# -- engines ---------------------------------------------------------------------


def _schema(t, index_type, metric="L2", extra=None, d=D):
    return t.TableSchema("t", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=d,
                      index=t.IndexParams(index_type, t.MetricType(metric),
                                          dict(BASE, **(extra or {})))),
        t.FieldSchema("tag", t.DataType.INT),
    ])


def _docs(seed=61, n=N, d=D, correlated=False):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 40, n)]
            + 0.6 * rng.standard_normal((n, d))).astype(np.float32)
    if correlated:
        # anisotropic gaussians under a seeded random rotation: energy
        # spread unevenly across dims, then mixed across every subspace
        scales = np.geomspace(4.0, 0.05, d).astype(np.float32)
        rot, _ = np.linalg.qr(rng.standard_normal((d, d)))
        vecs = ((rng.standard_normal((n, d)) * scales) @ rot).astype(
            np.float32)
    docs = [{"_id": f"d{i:05d}", "emb": vecs[i], "tag": int(i % 4)}
            for i in range(n)]
    queries = vecs[rng.choice(n, 8, replace=False)] + 0.05
    return docs, queries.astype(np.float32)


def _engines(index_type, metric="L2", extra=None, docs=None, queries=None,
             data_dirs=(None, None)):
    if docs is None:
        docs, queries = _docs()
    ref = RefEngine(_schema(rt, index_type, metric, extra),
                    data_dir=data_dirs[0])
    ref.micro_batch = False
    port = Engine(_schema(pt, index_type, metric, extra), device="cpu",
                  data_dir=data_dirs[1])
    for lo in range(0, len(docs), 1024):
        ref.upsert(docs[lo:lo + 1024])
        port.upsert(docs[lo:lo + 1024])
    ref.build_index()
    port.indexes["emb"].load_state(
        index_state_from_reference(ref.indexes["emb"].dump_state()))
    return ref, port, queries


def _search(engine, cls, queries, params=None):
    return engine.search(cls(vectors={"emb": queries}, k=10,
                             index_params=params or {}))


def _same(ref_res, port_res):
    """Keys equal in order, except where a score tie explains a swap;
    scores allclose position by position."""
    rk = [[it.key for it in r.items] for r in ref_res]
    rs = [[it.score for it in r.items] for r in ref_res]
    pk = [[it.key for it in r.items] for r in port_res]
    ps = [[it.score for it in r.items] for r in port_res]
    assert [len(r) for r in pk] == [len(r) for r in rk]
    for rkeys, rsc, pkeys, psc in zip(rk, rs, pk, ps):
        np.testing.assert_allclose(psc, rsc, rtol=RTOL, atol=ATOL)
        where = {k: j for j, k in enumerate(rkeys)}
        for i, (a, b) in enumerate(zip(rkeys, pkeys)):
            if a != b:
                j = where.get(b)
                assert _tied(psc[i], rsc[i]), (a, b)
                assert (_tied(rsc[j], rsc[i]) if j is not None
                        else _tied(psc[i], rsc[-1])), (a, b)
    return pk


FULL_PARAMS = [{}, {"rerank": 256}, {"fused_rerank": False},
               {"topk_mode": "exact"}]


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_ivfpq_int4_mirror_matches_reference(metric):
    ref, port, queries = _engines("IVFPQ", metric,
                                  {"mirror_dtype": "int4",
                                   "scan_mode": "full"})
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    ledger: list = []
    port_ivf.set_dispatch_ledger(ledger)
    try:
        for params in FULL_PARAMS:
            _same(_search(ref, RefRequest, queries, params),
                  _search(port, SearchRequest, queries, params))
    finally:
        port_ivf.set_dispatch_ledger(None)
    assert ledger == ["fused_scan_rerank", "fused_scan_rerank", "scan",
                      "rerank", "fused_scan_rerank"]
    for want, got in zip(ri._mirror.flush(), pi._mirror.flush()):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert pi._mirror._h8.shape[1] == D // 2
    assert pi._mirror.device_bytes() == ri._mirror.device_bytes()


def test_ivfrabitq_int4_stage1_matches_reference():
    ref, port, queries = _engines("IVFRABITQ", "L2",
                                  {"mirror_dtype": "int4"})
    for params in ({}, {"r0": 1024, "r1": 256}, {"stage0": "off"}):
        _same(_search(ref, RefRequest, queries, params),
              _search(port, SearchRequest, queries, params))
    for mirror in ("_bits", "_mirror"):
        for want, got in zip(getattr(ref.indexes["emb"], mirror).flush(),
                             getattr(port.indexes["emb"], mirror).flush()):
            assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_opq_from_reference_state_matches(metric, tmp_path):
    docs, queries = _docs(correlated=True)
    ref, port, _ = _engines("IVFPQ", metric, {"opq": True, "opq_iters": 2},
                            docs=docs, queries=queries)
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    state = ri.dump_state()
    assert "opq_R" in state
    np.testing.assert_array_equal(pi._opq_R, state["opq_R"])
    n = ri.indexed_count
    np.testing.assert_array_equal(pi._codes[:n], ri._codes[:n])
    for want, got in zip(ri._mirror.flush(), pi._mirror.flush()):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    # both regimes; the probe regime publishes the buckets first
    for params in ({"scan_mode": "full"}, {"scan_mode": "full",
                                           "rerank": 256},
                   {"scan_mode": "probe"}, {"scan_mode": "probe",
                                            "nprobe": 12}):
        keys = _same(_search(ref, RefRequest, queries, params),
                     _search(port, SearchRequest, queries, params))
    for name in ("_bucket_resid8", "_bucket_scale", "_bucket_vsq"):
        assert getattr(pi, name).numpy().tobytes() == \
            np.asarray(getattr(ri, name)).tobytes(), name
    # dump / open keeps the rotation and the answers
    port.dump(str(tmp_path / "dump"))
    again = Engine.open(str(tmp_path / "dump"), device="cpu")
    np.testing.assert_array_equal(again.indexes["emb"]._opq_R, pi._opq_R)
    assert _same(_search(ref, RefRequest, queries, {"scan_mode": "full"}),
                 _search(again, SearchRequest, queries,
                         {"scan_mode": "full"}))
    assert keys
    again.close()
    port.close()


def test_opq_training_bounds():
    """The port's own OPQ: an orthonormal rotation, and less
    reconstruction error than plain PQ on data whose energy the rotation
    spreads over every subspace."""
    docs, _ = _docs(correlated=True)
    errs = {}
    for opq in (False, True):
        eng = Engine(_schema(pt, "IVFPQ", "L2",
                             {"opq": opq, "opq_iters": 3, "train_iters": 4}),
                     device="cpu")
        eng.upsert(docs)
        eng.build_index()
        idx = eng.indexes["emb"]
        errs[opq] = idx.reconstruction_error(sample=1024)
        if opq:
            R = idx._opq_R
            assert R.shape == (D, D) and R.dtype == np.float32
            assert np.abs(R.T @ R - np.eye(D)).max() < 1e-4
            assert "opq_R" in idx.dump_state()
        else:
            assert idx._opq_R is None and "opq_R" not in idx.dump_state()
        eng.close()
    assert errs[True] < errs[False], errs


def test_convert_checks_opq_state():
    state = {"centroids": np.zeros((4, 8), np.float32),
             "codebooks": np.zeros((2, 16, 4), np.float32),
             "opq_R": np.eye(8, dtype=np.float32)}
    out = index_state_from_reference(state)
    np.testing.assert_array_equal(out["opq_R"], np.eye(8))
    with pytest.raises(ValueError, match="opq_R"):
        index_state_from_reference(dict(state, opq_R=np.eye(4)))
    with pytest.raises(ValueError, match="opq_R"):
        index_state_from_reference({k: v for k, v in state.items()
                                    if k != "codebooks"})


RECON_CASES = [
    ("IVFFLAT", "L2", {}),
    ("IVFPQ", "L2", {}),
    ("IVFPQ", "Cosine", {}),
    ("IVFPQ", "L2", {"opq": True, "opq_iters": 2}),
    ("IVFPQ", "L2", {"mirror_dtype": "int4"}),
    ("SCANN", "L2", {}),
    ("IVFRABITQ", "L2", {}),
    ("DISKANN", "L2", {}),
]


@pytest.mark.parametrize("index_type,metric,extra", RECON_CASES)
def test_reconstruction_error_matches_reference(index_type, metric, extra,
                                                tmp_path):
    dirs = ((str(tmp_path / "ref"), str(tmp_path / "port"))
            if index_type == "DISKANN" else (None, None))
    ref, port, _ = _engines(index_type, metric, extra, data_dirs=dirs)
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    if index_type == "IVFRABITQ":
        # the reference's inherited method indexes codes it never keeps
        with pytest.raises(IndexError):
            ri.reconstruction_error()
        assert pi.reconstruction_error() is None
        assert port.quality_info()["fields"]["emb"]["recon_error"] is None
        return
    for sample, seed in ((256, 0), (64, 3), (10 ** 6, 0)):
        want = ri.reconstruction_error(sample, seed)
        got = pi.reconstruction_error(sample, seed)
        assert want is not None and got is not None
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert port.quality_info()["fields"]["emb"]["recon_error"] == \
        pytest.approx(ref.quality_info()["fields"]["emb"]["recon_error"],
                      rel=1e-5)
    ref.close()
    port.close()


@pytest.mark.parametrize("index_type", ["FLAT", "HNSW"])
def test_reconstruction_error_none_where_rows_are_exact(index_type):
    ref, port, _ = _engines(index_type)
    assert ref.indexes["emb"].reconstruction_error() is None
    assert port.indexes["emb"].reconstruction_error() is None
