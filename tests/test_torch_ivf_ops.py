"""The port's full-scan search ops, k-means/PQ and quantizer against the
reference (vearch_tpu) on the same seeded numpy inputs, on the CPU.

Tolerances:
- ids (candidates, rerank results, cluster assignments, PQ codes) are
  equal;
- scores are allclose at rtol 1e-5, atol 1e-4: every product is exact
  (bf16/int8 operands widened to f32, or full-f32 products on both
  sides) and only the summation order differs;
- host-side numpy helpers (decode_pq_np, quantize_rows) are byte-equal;
- training cannot match JAX's PRNG, so the port's k-means objective and
  PQ reconstruction error, each a mean over four seeds, are held within
  10% of the reference's on the same data.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vearch_tpu.engine.types import MetricType as RefMetric  # noqa: E402
from vearch_tpu.index.int8_mirror import quantize_rows as ref_quantize  # noqa: E402
from vearch_tpu.ops import distance as ref_dist  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu.ops import kmeans as ref_km  # noqa: E402
from vearch_tpu.ops import pq as ref_pq  # noqa: E402
from vearch_tpu_torch.engine.types import MetricType  # noqa: E402
from vearch_tpu_torch.index.int8_mirror import quantize_rows  # noqa: E402
from vearch_tpu_torch.ops import distance as port_dist  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops import kmeans as port_km  # noqa: E402
from vearch_tpu_torch.ops import pq as port_pq  # noqa: E402

METRICS = {"l2": (RefMetric.L2, MetricType.L2),
           "ip": (RefMetric.INNER_PRODUCT, MetricType.INNER_PRODUCT),
           "cosine": (RefMetric.COSINE, MetricType.COSINE)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _mirror(n=4096, d=64, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    q8, scale, vsq = quantize_rows(base)
    return base, q8, scale, vsq


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("topk_mode", ["exact", "blockmax", "auto"])
def test_int8_scan_candidates(metric, topk_mode):
    base, q8, scale, vsq = _mirror()
    rng = np.random.default_rng(4)
    queries = base[rng.choice(4096, 9, replace=False)] + 0.05
    valid = rng.random(4096) > 0.1
    rm, pm = METRICS[metric]
    rs, ri = ref_ivf.int8_scan_candidates(
        jnp.asarray(queries), jnp.asarray(q8), jnp.asarray(scale),
        jnp.asarray(vsq), jnp.asarray(valid), 40, rm, topk_mode)
    ps, pi = port_ivf.int8_scan_candidates(
        _t(queries), _t(q8), _t(scale), _t(vsq), _t(valid), 40, pm,
        topk_mode)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(ps.numpy(), rs)


def _store(base, dtype):
    """Reference and port raw buffers in `dtype` with host sqnorms."""
    if dtype == "bfloat16":
        rb = jnp.asarray(base, jnp.bfloat16)
        pb = _t(base).to(torch.bfloat16)
    else:
        rb = jnp.asarray(base)
        pb = _t(base)
    sq = ref_dist.host_sqnorms(np.asarray(rb))
    np.testing.assert_array_equal(port_dist.host_sqnorms(pb.float().numpy()),
                                  sq)
    return rb, jnp.asarray(sq), pb, _t(sq)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_rerank(metric, dtype):
    base, _q8, _s, _v = _mirror(n=2000, d=48, seed=5)
    rng = np.random.default_rng(6)
    queries = rng.standard_normal((6, 48)).astype(np.float32)
    cand = rng.integers(0, 2000, (6, 64)).astype(np.int32)
    cand[:, -5:] = -1  # padding slots
    rb, rsq, pb, psq = _store(base, dtype)
    rm, pm = METRICS[metric]
    rs, ri = ref_ivf.exact_rerank(
        jnp.asarray(queries).astype(rb.dtype), jnp.asarray(cand), rb, rsq,
        10, rm)
    ps, pi = port_ivf.exact_rerank(
        _t(queries).to(pb.dtype), _t(cand), pb, psq, 10, pm)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(ps.numpy(), rs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topk_mode", ["auto", "blockmax"])
def test_int8_scan_rerank(dtype, topk_mode):
    base, q8, scale, vsq = _mirror(n=3072, d=32, seed=7)
    rng = np.random.default_rng(8)
    queries = base[rng.choice(3072, 5, replace=False)] + 0.02
    valid = rng.random(3072) > 0.05
    rb, rsq, pb, psq = _store(base, dtype)
    rs, ri = ref_ivf.int8_scan_rerank(
        jnp.asarray(queries), jnp.asarray(q8), jnp.asarray(scale),
        jnp.asarray(vsq), jnp.asarray(valid), rb, rsq, 64, 16,
        topk_mode=topk_mode)
    ps, pi = port_ivf.int8_scan_rerank(
        _t(queries), _t(q8), _t(scale), _t(vsq), _t(valid), pb, psq, 64, 16,
        topk_mode=topk_mode)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(ps.numpy(), rs)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_brute_force_search(metric):
    rng = np.random.default_rng(9)
    base = rng.standard_normal((700, 24)).astype(np.float32)
    queries = rng.standard_normal((5, 24)).astype(np.float32)
    valid = rng.random(700) > 0.2
    rm, pm = METRICS[metric]
    rs, ri = ref_dist.brute_force_search(
        jnp.asarray(queries), jnp.asarray(base), jnp.asarray(valid), 12, rm)
    ps, pi = port_dist.brute_force_search(
        _t(queries), _t(base), _t(valid), 12, pm)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(ps.numpy(), rs)
    # k > N pads with (-inf, -1), as the reference does
    ps, pi = port_dist.brute_force_search(_t(queries), _t(base[:7]), None,
                                          9, pm)
    assert (pi.numpy()[:, 7:] == -1).all()
    assert np.isneginf(ps.numpy()[:, 7:]).all()


def test_assign_and_encode_match_given_reference_quantizers():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    cents = np.asarray(ref_km.train_kmeans(jnp.asarray(x), k=24, iters=3))
    ra = np.asarray(ref_km.assign_clusters(jnp.asarray(x),
                                           jnp.asarray(cents)))
    pa = port_km.assign_clusters(_t(x), _t(cents)).numpy()
    np.testing.assert_array_equal(pa, ra)
    resid = x - cents[ra]
    cb = np.asarray(ref_pq.train_pq(jnp.asarray(resid), m=8, ksub=32,
                                    iters=3))
    rc = np.asarray(ref_pq.encode_pq(jnp.asarray(resid), jnp.asarray(cb)))
    pc = port_pq.encode_pq(_t(resid), _t(cb)).numpy()
    assert pc.dtype == np.uint8
    np.testing.assert_array_equal(pc, rc)
    # host decode and the per-row quantizer are byte-equal
    rd = ref_pq.decode_pq_np(rc, cb)
    pd = port_pq.decode_pq_np(pc, _t(cb))
    assert rd.tobytes() == pd.tobytes()
    approx = cents[ra] + rd
    for got, want in zip(quantize_rows(approx), ref_quantize(approx)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _objective(x, cents):
    d2 = ((x[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    return float(d2.min(axis=1).mean())


def test_port_training_objective_near_reference():
    """Lloyd's local optimum depends on the seeding draw, so the mean
    objective over four seeds of each trainer is compared."""
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((20, 16)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 20, 4000)]
         + 0.5 * rng.standard_normal((4000, 16))).astype(np.float32)
    seeds = range(4)
    ref = np.mean([_objective(x, np.asarray(ref_km.train_kmeans(
        jnp.asarray(x), k=20, iters=8, seed=s))) for s in seeds])
    ports = [port_km.train_kmeans(_t(x), k=20, iters=8, seed=s).numpy()
             for s in seeds]
    assert all(p.shape == (20, 16) and np.isfinite(p).all() for p in ports)
    assert np.mean([_objective(x, p) for p in ports]) <= 1.1 * ref
    # PQ reconstruction error of the port's codebooks vs the reference's
    errs, ref_errs = [], []
    for s in seeds:
        cb = port_pq.train_pq(_t(x), m=4, ksub=16, iters=4, seed=s)
        assert tuple(cb.shape) == (4, 16, 4)
        recon = port_pq.decode_pq_np(port_pq.encode_pq(_t(x), cb).numpy(),
                                     cb)
        errs.append(float(((x - recon) ** 2).sum(1).mean()))
        rcb = np.asarray(ref_pq.train_pq(jnp.asarray(x), m=4, ksub=16,
                                         iters=4, seed=s))
        rrecon = ref_pq.decode_pq_np(np.asarray(ref_pq.encode_pq(
            jnp.asarray(x), jnp.asarray(rcb))), rcb)
        ref_errs.append(float(((x - rrecon) ** 2).sum(1).mean()))
    assert np.mean(errs) <= 1.1 * np.mean(ref_errs)
