"""The port's probe-regime ops (vearch_tpu_torch/ops/probe_dots.py and the
probe scans of ops/ivf.py) against the reference on the same seeded numpy
inputs, on the CPU.

- `ivf_probe_dots` (its plain version on a CPU tensor) against the
  reference's Pallas `ivf_probe_dots` run in interpret mode, as
  tests/test_pallas.py runs it, at small shapes (nlist 16, cap 128,
  B <= 8), and against a float64 numpy einsum on every case of
  chip_smoke.probe_cases() (the cases the card checks the kernel on).
- `ivfpq_probe_search` against `ivfpq_probe_search_pallas` and the XLA
  arm `ivfpq_candidates` (the pattern of tests/test_pallas.py:39), and
  the port's own `ivfpq_candidates` / `ivfflat_candidates` against the
  reference's.

Tolerances:
- dots: |port - reference| <= 2*d*u*sum|terms| per entry (u = 2^-24):
  bf16 x int8 products are exact in f32, so the two differ only in the
  order they sum d exact terms, and each order is within (d-1)*u*sum|terms|
  of the exact sum;
- ids are equal; scores allclose at rtol 1e-5, atol 1e-4 (exact products,
  only the summation order differs) between the same arm of the two
  packages, and at the reference's own rtol 1e-3, atol 1e-2 between the
  kernel arm and the XLA arm, whose q.cent terms are summed differently;
- the kernel arm's masked slots carry id -1 in the port, where the
  reference's Pallas arm leaves the slot's docid beside a -inf score (its
  XLA arm gives -1, as the port does): ids are compared where the score
  is finite, and the port's are -1 elsewhere.
"""

import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vearch_tpu.engine.types import MetricType as RefMetric  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu.ops.pallas_kernels import (  # noqa: E402
    ivf_probe_dots as ref_probe_dots,
    ivfpq_probe_search_pallas,
)
from vearch_tpu_torch.engine.types import MetricType  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops import probe_dots as pd  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

U = 2.0 ** -24
CASES = {c[0]: c[1:] for c in chip_smoke.probe_cases()}
# small enough for the reference's interpret-mode grid, no padded slots
INTERPRET_CASES = ["b4", "d100", "d30_bytes", "all_cells_b1"]
METRICS = {"l2": (RefMetric.L2, MetricType.L2),
           "ip": (RefMetric.INNER_PRODUCT, MetricType.INNER_PRODUCT)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float64)


def _exact_dots(q, probes, buckets):
    """float64 dots of the bf16-rounded queries (exact at these sizes),
    the sum of the absolute terms, and zeros for padded slots."""
    vecs = buckets[np.maximum(probes, 0)].astype(np.float64)
    qb = _bf16(q)
    dots = np.einsum("bd,bjcd->bjc", qb, vecs)
    mag = np.einsum("bd,bjcd->bjc", np.abs(qb), np.abs(vecs))
    pad = (probes < 0)[:, :, None]
    return np.where(pad, 0.0, dots), np.where(pad, 0.0, mag)


def _port_dots(q, probes, buckets):
    before = pd.ivf_probe_dots.launches
    out = pd.ivf_probe_dots(_t(q).to(torch.bfloat16), _t(probes),
                            _t(buckets)).numpy()
    assert pd.ivf_probe_dots.launches == before  # CPU: the plain version
    return out


@pytest.mark.parametrize("name", INTERPRET_CASES)
def test_probe_dots_matches_reference_kernel(name):
    q, probes, buckets = CASES[name]
    ref = np.asarray(ref_probe_dots(jnp.asarray(q), jnp.asarray(probes),
                                    jnp.asarray(buckets)))
    got = _port_dots(q, probes, buckets)
    _, mag = _exact_dots(q, probes, buckets)
    d = q.shape[1]
    assert got.shape == ref.shape == probes.shape + (buckets.shape[1],)
    assert (np.abs(got - ref) <= 2 * d * U * mag).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_dots_matches_exact_sum(name):
    q, probes, buckets = CASES[name]
    got = _port_dots(q, probes, buckets)
    want, mag = _exact_dots(q, probes, buckets)
    d = q.shape[1]
    assert (np.abs(got - want) <= d * U * mag).all()
    if (probes < 0).any():
        assert (got[probes < 0] == 0).all()


def _buckets(seed, nlist=16, cap=128, d=32):
    """The bucket layout of tests/test_pallas.py's _setup, from a seed:
    int8 residuals, per-cell scale, |approx|^2, docids, all alive."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    resid8 = rng.integers(-127, 128, (nlist, cap, d)).astype(np.int8)
    scale = ((0.01 + rng.random(nlist)) * 0.01).astype(np.float32)
    ids = np.arange(nlist * cap).reshape(nlist, cap).astype(np.int32)
    approx = cents[:, None, :] + scale[:, None, None] * resid8.astype(
        np.float32)
    vsq = (approx ** 2).sum(-1).astype(np.float32)
    valid = np.ones(nlist * cap, bool)
    return cents, resid8, scale, vsq, ids, valid


def _search_case(name):
    """(queries, bucket arrays, nprobe, r, metric name) of a named case."""
    if name == "d100":
        arrs = _buckets(41, d=100)
        q = np.random.default_rng(42).standard_normal((5, 100))
        return q.astype(np.float32), arrs, 4, 10, "l2"
    arrs = list(_buckets(43))
    q = np.random.default_rng(44).standard_normal((4, 32)).astype(
        np.float32)
    if name == "l2":
        return q, arrs, 4, 10, "l2"
    if name == "ip":
        return q, arrs, 4, 10, "ip"
    if name == "mask_strided":
        arrs[5] = np.ones(16 * 128, bool)
        arrs[5][::3] = False
        return q, arrs, 6, 40, "l2"
    if name == "mask_all_false":
        arrs[5] = np.zeros(16 * 128, bool)
        return q, arrs, 4, 10, "l2"
    if name == "nprobe_is_nlist":
        return q, arrs, 16, 64, "ip"
    if name == "b1":
        return q[:1], arrs, 8, 20, "l2"
    if name == "padded_ids":
        # short buckets: the tail slots of each cell are padding (-1)
        arrs[4] = arrs[4].copy()
        arrs[4][:, 100:] = -1
        return q, arrs, 4, 480, "l2"
    raise KeyError(name)


SEARCH_CASES = ["l2", "ip", "mask_strided", "mask_all_false",
                "nprobe_is_nlist", "b1", "d100", "padded_ids"]


def _close(a, b, rtol=1e-5, atol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", SEARCH_CASES)
def test_ivfpq_probe_search_matches_reference(name):
    q, arrs, nprobe, r, metric = _search_case(name)
    rm, pm = METRICS[metric]
    l2 = metric == "l2"
    ref_args = [jnp.asarray(q)] + [jnp.asarray(a) for a in arrs]
    port_args = [_t(q)] + [_t(a) for a in arrs]
    ks, ki = ivfpq_probe_search_pallas(*ref_args, nprobe, r, l2)
    xs, xi = ref_ivf.ivfpq_candidates(*ref_args, nprobe, r, rm)
    ps, pi = pd.ivfpq_probe_search(*port_args, nprobe, r, l2)
    us, ui = port_ivf.ivfpq_candidates(*port_args, nprobe, r, pm)
    ks, ki, xs, xi = (np.asarray(a) for a in (ks, ki, xs, xi))
    ps, pi, us, ui = (a.numpy() for a in (ps, pi, us, ui))
    fin = np.isfinite(ks)
    # kernel arm: the reference's Pallas entry point, masked ids nulled
    np.testing.assert_array_equal(pi, np.where(fin, ki, -1))
    _close(ps, ks)
    # XLA arm against XLA arm, and the two arms of the port agree
    np.testing.assert_array_equal(ui, xi)
    _close(us, xs)
    np.testing.assert_array_equal(pi, ui)
    _close(ps, us, rtol=1e-3, atol=1e-2)
    if name == "mask_all_false":
        assert (pi == -1).all() and np.isneginf(ps).all()
    if name == "mask_strided":
        assert (pi[pi >= 0] % 3 != 0).all()
    if name == "padded_ids":
        assert (pi[:, 4 * 100:] == -1).all()  # only 4*100 real slots


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_probe_table_with_padded_slots(metric):
    """An explicit probes= table with -1 slots (a host quantizer that came
    up short): those steps scan cell 0 fully masked, so no docid appears
    twice."""
    q, arrs, _nprobe, r, _ = _search_case("l2")
    rm, pm = METRICS[metric]
    probes = np.random.default_rng(45).permutation(16)[:6].astype(
        np.int32)[None, :].repeat(4, 0)
    probes[:, 3:] = -1
    probes[1, :] = [0, -1, 5, -1, -1, -1]  # cell 0 real once, padded 4x
    xs, xi = ref_ivf.ivfpq_candidates(
        jnp.asarray(q), *(jnp.asarray(a) for a in arrs), 6, 400, rm,
        probes=jnp.asarray(probes))
    us, ui = port_ivf.ivfpq_candidates(
        _t(q), *(_t(a) for a in arrs), 6, 400, pm, probes=_t(probes))
    np.testing.assert_array_equal(ui.numpy(), np.asarray(xi))
    _close(us.numpy(), xs)
    for row in ui.numpy():
        real = row[row >= 0]
        assert len(real) == len(set(real.tolist()))
    assert (ui.numpy()[1] >= 0).sum() == 2 * 128  # cells 0 and 5, once


def _flat_case(seed, dtype):
    rng = np.random.default_rng(seed)
    nlist, cap, d = 12, 128, 24
    cents = rng.standard_normal((nlist, d)).astype(np.float32) * 3
    vecs = (cents[:, None, :] + rng.standard_normal((nlist, cap, d))
            ).astype(np.float32)
    ids = np.arange(nlist * cap).reshape(nlist, cap).astype(np.int32)
    ids[:, 90:] = -1
    valid = rng.random(nlist * cap) > 0.2
    q = (cents[rng.integers(0, nlist, 6)] + rng.standard_normal((6, d))
         ).astype(np.float32)
    if dtype == "bfloat16":
        rv, pv = jnp.asarray(vecs, jnp.bfloat16), _t(vecs).to(torch.bfloat16)
        rq, pq = jnp.asarray(q, jnp.bfloat16), _t(q).to(torch.bfloat16)
    else:
        rv, pv, rq, pq = jnp.asarray(vecs), _t(vecs), jnp.asarray(q), _t(q)
    sq = np.asarray(rv, np.float32)
    sq = (sq * sq).sum(-1)
    return (rq, jnp.asarray(cents), rv, jnp.asarray(sq), jnp.asarray(ids),
            jnp.asarray(valid)), (pq, _t(cents), pv, _t(sq), _t(ids),
                                  _t(valid))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivfflat_candidates_matches_reference(metric, dtype):
    rm, pm = METRICS[metric]
    ref_args, port_args = _flat_case(46, dtype)
    rs, ri = ref_ivf.ivfflat_candidates(*ref_args, 5, 50, rm)
    ps, pi = port_ivf.ivfflat_candidates(*port_args, 5, 50, pm)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(ps.numpy(), rs)
    got = pi.numpy()
    valid = port_args[5].numpy()
    assert valid[got[got >= 0]].all()
    # padded probe slots, as for IVFPQ
    probes = np.array([[3, -1, 7, -1, 3]] * 6, np.int32)
    rs, ri = ref_ivf.ivfflat_candidates(*ref_args, 5, 400, rm,
                                        probes=jnp.asarray(probes))
    ps, pi = port_ivf.ivfflat_candidates(*port_args, 5, 400, pm,
                                         probes=_t(probes))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _close(ps.numpy(), rs)


def test_coarse_probes_and_fold_topk_match_reference():
    rng = np.random.default_rng(47)
    cents = rng.standard_normal((40, 16)).astype(np.float32)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    q[3] = 0.0  # every coarse score is -|c|^2: order by |c|, then index
    cents[7] = cents[2]  # a tied pair of cells: the lower id first
    ref = np.asarray(ref_ivf._coarse_probes(jnp.asarray(q),
                                            jnp.asarray(cents), 12))
    got = port_ivf._coarse_probes(_t(q), _t(cents), 12).numpy()
    np.testing.assert_array_equal(got, ref)
    # fold: ties keep the running list first, then the lower slot
    best_s = np.array([[5.0, 3.0, 1.0, -np.inf]] * 2, np.float32)
    best_i = np.array([[10, 11, 12, -1]] * 2, np.int32)
    new_s = np.array([[3.0, 5.0, 2.0], [9.0, 1.0, 1.0]], np.float32)
    new_i = np.array([[20, 21, 22], [23, 24, 25]], np.int32)
    rs, ri = ref_ivf._fold_topk((jnp.asarray(best_s), jnp.asarray(best_i)),
                                jnp.asarray(new_s), jnp.asarray(new_i))
    ps, pi = port_ivf._fold_topk((_t(best_s), _t(best_i)), _t(new_s),
                                 _t(new_i))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))


def test_probe_dots_wrapper_rejects_bad_input():
    q, probes, buckets = CASES["b4"]
    qb = _t(q).to(torch.bfloat16)
    with pytest.raises(ValueError):  # f32 queries
        pd.ivf_probe_dots(_t(q), _t(probes), _t(buckets))
    with pytest.raises(ValueError):  # int64 probe table
        pd.ivf_probe_dots(qb, _t(probes.astype(np.int64)), _t(buckets))
    with pytest.raises(ValueError):  # d mismatch
        pd.ivf_probe_dots(qb, _t(probes), _t(buckets[:, :, :16]))
    with pytest.raises(ValueError):  # a probe id past nlist
        bad = probes.copy()
        bad[0, 0] = buckets.shape[0]
        pd.ivf_probe_dots(qb, _t(bad), _t(buckets))
    with pytest.raises(ValueError):  # probe rows != query rows
        pd.ivf_probe_dots(qb, _t(probes[:2]), _t(buckets))
