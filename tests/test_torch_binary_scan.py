"""IVFRABITQ's stage-0 machinery, the port against the reference on the
CPU: vearch_tpu_torch.ops.binary_scan, ivf.select_topk_scores,
perf_model.refine_depths and the bit-plane Int8Mirror, held against
vearch_tpu's functions of the same names on the same seeded inputs.

- `pack_sign_rows` and the flushed bit planes: byte-equal (numpy on both
  sides).
- `refine_depths`: equal.
- `select_topk_scores` against the reference's `_select_topk`: equal ids
  and equal scores (a selection moves values, it computes none), on
  integer scores full of ties, masked rows, both modes, and a matrix of
  80 blocks where the block-max branch prunes.
- `binary_scan_candidates`, `binary_refine_candidates` and
  `binary_refine_rerank`: equal ids, scores allclose at rtol 1e-5, atol
  1e-3. The products are exact in f32 on both sides (bf16 queries times
  +-1 or int8 values) and only the summation order differs; an L2 score
  is |q|^2 - 2 q.v + |v|^2 with terms near 100 here, so a few f32 ulps
  of those move it by up to ~1e-4.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vearch_tpu.engine.types import MetricType as RefMetric  # noqa: E402
from vearch_tpu.index.int8_mirror import Int8Mirror as RefMirror  # noqa: E402
from vearch_tpu.index.int8_mirror import quantize_rows  # noqa: E402
from vearch_tpu.index.int8_mirror import quantize_rows_int4  # noqa: E402
from vearch_tpu.ops import binary_scan as ref_bin  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu.ops import perf_model as ref_perf  # noqa: E402
from vearch_tpu_torch.engine.types import MetricType  # noqa: E402
from vearch_tpu_torch.index.int8_mirror import Int8Mirror  # noqa: E402
from vearch_tpu_torch.ops import binary_scan as port_bin  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops import perf_model as port_perf  # noqa: E402

RTOL, ATOL = 1e-5, 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("d", [32, 100, 128])
def test_pack_sign_rows_byte_equal(d):
    rows = np.random.default_rng(d).standard_normal((300, d)).astype(
        np.float32)
    rows[:5] = 0.0  # all-zero rows: every bit 0, the scale floor
    for want, got in zip(ref_bin.pack_sign_rows(rows),
                         port_bin.pack_sign_rows(rows)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("d", [32, 100, 128])
def test_bit_plane_mirror_flush_byte_equal(d):
    rng = np.random.default_rng(7 + d)
    ref, port = RefMirror(d, storage="bits"), Int8Mirror(d, "bits", "cpu")
    for n in (700, 1, 900):  # appends across a capacity growth
        rows = rng.standard_normal((n, d)).astype(np.float32)
        ref.append(rows)
        port.append(rows)
        for want, got in zip(ref.flush(), port.flush()):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype
            assert got.shape == want.shape and got.shape[0] % 512 == 0
            assert got.numpy().tobytes() == want.tobytes()
    assert port.device_bytes() == ref.device_bytes()
    # rewritten rows (re-absorb from 0) reach the device copy
    rows = rng.standard_normal((100, d)).astype(np.float32)
    ref.append(rows, start=0)
    port.append(rows, start=0)
    assert port.flush()[0].numpy().tobytes() == \
        np.asarray(ref.flush()[0]).tobytes()


def test_int4_mirror_is_refused():
    """The int4 mirror is served now: an odd dimension is still refused,
    and an even one flushes the reference's bytes."""
    with pytest.raises(ValueError, match="even"):
        Int8Mirror(63, "int4", "cpu")
    rng = np.random.default_rng(64)
    ref, port = RefMirror(64, storage="int4"), Int8Mirror(64, "int4", "cpu")
    for n in (700, 900):
        rows = rng.standard_normal((n, 64)).astype(np.float32)
        ref.append(rows)
        port.append(rows)
    for want, got in zip(ref.flush(), port.flush()):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert port.device_bytes() == ref.device_bytes()


@pytest.mark.parametrize("k", [1, 10, 13, 64, 100, 1000])
def test_refine_depths_equal(k):
    for n in (1, 100, 127, 128, 500, 512, 4096, 10 ** 6):
        assert port_perf.refine_depths(k, n) == ref_perf.refine_depths(k, n)


def test_unpack_bits_pm1_equal():
    planes = np.random.default_rng(3).integers(0, 256, (50, 13)).astype(
        np.uint8)
    want = np.asarray(ref_bin.unpack_bits_pm1(jnp.asarray(planes)))
    got = port_bin.unpack_bits_pm1(_t(planes))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def _tie_scores(b, n, seed, masked=0.0):
    """Integer scores in 0..4 (ties everywhere), a share of them -inf."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, (b, n)).astype(np.float32)
    s[rng.random((b, n)) < masked] = -np.inf
    return s


SELECT_CASES = {
    # name: (scores, r, topk_mode)
    "ties_exact": (_tie_scores(5, 8 * 512, 1), 37, "exact"),
    "ties_auto": (_tie_scores(5, 8 * 512, 2), 100, "auto"),
    "ties_blockmax": (_tie_scores(5, 8 * 512, 3), 64, "blockmax"),
    "masked_blockmax": (_tie_scores(4, 8 * 512, 4, masked=0.97), 200,
                        "blockmax"),
    "all_masked_exact": (np.full((2, 8 * 512), -np.inf, np.float32), 16,
                         "exact"),
    "normal_blockmax": (np.random.default_rng(5).standard_normal(
        (6, 8 * 512)).astype(np.float32) * 30, 128, "blockmax"),
    # 80 blocks, 72 selected: the block-max branch really prunes
    "prune80_auto": (np.random.default_rng(6).standard_normal(
        (3, 80 * 512)).astype(np.float32) * 30, 8, "auto"),
    "prune80_ties": (_tie_scores(3, 80 * 512, 7, masked=0.5), 40,
                     "blockmax"),
    "not_block_aligned": (_tie_scores(3, 1000, 8), 20, "blockmax"),
}


@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_topk_scores_matches_reference(name):
    scores, r, mode = SELECT_CASES[name]
    ws, wi = ref_ivf._select_topk(jnp.asarray(scores), r, mode)
    gs, gi = port_ivf.select_topk_scores(_t(scores), r, mode)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def _chain_case(d, metric_name, seed, n=8 * 512 - 300, b=6, masked=0.2):
    """A bit-plane mirror and an int8 mirror of the same rows (padded to
    the 512-row capacity), the raw rows, queries near rows, a mask."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((20, d)).astype(np.float32) * 2
    rows = (centers[rng.integers(0, 20, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    if metric_name == "IP":
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    cap = -(-n // 512) * 512

    def pad(a):
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out

    planes, p_scale, p_vsq = (pad(a) for a in ref_bin.pack_sign_rows(rows))
    a8, m_scale, m_vsq = (pad(a) for a in quantize_rows(rows))
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) >= masked
    q = rows[rng.choice(n, b, replace=False)] + 0.05 * rng.standard_normal(
        (b, d)).astype(np.float32)
    base = pad(rows)
    base_sq = np.sum(base * base, axis=1).astype(np.float32)
    return (q, planes, p_scale, p_vsq, a8, m_scale, m_vsq, valid, base,
            base_sq)


CHAIN = [(64, "L2", 11), (64, "IP", 12), (100, "L2", 13), (16, "IP", 14)]


def _metrics(name):
    return ((RefMetric.L2, MetricType.L2) if name == "L2"
            else (RefMetric.INNER_PRODUCT, MetricType.INNER_PRODUCT))


def _same(want, got):
    ws, wi = (np.asarray(x) for x in want)
    gs, gi = (x.numpy() for x in got)
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d,metric,seed", CHAIN)
@pytest.mark.parametrize("mode", ["exact", "blockmax"])
def test_binary_scan_candidates_match_reference(d, metric, seed, mode):
    q, planes, ps, pv, *_rest = _chain_case(d, metric, seed)
    valid = _rest[3]
    rm, pm = _metrics(metric)
    want = ref_bin.binary_scan_candidates(
        jnp.asarray(q), jnp.asarray(planes), jnp.asarray(ps),
        jnp.asarray(pv), jnp.asarray(valid), 300, rm, mode)
    got = port_bin.binary_scan_candidates(
        _t(q), _t(planes), _t(ps), _t(pv), _t(valid), 300, pm, mode)
    _same(want, got)
    assert not set(got[1].numpy().ravel()) & set(np.flatnonzero(~valid))


@pytest.mark.parametrize("d,metric,seed", CHAIN)
def test_binary_refine_candidates_match_reference(d, metric, seed):
    arrays = _chain_case(d, metric, seed)[:8]
    rm, pm = _metrics(metric)
    want = ref_bin.binary_refine_candidates(
        *(jnp.asarray(a) for a in arrays), 512, 96, rm, "blockmax")
    got = port_bin.binary_refine_candidates(
        *(_t(a) for a in arrays), 512, 96, pm, "blockmax")
    _same(want, got)


@pytest.mark.parametrize("d,metric,seed", CHAIN)
@pytest.mark.parametrize("r0,r1", [(512, 128), (1024, 256), (40, 12)])
def test_binary_refine_rerank_matches_reference(d, metric, seed, r0, r1):
    arrays = _chain_case(d, metric, seed)
    rm, pm = _metrics(metric)
    want = ref_bin.binary_refine_rerank(
        *(jnp.asarray(a) for a in arrays), r0, r1, 10, scan_metric=rm,
        rerank_metric=rm)
    got = port_bin.binary_refine_rerank(
        *(_t(a) for a in arrays), r0, r1, 10, scan_metric=pm,
        rerank_metric=pm)
    _same(want, got)


def test_int4_stage1_is_refused():
    """Stage 1 over an int4 mirror is served now: equal to the
    reference's on the same packed rows."""
    arrays = list(_chain_case(64, "L2", 15)[:8])
    raw = arrays[4].astype(np.float32) * arrays[5][:, None]
    packed, m_scale, m_vsq = quantize_rows_int4(raw)
    arrays[4:7] = packed, m_scale, m_vsq
    want = ref_bin.binary_refine_candidates(
        *(jnp.asarray(a) for a in arrays), 512, 96, RefMetric.L2,
        "blockmax", "int4")
    got = port_bin.binary_refine_candidates(
        *(_t(a) for a in arrays), 512, 96, MetricType.L2, "blockmax",
        "int4")
    _same(want, got)


def test_refine_counters_count_rows_per_stage():
    before_n = port_bin.refine_search_counts()
    before = port_bin.refine_stage_rows()
    port_bin.note_refine_search("fused", 4096, 819, 256, 10, 8)
    port_bin.note_refine_search("fused", 4096, 1024, 256, 10, 2)
    after = port_bin.refine_stage_rows()
    assert port_bin.refine_search_counts()["fused"] == before_n["fused"] + 2
    assert after["binary"] - before["binary"] == 4096 * 10
    assert after["int8"] - before["int8"] == 819 * 8 + 1024 * 2
    assert after["exact"] - before["exact"] == 256 * 10
    assert set(port_bin.refine_search_counts()) == set(ref_bin.REFINE_PATHS)
    assert port_bin.REFINE_STAGES == ref_bin.REFINE_STAGES
