"""The port's block-max int8 scan (vearch_tpu_torch/ops/blockmax_scan.py)
against the reference: `int8_blockmax_scan_pallas` run in interpret mode,
exactly as tests/test_pallas_blockmax.py runs it, and the XLA path
`int8_scan_candidates(..., "blockmax")`. Same cases as that file.

On the CPU the port's stage 1 is its plain PyTorch version; the Hopper
kernel itself needs a card (tests/test_torch_blockmax_cuda.py).

Tolerances:
- candidate ids are equal;
- scores are allclose at rtol 1e-5, atol 1e-4 — the products are exact
  (bf16 x int8 in f32) and only the summation order differs;
- stage-1 block maxima are within one bf16 ulp of a numpy version that
  rounds with ml_dtypes.bfloat16: a sum that lands next to a bf16
  rounding boundary may round either way under another summation order.

Which cases could be affected by bf16 rounding: XLA on the CPU may fold
the reference's f32->bf16->f32 round trip of the block maxima away, while
the port always rounds (the TPU's semantics). Rounding can only change
*which blocks are selected*, and only when fewer blocks are selected than
exist. In every case below except `prune` all blocks are selected
(nb_sel = min(2*max(32, r/4)+8, nblk) = nblk), so selection cannot be
affected; in `prune` (79 blocks, 72 selected) the top-8 rows lie far
inside the selected blocks, and the id equality holds there too.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vearch_tpu.engine.types import MetricType as RefMetric  # noqa: E402
from vearch_tpu.ops import ivf as ref_ivf  # noqa: E402
from vearch_tpu.ops.pallas_kernels import (  # noqa: E402
    int8_blockmax_scan_pallas,
)
from vearch_tpu_torch.engine.types import MetricType  # noqa: E402
from vearch_tpu_torch.ops import blockmax_scan as bms  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402

D = 64
N = 4096


def _mirror_arrays(n=N, d=D, seed=9):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    scale = np.maximum(np.abs(base).max(axis=1) / 127.0, 1e-12)
    q8 = np.clip(np.rint(base / scale[:, None]), -127, 127).astype(np.int8)
    deq = q8.astype(np.float32) * scale[:, None]
    vsq = np.sum(deq * deq, axis=1).astype(np.float32)
    return q8, scale.astype(np.float32), vsq, base


def _case(name):
    """(queries, q8, scale, vsq, valid, r, l2) of one named case."""
    if name in ("l2", "ip"):
        q8, scale, vsq, _ = _mirror_arrays()
        queries = np.random.default_rng(1).standard_normal(
            (7, D)).astype(np.float32)
        return queries, q8, scale, vsq, np.ones(N, bool), 64, name == "l2"
    if name in ("mask", "all_masked"):
        q8, scale, vsq, _ = _mirror_arrays()
        queries = np.random.default_rng(2).standard_normal(
            (4, D)).astype(np.float32)
        valid = np.ones(N, bool)
        valid[::3] = False
        if name == "all_masked":
            return queries, q8, scale, vsq, np.zeros(N, bool), 8, True
        return queries, q8, scale, vsq, valid, 32, True
    if name == "rows2560":
        q8, scale, vsq, base = _mirror_arrays(n=2560, seed=4)
        rng = np.random.default_rng(6)
        queries = base[rng.choice(2560, 6, replace=False)] + 0.01
        return queries, q8, scale, vsq, np.ones(2560, bool), 32, True
    if name in ("d100_l2", "d100_ip"):
        q8, scale, vsq, base = _mirror_arrays(n=2048, d=100, seed=17)
        rng = np.random.default_rng(18)
        queries = base[rng.choice(2048, 5, replace=False)] + 0.01
        return (queries, q8, scale, vsq, np.ones(2048, bool), 16,
                name == "d100_l2")
    if name == "b70":
        q8, scale, vsq, _ = _mirror_arrays(seed=19)
        queries = np.random.default_rng(20).standard_normal(
            (70, D)).astype(np.float32)
        return queries, q8, scale, vsq, np.ones(N, bool), 48, True
    if name == "prune":
        n = 79 * 512
        q8, scale, vsq, base = _mirror_arrays(n=n, d=16, seed=12)
        rng = np.random.default_rng(13)
        queries = base[rng.choice(n, 3, replace=False)] + 0.01
        return queries, q8, scale, vsq, np.ones(n, bool), 8, True
    raise KeyError(name)


CASES = ["l2", "ip", "mask", "all_masked", "rows2560", "d100_l2", "d100_ip",
         "b70", "prune"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", CASES)
def test_port_blockmax_matches_reference(name):
    queries, q8, scale, vsq, valid, r, l2 = _case(name)
    queries = np.asarray(queries, np.float32)
    ref_args = (jnp.asarray(queries), jnp.asarray(q8), jnp.asarray(scale),
                jnp.asarray(vsq), jnp.asarray(valid))
    ps, pi = int8_blockmax_scan_pallas(*ref_args, r, l2,
                                       interpret_override=True)
    xs, xi = ref_ivf.int8_scan_candidates(
        *ref_args, r, RefMetric.L2 if l2 else RefMetric.INNER_PRODUCT,
        "blockmax")
    port_args = (_t(queries), _t(q8), _t(scale), _t(vsq), _t(valid))
    ts, ti = bms.int8_blockmax_scan(*port_args, r, l2)
    us, ui = port_ivf.int8_scan_candidates(
        *port_args, r, MetricType.L2 if l2 else MetricType.INNER_PRODUCT,
        "blockmax")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(ui.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(ti.numpy(), ui.numpy())
    fin = np.isfinite(np.asarray(ps))
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
    np.testing.assert_allclose(ts.numpy()[fin], np.asarray(ps)[fin],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(us.numpy()[fin], np.asarray(xs)[fin],
                               rtol=1e-5, atol=1e-4)
    if name == "all_masked":
        assert (ti.numpy() == -1).all()
    if name == "mask":
        got = ti.numpy()
        assert (got[got >= 0] % 3 != 0).all()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("name", ["l2", "ip", "mask", "all_masked",
                                  "d100_l2", "prune"])
def test_port_stage1_rounds_through_bf16(name):
    """The port's stage 1 against numpy with explicit ml_dtypes bf16
    rounding (the reference's semantics on the TPU)."""
    queries, q8, scale, vsq, valid, _r, l2 = _case(name)
    queries = np.asarray(queries, np.float32)
    qb = queries.astype(ml_dtypes.bfloat16).astype(np.float32)
    dots = (qb @ q8.astype(np.float32).T) * scale[None, :]
    qsq = np.sum(queries * queries, axis=1)
    scores = -(qsq[:, None] - 2.0 * dots + vsq[None, :]) if l2 else dots
    scores = np.where(valid[None, :], scores, np.float32(-3.4e38))
    b, n = scores.shape
    want = scores.reshape(b, n // 512, 512).max(axis=2).astype(
        ml_dtypes.bfloat16).astype(np.float32)
    got = bms.int8_blockmax_stage1(
        _t(queries).to(torch.bfloat16), _t(q8), _t(scale), _t(vsq),
        _t(valid), _t(qsq), l2).numpy()
    # every value is a bf16 value
    np.testing.assert_array_equal(
        got, got.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= _bf16_ulp(want[fin])).all()


def test_stage1_wrapper_rejects_bad_input():
    queries, q8, scale, vsq, valid, _r, _l2 = _case("l2")
    qb = _t(queries).to(torch.bfloat16)
    qsq = _t(np.sum(queries * queries, axis=1))
    with pytest.raises(ValueError):
        bms.int8_blockmax_stage1(qb.float(), _t(q8), _t(scale), _t(vsq),
                                 _t(valid), qsq, True)
    with pytest.raises(ValueError):
        bms.int8_blockmax_stage1(qb, _t(q8[:1000]), _t(scale[:1000]),
                                 _t(vsq[:1000]), _t(valid[:1000]), qsq, True)
    with pytest.raises(ValueError):
        bms.int8_blockmax_stage1(qb, _t(q8), _t(scale), _t(vsq),
                                 _t(valid), qsq[:2], True)


@pytest.mark.parametrize("b,d,want", [
    (1, 128, 8), (8, 30, 8), (9, 128, 64), (64, 100, 64), (70, 64, 128),
    (1024, 128, 128), (1024, 1600, 64), (300, 12800, 8)])
def test_query_tile_width(b, d, want):
    """The kernel's query tile: the narrowest wgmma N that holds the
    batch, narrowed while the bf16 tile (d rounded up to 64) would pass
    the kernel's shared-memory budget."""
    n = bms.query_tile(b, d)
    assert n == want
    assert n * (-(-d // 64) * 64) * 2 <= bms.MAX_QUERY_SMEM


def test_query_tile_refuses_a_d_past_the_budget():
    with pytest.raises(ValueError):
        bms.query_tile(1, 12864)
