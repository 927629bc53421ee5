"""The port's block-max int8 scan (vearch_tpu_torch/ops/blockmax_scan.py)
against the reference: `int8_blockmax_scan_pallas` run in interpret mode,
exactly as tests/test_pallas_blockmax.py runs it, and the XLA path
`int8_scan_candidates(..., "blockmax")`. Same cases as that file.

On the CPU the port's stages 1 and 2 are their plain PyTorch versions;
the Hopper kernels themselves need a card
(tests/test_torch_blockmax_cuda.py). What surrounds the stage-2 kernel
is plain PyTorch and is tested here: the slot and tile maps it reads,
and the top-r and id mapping over the layout it writes.

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
from vearch_tpu_torch.ops.distance import (  # noqa: E402
    NEG_INF,
    sqnorms,
    stable_topk,
)

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


def _distinct_blocks(rng, b, nblk, nb_sel):
    """[b, nb_sel] int64: each row nb_sel distinct blocks, in random
    order (a stable top-k's indices are distinct, in score order)."""
    return torch.from_numpy(np.stack(
        [rng.permutation(nblk)[:nb_sel] for _ in range(b)]).astype(np.int64))


@pytest.mark.parametrize("b,nblk,nb_sel,n_tile", [
    (1, 1954, 264, 8), (7, 8, 8, 8), (70, 40, 13, 128), (130, 79, 72, 64),
    (300, 600, 40, 128)])
def test_stage2_maps_invert_the_selection(b, nblk, nb_sel, n_tile):
    """The stage-2 kernel's slot map against a brute-force inversion of
    random selections: entry (block, query) is the block's place in the
    query's list or -1; the tile map is 1 exactly where some query of the
    n_tile-wide tile selected the block."""
    top = _distinct_blocks(np.random.default_rng(b + nblk), b, nblk, nb_sel)
    slots, active = bms.stage2_maps(top, nblk, n_tile)
    want = np.full((nblk, b), -1, np.int32)
    want_active = np.zeros((-(-b // n_tile), nblk), np.uint8)
    for q in range(b):
        for i, blk in enumerate(top[q].tolist()):
            want[blk, q] = i
            want_active[q // n_tile, blk] = 1
    assert slots.dtype == torch.int32 and active.dtype == torch.uint8
    np.testing.assert_array_equal(slots.numpy(), want)
    np.testing.assert_array_equal(active.numpy(), want_active)


@pytest.mark.parametrize("name", CASES)
def test_stage2_topk_reads_the_kernel_layout(name):
    """The stage-2 kernel's output layout, built on the CPU from the
    plain formula (entry (q, i*512 + o): row o of block top_blocks[q, i]),
    through the wrapper's top-r and id mapping, gives the plain stage 2's
    candidates: ids equal, scores within the file's f32 tolerance (the
    products are exact; only the summation order differs)."""
    queries, q8, scale, vsq, valid, r, l2 = _case(name)
    q = _t(np.asarray(queries, np.float32))
    a8, sc, vs, va = _t(q8), _t(scale), _t(vsq), _t(valid)
    n_pad = a8.shape[0]
    nblk = n_pad // 512
    qsq = sqnorms(q)
    bmax = bms.int8_blockmax_stage1(q.to(torch.bfloat16), a8, sc, vs, va,
                                    qsq, l2)
    nb_sel = min(2 * max(32, min(r, n_pad) // 4) + 8, nblk)
    rr = min(r, nb_sel * 512)
    _, top = stable_topk(bmax, nb_sel)
    rows = (top[:, :, None] * 512 + torch.arange(512)).reshape(len(q), -1)
    dots = torch.gather(q.to(torch.bfloat16).float() @ a8.float().T, 1,
                        rows) * sc[rows]
    scores = -(qsq[:, None] - 2.0 * dots + vs[rows]) if l2 else dots
    scores = torch.where(va[rows], scores, torch.full_like(scores, NEG_INF))
    ks, ki = bms.stage2_topk(scores, top, rr)
    ps, pi = bms.blockmax_stage2_reference(q, a8, sc, vs, va, bmax, nb_sel,
                                           rr, l2)
    np.testing.assert_array_equal(ki.numpy(), pi.numpy())
    fin = np.isfinite(ps.numpy())
    np.testing.assert_array_equal(np.isfinite(ks.numpy()), fin)
    np.testing.assert_allclose(ks.numpy()[fin], ps.numpy()[fin],
                               rtol=1e-5, atol=1e-4)
    assert (ki.numpy()[~fin] == -1).all()


def test_stage2_kernel_wrapper_needs_cuda():
    """On the CPU, stage 2 runs the plain version; the kernel's own
    wrapper refuses a CPU tensor rather than fall back."""
    queries, q8, scale, vsq, valid, _r, _l2 = _case("l2")
    top = _distinct_blocks(np.random.default_rng(0), len(queries), 8, 8)
    with pytest.raises(ValueError):
        bms.blockmax_stage2_rescore(
            _t(queries).to(torch.bfloat16), _t(q8), _t(scale), _t(vsq),
            _t(valid), _t(np.sum(queries * queries, axis=1)), top, True)
