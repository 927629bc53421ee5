"""The port's mesh layer (vearch_tpu_torch/parallel/, FLAT_SHARDED, the
mesh branches of IVFPQ and IVFRABITQ) held against vearch_tpu's on the
CPU: the counterparts of tests/test_parallel.py and
tests/test_mesh_serving.py.

The reference runs as its own tests run it, on conftest's eight virtual
JAX CPU devices. The port's meshes see eight virtual CPU devices too
(`parallel/mesh.set_virtual_device_count(8)`, set by a fixture for each
test and cleared after it). Its "auto" counts physical devices, so every
mesh case here asks for `mesh_serving: "on"` explicitly.

The reference trains; its `dump_state()` goes through
`vearch_tpu_torch.convert` into the port's indexes, which re-absorb the
same rows. Then:
- the port's mesh path returns the ids of the port's single-device path
  and scores equal bit for bit (what the reference asserts of its own
  two paths), except on the 2x4 mesh, whose narrower data axis reshapes
  the shards' products: ids equal, scores allclose at rtol 1e-5, as the
  reference allows itself;
- the port's mesh path returns the reference mesh path's ids, scores
  allclose at rtol 1e-5, atol 1e-3 (exact products in another summation
  order, on L2 scores whose terms are near 60);
- FLAT_SHARDED equals FLAT to atol 1e-5 (cosine: a row-normalized IP
  against FLAT's division; ids equal);
- one sharded k-means step's summed partial statistics equal the
  reference's from the same centroids (allclose, rtol 1e-5, atol 1e-3:
  f32 sums over up to 3000 rows in another order); training itself is
  held to its objective (ROADMAP's parity rule: the init draws from a
  torch generator, not JAX's PRNG).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.raw_vector import RawVectorStore as RefStore  # noqa: E402
from vearch_tpu.index.binary import IVFRaBitQIndex as RefRaBitQ  # noqa: E402
from vearch_tpu.index.flat import FlatIndex as RefFlat  # noqa: E402
from vearch_tpu.index.ivf import IVFPQIndex as RefIVFPQ  # noqa: E402
from vearch_tpu.index.scann import ScannIndex as RefScann  # noqa: E402
from vearch_tpu.index.sharded_flat import ShardedFlatIndex as RefShardedFlat  # noqa: E402
from vearch_tpu.ops import kmeans as ref_km  # noqa: E402
from vearch_tpu.parallel import mesh as ref_mesh  # noqa: E402
from vearch_tpu.parallel import sharded as ref_sharded  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.engine.raw_vector import RawVectorStore  # noqa: E402
from vearch_tpu_torch.index import registry  # noqa: E402
from vearch_tpu_torch.index.binary import IVFRaBitQIndex  # noqa: E402
from vearch_tpu_torch.index.flat import FlatIndex  # noqa: E402
from vearch_tpu_torch.index.ivf import IVFPQIndex  # noqa: E402
from vearch_tpu_torch.index.scann import ScannIndex  # noqa: E402
from vearch_tpu_torch.index.sharded_flat import ShardedFlatIndex  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops import kmeans as km  # noqa: E402
from vearch_tpu_torch.ops import perf_model  # noqa: E402
from vearch_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from vearch_tpu_torch.parallel import sharded  # noqa: E402

D, N = 32, 3000
RTOL, ATOL = 1e-5, 1e-3
DOC = perf_model.DOCUMENTED_DISPATCHES
PQ = {"ncentroids": 16, "nsubvector": 8, "train_iters": 4}


@pytest.fixture(autouse=True)
def eight_devices():
    mesh_lib.set_virtual_device_count(8)
    yield
    mesh_lib.set_virtual_device_count(None)


def _data(seed=1234, n=N):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def _ref_index(cls, data, params, metric="L2"):
    store = RefStore(D)
    store.add(data)
    idx = cls(rt.IndexParams(cls.__name__, rt.MetricType(metric), params),
              store)
    idx.train(data[:2000])
    idx.absorb(data.shape[0])
    return idx


def _port_index(cls, data, params, state, metric="L2"):
    store = RawVectorStore(D, device="cpu")
    store.add(data)
    idx = cls(pt.IndexParams(cls.__name__, pt.MetricType(metric), params),
              store)
    idx.load_state(index_state_from_reference(state))
    return idx


def _trio(data, extra=None, metric="L2", ref_cls=RefIVFPQ,
          port_cls=IVFPQIndex, base=PQ):
    """The reference's mesh index and the port's mesh and single-device
    indexes, all three on the reference's trained state."""
    params = dict(base, **(extra or {}))
    ref = _ref_index(ref_cls, data, dict(params, mesh_serving="on"), metric)
    state = ref.dump_state()
    mesh = _port_index(port_cls, data, dict(params, mesh_serving="on"),
                       state, metric)
    single = _port_index(port_cls, data, dict(params, mesh_serving="off"),
                         state, metric)
    return ref, mesh, single


def _ledger(fn):
    led: list = []
    port_ivf.set_dispatch_ledger(led)
    try:
        out = fn()
    finally:
        port_ivf.set_dispatch_ledger(None)
    return out, led


def _bit_equal(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def _like_ref(port, ref):
    np.testing.assert_array_equal(port[1], np.asarray(ref[1]))
    np.testing.assert_allclose(port[0], np.asarray(ref[0]), rtol=RTOL,
                               atol=ATOL)


# -- the mesh itself ------------------------------------------------------------

def test_mesh_construction_cached_per_device_count():
    mk = mesh_lib.make_mesh
    assert mk(4, device_type="cpu") is mk(4, device_type="cpu")
    assert mk(8, device_type="cpu") is mesh_lib.default_mesh("cpu")
    assert mk(8, query_axis=2, device_type="cpu") is \
        mk(8, query_axis=2, device_type="cpu")
    assert mk(4, device_type="cpu") is not mk(8, device_type="cpu")
    assert mesh_lib.mesh_from_shape("4x2", "cpu") is \
        mk(8, data_axis=4, query_axis=2, device_type="cpu")
    assert mesh_lib.mesh_from_shape((4, 2), "cpu") is \
        mesh_lib.mesh_from_shape("4x2", "cpu")
    for alias in (None, "", "auto", "default", 8):
        assert mesh_lib.mesh_from_shape(alias, "cpu") is \
            mesh_lib.default_mesh("cpu")
    m = mesh_lib.mesh_from_shape("2x4", "cpu")
    assert (m.shape["data"], m.shape["query"], m.size) == (2, 4, 8)
    assert m.devices[1][3] == torch.device("cpu")
    # the virtual count is what a mesh sees, not what "auto" counts
    assert len(mesh_lib.visible_devices("cpu")) == 8
    assert mesh_lib.physical_device_count("cpu") == 1
    mesh_lib.set_virtual_device_count(None)
    assert mesh_lib.default_mesh("cpu").size == 1


def test_shard_rows_pads_and_places():
    mesh = mesh_lib.make_mesh(8, device_type="cpu")
    x = np.arange(1003 * 2, dtype=np.float32).reshape(1003, 2)
    arr, n = mesh_lib.shard_rows(mesh, x, pad_value=-1)
    ref_arr, ref_n = ref_mesh.shard_rows(ref_mesh.make_mesh(8), x,
                                         pad_value=-1)
    assert n == ref_n == 1003 and arr.shape == ref_arr.shape == (1008, 2)
    np.testing.assert_array_equal(
        torch.cat(arr.parts).numpy(), np.asarray(ref_arr))
    q, b = mesh_lib.shard_queries(mesh_lib.make_mesh(
        8, query_axis=2, device_type="cpu"), x[:3])
    assert b == 3 and q.shape == (4, 2) and len(q.parts) == 2


# -- IVFPQ over the mesh --------------------------------------------------------

@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_mesh_ivfpq_matches_reference_and_single(storage):
    data = _data()
    ref, mesh, single = _trio(data, {"mirror_dtype": storage})
    q = np.random.default_rng(5).standard_normal((4, D)).astype(np.float32)
    got, led = _ledger(lambda: mesh.search(q, 10, None))
    assert led == DOC["ivfpq_mesh_fused"]
    _bit_equal(got, single.search(q, 10, None))
    _like_ref(got, ref.search(q, 10, None))


def test_mesh_ivfpq_through_absorb():
    """Tail-appends land the rows a full placement would: equal to the
    single-device path and the reference after every absorb round."""
    data = _data()
    ref, mesh, single = _trio(data)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((4, D)).astype(np.float32)
    for _ in range(3):
        more = rng.standard_normal((500, D)).astype(np.float32)
        for idx in (ref, mesh, single):
            idx.store.add(more)
            idx.absorb(idx.store.count)
        got = mesh.search(q, 10, None)
        _bit_equal(got, single.search(q, 10, None))
        _like_ref(got, ref.search(q, 10, None))
    assert mesh._mirror._sh_cache.stats["appends"] >= 1


def test_mesh_deletion_mask_across_shards():
    data = _data()
    ref, mesh, single = _trio(data)
    q = np.random.default_rng(9).standard_normal((4, D)).astype(np.float32)
    _, top = single.search(q, 20, None)
    dead = sorted({int(i) for i in top[:, :8].ravel() if i >= 0})
    mask = np.ones(N, dtype=bool)
    mask[dead] = False
    got = mesh.search(q, 10, mask)
    _bit_equal(got, single.search(q, 10, mask))
    _like_ref(got, ref.search(q, 10, mask))
    assert not set(dead) & {int(i) for i in got[1].ravel()}
    # a device mask (the engine's cached alive mask) shards the same way
    _bit_equal(mesh.search(q, 10, torch.from_numpy(mask)), got)


@pytest.mark.parametrize("params,path", [
    ({"mesh_nprobe": 8}, "ivfpq_mesh_fused"),
    ({"scan_mode": "probe", "nprobe": 8}, "ivfpq_mesh_probe"),
    ({"scan_mode": "probe", "nprobe": 8, "mesh_shape": "4x2"},
     "ivfpq_mesh_probe"),
])
def test_mesh_probe_gate_matches_reference(params, path):
    """The probe gate masks the docid-ordered mirror to the probed cells
    inside the fused program: ids equal to the reference's gate."""
    data = _data()
    ref, mesh, _ = _trio(data)
    q = np.random.default_rng(11).standard_normal((8, D)).astype(np.float32)
    got, led = _ledger(lambda: mesh.search(q, 10, None, params))
    assert led == DOC[path]
    _like_ref(got, ref.search(q, 10, None, params))
    full = mesh.search(q, 10, None, {"scan_mode": "full"})[1]
    overlap = np.mean([len(set(full[r]) & set(got[1][r])) / 10
                       for r in range(8)])
    assert overlap >= 0.7, overlap


@pytest.mark.parametrize("shape", ["4x2", "4x1", "2x4"])
def test_mesh_query_axis(shape):
    data = _data()
    ref, mesh, _ = _trio(data)
    rng = np.random.default_rng(13)
    for rows in (8, 3):  # 3 pads the query axis
        q = rng.standard_normal((rows, D)).astype(np.float32)
        base = mesh.search(q, 10, None, {"scan_mode": "full"})
        got = mesh.search(q, 10, None,
                          {"scan_mode": "full", "mesh_shape": shape})
        np.testing.assert_array_equal(got[1], base[1])
        if shape == "2x4":
            np.testing.assert_allclose(got[0], base[0], rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[0], base[0])
        _like_ref(got, ref.search(q, 10, None,
                                  {"scan_mode": "full", "mesh_shape": shape}))


def test_mesh_unfused_and_scan_only_paths():
    data = _data()
    ref, mesh, single = _trio(data)
    q = np.random.default_rng(15).standard_normal((4, D)).astype(np.float32)
    p = {"scan_mode": "full", "fused_rerank": False}
    got, led = _ledger(lambda: mesh.search(q, 10, None, p))
    assert led == DOC["ivfpq_mesh_unfused"]
    _bit_equal(got, single.search(q, 10, None, p))
    _like_ref(got, ref.search(q, 10, None, p))
    # SCANN with reordering off: the quantized scores, one dispatch
    extra = {"reordering": False}
    sref = _ref_index(RefScann, data, dict(PQ, mesh_serving="on", **extra),
                      "InnerProduct")
    sport = _port_index(ScannIndex, data, dict(PQ, mesh_serving="on",
                                               **extra),
                        sref.dump_state(), "InnerProduct")
    got, led = _ledger(lambda: sport.search(q, 10, None,
                                            {"scan_mode": "full"}))
    assert led == DOC["ivfpq_mesh_scan"]
    _like_ref(got, sref.search(q, 10, None, {"scan_mode": "full"}))


def test_mesh_full_scan_cliff_scales_with_data_axis():
    data = _data()
    ref, mesh, _ = _trio(data, {"full_scan_limit": 500})
    q = np.random.default_rng(17).standard_normal((4, D)).astype(np.float32)
    # 8x1: 500 * 8 >= 3000 rows stays full; 2x4: 500 * 2 < 3000 -> probe
    assert _ledger(lambda: mesh.search(q, 10, None))[1] == \
        DOC["ivfpq_mesh_fused"]
    assert _ledger(lambda: mesh.search(
        q, 10, None, {"mesh_shape": "2x4"}))[1] == DOC["ivfpq_mesh_probe"]


def test_mesh_pallas_flag_keeps_single_device_path():
    data = _data()
    _, mesh, single = _trio(data)
    q = np.random.default_rng(19).standard_normal((4, D)).astype(np.float32)
    p = {"scan_kernel": "pallas"}
    got, led = _ledger(lambda: mesh.search(q, 10, None, p))
    assert led == DOC["ivfpq_full_pallas"]
    _bit_equal(got, single.search(q, 10, None, p))


def test_auto_stays_off_on_one_physical_device():
    data = _data(n=600)
    store = RawVectorStore(D, device="cpu")
    store.add(data)
    idx = IVFPQIndex(pt.IndexParams("IVFPQ", pt.MetricType.L2, PQ), store)
    assert idx.mesh_serving == "auto" and not idx.data_parallel
    assert idx.mesh_info() is None
    idx.train(data)
    idx.absorb(600)
    _, led = _ledger(lambda: idx.search(data[:2], 5, None))
    assert led == DOC["ivfpq_full_fused"]


def test_mesh_serving_config_validation():
    store = RawVectorStore(D, device="cpu")
    with pytest.raises(ValueError, match="mesh_serving"):
        IVFPQIndex(pt.IndexParams("IVFPQ", pt.MetricType.L2, dict(
            PQ, mesh_serving="sideways")), store)
    assert IVFPQIndex(pt.IndexParams("IVFPQ", pt.MetricType.L2, dict(
        PQ, mesh_serving=True)), store).data_parallel
    assert not IVFPQIndex(pt.IndexParams("IVFPQ", pt.MetricType.L2, dict(
        PQ, data_parallel=False)), store).data_parallel


# -- placement ------------------------------------------------------------------

def test_absorb_tail_appends_per_shard():
    """Within the placed capacity an absorb copies exactly the
    align-rounded window of new rows; the rebuild count stays."""
    data = _data()
    _, mesh, _ = _trio(data)
    q = data[:2]
    mesh.search(q, 10, None)
    stats = mesh._mirror._sh_cache.stats
    rebuilds, bytes0, rows0 = stats["rebuilds"], stats["h2d_bytes"], N
    mesh.store.add(_data(seed=3, n=500))
    mesh.absorb(rows0 + 500)
    mesh.search(q, 10, None)
    assert stats["rebuilds"] == rebuilds and stats["appends"] >= 1
    lo, hi = (rows0 // 512) * 512, -(-(rows0 + 500) // 512) * 512
    assert stats["h2d_bytes"] - bytes0 == (hi - lo) * (D + 8)


def test_flat_sharded_absorb_appends():
    data = _data(n=2000)
    store = RawVectorStore(D, device="cpu")
    store.add(data)
    idx = ShardedFlatIndex(pt.IndexParams("FLAT_SHARDED", pt.MetricType.L2),
                           store)
    idx.absorb(2000)
    q = data[:2]
    idx.search(q, 5, None)
    store.add(_data(seed=4, n=200))
    idx.absorb(2200)
    idx.search(q, 5, None)
    rebuilds = idx.placement_stats()["rebuilds"]
    bytes0 = idx.placement_stats()["h2d_bytes"]
    store.add(_data(seed=5, n=200))
    idx.absorb(2400)
    _, ids = idx.search(store.host_view()[2300:2302], 1, None)
    assert list(ids[:, 0]) == [2300, 2301]
    stats = idx.placement_stats()
    assert stats["rebuilds"] == rebuilds and stats["appends"] >= 1
    lo, hi = (2200 // 128) * 128, -(-2400 // 128) * 128
    assert stats["h2d_bytes"] - bytes0 == (hi - lo) * (D * 4 + 4)


def test_per_device_footprint_divides_sharded_state():
    data = _data()
    _, mesh, single = _trio(data)
    mesh.search(data[:2], 10, None)
    per_dev = mesh.device_footprint_per_device_bytes()
    assert 0 < per_dev < mesh.device_footprint_bytes()
    assert single.device_footprint_per_device_bytes() == \
        single.device_footprint_bytes()
    info = mesh.mesh_info()
    assert (info["devices"], info["data_shards"], info["query_shards"]) == \
        (8, 8, 1)
    assert info["per_device_bytes"] == per_dev
    assert info["mirror_placement"]["rebuilds"] >= 1


# -- IVFRABITQ over the mesh ----------------------------------------------------

@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_mesh_three_stage_matches_reference(storage):
    data = _data()
    extra = {"topk_mode": "exact", "mirror_dtype": storage}
    ref, mesh, single = _trio(data, extra, ref_cls=RefRaBitQ,
                              port_cls=IVFRaBitQIndex,
                              base={"ncentroids": 16, "train_iters": 4})
    rng = np.random.default_rng(21)
    q = data[:8] + 0.01 * rng.standard_normal((8, D)).astype(np.float32)
    got, led = _ledger(lambda: mesh.search(q, 10, None))
    assert led == DOC["ivfrabitq_mesh_three_stage"]
    _like_ref(got, ref.search(q, 10, None))
    assert (got[1][:, 0] == np.arange(8)).all()
    # the chain is not the single-device one (each shard keeps its own
    # top-r0): held to the single path's recall, as the reference is
    solo = single.search(q, 10, None)[1]
    gt = np.argsort(((q[:, None, :].astype(np.float64)
                      - data[None].astype(np.float64)) ** 2).sum(-1),
                    axis=1)[:, :10]

    def rec(ids):
        return np.mean([len(set(ids[j]) & set(gt[j])) / 10 for j in range(8)])

    assert rec(got[1]) >= rec(solo) - 0.05 and rec(got[1]) >= 0.85
    assert mesh.device_footprint_per_device_bytes() < \
        mesh.device_footprint_bytes()


# -- FLAT_SHARDED -----------------------------------------------------------------

@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_flat_sharded_matches_flat_and_reference(metric):
    data = _data(n=2000)
    q = np.random.default_rng(23).standard_normal((3, D)).astype(np.float32)

    def port(cls, itype):
        store = RawVectorStore(D, device="cpu")
        store.add(data)
        idx = cls(pt.IndexParams(itype, pt.MetricType(metric)), store)
        idx.absorb(2000)
        return idx

    def ref(cls, itype):
        store = RefStore(D)
        store.add(data)
        idx = cls(rt.IndexParams(itype, rt.MetricType(metric)), store)
        idx.absorb(2000)
        return idx

    flat = port(FlatIndex, "FLAT").search(q, 10, None)
    got, led = _ledger(lambda: port(ShardedFlatIndex, "FLAT_SHARDED").search(
        q, 10, None))
    assert led == DOC["flat_sharded"]
    np.testing.assert_array_equal(got[1], flat[1])
    np.testing.assert_allclose(got[0], flat[0], atol=1e-5)
    _like_ref(got, ref(RefShardedFlat, "FLAT_SHARDED").search(q, 10, None))
    np.testing.assert_array_equal(
        got[1], ref(RefFlat, "FLAT").search(q, 10, None)[1])


def test_registry_resolves_flat_sharded():
    store = RawVectorStore(D, device="cpu")
    for params in (pt.IndexParams("FLAT_SHARDED"),
                   pt.IndexParams("FLAT", params={"sharded": True})):
        idx = registry.create_index(params, store)
        assert type(idx) is ShardedFlatIndex
        assert idx.mesh.size == 8
    assert "FLAT_SHARDED" in registry.registered_types()
    idx = registry.create_index(pt.IndexParams(
        "FLAT_SHARDED", params={"mesh_shape": "4x2"}), store)
    assert (idx.mesh.shape["data"], idx.mesh.shape["query"]) == (4, 2)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_flat_searcher_matches_reference(shape):
    rng = np.random.default_rng(25)
    base = rng.standard_normal((1003, 16)).astype(np.float32)
    queries = np.concatenate([base[:4], rng.standard_normal(
        (4, 16)).astype(np.float32)])
    mesh = mesh_lib.make_mesh(8, data_axis=shape[0], query_axis=shape[1],
                              device_type="cpu")
    got = sharded.ShardedFlatSearcher(mesh, base, store_dtype="float32") \
        .search(queries, 5)
    want = ref_sharded.ShardedFlatSearcher(
        ref_mesh.make_mesh(8, data_axis=shape[0], query_axis=shape[1]),
        base, store_dtype="float32").search(queries, 5)
    _like_ref(got, want)
    assert (got[1][:4, 0] == np.arange(4)).all() and (got[1] < 1003).all()


# -- sharded k-means ------------------------------------------------------------

def test_sharded_kmeans_step_matches_reference_partials():
    rng = np.random.default_rng(27)
    x = rng.standard_normal((3000, D)).astype(np.float32)
    cents = x[rng.choice(3000, 16, replace=False)]
    reseed = x[:16]
    mesh = mesh_lib.make_mesh(8, device_type="cpu")
    xs, n = mesh_lib.shard_rows(mesh, x)
    valid, _ = mesh_lib.shard_rows(mesh, np.arange(xs.shape[0]) < n)
    cd = mesh_lib.replicate(mesh, cents)
    sums, counts = sharded.sharded_kmeans_partials(mesh, xs, valid, cd)
    xp = np.zeros((3072, D), np.float32)
    xp[:3000] = x
    rsums, rcounts = ref_km.kmeans_partials(
        jax.numpy.asarray(xp), jax.numpy.asarray(np.arange(3072) < 3000),
        jax.numpy.asarray(cents), chunk=1024)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(rsums),
                               rtol=1e-5, atol=1e-3)
    step = sharded.sharded_kmeans_step(mesh, xs, valid, cd,
                                       mesh_lib.replicate(mesh, reseed))
    rmesh = ref_mesh.make_mesh(8)
    rx, rn = ref_mesh.shard_rows(rmesh, x)
    rv, _ = ref_mesh.shard_rows(rmesh, np.arange(rx.shape[0]) < rn)
    rstep = ref_sharded.sharded_kmeans_step(
        rmesh, rx, rv, ref_mesh.replicate(rmesh, cents),
        ref_mesh.replicate(rmesh, reseed))
    np.testing.assert_allclose(step.local(0, 0).numpy(), np.asarray(rstep),
                               rtol=1e-5, atol=1e-4)


def _objective(x, cents):
    d2 = ((x[:, None, :].astype(np.float64)
           - np.asarray(cents, np.float64)[None]) ** 2).sum(-1)
    return float(d2.min(axis=1).mean())


def test_train_kmeans_sharded_objective():
    rng = np.random.default_rng(29)
    centers = rng.standard_normal((16, D)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 16, 4000)]
         + rng.standard_normal((4000, D)).astype(np.float32))
    mesh = mesh_lib.make_mesh(8, device_type="cpu")
    got = sharded.train_kmeans_sharded(mesh, x, k=16, iters=8)
    ref = ref_sharded.train_kmeans_sharded(ref_mesh.make_mesh(8), x, k=16,
                                           iters=8)
    single = km.train_kmeans(torch.from_numpy(x), k=16, iters=8)
    assert got.shape == (16, D)
    # the shard count moves no centroid beyond f32 summation order
    one = sharded.train_kmeans_sharded(
        mesh_lib.make_mesh(1, device_type="cpu"), x, k=16, iters=8)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-4)
    # each trainer's k-means++ init may merge a cluster or two (each
    # adds ~32 to this data's optimum of ~32): a bound, not bits
    assert _objective(x, got) <= 1.5 * _objective(x, ref)
    assert _objective(x, got) <= 1.5 * _objective(x, single)


def test_mesh_train_through_the_index():
    data = _data(n=4000)
    store = RawVectorStore(D, device="cpu")
    store.add(data)
    idx = IVFPQIndex(pt.IndexParams("IVFPQ", pt.MetricType.L2, dict(
        PQ, mesh_train=True, mesh_serving="on")), store)
    idx.train(data)
    idx.absorb(4000)
    assert idx.last_train_mesh == "8x1"
    plain = IVFPQIndex(pt.IndexParams("IVFPQ", pt.MetricType.L2, PQ),
                       RawVectorStore(D, device="cpu"))
    plain.train(data)
    assert plain.last_train_mesh is None
    assert _objective(data, idx.centroids) <= \
        1.05 * _objective(data, plain.centroids)
    _, ids = idx.search(data[:8], 1, None)
    assert (ids[:, 0] == np.arange(8)).all()
    # one visible device: the single-device trainer
    mesh_lib.set_virtual_device_count(None)
    one = IVFPQIndex(pt.IndexParams("IVFPQ", pt.MetricType.L2, dict(
        PQ, mesh_train=True)), RawVectorStore(D, device="cpu"))
    one.train(data)
    assert one.last_train_mesh is None


# -- through the engine ---------------------------------------------------------

def _engine(t, params, n=1200, **kw):
    schema = t.TableSchema("t", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams("IVFPQ", t.MetricType.L2, dict(
                          PQ, training_threshold=10 ** 9, **params))),
    ])
    if t is pt:
        eng = Engine(schema, device="cpu")
    else:
        from vearch_tpu.engine.engine import Engine as RefEngine

        eng = RefEngine(schema)
        eng.micro_batch = False
    vecs = _data(seed=33, n=n)
    eng.upsert([{"_id": f"d{i:05d}", "emb": vecs[i]} for i in range(n)])
    return eng, vecs


def test_engine_mesh_matches_reference_engine():
    from vearch_tpu.engine.engine import SearchRequest as RefRequest

    ref, vecs = _engine(rt, {"mesh_serving": "on"})
    ref.build_index()
    port, _ = _engine(pt, {"mesh_serving": "on"})
    port.indexes["emb"].load_state(
        index_state_from_reference(ref.indexes["emb"].dump_state()))
    q = vecs[:8] + 0.01
    trace: dict = {}
    got = port.search(SearchRequest(vectors={"emb": q}, k=10,
                                    include_fields=[], trace=trace))
    want = ref.search(RefRequest(vectors={"emb": q}, k=10,
                                 include_fields=[]))
    for a, b in zip(got, want):
        assert [i.key for i in a.items] == [i.key for i in b.items]
        np.testing.assert_allclose([i.score for i in a.items],
                                   [i.score for i in b.items],
                                   rtol=RTOL, atol=ATOL)
    assert trace["perf_path"] == "ivfpq_mesh_fused"
    assert "mesh.place" in [s[0] for s in trace["_phase_spans"]]
    assert trace["mesh"]["fields"]["emb"]["data_shards"] == 8
    gone = [got[0].items[0].key]
    port.delete(gone)
    again = port.search(SearchRequest(vectors={"emb": q[:1]}, k=10,
                                      include_fields=[]))
    assert again[0].items[0].key == got[0].items[1].key
    port.close()
    ref.close()


def test_apply_config_toggles_mesh_and_shape():
    eng, vecs = _engine(pt, {"mesh_serving": "off"})
    eng.build_index()
    req = lambda: SearchRequest(vectors={"emb": vecs[:8]}, k=10,  # noqa: E731
                                include_fields=[],
                                index_params={"scan_mode": "full"})
    res0, led = _ledger(lambda: eng._search_direct(req()))
    assert led == DOC["ivfpq_full_fused"]
    eng.apply_config({"mesh_serving": "on"})
    res1, led = _ledger(lambda: eng._search_direct(req()))
    assert led == DOC["ivfpq_mesh_fused"]
    eng.apply_config({"mesh_shape": "4x2"})
    assert eng.indexes["emb"]._serving_mesh(None).shape["query"] == 2
    res2 = eng._search_direct(req())
    for a, b, c in zip(res0, res1, res2):
        assert [(i.key, i.score) for i in a.items] == \
            [(i.key, i.score) for i in b.items] == \
            [(i.key, i.score) for i in c.items]
    assert eng.mesh_info()["devices"] == 8
    eng.close()


def test_warmed_mesh_search_compiles_nothing_new():
    data = _data()
    _, mesh, _ = _trio(data)
    q = data[:8]
    mesh.search(q, 10, None)
    before = perf_model.total_compiled_programs()
    for _ in range(3):
        mesh.search(q, 10, None)
    assert perf_model.total_compiled_programs() == before
    assert perf_model.compiled_program_counts()["sharded.ivf_fused"] >= 1
