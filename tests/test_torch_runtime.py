"""Runtime truth on the port, against vearch_tpu on the CPU: the perf
model's byte models and tables, the obs/ layer (accounting, SLO burn,
P^2 sketches, quality monitor, flight recorder, device sampler) and the
engine's and scheduler's hooks.

- Byte models equal the reference's on a grid, except two the port's
  layout changes, each with its difference stated byte for byte:
  `scan_peak_bytes("pallas_blockmax")` (the port's stage 2 widens the
  gathered int8 rows to f32 and keeps int64 ids: 4d + 4 more bytes a
  gathered row) and `ivf_bucket_footprint_bytes` (the port keeps
  `_bucket_lens`, nlist int32, beside the buckets).
- The peak table is the card's: no TPU row.
- obs/ copies fed the same sequences as the reference's give equal
  snapshots (apart from the accountant's random scope id and event
  stamps).
- Engines from the same trained state give equal `trace["dispatches"]`,
  pad counters and filter-cache counters.
- On the CPU the sampler measures nothing; tests inject a measurer, as
  they do into the reference's sampler.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu.obs import accounting as ref_acct  # noqa: E402
from vearch_tpu.obs import flight_recorder as ref_fr  # noqa: E402
from vearch_tpu.obs import quality as ref_quality  # noqa: E402
from vearch_tpu.obs import quantiles as ref_q  # noqa: E402
from vearch_tpu.obs import sampler as ref_sampler  # noqa: E402
from vearch_tpu.ops import perf_model as ref_perf  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import batching  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.obs import accounting as acct  # noqa: E402
from vearch_tpu_torch.obs import flight_recorder as fr  # noqa: E402
from vearch_tpu_torch.obs import quality  # noqa: E402
from vearch_tpu_torch.obs import quantiles  # noqa: E402
from vearch_tpu_torch.obs import sampler  # noqa: E402
from vearch_tpu_torch.ops import ivf as port_ivf  # noqa: E402
from vearch_tpu_torch.ops import perf_model  # noqa: E402

D, N = 32, 3000
BASE = {"ncentroids": 16, "nsubvector": 8, "train_iters": 3,
        "training_threshold": 10 ** 9, "nprobe": 6, "mesh_serving": "off"}


# -- perf model -------------------------------------------------------------------

GRID = [(n, d, r, b) for n in (1, 511, 512, 4096, 1_000_448)
        for d in (8, 100, 128) for r in (10, 128, 512, 5000)
        for b in (1, 32, 1024)]


@pytest.mark.parametrize("n,d,r,b", GRID[::7] + GRID[-3:])
def test_scan_byte_models_match_reference(n, d, r, b):
    assert perf_model.blockmax_selected_blocks(r, n) == \
        ref_perf.blockmax_selected_blocks(r, n)
    assert perf_model.scan_peak_bytes(b, n, d, r, "xla_full") == \
        ref_perf.scan_peak_bytes(b, n, d, r, "xla_full")
    # the port's stage 2: f32-widened gathered rows, int64 ids
    s = perf_model.blockmax_selected_blocks(r, n) * 512
    chunk = min(32, b)
    assert perf_model.scan_peak_bytes(b, n, d, r, "pallas_blockmax") == \
        ref_perf.scan_peak_bytes(b, n, d, r, "pallas_blockmax") \
        + chunk * s * (4 * d + 4)
    assert perf_model.scan_traffic_bytes(b, n, d, "xla_full") == \
        ref_perf.scan_traffic_bytes(b, n, d, "xla_full")
    with pytest.raises(ValueError):
        perf_model.scan_peak_bytes(b, n, d, r, "nope")


@pytest.mark.parametrize("n", [0, 1, 512, 1024, 1_048_576])
@pytest.mark.parametrize("d", [8, 17, 128])
def test_footprint_byte_models_match_reference(n, d):
    for storage in ("int8", "int4", "bits"):
        assert perf_model.mirror_footprint_bytes(n, d, storage) == \
            ref_perf.mirror_footprint_bytes(n, d, storage)
    assert perf_model.binary_plane_bytes(n, d) == \
        ref_perf.binary_plane_bytes(n, d)
    assert perf_model.binary_footprint_bytes(n, d) == \
        ref_perf.binary_footprint_bytes(n, d)
    assert perf_model.binary_scan_traffic_bytes(n, d) == \
        ref_perf.binary_scan_traffic_bytes(n, d)
    for itemsize in (2, 4):
        assert perf_model.raw_store_footprint_bytes(n, d, itemsize) == \
            ref_perf.raw_store_footprint_bytes(n, d, itemsize)
    for shards in (1, 3, 8):
        assert perf_model.per_device_bytes(n * d, n, shards) == \
            ref_perf.per_device_bytes(n * d, n, shards)
    for nlist, cap in ((16, 128), (2048, 7040)):
        # the port's _bucket_lens: nlist int32 more
        assert perf_model.ivf_bucket_footprint_bytes(nlist, cap, d) == \
            ref_perf.ivf_bucket_footprint_bytes(nlist, cap, d) + 4 * nlist
    assert perf_model.slab_bytes(n, d) == ref_perf.slab_bytes(n, d)
    assert perf_model.tier_h2d_bytes(3, n, d) == \
        ref_perf.tier_h2d_bytes(3, n, d)
    # int4 halves the row payload
    assert perf_model.mirror_footprint_bytes(n, 128, "int4") - 8 * n == \
        (perf_model.mirror_footprint_bytes(n, 128, "int8") - 8 * n) // 2


def test_bucket_models_and_tables_match_reference():
    assert perf_model.ROW_BUCKETS == ref_perf.ROW_BUCKETS
    assert perf_model.FETCH_K_TIERS == ref_perf.FETCH_K_TIERS
    assert perf_model.RECALL_K_TIERS == ref_perf.RECALL_K_TIERS
    assert perf_model.BLOCK == ref_perf.BLOCK
    assert perf_model.BLOCKMAX_STAGE2_CHUNK == ref_perf.BLOCKMAX_STAGE2_CHUNK
    for x in (1, 7, 8, 9, 64, 65, 1000, 1024, 1025, 5000):
        assert perf_model.bucket_rows(x) == ref_perf.bucket_rows(x)
        assert perf_model.bucket_fetch_k(x) == ref_perf.bucket_fetch_k(x)
        for cap in (1, 8, 64, 1024):
            assert perf_model.bucket_dispatch_bound(x, cap) == \
                ref_perf.bucket_dispatch_bound(x, cap)
        for pad in (x, x + 3, 1024):
            for d in (8, 128):
                assert perf_model.padding_waste_bytes(x, pad, d) == \
                    ref_perf.padding_waste_bytes(x, pad, d)
    assert perf_model.bucket_program_bound() == \
        ref_perf.bucket_program_bound()
    assert perf_model.bucket_program_bound(2, 3) == \
        ref_perf.bucket_program_bound(2, 3)
    for hit, cost in ((0.0, 0.0), (0.5, 0.1), (1.0, 0.0), (1.5, -1.0)):
        assert perf_model.effective_qps(100.0, hit, cost) == \
            ref_perf.effective_qps(100.0, hit, cost)
    for n, d, rr in ((10 ** 6, 128, 0), (10 ** 6, 128, 512), (1, 1, 0)):
        assert perf_model.roofline_qps(n, d, 989e12, rr) == \
            ref_perf.roofline_qps(n, d, 989e12, rr)


def test_peak_table_is_the_cards():
    assert all(k.startswith("NVIDIA") for k in perf_model.PEAK_OPS)
    assert "TPU" not in repr(perf_model.PEAK_OPS) + repr(
        perf_model.PEAK_BYTES_PER_S) + perf_model.DEFAULT_CHIP
    label, ops = perf_model.peak_ops("NVIDIA H100 80GB HBM3")
    assert ops == 989e12 and "bf16" in label
    assert perf_model.peak_ops("NVIDIA H100 80GB HBM3", "int8")[1] == 1979e12
    label, ops = perf_model.peak_ops(None)
    assert "assumed" in label and ops == 989e12
    assert perf_model.PEAK_BYTES_PER_S[perf_model.DEFAULT_CHIP] == 3.35e12


# every tag list the reference's perf gates and traces compare against,
# and sequences that match no path
TAG_LISTS = [list(v) for v in ref_perf.DOCUMENTED_DISPATCHES.values()] + [
    ["fused_scan_rerank", "fused_scan_rerank"], ["rerank"], ["scan"],
    ["probe_scan"], ["binary_refine_scan"], ["rerank", "scan"],
    ["flat_scan", "ivfflat_scan"]]


@pytest.mark.parametrize("tags", TAG_LISTS, ids=lambda t: "+".join(t) or "-")
def test_documented_dispatches_match_reference(tags):
    assert perf_model.DOCUMENTED_DISPATCHES == ref_perf.DOCUMENTED_DISPATCHES
    assert perf_model.path_for_dispatches(tags) == \
        ref_perf.path_for_dispatches(tags)


def test_perf_ledger_matches_reference():
    ours, theirs = perf_model.PerfLedger(), ref_perf.PerfLedger()
    for led in (ours, theirs):
        for step in (["scan", "rerank"], [], ["fused_scan_rerank"]):
            for t in step:
                led.append(t)
            led.mark_search()
        led.append("flat_scan")
    assert ours.per_search() == theirs.per_search()
    assert ours.counts() == theirs.counts()
    assert ours.dispatch_count() == theirs.dispatch_count() == len(ours)
    assert ours == theirs.tags and list(ours) == list(theirs)


def test_program_tracking_counts_new_signatures():
    events = []
    prev = perf_model._compile_observer
    perf_model.set_compile_observer(lambda *a: events.append(a))
    try:
        f = perf_model.register_op("test.square")(lambda x, k=1: x * k)
        before = perf_model.compiled_program_counts()["test.square"]
        f(torch.ones(3))
        f(torch.ones(3) * 2)               # same signature
        f(torch.ones(4))                   # new shape
        f(torch.ones(4), k=2)              # new static value
        f(torch.ones(4, dtype=torch.float64), k=2)
        assert perf_model.compiled_program_counts()["test.square"] == \
            before + 4
        assert [e[0] for e in events] == ["test.square"] * 4
        assert "torch.float32(3,)" in events[0][1]
        assert "k=2" in events[2][1]
        # a library build or load is one program of its own
        assert perf_model.note_program("build.x", "x.so", 1.0)
        assert not perf_model.note_program("build.x", "x.so", 1.0)
        assert events[-1] == ("build.x", "x.so", 1.0)
    finally:
        perf_model.set_compile_observer(prev)


def test_h2d_ledger_feeds_the_observer():
    seen = []
    before = perf_model.h2d_bytes_total()
    perf_model.set_h2d_observer(seen.append)
    try:
        perf_model.note_h2d_bytes(7)
    finally:
        perf_model.set_h2d_observer(None)
    assert perf_model.h2d_bytes_total() == before + 7 and seen == [7]


# -- obs copies against the reference -----------------------------------------------


def test_p2_estimator_and_registry_match_reference():
    rng = np.random.default_rng(5)
    xs = np.concatenate([rng.exponential(3.0, 400), rng.normal(50, 5, 40)])
    for q in (0.5, 0.95, 0.99):
        a, b = quantiles.P2Estimator(q), ref_q.P2Estimator(q)
        for i, x in enumerate(xs):
            a.observe(x)
            b.observe(x)
            if i in (0, 3, 4, 5, 50, len(xs) - 1):
                assert a.value() == b.value()
    ra, rb = quantiles.QuantileRegistry(), ref_q.QuantileRegistry()
    for i, x in enumerate(xs):
        key = (i % 3, "search")
        ra.observe(key, x)
        rb.observe(key, x)
    ra.drop((2, "search"))
    rb.drop((2, "search"))
    assert ra.snapshot() == rb.snapshot()
    assert quantiles.TRACKED_QUANTILES == ref_q.TRACKED_QUANTILES


def _feed_accountant(mod, a):
    a.charge("requests", 1, space="db/a")
    a.charge("rows", 8, space="db/b")
    with mod.billed("db/c"):
        a.charge("dispatches")
        a.on_dispatch("scan")
        a.on_h2d_bytes(4096)
    a.charge("device_us", 10)  # no bound space: _system
    for i in range(20):
        a.touch(f"db/s{i}")
    out = a.apportion_device_us([("db/a", 3), ("db/b", 1), (None, 0)], 1001)
    return out, a.label("db/s19"), a.labelled("device_us", 1e-3)


def test_space_accountant_matches_reference():
    ours = acct.SpaceAccountant(label_topk=12)
    theirs = ref_acct.SpaceAccountant(label_topk=12)
    assert _feed_accountant(acct, ours) == _feed_accountant(ref_acct, theirs)
    a, b = ours.snapshot(), theirs.snapshot()
    a.pop("scope_id")
    b.pop("scope_id")
    assert a == b
    totals = a["totals"]
    for meter in acct.METERS:
        assert totals[meter] == sum(m[meter] for m in a["spaces"].values())
    assert acct.METERS == ref_acct.METERS
    assert (acct.SYSTEM_SPACE, acct.QUALITY_SPACE, acct.OTHER_LABEL) == (
        ref_acct.SYSTEM_SPACE, ref_acct.QUALITY_SPACE, ref_acct.OTHER_LABEL)
    ours.reset()
    assert ours.snapshot()["spaces"] == {}


def test_slo_engine_matches_reference():
    ours, theirs = acct.SpaceSLOEngine(), ref_acct.SpaceSLOEngine()
    rng = np.random.default_rng(9)
    for eng in (ours, theirs):
        eng.set_objective("db/a", {"latency_ms": 20, "availability": 0.99})
        eng.set_objective("db/b", {"latency_ms": 5})
        eng.set_objective("db/gone", {"latency_ms": 5})
        eng.set_objective("db/gone", None)
    lat = rng.exponential(10.0, 120)
    for i, x in enumerate(lat):
        now = 1000.0 + i * 7.0
        for eng in (ours, theirs):
            eng.observe("db/a", float(x), ok=i % 17 != 0, now=now)
            eng.observe("db/b", float(x) / 3, now=now)
            eng.observe("db/none", 1.0, now=now)
    assert ours.summary(now=2000.0) == theirs.summary(now=2000.0)
    assert ours.objective("db/a") == theirs.objective("db/a")


def test_flight_recorder_matches_reference():
    ours, theirs = fr.CompileFlightRecorder(4), ref_fr.CompileFlightRecorder(4)
    for rec, mod in ((ours, fr), (theirs, ref_fr)):
        with rec.warmup():
            rec.on_compile("ivf.scan", "a", 1.0)
            with rec.warmup():
                rec.on_compile("ivf.scan", "b", 1.0)
        tok = mod.set_active_trace("t1")
        try:
            for sig in ("a", "a", "c", "d", "e", "f", "g"):
                rec.on_compile("ivf.scan", sig, 2.5)
            rec.on_compile("build.x", "x.so", 900.0)
        finally:
            mod.reset_active_trace(tok)
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in ours.events()]
    want = [{k: v for k, v in e.items() if k != "ts"}
            for e in theirs.events()]
    assert strip == want and strip[-1]["trace_id"] == "t1"
    assert ours.counts() == theirs.counts()
    assert ours.total() == theirs.total() == 7
    assert ours.warmup_compiles == theirs.warmup_compiles == 2
    assert not ours.in_warmup()
    ours.reset()
    assert ours.total() == 0 and ours.events() == []


def test_wilson_and_rbo_match_reference():
    for s, t in ((0, 0), (0, 10), (7, 10), (10, 10), (3.3, 8.1)):
        assert quality.wilson_bounds(s, t) == ref_quality.wilson_bounds(s, t)
    for a, b in (([], []), ([1], []), ([1, 2, 3], [1, 2, 3]),
                 ([1, 2, 3, 4], [4, 3, 2, 1]), ([1, 2], [3, 4, 5])):
        assert quality.rank_biased_overlap(a, b) == \
            ref_quality.rank_biased_overlap(a, b)


class _Item:
    def __init__(self, key):
        self.key = key


class _Result:
    def __init__(self, keys):
        self.items = [_Item(k) for k in keys]


class _FakeEngine:
    """Ground truth by the query's first coordinate; the same object
    serves both packages' monitors."""

    def __init__(self):
        self.data_version = 3
        self.requests = []

    def search(self, req):
        self.requests.append(req)
        q = next(iter(req.vectors.values()))[0]
        base = int(q[0])
        return [_Result([f"k{base + i}" for i in range(req.k)])]

    def quality_info(self):
        return {"doc_count": 10, "deleted_frac": 0.4, "fields": {
            "emb": {"trained": True, "recon_error": 0.2,
                    "cell_imbalance_cv": 3.0, "unindexed_frac": 0.0}}}


def _drive_monitor(mod):
    eng = _FakeEngine()
    mon = mod.QualityMonitor(get_engines=lambda: {1: eng}, sample_rate=0.5,
                             seed=7, min_samples=2)
    mon.set_floors({"db/s": 0.99})
    rng = np.random.default_rng(1)
    for step in range(12):
        q = rng.standard_normal((6, 4)).astype(np.float32)
        q[:, 0] = np.arange(6) * 10 + step
        served = [_Result([f"k{int(r[0]) + i}" for i in range(10)])
                  if i % 2 else _Result([f"x{i}"] * 10)
                  for i, r in enumerate(q)]
        mon.observe_search(1, "db/s", {"emb": q}, 10, served, 3)
        mon.run_pending()
    health = mon.collect_health()
    eng.quality_info = lambda: {"fields": {"emb": {
        "trained": True, "recon_error": 0.5}}}
    health2 = mon.collect_health()
    mon.note_index_mutation(1, "db/s", op="rebuild")
    after = mon.recall_snapshot()
    return (health, health2, after, mon.counters(), mon.obs_summary(),
            len(eng.requests),
            eng.requests[0].brute_force if eng.requests else None)


def test_quality_monitor_matches_reference():
    ours, theirs = _drive_monitor(quality), _drive_monitor(ref_quality)
    assert ours == theirs
    assert ours[5] > 0 and ours[6] is True
    assert quality.SHADOW_EVENTS == ref_quality.SHADOW_EVENTS


def test_quality_monitor_snapshots_match_reference():
    snaps = []
    for mod in (quality, ref_quality):
        eng = _FakeEngine()
        mon = mod.QualityMonitor(get_engines=lambda: {1: eng},
                                 sample_rate=1.0, min_samples=3)
        mon.set_floor("db/s", 0.95)
        for step in range(8):
            q = np.zeros((2, 4), np.float32)
            q[:, 0] = [step, 100 + step]
            served = [_Result([f"k{step + i}" for i in range(10)]),
                      _Result([f"k{100 + step + (i % 3)}" for i in range(10)])]
            mon.observe_search(1, "db/s", {"emb": q}, 10, served, 3)
            mon.run_pending()
        snaps.append((mon.recall_snapshot(), mon.breach_spaces(),
                      mon.stats()["recall"]))
    assert snaps[0] == snaps[1]


# -- the device sampler -------------------------------------------------------------


def test_sampler_measures_nothing_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sampler.measure_live_bytes() == {}
    assert sampler.measure_reserved_bytes() == {}
    s = sampler.DeviceSampler(lambda: 10 ** 9)
    snap = s.sample_now()
    assert snap["devices"] == {} and not snap["drift"]
    assert snap["drift_bytes"] == 0


def test_sampler_drift_matches_reference(monkeypatch):
    """Baseline, no drift inside the tolerance, drift past it: the same
    injected measurements through both samplers."""
    readings = iter([{"cuda:0": 1000 + 100}, {"cuda:0": 1000 + 60_000},
                     {"cuda:0": 1000 + 200_000}, {"cuda:0": 1000 + 10}])
    seq = [next(readings) for _ in range(4)]
    model = {"v": 100}

    def model_fn():
        return model["v"]

    ours_it, theirs_it = iter(seq), iter(seq)
    monkeypatch.setattr(sampler, "measure_live_bytes",
                        lambda: next(ours_it))
    ours = sampler.DeviceSampler(model_fn, drift_slack_bytes=50_000)
    monkeypatch.setattr(ref_sampler, "measure_live_bytes",
                        lambda: next(theirs_it))
    theirs = ref_sampler.DeviceSampler(model_fn, drift_slack_bytes=50_000)
    keys = ("samples", "devices", "model_per_device_bytes",
            "baseline_per_device_bytes", "drift_bytes", "drift")
    for step in range(4):
        if step == 1:
            model["v"] = 40_000  # the model grows with the structure
        a, b = ours.sample_now(), theirs.sample_now()
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    snap = ours.snapshot()
    assert snap["baseline_per_device_bytes"] == {"cuda:0": 1000}
    assert snap["samples"] == 4


def test_sampler_drift_verdicts(monkeypatch):
    values = {"cuda:0": 0}
    monkeypatch.setattr(sampler, "measure_live_bytes", lambda: dict(values))
    s = sampler.DeviceSampler(lambda: 1000, drift_slack_bytes=100,
                              drift_tolerance=0.5)
    values["cuda:0"] = 5000  # baseline 4000 beyond the model
    assert not s.sample_now()["drift"]
    values["cuda:0"] = 5000 + 600  # 600 <= 100 + 0.5 * 1000
    assert not s.sample_now()["drift"]
    values["cuda:0"] = 5000 + 601
    snap = s.sample_now()
    assert snap["drift"] and snap["drift_bytes"] == 601
    s.rebaseline()
    assert not s.snapshot()["drift"]
    s.start()
    s.stop()
    assert s._thread is None


# -- engines ------------------------------------------------------------------------


def _schema(t, index_type, metric="L2", extra=None, d=D):
    return t.TableSchema("t", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=d,
                      index=t.IndexParams(index_type, t.MetricType(metric),
                                          dict(BASE, **(extra or {})))),
        t.FieldSchema("tag", t.DataType.INT),
    ])


def _docs(seed=71, n=N, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, d)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 30, n)]
            + 0.6 * rng.standard_normal((n, d))).astype(np.float32)
    return [{"_id": f"d{i:05d}", "emb": vecs[i], "tag": int(i % 4)}
            for i in range(n)], vecs


def _binary_docs(n=1024, d=64):
    rng = np.random.default_rng(3)
    packed = np.packbits(rng.integers(0, 2, (n, d)).astype(np.uint8), 1)
    return [{"_id": f"d{i:05d}", "emb": packed[i], "tag": int(i % 4)}
            for i in range(n)], packed


def _pair(index_type, extra=None, tmp_path=None, docs=None, d=D):
    if docs is None:
        docs, _ = _docs(d=d)
    dirs = ((str(tmp_path / "ref"), str(tmp_path / "port"))
            if tmp_path is not None else (None, None))
    ref = RefEngine(_schema(rt, index_type, "L2", extra, d),
                    data_dir=dirs[0])
    port = Engine(_schema(pt, index_type, "L2", extra, d), device="cpu",
                  data_dir=dirs[1])
    ref.micro_batch = port.micro_batch = False
    for lo in range(0, len(docs), 1000):
        ref.upsert(docs[lo:lo + 1000])
        port.upsert(docs[lo:lo + 1000])
    ref.build_index()
    port.indexes["emb"].load_state(
        index_state_from_reference(ref.indexes["emb"].dump_state()))
    return ref, port


TRACE_CASES = [
    ("FLAT", {}, {}),
    ("IVFFLAT", {}, {}),
    ("IVFPQ", {"scan_mode": "full"}, {}),
    ("IVFPQ", {"scan_mode": "full"}, {"fused_rerank": False}),
    ("IVFPQ", {"scan_mode": "full"}, {"scan_kernel": "pallas"}),
    ("IVFPQ", {"scan_mode": "full", "mirror_dtype": "int4"}, {}),
    ("IVFPQ", {"scan_mode": "probe"}, {}),
    ("IVFPQ", {"opq": True, "opq_iters": 1}, {}),
    ("SCANN", {}, {}),
    ("IVFRABITQ", {}, {}),
    ("IVFRABITQ", {}, {"stage0": "off"}),
    ("HNSW", {}, {}),
    ("BINARYIVF", {}, {}),
    ("DISKANN", {}, {}),
    ("IVFPQ", {"store_type": "Disk"}, {}),
]


@pytest.mark.parametrize("index_type,extra,params", TRACE_CASES)
def test_trace_dispatches_match_reference(index_type, extra, params,
                                          tmp_path):
    disk = index_type == "DISKANN" or extra.get("store_type") == "Disk"
    binary = index_type == "BINARYIVF"
    docs, vecs = _binary_docs() if binary else _docs()
    ref, port = _pair(index_type, extra, tmp_path if disk else None,
                      docs=docs, d=64 if binary else D)
    q = vecs[[5, 9, 400]]
    traces = []
    for eng, cls in ((ref, RefRequest), (port, SearchRequest)):
        t: dict = {}
        eng.search(cls(vectors={"emb": q}, k=10, index_params=params,
                       trace=t))
        traces.append(t)
    want, got = traces
    for key in ("dispatches", "dispatch_count", "perf_path",
                "predicted_dispatches", "predicted_scan_bytes"):
        assert got.get(key) == want.get(key), key
    names = {s[0] for s in got["_phase_spans"]}
    assert {f"kernel.{tag}" for tag in got["dispatches"]} <= names
    assert {"engine.filter", "engine.search.emb", "engine.merge",
            "engine.shape"} <= names
    if not disk:
        assert names == {s[0] for s in want["_phase_spans"]}
    for key in got["dispatches"]:
        assert got[f"dispatch_{key}_ms"] >= 0.0
    ref.close()
    port.close()


def test_pad_and_filter_cache_counters_match_reference():
    ref, port = _pair("IVFPQ", {"scan_mode": "full"})
    _docs_, vecs = _docs()
    flt = {"operator": "AND", "conditions": [
        {"field": "tag", "operator": "IN", "value": [1, 2]}]}
    for eng, cls in ((ref, RefRequest), (port, SearchRequest)):
        for b in (1, 5, 8, 9, 64, 200):
            eng.search(cls(vectors={"emb": vecs[:b]}, k=10))
        for _ in range(3):
            eng.search(cls(vectors={"emb": vecs[:3]}, k=10, filters=flt))
        eng.upsert([{"_id": "late", "emb": vecs[0], "tag": 1}])
        eng.search(cls(vectors={"emb": vecs[:3]}, k=10, filters=flt))
        eng.shape_buckets = False
        eng.search(cls(vectors={"emb": vecs[:5]}, k=10))
    for name in ("pad_real_rows", "pad_padded_rows", "pad_waste_bytes",
                 "filter_cache_hits", "filter_cache_misses"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.filter_cache_hits == 2 and port.filter_cache_misses == 2
    assert port.pad_waste_bytes == perf_model.padding_waste_bytes(
        1 + 5 + 9 + 200 + 3 * 4, 8 + 8 + 64 + 256 + 8 * 4, D) + \
        perf_model.padding_waste_bytes(8, 8, D) + \
        perf_model.padding_waste_bytes(64, 64, D)
    port.close()
    ref.close()


def test_build_job_and_observers_match_reference():
    jobs, mutations = {}, {}
    docs, _ = _docs(n=1200)
    for name, cls, kw in (("ref", RefEngine, {}),
                          ("port", Engine, {"device": "cpu"})):
        t = rt if name == "ref" else pt
        eng = cls(_schema(t, "IVFPQ", extra={"warmup_batches": [8]}), **kw)
        eng.micro_batch = False
        eng.build_observer = lambda job, n=name: jobs.setdefault(
            n, []).append(dict(job))
        eng.mutation_observer = lambda op, n=name: mutations.setdefault(
            n, []).append(op)
        eng.upsert(docs)
        eng.build_index()
        eng.rebuild_index()
    for name in ("ref", "port"):
        assert [j["status"] for j in jobs[name]] == ["done", "done"]
        assert [j["op"] for j in jobs[name]] == ["build", "rebuild"]
        assert mutations[name] == ["rebuild"]
    a, b = jobs["port"][0], jobs["ref"][0]
    assert set(a) == set(b)
    assert a["phases_ms"].keys() == b["phases_ms"].keys()
    assert [s[0] for s in a["_phase_spans"]] == \
        [s[0] for s in b["_phase_spans"]]
    assert a["docs_total"] == b["docs_total"] == a["docs_done"] == 1200
    # a failing observer never fails the build
    eng = Engine(_schema(pt, "FLAT"), device="cpu")
    eng.build_observer = lambda job: 1 / 0
    eng.upsert(docs[:10])
    eng.build_index()
    assert eng.build_job["status"] == "done"


def test_quality_info_matches_reference():
    ref, port = _pair("IVFPQ")
    gone = [f"d{i:05d}" for i in range(0, N, 7)]
    ref.delete(gone)
    port.delete(gone)
    a, b = port.quality_info(), ref.quality_info()
    fa, fb = a.pop("fields")["emb"], b.pop("fields")["emb"]
    assert a == b
    rec_a, rec_b = fa.pop("recon_error"), fb.pop("recon_error")
    assert rec_a == pytest.approx(rec_b, rel=1e-5)
    assert fa == fb


def test_zero_new_programs_after_warmup():
    """The GPU meaning of the reference's zero-retrace gate, on the CPU:
    after warmup at the serving row buckets, searches of those buckets
    (padded row counts included) add no program signature and record no
    compile event."""
    docs, vecs = _docs()
    eng = Engine(_schema(pt, "IVFPQ", extra={
        "warmup_batches": [8, 64], "scan_mode": "full"}), device="cpu")
    eng.upsert(docs)
    rec = fr.install()
    eng.build_index()
    total0 = rec.total()
    programs0 = perf_model.total_compiled_programs()
    for b in (8, 5, 64, 40, 1):
        eng.search(SearchRequest(vectors={"emb": vecs[:b]}, k=10))
    assert rec.total() == total0
    assert perf_model.total_compiled_programs() == programs0
    # an unwarmed shape (a rerank depth no other test uses) is a compile
    # event, with the trace that caused it
    tok = fr.set_active_trace("req-1")
    try:
        eng.search(SearchRequest(vectors={"emb": vecs[:100]}, k=10,
                                 index_params={"rerank": 333}))
    finally:
        fr.reset_active_trace(tok)
    assert rec.total() > total0
    assert rec.events()[-1]["trace_id"] == "req-1"
    eng.close()


def test_accounting_hooks_bill_the_bound_space():
    docs, vecs = _docs()
    eng = Engine(_schema(pt, "IVFPQ", extra={"scan_mode": "full"}),
                 device="cpu")
    eng.upsert(docs)
    eng.build_index()
    eng.micro_batch = False
    a = acct.install()
    a.reset()
    ledger: list = []
    port_ivf.set_dispatch_ledger(ledger)
    try:
        with acct.billed("db/x"):
            eng.search(SearchRequest(vectors={"emb": vecs[:4]}, k=10))
    finally:
        port_ivf.set_dispatch_ledger(None)
        port_ivf.set_dispatch_observer(None)
        perf_model.set_h2d_observer(None)
    snap = a.snapshot()["spaces"]["db/x"]
    assert snap["dispatches"] == len(ledger) == 1
    assert snap["device_us"] > 0
    a.reset()


def _sched_engine():
    docs, vecs = _docs()
    eng = Engine(_schema(pt, "IVFPQ", extra={"scan_mode": "full"}),
                 device="cpu")
    eng.upsert(docs)
    eng.build_index()
    return eng, vecs


def test_scheduler_charges_a_grouped_run_by_rows():
    """One bucket of four pendings in two spaces, one of them killed:
    every pending is charged its queue wait, the group's wall time is
    split by row share and sums to it, the killed one gets its abort."""
    eng, vecs = _sched_engine()
    sched = batching.BatchScheduler(eng, max_rows=1024)
    acct.ACCOUNTANT.reset()
    walls = []
    inner = eng._search_direct

    def timed(req):
        t0 = time.monotonic()
        try:
            return inner(req)
        finally:
            walls.append(time.monotonic() - t0)

    eng._search_direct = timed
    pendings = []
    for space, rows in (("db/a", 3), ("db/b", 1), ("db/a", 2), ("db/b", 2)):
        with acct.billed(space):
            req = SearchRequest(vectors={"emb": vecs[:rows]}, k=10)
            if len(pendings) == 3:
                req.ctx = pt.RequestContext()
                req.ctx.kill("test")
            pendings.append(batching._Pending(req, rows))
    time.sleep(0.002)
    bucket = batching._Bucket("k")
    bucket.pendings = pendings
    bucket.rows = 8
    sched._run_bucket(bucket)
    sched.stop()
    spaces = acct.ACCOUNTANT.snapshot()["spaces"]
    assert set(spaces) >= {"db/a", "db/b"}
    for sp in ("db/a", "db/b"):
        assert spaces[sp]["queue_wait_us"] >= 2 * 2000
    dev_a, dev_b = spaces["db/a"]["device_us"], spaces["db/b"]["device_us"]
    assert len(walls) == 1
    total = dev_a + dev_b
    assert walls[0] * 1e6 - 1 <= total <= walls[0] * 1e6 + 5000
    # the row-share split (3, 1, 2, 2 rows), floor division with the
    # remainder on the last share
    s = [total * rows // 8 for rows in (3, 1, 2)]
    assert (dev_a, dev_b) == (s[0] + s[2], s[1] + total - sum(s))
    assert isinstance(pendings[3].error, pt.RequestKilled)
    assert all(p.results is not None for p in pendings[:3])
    acct.ACCOUNTANT.reset()
    eng.close()


def test_scheduler_charges_concurrent_callers_in_two_spaces():
    eng, vecs = _sched_engine()
    eng.batch_delay_ms = 20.0
    walls = []
    lock = threading.Lock()
    inner = eng._search_direct

    def timed(req):
        t0 = time.monotonic()
        try:
            return inner(req)
        finally:
            with lock:
                walls.append(time.monotonic() - t0)

    eng._search_direct = timed
    eng.search(SearchRequest(vectors={"emb": vecs[:2]}, k=10))  # starts it
    with lock:
        walls.clear()
    acct.ACCOUNTANT.reset()
    errors = []

    def caller(i):
        try:
            with acct.billed("db/a" if i % 2 else "db/b"):
                res = eng.search(SearchRequest(
                    vectors={"emb": vecs[i * 4:i * 4 + 4]}, k=10))
            assert [r.items[0].key for r in res] == \
                [f"d{i * 4 + j:05d}" for j in range(4)]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    spaces = acct.ACCOUNTANT.snapshot()["spaces"]
    assert acct.SYSTEM_SPACE not in spaces  # every run was bound
    dev = spaces["db/a"]["device_us"] + spaces["db/b"]["device_us"]
    assert spaces["db/a"]["device_us"] > 0 and spaces["db/b"]["device_us"] > 0
    assert sum(walls) * 1e6 - 8 <= dev <= sum(walls) * 1e6 + 5000 * len(walls)
    assert eng._microbatcher.stats()["dispatch_rows"] >= 32
    acct.ACCOUNTANT.reset()
    eng.close()
