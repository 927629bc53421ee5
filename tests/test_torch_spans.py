"""The port's span API (`vearch_tpu_torch/ops/ivf.py` `span`) on the
CPU: one span gives a traced request's `_phase_spans` row and, while a
`torch.profiler` runs, a profiler range of the same name over the same
window; with neither it records nothing and opens nothing. The spans of
each path are the ones docs/OBSERVABILITY_TORCH.md documents, nested as it
says."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vearch_tpu_torch.engine import types as pt
from vearch_tpu_torch.engine.engine import Engine, SearchRequest
from vearch_tpu_torch.ops import ivf as ivf_ops

D, N = 32, 3000
PARAMS = {"ncentroids": 16, "nsubvector": 8, "train_iters": 3,
          "training_threshold": 10 ** 9, "nprobe": 6,
          "mesh_serving": "off"}
ENGINE = {"engine.filter", "engine.search.emb", "engine.merge",
          "engine.shape"}
# each path's spans: (name, the span that contains it)
FULL = {"index.input": "engine.search.emb",
        "index.prepare": "engine.search.emb",
        "scan.blockmax": "engine.search.emb",
        "scan.refine": "engine.search.emb",
        "scan.rerank": "engine.search.emb",
        "index.fetch": "engine.search.emb"}
PROBE = {"index.input": "engine.search.emb",
         "index.prepare": "engine.search.emb",
         "scan.coarse": "engine.search.emb",
         "scan.probe_dots": "engine.search.emb",
         "scan.assemble": "engine.search.emb",
         "scan.select": "engine.search.emb",
         "scan.rerank": "engine.search.emb",
         "index.fetch": "engine.search.emb"}
THREE_STAGE = {"index.input": "engine.search.emb",
               "index.prepare": "engine.search.emb",
               "stage.flush": "index.prepare",
               "stage.refine": "engine.search.emb",
               "scan.unpack": "stage.refine",
               "scan.matmul": "stage.refine",
               "scan.epilogue": "stage.refine",
               "scan.select": "stage.refine",
               "scan.rescore": "stage.refine",
               "scan.rerank": "stage.refine",
               "index.fetch": "stage.refine"}
CASES = {
    # the block-max branch at any size; the CPU runs stage 1's plain
    # version under the same spans
    "full": ("IVFPQ", {"scan_mode": "full", "topk_mode": "blockmax"},
             FULL),
    # the probe kernel's arm (its plain version on the CPU)
    "probe": ("IVFPQ", {"scan_mode": "probe", "probe_kernel": "pallas"},
              PROBE),
    "three_stage": ("IVFRABITQ", {}, THREE_STAGE),
}


def _engine(index_type: str) -> tuple[Engine, np.ndarray]:
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((30, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 30, N)]
            + 0.6 * rng.standard_normal((N, D))).astype(np.float32)
    eng = Engine(pt.TableSchema("t", [pt.FieldSchema(
        "emb", pt.DataType.VECTOR, dimension=D,
        index=pt.IndexParams(index_type, pt.MetricType.L2, PARAMS))]),
        device="cpu")
    eng.micro_batch = False
    eng.upsert([{"_id": f"d{i}", "emb": vecs[i]} for i in range(N)])
    eng.build_index()
    return eng, vecs


@pytest.fixture(scope="module")
def engines():
    out = {t: _engine(t) for t in ("IVFPQ", "IVFRABITQ")}
    yield out
    for eng, _ in out.values():
        eng.close()


def _request(vecs, params, trace):
    return SearchRequest(vectors={"emb": vecs[[5, 9, 400, 7]]}, k=10,
                         include_fields=[], index_params=dict(params),
                         trace=trace)


def test_untraced_search_records_nothing_and_opens_no_range(
        engines, monkeypatch):
    """No profiler and `trace=None`: every span the search reaches is the
    shared no-op, no range opens and the thread holds no capture."""
    reached, opened = [], []
    real = ivf_ops.span

    def counting(name, device=False):
        s = real(name, device)
        reached.append((name, s))
        return s

    monkeypatch.setattr(ivf_ops, "span", counting)
    monkeypatch.setattr(ivf_ops, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd.profiler._is_profiler_enabled
    for index_type, params, _ in CASES.values():
        eng, vecs = engines[index_type]
        req = _request(vecs, params, None)
        eng.search(req)
        assert req.trace is None
    assert {n for n, _ in reached} >= {"engine.filter", "index.input",
                                       "scan.rerank", "index.fetch"}
    assert all(s is ivf_ops._NO_SPAN for _, s in reached)
    assert opened == []
    assert getattr(ivf_ops._capture_tls, "capture", None) is None


def test_a_span_without_a_capture_or_profiler_is_the_no_op():
    assert ivf_ops.span("scan.refine", device=True) is ivf_ops._NO_SPAN
    with ivf_ops.span("index.fetch") as s:
        pass
    assert s is ivf_ops._NO_SPAN


def _ranges(prof) -> dict[str, list[tuple[int, int]]]:
    """The profiler's host ranges by name: (start us, end us) on the
    epoch clock, sorted."""
    out: dict[str, list] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            continue
        s = ev.start_ns() // 1000
        out.setdefault(ev.name(), []).append((s, s + ev.duration_ns()
                                              // 1000))
    return {k: sorted(v) for k, v in out.items()}


def _rows(trace) -> dict[str, list[tuple[int, int]]]:
    out: dict[str, list] = {}
    for name, start_us, dur_us in trace["_phase_spans"]:
        out.setdefault(name, []).append((start_us, start_us + dur_us))
    return {k: sorted(v) for k, v in out.items()}


def _inside(child, parents) -> bool:
    return any(a <= child[0] and child[1] <= b for a, b in parents)


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_search_gives_each_span_as_a_row_and_a_range(engines, case):
    index_type, params, spans = CASES[case]
    eng, vecs = engines[index_type]
    eng.search(_request(vecs, params, {}))  # first calls out of the way
    trace: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the profiler's first range pays its set-up
        with record_function("warm"):
            pass
        eng.search(_request(vecs, params, trace))
    rows, ranges = _rows(trace), _ranges(prof)
    want = ENGINE | set(spans)
    program = {n for n in rows if not n.startswith("kernel.")}
    assert program == want
    for name in want:
        assert len(rows[name]) == len(ranges.get(name, [])), name
        for (r0, r1), (p0, p1) in zip(rows[name], ranges[name]):
            # the same window on the two clocks
            assert abs(r0 - p0) <= 5000, name
            assert abs((r1 - r0) - (p1 - p0)) <= max(
                500, 0.1 * (p1 - p0)), name
    for name, parent in spans.items():
        for window in rows[name]:
            assert _inside(window, rows[parent]), (name, parent)
        for window in ranges[name]:
            assert _inside(window, ranges[parent]), (name, parent)
    # the engine's phases are siblings, one each
    for name in ENGINE:
        assert len(rows[name]) == 1
    # *_ms keys are the spans' windows
    assert trace["filter_ms"] == pytest.approx(
        (rows["engine.filter"][0][1] - rows["engine.filter"][0][0]) / 1e3,
        abs=0.002)
    # no stream timing on the CPU
    assert "stream_ms" not in trace


def test_profiler_alone_opens_ranges_and_keeps_no_rows(engines):
    eng, vecs = engines["IVFPQ"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.search(_request(vecs, CASES["full"][1], None))
    ranges = _ranges(prof)
    assert ENGINE | set(FULL) <= set(ranges)
    assert getattr(ivf_ops._capture_tls, "capture", None) is None


def test_tier_phase_rows_join_the_capture_and_the_ledger():
    ledger: list = []
    ivf_ops.set_tier_phase_ledger(ledger)
    cap = ivf_ops.begin_capture("cpu")
    try:
        with ivf_ops.span("index.prepare"):
            t0 = time.monotonic()
            ivf_ops.note_tier_phase("fetch", t0, t0 + 0.001)
    finally:
        ivf_ops.end_capture()
        ivf_ops.set_tier_phase_ledger(None)
    assert [row[0] for row in cap.spans] == ["index.prepare", "tier.fetch"]
    assert ledger == [("fetch", t0, t0 + 0.001)]
    assert cap.stream == [] and cap.stream_device is None


def test_span_cost_without_tracing_is_one_check():
    """Neither a profiler nor a capture: a span is one thread-local read
    and one flag check, well under what a traced span costs."""
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with ivf_ops.span("scan.refine", device=True):
            pass
    off = (time.perf_counter() - t0) / n
    cap = ivf_ops.begin_capture("cpu")
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            with ivf_ops.span("scan.refine", device=True):
                pass
        on = (time.perf_counter() - t0) / n
    finally:
        ivf_ops.end_capture()
    assert len(cap.spans) == n
    assert off < on


def test_span_attributes_join_the_capture():
    """`span_attrs` gives the innermost open span of a traced request an
    entry a call, so a span that runs a stage twice keeps both; without
    a capture, or outside any span, it keeps nothing and `make` is not
    called."""
    def never():
        raise AssertionError("make called without a capture")

    with ivf_ops.span("scan.blockmax", device=True):
        ivf_ops.span_attrs(never)
    cap = ivf_ops.begin_capture("cpu")
    try:
        ivf_ops.span_attrs(lambda: {"outside": 1})
        with ivf_ops.span("engine.search.emb"):
            with ivf_ops.span("scan.blockmax", device=True):
                ivf_ops.span_attrs(lambda: {"query_tile": 64})
            with ivf_ops.span("scan.refine", device=True):
                ivf_ops.span_attrs(lambda: {"mirror_bytes": 5})
                ivf_ops.span_attrs(lambda: {"mirror_bytes": 7})
            ivf_ops.span_attrs(lambda: {"field": 1})
    finally:
        ivf_ops.end_capture()
    assert cap.attrs == [["scan.blockmax", {"query_tile": 64}],
                         ["scan.refine", {"mirror_bytes": 5}],
                         ["scan.refine", {"mirror_bytes": 7}],
                         ["engine.search.emb", {"field": 1}]]


def test_traced_full_scan_gives_its_stages_the_query_tile(engines,
                                                          monkeypatch):
    """The block-max stages' launches give their spans `query_tile` and
    `mirror_bytes` in the trace's `span_attrs`, a 0-d tensor read as a
    number; on the CPU the plain versions run and give none, so stand-ins
    that add the attributes are put in their place to see them reach
    the trace. An untraced search calls no `make`."""
    from vearch_tpu_torch.ops import blockmax_scan as bms

    eng, vecs = engines["IVFPQ"]
    trace: dict = {}
    eng.search(_request(vecs, CASES["full"][1], trace))
    assert "span_attrs" not in trace
    made = []

    def tagged(fn, value):
        def run(*args, **kw):
            out = fn(*args, **kw)
            ivf_ops.span_attrs(lambda: made.append(value) or {
                "query_tile": 7, "mirror_bytes": value})
            return out
        return run

    for mod in (ivf_ops, bms):
        monkeypatch.setattr(mod, "int8_blockmax_stage1", tagged(
            bms.int8_blockmax_stage1, 11))
        monkeypatch.setattr(mod, "blockmax_stage2", tagged(
            bms.blockmax_stage2, torch.tensor(13)))
    eng.search(_request(vecs, CASES["full"][1], None))
    assert made == []
    trace = {}
    eng.search(_request(vecs, CASES["full"][1], trace))
    assert trace["span_attrs"] == [
        ["scan.blockmax", {"query_tile": 7, "mirror_bytes": 11}],
        ["scan.refine", {"query_tile": 7, "mirror_bytes": 13}]]
    assert all(type(a["mirror_bytes"]) is int
               for _, a in trace["span_attrs"])
