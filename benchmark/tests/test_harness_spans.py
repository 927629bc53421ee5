"""The readers of the program's spans (benchmark/harness/spans.py and
the per-layer metrics on it) on synthetic windows: the rows and the
cells each reads, and None where the program recorded nothing."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.harness.loops import Record, Window

STREAM = {"scan_refine_stream_ms_per_kquery.batch": "scan.refine",
          "scan_select_stream_ms_per_kquery.batch": "scan.select",
          "scan_rerank_stream_ms_per_kquery.batch": "scan.rerank"}
CELLS = {"scan_refine_stream_ms_per_kquery.batch": {
             "sift1m-ivfpq.batch-full"},
         "scan_select_stream_ms_per_kquery.batch": {
             "sift1m-ivfrabitq.batch-3stage", "sift1m-ivfpq.batch-probe"},
         "scan_rerank_stream_ms_per_kquery.batch": {
             "sift1m-ivfpq.batch-full", "sift1m-ivfrabitq.batch-3stage",
             "sift1m-ivfpq.batch-probe"},
         "engine_prepare_ms.batch": {
             "sift1m-ivfpq.batch-full", "sift1m-ivfrabitq.batch-3stage",
             "sift1m-ivfpq.batch-probe"}}


def _trace(start_us: int, stream: dict | None, spans=None) -> dict:
    rows = [["engine.filter", start_us, 300],
            ["engine.search.emb", start_us + 300, 9000],
            ["index.input", start_us + 310, 200],
            ["index.prepare", start_us + 520, 1000],
            ["scan.refine", start_us + 1600, 50],
            ["index.fetch", start_us + 1700, 7000],
            ["kernel.fused_scan_rerank", start_us + 1550, 8000],
            ["engine.merge", start_us + 9400, 4000],
            ["engine.shape", start_us + 13400, 2000]]
    out = {"_phase_spans": rows if spans is None else spans}
    if stream is not None:
        out["stream_ms"] = stream
    return out


def _ctx(traces, rows_each: int = 4) -> SimpleNamespace:
    recs = []
    for i, tr in enumerate(traces):
        recs.append(Record(rows=np.arange(rows_each), due=float(i),
                           sent=float(i), done=float(i) + 0.5,
                           result=("kept",), trace=tr))
    return SimpleNamespace(window=Window(recs, 0.0, 10.0, 10.0))


def _read(name, ctx):
    return spec.load_module("metrics", name).read(ctx)


@pytest.mark.parametrize("name", sorted(STREAM))
def test_stream_readers_sum_their_span_per_kquery(name):
    span = STREAM[name]
    ctx = _ctx([_trace(1_000_000, {span: 2.0, "scan.other": 50.0}),
                _trace(2_000_000, {span: 4.0}),
                _trace(3_000_000, {"scan.other": 9.0})])
    # the third search did not run the stage: its queries do not count
    assert _read(name, ctx) == pytest.approx(6.0 / (8 / 1e3))


@pytest.mark.parametrize("name", sorted(STREAM))
def test_stream_readers_read_none_without_the_counter(name):
    assert _read(name, _ctx([_trace(1_000_000, None)])) is None
    assert _read(name, _ctx([None, None])) is None
    assert _read(name, _ctx([])) is None


def test_stream_readers_count_a_shared_dispatch_once():
    # requests the scheduler packed share one trace and one search span
    shared = _trace(1_000_000, {"scan.rerank": 3.0})
    ctx = _ctx([shared, shared, shared], rows_each=2)
    assert _read("scan_rerank_stream_ms_per_kquery.batch", ctx) == \
        pytest.approx(3.0 / (6 / 1e3))


def test_prepare_sums_filter_input_and_prepare_rows():
    ctx = _ctx([_trace(1_000_000, None), _trace(2_000_000, None)])
    # 0.3 + 0.2 + 1.0 ms: engine.search.*, scan.*, index.fetch and the
    # engine's merge and shape rows are not the host's preparation
    assert _read("engine_prepare_ms.batch", ctx) == pytest.approx(1.5)


def test_prepare_ignores_the_engine_search_rows():
    rows = [["engine.filter", 0, 100], ["engine.search.emb", 100, 5000],
            ["engine.search.other", 5100, 7000], ["index.input", 110, 40],
            ["index.prepare", 150, 60], ["index.prepare", 400, 40]]
    ctx = _ctx([_trace(0, None, spans=rows)])
    assert _read("engine_prepare_ms.batch", ctx) == pytest.approx(0.24)


def test_prepare_reads_none_without_the_program_spans():
    # a program before the spans: engine.* rows only
    rows = [["engine.filter", 0, 100], ["engine.search.emb", 100, 5000],
            ["engine.merge", 5100, 10], ["engine.shape", 5110, 10]]
    assert _read("engine_prepare_ms.batch",
                 _ctx([_trace(0, None, spans=rows)])) is None
    assert _read("engine_prepare_ms.batch", _ctx([None])) is None
    assert _read("engine_prepare_ms.batch", _ctx([])) is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_reader_is_declared_for_its_cells(name):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert set(entry["workloads"]) == CELLS[name]
    assert entry["moves"] == "search_qps"
    assert entry["layer"] == ("engine" if name.startswith("engine")
                              else "scan ops")
