"""The GIST1M deployment (`gist1m-ivfpq`, its cell
`gist1m-ivfpq.batch-full`) and the kernels' mirror-byte metric
(`blockmax_mirror_gb_per_kquery.batch`): the entries keep the rules and
add only what they name, a CPU cut of the configuration (20,000 of its
960-d rows) is correct where the int8 control fails both score-gap
limits, and the metric's reader sums the `mirror_bytes` attributes of
the window's engine traces, or reads None."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import cell, control, spec
from benchmark.harness.loops import Record, Window

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELL = "gist1m-ivfpq.batch-full"
METRIC = "blockmax_mirror_gb_per_kquery.batch"
# the cell's name is appended to these lists, and to no other
APPENDED = {"search_qps", "device_idle_pct.batch",
            "search_device_ms_per_kquery.batch", "blockmax_scan_roofline",
            "engine_merge_shape_ms.batch"}
# 20,000 rows at the published width and index settings (32 subvectors
# of 30 dimensions), a hundredth of the lists
CUT = {"data": {"rows": 20_000, "clusters": 100, "query_pool": 512},
       "index": {"params": {"ncentroids": 64}}}
SEED = 3_141_592_653_589


def test_the_deployment_keeps_the_rules():
    assert spec.problems(BENCH) == []
    assert len(BENCH["workloads"]) == 4
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    entry = spec.cell(BENCH, CELL)
    assert (entry["config"], entry["traffic"]) == ("gist1m-ivfpq",
                                                   "batch-full")
    conf = next(c for c in BENCH["configs"] if c["name"] == "gist1m-ivfpq")
    assert conf["reduced"] == []
    cfg = spec.config(BENCH, "gist1m-ivfpq")
    assert cfg["data"]["dim"] == cfg["shape"]["dim"] == 960
    assert cfg["data"]["rows"] == cfg["shape"]["rows"] == 1_000_000
    assert cfg["index"] == {"type": "IVFPQ", "metric": "L2", "params": {
        "ncentroids": 2048, "nsubvector": 32, "train_iters": 8,
        "store_dtype": "bfloat16"}}
    sift = spec.config(BENCH, "sift1m-ivfpq")
    for key in ("clusters", "center_scale", "row_noise", "query_noise",
                "query_pool", "rows_seed", "delete_share"):
        assert cfg["data"][key] == sift["data"][key]
    assert cfg["limits"]["recall_at_10"] == {"min": 0.95}


def test_the_cell_joins_only_the_lists_it_names():
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed == APPENDED | {METRIC}
    entry = next(m for m in BENCH["per_layer"] if m["name"] == METRIC)
    assert entry == {
        "name": METRIC, "unit": "GB", "better": "lower",
        "source": "program_counter", "layer": "kernels",
        "moves": "search_qps",
        "workloads": ["sift1m-ivfpq.batch-full", CELL]}


@pytest.fixture(scope="module")
def cut_run():
    bench = spec.load()
    out = cell.run(bench, CELL, SEED, 0.4, False, "cpu", time.monotonic(),
                   CUT, {"rows": 64})
    numbers, _ = control.run(bench, CELL, SEED, "cpu", CUT)
    return out, {n.name: n for n in numbers}


def test_a_bf16_store_answer_passes_the_gap_limits(cut_run):
    out, _ = cut_run
    assert out.result["correct"], [n.line() for n in out.numbers]
    checks = out.result["checks"]
    for name in ("score_gap_max", "score_gap_rms"):
        assert checks[name]["value"] <= checks[name]["limit"]


def test_the_int8_control_fails_both_gap_limits(cut_run):
    _, ctrl = cut_run
    assert not ctrl["score_gap_max"].ok
    assert not ctrl["score_gap_rms"].ok


def _ctx(attrs, traced=True, batches=2):
    """A traced window of `batches` 1,024-query searches, each engine
    trace carrying `attrs` as its `span_attrs` (None: no such key)."""
    recs = []
    for i in range(batches):
        trace = {"_phase_spans": [["engine.search.emb", i, 1]]}
        if attrs is not None:
            trace["span_attrs"] = attrs
        recs.append(Record(rows=np.arange(1024), due=0.0, sent=0.0,
                           done=1.0, result=("kept",), trace=trace))
    return SimpleNamespace(trace=object() if traced else None,
                           window=Window(recs, 0.0, 1.0, 1.0), state={})


def test_the_reader_sums_both_stages_per_kquery():
    reader = spec.load_module("metrics", METRIC)
    # a 1,024-query batch at d=960: 16 tiles x 1,000,448 rows x 968 bytes
    # in stage 1, and as many through stage 2's tile map; a span that
    # ran a stage twice keeps an entry for each launch
    per_batch = 16 * 1_000_448 * 968
    attrs = [["scan.blockmax", {"query_tile": 64,
                                "mirror_bytes": per_batch}],
             ["scan.refine", {"query_tile": 64,
                              "mirror_bytes": per_batch // 2}],
             ["scan.refine", {"query_tile": 64,
                              "mirror_bytes": per_batch // 2}],
             ["scan.rerank", {"other": 1}]]
    want = 2 * 2 * per_batch / 1e9 / 2.048
    assert reader.read(_ctx(attrs)) == pytest.approx(want, rel=1e-12)
    assert 30.0 < want < 30.5


def test_the_reader_reads_none_without_trace_or_attribute():
    reader = spec.load_module("metrics", METRIC)
    attrs = [["scan.blockmax", {"mirror_bytes": 10 ** 9}]]
    assert reader.read(_ctx(attrs, traced=False)) is None
    # a program before the attribute
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx([["scan.blockmax", {"query_tile": 64}]])) \
        is None
    # nothing streamed in the window
    assert reader.read(_ctx(attrs, batches=0)) is None
