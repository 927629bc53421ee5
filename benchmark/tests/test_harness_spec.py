"""BENCHMARK.json keeps its static rules, and every file a
cell needs is found by its name."""

import copy
import json

import pytest

from benchmark.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_rules():
    assert spec.problems(BENCH) == []


@pytest.mark.parametrize("name,ok", [
    ("sift1m-ivfpq.batch-full", True), ("search_qps", True),
    ("_x", True), ("9a", True), ("a" * 64, True), ("a" * 65, False),
    ("-a", False), (".a", False), ("a b", False), ("a,b", False),
    ("a/b", False), ("µs", False), ("", False), (None, False)])
def test_names(name, ok):
    assert spec.valid_name(name) is ok


@pytest.mark.parametrize("unit,ok", [
    ("queries/s", True), ("%", True), ("ms", True), ("ratio", True),
    ("tokens/s", True), ("a" * 16, True), ("a" * 17, False),
    ("queries per s", False), ("µs", False), ("", False),
    ("ms,", False)])
def test_units(unit, ok):
    assert spec.valid_unit(unit) is ok


def _broken(path, value):
    bad = copy.deepcopy(BENCH)
    node = bad
    for key in path[:-1]:
        node = node[key]
    if value is KeyError:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return bad


@pytest.mark.parametrize("path,value", [
    (("run_seconds",), 52), (("run_seconds",), 0), (("run_seconds",), 9.5),
    (("end_to_end", 0, "bound"), 0.3), (("end_to_end", 0, "unit"), "q per s"),
    (("end_to_end", 0, "source"), "program_span"),
    (("end_to_end", 0, "why"), "extra key"),
    (("per_layer", 0, "moves"), "nothing"),
    (("per_layer", 0, "layer"), "two\nlines"),
    (("workloads", 0, "chips"), 2),
    (("workloads", 1, "config"), "no-such-config"),
    (("workloads", 0, "why"), "x" * 201),
    (("configs", 0, "reduced"), ["hidden size"]),
    (("configs", 0, "file"), "/abs/path.json"),
    (("paths",), []), (("command",), ["python3", "../run.py"]),
    (("end_to_end", 2), KeyError),
])
def test_breaches_are_named(path, value):
    assert spec.problems(_broken(path, value))


def test_duplicate_names_and_pairs_are_refused():
    bad = copy.deepcopy(BENCH)
    bad["workloads"].append(dict(bad["workloads"][0]))
    assert any("used twice" in p for p in spec.problems(bad))


def test_every_file_a_cell_needs_is_there():
    for w in BENCH["workloads"]:
        cfg = spec.config(BENCH, w["config"])
        assert cfg["name"] == w["config"]
        assert (spec.BENCH_DIR / "data" /
                f"{cfg['data']['recipe']}.py").is_file()
        assert spec.traffic(w["traffic"])["kind"] in ("closed_loop",
                                                      "open_loop")
    for m in BENCH["end_to_end"]:
        assert hasattr(spec.load_module("end_to_end", m["name"]), "read")
    for m in BENCH["per_layer"]:
        assert hasattr(spec.load_module("metrics", m["name"]), "read")


def test_configuration_files_state_source_guarantees_and_limits():
    for c in BENCH["configs"]:
        cfg = spec.config(BENCH, c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["guarantees"] and cfg["assumed"]
        assert {"unanswered", "short_answers", "malformed_answers",
                "deleted_returned", "recall_at_10", "score_gap_max",
                "score_gap_rms"} <= set(cfg["limits"])
        assert cfg["shape"]["rows"] == cfg["data"]["rows"] == 1_000_000
