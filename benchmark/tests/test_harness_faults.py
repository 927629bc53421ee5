"""The comparison catches a broken program: a whole run of a cell at a
small size on the CPU (the harness's look for a card skipped), once
sound and once with the timed path broken underneath for each fault the
cell can have, and the control (the reference one precision down, int8)
in the program's place. One card has no exchange between chips to leave
out, and a search holds no state between steps: "a step that returns its
state unchanged" is a search that hands back its previous answer."""

import time

import numpy as np
import pytest

from benchmark.harness import cell, control, spec

BENCH = spec.load()
SMALL = {"data": {"rows": 6000, "clusters": 60, "query_pool": 512},
         "index": {"params": {"ncentroids": 32, "nsubvector": 8}}}
BATCH = {"rows": 64}
ONLINE = {"rate": 40.0, "senders": 8, "drain_s": 30,
          "index_params": {"nprobe": 4}}


def run(workload, traffic_over, seconds=0.4, seed=1234567890123):
    return cell.run(BENCH, workload, seed, seconds, False, "cpu",
                    time.monotonic(), SMALL, traffic_over)


def failing(out):
    return {n.name for n in out.numbers if not n.ok}


def fault(kind):
    """A wrapper of an index's search(queries, k, valid, params) that
    breaks its answer the way `kind` says."""
    def wrap(orig):
        last = {}

        def search(self, queries, k, valid, params=None):
            if kind == "deletes_ignored":
                valid = None
            s, i = orig(self, queries, k, valid, params)
            s, i = np.array(s), np.array(i)
            if kind == "altered":
                i[:, 0] = (i[:, 0] + 7) % self.store.count
            elif kind == "half_left_out":
                i[len(i) // 2:] = -1
                s[len(s) // 2:] = -np.inf
            elif kind == "stale":
                prev = last.get(len(i))
                last[len(i)] = (s, i)
                if prev is not None:
                    s, i = prev
            return s, i
        return search
    return wrap


def test_a_sound_run_is_correct():
    out = run("sift1m-ivfpq.batch-full", BATCH)
    assert out.result["correct"], failing(out)
    assert out.result["metrics"]["search_qps"]["value"] > 0


@pytest.mark.parametrize("kind,caught", [
    ("altered", {"score_gap_max"}),
    ("half_left_out", {"short_answers", "recall_at_10"}),
    ("stale", {"recall_at_10", "score_gap_max"}),
    ("deletes_ignored", {"deleted_returned"}),
])
def test_a_broken_batch_run_is_not_correct(kind, caught, monkeypatch):
    from vearch_tpu_torch.index.ivf import IVFPQIndex

    monkeypatch.setattr(IVFPQIndex, "search",
                        fault(kind)(IVFPQIndex.search))
    out = run("sift1m-ivfpq.batch-full", BATCH)
    assert out.result["correct"] is False
    assert caught <= failing(out)


def test_a_broken_three_stage_run_is_not_correct(monkeypatch):
    from vearch_tpu_torch.index.binary import IVFRaBitQIndex

    monkeypatch.setattr(IVFRaBitQIndex, "search",
                        fault("altered")(IVFRaBitQIndex.search))
    out = run("sift1m-ivfrabitq.batch-3stage", BATCH)
    assert out.result["correct"] is False
    assert "score_gap_max" in failing(out)


def test_a_broken_online_run_is_not_correct(monkeypatch):
    """The open loop's mix (`traffic/online-probe.json`), which no cell
    of BENCHMARK.json runs yet, through the same comparison."""
    from vearch_tpu_torch.index.ivf import IVFPQIndex

    monkeypatch.setattr(IVFPQIndex, "search",
                        fault("half_left_out")(IVFPQIndex.search))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [{
        "name": "online", "config": "sift1m-ivfpq",
        "traffic": "online-probe", "chips": 1, "why": "test"}])
    out = cell.run(bench, "online", 1234567890123, 0.5, False, "cpu",
                   time.monotonic(), SMALL, ONLINE)
    assert out.result["correct"] is False
    assert "short_answers" in failing(out)


def test_the_control_is_not_correct():
    numbers, _ = control.run(BENCH, "sift1m-ivfpq.batch-full", 42, "cpu",
                             SMALL)
    assert not all(n.ok for n in numbers)
    assert {"score_gap_max", "score_gap_rms"} & {
        n.name for n in numbers if not n.ok}
