"""One short run of a cell on the card, started as any run of
`benchmark/run.py` is (needs an NVIDIA GPU; skips elsewhere)."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(cuda_device, trace):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sift1m-ivfpq.batch-full", "--seed", "2147483659", "--seconds",
         "2", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    want = {m["name"] for m in spec.load()["per_layer" if trace
                                           else "end_to_end"]
            if spec.applies(m, "sift1m-ivfpq.batch-full")}
    assert set(out["metrics"]) == want
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
