"""The run's check for JAX: top-level module names compared whole, so
the port (vearch_tpu_torch) passes and the JAX package (vearch_tpu) does
not; and run.py prints no result without a card or without the
program."""

import json
import runpy
import shutil
import subprocess
import sys
import types

import pytest

from benchmark.harness import spec

RUN = spec.BENCH_DIR / "run.py"


@pytest.fixture
def run_module():
    return runpy.run_path(str(RUN), run_name="run_under_test")


@pytest.mark.parametrize("loaded,found", [
    ("vearch_tpu_torch.engine.engine", []),
    ("vearch_tpu_torchx", []),
    ("jaxtyping", []),
    ("vearch_tpu", ["vearch_tpu"]),
    ("vearch_tpu.ops.ivf", ["vearch_tpu"]),
    ("jax.numpy", ["jax"]),
    ("jaxlib", ["jaxlib"]),
    ("flax.linen", ["flax"]),
])
def test_forbidden_modules(run_module, monkeypatch, loaded, found):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                        "vearch_tpu")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    assert run_module["forbidden_modules"]() == found


def _last_json(stdout: str):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, str(RUN), "--workload", "sift1m-ivfpq.batch-full",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert _last_json(p.stdout) is None


def test_without_the_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and benchmark/: with a
    card faked, the run stops where it imports the program."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; "
            "torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv = ['run.py', '--workload', 'sift1m-ivfpq.batch-full',"
            " '--seed', '1', '--seconds', '1', '--trace', '0']; "
            "import runpy; runpy.run_path('benchmark/run.py', "
            "run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True,
                       env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert "vearch_tpu_torch" in p.stderr
    assert _last_json(p.stdout) is None


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.harness.cell, benchmark.harness.control; "
            "from benchmark.harness import spec; b = spec.load(); "
            "[spec.load_module('metrics', m['name']) "
            "for m in b['per_layer']]; "
            "[spec.load_module('end_to_end', m['name']) "
            "for m in b['end_to_end']]; "
            "import vearch_tpu_torch.engine.engine; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "vearch_tpu"}
    assert "vearch_tpu_torch" in tops
