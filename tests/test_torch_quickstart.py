"""The port's quickstart (examples/python/quickstart_torch.py) runs and
prints what tests/test_quickstart_example.py asserts of the reference's:
the same lines, tags and phase names (none differ between the two
packages). Without `--device` its partition servers take the card, so
with no GPU visible it refuses to start."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "python", "quickstart_torch.py")


def test_quickstart_torch_runs_and_prints_profile():
    out = subprocess.run([sys.executable, SCRIPT, "--device", "cpu"],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "top hit: doc-42" in out.stdout
    assert "profile (2 partitions" in out.stdout
    assert "dispatches    ['flat_scan']" in out.stdout
    assert "write profile (" in out.stdout
    assert "wal_append" in out.stdout
    assert "build done in" in out.stdout
    assert "slow-query log (threshold 0.001 ms):" in out.stdout
    assert "(phases [" in out.stdout
    assert "quickstart OK" in out.stdout


def test_quickstart_torch_defaults_to_the_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    assert "quickstart OK" not in out.stdout
