"""The reference's exact top-k equals a NumPy brute force, its control
rounds to int8, and it imports nothing of the program."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import exact


def brute(rows, alive, queries, k):
    d = ((queries[:, None, :].astype(np.float64)
          - rows[None, :, :].astype(np.float64)) ** 2).sum(-1)
    d[:, ~alive] = np.inf
    ids = np.lexsort((np.broadcast_to(np.arange(len(rows)), d.shape), d),
                     axis=1)[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


@pytest.mark.parametrize("n,q,k", [(3000, 50, 10), (700, 1100, 5),
                                   (40, 8, 10)])
def test_exact_topk_equals_numpy(n, q, k, monkeypatch):
    monkeypatch.setattr(exact, "ROW_CHUNK", 256)
    rng = np.random.default_rng(n)
    rows = rng.standard_normal((n, 12)).astype(np.float32)
    queries = rng.standard_normal((q, 12)).astype(np.float32)
    alive = rng.random(n) > 0.1
    ids, dist = exact.exact_topk(*exact.to_device(rows, queries, alive,
                                                  "cpu"), k)
    want_i, want_d = brute(rows, alive, queries, k)
    assert np.array_equal(ids.numpy(), want_i)
    assert np.allclose(dist.numpy(), want_d, rtol=1e-12)


def test_ties_take_the_lower_row():
    rows = np.zeros((6, 4), np.float32)
    rows[3:] = 5.0
    ids, _ = exact.exact_topk(torch.from_numpy(rows),
                              torch.ones(6, dtype=torch.bool),
                              torch.zeros((1, 4)), 3)
    assert ids.tolist() == [[0, 1, 2]]


def test_int8_round():
    x = torch.tensor([[1.0, -0.5, 0.25, 127.0], [0.0, 0.0, 0.0, 0.0]])
    r = exact.int8_round(x)
    # round half to even: -0.5 -> 0, 0.25 -> 0
    assert torch.equal(r[0], torch.tensor([1.0, 0.0, 0.0, 127.0]))
    assert torch.equal(r[1], torch.zeros(4))
    y = torch.randn(50, 64)
    err = (exact.int8_round(y) - y).abs().amax(1)
    assert torch.all(err <= y.abs().amax(1) / 254 * (1 + 1e-6))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"vearch_tpu_torch", "vearch_tpu", "jax",
                           "jaxlib", "flax"}, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.exact, benchmark.harness.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    for name in ("vearch_tpu_torch", "vearch_tpu", "jax"):
        assert f"'{name}'" not in out
