"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
tensor-core rates without sparsity, HBM3 bandwidth, at the 700 W power
limit). Frozen copy of PEAK_OPS / PEAK_BYTES_PER_S in
vearch_tpu_torch/ops/perf_model.py. A card set below 700 W reaches less;
the run prints its power limit (`card` line) beside the shares."""

from __future__ import annotations

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, operand: str) -> float:
    """The least time for `ops` operations on `operand` and `nbytes`
    bytes moved: the larger of the compute and the memory bound."""
    return max(ops / PEAK_OPS[operand], nbytes / PEAK_BYTES_PER_S)
