"""Probe dots: the dot of each bf16 query with every live row of each
bucket it probes, int8 rows widened, f32 out. The work of
vearch_tpu_torch/csrc/probe_dots.cu (and of the TPU kernel
`ivf_probe_dots` it replaced), counted from the inputs: the live rows of
the probed buckets (the index's bucket lengths), not the padded
capacity the output is laid out in.

For one launch over queries i with probed buckets P(i) and bucket
lengths len(c): pairs = sum_i sum_{c in P(i)} len(c) dots.
Operations: 2 d a dot (on the bf16 tensor cores). Bytes, each input
once and each output once: the queries (bf16), the int8 rows of every
bucket some query probes (each bucket once), the work list (a 4-byte
pair index per (query, probe) and nlist + 2 offsets) and the bucket
lengths, and one f32 dot a pair.
"""

from __future__ import annotations

from benchmark.roofline import peaks

KERNELS = ("probe_dots_kernel",)
OPERAND = "bf16"


def ops(pairs: int, d: int) -> float:
    return 2.0 * pairs * d


def nbytes(b: int, d: int, nprobe: int, nlist: int, pairs: int,
           union_rows: int) -> float:
    return (b * d * 2 + union_rows * d + b * nprobe * 4 + (nlist + 2) * 4
            + nlist * 4 + pairs * 4)


def least_seconds(b: int, d: int, nprobe: int, nlist: int, pairs: int,
                  union_rows: int) -> float:
    """Least time of one launch."""
    return peaks.least_seconds(
        ops(pairs, d), nbytes(b, d, nprobe, nlist, pairs, union_rows),
        OPERAND)
