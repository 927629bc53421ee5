"""Stage 1 of the block-max full scan: every (query, live row) score of
a bf16 query against an int8 mirror row, widened to f32, times the row's
scale, as an L2 score, and the maximum of each 512-row block. The work
of vearch_tpu_torch/csrc/blockmax_scan.cu (and of the TPU kernel
`int8_blockmax_scan_pallas` it replaced), counted from the inputs, as
the kernel's first version in chip_smoke.py counted its bound (2 B N d
at the bf16 peak): the kernel widens int8 to bf16 and multiplies on the
bf16 tensor cores.

Operations: 2 d a (query, live row) pair. Bytes, each input once and
each output once: the queries (bf16) and their squared norms (f32); of
each live row its d int8 values, its f32 scale and its f32 squared
norm; the validity mask over the indexed rows (1 byte a row); the f32
block maxima [B, ceil(indexed / 512)]. A deleted row needs no score, so
its values are not counted.
"""

from __future__ import annotations

from benchmark.roofline import peaks

KERNELS = ("blockmax_wgmma_kernel",)
OPERAND = "bf16"
BLOCK = 512


def ops(b: int, live: int, d: int) -> float:
    return 2.0 * b * live * d


def nbytes(b: int, live: int, indexed: int, d: int) -> float:
    blocks = -(-indexed // BLOCK)
    return (b * d * 2 + b * 4 + live * (d + 4 + 4) + indexed
            + b * blocks * 4)


def least_seconds(b: int, live: int, indexed: int, d: int) -> float:
    """Least time of one launch over `b` queries."""
    return peaks.least_seconds(ops(b, live, d),
                               nbytes(b, live, indexed, d), OPERAND)
