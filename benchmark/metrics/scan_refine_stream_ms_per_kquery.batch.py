"""Stream time of the `scan.refine` device span per 1,000 queries
answered in a batch cell: stage 2 of the block-max full scan (the top
blocks' rows gathered, widened to f32 and re-scored, their top-r),
timed on the CUDA stream by the program's event pair from the stage's
start to its last operation and summed over the traced window's
searches (each trace's `stream_ms`)."""

from benchmark.harness.spans import stream_ms_per_kquery


def read(ctx):
    return stream_ms_per_kquery(ctx, "scan.refine")
