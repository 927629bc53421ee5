"""Stream time of the `scan.select` device span per 1,000 queries
answered in a batch cell: the top-r selection (the three-stage chain's
stage-0 selection over the [B, N] scores; the probe regime's stable
top-r over its padded slots and the ids' gather), timed on the CUDA
stream by the program's event pair from the stage's start to its last
operation and summed over the traced window's searches (each trace's
`stream_ms`)."""

from benchmark.harness.spans import stream_ms_per_kquery


def read(ctx):
    return stream_ms_per_kquery(ctx, "scan.select")
