"""The probe-dots kernel's share of its roofline in the batch cell:
the least time for the probe dots of every dispatch in the traced window
(benchmark/roofline/probe_dots.py, live rows of the probed buckets),
over the kernel's device time in the trace."""

from benchmark.harness import layers


def start(ctx):
    layers.probe_start(ctx)


def read(ctx):
    return layers.probe_roofline_pct(ctx, "probe_dots_roofline.batch")
