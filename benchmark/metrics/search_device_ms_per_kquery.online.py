"""Summed device time of every operation in the traced window, per 1,000
queries answered, in the open-loop cell, where padded shape buckets and
partly filled dispatches add work a query."""

from benchmark.harness.layers import device_ms_per_kquery


def read(ctx):
    return device_ms_per_kquery(ctx)
