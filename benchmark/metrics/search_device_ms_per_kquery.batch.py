"""Summed device time of every operation in the traced window (kernels,
copies, fills), per 1,000 queries answered: the scan ops' cost of a
query, in a batch cell."""

from benchmark.harness.layers import device_ms_per_kquery


def read(ctx):
    return device_ms_per_kquery(ctx)
