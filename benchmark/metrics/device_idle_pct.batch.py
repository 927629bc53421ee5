"""Share of the traced window in which no operation ran on the device,
in a closed-loop batch cell: the host's gaps between and inside
searches, which a faster host path turns into search_qps."""

from benchmark.harness.layers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
