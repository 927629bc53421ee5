"""Share of the traced window in which no operation ran on the device,
in the open-loop cell: below the knee the device waits for arrivals and
for the scheduler's host work between dispatches."""

from benchmark.harness.layers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
