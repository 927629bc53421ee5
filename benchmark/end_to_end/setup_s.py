"""Seconds from the process's start to the window's first request:
imports, the CUDA context, the data, ingest, build, deletes, the probe
buckets' publish and the warm-up of the cell's own shapes (host clock)."""


def read(ctx):
    return ctx.setup_s
