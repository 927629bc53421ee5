"""The host's work before a search's first launch, per batch: the summed
`engine.filter` (the alive or filter mask), `index.input` (the query
decode and the shape-bucket pad) and `index.prepare` (the query upload,
the mirror's flush, the valid mask, the probe publish) rows of each
search's own trace, averaged over the traced window's searches. In a
one-caller loop the device is idle through all of it."""

from benchmark.harness.spans import span_ms_per_search

PREPARE = ("engine.filter", "index.input", "index.prepare")


def read(ctx):
    return span_ms_per_search(ctx, PREPARE, "index.input")
