"""Int8 mirror bytes the two block-max kernels streamed in the traced
window, in GB per 1,000 queries answered: the sum of the `mirror_bytes`
attributes that each launch of stage 1 (every query tile walks every
row, d + 8 bytes a row) and of the stage-2 re-score (the (query tile,
block) pairs the selection lets through, 512 rows each) gives its span
on a traced request (each engine trace's `span_attrs`). It moves with
the kernels' query tile: a batch of 1,024 is 8 tiles of 128 queries at
d=128 and 16 tiles of 64 at d=960. A program whose traces carry no such
attribute (one before them), a run without a trace, or a window in
which the kernels streamed nothing reads None, so the metric is left
out of the result line."""

from benchmark.harness.layers import dispatches


def read(ctx):
    if ctx.trace is None or ctx.window is None:
        return None
    streamed, queries = 0, 0
    for group in dispatches(ctx.window):
        got = [float(attrs["mirror_bytes"]) for _, attrs
               in (group[0].trace or {}).get("span_attrs") or []
               if "mirror_bytes" in attrs]
        if got:
            streamed += sum(got)
            queries += sum(len(r.rows) for r in group)
    if streamed <= 0 or queries == 0:
        return None
    return streamed / 1e9 / (queries / 1e3)
