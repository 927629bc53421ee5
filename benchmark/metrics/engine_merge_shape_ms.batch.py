"""The engine's host work after the index returns, per batch: the
`merge_ms` and `shape_ms` phases of each search's own trace
(Engine.search's `req.trace`), averaged over the traced window's
searches."""


def read(ctx):
    vals = [r.trace["merge_ms"] + r.trace["shape_ms"]
            for r in ctx.window.answered
            if r.trace and "merge_ms" in r.trace and "shape_ms" in r.trace]
    return sum(vals) / len(vals) if vals else None
