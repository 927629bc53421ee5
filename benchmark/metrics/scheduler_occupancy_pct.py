"""How full the scheduler's dispatches were over the window: the real
rows it dispatched over the padded capacity of those dispatches (the
change of BatchScheduler.stats()'s dispatch_rows and dispatch_capacity
across the window)."""


def _stats(ctx):
    mb = ctx.system.engine._microbatcher
    return None if mb is None else mb.stats()


def start(ctx):
    ctx.state["scheduler_stats"] = _stats(ctx)


def read(ctx):
    s0, s1 = ctx.state.get("scheduler_stats"), _stats(ctx)
    if s0 is None or s1 is None:
        return None
    cap = s1["dispatch_capacity"] - s0["dispatch_capacity"]
    rows = s1["dispatch_rows"] - s0["dispatch_rows"]
    return 100.0 * rows / cap if cap > 0 else None
