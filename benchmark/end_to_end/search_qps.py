"""Queries answered in the window over the window's seconds, from the
first search sent to the answer of the last one sent before the window's
length was up (host clock)."""


def read(ctx):
    w = ctx.window
    return w.queries_answered() / (w.closed - w.opened)
