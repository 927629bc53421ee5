"""The share of the reference's exact top 10 that came back, over every
answer given to the sampled pool queries in the window (the comparison's
`recall_at_10`)."""


def read(ctx):
    n = ctx.numbers.get("recall_at_10")
    return None if n is None else n.value
