"""The 95th percentile (nearest rank) of every request's latency in the
window, timed from when the request was due to when its answer came
(host clock), so a stall counts against every request due behind it. A
request that failed or never came back counts as answered at the moment
the harness gave up on it, later than any answer."""

import math


def read(ctx):
    w = ctx.window
    give_up = w.give_up if w.give_up is not None else w.closed
    lat = sorted((r.done if r.result is not None else give_up) - r.due
                 for r in w.records)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
