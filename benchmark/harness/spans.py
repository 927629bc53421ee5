"""Readers of the program's own spans in a traced window: the rows of
each engine trace's `_phase_spans` ([name, start epoch us, length us])
and its `stream_ms` ({device stage: ms on the CUDA stream, summed over
the search}), which vearch_tpu_torch's span API (`ops/ivf.py` `span`)
records on a traced request. A program that records neither (one that
predates the spans) gives None, so a metric read here is left out of
the result line rather than read as 0.

Requests that one engine dispatch served together share one trace
(layers.dispatches), so each dispatch is read once.
"""

from __future__ import annotations

from benchmark.harness.layers import dispatches


def stream_ms_per_kquery(ctx, name: str) -> float | None:
    """The stream time of device span `name` summed over the window's
    dispatches that ran it, per 1,000 queries those dispatches answered."""
    if ctx.window is None:
        return None
    ms, queries = 0.0, 0
    for group in dispatches(ctx.window):
        got = (group[0].trace or {}).get("stream_ms") or {}
        if name in got:
            ms += float(got[name])
            queries += sum(len(r.rows) for r in group)
    return ms / (queries / 1e3) if queries else None


def span_ms_per_search(ctx, names: tuple[str, ...], marker: str
                       ) -> float | None:
    """The mean over the window's dispatches of the summed length of
    their rows named exactly one of `names`, in ms; only dispatches whose
    trace holds a `marker` row count (a span every search of the program
    opens, so that a program without the spans reads None)."""
    if ctx.window is None:
        return None
    per_search = []
    for group in dispatches(ctx.window):
        rows = (group[0].trace or {}).get("_phase_spans") or []
        if not any(row[0] == marker for row in rows):
            continue
        per_search.append(sum(float(dur_us) for name, _, dur_us in rows
                              if name in names) / 1e3)
    return sum(per_search) / len(per_search) if per_search else None
