"""Helpers the per-layer metric readers share: the device's share of the
window, the dispatches a window's requests rode, the coarse probes of
pool queries, and the probe-dots work of a window's dispatches (read by
the probe_dots_roofline metrics of the batch and the online cells)."""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark.roofline import probe_dots


def device_idle_pct(ctx) -> float | None:
    """Share of the traced window with no device operation running."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def device_ms_per_kquery(ctx) -> float | None:
    """Summed device time of the window per 1,000 queries answered."""
    q = ctx.window.queries_answered() if ctx.window else 0
    if ctx.trace is None or q == 0 or not ctx.trace.device:
        return None
    return ctx.trace.device_seconds() * 1e3 / (q / 1e3)


def dispatches(window) -> list[list]:
    """The window's answered requests grouped by the engine dispatch that
    served them. A closed-loop request is its own dispatch; requests the
    scheduler packed together share their trace's `engine.search.*` span
    (one search, one start), which identifies the dispatch."""
    groups: dict = {}
    for i, rec in enumerate(window.answered):
        key = ("own", i)
        for name, start_us, _ in (rec.trace or {}).get("_phase_spans", []):
            if name.startswith("engine.search."):
                key = ("search", start_us)
                break
        groups.setdefault(key, []).append(rec)
    return list(groups.values())


def coarse_probes(ctx, pool_rows: np.ndarray, nprobe: int) -> np.ndarray:
    """[len(pool_rows), nprobe] coarse cells nearest each pool query by
    L2 to the index's centroids (the probe regime's selection), worked
    out for a reader's count of work; cached per pool row."""
    cache = ctx.state.setdefault("coarse_probes", {})
    todo = np.asarray(sorted(set(pool_rows.tolist()) - set(cache)),
                      dtype=np.int64)
    if todo.size:
        cents = ctx.system.index.centroids.float()
        q = torch.from_numpy(ctx.data.queries[todo]).to(cents.device)
        d = ((q * q).sum(1)[:, None] - 2.0 * q @ cents.T
             + (cents * cents).sum(1)[None, :])
        top = torch.topk(d, nprobe, dim=1, largest=False).indices
        for p, row in zip(todo.tolist(), top.cpu().numpy()):
            cache[p] = row
    return np.stack([cache[int(p)] for p in pool_rows])


def traced_share(name: str, launches: int, traced: int, dispatches: int
                 ) -> float | None:
    """The share of a kernel's launches whose device time the trace holds:
    the work of every dispatch times it is what that time covers. Each
    dispatch launches the kernel once, so the program's launch counter
    and the dispatches the requests' traces show must agree, or the
    metric is not read (None). The profiler may drop a few of some
    hundred thousand device records in a window (6 of 3,235 probe-dots
    launches in one open-loop run on an H100); more than 2% dropped is
    not read."""
    if launches != dispatches or launches == 0 or traced > launches \
            or traced < 0.98 * launches:
        print(f"{name}: not read (launches {launches}, traced {traced}, "
              f"dispatches {dispatches})", file=sys.stderr)
        return None
    if traced != launches:
        print(f"{name}: {launches - traced} of {launches} launches not in "
              f"the trace; the work counted is scaled to the rest",
              file=sys.stderr)
    return traced / launches


def _probe_launches() -> int:
    from vearch_tpu_torch.ops.probe_dots import ivf_probe_dots

    return ivf_probe_dots.launches


def probe_start(ctx) -> None:
    ctx.state["probe_launches"] = _probe_launches()


def probe_roofline_pct(ctx, name: str) -> float | None:
    """100 x the least time of every dispatch's probe dots over the
    kernel's device time in the trace (see traced_share)."""
    if ctx.trace is None:
        return None
    seconds = ctx.trace.device_seconds(probe_dots.KERNELS)
    launches = _probe_launches() - ctx.state["probe_launches"]
    groups = dispatches(ctx.window)
    traced = ctx.trace.count(probe_dots.KERNELS)
    scale = traced_share(name, launches, traced, len(groups))
    if seconds <= 0 or scale is None:
        return None
    index = ctx.system.index
    lens = np.asarray(index.cell_populations(), dtype=np.int64)
    nlist = len(lens)
    nprobe = min(int(ctx.traffic["index_params"]["nprobe"]), nlist)
    least = 0.0
    for g in groups:
        rows = np.concatenate([r.rows for r in g])
        probes = coarse_probes(ctx, rows, nprobe)
        pairs = int(lens[probes].sum())
        union = int(lens[np.unique(probes)].sum())
        least += probe_dots.least_seconds(len(rows), ctx.data.dim, nprobe,
                                          nlist, pairs, union)
    return 100.0 * least * scale / seconds
