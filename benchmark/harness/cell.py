"""One run of one cell: make the data from the seed, build the system,
warm the traffic's shapes, drive the measured window, read the metrics,
free the system, and hold what it returned to the reference.

Set-up (`setup_s`) is everything from the process's start to the
window's first request: imports, the CUDA context, the data, ingest,
build, deletes and warm-up. The reference runs after the window, once
the peak memory is read and the system is freed, and is not set-up.
"""

from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.harness import check, loops, spec, trace
from benchmark.harness import traffic as traffic_gen
from benchmark.harness.system import System


@dataclass
class Context:
    """What a metric reader (`benchmark/end_to_end/<name>.py`,
    `benchmark/metrics/<name>.py`) reads. A per-layer reader's optional
    `start(ctx)` runs just before the window opens and its `read(ctx)`
    just after it closes, while `system` still serves; an end-to-end
    reader's `read(ctx)` runs after the comparison (`numbers`). `state`
    is the readers' own, keyed as they like."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    data: object
    system: System | None = None
    window: loops.Window | None = None
    trace: trace.Summary | None = None
    setup_s: float | None = None
    numbers: dict = field(default_factory=dict)
    state: dict = field(default_factory=dict)


@dataclass
class Outcome:
    result: dict                # the result line's object
    numbers: list[check.Number]  # the comparison, each beside its limit
    lines: list[str]            # the run's earlier lines of output


def merge(base: dict, over: dict | None) -> dict:
    """`base` with `over`'s entries in place of its own, nested dicts
    merged likewise (a test's smaller sizes over a configuration)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def warm_sizes(traffic: dict, system: System) -> list[int]:
    """Row counts to warm: the closed loop's batch; for the open loop one
    count for each shape a dispatch can run at (the requests' sizes and
    every power of two up to the rows one dispatch packs, one of each
    padded shape), so every shape runs before the window."""
    sizes = traffic_gen.request_sizes(traffic)
    if traffic["kind"] == "open_loop":
        b = 1
        while b <= system.max_rows():
            sizes.append(b)
            b *= 2
    by_shape = {}
    for b in sorted(sizes):
        by_shape.setdefault(system.dispatch_rows(b), b)
    return sorted(by_shape.values())


def readers(bench: dict, cell_name: str, kind: str) -> dict:
    """name -> (entry, module) of the cell's metrics of one kind
    ("end_to_end" from end_to_end/, "per_layer" from metrics/)."""
    folder = "end_to_end" if kind == "end_to_end" else "metrics"
    return {m["name"]: (m, spec.load_module(folder, m["name"]))
            for m in bench[kind] if spec.applies(m, cell_name)}


def run(bench: dict, cell_name: str, seed: int, seconds: float,
        traced: bool, device, t_start: float,
        config_over: dict | None = None,
        traffic_over: dict | None = None) -> Outcome:
    device = torch.device(device)
    cell = spec.cell(bench, cell_name)
    config = merge(spec.config(bench, cell["config"]), config_over)
    traffic = merge(spec.traffic(cell["traffic"]), traffic_over)
    if traffic["kind"] not in traffic_gen.KINDS:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    lines = []
    t0 = time.monotonic()
    recipe = spec.load_module("data", config["data"]["recipe"])
    data = recipe.make(config["data"], seed, device)
    data_s = time.monotonic() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    system = System(config, data, device)
    pool = len(data.queries)
    if traffic["kind"] == "closed_loop":
        batches = traffic_gen.closed_batches(traffic, pool, seed)
    else:
        schedule = traffic_gen.open_schedule(traffic, pool, seed, seconds)
    warm_s = system.warm(warm_sizes(traffic, system), traffic, data.queries)
    settle_heap()
    ctx = Context(cell, config, traffic, seed, seconds, traced, device,
                  data, system)
    kind = "per_layer" if traced else "end_to_end"
    mine = readers(bench, cell_name, kind)
    if traced:
        for _, mod in mine.values():
            if hasattr(mod, "start"):
                mod.start(ctx)
    compiles0 = system.compile_events()
    prof = trace.start(device) if traced else None
    ctx.setup_s = time.monotonic() - t_start
    lines.append("setup " + _json(dict(
        setup_s=ctx.setup_s, data_s=data_s, warm_s=warm_s,
        **system.timings, **system.facts())))
    with GcPauses() as gc_pauses:
        if traffic["kind"] == "closed_loop":
            window = loops.closed_loop(system, traffic, data.queries,
                                       batches, seconds, traced)
        else:
            window = loops.open_loop(system, traffic, data.queries,
                                     schedule, seconds, traced)
    window.stats.update(gc_pauses.facts())
    ctx.window = window
    if traced:
        t_tr = time.monotonic()
        ctx.trace = trace.summarize(trace.stop(prof), program_spans(window),
                                    in_flight(window))
        lines.append("trace " + _json(dict(
            reduce_s=time.monotonic() - t_tr,
            device_ops=len(ctx.trace.device), window_s=ctx.trace.window_s,
            busy_s=ctx.trace.busy_s)))
    lines.append("window " + _json(_window_facts(
        window, system.compile_events() - compiles0)))
    metrics = {}
    if traced:
        for name, (entry, mod) in mine.items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    if traced:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    loops.release(window, system)
    system.close()
    ctx.system = None
    t_ref = time.monotonic()
    numbers, facts = check.compare(config, data, window.records, seed, device)
    facts["reference_s"] = time.monotonic() - t_ref
    lines.append("reference " + _json(facts))
    ctx.numbers = {n.name: n for n in numbers}
    if not traced:
        for name, (entry, mod) in mine.items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": entry["unit"]}
    result = {
        "correct": all(n.ok for n in numbers),
        "attempted": len(window.records),
        "failed": int(ctx.numbers["unanswered"].value)
        if "unanswered" in ctx.numbers else 0,
        "metrics": metrics,
        "device": dev,
    }
    if traced:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                               "idle_gaps": ctx.trace.top_gaps(10)}
    result["checks"] = {n.name: n.entry() for n in numbers}
    return Outcome(result, numbers, lines)


def settle_heap() -> None:
    """Collect, then freeze every object the set-up left (the program's
    tables, the imported modules), so that a full collection in the
    window scans only what the window makes. Unfrozen, each full
    collection of a 1M-row engine holds the interpreter some 185 ms
    (about 173,000 tracked objects and two 1M-element lists), a dozen
    times a minute in the open loop, and the tail's share that they
    delay swings from run to run (PERF.md §5)."""
    gc.collect()
    gc.freeze()


class GcPauses:
    """Counts the garbage collector's full collections in the window and
    the seconds they held the interpreter."""

    def __enter__(self):
        self.n, self.seconds, self._t0 = 0, 0.0, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.n += 1
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)

    def facts(self) -> dict:
        return {"gc_full_collections": self.n, "gc_full_s": self.seconds}


def program_spans(window: loops.Window) -> list[tuple[int, int, str]]:
    """The program's own spans of the window's requests (each engine
    trace's `_phase_spans`: [name, start epoch us, length us]), once
    each, as (start ns, end ns, "program:" name)."""
    seen = set()
    for rec in window.answered:
        for name, start_us, dur_us in (rec.trace or {}).get(
                "_phase_spans", []):
            seen.add((int(start_us) * 1000, int(start_us + dur_us) * 1000,
                      f"program:{name}"))
    return sorted(seen)


def in_flight(window: loops.Window) -> list[tuple[int, int]]:
    """The stretches of the window in which some request was sent and not
    yet answered, on the profiler's epoch clock (ns), merged."""
    epoch = time.time() - time.monotonic()
    spans = sorted((int((r.sent + epoch) * 1e9), int((r.done + epoch) * 1e9))
                   for r in window.records
                   if r.sent is not None and r.done is not None)
    out: list[list[int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _window_facts(window: loops.Window, compiles: int) -> dict:
    late = np.asarray([r.sent - r.due for r in window.records
                       if r.sent is not None])
    lat = np.asarray([r.done - r.due for r in window.records
                      if r.result is not None])
    out = {"requests": len(window.records),
           "answered": len(window.answered),
           "queries_answered": window.queries_answered(),
           "seconds": window.closed - window.opened,
           "compile_events_in_window": compiles}
    errors = [r.error for r in window.records if r.error]
    if errors:
        out["errors"] = {"count": len(errors), "first": errors[0][:500]}
    if lat.size:
        out["latency_ms"] = {f"p{q}": float(np.percentile(lat, q)) * 1e3
                             for q in (50, 90, 95, 99)}
    if late.size:
        out["late_ms"] = {"p50": float(np.percentile(late, 50)) * 1e3,
                          "p95": float(np.percentile(late, 95)) * 1e3,
                          "max": float(late.max()) * 1e3}
    out.update({k: v for k, v in window.stats.items()
                if not k.startswith("_")})
    return out


def _json(obj) -> str:
    return json.dumps(obj, sort_keys=True)
