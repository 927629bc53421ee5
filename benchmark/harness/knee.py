"""The knee sweep of an open-loop cell: one set-up, then steady Poisson
traffic (the cell's mix with its square wave flattened) at each of a few
rates, one after another, each for `--seconds`. For each rate: the
requests offered and answered, latency percentiles from the due time,
how late the generator ran, and the backlog (requests due and not yet
answered) at the middle and at the end of the arrivals. The knee is the
highest rate whose backlog does not grow from the middle to the end; the
cell's rate is set once from it, by hand, in its traffic file.

    python -m benchmark.harness.knee --workload sift1m-ivfpq.online-probe \
        --seed 1 --seconds 12 --rates 600 800 1000 1200
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from benchmark.harness import loops, spec
from benchmark.harness import traffic as traffic_gen
from benchmark.harness.cell import settle_heap, warm_sizes
from benchmark.harness.system import System


def backlog(records, t: float) -> int:
    """Requests due by `t` and not answered by then."""
    return sum(r.due <= t and (r.done is None or r.done > t)
               for r in records)


def rate_facts(window, rate: float) -> dict:
    rec = window.records
    lat = np.asarray([(r.done if r.result is not None else window.give_up)
                      - r.due for r in rec]) * 1e3
    late = np.asarray([r.sent - r.due for r in rec
                       if r.sent is not None]) * 1e3
    mid = window.opened + window.seconds / 2
    end = window.opened + window.seconds
    return {
        "rate": rate, "offered": len(rec),
        "answered": len(window.answered),
        "rows_per_s": sum(len(r.rows) for r in rec) / window.seconds,
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "late_p95_ms": float(np.percentile(late, 95)) if late.size else None,
        "late_max_ms": float(late.max()) if late.size else None,
        "backlog_mid": backlog(rec, mid), "backlog_end": backlog(rec, end),
        "drain_s": window.closed - end,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="knee sweep of an open loop")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    config = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    device = torch.device("cuda")
    data = spec.load_module("data", config["data"]["recipe"]).make(
        config["data"], args.seed, device)
    system = System(config, data, device)
    system.warm(warm_sizes(mix, system), mix, data.queries)
    settle_heap()
    for i, rate in enumerate(args.rates):
        steady = dict(mix, rate=rate, wave={"period_s": 1.0,
                                            "levels": [1.0]})
        sched = traffic_gen.open_schedule(steady, len(data.queries),
                                          args.seed + i, args.seconds)
        w = loops.open_loop(system, steady, data.queries, sched,
                            args.seconds, False)
        loops.release(w, system)
        print("knee " + json.dumps(rate_facts(w, rate)), flush=True)
        if system.engine is None:
            break
        time.sleep(1.0)
    system.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
