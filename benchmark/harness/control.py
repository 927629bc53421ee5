"""The control of the comparison: the reference computed one precision
below the configuration's bfloat16 store (int8, `exact.int8_topk`), put
in the program's place. It answers each pool query once and goes through
the same comparison as a run; a sound comparison finds it not correct.
Its readings set the upper ends of the score gaps' limits.

    python -m benchmark.harness.control --workload <cell> --seeds <n>...
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, spec
from benchmark.harness.cell import merge
from benchmark.harness.loops import Record
from benchmark.reference import exact


def run(bench: dict, cell_name: str, seed: int, device,
        config_over: dict | None = None) -> tuple[list, dict]:
    """The comparison's numbers for the control on the cell's data."""
    device = torch.device(device)
    config = merge(spec.config(bench, spec.cell(bench, cell_name)[
        "config"]), config_over)
    data = spec.load_module("data", config["data"]["recipe"]).make(
        config["data"], seed, device)
    rows, alive, queries = exact.to_device(data.rows, data.queries,
                                           data.alive(), device)
    ids, dist = exact.int8_topk(rows, alive, queries, int(config["k"]))
    del rows, alive, queries
    keys = [[str(i) for i in r] for r in ids.cpu().tolist()]
    result = SimpleNamespace(keys=keys, scores=dist.float().cpu().numpy()
                             .reshape(-1))
    rec = Record(rows=np.arange(len(data.queries)), due=0.0, sent=0.0,
                 done=0.0, result=result)
    return check.compare(config, data, [rec], seed, device)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="the control's readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = spec.load()
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        numbers, facts = run(bench, args.workload, seed, dev)
        print("control " + json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": all(n.ok for n in numbers),
            "readings": {n.name: n.value for n in numbers}, **facts}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
