#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on one NVIDIA GPU.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. With `--trace 0` the result's metrics are
the cell's end-to-end metrics; with `--trace 1` its per-layer metrics,
read from a device trace of the window. The last line of standard output
is one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and last `checks`: each number
that decided `correct` beside its limit); the last lines of standard
error are the same numbers, one a line. Earlier lines of standard output
give the set-up's steps (`setup`), the window (`window`), the trace's
reduction (`trace`) and the comparison (`reference`).

Exits with another code than 0, and prints no result, when there is no
CUDA device or fewer than the cell asks for, when the program cannot be
imported, or when JAX or the JAX package was loaded in this process.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# import the harness and the program from the checkout, not from
# benchmark/ (the script's own directory)
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "vearch_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that must not be: JAX, its
    libraries and the JAX package, compared as whole names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> dict:
    """The card's name and power limit as nvidia-smi reads them, to keep
    beside every number of the run."""
    import subprocess

    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return {"nvidia_smi": p.stdout.strip()}
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"not read: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell, spec

    bench = spec.load()
    chips = spec.cell(bench, args.workload)["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); {seen} "
              f"visible", file=sys.stderr)
        return 2
    import vearch_tpu_torch  # noqa: F401  (the program: no result without it)

    card = card_line()
    out = cell.run(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("card " + json.dumps(card), flush=True)
    for line in out.lines:
        print(line, flush=True)
    for n in out.numbers:
        print(n.line(), file=sys.stderr, flush=True)
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
