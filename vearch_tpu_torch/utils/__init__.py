"""Shared helpers of the port's cluster plane: the copy of
vearch_tpu/utils/__init__.py without its two JAX-only helpers (the
platform env and the compilation cache), which nothing in the port calls.
"""

import time

# Span epochs are derived from monotonic measurements plus this
# process-constant anchor: durations must survive wall-clock steps
# (lint VL203), and a later NTP step merely shifts where spans sit on
# the collector's absolute timeline. Shared by every module whose
# timestamps cross function boundaries before span emission (engine
# phases, ivf dispatch capture, microbatch queue waits).
MONO_EPOCH_OFFSET = time.time() - time.monotonic()  # lint: allow[wall-clock] span epoch anchor, captured once at import


def mono_us(t_monotonic: float) -> int:
    """Monotonic seconds -> wall-anchored epoch microseconds, the
    `start_us` convention of the tracing layer."""
    return int((MONO_EPOCH_OFFSET + t_monotonic) * 1e6)


def prune_job_registry(jobs: dict, keep: int = 64) -> None:
    """Age out completed job records oldest-first, keeping `keep`
    finished entries (shared by the master and PS async-backup
    registries; caller holds the registry lock)."""
    done = [k for k in sorted(jobs, key=lambda k: jobs[k]["updated"])
            if jobs[k]["status"] in ("done", "error")]
    for old in done[:-keep]:
        del jobs[old]
