"""Device sampler, the port of vearch_tpu/obs/sampler.py: measure what
the footprint models only predict.

`measure_live_bytes` reads the CUDA caching allocator of every visible
card, `torch.cuda.memory_stats(i)["allocated_bytes.all.current"]`,
labelled ``cuda:<i>``: the bytes of live tensors, rounded up to the
allocator's 512-byte blocks. `measure_reserved_bytes` reads
``reserved_bytes.all.current`` (what the allocator has reserved on the
card, freed blocks included); it is reported beside the measurement,
never compared. Without a card both return {}: the sampler then measures
nothing rather than invent a number, and it never stands the model in
for a measurement. Tests monkeypatch `measure_live_bytes`.

`DeviceSampler` is the reference's: a baseline at the first sample (what
was resident before the model's structures: everything the model never
claimed to cover), then per device
``drift_bytes = max(0, measured - model - baseline)``, flagged as
`drift` when it exceeds ``drift_slack_bytes + drift_tolerance * model``
(64 MB + 0.5 x model). Drift is one-sided: an allocation the model does
not know of pushes the measurement above it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from vearch_tpu_torch.ops import perf_model


def _cuda_stat(key: str) -> dict[str, int]:
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get(key, 0))
            for i in range(torch.cuda.device_count())}


def measure_live_bytes() -> dict[str, int]:
    """Live tensor bytes per visible card; {} without one."""
    return _cuda_stat("allocated_bytes.all.current")


def measure_reserved_bytes() -> dict[str, int]:
    """Bytes the caching allocator holds per visible card; {} without
    one."""
    return _cuda_stat("reserved_bytes.all.current")


class DeviceSampler:
    """Samples the card on a fixed interval (`start`), or on demand
    (`sample_now`). ``model_bytes_fn`` returns the modelled resident
    bytes per device (the hosted engines' summed
    `device_footprint_bytes`)."""

    def __init__(
        self,
        model_bytes_fn: Callable[[], int],
        interval_s: float = 5.0,
        drift_tolerance: float = 0.5,
        drift_slack_bytes: int = 64 << 20,
        name: str = "ps-device-sampler",
    ):
        self.model_bytes_fn = model_bytes_fn
        self.interval_s = float(interval_s)
        self.drift_tolerance = float(drift_tolerance)
        self.drift_slack_bytes = int(drift_slack_bytes)
        self._name = name
        self._lock = threading.Lock()
        self._state: dict[str, Any] = {
            "samples": 0,
            "devices": {},
            "h2d_bytes_total": 0,
            "compiled_programs": 0,
            "model_per_device_bytes": 0,
            "baseline_per_device_bytes": {},
            "drift_bytes": 0,
            "drift": False,
        }
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self.sample_now()
        self._thread = threading.Thread(target=self._run, name=self._name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:
                # sampling must never take the server down; the stale
                # `samples` count shows a wedged sampler
                continue

    def sample_now(self) -> dict[str, Any]:
        devices = measure_live_bytes()
        model = int(self.model_bytes_fn() or 0)
        h2d = perf_model.h2d_bytes_total()
        compiled = perf_model.total_compiled_programs()
        with self._lock:
            if self._state["samples"] == 0:
                # what was resident before the modelled structures
                self._state["baseline_per_device_bytes"] = {
                    lbl: max(0, b - model) for lbl, b in devices.items()}
            base = self._state["baseline_per_device_bytes"]
            drift_bytes = 0
            for lbl, measured in devices.items():
                drift_bytes = max(drift_bytes,
                                  measured - model - base.get(lbl, 0))
            drift = drift_bytes > (self.drift_slack_bytes
                                   + self.drift_tolerance * model)
            self._state.update({
                "samples": self._state["samples"] + 1,
                "devices": devices,
                "h2d_bytes_total": h2d,
                "compiled_programs": compiled,
                "model_per_device_bytes": model,
                "drift_bytes": int(drift_bytes),
                "drift": bool(drift),
            })
            return dict(self._state)

    def rebaseline(self) -> None:
        """Capture the baseline again (after a planned change)."""
        with self._lock:
            self._state["samples"] = 0
        self.sample_now()

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            out = dict(self._state)
            out["devices"] = dict(out["devices"])
            return out
