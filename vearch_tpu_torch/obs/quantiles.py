"""Streaming tail quantiles, the port of vearch_tpu/obs/quantiles.py: the
P^2 algorithm (Jain & Chlamtac, CACM 1985), one quantile tracked with
five markers and no sample buffer, O(1) memory and update. A
`QuantileRegistry` bundles one estimator per tracked quantile per key
and serialises access with a plain lock.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable


#: the quantiles every sketch tracks; mirrored by the gauge's ``q``
#: label values, so this tuple is also the label-cardinality bound.
TRACKED_QUANTILES: tuple[float, ...] = (0.5, 0.95, 0.99)


class P2Estimator:
    """Single-quantile P^2 marker estimator.

    Five markers bracket [min, q/2-ish, q, (1+q)/2-ish, max]; each
    observation shifts marker positions and nudges heights with a
    piecewise-parabolic fit. Below five observations the raw sample is
    kept and quantiled by nearest rank. Not thread-safe — the owning
    registry serialises access.
    """

    __slots__ = ("q", "n", "_init", "_h", "_pos", "_des", "_inc")

    def __init__(self, q: float):
        self.q = float(q)
        self.n = 0
        self._init: list[float] = []
        self._h = [0.0] * 5
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._des = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q,
                     5.0]
        self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._init.append(x)
            if self.n == 5:
                self._init.sort()
                self._h = list(self._init)
            return
        h, pos = self._h, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 3
            for i in range(1, 5):
                if x < h[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._des[i] += self._inc[i]
        for i in range(1, 4):
            d = self._des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                d <= -1.0 and pos[i - 1] - pos[i] < -1.0
            ):
                d = 1.0 if d >= 0.0 else -1.0
                hp = self._parabolic(i, d)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:
                    h[i] = self._linear(i, d)
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._h, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d)
            * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d)
            * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, pos = self._h, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])

    def value(self) -> float:
        if self.n == 0:
            return 0.0
        if self.n <= 5:
            s = sorted(self._init)
            idx = int(round(self.q * (len(s) - 1)))
            return s[max(0, min(len(s) - 1, idx))]
        return self._h[2]


class QuantileRegistry:
    """Keyed latency sketches: one P^2 estimator per tracked quantile.

    Keys are caller-chosen tuples — the PS uses ``(partition_id, op)``
    plus a node-level ``("_node", op)`` rollup; the router uses
    ``(ps_addr, op)``. ``snapshot()`` renders every key's quantile
    values and observation count in one pass for gauges and stats
    surfaces. Estimators never expire: key cardinality is bounded by
    topology (partitions hosted x ops), which is exactly the bound the
    metrics cardinality soak enforces.
    """


    def __init__(
        self, quantiles: Iterable[float] = TRACKED_QUANTILES,
        name: str = "obs.quantiles",
    ):
        self.quantiles = tuple(float(q) for q in quantiles)
        self._lock = threading.Lock()
        self._sketches: dict[tuple, list[P2Estimator]] = {}

    def observe(self, key: tuple, value: float) -> None:
        with self._lock:
            est = self._sketches.get(key)
            if est is None:
                est = [P2Estimator(q) for q in self.quantiles]
                self._sketches[key] = est
            for e in est:
                e.observe(value)

    def drop(self, key: tuple) -> None:
        """Forget a key (partition moved away); the next observation
        starts a fresh sketch."""
        with self._lock:
            self._sketches.pop(key, None)

    def snapshot(self) -> dict[tuple, dict[str, Any]]:
        """``{key: {"count": n, "q": {"0.5": v, ...}}}``; quantile keys
        are strings so snapshots survive a JSON round trip unchanged."""
        with self._lock:
            out: dict[tuple, dict[str, Any]] = {}
            for key, est in self._sketches.items():
                out[key] = {
                    "count": est[0].n if est else 0,
                    "q": {_qlabel(e.q): e.value() for e in est},
                }
            return out


def _qlabel(q: float) -> str:
    """Stable label text for a quantile: 0.5 -> "0.5", 0.95 -> "0.95"."""
    s = repr(q)
    return s.rstrip("0").rstrip(".") if "." in s else s
