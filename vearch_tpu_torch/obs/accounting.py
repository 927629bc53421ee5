"""Per-space cost accounting and the SLO burn-rate engine, the port of
vearch_tpu/obs/accounting.py.

- a request-scoped space context (contextvar), bound by the caller
  before engine work and re-bound by the batch scheduler on its
  dispatcher thread (engine/batching.py captures it at submit);
- a process-global `SpaceAccountant` whose per-space meters move inside
  the same calls that feed the process ledgers (observer hooks in
  ops/ivf.py `note_dispatch` and ops/perf_model.py `note_h2d_bytes`,
  installed by `install()`), so the sum over spaces of any meter equals
  the accountant's total;
- integer microsecond device-time apportionment for co-batched buckets
  by row share, whose slices sum to the measured bucket total exactly;
- a top-K + "other" metric label policy;
- `SpaceSLOEngine`: declared per-space latency/availability objectives,
  P^2 latency quantiles and windowed good/bad counts feeding error-budget
  burn rates (a fast 5-minute window, a slow 1-hour one).

Work with no bound space (warmup, prefetch workers, background builds)
accrues to `_system`. Nothing here launches device work.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from typing import Any, Iterator


#: reserved bucket for work no request context claimed (warmup,
#: prefetch threads, background builds) — keeps sums conservation-exact
SYSTEM_SPACE = "_system"

#: reserved bucket for shadow ground-truth traffic (obs/quality.py):
#: recall-estimation re-executions bill their exact FLAT cost here so
#: tenant meters never inflate while conservation stays sum-exact
QUALITY_SPACE = "__quality__"

#: collapsed metric label once the per-space label budget is spent
OTHER_LABEL = "other"

#: distinct spaces that mint their own metric label; later arrivals
#: collapse into OTHER_LABEL. First-come stable: a label never changes
#: once assigned, so a mid-soak tenant churn cannot mint new series
#: past topk + 1.
SPACE_LABEL_TOPK = 12

#: meters every space account carries (all integers: conservation sums
#: must be exact, and floats drift)
METERS = (
    "requests",      # partition-level search RPCs billed (hedge extras excluded)
    "dispatches",    # device dispatches (same call as the dispatch ledger)
    "h2d_bytes",     # host->device bytes (same call as note_h2d_bytes)
    "device_us",     # engine device wall-time slices, µs (row-share split)
    "queue_wait_us",  # admission/gate wait, µs
    "rows",          # query rows served
    "cache_hits",    # PS result-cache hits (billed at zero device cost)
    "sheds",         # admission 429s (zero device work)
    "kills",         # deadline/slow/operator aborts
    "hedge_extras",  # duplicate hedge attempts (device cost real, request not double-billed)
)

_active_space: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "vearch_obs_active_space", default=None
)


def set_space(space: str | None) -> contextvars.Token:
    """Bind the request's space key ("db/space") for cost attribution;
    returns a token for :func:`reset_space`."""
    return _active_space.set(space)


def reset_space(token: contextvars.Token) -> None:
    _active_space.reset(token)


def current_space() -> str | None:
    """The calling context's bound space key, if any — captured at
    microbatch submit time to carry attribution across the dispatcher
    thread hop (same pattern as flight_recorder.current_trace)."""
    return _active_space.get()


@contextlib.contextmanager
def billed(space: str | None) -> Iterator[None]:
    """Scope helper: bind `space` for the duration of the block."""
    token = set_space(space)
    try:
        yield
    finally:
        reset_space(token)


class SpaceAccountant:
    """Process-global per-space meters, conservation-exact.

    Every ``charge`` increments the space's meter AND the global total
    under one lock, so ``sum(spaces) == totals`` holds at every
    observable instant. The dispatch/h2d observer hooks are invoked
    from the exact same calls that feed the process-global ledgers, so
    the accountant's totals track those ledgers delta-for-delta.
    """

    def __init__(self, label_topk: int = SPACE_LABEL_TOPK):
        self.label_topk = int(label_topk)
        # rides the heartbeat so the master can deduplicate co-located
        # PS nodes sharing one process (and therefore one accountant)
        self.scope_id = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._spaces: dict[str, dict[str, int]] = {}
        self._totals: dict[str, int] = {m: 0 for m in METERS}
        self._labels: dict[str, str] = {}

    # -- internals (callers hold _lock) ---------------------------------

    def _meters(self, space: str) -> dict[str, int]:
        m = self._spaces.get(space)
        if m is None:
            m = self._spaces[space] = {k: 0 for k in METERS}
            # label minted at first charge (not at scrape) so the
            # assignment order is the traffic order, deterministically
            n_owned = sum(1 for v in self._labels.values()
                          if v != OTHER_LABEL)
            self._labels[space] = (
                space if n_owned < self.label_topk else OTHER_LABEL
            )
        return m

    # -- charging -------------------------------------------------------

    def charge(self, meter: str, n: int = 1,
               space: str | None = None) -> None:
        """Add `n` to `meter` for `space` (default: the bound context's
        space, else the `_system` bucket)."""
        sp = space if space is not None else (
            _active_space.get() or SYSTEM_SPACE)
        n = int(n)
        with self._lock:
            self._meters(sp)[meter] += n
            self._totals[meter] += n

    def touch(self, space: str) -> None:
        """Mint the space's account (and metric label) without charging
        anything — called when a partition is hosted so residency
        gauges render before the first request."""
        with self._lock:
            self._meters(space)

    def apportion_device_us(
        self, shares: list[tuple[str | None, int]], total_us: int
    ) -> list[int]:
        """Split a co-batched bucket's measured device time across its
        requests by row share, in integer microseconds, exactly: the
        returned slices sum to `total_us` (floor division, remainder to
        the last share). Each slice is charged to its share's space."""
        total_us = int(total_us)
        total_rows = sum(max(int(r), 0) for _, r in shares)
        out: list[int] = []
        acc = 0
        for i, (_, rows) in enumerate(shares):
            if i == len(shares) - 1:
                us = total_us - acc
            else:
                us = (total_us * max(int(rows), 0)) // max(total_rows, 1)
            acc += us
            out.append(us)
        with self._lock:
            for (space, _), us in zip(shares, out):
                sp = space or SYSTEM_SPACE
                self._meters(sp)["device_us"] += us
                self._totals["device_us"] += us
        return out

    # -- ledger observer hooks (installed by install()) ------------------

    def on_dispatch(self, tag: str) -> None:
        """Called from ops.ivf.note_dispatch — the same call that feeds
        the global dispatch ledger, so per-space counts reconcile."""
        self.charge("dispatches", 1)

    def on_h2d_bytes(self, n: int) -> None:
        """Called from ops.perf_model.note_h2d_bytes — the same call
        that feeds the process H2D byte ledger."""
        self.charge("h2d_bytes", n)

    # -- rendering ------------------------------------------------------

    def label(self, space: str) -> str:
        """The metric label for `space` under the top-K policy (minting
        the account if this is the first sighting)."""
        with self._lock:
            self._meters(space)
            return self._labels[space]

    def labelled(self, meter: str, scale: float = 1.0
                 ) -> dict[tuple[str, ...], float]:
        """Aggregate a meter by metric label for a callback metric —
        bounded at topk + 2 series regardless of tenant count."""
        with self._lock:
            out: dict[tuple[str, ...], float] = {}
            for sp, m in self._spaces.items():
                key = (self._labels.get(sp, OTHER_LABEL),)
                out[key] = out.get(key, 0.0) + float(m[meter]) * scale
            return out

    def snapshot(self) -> dict[str, Any]:
        """Exact per-space meters + totals (JSON surfaces: /ps/stats,
        the heartbeat usage block, tests). Unlike the metric labels,
        this is never collapsed — conservation checks need exact keys."""
        with self._lock:
            return {
                "scope_id": self.scope_id,
                "spaces": {sp: dict(m) for sp, m in self._spaces.items()},
                "totals": dict(self._totals),
                "labels": dict(self._labels),
            }

    def reset(self) -> None:
        """Test hook: drop meters AND label assignments (the label
        budget is first-come — a soak that churns 50 synthetic tenants
        must hand the budget back)."""
        with self._lock:
            self._spaces.clear()
            self._labels.clear()
            for k in self._totals:
                self._totals[k] = 0


#: process-global accountant — one per process, like the ledgers it mirrors.
ACCOUNTANT = SpaceAccountant()


def install() -> SpaceAccountant:
    """Hook the accountant into the dispatch + H2D ledgers (idempotent).
    Called by the PS at construction; safe to call from tests."""
    from vearch_tpu_torch.ops import ivf, perf_model

    perf_model.set_h2d_observer(ACCOUNTANT.on_h2d_bytes)
    ivf.set_dispatch_observer(ACCOUNTANT.on_dispatch)
    return ACCOUNTANT


# -- per-space SLO engine (router tier) ---------------------------------------

#: SRE fast-burn page threshold: a 5-minute window burning the error
#: budget 14.4x faster than sustainable exhausts a 30-day budget in ~2
#: days — the classic multiwindow paging bound.
FAST_BURN_THRESHOLD = 14.4

#: no burn verdicts off a cold window: the first requests against a
#: space carry no budget evidence worth paging on
MIN_SLO_SAMPLES = 20

_FAST_WINDOW_S = 300.0
_SLOW_WINDOW_S = 3600.0
_N_BUCKETS = 60


class _BurnWindow:
    """Fixed-memory rolling good/bad window: N time buckets rotated by
    a monotonic clock. Not thread-safe — the owning engine locks."""

    def __init__(self, window_s: float, buckets: int = _N_BUCKETS):
        self.width = float(window_s) / buckets
        self.good = [0] * buckets
        self.bad = [0] * buckets
        self._epoch = 0  # absolute bucket index of the cursor

    def _rotate(self, now: float) -> int:
        epoch = int(now / self.width)
        ahead = epoch - self._epoch
        n = len(self.good)
        if ahead > 0:
            for i in range(min(ahead, n)):
                j = (self._epoch + 1 + i) % n
                self.good[j] = 0
                self.bad[j] = 0
            self._epoch = epoch
        return epoch % n

    def add(self, ok: bool, now: float) -> None:
        i = self._rotate(now)
        if ok:
            self.good[i] += 1
        else:
            self.bad[i] += 1

    def counts(self, now: float) -> tuple[int, int]:
        self._rotate(now)
        return sum(self.good), sum(self.bad)


class SpaceSLOEngine:
    """Declared per-space objectives -> error-budget burn rates.

    An objective is a dict on the Space entity (``slo`` field):
    ``{"latency_ms": 50, "availability": 0.999}`` — a request is *bad*
    when it errors (429/499/5xx at the router) or outlives its latency
    target. Burn rate = bad_fraction / (1 - availability): 1.0 spends
    the budget exactly at the sustainable rate; >= 14.4 over the fast
    window is the paging condition (`fast_burn`).
    """


    def __init__(self):
        self._lock = threading.Lock()
        self._objectives: dict[str, dict] = {}
        # space -> {fast: _BurnWindow, slow: _BurnWindow, q: P2 sketches,
        #           good: int, bad: int}
        self._state: dict[str, dict] = {}

    def set_objective(self, space: str, slo: dict | None) -> None:
        """Declare (or clear) a space's objective. Reconciled from the
        Space entity whenever the router (re)fetches its metadata."""
        with self._lock:
            if not slo:
                self._objectives.pop(space, None)
                self._state.pop(space, None)
                return
            if self._objectives.get(space) != slo:
                self._objectives[space] = dict(slo)

    def objective(self, space: str) -> dict | None:
        with self._lock:
            obj = self._objectives.get(space)
            return dict(obj) if obj else None

    def observe(self, space: str, latency_ms: float, ok: bool = True,
                now: float | None = None) -> None:
        """Score one logical request against the space's objective.
        No-op for spaces without a declared SLO. Hedge attempts never
        reach here — the router observes once per client request, so a
        won hedge bills once by construction."""
        from vearch_tpu_torch.obs.quantiles import P2Estimator, TRACKED_QUANTILES

        now = time.monotonic() if now is None else now
        with self._lock:
            obj = self._objectives.get(space)
            if obj is None:
                return
            st = self._state.get(space)
            if st is None:
                st = self._state[space] = {
                    "fast": _BurnWindow(_FAST_WINDOW_S),
                    "slow": _BurnWindow(_SLOW_WINDOW_S),
                    "q": {q: P2Estimator(q) for q in TRACKED_QUANTILES},
                    "good": 0, "bad": 0,
                }
            target = obj.get("latency_ms")
            bad = (not ok) or (
                target is not None and latency_ms > float(target)
            )
            st["fast"].add(not bad, now)
            st["slow"].add(not bad, now)
            if bad:
                st["bad"] += 1
            else:
                st["good"] += 1
            for est in st["q"].values():
                est.observe(float(latency_ms))

    @staticmethod
    def _burn(good: int, bad: int, budget: float) -> float:
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / max(budget, 1e-9)

    def summary(self, now: float | None = None) -> dict[str, dict]:
        """Per-space SLO state for /router/stats, the master health
        rollup, and the doctor's `slo_burn` check."""
        now = time.monotonic() if now is None else now
        with self._lock:
            out: dict[str, dict] = {}
            for space, obj in self._objectives.items():
                st = self._state.get(space)
                avail = float(obj.get("availability", 0.999))
                budget = 1.0 - avail
                threshold = float(
                    obj.get("fast_burn_threshold", FAST_BURN_THRESHOLD))
                rec: dict[str, Any] = {
                    "objective": dict(obj),
                    "samples": 0,
                    "burn_fast": 0.0,
                    "burn_slow": 0.0,
                    "fast_burn": False,
                }
                if st is not None:
                    gf, bf = st["fast"].counts(now)
                    gs, bs = st["slow"].counts(now)
                    samples = st["good"] + st["bad"]
                    burn_fast = self._burn(gf, bf, budget)
                    rec.update({
                        "samples": samples,
                        "good": st["good"],
                        "bad": st["bad"],
                        "window_fast": {"good": gf, "bad": bf},
                        "window_slow": {"good": gs, "bad": bs},
                        "burn_fast": round(burn_fast, 3),
                        "burn_slow": round(
                            self._burn(gs, bs, budget), 3),
                        "fast_burn": bool(
                            gf + bf >= MIN_SLO_SAMPLES
                            and burn_fast >= threshold
                        ),
                        "latency_ms": {
                            str(q): round(est.value(), 3)
                            for q, est in st["q"].items()
                        },
                    })
                out[space] = rec
            return out

    def burn_gauge(self) -> dict[tuple[str, ...], float]:
        """Fast-window burn rate per space for the router's
        `vearch_space_slo_burn_rate` gauge. Objectives are operator-
        declared (bounded cardinality by construction), but the top-K
        policy still applies for defence in depth."""
        summary = self.summary()
        out: dict[tuple[str, ...], float] = {}
        for i, space in enumerate(sorted(summary)):
            key = (space if i < SPACE_LABEL_TOPK else OTHER_LABEL,)
            out[key] = max(out.get(key, 0.0),
                           float(summary[space]["burn_fast"]))
        return out

    def reset(self) -> None:
        with self._lock:
            self._objectives.clear()
            self._state.clear()
