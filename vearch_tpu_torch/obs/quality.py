"""Search-quality truth layer, the port of vearch_tpu/obs/quality.py: live
recall estimation and index-health drift.

- Shadow recall sampling: a keyed hash selects a fraction of served
  search rows (default 1%); each is re-executed as an exact
  `brute_force` search through the port engine (the FLAT scan on the
  engine's device, which bypasses the batch scheduler) and the served
  top-k is scored against it. Per-(space, k-tier) estimators keep a
  decayed binomial (EWMA recall + Wilson interval) and a rank-biased
  overlap EWMA. Shadow work bills to accounting.QUALITY_SPACE, and its
  first execution per key runs inside the flight recorder's warmup
  scope.
- Index-health drift: `collect_health` reads each engine's
  `quality_info` (reconstruction error against its value at train time,
  cell imbalance, deleted and unindexed fractions) and marks a partition
  `needs_retrain`.

Host numpy only; the only device work is the engine's shadow search.
Every index mutation calls `note_index_mutation`, so estimators reset
instead of scoring fresh truth against a stale serving snapshot.
"""

from __future__ import annotations

import collections
import hashlib
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from vearch_tpu_torch.obs import accounting
from vearch_tpu_torch.obs import flight_recorder
from vearch_tpu_torch.obs.errors import internal_error
from vearch_tpu_torch.ops.perf_model import RECALL_K_TIERS

#: rank-biased-overlap persistence: weight of each next rank depth
RBO_P = 0.9

#: normal quantile for the Wilson recall interval (95% two-sided)
WILSON_Z = 1.96

#: ops that invalidate the train-time reconstruction baseline (the
#: quantizers themselves changed, not just the row set)
_RETRAIN_OPS = ("build", "rebuild", "train", "restore", "load")


def wilson_bounds(s: float, t: float, z: float = WILSON_Z
                  ) -> tuple[float, float]:
    """Wilson score interval for `s` successes in `t` trials (both may
    be decayed/fractional: the interval is then conservative for the
    effective sample size)."""
    if t <= 0:
        return 0.0, 1.0
    p = min(max(s / t, 0.0), 1.0)
    n = t
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def rank_biased_overlap(a: list, b: list, p: float = RBO_P) -> float:
    """Truncated-extrapolated RBO (Webber et al. 2010, eq. 30) between
    two rankings, evaluated to the shorter depth. 1.0 = identical
    ordering, 0.0 = disjoint; top ranks dominate (persistence `p`)."""
    k = min(len(a), len(b))
    if k == 0:
        return 1.0 if not a and not b else 0.0
    seen_a: set = set()
    seen_b: set = set()
    x = 0  # |A_d ∩ B_d|
    acc = 0.0
    for d in range(1, k + 1):
        ea, eb = a[d - 1], b[d - 1]
        if ea == eb:
            x += 1
        else:
            if ea in seen_b:
                x += 1
            if eb in seen_a:
                x += 1
        seen_a.add(ea)
        seen_b.add(eb)
        acc += (x / d) * (p ** d)
    return (x / k) * (p ** k) + (1 - p) / p * acc


@dataclass
class ShadowJob:
    """One sampled search row awaiting ground-truth re-execution."""

    pid: int
    space: str
    vectors: dict[str, np.ndarray]  # field -> [d] f32 query row
    k: int
    served: list  # served top-k keys, rank order
    data_version: int
    index_params: dict = field(default_factory=dict)
    # carried into the ground-truth request so truth answers the SAME
    # question the serving path did (a filtered search scored against
    # unfiltered truth would report phantom recall loss)
    filters: Any = None
    field_weights: dict = field(default_factory=dict)


class _RecallCell:
    """Decayed binomial recall estimator for one (space, k-tier)."""

    __slots__ = ("s", "t", "samples")

    def __init__(self):
        self.s = 0.0  # decayed hits
        self.t = 0.0  # decayed trials
        self.samples = 0  # undecayed count since last reset (gating)

    def update(self, hits: int, k: int, decay: float) -> None:
        self.s = (1.0 - decay) * self.s + float(hits)
        self.t = (1.0 - decay) * self.t + float(k)
        self.samples += 1

    def recall(self) -> float | None:
        return self.s / self.t if self.t > 0 else None


class _RboCell:
    __slots__ = ("value", "samples")

    def __init__(self):
        self.value = 0.0
        self.samples = 0

    def update(self, rbo: float, decay: float) -> None:
        if self.samples == 0:
            self.value = rbo
        else:
            self.value = (1.0 - decay) * self.value + decay * rbo
        self.samples += 1


#: shadow pipeline event names (the `event` label universe of
#: vearch_ps_quality_shadow_total — fixed, so cardinality is bounded)
SHADOW_EVENTS = (
    "sampled",   # row selected by the hash
    "executed",  # ground truth ran and scored
    "shed",      # negative-priority admission refused the shadow
    "stale",     # engine mutated between serve and shadow; sample dropped
    "dropped",   # queue full / engine gone
    "error",     # shadow execution raised (counted, never propagated)
)


class QualityMonitor:
    """Per-PS recall estimation + index-health drift (one per PSServer;
    in-process multi-node tests host the same pid on several nodes, so
    this is deliberately NOT process-global)."""

    def __init__(
        self,
        get_engines: Callable[[], dict[int, Any]] | None = None,
        pid_space: Callable[[int], str | None] | None = None,
        admission: Any = None,
        sample_rate: float = 0.01,
        seed: int = 0,
        decay: float = 0.02,
        min_samples: int = 20,
        queue_cap: int = 256,
        health_interval_s: float = 10.0,
        recon_ratio_max: float = 1.5,
        imbalance_cv_max: float = 2.0,
        deleted_frac_max: float = 0.3,
        unindexed_frac_max: float = 0.5,
    ):
        self._get_engines = get_engines or (lambda: {})
        self._pid_space = pid_space or (lambda pid: None)
        self._admission = admission
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.decay = float(decay)
        self.min_samples = int(min_samples)
        self.queue_cap = int(queue_cap)
        self.health_interval_s = float(health_interval_s)
        self.recon_ratio_max = float(recon_ratio_max)
        self.imbalance_cv_max = float(imbalance_cv_max)
        self.deleted_frac_max = float(deleted_frac_max)
        self.unindexed_frac_max = float(unindexed_frac_max)
        self._seed_key = self.seed.to_bytes(8, "big", signed=False)
        self._lock = threading.Lock()
        self._cells: dict[tuple[str, int], _RecallCell] = {}
        self._rbo: dict[str, _RboCell] = {}
        self._floors: dict[str, float] = {}
        self._counters: dict[str, int] = {e: 0 for e in SHADOW_EVENTS}
        self._queue: collections.deque[ShadowJob] = collections.deque()
        self._warmed: set[tuple] = set()
        self._health: dict[int, dict[str, Any]] = {}
        self._recon_baseline: dict[tuple[int, str], float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- runtime knobs ---------------------------------------------------

    def configure(self, **kw) -> None:
        """Apply runtime knob changes (PS /engine/config `quality`
        block): sample_rate, decay, min_samples, health thresholds."""
        for name in ("sample_rate", "decay", "min_samples",
                     "health_interval_s", "recon_ratio_max",
                     "imbalance_cv_max", "deleted_frac_max",
                     "unindexed_frac_max"):
            if name in kw and kw[name] is not None:
                cast = int if name == "min_samples" else float
                setattr(self, name, cast(kw[name]))

    def set_floors(self, floors: dict[str, float]) -> None:
        """Replace the per-space recall floors (heartbeat-applied from
        the master's /register response; source is Space.slo)."""
        fl = {str(k): float(v) for k, v in (floors or {}).items()}
        with self._lock:
            self._floors = fl

    def set_floor(self, space: str, floor: float | None) -> None:
        with self._lock:
            if floor is None:
                self._floors.pop(space, None)
            else:
                self._floors[space] = float(floor)

    # -- deterministic sampling -----------------------------------------

    def sampled(self, row: np.ndarray, k: int) -> bool:
        """Keyed-hash row selection: a pure function of (seed, query
        bytes, k) — replicas serving the same traffic sample the same
        set, and reruns are exactly reproducible."""
        payload = (
            np.ascontiguousarray(row, dtype=np.float32).tobytes()
            + int(k).to_bytes(4, "big", signed=False)
        )
        h = hashlib.blake2b(payload, digest_size=8,
                            key=self._seed_key).digest()
        return int.from_bytes(h, "big") < self.sample_rate * 2.0 ** 64

    def observe_search(
        self,
        pid: int,
        space: str,
        vectors: dict[str, np.ndarray],
        k: int,
        results: list,
        data_version: int,
        index_params: dict | None = None,
        filters: Any = None,
        field_weights: dict | None = None,
    ) -> int:
        """Score a served search for sampling. `vectors` is the request's
        field->[B, d] batch (a flat [d] row counts as B=1); `results` is
        the served per-row sequence — SearchResult objects or plain key
        lists (the columnar wire shape). Enqueues a ShadowJob per
        sampled row; returns how many."""
        if self.sample_rate <= 0.0 or not vectors or not results:
            return 0
        fields = sorted(vectors)
        batches = {}
        for f in fields:
            # lint: allow[host-sync] copies the sampled (host) query payload for the shadow job, no device involved
            arr = np.asarray(vectors[f], dtype=np.float32)
            batches[f] = arr[None, :] if arr.ndim == 1 else arr
        nrows = min(len(results),
                    min(b.shape[0] for b in batches.values()))
        picked = 0
        for i in range(nrows):
            if not self.sampled(batches[fields[0]][i], k):
                continue
            r = results[i]
            served = (list(r) if isinstance(r, (list, tuple))
                      else [it.key for it in r.items])
            job = ShadowJob(
                pid=pid, space=space,
                vectors={f: batches[f][i].copy() for f in fields},
                k=int(k), served=served,
                data_version=int(data_version),
                index_params=dict(index_params or {}),
                filters=filters,
                field_weights=dict(field_weights or {}),
            )
            with self._lock:
                self._counters["sampled"] += 1
                if len(self._queue) >= self.queue_cap:
                    self._counters["dropped"] += 1
                else:
                    self._queue.append(job)
                    picked += 1
        return picked

    # -- shadow execution ------------------------------------------------

    def run_pending(self, limit: int | None = None) -> int:
        """Drain queued shadow jobs synchronously (worker thread body;
        also the test hook — no thread needed for determinism)."""
        done = 0
        while limit is None or done < limit:
            with self._lock:
                if not self._queue:
                    break
                job = self._queue.popleft()
            self._execute(job)
            done += 1
        return done

    def _execute(self, job: ShadowJob) -> None:
        eng = self._get_engines().get(job.pid)
        if eng is None:
            with self._lock:
                self._counters["dropped"] += 1
            return
        if getattr(eng, "data_version", None) != job.data_version:
            # rows were written/deleted between serve and shadow: the
            # served list and fresh ground truth are for different
            # corpora — scoring them would report phantom recall loss
            with self._lock:
                self._counters["stale"] += 1
            return
        adm = self._admission
        if adm is not None and not adm.try_admit(priority=-1):
            with self._lock:
                self._counters["shed"] += 1
            return
        try:
            truth = self._ground_truth(eng, job)
        except Exception as e:  # shadow work must never break serving
            internal_error("quality.shadow", e)
            with self._lock:
                self._counters["error"] += 1
            return
        finally:
            if adm is not None:
                adm.leave()
        self._score(job, truth)

    def _ground_truth(self, eng: Any, job: ShadowJob) -> list:
        """Exact FLAT top-k over the raw store, billed to __quality__.
        brute_force bypasses the microbatcher and runs the documented
        flat_scan dispatch; the first execution per warm key runs in
        the flight recorder's warmup scope so a cold FLAT compile is
        attributed to warmup rather than paged as serving drift."""
        from vearch_tpu_torch.engine.engine import SearchRequest

        req = SearchRequest(
            vectors={f: q[None, :] for f, q in job.vectors.items()},
            k=job.k,
            filters=job.filters,
            include_fields=[],
            brute_force=True,
            field_weights=job.field_weights,
            index_params=job.index_params,
        )
        key = (job.pid, tuple(sorted(job.vectors)), job.k)
        with self._lock:
            cold = key not in self._warmed
        with accounting.billed(accounting.QUALITY_SPACE):
            if cold:
                with flight_recorder.RECORDER.warmup():
                    res = eng.search(req)
                with self._lock:
                    self._warmed.add(key)
            else:
                res = eng.search(req)
        return [it.key for it in res[0].items]

    def _score(self, job: ShadowJob, truth: list) -> None:
        rbo = rank_biased_overlap(job.served, truth)
        with self._lock:
            self._counters["executed"] += 1
            for kt in RECALL_K_TIERS:
                if kt > job.k:
                    continue
                hits = len(set(job.served[:kt]) & set(truth[:kt]))
                cell = self._cells.get((job.space, kt))
                if cell is None:
                    cell = self._cells[(job.space, kt)] = _RecallCell()
                cell.update(hits, kt, self.decay)
            rc = self._rbo.get(job.space)
            if rc is None:
                rc = self._rbo[job.space] = _RboCell()
            rc.update(rbo, self.decay)

    # -- staleness hook -----------------------------------------------------

    def note_index_mutation(self, pid: int | None = None,
                            space: str | None = None, op: str = "") -> None:
        """MUST be called by every code path that mutates index contents
        (absorb/build/delete/restore/split cutover): resets
        the affected recall estimators so fresh ground truth is never
        scored against pre-mutation serving behaviour, and invalidates
        the train-time reconstruction baseline when quantizers retrain.
        Safe to call at any frequency; it only clears streaming state."""
        with self._lock:
            if space is None:
                self._cells.clear()
                self._rbo.clear()
            else:
                for key in [k for k in self._cells if k[0] == space]:
                    del self._cells[key]
                self._rbo.pop(space, None)
            if op in _RETRAIN_OPS:
                if pid is None:
                    self._recon_baseline.clear()
                else:
                    for key in [k for k in self._recon_baseline
                                if k[0] == pid]:
                        del self._recon_baseline[key]
            if pid is not None:
                self._warmed = {w for w in self._warmed if w[0] != pid}
                self._health.pop(pid, None)

    # -- index-health drift ----------------------------------------------

    def collect_health(self) -> dict[int, dict[str, Any]]:
        """Sample every hosted engine's quality_info, compare recon
        error against its train-time baseline, and derive needs_retrain
        reasons. Called from the worker cadence and directly by tests."""
        out: dict[int, dict[str, Any]] = {}
        for pid, eng in dict(self._get_engines()).items():
            try:
                info = eng.quality_info()
            except Exception as e:
                internal_error("quality.health", e)
                continue
            reasons: list[str] = []
            if info.get("deleted_frac", 0.0) > self.deleted_frac_max:
                reasons.append(
                    f"deleted_frac={info['deleted_frac']:.3f}"
                    f">{self.deleted_frac_max}")
            fields = info.get("fields", {})
            for fname, f in fields.items():
                recon = f.get("recon_error")
                if recon is not None:
                    bkey = (pid, fname)
                    with self._lock:
                        base = self._recon_baseline.get(bkey)
                        if base is None and f.get("trained"):
                            # first sighting after (re)train: this IS
                            # the train-time value drift compares against
                            self._recon_baseline[bkey] = base = recon
                    f["recon_baseline"] = base
                    if (base is not None and base > 0
                            and recon > base * self.recon_ratio_max):
                        reasons.append(
                            f"{fname}: recon_error={recon:.4f} is "
                            f"{recon / base:.2f}x train-time {base:.4f}")
                cv = f.get("cell_imbalance_cv")
                if cv is not None and cv > self.imbalance_cv_max:
                    reasons.append(
                        f"{fname}: cell_imbalance_cv={cv:.2f}"
                        f">{self.imbalance_cv_max}")
                uf = f.get("unindexed_frac")
                if uf is not None and uf > self.unindexed_frac_max:
                    reasons.append(
                        f"{fname}: unindexed_frac={uf:.3f}"
                        f">{self.unindexed_frac_max}")
            info["needs_retrain"] = bool(reasons)
            info["reasons"] = reasons
            out[pid] = info
        with self._lock:
            self._health = out
        return out

    # -- worker ----------------------------------------------------------

    def start(self) -> None:
        """Background worker: drains shadow jobs and runs the health
        cadence. Idempotent; tests usually skip it and call
        run_pending()/collect_health() synchronously."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, name="quality-worker", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _worker(self) -> None:
        next_health = time.monotonic() + self.health_interval_s
        while not self._stop.wait(0.05):
            try:
                self.run_pending()
                now = time.monotonic()
                if now >= next_health:
                    self.collect_health()
                    next_health = now + self.health_interval_s
            except Exception as e:  # the loop must survive anything
                internal_error("quality.worker", e)

    # -- read surfaces ---------------------------------------------------

    def recall_snapshot(self) -> dict[str, Any]:
        """Per-space estimator state: EWMA recall + Wilson bounds per
        k-tier, RBO, sample counts, floor + breach verdicts."""
        with self._lock:
            spaces: dict[str, dict[str, Any]] = {}
            for (space, kt), cell in self._cells.items():
                sp = spaces.setdefault(space, {"recall": {}})
                lo, hi = wilson_bounds(cell.s, cell.t)
                sp["recall"][str(kt)] = {
                    "estimate": cell.recall(),
                    "wilson_low": lo,
                    "wilson_high": hi,
                    "samples": cell.samples,
                }
            for space, rc in self._rbo.items():
                sp = spaces.setdefault(space, {"recall": {}})
                sp["rbo"] = rc.value
                sp["rbo_samples"] = rc.samples
            for space, sp in spaces.items():
                floor = self._floors.get(space)
                sp["floor"] = floor
                sp["breach"] = self._breached_locked(space, floor)
            return {"spaces": spaces, "counters": dict(self._counters)}

    def _breached_locked(self, space: str,
                         floor: float | None) -> bool:
        """Floor breach = enough evidence that even the OPTIMISTIC end
        of the recall interval sits under the floor, at any k-tier —
        Wilson-upper gating means a breach is statistical, not one bad
        sample after an absorb."""
        if floor is None:
            return False
        for (sp, _kt), cell in self._cells.items():
            if sp != space or cell.samples < self.min_samples:
                continue
            _lo, hi = wilson_bounds(cell.s, cell.t)
            if hi < floor:
                return True
        return False

    def breach_spaces(self) -> list[str]:
        with self._lock:
            return sorted(
                sp for sp, floor in self._floors.items()
                if self._breached_locked(sp, floor)
            )

    def health_snapshot(self) -> dict[int, dict[str, Any]]:
        with self._lock:
            return {pid: dict(h) for pid, h in self._health.items()}

    def partition_stats(self, pid: int) -> dict[str, Any] | None:
        """Per-partition quality block riding the heartbeat's partition
        stats → master _node_stats → elastic.compute_plan needs_retrain."""
        with self._lock:
            h = self._health.get(pid)
            return dict(h) if h is not None else None

    def obs_summary(self) -> dict[str, Any]:
        """Compact summary riding the heartbeat obs block → master
        _node_obs → /cluster/health degradation."""
        with self._lock:
            retrain = sorted(pid for pid, h in self._health.items()
                             if h.get("needs_retrain"))
        return {
            "recall_breach_spaces": self.breach_spaces(),
            "needs_retrain_pids": retrain,
        }

    def stats(self) -> dict[str, Any]:
        """The /ps/stats `quality` block."""
        with self._lock:
            depth = len(self._queue)
            floors = dict(self._floors)
        return {
            "sampling": {
                "rate": self.sample_rate,
                "seed": self.seed,
                "decay": self.decay,
                "min_samples": self.min_samples,
                "queue": depth,
                "counters": self.counters(),
            },
            "floors": floors,
            "recall": self.recall_snapshot()["spaces"],
            "health": {str(pid): h
                       for pid, h in self.health_snapshot().items()},
        }

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)
