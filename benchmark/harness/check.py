"""The comparison that decides `correct`: what `Engine.search` returned in
the window against the plain reference (`benchmark/reference/exact.py`),
on the rows, deletes and queries the harness made from the seed.

Every answer due in the window is read and judged: the reference works
out the exact top k of every query of the pool (a pass over every row a
query, some milliseconds for the pool on the card), and every hit of
every answer is scored again.

The numbers, each with its limit in the configuration's `limits`:

- `unanswered`: requests sent in the window that failed or never came
  back (0: a request is due an answer);
- `short_answers`: answers with fewer than k hits (0: each query has far
  more than k live rows);
- `malformed_answers`: answers with a key that is no row, a row twice,
  or scores not finite and ascending (0);
- `deleted_returned`: hits on a deleted row, over every answer (0: the
  configurations' guarantee);
- `recall_at_10`: the share of the reference's exact top k that came
  back, over every answer (at least the configuration's stated recall);
- `score_gap_max`, `score_gap_rms`: for each hit, the gap between the
  squared L2 score the program returned and the reference's exact one
  for that row, |s - d| / (sqrt(d) |v| + 2^-24 (|q|^2 + |v|^2)): the
  first term is the scale of an error in the stored row or the query
  (d changes by 2 (q - v) . delta), the second that of f32 round-off in
  |q|^2 - 2 q.v + |v|^2. Their largest and their root mean square
  (NO_HITS when no hit came back to judge).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.harness.system import columns
from benchmark.reference import exact

PAIR_CHUNK = 131_072  # hits whose distances one pass computes
NO_HITS = 1e9  # a score gap when no hit came back to judge


@dataclass
class Number:
    name: str
    value: float
    limit: float
    need: str  # "max": value <= limit; "min": value >= limit

    @property
    def ok(self) -> bool:
        if self.need == "max":
            return self.value <= self.limit
        return self.value >= self.limit

    def line(self) -> str:
        op = "<=" if self.need == "max" else ">="
        return (f"check {self.name} {self.value!r} {op} {self.limit!r} "
                f"{'ok' if self.ok else 'FAIL'}")

    def entry(self) -> dict:
        return {"value": self.value, "limit": self.limit,
                "need": "<=" if self.need == "max" else ">="}


@dataclass
class Tally:
    unanswered: int = 0
    short: int = 0
    malformed: int = 0
    deleted_returned: int = 0
    # every answer: its pool query [m], hit rows [m, k] (-1 past its
    # hits), hit scores [m, k] (nan past them), and whether it is
    # malformed [m]
    pool_rows: np.ndarray = None
    ids: np.ndarray = None
    scores: np.ndarray = None
    bad: np.ndarray = None


def _one_by_one(lens, keys, scores, k: int):
    """(hit rows, scores, malformed) of answers read one by one: a key
    that is no row number reads -1 and marks its answer malformed."""
    ids = np.full((len(lens), k), -1, dtype=np.int64)
    sc = np.full((len(lens), k), np.nan)
    bad = lens > k
    pos = 0
    for j, n in enumerate(lens.tolist()):
        for c, key in enumerate(list(keys[pos:pos + min(n, k)])):
            try:
                ids[j, c] = int(key)
            except ValueError:
                bad[j] = True
        sc[j, :min(n, k)] = scores[pos:pos + min(n, k)]
        pos += n
    return ids, sc, bad


def tally(records, k: int, n: int, deleted: np.ndarray) -> Tally:
    """Read every answer of `records` (loops.Record)."""
    t = Tally()
    parts = []
    for rec in records:
        if rec.result is None:
            t.unanswered += 1
            continue
        lens, keys, scores = columns(rec.result)
        if len(lens) != len(rec.rows):
            t.unanswered += 1
            continue
        try:
            if not (lens == k).all():
                raise ValueError("ragged")
            ids = np.asarray(keys, dtype=np.int64).reshape(len(lens), k)
            sc = scores.reshape(len(lens), k)
            bad = np.zeros(len(lens), dtype=bool)
        except ValueError:
            ids, sc, bad = _one_by_one(lens, keys, scores, k)
        t.short += int((lens < k).sum())
        parts.append((np.asarray(rec.rows), ids, sc, bad, lens))
    if not parts:
        parts = [(np.zeros(0, np.int64), np.zeros((0, k), np.int64),
                  np.zeros((0, k)), np.zeros(0, bool), np.zeros(0, int))]
    t.pool_rows = np.concatenate([p[0] for p in parts]).astype(np.int64)
    t.ids = np.concatenate([p[1] for p in parts])
    t.scores = np.concatenate([p[2] for p in parts])
    lens = np.minimum(np.concatenate([p[4] for p in parts]), k)
    present = np.arange(k)[None, :] < lens[:, None]
    srt = np.sort(np.where(present, t.ids, -1 - np.arange(k)[None, :]), 1)
    with np.errstate(invalid="ignore"):
        step = np.diff(t.scores, axis=1)
    bad = np.concatenate([p[3] for p in parts])
    bad |= (present & ((t.ids < 0) | (t.ids >= n))).any(1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= (present & ~np.isfinite(t.scores)).any(1)
    bad |= (present[:, 1:] & (step < 0)).any(1)
    t.bad = bad
    t.malformed = int(bad.sum())
    t.deleted_returned = int((present & np.isin(t.ids, deleted)).sum())
    return t


def score_gaps(rows: torch.Tensor, queries: torch.Tensor, pool_rows,
               ids, scores) -> np.ndarray:
    """The normalised gap of every hit (pool query, hit row, score)."""
    out = []
    dev = rows.device
    for lo in range(0, len(pool_rows), PAIR_CHUNK):
        hi = min(lo + PAIR_CHUNK, len(pool_rows))
        q = queries[torch.from_numpy(pool_rows[lo:hi]).to(dev)].double()
        v = rows[torch.from_numpy(ids[lo:hi]).to(dev)].double()
        d = ((q - v) ** 2).sum(1)
        vsq, qsq = (v * v).sum(1), (q * q).sum(1)
        scale = torch.sqrt(d * vsq) + 2.0 ** -24 * (qsq + vsq)
        s = torch.from_numpy(scores[lo:hi]).to(dev)
        out.append(((s - d).abs() / scale).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def compare(config: dict, data, records, seed: int, device
            ) -> tuple[list[Number], dict]:
    """The numbers that decide `correct`, each beside its limit, and the
    facts the run reports about the comparison."""
    k = int(config["k"])
    t = tally(records, k, data.n, data.deleted)
    rows, alive, queries = exact.to_device(data.rows, data.queries,
                                           data.alive(), device)
    truth, _ = exact.exact_topk(rows, alive, queries, k)
    truth = truth.cpu().numpy()
    found = 0
    for lo in range(0, len(t.pool_rows), PAIR_CHUNK):
        hi = min(lo + PAIR_CHUNK, len(t.pool_rows))
        found += int((t.ids[lo:hi, :, None]
                      == truth[t.pool_rows[lo:hi]][:, None, :]).any(2).sum())
    recall = found / (k * len(t.pool_rows)) if len(t.pool_rows) else 0.0
    good = ~t.bad[:, None] & (t.ids >= 0) & np.isfinite(t.scores)
    reps = np.broadcast_to(t.pool_rows[:, None], t.ids.shape)
    gaps = score_gaps(rows, queries, reps[good], t.ids[good],
                      t.scores[good])
    del rows, alive, queries
    values = {
        "unanswered": t.unanswered,
        "short_answers": t.short,
        "malformed_answers": t.malformed,
        "deleted_returned": t.deleted_returned,
        "recall_at_10": recall,
        "score_gap_max": float(gaps.max()) if gaps.size else NO_HITS,
        "score_gap_rms": float(np.sqrt(np.mean(gaps ** 2)))
        if gaps.size else NO_HITS,
    }
    numbers = [Number(name, float(values[name]), float(lim[need]), need)
               for name, lim in config["limits"].items()
               for need in ("max", "min") if need in lim]
    facts = {"answers_read": int(len(t.pool_rows)),
             "hits_judged": int(gaps.size)}
    return numbers, facts
