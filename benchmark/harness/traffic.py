"""The one traffic generator: it reads a mix's file of parameters
(`benchmark/traffic/<mix>.json`) and makes, from the seed, what the loops
send. Every seed gets the same amount of work of each size; the seed
changes which queries go where and when.

Two kinds of mix:

- `closed_loop`: one caller sends a batch of `rows` queries, waits for
  the answer and sends the next, back to back. The pool is cut into
  batches of `rows`, in an order drawn from the seed, and sent round and
  round.
- `open_loop`: requests arrive on a schedule whether or not earlier ones
  are answered. The rate is `rate` requests a second times a square
  wave: each of `wave.levels` in turn for `wave.period_s /
  len(levels)` seconds. In each such step the number of arrivals is
  that step's rate times its length, rounded, placed at uniformly random
  times (a Poisson process given its count). Each request's number of
  rows is drawn from `rows.sizes` with `rows.shares`, as exact counts
  over the window in a seeded order, and its rows are distinct pool
  queries drawn from the seed.
"""

from __future__ import annotations

import numpy as np

KINDS = ("closed_loop", "open_loop")


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A generator for one purpose, drawn from the run's seed."""
    tag = int.from_bytes(purpose.encode(), "little") % (2 ** 63)
    return np.random.default_rng([int(seed) % (2 ** 63), tag])


def closed_batches(traffic: dict, pool: int, seed: int) -> list[np.ndarray]:
    """The closed loop's batches of pool rows, in the order they are
    sent (round and round)."""
    b = int(traffic["rows"])
    if pool < b:
        raise ValueError(f"pool of {pool} queries < batch of {b}")
    perm = rng(seed, "closed.pool").permutation(pool)
    batches = [np.sort(perm[i:i + b]) for i in range(0, pool - b + 1, b)]
    order = rng(seed, "closed.order").permutation(len(batches))
    return [batches[i] for i in order]


def wave_steps(traffic: dict, seconds: float) -> list[tuple[float, float,
                                                              float]]:
    """The open loop's steps (start s, end s, rate/s) over `seconds`."""
    wave = traffic["wave"]
    levels = [float(x) for x in wave["levels"]]
    step = float(wave["period_s"]) / len(levels)
    rate = float(traffic["rate"])
    out, t, i = [], 0.0, 0
    while t < seconds - 1e-9:
        end = min(t + step, float(seconds))
        out.append((t, end, rate * levels[i % len(levels)]))
        t, i = end, i + 1
    return out


def row_counts(traffic: dict, n: int, seed: int) -> np.ndarray:
    """Rows of each of `n` requests: exact counts of each size by its
    share (largest remainders), in an order drawn from the seed."""
    sizes = [int(s) for s in traffic["rows"]["sizes"]]
    shares = np.asarray(traffic["rows"]["shares"], dtype=np.float64)
    if len(sizes) != len(shares) or abs(shares.sum() - 1.0) > 1e-9:
        raise ValueError("rows.sizes and rows.shares must pair up, "
                         "shares summing to 1")
    want = shares * n
    counts = np.floor(want).astype(int)
    for i in np.argsort(-(want - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    out = np.repeat(np.asarray(sizes), counts)
    return rng(seed, "open.sizes").permutation(out)


def open_schedule(traffic: dict, pool: int, seed: int, seconds: float
                  ) -> list[tuple[float, np.ndarray]]:
    """The open loop's requests: (due s after the window opens, pool
    rows), in order of due time."""
    times = []
    r_time = rng(seed, "open.times")
    for t0, t1, rate in wave_steps(traffic, seconds):
        n = int(round(rate * (t1 - t0)))
        times.append(np.sort(r_time.uniform(t0, t1, n)))
    due = np.concatenate(times) if times else np.zeros(0)
    sizes = row_counts(traffic, len(due), seed)
    if sizes.size and sizes.max() > pool:
        raise ValueError(f"a request of {sizes.max()} rows > pool {pool}")
    r_rows = rng(seed, "open.rows")
    return [(float(t), np.sort(r_rows.choice(pool, int(b), replace=False)))
            for t, b in zip(due, sizes)]


def request_sizes(traffic: dict) -> list[int]:
    """The row counts a mix's requests have."""
    if traffic["kind"] == "closed_loop":
        return [int(traffic["rows"])]
    return sorted({int(s) for s in traffic["rows"]["sizes"]})
