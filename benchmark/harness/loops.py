"""The loops that drive the system during the measured window.

Each request is a `Record`: its pool rows, when it was due, when it was
sent, when its answer came (None if it never did), the answer or the
error, and the engine's own trace of it in a traced run. Every call into
the system is wrapped in a profiler range (`bench.search`), and the
window in `bench.window`, so the device trace can be cut to the window
and its idle gaps told apart by what the host was doing.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
from torch.profiler import record_function

from benchmark.harness.system import keep

LEAD_S = 0.2  # the open loop's senders start this long before the first due


@dataclass
class Record:
    rows: np.ndarray
    due: float
    sent: float | None = None
    done: float | None = None
    result: object = None
    error: str | None = None
    trace: dict | None = None


@dataclass
class Window:
    records: list[Record]
    opened: float
    closed: float  # when the last request sent in the window was answered
    seconds: float  # the length the mix was asked to run
    stats: dict = field(default_factory=dict)
    # the open loop's moment of giving up on unanswered requests
    give_up: float | None = None

    @property
    def answered(self) -> list[Record]:
        return [r for r in self.records if r.result is not None]

    def queries_answered(self) -> int:
        return int(sum(len(r.rows) for r in self.answered))


def _call(system, req, rec: Record, keep=None) -> None:
    """Send `req`, timing it into `rec`; `keep` turns the answer into what
    the record holds (as it is when None)."""
    rec.sent = time.monotonic()
    with record_function("bench.search"):
        try:
            result = system.search(req)
        except Exception as e:  # a failed request is counted, not raised
            rec.error = f"{type(e).__name__}: {e}"
            result = None
    rec.done = time.monotonic()
    if result is not None:
        rec.result = result if keep is None else keep(result)


def keep_small(result) -> tuple:
    return keep(result, flat_array=True)


def closed_loop(system, traffic: dict, queries: np.ndarray,
                batches: list[np.ndarray], seconds: float,
                traced: bool) -> Window:
    """One caller, back to back, until `seconds` have passed; the window
    ends when the last search sent in it is answered, so the rate counts
    all the work and all the time. Each answer is kept (system.keep) as
    it comes, inside the window: some tenths of a millisecond a batch."""
    vecs = [np.ascontiguousarray(queries[b]) for b in batches]
    records: list[Record] = []
    with record_function("bench.window"):
        opened = time.monotonic()
        end = opened + seconds
        i = 0
        while i == 0 or time.monotonic() < end:
            j = i % len(batches)
            req = system.request(vecs[j], traffic, {} if traced else None)
            rec = Record(rows=batches[j], due=time.monotonic())
            _call(system, req, rec, keep)
            rec.trace = req.trace
            records.append(rec)
            i += 1
        system.sync()
        closed = time.monotonic()
    return Window(records, opened, closed, seconds)


def open_loop(system, traffic: dict, queries: np.ndarray,
              schedule: list[tuple[float, np.ndarray]], seconds: float,
              traced: bool) -> Window:
    """Requests sent on their schedule by a pool of `traffic["senders"]`
    threads, each timed from when it was due. A sender takes the next
    request in due order, sleeps until it is due and waits for its
    answer, and keeps it as arrays (system.keep); when every sender
    is waiting, the next request goes late, and
    `Record.sent - Record.due` says by how much. Requests still
    unanswered, or not yet sent, `drain_s` after the window's length are
    given up."""
    records = [Record(rows=rows, due=0.0) for _, rows in schedule]
    lock = threading.Lock()
    nxt = [0]
    opened = time.monotonic() + LEAD_S
    give_up = opened + seconds + float(traffic["drain_s"])
    for rec, (due, _) in zip(records, schedule):
        rec.due = opened + due

    def sender() -> None:
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(records):
                return
            rec = records[i]
            wait = rec.due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            if time.monotonic() >= give_up:
                return
            # made once due, so that no request waits its turn as live
            # objects the garbage collector would carry into its oldest
            # generation
            req = system.request(np.ascontiguousarray(queries[rec.rows]),
                                 traffic, {} if traced else None)
            _call(system, req, rec, keep_small)
            rec.trace = req.trace

    threads = [threading.Thread(target=sender, daemon=True,
                                name=f"bench-sender-{i}")
               for i in range(int(traffic["senders"]))]
    for t in threads:
        t.start()
    time.sleep(max(0.0, opened - time.monotonic()))
    with record_function("bench.window"):
        for t in threads:
            t.join(max(0.0, give_up - time.monotonic()))
        system.sync()
        stuck = [t for t in threads if t.is_alive()]
        done = [r.done for r in records if r.done is not None]
        closed = max(done) if done else time.monotonic()
    return Window(records, opened, max(closed, opened), seconds,
                  stats={"stuck_senders": len(stuck), "_threads": stuck},
                  give_up=give_up)


def release(window: Window, system) -> None:
    """After a window whose senders are stuck: close the system (which
    errors their waiting calls) and wait for every sender to end."""
    stuck = window.stats.pop("_threads", [])
    if stuck:
        system.close()
        for t in stuck:
            t.join(60)
