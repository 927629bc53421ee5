"""The traffic generator and the loops: the open loop's mean rate and
square wave, the same work for every seed, determinism per seed, and how
lateness and latency are accounted."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import loops, spec, traffic

ONLINE = spec.traffic("online-probe")


def test_open_loop_rate_and_square_wave():
    mix = dict(ONLINE, rate=500.0)
    sched = traffic.open_schedule(mix, 8192, 11, 20.0)
    due = np.asarray([t for t, _ in sched])
    assert np.all(np.diff(due) >= 0) and due.min() >= 0 and due.max() < 20
    # 20 s of a 4 s wave: 5 x (2 s at 625/s + 2 s at 375/s)
    assert len(sched) == 5 * (1250 + 750)
    counts = np.histogram(due, bins=np.arange(0, 21, 2.0))[0]
    assert counts.tolist() == [1250, 750] * 5
    assert len(sched) / 20.0 == pytest.approx(500.0)


def test_open_loop_partial_step():
    steps = traffic.wave_steps(dict(ONLINE, rate=100.0), 5.0)
    assert steps == [(0.0, 2.0, 125.0), (2.0, 4.0, 75.0), (4.0, 5.0, 125.0)]


def test_open_loop_sizes_are_exact_shares():
    sched = traffic.open_schedule(dict(ONLINE, rate=250.0), 8192, 3, 8.0)
    sizes = np.asarray([len(r) for _, r in sched])
    assert len(sizes) == 2000
    for size, share in zip([1, 4, 16, 64], [0.5, 0.25, 0.15, 0.1]):
        assert (sizes == size).sum() == round(share * 2000)
    assert all(len(set(r.tolist())) == len(r) for _, r in sched)
    assert max(r.max() for _, r in sched) < 8192


def test_every_seed_gets_the_same_work():
    a = traffic.open_schedule(ONLINE, 8192, 1, 12.0)
    b = traffic.open_schedule(ONLINE, 8192, 2, 12.0)
    assert len(a) == len(b)
    assert sorted(len(r) for _, r in a) == sorted(len(r) for _, r in b)
    assert [t for t, _ in a] != [t for t, _ in b]


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_schedules_repeat_per_seed(seed):
    a = traffic.open_schedule(ONLINE, 8192, seed, 6.0)
    b = traffic.open_schedule(ONLINE, 8192, seed, 6.0)
    assert [t for t, _ in a] == [t for t, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    c1 = traffic.closed_batches(spec.traffic("batch-full"), 8192, seed)
    c2 = traffic.closed_batches(spec.traffic("batch-full"), 8192, seed)
    assert all(np.array_equal(x, y) for x, y in zip(c1, c2))


def test_closed_batches_cover_the_pool_once():
    batches = traffic.closed_batches(spec.traffic("batch-full"), 8192, 9)
    assert len(batches) == 8 and all(len(b) == 1024 for b in batches)
    assert sorted(np.concatenate(batches).tolist()) == list(range(8192))


class SlowSystem:
    """Answers after `service_s`, one request at a time."""

    def __init__(self, service_s):
        self.service_s = service_s
        import threading

        self.lock = threading.Lock()

    def request(self, vectors, mix, trace=None):
        return SimpleNamespace(n=len(vectors), trace=trace)

    def search(self, req):
        with self.lock:
            time.sleep(self.service_s)
        return SimpleNamespace(keys=[["0"]] * req.n,
                               scores=np.zeros(req.n))

    def sync(self):
        pass


def test_lateness_and_latency_accounting():
    # 40 requests due at once, 4 senders, 20 ms each one at a time: the
    # senders hold 4 at a time, so later requests go late and every
    # latency counts from the due time
    mix = {"senders": 4, "drain_s": 10}
    sched = [(0.0, np.asarray([i])) for i in range(40)]
    w = loops.open_loop(SlowSystem(0.02), mix, np.zeros((40, 2)), sched,
                        0.1, False)
    late = sorted(r.sent - r.due for r in w.records)
    lat = sorted(r.done - r.due for r in w.records)
    assert late[3] < 0.05 and late[-1] > 0.6
    assert lat[-1] > 0.75
    assert all(r.done >= r.sent >= r.due - 1e-3 for r in w.records)
    ctx = SimpleNamespace(window=w)
    p95 = spec.load_module("end_to_end", "search_p95_ms").read(ctx)
    assert p95 == pytest.approx(lat[37] * 1e3)


def test_unanswered_requests_count_as_given_up():
    mix = {"senders": 2, "drain_s": 0.2}
    sched = [(0.0, np.asarray([i])) for i in range(10)]
    w = loops.open_loop(SlowSystem(0.15), mix, np.zeros((10, 2)), sched,
                        0.0, False)
    missing = [r for r in w.records if r.result is None]
    assert len(missing) >= 7 and w.stats["stuck_senders"] == 2
    ctx = SimpleNamespace(window=w)
    p95 = spec.load_module("end_to_end", "search_p95_ms").read(ctx)
    assert p95 >= (w.give_up - max(r.due for r in w.records)) * 1e3 - 1e-6
    loops.release(w, SimpleNamespace(close=lambda: None))
