"""Admission control: bounded wait queue in front of the search gates.

Overload on a partition server degrades in two stages today: requests
queue on the concurrency gate (latency climbs), then the gate's 30s
acquire times out (latency has already collapsed for everyone). This
controller adds the missing first line: when the number of requests
*waiting* for a gate crosses ``queue_limit``, new arrivals are shed
immediately with 429 + Retry-After instead of joining a queue that is
already longer than anyone will wait for. Shed work never touches the
engine, so it costs zero device dispatches.

Three priority classes make the bounded queue a priority queue: normal
traffic sheds at ``queue_limit``; high-priority requests
(``priority >= 1`` in the search body — replica catch-up probes,
operator diagnostics) are allowed to queue up to twice that depth, so a
saturated node stays debuggable; low-priority work (``priority < 0`` —
the quality monitor's shadow ground-truth searches, obs/quality.py)
sheds at HALF the depth, so background truth sampling is the first
thing a loaded node drops and can never crowd out tenant traffic.

``queue_limit == 0`` disables shedding entirely (the default): the
behavior is exactly the pre-admission-control gate.
"""

from __future__ import annotations

from vearch_tpu_torch.tools import lockcheck


@lockcheck.guarded
class AdmissionController:
    """Counts waiters and sheds past the bound; the actual concurrency
    limit stays with the semaphore gates behind it."""

    _guarded_by = {
        "_waiting": "_lock",
        "shed_total": "_lock",
        "admitted_total": "_lock",
    }

    def __init__(self, queue_limit: int = 0, name: str = "ps.admission"):
        self.queue_limit = int(queue_limit)
        self._lock = lockcheck.make_lock(name)
        self._waiting = 0
        self.shed_total = 0
        self.admitted_total = 0

    def try_admit(self, priority: int = 0) -> bool:
        """Reserve a queue slot. Returns False (and counts a shed) when
        the wait queue is full for this priority class; the caller must
        pair a True return with exactly one :meth:`leave`."""
        limit = self.queue_limit
        if limit > 0 and int(priority) >= 1:
            limit *= 2
        elif limit > 0 and int(priority) < 0:
            limit = max(1, limit // 2)
        with self._lock:
            if limit > 0 and self._waiting >= limit:
                self.shed_total += 1
                return False
            self._waiting += 1
            self.admitted_total += 1
            return True

    def leave(self) -> None:
        """Release the queue slot (the request got a gate permit, timed
        out, or errored — the slot frees in every case)."""
        with self._lock:
            self._waiting -= 1

    @property
    def waiting(self) -> int:
        with self._lock:
            return self._waiting

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "queue_limit": self.queue_limit,
                "waiting": self._waiting,
                "shed_total": self.shed_total,
                "admitted_total": self.admitted_total,
            }
