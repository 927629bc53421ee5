"""The device trace of a traced run (`--trace 1`): `torch.profiler` over
the measured window, reduced to what the per-layer metrics and the
`breakdown` read.

- The window is the profiler range `bench.window` that the loops open
  and close; device operations are clipped to it.
- Busy time is the union of the device operations' intervals (kernels,
  copies, fills), so overlapping operations count once; the idle share
  is 1 - busy / window.
- Device time by name sums each operation's own duration.
- Profiler ranges that kineto mirrors onto the device's timeline are
  not device work and are left out.
- Each idle gap (a stretch of the window with no device operation) is
  labelled with the innermost host range or operator open at its middle
  on the thread that launched the operation ending the gap: what the
  host was doing while the device waited for it. A thread the profiler
  did not follow (the scheduler's, where this PyTorch cannot profile
  every thread) is read from the program's own spans of the requests
  (`engine.*`, `batch.pack`, ...), marked `program:`.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from dataclasses import dataclass, field

NAME_MAX = 160  # characters of an operation's name kept in a breakdown
NO_HOST_OP = "(no host range open)"
QUIET = "(no request in flight)"
KINETO_OWN = ("Activity Buffer Request",)  # the profiler's own host events
PROGRAM = -1  # the thread key of the program's own spans


@dataclass
class Summary:
    window_ns: tuple[int, int]
    device: list[tuple[str, int, int]]  # (name, start ns, end ns), clipped
    busy_ns: int
    gaps: list[tuple[str, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def device_seconds(self, names=None) -> float:
        """Summed device time of the operations whose name holds one of
        `names` (all operations when None)."""
        return sum(e - s for n, s, e in self.device
                   if names is None or any(k in n for k in names)) / 1e9

    def count(self, names) -> int:
        return sum(any(k in n for k in names) for n, _, _ in self.device)

    def top_ops(self, n: int = 10) -> list[list]:
        by = defaultdict(int)
        for name, s, e in self.device:
            by[name[:NAME_MAX]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def top_gaps(self, n: int = 10) -> list[list]:
        by = defaultdict(int)
        for label, ns in self.gaps:
            by[label[:NAME_MAX]] += ns
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def start(device) -> object:
    """A running profiler of the host and the device, on every thread
    where this PyTorch can."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):
        prof = profile(activities=acts)
    prof.start()
    return prof


def stop(prof) -> list:
    """Stop `prof`; returns its events."""
    prof.stop()
    return prof.profiler.kineto_results.events()


def _annotation(ev) -> bool:
    """A profiler range (record_function) rather than work: kineto
    mirrors each range onto the device's timeline as well."""
    fn = getattr(ev, "is_user_annotation", None)
    if fn is not None:
        return bool(fn())
    return "annotation" in str(ev.activity_type()).lower()


def summarize(events, program_spans=(), in_flight=()) -> Summary:
    """The Summary of a traced window's `events`. `program_spans`, the
    program's own host spans ((start ns, end ns, name) on the same epoch
    clock), label the idle gaps whose launching thread the profiler did
    not record (a thread it could not follow); a gap that nothing labels
    and in which no request was in flight (`in_flight`: sorted, disjoint
    (start ns, end ns) on that clock) is QUIET: the device waited for
    arrivals."""
    from torch.autograd import DeviceType

    window = None
    host: list[tuple[int, int, str, int]] = []  # (start, end, name, thread)
    launch: dict[int, int] = {}  # correlation id -> host launch time
    dev_raw: list[tuple[str, int, int, int]] = []
    for ev in events:
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name == "bench.window":
                window = (s, e)
            elif name in KINETO_OWN:
                continue
            elif name.startswith("cuda"):
                # a CUDA runtime call: when the host launched the device
                # operation of the same correlation id
                launch[ev.correlation_id()] = s
            else:
                host.append((s, e, name, ev.start_thread_id()))
        elif not _annotation(ev):
            dev_raw.append((name, s, e, ev.correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = window
    clipped = sorted((max(s, w0), min(e, w1), n, c) for n, s, e, c in dev_raw
                     if e > w0 and s < w1)
    busy, gaps, cursor = 0, [], w0
    for s, e, _, corr in clipped:
        if s > cursor:
            gaps.append((cursor, s, corr))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1, None))
    device = [(n, s, e) for s, e, n, _ in clipped]
    host += [(s, e, name, PROGRAM) for s, e, name in program_spans]
    labelled = _label_gaps(gaps, host, launch)
    starts = [a for a, _ in in_flight]
    for k, ((a, b, _), (label, n)) in enumerate(zip(gaps, labelled)):
        i = bisect.bisect_right(starts, (a + b) // 2) - 1
        if label == NO_HOST_OP and (i < 0 or in_flight[i][1] < (a + b) // 2):
            labelled[k] = (QUIET, n)
    return Summary(window, device, busy, labelled)


def _innermost(points: list[int], spans) -> list:
    """For each of the sorted `points`, the span (start, end, ...) open
    at it that started last (the innermost of nested ones), or None."""
    spans = sorted(spans)
    out, i, open_ = [], 0, []  # open_: max-heap on start
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            heapq.heappush(open_, (-spans[i][0], i))
            i += 1
        while open_ and spans[open_[0][1]][1] < p:
            heapq.heappop(open_)
        out.append(spans[open_[0][1]] if open_ else None)
    return out


def _label_gaps(gaps, host, launch) -> list[tuple[str, int]]:
    """(label, length ns) of each gap: the innermost host range or
    operator open at the gap's middle on the thread that launched the
    device operation ending the gap (found as the innermost host span
    around that launch); where that thread is not known, the innermost
    of the program's own spans open there."""
    by_launch = sorted((launch[c], k) for k, (_, _, c) in enumerate(gaps)
                       if c in launch)
    thread_of: dict[int, int] = {}
    for (_, k), span in zip(by_launch, _innermost(
            [t for t, _ in by_launch], host)):
        if span is not None:
            thread_of[k] = span[3]
    per_thread: dict = defaultdict(list)
    for k, (a, b, _) in enumerate(gaps):
        per_thread[thread_of.get(k, PROGRAM)].append(((a + b) // 2, k))
    host_of: dict = defaultdict(list)
    for span in host:
        host_of[span[3]].append(span)
    labels = [NO_HOST_OP] * len(gaps)
    for thread, mids in per_thread.items():
        mids.sort()
        spans = host_of[thread]
        for (_, k), span in zip(mids, _innermost([m for m, _ in mids],
                                                  spans)):
            if span is not None:
                labels[k] = span[2]
    return [(lab, b - a) for lab, (a, b, _) in zip(labels, gaps)]
