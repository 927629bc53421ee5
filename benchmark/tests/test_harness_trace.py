"""The device trace's reduction: busy time as the union of device
operations in the window, profiler ranges on the device's timeline left
out, and each idle gap labelled by what the launching host thread was
doing, or as time with no request in flight."""

import pytest
from torch.autograd import DeviceType

from benchmark.harness import trace


class Ev:
    def __init__(self, name, start, dur, device=False, corr=0, thread=1,
                 annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c, self._t, self._a = device, corr, thread, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


EVENTS = [
    Ev("bench.window", 0, 100),
    Ev("bench.search", 0, 60),
    Ev("aten::sort", 22, 6),
    Ev("cudaLaunchKernel", 5, 1, corr=5),
    Ev("cudaLaunchKernel", 25, 1, corr=7),
    Ev("cudaLaunchKernel", 26, 1, corr=8),
    Ev("kernel_a", 10, 10, device=True, corr=5),
    Ev("kernel_b", 30, 10, device=True, corr=7),
    Ev("kernel_b", 35, 15, device=True, corr=8),
    Ev("bench.search", 0, 60, device=True, annotation=True),
    Ev("kernel_outside", 120, 5, device=True, corr=9),
]


def test_busy_is_the_union_inside_the_window():
    s = trace.summarize(EVENTS, in_flight=[(0, 60)])
    assert s.window_ns == (0, 100)
    assert s.busy_ns == 10 + 20
    assert s.device_seconds() == pytest.approx((10 + 10 + 15) / 1e9)
    assert s.device_seconds(["kernel_b"]) == pytest.approx(25 / 1e9)
    assert s.count(["kernel_b"]) == 2
    assert [n for n, _ in s.top_ops()] == ["kernel_b", "kernel_a"]


def test_gaps_are_labelled_by_the_launching_thread():
    s = trace.summarize(EVENTS, in_flight=[(0, 60)])
    got = dict((label, ns) for label, ns in s.gaps)
    # [0, 10]: the host in bench.search before launching kernel_a;
    # [20, 30]: in aten::sort, which launched kernel_b; [50, 100]: no
    # request in flight after 60
    assert got == {"bench.search": 10, "aten::sort": 10, trace.QUIET: 50}


def test_program_spans_label_an_unfollowed_thread():
    s = trace.summarize(EVENTS, [(40, 90, "program:engine.shape")],
                        in_flight=[(0, 100)])
    assert dict(s.gaps)["program:engine.shape"] == 50
