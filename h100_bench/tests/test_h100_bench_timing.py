"""The end-to-end arithmetic and the device timeline on synthetic
timelines."""

from __future__ import annotations

import pytest

from h100_bench import devtrace, timing, work


def test_pass_ms_p95_is_the_interpolated_95th_percentile():
    passes = [0.1] * 95 + [0.2, 0.3, 0.4, 0.5, 0.6]
    # rank 0.95 * 99 = 94.05: 0.1 + 0.05 * (0.2 - 0.1)
    assert timing.percentile(passes, 95) == pytest.approx(0.105)
    assert timing.percentile([7.0], 95) == 7.0
    assert timing.percentile(list(range(101)), 95) == pytest.approx(95.0)
    with pytest.raises(ValueError):
        timing.percentile([], 95)


def test_mrays_is_the_references_accounting():
    # 1024^2 pixels, 1 sample, 3 bounces: 4 rays a pixel
    assert work.rays(1024 * 1024, 1, 3) == 4 * 1024 * 1024
    # 250 passes in 20 s
    assert work.rays(1024 * 1024, 250, 3) / 20.0 / 1e6 == pytest.approx(
        52.4288)


def test_union_and_gaps_of_overlapping_intervals():
    dev = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert timing.merged(dev) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert timing.busy_time(dev, (1.0, 10.0)) == pytest.approx(1.0 + 1.0
                                                               + 1.0)
    assert timing.idle_gaps(dev, (1.0, 10.0)) == [(2.0, 3.0), (4.0, 9.0)]
    assert timing.idle_gaps([], (0.0, 1.0)) == [(0.0, 1.0)]


def test_gaps_labelled_by_innermost_span_and_host_op():
    spans = [("bench.step", 0.0, 10.0), ("bench.trace_packets", 2.0, 6.0)]
    ops = [("aten::nonzero", 2.5, 3.5), ("aten::mul", 7.0, 8.0)]
    gaps = [(2.9, 3.1), (7.4, 7.6), (5.0, 5.2), (11.0, 12.0)]
    got = timing.label_gaps(gaps, spans, ops)
    assert got == pytest.approx({
        "bench.trace_packets | aten::nonzero": 0.2,
        "bench.step | aten::mul": 0.2,
        "bench.trace_packets | no host op": 0.2,
        "outside | no host op": 1.0})


def test_summarize_keeps_device_work_inside_the_window():
    ev = [
        ("user_annotation", "bench.window", 10.0, 20.0, 1),
        ("user_annotation", "bench.step", 10.0, 20.0, 1),
        ("gpu_user_annotation", "bench.window", 10.0, 20.0, 7),
        ("kernel", "void k<int>(int)", 11.0, 13.0, 7),
        ("kernel", "void k<int>(int)", 12.0, 14.0, 7),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 15.0, 15.5, 7),
        ("kernel", "void dense_resident_kernel<BW>(int)", 16.0, 17.0, 7),
        ("kernel", "void early(int)", 5.0, 6.0, 7),
        ("cpu_op", "aten::nonzero", 14.0, 15.2, 1),
        ("cpu_op", "aten::other_thread", 14.0, 15.2, 2),
    ]
    s = devtrace.summarize(ev)
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(3.0 + 0.5 + 1.0)
    assert s.device_events == 4
    assert s.device_n["void k<int>"] == 2
    assert devtrace.kernel_time(s, "dense_resident_kernel") == (1.0, 1)
    assert devtrace.kernel_time(s, "dense_resident") == (0.0, 0)
    assert s.idle_s["bench.step | aten::nonzero"] == pytest.approx(1.0)
    assert sum(s.idle_s.values()) == pytest.approx(10.0 - 4.5)


def test_summarize_needs_the_window_span():
    with pytest.raises(ValueError):
        devtrace.summarize([("kernel", "k", 0.0, 1.0, 7)])


class _Event:
    """A raw profiler event: the profiler's events do not name their
    activity, only their device and whether they are a user annotation."""

    def __init__(self, name, device, start_us, dur_us, thread, ann=False):
        self._v = (name, device, start_us * 1000, (start_us + dur_us) * 1000,
                   thread, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def _prof(evs):
    import types

    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))


def test_events_without_activity_kinds_are_classified():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [_Event("bench.window", cpu, 0, 100, 1, ann=True),
           _Event("bench.window", cuda, 0, 100, 9),
           _Event("aten::mul", cpu, 10, 5, 1),
           _Event("void k(int)", cuda, 20, 30, 9)]
    s = devtrace.summarize(devtrace.events_of(_prof(evs)))
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.device_events == 1


@pytest.mark.parametrize("device_says", [False, True])
def test_the_programs_annotations_are_not_device_work(device_says):
    """A ``record_function`` range of the program's own (no ``bench.``
    prefix) shows on the device too; it is neither a launch nor busy time,
    whether or not the device-side event says it is an annotation."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [_Event("bench.window", cpu, 0, 100, 1, ann=True),
           _Event("packets.sort", cpu, 5, 60, 1, ann=True),
           _Event("packets.sort", cuda, 5, 60, 9, ann=device_says),
           _Event("aten::sort", cpu, 6, 2, 1),
           _Event("void radix_sort(int)", cuda, 20, 10, 9),
           _Event("Memcpy DtoH (Device -> Pageable)", cuda, 40, 5, 9)]
    events = devtrace.events_of(_prof(evs))
    assert [a for a, *_ in events] == [
        "user_annotation", "user_annotation", "gpu_user_annotation",
        "cpu_op", "kernel", "kernel"]
    s = devtrace.summarize(events)
    assert s.device_events == 2
    assert s.busy_s == pytest.approx(15e-6)
    assert "packets.sort" not in s.device_s
