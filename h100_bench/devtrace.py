"""The device timeline of a traced window, read from ``torch.profiler``.

The benchmark marks its own host spans with ``record_function`` names that
start with ``bench.``; ``bench.window`` bounds the traced window. From the
profiler's raw events it keeps the device's kernels and memory operations
(their union is the busy time; the device-side copies of annotated ranges,
the benchmark's or the program's, are not work), the host operations of
the thread that ran the window, and the benchmark's spans, and labels each
idle stretch of the device by what that thread was doing at its midpoint.
"""

from __future__ import annotations

import re
from typing import NamedTuple

from . import timing

SPAN_PREFIX = "bench."
WINDOW = "bench.window"
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    device_events: int       # kernels and memory operations in the window
    device_s: dict           # device seconds by event name
    device_n: dict           # events by name
    idle_s: dict             # idle seconds by "span | host operation"


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its trailing argument list, at most
    ``width`` characters."""
    depth = 0
    for i in range(len(name) - 1, -1, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i].rstrip()
            break
    return name[:width]


def events_of(prof):
    """-> [(activity, name, start_s, end_s, thread)] of a finished
    ``torch.profiler.profile``, read from its raw events. The events do not
    name their activity, so it is worked out: a host event is a
    ``user_annotation`` where the event says it is one (a
    ``record_function`` range, the benchmark's or the program's) or bears
    the benchmark's prefix, else a
    ``cpu_op``; a device event is a ``gpu_user_annotation`` where it says
    so or bears a host annotation's name (the device-side copy of that
    range), else a ``kernel`` (kernels and memory operations: the device's
    work)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = [(e.device_type() == cuda,
            e.is_user_annotation() or e.name().startswith(SPAN_PREFIX),
            e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9,
            e.start_thread_id())
           for e in prof.profiler.kineto_results.events()]
    annotations = {n for dev, ann, n, *_ in raw if ann and not dev}
    out = []
    for dev, ann, name, s, t, th in raw:
        if dev:
            act = ("gpu_user_annotation" if ann or name in annotations
                   else "kernel")
        else:
            act = "user_annotation" if ann else "cpu_op"
        out.append((act, name, s, t, th))
    return out


def summarize(events) -> TraceSummary:
    """The window's busy and idle time from ``events_of``'s tuples."""
    window = next(((s, e, th) for a, n, s, e, th in events if n == WINDOW
                   and a == "user_annotation"), None)
    if window is None:
        raise ValueError(f"no {WINDOW} span in the trace")
    w0, w1, thread = window
    dev, spans, ops, by_name, count = [], [], [], {}, {}
    n_dev = 0
    for act, name, s, e, th in events:
        if act in DEVICE_ACTIVITY:
            if e <= w0 or s >= w1:
                continue
            dev.append((s, e))
            n_dev += 1
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s)
            count[key] = count.get(key, 0) + 1
        elif th == thread and act == "user_annotation" and \
                name.startswith(SPAN_PREFIX):
            spans.append((name, s, e))
        elif th == thread and act == "cpu_op":
            ops.append((name, s, e))
    gaps = timing.idle_gaps(dev, (w0, w1))
    return TraceSummary(window_s=w1 - w0,
                        busy_s=timing.busy_time(dev, (w0, w1)),
                        device_events=n_dev, device_s=by_name,
                        device_n=count,
                        idle_s=timing.label_gaps(gaps, spans, ops))


def kernel_time(summary: TraceSummary, trace_name: str):
    """-> (device seconds, launches) of the kernels whose names hold
    ``trace_name`` as a whole identifier."""
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(trace_name)
                     + r"(?![A-Za-z0-9_])")
    keys = [k for k in summary.device_s if pat.search(k)]
    return (sum(summary.device_s[k] for k in keys),
            sum(summary.device_n[k] for k in keys))
