"""What the readers of the program's own spans and counters share
(``cudapathtracer_tpu_torch/utils/tracing.py``).

A reader calls ``switch_on()`` when it is loaded: the harness loads readers
for a traced run alone, before it sets the cell up, so the untraced runs
that give the end-to-end numbers run with tracing off. After the window it
reads ``records(readings)``. A tree without the facility reads nothing and
raises nothing.

"Device ms" is a span's timing-event interval; a record without events
stands in with its host interval. A run whose traced window saw no device
work (the CPU) reads nothing: its host intervals are not device times.
"""

from __future__ import annotations

import importlib
import statistics


def _tracing():
    try:
        return importlib.import_module(
            "cudapathtracer_tpu_torch.utils.tracing")
    except ImportError:
        return None


def switch_on():
    t = _tracing()
    if t is not None:
        t.enable(True)


def records(r):
    """The program's records of a traced run, or None (no facility, or no
    device work in the traced window)."""
    t = _tracing()
    if t is None or r.trace is None or not r.trace.device_events:
        return None
    return t.records()


def device_ms(rec) -> float:
    if rec.device_ms is not None:
        return rec.device_ms
    return (rec.end_ns - rec.start_ns) * 1e-6


def spans(recs, name: str) -> list:
    return [x for x in recs if x.kind == "span" and x.name == name]


def median(values):
    return statistics.median(values) if values else None


def per_root(recs, root: str, value) -> float | None:
    """The median over the roots named ``root`` of ``value(root record,
    records that share its root id)``."""
    members = {}
    for x in recs:
        members.setdefault(x.root, []).append(x)
    return median([value(x, members[x.id]) for x in spans(recs, root)
                   if x.parent is None])
