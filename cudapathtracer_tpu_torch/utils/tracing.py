"""Spans and counters inside the program, kept in memory, off by default.

``span(name, **attrs)`` marks a stretch of the program, ``count(name, n)``
adds to a counter at a layer's boundary, ``enable(on)`` is the one switch
and ``records()`` returns what was kept. Nothing turns tracing on but
``enable(True)``: no environment variable, no config field.

Off, ``span`` and ``count`` only read the switch: no range, no event, no
tensor, no synchronize. On:

* a span is one ``Record``: its name, host start and end, the innermost
  span open on the same thread when it opened (its parent), the outermost
  one (its root; spans of one root share that root's id), its thread and
  its attributes. Each thread keeps its own stack of open spans, so a span
  opened in autograd's thread nests under nothing of the caller's;
* host times are ``time.time_ns()``, the clock of ``torch.profiler``'s raw
  events, so a record lines up with a device trace;
* while a profiler runs, a span is also a ``record_function`` range of the
  same name;
* once CUDA is initialised, a span records a pair of timing events on the
  current stream; ``records()`` resolves them (``device_ms``), so the
  traced code never waits for them;
* ``count`` keeps a record of its own under the innermost open span and
  adds ``n`` to that span's attribute of the counter's name.

The module imports nothing from the package, so every layer can import it.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import NamedTuple

import torch

_on = False
_kept = []                    # closed spans and counts, as they closed
_ids = itertools.count()
_local = threading.local()    # .stack: the thread's open spans
_OFF = nullcontext()


class Record(NamedTuple):
    """A closed span (``kind`` "span") or a count ("count", ``n`` its
    increment, ``start_ns`` = ``end_ns``). ``device_ms`` is the span's
    timing-event interval, None without CUDA events."""

    kind: str
    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict
    n: int | None = None
    device_ms: float | None = None


class _Open:
    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "attrs", "events", "device_ms", "range")

    def record(self) -> Record:
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self.events = None
        return Record("span", self.name, self.id, self.parent, self.root,
                      self.thread, self.start_ns, self.end_ns, self.attrs,
                      None, self.device_ms)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _opened(name: str, attrs: dict, stack: list) -> _Open:
    rec = _Open()
    rec.name, rec.id, rec.attrs = name, next(_ids), attrs
    rec.thread = threading.get_ident()
    top = stack[-1] if stack else None
    rec.parent = None if top is None else top.id
    rec.root = rec.id if top is None else top.root
    rec.events = rec.device_ms = rec.range = None
    return rec


class _Span:
    """One use of a span per ``with``; the object may be entered again
    after it closed (a checkpoint's recompute context, say)."""

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        rec = _opened(self.name, dict(self.attrs), stack)
        stack.append(rec)
        rec.start_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():
            rec.range = torch.profiler.record_function(self.name)
            rec.range.__enter__()
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        return self

    def __exit__(self, *exc):
        rec = _stack().pop()
        if rec.events is not None:
            rec.events[1].record()
        if rec.range is not None:
            rec.range.__exit__(*exc)
            rec.range = None
        rec.end_ns = time.time_ns()
        _kept.append(rec)
        return False


def span(name: str, **attrs):
    """A context manager marking a span named ``name`` with ``attrs``
    (numbers or strings); a no-op while tracing is off."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int):
    """Add ``n`` to the counter ``name``: a count record, and ``n`` added
    to the innermost open span's attribute ``name``; nothing while tracing
    is off."""
    if not _on:
        return
    stack = _stack()
    rec = _opened(name, {}, stack)
    if stack:
        top = stack[-1].attrs
        top[name] = top.get(name, 0) + n
    rec.start_ns = rec.end_ns = time.time_ns()
    _kept.append(Record("count", name, rec.id, rec.parent, rec.root,
                        rec.thread, rec.start_ns, rec.end_ns, {}, n))


def enable(on: bool):
    """The switch. Turning tracing on drops what an earlier capture
    kept."""
    global _on
    if on and not _on:
        _kept.clear()
    _on = bool(on)


def enabled() -> bool:
    return _on


def records() -> list:
    """Every record kept since tracing was last turned on, in the order
    they closed; waits for the spans' timing events, so call it after the
    traced work has been synchronized."""
    return [r if isinstance(r, Record) else r.record() for r in list(_kept)]
