"""The arithmetic of the end-to-end metrics and of the device timeline,
as pure functions of host times and trace intervals (seconds, or any one
unit throughout)."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default method)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_time(intervals, window) -> float:
    """The length of the union of ``intervals`` inside ``window``."""
    w0, w1 = window
    return sum(max(0.0, min(e, w1) - max(s, w0)) for s, e in
               merged(intervals))


def idle_gaps(intervals, window):
    """The (start, end) stretches of ``window`` that no interval covers."""
    w0, w1 = window
    gaps, t = [], w0
    for s, e in merged(intervals):
        if e <= w0 or s >= w1:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return gaps


def innermost(spans, points):
    """For each of ``points``, the name of the innermost of the nested
    (name, start, end) ``spans`` that holds it, or None. Spans of one
    thread nest; each point is answered in O(log n) amortized."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [None] * len(points)
    stack, k = [], 0
    for i in order:
        p = points[i]
        while k < len(spans) and spans[k][1] <= p:
            s = spans[k]
            while stack and stack[-1][2] < s[1]:
                stack.pop()
            stack.append(s)
            k += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def label_gaps(gaps, bench_spans, host_ops):
    """Idle seconds by what the host was doing at each gap's midpoint:
    the innermost benchmark span, then the innermost host operation.
    -> {label: summed gap length}."""
    mids = [(s + e) / 2.0 for s, e in gaps]
    where = innermost(bench_spans, mids)
    what = innermost(host_ops, mids)
    out = {}
    for (s, e), a, b in zip(gaps, where, what):
        label = f"{a or 'outside'} | {b or 'no host op'}"
        out[label] = out.get(label, 0.0) + (e - s)
    return out


def top(d: dict, n: int = 10):
    """The ``n`` largest entries of {name: value} as [[name, value], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

