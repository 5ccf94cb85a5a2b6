"""Milliseconds a train step spends in the boundary terms, from the
program's own spans: per ``diff.forward`` root, the summed device ms of
its ``diff.edges.primary`` and ``diff.edges.shadow`` spans; the median
over the roots that have any (the target render has none)."""

from h100_bench import program_spans as ps

ps.switch_on()

EDGE_SPANS = ("diff.edges.primary", "diff.edges.shadow")


def edges_ms(recs):
    roots = {x.id for x in ps.spans(recs, "diff.forward")
             if x.parent is None}
    per_root = {}
    for x in recs:
        if x.kind == "span" and x.name in EDGE_SPANS and x.root in roots:
            per_root[x.root] = per_root.get(x.root, 0.0) + ps.device_ms(x)
    return ps.median(list(per_root.values()))


def read(r):
    recs = ps.records(r)
    return None if recs is None else edges_ms(recs)
