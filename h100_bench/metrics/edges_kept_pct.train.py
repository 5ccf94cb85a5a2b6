"""The share of the boundary terms' edge samples that count, from the
program's own counters: 100 x the sum of ``edges.kept`` (the samples that
pass a term's tests and scatter into the image) over the sum of
``edges.drawn`` (the samples drawn), over both terms of every step of the
traced run."""

from h100_bench import program_spans as ps

ps.switch_on()


def edges_kept_pct(recs):
    total = {"edges.drawn": 0, "edges.kept": 0}
    for x in recs:
        if x.kind == "count" and x.name in total:
            total[x.name] += x.n
    if not total["edges.drawn"]:
        return None
    return 100.0 * total["edges.kept"] / total["edges.drawn"]


def read(r):
    recs = ps.records(r)
    return None if recs is None else edges_kept_pct(recs)
