"""Milliseconds of the packet engine's ray sort and cull per sample, from
the program's own spans: per ``render.batch`` root, the device ms of its
``packets.sort`` (the sort keys, the sort and the gather into sorted order)
and ``packets.cull`` spans (tile bounds, frustum cull, ``topk``, caps),
over the root's ``samples``; the median over the roots of the traced
run."""

from h100_bench import program_spans as ps

ps.switch_on()


def sort_cull_ms(root, members):
    return sum(ps.device_ms(x) for x in members if x.kind == "span"
               and x.name in ("packets.sort", "packets.cull")) \
        / root.attrs["samples"]


def read(r):
    recs = ps.records(r)
    return None if recs is None else ps.per_root(recs, "render.batch",
                                                 sort_cull_ms)
