"""Milliseconds of the integrator glue per sample, from the program's own
spans: per ``render.batch`` root, the device ms of its
``integrator.radiance`` spans less those of the ``packets.trace`` spans
directly under them, over the root's ``samples``; the median over the
roots of the traced run (set-up, warm-up and the profiled passes are a few
roots of hundreds)."""

from h100_bench import program_spans as ps

ps.switch_on()


def glue_ms(root, members):
    radiance = {x.id: x for x in members
                if x.kind == "span" and x.name == "integrator.radiance"}
    traces = [x for x in members if x.kind == "span"
              and x.name == "packets.trace" and x.parent in radiance]
    return ((sum(map(ps.device_ms, radiance.values()))
             - sum(map(ps.device_ms, traces))) / root.attrs["samples"])


def read(r):
    recs = ps.records(r)
    return None if recs is None else ps.per_root(recs, "render.batch",
                                                 glue_ms)
