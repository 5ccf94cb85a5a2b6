"""Milliseconds a train step spends recomputing its checkpointed samples in
the backward, from the program's own spans: per ``diff.forward`` root, the
summed device ms of the ``diff.recompute`` spans (autograd's thread) that
start between it and the next ``diff.forward`` root; the median over the
roots that have any (the target render, under no_grad, has none)."""

from h100_bench import program_spans as ps

ps.switch_on()


def recompute_ms(recs):
    roots = sorted((x for x in ps.spans(recs, "diff.forward")
                    if x.parent is None), key=lambda x: x.start_ns)
    redo = ps.spans(recs, "diff.recompute")
    per_step = []
    for a, b in zip(roots, roots[1:] + [None]):
        ms = [ps.device_ms(x) for x in redo if x.start_ns >= a.start_ns
              and (b is None or x.start_ns < b.start_ns)]
        if ms:
            per_step.append(sum(ms))
    return ps.median(per_step)


def read(r):
    recs = ps.records(r)
    return None if recs is None else recompute_ms(recs)
