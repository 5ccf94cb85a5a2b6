"""Milliseconds of a train step's backward: the benchmark's span around
``torch.autograd.grad`` of each step, synchronized at both ends, its mean
over the timed part of the traced window."""


def read(r):
    s = r.spans.get("backward")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
