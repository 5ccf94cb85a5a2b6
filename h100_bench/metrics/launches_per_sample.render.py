"""Device kernels and memory operations in the traced passes, per sample
they completed (the eager glue is launch-bound: fewer, larger launches)."""


def read(r):
    t = r.trace
    if t is None or not t.device_events:
        return None
    return t.device_events / r.traced_samples
