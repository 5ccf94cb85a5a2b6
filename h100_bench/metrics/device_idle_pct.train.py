"""The device's idle share of the traced train steps: 1 - (the union of its
kernel and memory-operation intervals) / (the traced window), from
``torch.profiler``'s device trace."""


def read(r):
    t = r.trace
    if t is None or not t.device_events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
