"""Milliseconds in the packet engine per sample: the benchmark's span
around each call from the integrators into ``ops/packets.trace_packets``,
synchronized at both ends, summed over the timed part of the traced
window, over the samples completed there."""

SPANS = {"trace_packets": "cudapathtracer_tpu_torch.ops.packets:trace_packets"}


def read(r):
    s = r.spans.get("trace_packets")
    if not s or not r.samples:
        return None
    return 1e3 * sum(s) / r.samples
