"""The fold kernels' share of their roofline in the traced passes:
sum of bounds / sum of device time. A call's bound is max(bytes / 3.35
TB/s, tests x OPS_PER_TEST / 67 TFLOP/s) over the work its own rays,
shortlists and returned t need (``work.needed_work``); the calls are those
the packet engine made into the fold wrappers while the profiler ran, and
the times are the device trace's events of the kernels' trace names
(``fold_kernels/*.json``). Nothing is read where the calls and the
kernel events of a name do not pair up one to one."""

from h100_bench import devtrace

FOLDS = True


def read(r):
    if r.trace is None:
        return None
    bound = busy = 0.0
    for k in r.fold_kernels:
        calls, b = r.folds.get(k["trace_name"], (0, 0.0))
        s, n = devtrace.kernel_time(r.trace, k["trace_name"])
        if calls != n:
            return None
        bound += b
        busy += s
    return 100.0 * bound / busy if busy > 0 else None
