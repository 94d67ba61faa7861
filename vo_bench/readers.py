"""Helpers of the per-layer metric readers in `metrics/`."""


def kernel_device_s(run, names):
    """Device seconds of the program's hand-written kernels `names` (launch
    counter names) in a traced window, held to the program's launch
    counters: a kernel whose trace events do not number its launches gives
    None (the profiler now and then drops them)."""
    total = 0.0
    for k in names:
        trace_name = run["kernels"][k]
        n = s = 0
        for op, v in run["trace"]["device_ops"].items():
            if trace_name in op:
                n += v["count"]
                s += v["s"]
        if n != run["launches"].get(k, 0):
            return None
        total += s
    return total


def stage_mean_ms(run, stage):
    """Mean of one `timed=True` stage span (ms) over the frames that have it."""
    v = [st[stage] for st in run["stage_ms"] if stage in st]
    return sum(v) / len(v) if v else None
