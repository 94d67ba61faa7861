"""device.idle_pct: the share of the traced window in which no kernel or
copy ran on the device (the union of the trace's device intervals)."""


def read(run):
    t = run["trace"]
    if t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
