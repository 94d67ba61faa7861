"""ba.device_ms_per_solve: device time of ba_terms, ba_solve and ba_backsub
over the window BA solves (one a keyframe) in the window."""

from vo_bench.readers import kernel_device_s


def read(run):
    if not run["keyframes"]:
        return None
    s = kernel_device_s(run, ["ba_terms", "ba_solve", "ba_backsub"])
    if s is None or s <= 0.0:
        return None
    return 1e3 * s / run["keyframes"]
