"""kernels.device_ms_per_frame: device time of klt_pyr, klt_scale, pose_gn
and the ba_* kernels over the window's frames."""

from vo_bench.readers import kernel_device_s


def read(run):
    s = kernel_device_s(run, list(run["kernels"]))
    if s is None or not run["frames"] or s <= 0.0:
        return None
    return 1e3 * s / run["frames"]
