"""keyframe.ms_per_keyframe: the per-frame entry's `timed=True` span `time_ba`, mean: the keyframe step (re-triangulation, window BA), over keyframes."""

from vo_bench.readers import stage_mean_ms


def read(run):
    return stage_mean_ms(run, "time_ba")
