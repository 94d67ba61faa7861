"""track.ms_per_frame: the per-frame entry's `timed=True` span `time_track`, mean: the track stage (pyramids, priors, the KLT calls)."""

from vo_bench.readers import stage_mean_ms


def read(run):
    return stage_mean_ms(run, "time_track")
