"""update.ms_per_frame: the per-frame entry's `timed=True` span `time_new`, mean: the update stage with replenishment and recovery."""

from vo_bench.readers import stage_mean_ms


def read(run):
    return stage_mean_ms(run, "time_new")
