"""The end-to-end metrics' arithmetic on synthetic timings, and the per-layer
readers on a synthetic run."""

import numpy as np
import pytest

from vo_bench import run, tracing


def test_fps_is_frames_over_the_whole_window():
    assert run.fps(600, 20.0) == 30.0
    # Slow calls lower the rate: it is not a mean of per-call rates.
    assert run.fps(2 * 24, 0.5 + 1.5) == 24.0


def test_frame_ms_p95_is_over_all_frames():
    ms = [10.0] * 95 + [100.0] * 5
    assert run.frame_ms_p95(ms) == pytest.approx(np.percentile(ms, 95))
    assert run.frame_ms_p95(list(range(1, 201))) == pytest.approx(190.05)
    # One slow frame in twenty sits at the tail, not averaged away.
    assert run.frame_ms_p95([10.0] * 19 + [50.0]) == pytest.approx(np.percentile([10.0] * 19 + [50.0], 95))


def test_merged_intervals():
    assert tracing.merged_us([(0, 2), (1, 3), (5, 6), (6, 6)]) == [[0, 3], [5, 6]]


def _run(launches=None):
    return {
        "trace": {"window_s": 2.0, "busy_s": 0.5, "idle_by_host": {},
                  "device_ops": {"klt::klt_pyr_kernel(PyrArgs)": {"count": 4, "s": 0.004},
                                 "pose_gn::pose_gn_kernel(pose_gn::Batch)": {"count": 2, "s": 0.002},
                                 "ba_terms_kernel(Args, int, int)": {"count": 12, "s": 0.0012},
                                 "ba_solve_kernel(Args, int, int)": {"count": 10, "s": 0.001},
                                 "ba_backsub_kernel(Args, int)": {"count": 10, "s": 0.0008},
                                 "elementwise": {"count": 100, "s": 0.1}}},
        "syncs": 40, "frames": 2, "keyframes": 1,
        "launches": launches or {"klt_pyr": 4, "klt_scale": 0, "pose_gn": 2, "ba_terms": 12, "ba_solve": 10,
                                 "ba_backsub": 10},
        "stage_ms": [{"time_track": 2.0, "time_new": 10.0}, {"time_track": 4.0, "time_new": 20.0, "time_ba": 7.0}],
        "kernels": run.KERNELS,
    }


def test_readers():
    r = _run()
    assert run.read_metric("device.idle_pct", r) == pytest.approx(75.0)
    assert run.read_metric("driver.syncs_per_frame", r) == 20.0
    assert run.read_metric("kernels.device_ms_per_frame", r) == pytest.approx(9.0 / 2)
    assert run.read_metric("ba.device_ms_per_solve", r) == pytest.approx(3.0)
    assert run.read_metric("track.ms_per_frame", r) == 3.0
    assert run.read_metric("update.ms_per_frame", r) == 15.0
    assert run.read_metric("keyframe.ms_per_keyframe", r) == 7.0


def test_a_reader_with_nothing_to_read_returns_nothing():
    r = _run(launches={"klt_pyr": 5, "klt_scale": 0, "pose_gn": 2, "ba_terms": 12, "ba_solve": 10, "ba_backsub": 10})
    assert run.read_metric("kernels.device_ms_per_frame", r) is None  # a dropped trace event
    r = _run()
    r["keyframes"], r["stage_ms"] = 0, []
    r["trace"]["busy_s"] = 0.0
    for name in ("ba.device_ms_per_solve", "track.ms_per_frame", "keyframe.ms_per_keyframe", "device.idle_pct"):
        assert run.read_metric(name, r) is None
