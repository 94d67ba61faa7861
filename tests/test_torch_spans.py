"""The pipelines' stage spans (`utils/timer.span`) on CPU: counted always,
profiler ranges only with tracing on, nested as the stages are, and the
timed=True path's stage_ms keys kept.

World: tests/test_torch_batch.py's plane sequence (stereo) and
tests/test_torch_mono_vo.py's two-plane sequence (mono), each through its
batch entry point after the bootstrap, under a torch.profiler CPU profile.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from visual_odometry_ros_tpu_torch import io as tio
from visual_odometry_ros_tpu_torch.io.synthetic import PlaneSequence, TwoPlaneSequence, forward_trajectory
from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO
from visual_odometry_ros_tpu_torch.utils import timer

from test_torch_mono_vo import mono_cfg  # noqa: E402
from test_torch_stereo_vo import small_cfg  # noqa: E402

torch.set_num_threads(2)
STAGES = {"stereo": ("vo.track", "vo.stereo", "vo.pose", "vo.update"),
          "mono": ("vo.track", "vo.onep", "vo.pose", "vo.update")}
# Spans that only run under a condition: the keyframe step, a recovery, the
# 5-point fallback, and replenishment, which nests in three of them.
MAY_RUN = ("vo.keyframe", "vo.recover", "vo.fallback", "vo.replenish")
REPLENISH_PARENTS = ("vo.update", "vo.fallback", "vo.recover")


@pytest.fixture(scope="module")
def stereo_frames():
    world = PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    pairs = [world.stereo_pair(T.astype(np.float64)) for T in forward_trajectory(9, step=0.22, yaw_rate=0.0015)]
    return [np.clip(np.stack([p[k] for p in pairs]), 0, 255).astype(np.uint8) for k in (0, 1)]


@pytest.fixture(scope="module")
def mono_frames():
    world = TwoPlaneSequence(z0_a=9.0, z0_b=18.0)
    poses = forward_trajectory(16, step=0.3, yaw_rate=0.001, lateral=0.12)
    return np.stack([np.clip(world.render(np.linalg.inv(T.astype(np.float64))), 0, 255).astype(np.uint8)
                     for T in poses])


def _batches(mode, stereo_frames, mono_frames):
    """A bootstrapped pipeline and a function running its batch entry over
    the frames left, in two calls."""
    if mode == "stereo":
        ils, irs = stereo_frames
        vo = StereoVO(small_cfg(tio.VOConfig, "off"), device="cpu")
        vo.track_stereo_batch(ils[:1], irs[:1])
        return vo, lambda: [vo.track_stereo_batch(ils[a:b], irs[a:b]) for a, b in ((1, 5), (5, 9))]
    vo = MonoVO(mono_cfg(tio.VOConfig, "off"), device="cpu")
    i = 0
    while vo.phase != 2:
        vo.track_image(mono_frames[i])
        i += 1
    mid = (i + len(mono_frames)) // 2
    return vo, lambda: [vo.track_batch(mono_frames[a:b]) for a, b in ((i, mid), (mid, len(mono_frames)))]


def _traced(mode, stereo_frames, mono_frames, on):
    """Host events named vo.* of a CPU profile over two batch calls, and the
    span counts over the same calls."""
    vo, calls = _batches(mode, stereo_frames, mono_frames)
    timer.reset_span_counts()
    with timer.tracing(on), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = calls()
    n_frames = sum(len(o) for o in out)
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("vo.")]
    return spans, dict(timer.SPAN_COUNTS), n_frames


@pytest.mark.parametrize("mode", ["stereo", "mono"])
def test_spans_off_leave_no_profiler_event_and_still_count(mode, stereo_frames, mono_frames):
    spans, counts, n_frames = _traced(mode, stereo_frames, mono_frames, on=False)
    assert spans == []
    assert counts["vo.entry"] == 2
    for name in STAGES[mode]:
        assert counts[name] == n_frames, name
    assert set(counts) <= {"vo.entry", *STAGES[mode], *MAY_RUN}


@pytest.mark.parametrize("mode", ["stereo", "mono"])
def test_spans_on_nest_as_the_stages_and_number_their_counts(mode, stereo_frames, mono_frames):
    spans, counts, n_frames = _traced(mode, stereo_frames, mono_frames, on=True)
    by_name = {}
    for name, s, t in spans:
        by_name.setdefault(name, []).append((s, t))
    assert {k: len(v) for k, v in by_name.items()} == counts
    assert counts["vo.replenish"] > 0  # the nesting check below is not vacuous

    def inside(iv, parents):
        return any(p0 <= iv[0] and iv[1] <= p1 for name in parents for p0, p1 in by_name.get(name, []))

    entries = by_name["vo.entry"]
    for name, s, t in spans:
        if name != "vo.entry":
            assert inside((s, t), ["vo.entry"]), name
    for iv in by_name["vo.replenish"]:
        assert inside(iv, REPLENISH_PARENTS)
    # The stages of a frame follow one another without overlap.
    top = sorted((s, t) for name, s, t in spans if name in STAGES[mode] + ("vo.keyframe", "vo.recover",
                                                                          "vo.fallback"))
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    assert len(entries) == 2 and n_frames == counts["vo.track"]


def test_off_span_is_one_shared_no_op(monkeypatch):
    """Off, a span reads no clock, opens no profiler range and waits for no
    device: only the counter moves."""

    def forbidden(*a, **k):
        raise AssertionError("called on the off path")

    monkeypatch.setattr(time, "perf_counter", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    timer.reset_span_counts()
    a, b = timer.span("vo.track"), timer.span("vo.update")
    assert a is b
    with a:
        with b:
            pass
    assert timer.SPAN_COUNTS == {"vo.track": 1, "vo.update": 1}


def test_tracing_restores_the_setting_before_it():
    assert timer.span("vo.track") is timer.span("vo.pose")
    with timer.tracing(True):
        with timer.tracing(False):
            assert timer.span("vo.track") is timer.span("vo.pose")
        assert isinstance(timer.span("vo.track"), torch.profiler.record_function)
    assert timer.span("vo.track") is timer.span("vo.pose")


def test_timed_span_adds_to_its_key_and_counts():
    timer.reset_span_counts()
    stage_ms = {}
    for _ in range(2):
        with timer.span("vo.update", stage_ms, "time_new"):
            time.sleep(0.002)
    assert stage_ms["time_new"] >= 4.0 and timer.SPAN_COUNTS["vo.update"] == 2


@pytest.mark.parametrize("mode", ["stereo", "mono"])
def test_timed_entry_keeps_the_stage_ms_keys(mode, stereo_frames, mono_frames):
    """timed=True through the per-frame entry fills the keys it always did,
    and only those."""
    if mode == "stereo":
        ils, irs = stereo_frames
        vo = StereoVO(small_cfg(tio.VOConfig, "off"), device="cpu")
        sm = [vo.track_stereo_images(il, ir, timed=True)[1].get("stage_ms") for il, ir in zip(ils, irs)][1:]
        core, extra = {"time_track", "time_stereo", "time_pose", "time_new"}, {"time_ba"}
    else:
        vo = MonoVO(mono_cfg(tio.VOConfig, "off"), device="cpu")
        sm = [s for s in (vo.track_image(f, timed=True)[1].get("stage_ms") for f in mono_frames) if s]
        core, extra = {"time_track", "time_1p", "time_pose", "time_new"}, {"time_5p", "time_ba"}
    assert sm
    for st in sm:
        assert core <= set(st) <= core | extra, st
        assert all(v > 0.0 for v in st.values())
    assert any("time_ba" in st for st in sm)
