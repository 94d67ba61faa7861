"""The comparison that decides `correct` fails a broken timed path: the rest
of a run on the CPU (no look for a card), with a fault planted in the
program underneath."""

import numpy as np
import pytest

from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO
from vo_bench.tests._small import run_cell


def _unchanged(cls):
    step = cls._steady_step

    def frozen(self, state, *args, **kwargs):
        return state, step(self, state, *args, **kwargs)[1]

    return frozen


def _altered_record(record):
    def altered(self, T_wc, *args, **kwargs):
        T = np.array(T_wc, copy=True)
        T[0, 3] += 0.5  # half a metre, where the pose is produced: past the limits of every cell
        return record(self, T, *args, **kwargs)

    return altered


def test_a_step_that_leaves_its_state_unchanged(capsys, monkeypatch):
    monkeypatch.setattr(StereoVO, "_steady_step", _unchanged(StereoVO))
    assert run_cell(capsys, "kitti00_stereo.batch_cruise")["correct"] is False


def test_a_mono_step_that_leaves_its_state_unchanged(capsys, monkeypatch):
    monkeypatch.setattr(MonoVO, "_steady_step", _unchanged(MonoVO))
    assert run_cell(capsys, "kitti00_mono.batch_urban", frames=60)["correct"] is False


def test_half_of_the_batch_left_out(capsys, monkeypatch):
    track = StereoVO.track_stereo_batch

    def half(self, imgs_l, imgs_r):
        """The batch's first half tracked; the rest given the last pose."""
        n = len(imgs_l)
        if n == 1:
            return track(self, imgs_l, imgs_r)
        out = track(self, imgs_l[: n // 2], imgs_r[: n // 2])
        for _ in range(n - n // 2):
            self.trajectory.append(self.trajectory[-1])
            out.append(dict(out[-1]))
        return out

    monkeypatch.setattr(StereoVO, "track_stereo_batch", half)
    assert run_cell(capsys, "kitti00_stereo.batch_cruise")["correct"] is False


@pytest.mark.parametrize("cls, workload", [(StereoVO, "kitti00_stereo.batch_cruise"),
                                           (MonoVO, "kitti00_mono.batch_urban")])
def test_an_answer_altered_where_it_is_produced(capsys, monkeypatch, cls, workload):
    monkeypatch.setattr(cls, "_record", _altered_record(cls._record))
    assert run_cell(capsys, workload, frames=60)["correct"] is False


def test_sound_runs_are_correct(capsys):
    assert run_cell(capsys, "kitti00_stereo.batch_cruise")["correct"] is True
