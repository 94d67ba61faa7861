"""The port's batch serving path (`track_stereo_batch`) against its own
per-frame path and against the JAX package's `lax.scan` batch, on CPU.

World: tests/test_scan_batch.py's 9-frame plane sequence, split 5 + 4 so
both the bootstrap branch and the plain branch of `track_stereo_batch` run.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.config import VOConfig as JConfig  # noqa: E402
from visual_odometry_ros_tpu.io.synthetic import (  # noqa: E402
    DistortedStereoSequence,
    PlaneSequence,
    forward_trajectory,
)
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JVO  # noqa: E402
from visual_odometry_ros_tpu_torch import io as tio  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO as TVO  # noqa: E402

from test_torch_camera import DIST, distorted_cfg  # noqa: E402
from test_torch_stereo_vo import small_cfg  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    world = PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    poses = forward_trajectory(9, step=0.22, yaw_rate=0.0015)
    pairs = [world.stereo_pair(T.astype(np.float64)) for T in poses]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_batch_matches_sequential_on_uint8_frames(frames):
    """Camera-native uint8 batches through the kernel leg against the
    per-frame path on the same frames: 1e-4 (the same programs; only the
    point where float32 conversion happens differs, and it is exact)."""
    ils, irs = (np.clip(x, 0, 255).astype(np.uint8) for x in frames)
    seq = TVO(small_cfg(tio.VOConfig, "on"), device="cpu")
    for il, ir in zip(ils, irs):
        seq.track_stereo_images(il, ir)
    bat = TVO(small_cfg(tio.VOConfig, "on"), device="cpu")
    out = bat.track_stereo_batch(ils[:5], irs[:5]) + bat.track_stereo_batch(ils[5:], irs[5:])
    assert len(out) == 8 and [s["frame"] for s in out] == list(range(1, 9))
    np.testing.assert_allclose(np.stack(bat.trajectory), np.stack(seq.trajectory), atol=1e-4)
    assert [s["keyframe"] for s in bat.stats_log] == [s["keyframe"] for s in seq.stats_log]
    for a, b in zip(bat.stats_log[1:], seq.stats_log[1:]):
        assert a.keys() == b.keys()
        for k in ("n_tracked", "n_inliers", "n_new", "pose_ok", "recovered", "ba_rejected"):
            assert a[k] == b[k], k
        assert (a["ba_err"] is None) == (b["ba_err"] is None)


def test_batch_matches_jax_scan(frames):
    """The JAX `lax.scan` batch on the same split: poses to 1e-3 m (float32
    differences through 8 frames and a BA window), the same keyframes and
    the same stats keys."""
    ils, irs = frames
    jvo = JVO(small_cfg(JConfig))
    jout = jvo.track_stereo_batch(ils[:5], irs[:5]) + jvo.track_stereo_batch(ils[5:], irs[5:])
    tvo = TVO(small_cfg(tio.VOConfig, "off"), device="cpu")
    tout = tvo.track_stereo_batch(ils[:5], irs[:5]) + tvo.track_stereo_batch(ils[5:], irs[5:])
    tj, tt = np.stack(jvo.trajectory), np.stack(tvo.trajectory)
    np.testing.assert_allclose(tt[:, :3, 3], tj[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(tt[:, :3, :3], tj[:, :3, :3], atol=1e-4)
    assert [s["keyframe"] for s in tvo.stats_log] == [s["keyframe"] for s in jvo.stats_log]
    assert [sorted(s) for s in tout] == [sorted(s) for s in jout]
    assert [s["n_inliers"] for s in tout] == [s["n_inliers"] for s in jout]


def test_batch_of_one_bootstraps_and_returns():
    world = PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    il, ir = world.stereo_pair(np.eye(4))
    vo = TVO(small_cfg(tio.VOConfig, "off"), device="cpu")
    out = vo.track_stereo_batch(il[None], ir[None])
    assert out == [{"frame": 0, "keyframe": True, "n_tracked": 0}]
    assert vo.state is not None and len(vo.trajectory) == 1


def test_distorted_batch_matches_sequential():
    """flagDoUndistortion: the batch is converted once, then rectified frame
    by frame; the same poses as the per-frame path to 1e-4."""
    world = DistortedStereoSequence(PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5), DIST)
    poses = forward_trajectory(4, step=0.22, yaw_rate=0.0015)
    pairs = [world.stereo_pair(T.astype(np.float64)) for T in poses]
    ils, irs = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    seq = TVO(distorted_cfg(tio.VOConfig, "off"), device="cpu")
    for il, ir in pairs:
        seq.track_stereo_images(il, ir)
    bat = TVO(distorted_cfg(tio.VOConfig, "off"), device="cpu")
    bat.track_stereo_batch(ils, irs)
    np.testing.assert_allclose(np.stack(bat.trajectory), np.stack(seq.trajectory), atol=1e-4)
