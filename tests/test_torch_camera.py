"""Camera model, rectification and the distorted pipeline run in the port
against the JAX package, on CPU.

Camera ops run at 120x160 with EuRoC-like radtan distortion
[-0.28, 0.07, 1e-4, -1e-4, 0] (tests/test_stereo_vo_pipeline.py:116). The
end-to-end run is that file's distorted test: the 640x480 plane world
rendered through distorted lenses, `flagDoUndistortion=True`.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu import camera as JC  # noqa: E402
from visual_odometry_ros_tpu.config import VOConfig as JConfig  # noqa: E402
from visual_odometry_ros_tpu.io.synthetic import (  # noqa: E402
    DistortedStereoSequence,
    PlaneSequence,
    forward_trajectory,
)
from visual_odometry_ros_tpu.io.trajectory import ate_rmse, rpe  # noqa: E402
from visual_odometry_ros_tpu.models.stereo_vo import StereoVO as JVO  # noqa: E402
from visual_odometry_ros_tpu.utils import geometry as JG  # noqa: E402
from visual_odometry_ros_tpu_torch import camera as TC  # noqa: E402
from visual_odometry_ros_tpu_torch import io as tio  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO as TVO  # noqa: E402

from test_torch_stereo_vo import small_cfg  # noqa: E402

torch.set_num_threads(2)
DIST = np.array([-0.28, 0.07, 1e-4, -1e-4, 0.0], np.float32)
DIST_R = np.array([-0.25, 0.05, -2e-4, 1e-4, 0.01], np.float32)
H, W = 120, 160


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cams(dist_l=DIST, dist_r=DIST_R):
    jl = JC.make_camera(150.0, 152.0, 81.0, 58.5, dist_l, W, H)
    jr = JC.make_camera(148.0, 149.0, 79.5, 61.0, dist_r, W, H)
    tl = TC.make_camera(150.0, 152.0, 81.0, 58.5, dist_l, W, H)
    tr = TC.make_camera(148.0, 149.0, 79.5, 61.0, dist_r, W, H)
    return jl, jr, tl, tr


def rotated_T_lr():
    """A rig with a rotated right camera and a baseline off the x axis."""
    return np.asarray(JG.se3_exp(jnp.asarray(np.array([0.5, 0.02, -0.01, 0.01, -0.02, 0.015], np.float32))))


def smooth_image(seed, smooth=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(2 * smooth + 1, np.float32) / (2 * smooth + 1)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img).astype(np.float32)


def test_distortion_and_projection_match_jax():
    """Pixel-space tolerance 1e-3 px (float32 polynomial, other operation
    order); masks exactly."""
    jl, _, tl, _ = cams()
    rng = np.random.default_rng(0)
    xn = rng.uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
    fx = 150.0
    np.testing.assert_allclose(N(TC.distort_normalized(tl, torch.as_tensor(xn))) * fx,
                               N(JC.distort_normalized(jl, jnp.asarray(xn))) * fx, atol=1e-3)
    xd = N(JC.distort_normalized(jl, jnp.asarray(xn)))
    und_t = N(TC.undistort_normalized(tl, torch.as_tensor(xd)))
    np.testing.assert_allclose(und_t * fx, N(JC.undistort_normalized(jl, jnp.asarray(xd))) * fx, atol=1e-3)
    np.testing.assert_allclose(und_t, xn, atol=2e-3)  # the fixed point inverts the model
    p = rng.uniform(-10, 170, (500, 2)).astype(np.float32)
    np.testing.assert_allclose(N(TC.undistort_pixels(tl, torch.as_tensor(p))),
                               N(JC.undistort_pixels(jl, jnp.asarray(p))), atol=1e-3)
    np.testing.assert_allclose(N(TC.pixel_to_normalized(tl, torch.as_tensor(p))) * fx,
                               N(JC.pixel_to_normalized(jl, jnp.asarray(p))) * fx, atol=1e-3)
    np.testing.assert_array_equal(N(TC.in_image(tl, torch.as_tensor(p))), N(JC.in_image(jl, jnp.asarray(p))))
    X = np.concatenate([rng.uniform(-3, 3, (200, 2)), rng.uniform(1, 20, (200, 1))], -1).astype(np.float32)
    np.testing.assert_allclose(N(TC.project_to_pixel(tl, torch.as_tensor(X))),
                               N(JC.project_to_pixel(jl, jnp.asarray(X))), atol=1e-3)
    np.testing.assert_allclose(N(tl.K), N(jl.K))
    np.testing.assert_allclose(N(TC.image_undistort_maps(tl)), N(JC.image_undistort_maps(jl)), atol=1e-3)


@pytest.mark.parametrize("rig", ["pure_x_baseline", "rotated"])
def test_make_stereo_camera_matches_jax(rig):
    """Rectified camera, rectified extrinsics and both remap grids; grids
    to 1e-3 px."""
    jl, jr, tl, tr = cams()
    if rig == "rotated":
        T_lr = rotated_T_lr()
    else:
        T_lr = np.eye(4, dtype=np.float32)
        T_lr[0, 3] = 0.5
    js = JC.make_stereo_camera(jl, jr, jnp.asarray(T_lr))
    ts = TC.make_stereo_camera(tl, tr, T_lr)
    for f in ("fx", "fy", "cx", "cy"):
        assert float(getattr(ts.rect, f)) == float(getattr(js.rect, f)), f
    assert (ts.rect.width, ts.rect.height) == (W, H)
    np.testing.assert_allclose(N(ts.T_lr_rect), N(js.T_lr_rect), atol=1e-6)
    np.testing.assert_allclose(float(ts.baseline), float(js.baseline), rtol=1e-6)
    np.testing.assert_allclose(N(ts.map_left), N(js.map_left), atol=1e-3)
    np.testing.assert_allclose(N(ts.map_right), N(js.map_right), atol=1e-3)


def test_rectified_images_match_jax():
    """`remap` through bilinear_sample (mask -> 0): intensities to 1e-3
    (maps equal to ~1e-5 px on a smooth image)."""
    jl, jr, tl, tr = cams()
    T_lr = rotated_T_lr()
    js = JC.make_stereo_camera(jl, jr, jnp.asarray(T_lr))
    ts = TC.make_stereo_camera(tl, tr, T_lr)
    a, b = smooth_image(1), smooth_image(2)
    ja, jb = JC.rectify_stereo_images(js, jnp.asarray(a), jnp.asarray(b))
    ta, tb = TC.rectify_stereo_images(ts, torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(N(ta), N(ja), atol=1e-3)
    np.testing.assert_allclose(N(tb), N(jb), atol=1e-3)
    assert (N(ta) == 0).any()  # the barrel-distorted border maps outside the raw image


@pytest.fixture(scope="module")
def distorted_seq():
    world = PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    poses = forward_trajectory(12, step=0.22, yaw_rate=0.0015)
    dworld = DistortedStereoSequence(world, DIST)
    return poses, [dworld.stereo_pair(T.astype(np.float64)) for T in poses]


def distorted_cfg(cls, use_pallas="auto"):
    cfg = small_cfg(cls, use_pallas)
    cfg.cam.k1, cfg.cam.k2, cfg.cam.p1, cfg.cam.p2, cfg.cam.k3 = (float(d) for d in DIST)
    cfg.cam_right = cfg.cam
    cfg.flagDoUndistortion = True
    return cfg


def test_distorted_run_matches_jax(distorted_seq):
    """Every frame rectified in both packages: the port's trajectory (plain
    leg) matches the JAX one to 1 mm, and both meet the JAX test's bounds."""
    poses, frames = distorted_seq
    jvo = JVO(distorted_cfg(JConfig))
    tvo = TVO(distorted_cfg(tio.VOConfig, "off"), device="cpu")
    assert (tvo.fx, tvo.cx, tvo.cy) == (jvo.fx, jvo.cx, jvo.cy)
    np.testing.assert_allclose(tvo.T_rl.numpy(), jvo.T_rl, atol=1e-6)
    for il, ir in frames:
        jvo.track_stereo_images(il, ir)
        tvo.track_stereo_images(il, ir)
    tj, tt = np.stack(jvo.trajectory), np.stack(tvo.trajectory)
    assert [s["keyframe"] for s in tvo.stats_log] == [s["keyframe"] for s in jvo.stats_log]
    np.testing.assert_allclose(tt[:, :3, 3], tj[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(tt[:, :3, :3], tj[:, :3, :3], atol=1e-4)
    assert ate_rmse(tt, poses, align="none") < 0.05 * 0.22 * 11
    t_rmse, r_rmse = rpe(tt, poses)
    assert t_rmse < 0.03 and r_rmse < 0.3
    assert tvo.stats_log[-1]["n_inliers"] > 50
