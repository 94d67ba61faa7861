"""The device renderer against the program's numpy CorridorSequence, at a
small size on a few poses, with the numpy renderer's own textures."""

import numpy as np
import torch

from visual_odometry_ros_tpu_torch.io.synthetic import CorridorSequence
from vo_bench import render as R


def test_renderer_matches_the_numpy_corridor():
    T = R.trajectory(40, 0.8, 0.0015, 240, 0.05, 97, np.random.default_rng(3))
    W, H = 160, 96
    seq = CorridorSequence.fit(T, width=W, height=H, fx=90.0, fy=90.0, cx=79.5, cy=47.5,
                               wall_tex_size=256, wall_tex_scale=40.0)
    geom = R.corridor_geometry(T)
    assert geom == seq.extent
    levels0 = [pl.tex.levels[0] for pl in seq.planes]
    tex = {k: torch.as_tensor(levels0[i]) for i, k in enumerate(("left", "right", "floor", "ceiling", "end"))}
    tex["panels"] = torch.as_tensor(np.stack(levels0[5:]))
    planes = R.build_planes(geom, tex, {"tex_scale": 25.0, "wall_tex_scale": 40.0, "panel_tex_scale": 85.0}, "cpu")
    assert len(planes) == len(seq.planes)
    for ours, theirs in zip(planes, seq.planes):
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(ours.levels, theirs.tex.levels))
    rnd = R.CorridorRenderer(planes, 90.0, 90.0, 79.5, 47.5, W, H, "cpu", cull_m=1e9)
    idx = [0, 13, 39]
    img = rnd.render(torch.as_tensor(R.se3_inv(T[idx])), torch.as_tensor(T[idx, 2, 3])).numpy()
    for j, i in enumerate(idx):
        ref = seq.render(np.linalg.inv(T[i]))
        close = np.abs(img[j] - ref) <= 1e-3
        assert close.mean() >= 0.999, (i, np.abs(img[j] - ref).max())


def test_smoothing_matches_numpy():
    raw = np.random.default_rng(0).uniform(30, 220, (64, 64)).astype(np.float32)
    k = np.ones(3, np.float32) / 3
    t = raw.copy()
    for _ in range(2):
        t = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, t)
        t = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, t)
    assert np.abs(R.smooth_textures(torch.as_tensor(raw)[None], 2)[0].numpy() - t).max() < 1e-3


def test_trajectory_is_straight_on_average_with_the_peak_yaw_rate():
    T = R.trajectory(2000, 0.8, 0.0015, 240, 0.05, 97, np.random.default_rng(5))
    yaw = np.arctan2(T[:, 0, 2], T[:, 2, 2])
    assert np.abs(np.diff(yaw)).max() <= 0.0015 + 1e-9
    assert np.abs(T[:, 0, 3]).max() < 2.0  # the corridor stays a corridor
    step = np.linalg.norm(np.diff(T[:, :3, 3], axis=0), axis=1)
    assert 0.8 * 0.95 - 1e-9 <= step.min() and step.max() <= 0.8 * 1.05 + 1e-9


def test_frames_repeat_for_a_seed():
    from vo_bench import world

    cam = dict(fx=90.0, fy=90.0, cx=79.5, cy=47.5, width=160, height=96)
    tr = {"frames": 6, "speed_m_per_frame": 0.25, "yaw_rate_rad_per_frame": 0.0015, "yaw_period_frames": 240,
          "speed_jitter": 0.05, "jitter_period_frames": 97,
          "world": {"margins_m": {"wall_m": 8.0, "floor_m": 1.6, "ceiling_m": 8.0}, "tex_size": 64, "tex_scale": 25.0, "wall_tex_size": 64, "wall_tex_scale": 40.0, "smooth": 2,
                    "panel_tex_size": 32, "panel_tex_scale": 85.0, "panel_smooth": 1, "cull_m": 150.0,
                    "render_batch": 4}}
    big = 2**31 + 12345
    a = world.make_frames(cam, 0.5371657, tr, big, "cpu")
    b = world.make_frames(cam, 0.5371657, tr, big, "cpu")
    c = world.make_frames(cam, 0.5371657, tr, big + 1, "cpu")
    assert a["left"].dtype == torch.uint8 and a["left"].shape == (6, 96, 160)
    assert torch.equal(a["left"], b["left"]) and torch.equal(a["right"], b["right"])
    assert not torch.equal(a["left"], c["left"])


def test_seeds_share_one_texture_set_in_another_order():
    from vo_bench import world

    g = torch.Generator().manual_seed(3)
    tex = {"floor": torch.rand((16, 16), generator=g), "panels": torch.rand((3, 8, 8), generator=g)}
    a = world.rolled(tex, np.random.default_rng([2**31 + 5, 2]))
    b = world.rolled(tex, np.random.default_rng([2**31 + 6, 2]))
    for k, t in tex.items():
        assert torch.equal(torch.sort(a[k].reshape(-1)).values, torch.sort(t.reshape(-1)).values)
    assert not all(torch.equal(a[k], b[k]) for k in tex)
