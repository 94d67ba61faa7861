"""The hand-written KLT kernels and the ported pipeline on a CUDA GPU.

Every test here needs the card (marker `cuda`) and skips without one. The
file imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from visual_odometry_ros_tpu_torch import camera as TC  # noqa: E402
from visual_odometry_ros_tpu_torch import io as tio  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import features as TF  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import klt as KLT  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pnp as TPNP  # noqa: E402
from visual_odometry_ros_tpu_torch.ops.pyramid import build_pyramid  # noqa: E402
from visual_odometry_ros_tpu_torch.utils import geometry as TG  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the KLT kernels have no CPU mode)")
    return torch.device("cuda")


def smooth_noise(H, W, seed, smooth=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(2 * smooth + 1, np.float32) / (2 * smooth + 1)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img).astype(np.float32)


def _pair(dev, shift=(2, -1), H=120, W=160, seed=39):
    base = smooth_noise(H + 16, W + 16, seed)
    a = np.ascontiguousarray(base[8 : 8 + H, 8 : 8 + W])
    b = np.ascontiguousarray(base[8 - shift[1] : 8 - shift[1] + H, 8 - shift[0] : 8 - shift[0] + W])
    return torch.tensor(a, device=dev), torch.tensor(b, device=dev)


def _grid(dev, H=120, W=160, margin=2, n=16):
    gy, gx = np.meshgrid(np.linspace(margin, H - 1 - margin, n), np.linspace(margin, W - 1 - margin, n),
                         indexing="ij")
    return torch.tensor(np.stack([gx.ravel(), gy.ravel()], -1), dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("epi1d", [False, True])
def test_klt_level_kernel_matches_plain_version(dev, epi1d):
    a, b = _pair(dev)
    p0 = _grid(dev)  # includes border features with partial windows
    p1 = (p0 + 0.7).contiguous()
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    KK.reset_launch_counts()
    k = KK.track_level(a, b, p0, p1, valid, radius=10, iters=15, epi1d=epi1d)
    r = KK.track_level_ref(a, b, p0, p1, valid, 10, 15, 0.03, 1e-4, epi1d)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["klt_pyr"] == 1
    assert torch.equal(k[1], r[1]) and torch.equal(k[3], r[3])
    # Only the summation order differs (warp shuffle tree vs PyTorch reduction).
    torch.testing.assert_close(k[0], r[0], atol=1e-3, rtol=0)
    torch.testing.assert_close(k[2], r[2], atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_klt_scale_kernel_matches_plain_version(dev):
    a, b = _pair(dev)
    p0 = _grid(dev)
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    gen = torch.Generator().manual_seed(1)
    sc = (0.8 + 0.5 * torch.rand(len(p0), generator=gen)).to(dev)
    p1 = (p0 + torch.tensor([2.0, -1.0], device=dev)).contiguous()
    KK.reset_launch_counts()
    k = KK.track_scale(a, b, p0, p1, sc, valid, radius=11, iters=12)
    r = KK.track_scale_ref(a, b, p0, p1, sc, valid, 11, 12)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["klt_scale"] == 1
    assert torch.equal(k[2], r[2])
    torch.testing.assert_close(k[0], r[0], atol=1e-3, rtol=0)  # summation order only


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_serve(dev):
    a, b = _pair(dev)
    p0 = _grid(dev)
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # mixed devices
        KK.track_level(a, b, p0.cpu(), p0.cpu(), valid)
    with pytest.raises(TypeError):
        KK.track_level(a.half(), b.half(), p0, p0, valid)
    with pytest.raises(ValueError):
        KK.track_scale(a, b, p0, p0, torch.ones(len(p0), device=dev), valid, radius=12)


def agree(p_k, ok_k, p_r, ok_r, min_live=0.25):
    """chip_smoke.py's kernel-vs-plain tolerances: median |dp| <= 1e-3 px
    over features live in both, at most 0.5% of them farther apart than
    0.05 px (float32 rounding can move the |step| < eps stop test by one
    step), flags equal on at least 99.5% of features."""
    both = ok_k & ok_r
    assert int(both.sum()) >= min_live * ok_r.numel()
    dp = torch.linalg.norm(p_k - p_r, dim=-1)[both]
    assert float(dp.median()) <= 1e-3
    assert float((dp > 0.05).float().mean()) <= 0.005
    assert float((ok_k == ok_r).float().mean()) >= 0.995


def border_features(dev, H=120, W=160):
    """Features 1-2 px inside each border (and the corners), then a grid."""
    pts = []
    for d in (1.0, 1.5, 2.0):
        for x in np.linspace(12, W - 13, 7):
            pts += [(x, d), (x, H - 1 - d)]
        for y in np.linspace(12, H - 13, 5):
            pts += [(d, y), (W - 1 - d, y)]
        pts += [(d, d), (W - 1 - d, d), (d, H - 1 - d), (W - 1 - d, H - 1 - d)]
    grid = _grid(dev, H, W, margin=6, n=10).cpu().numpy().tolist()
    return torch.tensor(pts + grid, dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("epi1d", [False, True])
def test_klt_pyr_climb_matches_plain_version(dev, epi1d):
    """The fused climb, forward and bidirectional, with features 1-2 px from
    every border."""
    a, b = _pair(dev, shift=(3, 0) if epi1d else (3, -2))
    imgs0, imgs1 = list(build_pyramid(a, 3)), list(build_pyramid(b, 3))
    p0 = border_features(dev)
    seed = (p0 + torch.tensor([2.0, 0.0 if epi1d else -1.0], device=dev)).contiguous()
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    args = (imgs0, imgs1, p0, seed, valid, 10, 15, 6, 0.03, 1e-4, epi1d)
    KK.reset_launch_counts()
    k = KK.track_pyr(*args)
    kb = KK.track_pyr_bidir(*args, back_levels=1)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["klt_pyr"] == 2
    r = KK.track_pyr_ref(*args)
    rb = KK.track_pyr_bidir_ref(*args, back_levels=1)
    agree(k[0], k[1], r[0], r[1])
    agree(kb[0], kb[1], rb[0], rb[1])
    agree(kb[3], kb[4], rb[3], rb[4])
    assert bool(k[1][:8].any())  # some border features stay live


@pytest.mark.cuda
def test_klt_pyr_restages_the_target_box(dev):
    """Seeds 6-10 px from the answer at one level: Gauss-Newton walks out of
    the first staged box (4 px margin) and the kernel re-stages it."""
    a, b = _pair(dev, shift=(2, -1), seed=41)
    p0 = _grid(dev, margin=24, n=12)
    rng = np.random.default_rng(4)
    ang = rng.uniform(0, 2 * np.pi, len(p0))
    rad = rng.uniform(6, 10, len(p0))
    off = torch.tensor(np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1), dtype=torch.float32, device=dev)
    seed = (p0 + torch.tensor([2.0, -1.0], device=dev) + off).contiguous()
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    k = KK.track_level(a, b, p0, seed, valid, radius=10, iters=30)
    r = KK.track_level_ref(a, b, p0, seed, valid, 10, 30)
    agree(k[0], k[1], r[0], r[1])
    walked = torch.linalg.norm(r[0] - seed, dim=-1)[r[1]]
    assert float((walked > 5.0).float().mean()) > 0.5  # most estimates left the first box


@pytest.mark.cuda
@pytest.mark.parametrize("s", [0.5, 2.0])
def test_klt_scale_at_the_clip_limits(dev, s):
    a, b = _pair(dev, shift=(2, -1))
    p0 = border_features(dev)
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    sc = torch.full((len(p0),), s, device=dev)
    p1 = (p0 + torch.tensor([1.5, -0.5], device=dev)).contiguous()
    k = KK.track_scale(a, b, p0, p1, sc, valid, radius=11, iters=12)
    r = KK.track_scale_ref(a, b, p0, p1, sc, valid, 11, 12)
    agree(k[0], k[2], r[0], r[2], min_live=0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1024, 4096])
def test_klt_kernels_at_batch_sizes(dev, n):
    a, b = _pair(dev, shift=(2, -1))
    imgs0, imgs1 = list(build_pyramid(a, 3)), list(build_pyramid(b, 3))
    rng = np.random.default_rng(n)
    p0 = torch.tensor(rng.uniform([12, 12], [147, 107], (n, 2)), dtype=torch.float32, device=dev)
    seed = (p0 + torch.tensor(rng.uniform(1, 3, (n, 2)) * [1, -0.5], dtype=torch.float32, device=dev)).contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    k = KK.track_pyr(imgs0, imgs1, p0, seed, valid, 10, 15, 6)
    r = KK.track_pyr_ref(imgs0, imgs1, p0, seed, valid, 10, 15, 6)
    ks = KK.track_scale(a, b, p0, k[0].contiguous(), torch.ones(n, device=dev), k[1], 11, 12)
    rs = KK.track_scale_ref(a, b, p0, k[0].contiguous(), torch.ones(n, device=dev), k[1], 11, 12)
    if n == 1:  # one feature: exact flags, 1e-3 px
        assert torch.equal(k[1], r[1]) and torch.equal(ks[2], rs[2])
        torch.testing.assert_close(k[0], r[0], atol=1e-3, rtol=0)
    else:
        agree(k[0], k[1], r[0], r[1])
        agree(ks[0], ks[2], rs[0], rs[2])


@pytest.mark.cuda
def test_klt_kernels_on_an_all_invalid_batch(dev):
    a, b = _pair(dev)
    imgs0, imgs1 = list(build_pyramid(a, 3)), list(build_pyramid(b, 3))
    p0 = _grid(dev, margin=12)
    seed = (p0 + 1.0).contiguous()
    valid = torch.zeros(len(p0), dtype=torch.bool, device=dev)
    p1, live, err, p0b, live0 = KK.track_pyr_bidir(imgs0, imgs1, p0, seed, valid, 10, 15, 6, back_levels=1)
    assert torch.equal(p1, seed) and not live.any() and not live0.any()
    assert torch.equal(err, torch.zeros_like(err))
    assert torch.equal(p0b, p0 / 1.0)  # the backward climb keeps its seed, p0
    q, e, ok = KK.track_scale(a, b, p0, seed, torch.ones(len(p0), device=dev), valid, 11, 12)
    assert torch.equal(q, seed) and not ok.any() and torch.equal(e, torch.zeros_like(e))


@pytest.mark.cuda
def test_one_klt_pyr_launch_per_pyramid_track(dev):
    """ops/klt's pyramid tracks launch one kernel per call on CUDA tensors."""
    a, b = _pair(dev, shift=(2, -1))
    pyr0 = tuple((x, x, x) for x in build_pyramid(a, 3))
    pyr1 = tuple((x, x, x) for x in build_pyramid(b, 3))
    p0 = _grid(dev, margin=12)
    prior = (p0 + torch.tensor([2.0, -1.0], device=dev)).contiguous()
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    params = KLT.KLTParams(window_radius=10, levels=3, iters=15, iters_coarse=6, use_kernel=True)
    for call in (
        lambda: KLT._pyr_track(pyr0, pyr1, p0, prior, valid, params),
        lambda: KLT._pyr_track(pyr0, pyr1, p0, prior, valid, params, track_levels=1, epi1d=True),
        lambda: KLT.track_with_prior_pyr(pyr0, pyr1, p0, prior, valid, params),
        lambda: KLT.track_bidirectional_pyr(pyr0, pyr1, p0, prior, valid, params, fb_scale=5.0, back_levels=1),
    ):
        KK.reset_launch_counts()
        call()
        assert KK.LAUNCHES == {"klt_pyr": 1, "klt_scale": 0}


def plane_cfg():
    """tests/test_stereo_vo_pipeline.py:_small_cfg."""
    cfg = tio.VOConfig()
    cfg.cam.fx = cfg.cam.fy = 500.0
    cfg.cam.cx, cfg.cam.cy = 320.0, 240.0
    cfg.cam.width, cfg.cam.height = 640, 480
    cfg.cam_right = cfg.cam
    cfg.T_lr = np.eye(4, dtype=np.float32)
    cfg.T_lr[0, 3] = 0.5
    cfg.extractor.n_features = 384
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.extractor.score_min = 10.0
    cfg.extractor.thres_fastscore = 8.0
    cfg.map.landmark_capacity = 2048
    cfg.keyframe.n_max_keyframes_in_window = 5
    cfg.keyframe.thres_translation = 1.0
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    return cfg


@pytest.mark.cuda
def test_pipeline_runs_on_cuda_through_the_kernels(dev):
    world = tio.PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    poses = tio.forward_trajectory(12, step=0.22, yaw_rate=0.0015)
    vo = StereoVO(plane_cfg(), device=dev)
    KK.reset_launch_counts()
    for T in poses:
        vo.track_stereo_images(*world.stereo_pair(T.astype(np.float64)))
    assert KK.LAUNCHES["klt_pyr"] > 0 and KK.LAUNCHES["klt_scale"] > 0
    traj = np.stack(vo.trajectory)
    # Bounds of tests/test_stereo_vo_pipeline.py.
    assert tio.ate_rmse(traj, poses, align="none") < 0.05 * 0.22 * 11
    assert sum(1 for s in vo.stats_log if s.get("ba_err") is not None and not s["ba_rejected"]) >= 2


def descriptor_sets(seed):
    """Descriptor bytes with deliberate ties (duplicated rows in both sets)
    and near copies that pass the ratio test."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, (5000, 32)).astype(np.int32)  # > one chunk of the distance matrix
    db[40] = db[41]
    da = db[rng.choice(5000, 512, replace=False)].copy()
    flip = rng.integers(0, 256, da.shape) & rng.integers(0, 256, da.shape) & rng.integers(0, 256, da.shape)
    da ^= np.where(rng.random(da.shape) < 0.15, flip, 0).astype(np.int32)
    da[10] = da[11]
    da[20] = db[40]
    da[30] = db[7]
    da[31] = db[7]
    return da, rng.random(512) > 0.1, db, rng.random(5000) > 0.1


@pytest.mark.cuda
def test_hamming_matching_on_cuda_equals_cpu(dev):
    """Integer distances and first-index tie breaking: exactly the CPU's."""
    da, va, db, vb = (torch.as_tensor(x) for x in descriptor_sets(3))
    d_cpu = TF.hamming_distance_matrix(da, db)
    d_gpu = TF.hamming_distance_matrix(da.to(dev), db.to(dev))
    assert torch.equal(d_gpu.cpu(), d_cpu)
    m_cpu, ok_cpu = TF.match_descriptors(da, va, db, vb, max_dist=60)
    m_gpu, ok_gpu = TF.match_descriptors(da.to(dev), va.to(dev), db.to(dev), vb.to(dev), max_dist=60)
    assert torch.equal(ok_gpu.cpu(), ok_cpu) and torch.equal(m_gpu.cpu(), m_cpu)
    assert int(ok_cpu.sum()) > 100


@pytest.mark.cuda
def test_pnp_ransac_on_cuda_matches_cpu(dev):
    """The same injected draws on both devices: T_cw to 1e-4, the same
    inlier mask and count (cuSOLVER against LAPACK eigh/SVD, float32)."""
    rng = np.random.default_rng(3)
    n = 256
    Xw = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n), rng.uniform(4, 30, n)], -1).astype(np.float32)
    T_cw = TG.se3_exp(torch.tensor([0.4, -0.15, 0.2, 0.03, 0.08, -0.02])).numpy()
    Xc = Xw @ T_cw[:3, :3].T + T_cw[:3, 3]
    pts = np.stack([Xc[:, 0] / Xc[:, 2] * 700 + 320, Xc[:, 1] / Xc[:, 2] * 700 + 240], -1).astype(np.float32)
    pts += rng.normal(0, 0.05, pts.shape).astype(np.float32)
    out = rng.choice(n, 77, replace=False)
    pts[out] += rng.uniform(25, 90, (77, 2)).astype(np.float32)
    valid = torch.as_tensor(rng.random(n) > 0.1)
    idx = TPNP.sample_minimal_sets(valid, 64, torch.Generator().manual_seed(5))
    args = (torch.as_tensor(Xw), torch.as_tensor(pts), valid, 700.0, 700.0, 320.0, 240.0)
    r_cpu = TPNP.pnp_ransac(*args, idx=idx)
    r_gpu = TPNP.pnp_ransac(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args), idx=idx.to(dev))
    assert bool(r_cpu.ok) and bool(r_gpu.ok)
    torch.testing.assert_close(r_gpu.T_cw.cpu(), r_cpu.T_cw, atol=1e-4, rtol=0)
    assert torch.equal(r_gpu.inliers.cpu(), r_cpu.inliers) and int(r_gpu.n_inliers) == int(r_cpu.n_inliers)


@pytest.mark.cuda
def test_rectification_on_cuda_matches_cpu(dev):
    """Maps built on each device, remapped through bilinear_sample: 1e-4 in
    intensity on a smooth image."""
    dist_l = [-0.28, 0.07, 1e-4, -1e-4, 0.0]
    dist_r = [-0.25, 0.05, -2e-4, 1e-4, 0.01]
    T_lr = TG.se3_exp(torch.tensor([0.5, 0.02, -0.01, 0.01, -0.02, 0.015]))
    img_l = torch.as_tensor(smooth_noise(120, 160, 1, smooth=6))
    img_r = torch.as_tensor(smooth_noise(120, 160, 2, smooth=6))
    out = []
    for d in ("cpu", dev):
        left = TC.make_camera(150.0, 152.0, 81.0, 58.5, dist_l, 160, 120, device=d)
        right = TC.make_camera(148.0, 149.0, 79.5, 61.0, dist_r, 160, 120, device=d)
        st = TC.make_stereo_camera(left, right, T_lr)
        out.append([x.cpu() for x in TC.rectify_stereo_images(st, img_l.to(d), img_r.to(d))])
    for a, b in zip(out[1], out[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_recovery_on_cuda_relocalizes_after_blackout(dev):
    """tests/test_stereo_vo_pipeline.py's blackout world on the card, with
    the port's own draws from CUDA generators: descriptor relocalization
    (mode 3) fires and the final pose is within 0.25 m of the truth."""
    world = tio.PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    poses = tio.forward_trajectory(6, step=0.22, yaw_rate=0.0015)
    poses = np.concatenate([poses, np.repeat(poses[-1:], 8, axis=0)])
    rng = np.random.default_rng(3)
    vo = StereoVO(plane_cfg(), device=dev)
    for i, T in enumerate(poses):
        il, ir = world.stereo_pair(T.astype(np.float64))
        if 6 <= i < 9:
            il = rng.uniform(0, 255, il.shape).astype(np.float32)
            ir = rng.uniform(0, 255, ir.shape).astype(np.float32)
        vo.track_stereo_images(il, ir)
    assert 3 in [s.get("recovered", 0) for s in vo.stats_log]
    assert np.linalg.norm(vo.trajectory[-1][:3, 3] - poses[-1][:3, 3]) < 0.25
