"""The hand-written kernels (KLT, pose_gn, ba_*) and the ported pipeline on a CUDA GPU.

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
from visual_odometry_ros_tpu_torch.io.synthetic import TwoPlaneSequence  # noqa: E402
from visual_odometry_ros_tpu_torch.models import mono_vo as TMVO  # noqa: E402
from visual_odometry_ros_tpu_torch.models import stereo_vo as TSVO  # noqa: E402
from visual_odometry_ros_tpu_torch.models.mono_vo import MonoVO  # noqa: E402
from visual_odometry_ros_tpu_torch.models.stereo_vo import StereoVO  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import features as TF  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import klt as KLT  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import kernels as KN  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pnp as TPNP  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pose_gn as TPG  # noqa: E402
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
    KN.reset_launch_counts()
    k = KK.track_level(a, b, p0, p1, valid, radius=10, iters=15, epi1d=epi1d)
    r = KK.track_level_ref(a, b, p0, p1, valid, 10, 15, 0.03, 1e-4, epi1d)
    torch.cuda.synchronize()
    assert KN.LAUNCHES["klt_pyr"] == 1
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
    KN.reset_launch_counts()
    k = KK.track_scale(a, b, p0, p1, sc, valid, radius=11, iters=12)
    r = KK.track_scale_ref(a, b, p0, p1, sc, valid, 11, 12)
    torch.cuda.synchronize()
    assert KN.LAUNCHES["klt_scale"] == 1
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
    KN.reset_launch_counts()
    k = KK.track_pyr(*args)
    kb = KK.track_pyr_bidir(*args, back_levels=1)
    torch.cuda.synchronize()
    assert KN.LAUNCHES["klt_pyr"] == 2
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
        KN.reset_launch_counts()
        call()
        assert KN.LAUNCHES == {**dict.fromkeys(KN.LAUNCHES, 0), "klt_pyr": 1}


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
    KN.reset_launch_counts()
    for T in poses:
        vo.track_stereo_images(*world.stereo_pair(T.astype(np.float64)))
    assert KN.LAUNCHES["klt_pyr"] > 0 and KN.LAUNCHES["klt_scale"] > 0
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


def mono_cfg(use_pallas="auto"):
    """tests/test_mono_vo_pipeline.py:_mono_cfg."""
    cfg = tio.VOConfig()
    cfg.cam.fx = cfg.cam.fy = 500.0
    cfg.cam.cx, cfg.cam.cy = 320.0, 240.0
    cfg.cam.width, cfg.cam.height = 640, 480
    cfg.extractor.n_features = 384
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.extractor.score_min = 10.0
    cfg.extractor.thres_fastscore = 8.0
    cfg.map.landmark_capacity = 2048
    cfg.map.thres_parallax = 0.4
    cfg.keyframe.n_max_keyframes_in_window = 5
    cfg.keyframe.thres_translation = 1e9
    cfg.keyframe.thres_overlap_ratio = 0.75
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    cfg.tracker.thres_sampson = 100.0
    cfg.tracker.use_pallas = use_pallas
    return cfg


def test_entry_points_default_to_the_card():
    """StereoVO(cfg), MonoVO(cfg) and both `state_from_numpy` place their
    tensors on the card; with no card the constructor (or at the latest the
    first frame) and the state restore raise instead of carrying on on the
    CPU."""
    frame = np.zeros((480, 640), np.float32)
    trees = []
    for cls, mod, cfg in ((StereoVO, TSVO, plane_cfg()), (MonoVO, TMVO, mono_cfg())):
        vo = cls(cfg, device="cpu")
        trees.append((mod, mod.state_to_numpy(vo.init_state(vo._build_pyr(torch.zeros(480, 640))))))
    if torch.cuda.is_available():
        for vo in (StereoVO(plane_cfg()), MonoVO(mono_cfg())):
            assert vo.device.type == "cuda"
        for mod, tree in trees:
            assert mod.state_from_numpy(tree).T_wc.device.type == "cuda"
        return
    for make, feed in ((lambda: StereoVO(plane_cfg()), lambda vo: vo.track_stereo_images(frame, frame)),
                       (lambda: MonoVO(mono_cfg()), lambda vo: vo.track_image(frame))):
        with pytest.raises((RuntimeError, AssertionError)):
            feed(make())
    for mod, tree in trees:
        with pytest.raises((RuntimeError, AssertionError)):
            mod.state_from_numpy(tree)


@pytest.mark.cuda
def test_klt_pyr_bidir_2d_at_mono_call_sites(dev):
    """The 2-D bidirectional climb with the backward pass over level 0 only,
    as mono's init track (seeded at p0) and steady track (seeded from a
    prior) launch it: forward and backward outputs against the plain version,
    features 1-2 px from every border."""
    a, b = _pair(dev, shift=(3, -2))
    imgs0, imgs1 = list(build_pyramid(a, 3)), list(build_pyramid(b, 3))
    p0 = border_features(dev)
    rng = np.random.default_rng(5)
    prior = (p0 + torch.tensor([3.0, -2.0], device=dev)
             + torch.tensor(rng.uniform(-1, 1, p0.shape), dtype=torch.float32, device=dev)).contiguous()
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    for seed in (p0.contiguous(), prior):
        args = (imgs0, imgs1, p0, seed, valid, 10, 15, 6, 0.03, 1e-4, False)
        KN.reset_launch_counts()
        k = KK.track_pyr_bidir(*args, back_levels=1)
        torch.cuda.synchronize()
        assert KN.LAUNCHES == {**dict.fromkeys(KN.LAUNCHES, 0), "klt_pyr": 1}
        r = KK.track_pyr_bidir_ref(*args, back_levels=1)
        agree(k[0], k[1], r[0], r[1])
        agree(k[3], k[4], r[3], r[4])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [0.3, 3.5])
def test_klt_scale_mono_iterations_beyond_the_clip(dev, s):
    """Mono's 30 scale iterations with a prior outside [0.5, 2] (mono clips
    its priors to [0.25, 4]); the kernel clamps s as its plain version does."""
    a, b = _pair(dev, shift=(2, -1))
    p0 = border_features(dev)
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    sc = torch.full((len(p0),), s, device=dev)
    p1 = (p0 + torch.tensor([1.5, -0.5], device=dev)).contiguous()
    k = KK.track_scale(a, b, p0, p1, sc, valid, radius=11, iters=30)
    r = KK.track_scale_ref(a, b, p0, p1, sc, valid, 11, 30)
    agree(k[0], k[2], r[0], r[2], min_live=0.2)
    clamped = KK.track_scale_ref(a, b, p0, p1, torch.full_like(sc, 0.5 if s < 1 else 2.0), valid, 11, 30)
    assert torch.equal(r[2], clamped[2]) and torch.equal(r[0], clamped[0])


@pytest.mark.cuda
def test_mono_pipeline_on_cuda_kernel_and_plain_legs(dev):
    """MonoVO(cfg) with no device argument on the two-plane world: the kernel
    leg and the plain leg run on the card with the same phases, and both
    stay within tests/test_mono_vo_pipeline.py's bound (sim3 ATE after the
    bootstrap < 8% of the distance)."""
    world = TwoPlaneSequence(z0_a=9.0, z0_b=18.0)
    poses = tio.forward_trajectory(16, step=0.3, yaw_rate=0.001, lateral=0.12)
    frames = [world.render(np.linalg.inv(T.astype(np.float64))) for T in poses]
    runs = {}
    for leg in ("auto", "off"):
        vo = MonoVO(mono_cfg(leg))
        assert vo.device.type == "cuda"
        KN.reset_launch_counts()
        for f in frames:
            vo.track_image(f)
        runs[leg] = (vo, dict(KN.LAUNCHES))
    assert runs["auto"][1]["klt_pyr"] > 0 and runs["auto"][1]["klt_scale"] > 0
    # The KLT switch leaves the pose solve alone: pose_gn runs on both legs.
    assert runs["off"][1]["klt_pyr"] == runs["off"][1]["klt_scale"] == 0
    assert runs["off"][1]["pose_gn"] == runs["auto"][1]["pose_gn"] > 0
    phases = [[s["phase"] for s in vo.stats_log] for vo, _ in runs.values()]
    assert phases[0] == phases[1] and "bootstrapped" in phases[0]
    b = phases[0].index("bootstrapped")
    path = np.sum(np.linalg.norm(np.diff(poses[b:, :3, 3], axis=0), axis=1))
    for vo, _ in runs.values():
        assert tio.ate_rmse(np.stack(vo.trajectory)[b:], poses[b:], align="sim3") < 0.08 * path


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["track", "track_with_prior", "track_bidirectional"])
def test_image_level_klt_is_one_launch_and_agrees(dev, name):
    """ops/klt's image-level calls on the kernel leg: exactly one klt_pyr
    launch each (the backward climb fused for the bidirectional call), and
    the same result as the call on CPU tensors (the plain versions)."""
    a, b = _pair(dev)
    p0 = _grid(dev, margin=12)
    valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
    kp = KLT.KLTParams(levels=3, use_kernel=True)
    args = (a, b, p0) if name == "track" else (a, b, p0, (p0 + torch.tensor([1.5, -0.5], device=dev)).contiguous())
    KN.reset_launch_counts()
    p_k, ok_k = getattr(KLT, name)(*args, valid, kp)
    torch.cuda.synchronize()
    assert KN.LAUNCHES == {**dict.fromkeys(KN.LAUNCHES, 0), "klt_pyr": 1}
    p_r, ok_r = getattr(KLT, name)(*(x.cpu() for x in args), valid.cpu(), kp)
    agree(p_k.cpu(), ok_k.cpu(), p_r, ok_r, min_live=0.5)


def _tiny_kitti(root):
    """A 320x240 KITTI layout of the plane world (6 frames, 0.22 m/frame)
    and a reference-format YAML sized for it."""
    import chip_smoke as CS

    world = tio.PlaneSequence(width=320, height=240, fx=250.0, fy=250.0, cx=160.0, cy=120.0, z0=14.0, sx=0.3,
                              sy=0.15, baseline=0.5)
    poses = tio.forward_trajectory(6, step=0.22, yaw_rate=0.0015)
    pairs = [[np.clip(x, 0, 255).astype(np.uint8) for x in world.stereo_pair(T.astype(np.float64))] for T in poses]
    CS.write_kitti_layout(str(root), [p[0] for p in pairs], [p[1] for p in pairs], poses, 250.0, 160.0, 120.0, 0.5)
    cfg = root / "tiny.yaml"
    cam = "".join(f"Camera.{s}.{k}: {v}\n" for s in ("left", "right")
                  for k, v in (("fx", 250.0), ("fy", 250.0), ("cx", 160.0), ("cy", 120.0), ("width", 320), ("height", 240)))
    cfg.write_text("%YAML:1.0\nflagDoUndistortion: 0\n" + cam + "T_lr: !!opencv-matrix\n  rows: 4\n  cols: 4\n"
                   "  dt: f\n  data: [1,0,0,0.5, 0,1,0,0, 0,0,1,0, 0,0,0,1]\nfeature_tracker.max_level: 3\n"
                   "feature_extractor.n_features: 256\nfeature_extractor.n_bins_u: 16\nfeature_extractor.n_bins_v: 8\n"
                   "feature_extractor.thres_fastscore: 8.0\n")
    return str(root), str(cfg), poses


@pytest.mark.cuda
def test_cli_on_a_tiny_kitti_layout_on_the_card(dev, tmp_path):
    """run_vo on the card by default: through both kernels, one stats record
    per frame, and the CPU run's poses (plain kernel versions) to 5 mm."""
    from visual_odometry_ros_tpu_torch import run_vo

    root, cfg, poses = _tiny_kitti(tmp_path / "kitti")
    base = ["--dataset", "kitti", "--root", root, "--config", cfg, "--mode", "stereo", "--quiet"]
    KN.reset_launch_counts()
    s = run_vo.main(base + ["--out", str(tmp_path / "card")])
    assert KN.LAUNCHES["klt_pyr"] > 0 and KN.LAUNCHES["klt_scale"] == 5
    run_vo.main(base + ["--out", str(tmp_path / "cpu"), "--device", "cpu"])
    assert s["frames"] == 6 and len((tmp_path / "card" / "stats.jsonl").read_text().splitlines()) == 6
    card, cpu = (np.loadtxt(tmp_path / d / "frame_poses.txt") for d in ("card", "cpu"))
    np.testing.assert_allclose(card, cpu, atol=5e-3, rtol=0)
    assert s["ate_rmse"] < 0.05 * 0.22 * 5 and s["mean_n_final"] > 30


@pytest.mark.cuda
def test_one_rank_nccl_ba_matches_single_device(dev, tmp_path):
    """make_distributed_ba over a one-rank NCCL group at dryrun_multichip's
    problem shape (M cut to 1024): test_dist_ba.py's tolerances."""
    import torch.distributed as dist

    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.parallel import dist_ba
    from visual_odometry_ros_tpu_torch.parallel import multihost as MH

    rank_dev = MH.init_worker(f"file://{tmp_path / 'rdv'}", 1, 0, backend="nccl")
    try:
        assert rank_dev.type == "cuda" and dist.get_backend() == "nccl"
        prob, fx, fy, cx, cy, T_rl = MH.dryrun_problem_np(M=1024)
        group = MH.global_mesh()
        local = MH.host_tree(prob, group, dist_ba._sharded_specs()[0], rank_dev)
        T_rl = torch.as_tensor(T_rl, device=rank_dev)
        params = BA.BAParams(iters=3)
        info_d, info_s = {}, {}
        res = dist_ba.make_distributed_ba(group, params)(local, fx, fy, cx, cy, T_rl, info_d)
        KN.reset_launch_counts()
        ref = BA.ba_solve_impl(BA.BAProblem(*(torch.as_tensor(a, device=rank_dev) for a in prob)), fx, fy, cx, cy,
                               T_rl, params, info=info_s)
        assert KN.LAUNCHES["ba_backsub"] == params.iters  # the single-device solve runs on the ba_* kernels
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(res.T_cw, ref.T_cw, atol=2e-4, rtol=0)
    torch.testing.assert_close(res.Xw, ref.Xw, atol=5e-3, rtol=0)
    assert abs(float(res.mean_err_px) - float(ref.mean_err_px)) < 1e-3
    assert int(res.n_obs) == int(ref.n_obs) and info_d == info_s


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
def test_mono_recover_on_cuda_matches_cpu(dev, mode):
    """MonoVO._recover on the card and on a CPU copy of the same steady
    state with the same draws: PnP relocalization on the tracked landmarks
    (mode 1), or with every track dropped a re-bootstrap (mode 2). The same
    mode, track mask and fail_count, T_wc to 1e-4."""
    world = TwoPlaneSequence(z0_a=9.0, z0_b=18.0)
    poses = tio.forward_trajectory(12, step=0.3, yaw_rate=0.001, lateral=0.12)
    vo = MonoVO(mono_cfg("auto"))
    for T in poses:
        vo.track_image(world.render(np.linalg.inv(T.astype(np.float64))))
    assert vo.phase == 2 and vo.stats_log[-1]["phase"] == "steady"
    state = TMVO.state_from_numpy(TMVO.state_to_numpy(vo.state), device="cpu")
    if mode == 2:
        state = state.replace(tracks=state.tracks.replace(valid=torch.zeros_like(state.tracks.valid)))
    tree = TMVO.state_to_numpy(state)
    cpu = MonoVO(mono_cfg("auto"), device="cpu")
    fid = int(state.frame_id)

    def draw(valid):  # the CPU generator's draws on the caller's device
        return cpu._draw_recovery(fid, valid.cpu()).to(valid.device)

    out = {}
    for name, v, d in (("cuda", vo, dev), ("cpu", cpu, torch.device("cpu"))):
        new, got = v._recover(TMVO.state_from_numpy(tree, device=d), draw=draw)
        out[name] = (TMVO.state_from_numpy(TMVO.state_to_numpy(new), device="cpu"), int(got))
    (c, mc), (p, mp) = out["cuda"], out["cpu"]
    assert mc == mp == mode
    assert torch.equal(c.tracks.valid, p.tracks.valid)
    assert int(c.fail_count) == int(p.fail_count) == 0
    torch.testing.assert_close(c.T_wc, p.T_wc, atol=1e-4, rtol=0)
    if mode == 2:
        assert int(c.ring.count) == 1 and int(c.tracks.valid.sum()) > 50


@pytest.mark.cuda
def test_rectify_tool_on_cuda_matches_cpu(dev, tmp_path):
    """The port's rectification tool with its default device (the card)
    against --device cpu on a radtan pair: the same files, pixels within one
    grey level (uint8 rounding), the same printed K_rect and baseline."""
    from PIL import Image

    from test_torch_rectify_tool import k_rect, rectified, write_raw_pairs, write_stereo_yaml
    from visual_odometry_ros_tpu_torch import rectify_stereo as TR

    cfg = write_stereo_yaml(tmp_path / "stereo.yaml")
    left, right = write_raw_pairs(str(tmp_path / "raw"))
    common = ["--config", cfg, "--left", left, "--right", right, "--out"]
    line_c = TR.main(common + [str(tmp_path / "card")])
    line_p = TR.main(common + [str(tmp_path / "cpu"), "--device", "cpu"])
    c, p = rectified(tmp_path / "card"), rectified(tmp_path / "cpu")
    assert list(c) == list(p) and len(c) == 4
    for k in c:
        assert np.abs(c[k] - p[k]).max() <= 1, k
    np.testing.assert_allclose(k_rect(line_c), k_rect(line_p), atol=1e-3, rtol=0)
    assert Image.open(os.path.join(tmp_path, "card", "left", "000000.png")).mode == "L"


@pytest.mark.cuda
def test_profiler_klt_events_equal_the_launch_counters(dev):
    """profile_stages' trace of a pipeline batch on the card: the KLT kernels'
    trace events equal ops/kernels.LAUNCHES over the same window, the
    trace holds device time, and the sync count restores the debug mode."""
    from visual_odometry_ros_tpu_torch import profile_stages as PS

    world = tio.PlaneSequence(z0=14.0, sx=0.3, sy=0.15, baseline=0.5)
    poses = tio.forward_trajectory(7, step=0.22, yaw_rate=0.0015)
    pairs = [world.stereo_pair(T.astype(np.float64)) for T in poses]
    il, ir = np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])
    vo = StereoVO(plane_cfg(), device=dev)
    vo.track_stereo_batch(il[:4], ir[:4])
    win = PS.trace_window(lambda: vo.track_stereo_batch(il[4:], ir[4:]), dev)
    assert win["kernel_launches"]["klt_pyr"] >= 6 and win["kernel_launches"]["klt_scale"] == 3
    assert win["kernel_launches"]["pose_gn"] >= 3  # one per tracked frame, more on a recovery
    assert win["kernel_trace_events"] == win["kernel_launches"]
    assert 0 < win["busy_ms"] <= win["window_ms"] and 0 <= win["idle_share"] < 1 and win["top_ops"]
    state = vo.state
    im = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (il[6], ir[6])]
    before = torch.cuda.get_sync_debug_mode()
    assert PS.count_syncs(lambda: vo._steady_step(state, *im), dev) > 0
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.cuda
def test_pinned_upload_equals_the_pageable_one(dev):
    from visual_odometry_ros_tpu_torch import h2d_overlap_probe as H2D

    rng = np.random.default_rng(0)
    host = tuple(rng.integers(0, 255, (3, 376, 1241), np.uint8) for _ in range(2))
    routes = H2D._Routes(host, dev)
    page, page_f = routes.read(routes.pageable_start())
    pin, pin_f = routes.read(routes.pinned_start())
    torch.cuda.synchronize(dev)
    for a, b, h in zip(page, pin, host):
        assert a.device.type == b.device.type == "cuda" and a.dtype == b.dtype == torch.uint8
        assert torch.equal(a, b) and np.array_equal(b.cpu().numpy(), h)
    for a, b in zip(page_f, pin_f):
        assert a.dtype == torch.float32 and torch.equal(a, b)


# ----------------------------------------------------------------------------
# pose_gn: the whole pose solve in one launch
# ----------------------------------------------------------------------------


def pose_problem(dev, kind, seed=21, n_out=None, behind=0, n_valid=None, nan_obs=False):
    """tests/test_torch_pose_gn.py's stereo frame pair (KITTI intrinsics,
    0.3 px noise, gross outliers, ~95% / ~80% valid) at `kind`'s N, on
    `dev`: the arguments of POSE_CALLS[kind] before params."""
    n = POSE_CALLS[kind][1]
    rng = np.random.default_rng(seed)
    n_out = n // 8 if n_out is None else n_out
    X0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n), rng.uniform(4, 40, n)], -1).astype(np.float32)
    T10 = TG.se3_exp(torch.tensor([0.02, -0.01, -0.25, 0.003, 0.008, -0.002])).numpy()
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.5371657
    f, cx, cy = 718.856, 607.1928, 185.2157
    Xl = X0 @ T10[:3, :3].T + T10[:3, 3]
    Xr = Xl + T_rl[:3, 3]
    pl = np.stack([Xl[:, 0] / Xl[:, 2] * f + cx, Xl[:, 1] / Xl[:, 2] * f + cy], -1)
    pr = np.stack([Xr[:, 0] / Xr[:, 2] * f + cx, Xr[:, 1] / Xr[:, 2] * f + cy], -1)
    pl = (pl + rng.normal(0, 0.3, pl.shape)).astype(np.float32)
    pr = (pr + rng.normal(0, 0.3, pr.shape)).astype(np.float32)
    pl[:n_out] += rng.uniform(-30, 30, (n_out, 2)).astype(np.float32)
    vl = rng.uniform(size=n) > 0.05
    vr = vl & (rng.uniform(size=n) > 0.2)
    if behind:
        X0[n_out:n_out + behind, 2] *= -1.0
    if n_valid is not None:
        vl[np.cumsum(vl) > n_valid] = False
        vr &= vl
    if nan_obs:
        pl[np.flatnonzero(vl)[-1], 0] = np.nan
    t = {k: torch.as_tensor(v, device=dev) for k, v in dict(X0=X0, pl=pl, pr=pr, vl=vl, vr=vr, T_rl=T_rl).items()}
    T0 = torch.eye(4, device=dev)
    if "mono" in kind:
        return (t["X0"], t["pl"], t["vl"], f, f, cx, cy, T0)
    return (t["X0"], t["pl"], t["pr"], t["vl"], t["vr"], f, f, cx, cy, t["T_rl"], T0)


POSE_CASES = {
    "main": ({}, {}),
    "max_iters": ({}, dict(step_tol=0.0, cost_tol=0.0)),
    "few_valid": (dict(n_out=0, n_valid=4), {}),
    "cholesky_fails": (dict(nan_obs=True), {}),
    "all_invalid": (dict(n_valid=0), {}),
    "behind_camera": (dict(behind=100), {}),
}
POSE_CALLS = {  # function, N: stereo at the bench config's 1024 tracks, mono at 512
    "stereo_robust": ("pose_only_gn_stereo_robust", 1024),
    "mono_robust": ("pose_only_gn_mono_robust", 512),
    "mono_polish": ("pose_only_gn_mono", 512),
    "stereo_polish": ("pose_only_gn_stereo", 1024),
}


def pose_call(kind, args, params):
    name = POSE_CALLS[kind][0]
    fns = getattr(TPG, name), getattr(TPG, name + "_ref")
    robust = name.endswith("_robust")
    return [(lambda f=f: f(*args, params) if robust else (f(*args, params), None)) for f in fns]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(POSE_CASES))
@pytest.mark.parametrize("kind", list(POSE_CALLS))
def test_pose_gn_matches_plain_version(dev, kind, case):
    """One pose_gn launch per solve; against the plain version on the card.
    Only the sum order differs, which can move the stop test by an
    iteration: T10 to 1e-4 (an extra iteration at the step_tol stop moves it
    by less), the same ok, mean error to 1e-3 relative; a pose within 1e-4
    moves a pixel by up to fx * 1e-4 (0.07 px): per-point error to 1e-3
    relative plus that, and the same inliers except within that of the
    threshold."""
    kw, prm = POSE_CASES[case]
    args = pose_problem(dev, kind, **kw)
    params = TPG.PoseGNParams(**prm)
    kernel, plain = pose_call(kind, args, params)
    KN.reset_launch_counts()
    rk, ek = kernel()
    torch.cuda.synchronize()
    assert KN.LAUNCHES == {**dict.fromkeys(KN.LAUNCHES, 0), "pose_gn": 1}
    rr, er = plain()
    assert KN.LAUNCHES["pose_gn"] == 1  # the plain version launches nothing
    assert bool(rk.ok) == bool(rr.ok)
    torch.testing.assert_close(rk.T10, rr.T10, atol=1e-4, rtol=0)
    intr = args[-6:-2] if "stereo" in kind else args[3:7]
    px = intr[0] * 1e-4
    e = TPG._reproj_err_px(rr.T10, args[0], args[1], *intr)
    flip = rk.inliers != rr.inliers
    assert not bool(flip.any()) or float((e[flip] - params.reproj_thresh).abs().max()) <= px
    torch.testing.assert_close(rk.mean_err, rr.mean_err, rtol=1e-3, atol=0, equal_nan=True)
    if ek is not None:
        torch.testing.assert_close(ek, er, rtol=1e-3, atol=px, equal_nan=True)
    if case == "max_iters":
        assert int(rk.n_iter) == int(rr.n_iter) == params.max_iters * (2 if ek is not None else 1)
    if case == "all_invalid":
        assert not bool(rk.ok) and not bool(rk.inliers.any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stereo_robust", "mono_polish"])
def test_pose_gn_relaunch_is_bit_identical_and_never_syncs(dev, kind):
    """Two launches on the same inputs are bit-identical (the block's sums
    run in a fixed order), and a call makes no host sync."""
    args = pose_problem(dev, kind)
    kernel, _ = pose_call(kind, args, TPG.PoseGNParams())
    kernel()  # builds and loads the library before the sync check
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, b = kernel(), kernel()
    finally:
        torch.cuda.set_sync_debug_mode(before)
    flat = [t for t in (*a[0], a[1]) if t is not None], [t for t in (*b[0], b[1]) if t is not None]
    assert all(torch.equal(x, y) for x, y in zip(*flat))


def polish_pair(dev):
    """pnp_ransac's two polishes of one recovery at the mono N: the first
    40 valid points from a perturbed pose, every valid point from the
    identity (`pose_only_gn_mono_many`'s solves)."""
    X0, pl, vl, fx, fy, cx, cy, T0 = pose_problem(dev, "mono_polish", seed=31)
    winner = vl & (torch.cumsum(vl.to(torch.int64), 0) <= 40)
    T_w = TG.se3_exp(torch.tensor([0.03, -0.02, -0.2, 0.004, 0.01, -0.003], device=dev))
    return [(X0, pl, winner, fx, fy, cx, cy, T_w), (X0, pl, vl, fx, fy, cx, cy, T0)]


@pytest.mark.cuda
def test_pose_gn_pair_is_one_launch_and_each_solve_its_single_launch(dev):
    """pnp_ransac's two polishes in one launch of two blocks: each solve bit
    for bit what its own launch gives, and within the plain version's
    tolerances (test_pose_gn_matches_plain_version's)."""
    solves, params = polish_pair(dev), TPG.PoseGNParams(max_iters=30)
    KN.reset_launch_counts()
    pair = TPG.pose_only_gn_mono_many(solves, params)
    torch.cuda.synchronize()
    assert KN.LAUNCHES == {**dict.fromkeys(KN.LAUNCHES, 0), "pose_gn": 1}
    for s, got in zip(solves, pair):
        alone = TPG.pose_only_gn_mono(*s, params)
        assert all(torch.equal(a, b) for a, b in zip(got, alone))
        ref = TPG.pose_only_gn_mono_ref(*s, params)
        assert bool(got.ok) == bool(ref.ok)
        torch.testing.assert_close(got.T10, ref.T10, atol=1e-4, rtol=0)
        torch.testing.assert_close(got.mean_err, ref.mean_err, rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_pose_gn_pair_relaunch_is_bit_identical_and_never_syncs(dev):
    solves, params = polish_pair(dev), TPG.PoseGNParams(max_iters=30)
    TPG.pose_only_gn_mono_many(solves, params)
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, b = TPG.pose_only_gn_mono_many(solves, params), TPG.pose_only_gn_mono_many(solves, params)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    assert all(torch.equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb))


@pytest.mark.cuda
def test_pose_gn_launcher_takes_one_to_max_solves(dev):
    """The C launcher runs 1 to MAX_SOLVES solves, one block of 256 threads
    each, and refuses any other count; a single solve agrees with the plain
    version."""
    import ctypes

    args = pose_problem(dev, "stereo_robust")
    params = TPG.PoseGNParams()
    inputs = (args[0], args[1], args[2], args[3], args[4], args[9], args[10], *args[5:9], params, 2, 2.0)
    res, err, packed = TPG._pack(*inputs)
    lib = KN.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert lib.pose_gn_launch(ctypes.byref(packed), 1, stream) == 0
    assert lib.pose_gn_launch(ctypes.byref(packed), 0, stream) != 0
    assert lib.pose_gn_launch(ctypes.byref(packed), TPG.MAX_SOLVES + 1, stream) != 0
    ref, _ = TPG.pose_only_gn_stereo_robust_ref(*args, params)
    assert bool(res.ok) == bool(ref.ok)
    torch.testing.assert_close(res.T10, ref.T10, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_pose_gn_refuses_what_it_cannot_serve(dev):
    X0, pl, pr, vl, vr, fx, fy, cx, cy, T_rl, T0 = pose_problem(dev, "stereo_robust")
    with pytest.raises(TypeError):  # dtype
        TPG.pose_only_gn_stereo_robust(X0.double(), pl, pr, vl, vr, fx, fy, cx, cy, T_rl, T0)
    with pytest.raises(ValueError):  # shape
        TPG.pose_only_gn_stereo_robust(X0, pl[:-1].contiguous(), pr, vl, vr, fx, fy, cx, cy, T_rl, T0)
    with pytest.raises(ValueError):  # mixed devices
        TPG.pose_only_gn_mono(X0, pl, vl.cpu(), fx, fy, cx, cy, T0)
    with pytest.raises(ValueError):  # contiguity
        TPG.pose_only_gn_mono_robust(X0.T.contiguous().T, pl, vl, fx, fy, cx, cy, T0)


# ----------------------------------------------------------------------------
# ba_*: the window BA's GN loop on the card
# ----------------------------------------------------------------------------


def ba_window(dev, seed=3, K=10, M=4096, n_lm=3000, stereo=True, n_kf=None):
    """tests/test_torch_ba_gn.py's window (keyframes 0.6 m apart down a
    street at KITTI's intrinsics, n_lm live landmarks, 0.3 px noise, right
    rows where the right camera sees the point unless mono, the optimisable
    poses and every point perturbed; the slots from n_kf on not live), built
    with the port's geometry, on `dev`. Returns (BAProblem, intrinsics,
    T_rl)."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    fx, cx, cy, W, H, base = 718.856, 607.1928, 185.2157, 1241, 376, 0.5371657
    rng = np.random.default_rng(seed)
    T_cw = np.stack([TG.se3_inverse(TG.se3_exp(torch.tensor(
        [0.01 * k, 0.002 * k, 0.6 * k, 0.001 * k, 0.004 * k, 0.0005 * k], dtype=torch.float32))).numpy()
        for k in range(K)])
    Xw = np.zeros((M, 3), np.float32)
    Xw[:n_lm] = np.stack([rng.uniform(-12, 12, n_lm), rng.uniform(-3, 2, n_lm), rng.uniform(8, 45, n_lm)], -1)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -base
    pts, pts_r = np.zeros((M, K, 2), np.float32), np.zeros((M, K, 2), np.float32)
    mask, mask_r = np.zeros((M, K), bool), np.zeros((M, K), bool)

    def project(Xc):
        uv = np.stack([Xc[:, 0] / Xc[:, 2] * fx + cx, Xc[:, 1] / Xc[:, 2] * fx + cy], -1)
        ok = (Xc[:, 2] > 1.0) & (uv[:, 0] > 2) & (uv[:, 0] < W - 2) & (uv[:, 1] > 2) & (uv[:, 1] < H - 2)
        return uv + rng.normal(0, 0.3, uv.shape), ok

    for k in range(K):
        Xc = Xw[:n_lm] @ T_cw[k, :3, :3].T + T_cw[k, :3, 3]
        pts[:n_lm, k], ok = project(Xc)
        mask[:n_lm, k] = ok & (rng.uniform(size=n_lm) > 0.1)
        if stereo:
            pts_r[:n_lm, k], ok_r = project(Xc + T_rl[:3, 3])
            mask_r[:n_lm, k] = mask[:n_lm, k] & ok_r
    pts[~mask], pts_r[~mask_r] = 0.0, 0.0
    T0 = torch.as_tensor(T_cw)
    T0[2:] = TG.add_front_se3(T0[2:], torch.as_tensor(rng.normal(0, 0.01, (K - 2, 6)), dtype=torch.float32))
    X0 = Xw + np.where(np.arange(M)[:, None] < n_lm, rng.normal(0, 0.05, (M, 3)), 0.0).astype(np.float32)
    prob = BA.BAProblem(*(torch.as_tensor(a).to(dev) for a in (T0.numpy(), X0, pts, mask, pts_r, mask_r,
                                                                 np.arange(K) < (n_kf or K), np.arange(M) < n_lm)))
    return prob, (fx, fx, cx, cy), torch.as_tensor(T_rl, device=dev)


def assert_ba_close(got, ref, info_k, info_r):
    """tests/test_torch_ops.py's tolerances (T_cw 2e-4, Xw 2e-3 relative and
    absolute, mean error 1e-3 relative), killed and n_obs equal, iterations
    equal or one apart."""
    torch.testing.assert_close(got.T_cw, ref.T_cw, atol=2e-4, rtol=0)
    torch.testing.assert_close(got.Xw, ref.Xw, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(got.mean_err_px, ref.mean_err_px, rtol=1e-3, atol=0)
    torch.testing.assert_close(got.mean_err0_px, ref.mean_err0_px, rtol=1e-5, atol=0)
    assert torch.equal(got.killed, ref.killed) and int(got.n_obs) == int(ref.n_obs)
    assert abs(info_k["iters"] - info_r["iters"]) <= 1 and info_k["iters"] > 1, (info_k, info_r)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stereo", "mono"])
def test_ba_kernels_match_the_plain_version(dev, kind):
    """ba_solve_impl on CUDA tensors (the ba_* kernels) against ba_solve_ref
    on the same tensors at the main path's size: K = 10 stereo, K = 8 mono,
    M = 4096. Only the float32 sums' order differs: tests/test_torch_ops.py's
    tolerances (T_cw 2e-4, Xw 2e-3 relative and absolute, mean error 1e-3
    relative), killed and n_obs equal, iterations equal or one apart."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    prob, intr, T_rl = ba_window(dev, K=10 if kind == "stereo" else 8, stereo=kind == "stereo")
    params = BA.BAParams()
    info_k, info_r = {}, {}
    KN.reset_launch_counts()
    got = BA.ba_solve_impl(prob, *intr, T_rl, params, info=info_k)
    assert {k: KN.LAUNCHES[k] for k in ("ba_terms", "ba_solve", "ba_backsub")} == {
        "ba_terms": params.iters + 2, "ba_solve": params.iters, "ba_backsub": params.iters}
    ref = BA.ba_solve_ref(prob, *intr, T_rl, params, info=info_r)
    assert_ba_close(got, ref, info_k, info_r)


@pytest.mark.cuda
@pytest.mark.parametrize("K, n_kf, n_opt", [(8, 3, 1), (10, 6, 4), (9, 9, 7), (16, 16, 14)])
def test_ba_kernels_solve_the_optimisable_slots_only(dev, K, n_kf, n_opt):
    """ba_solve factors the 6 n_opt unknowns of the optimisable slots only:
    one warp up to 32 (n_opt 1 and 4), the block by 6 x 6 keyframe blocks
    above (7, and 14 in a window of 16 keyframes). The kernels against
    ba_solve_ref under the same tolerances."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    prob, intr, T_rl = ba_window(dev, seed=20 + K, K=K, M=4096 if K < 16 else 1024,
                                 n_lm=3000 if K < 16 else 800, n_kf=n_kf)
    params = BA.BAParams()
    assert BA.n_opt(prob.kf_valid, params) == n_opt
    info_k, info_r = {}, {}
    got = BA.ba_solve_impl(prob, *intr, T_rl, params, info=info_k)
    ref = BA.ba_solve_ref(prob, *intr, T_rl, params, info=info_r)
    assert_ba_close(got, ref, info_k, info_r)


@pytest.mark.cuda
def test_ba_kernels_anchor_and_write_back_bit_for_bit(dev):
    """In a window whose anchor pose is turned and tens of metres from the
    world origin (where another rounding of the small products shows), the
    first launch's anchored start (T_cr, Xr) and the last launch's
    write-back equal ops/ba._anchor's and _write_back's bit for bit, and the
    starting error stays within chip_smoke's 1e-5 of ba_solve_ref's."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    prob, intr, T_rl = ba_window(dev, n_kf=7)
    G = TG.se3_exp(torch.tensor([35.0, -4.0, 52.0, 0.3, -0.8, 0.2], device=dev))  # the world moved
    prob = prob._replace(T_cw=prob.T_cw @ TG.se3_inverse(G), Xw=TG.transform_points(G, prob.Xw))
    params = BA.BAParams()
    an = BA._anchor(prob, params)
    start, end = {}, {}

    def launch(name, c_fn, argv):  # the state as the first launch leaves it and as the last one finds it
        _, _, bufs = argv[0]._obj.tensors
        final = name == "ba_terms" and argv[2] == BA._ERR_FINAL
        if final:
            end.update(T=bufs["T"].view(-1, 4, 4).clone(), X=bufs["X"].view(-1, 3).clone())
        KN.launch(name, c_fn, argv)
        if not start:
            start.update(T=bufs["T"].view(-1, 4, 4).clone(), X=bufs["X"].view(-1, 3).clone())

    got = BA._ba_kernels(prob, *intr, T_rl, params, None, None, KN.build(), launch=launch,
                         stream=torch.cuda.current_stream(dev).cuda_stream)
    act = an.lm_active
    assert torch.equal(start["T"], an.T_cr) and torch.equal(start["X"][act], an.Xr[act])
    zero = torch.zeros((), device=dev)
    want = BA._write_back(prob, params, an, end["T"], end["X"], zero, zero, zero, zero)
    for key in ("T_cw", "Xw", "killed"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    ref = BA.ba_solve_ref(prob, *intr, T_rl, params)
    torch.testing.assert_close(got.mean_err0_px, ref.mean_err0_px, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_ba_kernels_fold_the_anchoring_and_the_write_back(dev):
    """The first launch anchors and the last writes back, with no host sync:
    at 0 iterations the solve is those two launches alone, against
    ba_solve_ref; at 10, the fixed poses and the inactive landmarks come back
    bit-identical to the input."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    prob, intr, T_rl = ba_window(dev, n_kf=7)
    prob = prob._replace(lm_valid=prob.lm_valid & (torch.arange(4096, device=dev) % 3 > 0))
    BA.ba_solve_impl(prob, *intr, T_rl, BA.BAParams())  # builds and loads the library before the sync check
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ends, full = (BA.ba_solve_impl(prob, *intr, T_rl, BA.BAParams(iters=n)) for n in (0, 10))
    finally:
        torch.cuda.set_sync_debug_mode(before)
    ref = BA.ba_solve_ref(prob, *intr, T_rl, BA.BAParams(iters=0))
    torch.testing.assert_close(ends.T_cw, ref.T_cw, atol=1e-6, rtol=0)
    torch.testing.assert_close(ends.Xw, ref.Xw, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(ends.mean_err_px, ref.mean_err_px, rtol=1e-5, atol=0)
    assert torch.equal(ends.killed, ref.killed) and int(ends.n_obs) == int(ref.n_obs)
    an = BA._anchor(prob, BA.BAParams())
    for res in (ends, full):
        assert torch.equal(res.T_cw[~an.opt_mask], prob.T_cw[~an.opt_mask])
        assert torch.equal(res.Xw[~an.lm_active], prob.Xw[~an.lm_active])


@pytest.mark.cuda
def test_ba_kernels_relaunch_is_bit_identical_and_never_syncs(dev):
    """A single-device solve without `info` makes no host sync and enqueues
    launches_per_solve(iters) launches; two solves on the same inputs are
    bit-identical (every cross-block sum runs in block order)."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    prob, intr, T_rl = ba_window(dev)
    params = BA.BAParams(iters=7)
    BA.ba_solve_impl(prob, *intr, T_rl, params)  # builds and loads the library before the sync check
    torch.cuda.synchronize()
    KN.reset_launch_counts()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, b = BA.ba_solve_impl(prob, *intr, T_rl, params), BA.ba_solve_impl(prob, *intr, T_rl, params)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    assert sum(KN.LAUNCHES[k] for k in ("ba_terms", "ba_solve", "ba_backsub")) == 2 * BA.launches_per_solve(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["largest_k16", "dense_dryrun"])
def test_ba_backsub_redesign_matches_plain_and_relaunches_bit_identical(dev, case):
    """ba_backsub reading the blocks ba_terms stored, with its landmarks
    over the grid and the decision in its last block: at the largest window
    (K = 16, 14 optimisable slots) and on dryrun_multichip's dense window
    (all 4096 landmarks listed, 256 tiles on the card's blocks) against
    ba_solve_ref under the solve's tolerances; two solves without a host
    sync, bit-identical."""
    from visual_odometry_ros_tpu_torch.ops import ba as BA
    from visual_odometry_ros_tpu_torch.parallel import multihost as MH

    if case == "largest_k16":
        prob, intr, T_rl = ba_window(dev, seed=36, K=16, M=1024, n_lm=800)
        params = BA.BAParams()
    else:
        p, fx, fy, cx, cy, T_rl = MH.dryrun_problem_np()
        prob = BA.BAProblem(*(torch.as_tensor(a).to(dev) for a in p))
        intr, T_rl, params = (fx, fy, cx, cy), torch.as_tensor(T_rl, device=dev), BA.BAParams(iters=3)
    info_k, info_r = {}, {}
    got = BA.ba_solve_impl(prob, *intr, T_rl, params, info=info_k)
    ref = BA.ba_solve_ref(prob, *intr, T_rl, params, info=info_r)
    assert_ba_close(got, ref, info_k, info_r)
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, b = BA.ba_solve_impl(prob, *intr, T_rl, params), BA.ba_solve_impl(prob, *intr, T_rl, params)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and all(torch.equal(x, y) for x, y in zip(a, got))


@pytest.mark.cuda
def test_ba_kernels_refuse_what_they_cannot_serve(dev):
    from visual_odometry_ros_tpu_torch.ops import ba as BA

    prob, intr, T_rl = ba_window(dev, M=256, n_lm=200)
    with pytest.raises(TypeError):  # dtype
        BA.ba_solve_impl(prob._replace(Xw=prob.Xw.double()), *intr, T_rl)
    with pytest.raises(ValueError):  # shape
        BA.ba_solve_impl(prob._replace(pts=prob.pts[:, :-1]), *intr, T_rl)
    with pytest.raises(ValueError):  # mixed devices
        BA.ba_solve_impl(prob._replace(lm_valid=prob.lm_valid.cpu()), *intr, T_rl)
    big, intr, T_rl = ba_window(dev, K=17, M=256, n_lm=100)
    with pytest.raises(ValueError):  # K > MAX_K
        BA.ba_solve_impl(big, *intr, T_rl)
