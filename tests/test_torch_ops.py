"""Parity of the PyTorch port's ops against the JAX package, on CPU.

Every input is made with numpy from a seed and handed to both frameworks;
each tolerance says why it is what it is. Both sides compute in float32, so
"float32 rounding" tolerances cover differing operation order only.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.mapping import arena as JA  # noqa: E402
from visual_odometry_ros_tpu.ops import ba as JBA  # noqa: E402
from visual_odometry_ros_tpu.ops import depth_filter as JDF  # noqa: E402
from visual_odometry_ros_tpu.ops import features as JF  # noqa: E402
from visual_odometry_ros_tpu.ops import pose_gn as JPG  # noqa: E402
from visual_odometry_ros_tpu.ops import pyramid as JP  # noqa: E402
from visual_odometry_ros_tpu.ops import stereo_disparity as JSD  # noqa: E402
from visual_odometry_ros_tpu.ops import triangulate as JTRI  # noqa: E402
from visual_odometry_ros_tpu.utils import geometry as JG  # noqa: E402
from visual_odometry_ros_tpu.utils import interp as JI  # noqa: E402
from visual_odometry_ros_tpu.utils import robust as JR  # noqa: E402
from visual_odometry_ros_tpu_torch.mapping import arena as TA  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import ba as TBA  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import depth_filter as TDF  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import features as TF  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pose_gn as TPG  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pyramid as TP  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import stereo_disparity as TSD  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import triangulate as TTRI  # noqa: E402
from visual_odometry_ros_tpu_torch.utils import geometry as TG  # noqa: E402
from visual_odometry_ros_tpu_torch.utils import interp as TI  # noqa: E402
from visual_odometry_ros_tpu_torch.utils import robust as TR  # noqa: E402

torch.set_num_threads(2)


def J(x):
    return jnp.asarray(x)


def T(x):
    return torch.as_tensor(np.asarray(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def smooth_image(H, W, seed, smooth=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(2 * smooth + 1, np.float32) / (2 * smooth + 1)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img).astype(np.float32)


# ----------------------------------------------------------------------------
# geometry
# ----------------------------------------------------------------------------

_rng = np.random.default_rng(0)
_W3 = np.concatenate([_rng.normal(0, 0.5, (6, 3)), np.zeros((1, 3)), 1e-8 * np.ones((1, 3))]).astype(np.float32)
_XI = np.concatenate([_rng.normal(0, 1.0, (8, 3)), _W3], axis=-1).astype(np.float32)


@pytest.mark.parametrize(
    "name,jfn,tfn,arg",
    [
        ("so3_exp", JG.so3_exp, TG.so3_exp, _W3),
        ("left_jac", JG._so3_left_jacobian, TG.so3_left_jacobian, _W3),
        ("left_jac_inv", JG._so3_left_jacobian_inv, TG.so3_left_jacobian_inv, _W3),
        ("se3_exp", JG.se3_exp, TG.se3_exp, _XI),
        ("skew", JG.skew, TG.skew, _W3),
    ],
)
def test_geometry_matches_jax(name, jfn, tfn, arg):
    # float32 rounding of trig/series evaluated in a different op order.
    np.testing.assert_allclose(N(tfn(T(arg))), np.asarray(jfn(J(arg))), atol=2e-6, rtol=1e-5)


def test_geometry_inverse_log_project_transform():
    Tm = np.asarray(JG.se3_exp(J(_XI)))
    np.testing.assert_allclose(N(TG.se3_inverse(T(Tm))), np.asarray(JG.se3_inverse(J(Tm))), atol=1e-6)
    # log: arccos near identity amplifies float32 rounding -> 1e-4.
    np.testing.assert_allclose(N(TG.se3_log(T(Tm))), np.asarray(JG.se3_log(J(Tm))), atol=1e-4)
    np.testing.assert_allclose(N(TG.so3_log(T(Tm[:, :3, :3]))), np.asarray(JG.so3_log(J(Tm[:, :3, :3]))), atol=1e-4)
    bent = Tm.copy()
    bent[:, :3, :3] *= 1.002  # off SO(3)
    np.testing.assert_allclose(N(TG.se3_project(T(bent))), np.asarray(JG.se3_project(J(bent))), atol=1e-6)
    X = _rng.normal(0, 5, (7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        N(TG.transform_points(T(Tm[0]), T(X))), np.asarray(JG.transform_points(J(Tm[0]), J(X))), atol=1e-5
    )
    np.testing.assert_allclose(
        N(TG.add_front_se3(T(Tm[1]), T(_XI[2]))), np.asarray(JG.add_front_se3(J(Tm[1]), J(_XI[2]))), atol=2e-6
    )


# ----------------------------------------------------------------------------
# interp / robust
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("border", [0.0, 1.0])
def test_bilinear_sample_quirks_match_jax(border):
    H, W = 30, 40
    img = smooth_image(H, W, 1)
    rng = np.random.default_rng(2)
    pts = np.concatenate(
        [
            rng.uniform(-3, [W + 2, H + 2], (200, 2)),  # includes out-of-range points
            [[W - 1, 5.5], [3.25, H - 1], [W - 1, H - 1], [0.0, 0.0], [-0.5, 4.0], [W - 0.5, 7.0]],
        ]
    ).astype(np.float32)
    vj, mj = JI.bilinear_sample(J(img), J(pts), valid_border=border)
    vt, mt = TI.bilinear_sample(T(img), T(pts), valid_border=border)
    np.testing.assert_array_equal(N(mt), np.asarray(mj))
    # Same formula and operation order: values agree to float32 rounding of [0, 255] data.
    np.testing.assert_allclose(N(vt), np.asarray(vj), atol=1e-4)
    # u = W-1 exactly: fraction 0 at the index clamped to W-2, so column W-2 is read.
    np.testing.assert_allclose(float(vt[200]), 0.5 * (img[5, W - 2] + img[6, W - 2]), atol=1e-4)
    np.testing.assert_allclose(float(vt[202]), img[H - 2, W - 2], atol=1e-4)
    if border == 0.0:  # the mask includes both ends of [0, W-1]
        assert bool(mt[200]) and bool(mt[202])


def test_zncc_and_sample_patches_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 49)).astype(np.float32)
    b = (a * 0.7 + rng.normal(size=(5, 49)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(N(TI.zncc(T(a), T(b))), np.asarray(JI.zncc(J(a), J(b))), atol=1e-6)
    img = smooth_image(20, 24, 4)
    c = np.float32([[5.3, 6.7], [10.1, 12.9]])
    off = np.float32([[0, 0], [1, -1], [-2, 2]])
    vj, mj = JI.sample_patches(J(img), J(c), J(off))
    vt, mt = TI.sample_patches(T(img), T(c), T(off))
    np.testing.assert_allclose(N(vt), np.asarray(vj), atol=1e-4)
    np.testing.assert_array_equal(N(mt), np.asarray(mj))


def test_robust_matches_jax():
    rng = np.random.default_rng(5)
    v = rng.uniform(-5, 60, 500).astype(np.float32)
    m = rng.uniform(size=500) > 0.3
    np.testing.assert_allclose(N(TR.huber_weight(T(np.abs(v)), 2.0)), np.asarray(JR.huber_weight(J(np.abs(v)), 2.0)), rtol=1e-6)
    # Histograms count exactly.
    np.testing.assert_array_equal(N(TR.masked_histogram(T(v), T(m), 0.0, 48.0, 96)),
                                  np.asarray(JR.masked_histogram(J(v), J(m), 0.0, 48.0, 96)))
    assert float(TR.masked_median_histogram(T(v), T(m), 0.0, 48.0, 96)) == float(
        JR.masked_median_histogram(J(v), J(m), 0.0, 48.0, 96))
    np.testing.assert_allclose(float(TR.masked_mean(T(v), T(m))), float(JR.masked_mean(J(v), J(m))), rtol=1e-5)


# ----------------------------------------------------------------------------
# pyramid
# ----------------------------------------------------------------------------


def test_pyramid_matches_jax():
    img = smooth_image(61, 83, 6)  # odd sizes exercise the edge replication
    pj = JP.build_pyramid_with_gradients(J(img), 3)
    pt = TP.build_pyramid_with_gradients(T(img), 3)
    for lj, lt in zip(pj, pt):
        for aj, at in zip(lj, lt):
            assert tuple(at.shape) == aj.shape
            # Band-matrix matmul (JAX) vs gathered taps (port): float32 rounding.
            np.testing.assert_allclose(N(at), np.asarray(aj), atol=2e-4)
    np.testing.assert_allclose(N(TP.box_filter(T(img), 3)), np.asarray(JP.box_filter(J(img), 3)), atol=1e-4)
    flat = TP.build_pyramid_with_gradients(T(img), 2, with_gradients=False)
    assert all(lvl[0] is lvl[1] is lvl[2] for lvl in flat)  # aliased, no Scharr pass


def test_global_shift_zncc_matches_jax():
    base = smooth_image(60, 80, 7)
    prev = base[8:52, 8:72]
    curr = base[5:49, 10:74]  # content moves by (du, dv) = (-2, +3)
    sj, scj = JP.global_shift_zncc(J(prev), J(curr), radius=4)
    st, sct = TP.global_shift_zncc(T(prev), T(curr), radius=4)
    np.testing.assert_array_equal(N(st), np.asarray(sj))
    np.testing.assert_allclose(float(sct), float(scj), atol=1e-5)


# ----------------------------------------------------------------------------
# triangulation / depth filter / pose
# ----------------------------------------------------------------------------


def test_triangulate_and_update_gaussian_match_jax():
    rng = np.random.default_rng(8)
    X = np.stack([rng.uniform(-3, 3, 64), rng.uniform(-2, 2, 64), rng.uniform(3, 30, 64)], -1).astype(np.float32)
    T10 = np.asarray(JG.se3_exp(J(np.float32([-0.5, 0.02, 0.1, 0.01, -0.02, 0.005]))))
    X1 = X @ T10[:3, :3].T + T10[:3, 3]
    xn0 = (X[:, :2] / X[:, 2:]).astype(np.float32) + rng.normal(0, 1e-3, (64, 2)).astype(np.float32)
    xn1 = (X1[:, :2] / X1[:, 2:]).astype(np.float32)
    aj, bj = JTRI.triangulate(J(xn0), J(xn1), J(T10))
    at, bt = TTRI.triangulate(T(xn0), T(xn1), T(T10))
    # Adjugate solve of a conditioning-sensitive normal system: relative 1e-4.
    np.testing.assert_allclose(N(at), np.asarray(aj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(bt), np.asarray(bj), rtol=1e-4, atol=1e-4)
    mu, s2, x, t2 = (rng.uniform(0.01, 2, 32).astype(np.float32) for _ in range(4))
    for a, b in zip(TDF.update_gaussian(T(mu), T(s2), T(x), T(t2)), JDF.update_gaussian(J(mu), J(s2), J(x), J(t2))):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-6)


def _pose_problem(seed=9, n=300, n_out=40):
    rng = np.random.default_rng(seed)
    X0 = np.stack([rng.uniform(-6, 6, n), rng.uniform(-3, 3, n), rng.uniform(4, 40, n)], -1).astype(np.float32)
    T10 = np.asarray(JG.se3_exp(J(np.float32([0.03, -0.01, -0.4, 0.004, 0.01, -0.002]))))
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.5
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    Xl = X0 @ T10[:3, :3].T + T10[:3, 3]
    Xr = Xl + T_rl[:3, 3]
    pl = np.stack([Xl[:, 0] / Xl[:, 2] * fx + cx, Xl[:, 1] / Xl[:, 2] * fy + cy], -1)
    pr = np.stack([Xr[:, 0] / Xr[:, 2] * fx + cx, Xr[:, 1] / Xr[:, 2] * fy + cy], -1)
    pl = (pl + rng.normal(0, 0.3, pl.shape)).astype(np.float32)
    pr = (pr + rng.normal(0, 0.3, pr.shape)).astype(np.float32)
    pl[:n_out] += rng.uniform(-30, 30, (n_out, 2)).astype(np.float32)  # outliers
    vl = rng.uniform(size=n) > 0.05
    vr = vl & (rng.uniform(size=n) > 0.2)
    return X0, pl, pr, vl, vr, fx, fy, cx, cy, T_rl


def test_pose_only_gn_stereo_robust_matches_jax():
    X0, pl, pr, vl, vr, fx, fy, cx, cy, T_rl = _pose_problem()
    params = dict(max_iters=50, huber_delta=0.5, reproj_thresh=3.0)
    rj, ej = JPG.pose_only_gn_stereo_robust(
        J(X0), J(pl), J(pr), J(vl), J(vr), fx, fy, cx, cy, J(T_rl), jnp.eye(4), JPG.PoseGNParams(**params)
    )
    rt, et = TPG.pose_only_gn_stereo_robust(
        T(X0), T(pl), T(pr), T(vl), T(vr), fx, fy, cx, cy, T(T_rl), torch.eye(4), TPG.PoseGNParams(**params)
    )
    assert bool(rt.ok) == bool(rj.ok) is True
    # Same GN iterates; the 6x6 normal sums accumulate in another order.
    np.testing.assert_allclose(N(rt.T10), np.asarray(rj.T10), atol=5e-5)
    np.testing.assert_array_equal(N(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(float(rt.mean_err), float(rj.mean_err), rtol=1e-3)
    np.testing.assert_allclose(N(et), np.asarray(ej), rtol=1e-3, atol=1e-3)


# ----------------------------------------------------------------------------
# features
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corner_image():
    img = smooth_image(96, 128, 10, smooth=1)
    rng = np.random.default_rng(11)
    for _ in range(40):  # bright/dark blobs make FAST corners
        y, x = rng.integers(10, 86), rng.integers(10, 118)
        img[y - 2 : y + 3, x - 2 : x + 3] += rng.choice([-80.0, 80.0])
    return np.clip(img, 0, 255).astype(np.float32)


def test_fast_harris_occupancy_match_jax(corner_image):
    img = corner_image
    np.testing.assert_array_equal(N(TF.fast_corner_mask(T(img), 15.0)), np.asarray(JF.fast_corner_mask(J(img), 15.0)))
    hj = np.asarray(JF.harris_response(J(img)))
    # Harris is a difference of large products: float32 rounding relative to the scale.
    np.testing.assert_allclose(N(TF.harris_response(T(img))), hj, atol=1e-5 * np.abs(hj).max())
    rng = np.random.default_rng(12)
    pts = rng.uniform(0, [128, 96], (50, 2)).astype(np.float32)
    val = rng.uniform(size=50) > 0.4
    np.testing.assert_array_equal(
        N(TF.occupancy_grid(T(pts), T(val), 96, 128, 6, 8)), np.asarray(JF.occupancy_grid(J(pts), J(val), 96, 128, 6, 8))
    )


def test_detect_features_selects_same_set(corner_image):
    img = corner_image
    rng = np.random.default_rng(13)
    prev = rng.uniform(0, [128, 96], (20, 2)).astype(np.float32)
    pv = rng.uniform(size=20) > 0.5
    kw = dict(gh=6, gw=8, n_max=64, fast_thresh=15.0, score_min=10.0)
    pj, vj = JF.detect_features(J(img), J(prev), J(pv), **kw)
    pt, vt = TF.detect_features(T(img), T(prev), T(pv), **kw)
    pj, vj = np.asarray(pj), np.asarray(vj)
    pt, vt = N(pt), N(vt)
    assert vt.sum() == vj.sum() > 5
    # top_k vs stable sort may order exact ties differently: compare as sets.
    assert set(map(tuple, pt[vt].tolist())) == set(map(tuple, pj[vj].tolist()))


def test_orb_descriptors_match_jax(corner_image):
    img = corner_image
    rng = np.random.default_rng(14)
    pts = rng.uniform(0, [128, 96], (40, 2)).astype(np.float32)
    dj, vj = JF.orb_descriptors(J(img), J(pts))
    dt, vt = TF.orb_descriptors(T(img), T(pts))
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    np.testing.assert_array_equal(N(dt).astype(np.uint32), np.asarray(dj))
    np.testing.assert_array_equal(N(TF.desc_to_u8(dt)), np.asarray(JF.desc_to_u8(dj)))
    oj = np.asarray(JF.orb_orientation(J(img), J(pts)))
    np.testing.assert_allclose(N(TF.orb_orientation(T(img), T(pts))), oj, atol=1e-4)


# ----------------------------------------------------------------------------
# stereo disparity
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stereo_pair():
    base = smooth_image(64, 140, 15, smooth=2)
    left = base[:, 20:120]
    right = base[:, 26:126]  # uniform 6 px disparity
    return left.copy(), right.copy()


def test_zncc_disparity_matches_jax(stereo_pair):
    left, right = stereo_pair
    kw = dict(max_disp=16, radius=3, min_zncc=0.5, peak_margin=0.03, fxb=100.0)
    rj = JSD.zncc_disparity(J(left), J(right), **kw)
    rt = TSD.zncc_disparity(T(left), T(right), **kw)
    vj = np.asarray(rj.valid)
    vt = N(rt.valid)
    # Argmax/threshold decisions can flip on float32 near-ties only.
    assert (vj == vt).mean() > 0.995
    both = vj & vt
    assert both.sum() > 1000
    np.testing.assert_allclose(N(rt.disparity)[both], np.asarray(rj.disparity)[both], atol=1e-3)
    assert (N(rt.ambiguous) == np.asarray(rj.ambiguous)).mean() > 0.995


def test_verify_disparity_zncc_matches_jax(stereo_pair):
    left, right = stereo_pair
    rng = np.random.default_rng(16)
    pts = rng.uniform([5, 5], [95, 59], (80, 2)).astype(np.float32)
    disp = (6.0 + rng.normal(0, 0.5, 80) + (rng.uniform(size=80) < 0.2) * 9.0).astype(np.float32)
    valid = rng.uniform(size=80) > 0.1
    kw = dict(radius=4, span=12)
    oj, sj = JSD.verify_disparity_zncc(J(left), J(right), J(pts), J(disp), J(valid), **kw)
    ot, st = TSD.verify_disparity_zncc(T(left), T(right), T(pts), T(disp), T(valid), **kw)
    np.testing.assert_array_equal(N(ot), np.asarray(oj))
    np.testing.assert_allclose(N(st), np.asarray(sj), atol=1e-5)
    assert N(ot).sum() > 10


# ----------------------------------------------------------------------------
# arena: indexed writes against the one-hot contractions
# ----------------------------------------------------------------------------


def _scatter_case(seed=17, M=64, n=40):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=n) > 0.4
    idx = np.zeros(n, np.int32)  # dead lanes carry lm_idx 0 (and duplicates)
    idx[mask] = rng.permutation(M)[: mask.sum()]
    idx[~mask][::2] = -1
    return rng, idx, mask, M, n


@pytest.mark.parametrize("op,dest_kind", [("set", "f1"), ("set", "f2"), ("set", "i1"), ("set", "b1"),
                                          ("or", "b1"), ("add", "i1")])
def test_indexed_update_matches_onehot(op, dest_kind):
    rng, idx, mask, M, n = _scatter_case()
    if dest_kind == "f1":
        dest, vals = rng.normal(size=M).astype(np.float32), rng.normal(size=n).astype(np.float32)
    elif dest_kind == "f2":
        dest, vals = rng.normal(size=(M, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)
    elif dest_kind == "i1":
        dest, vals = rng.integers(0, 50, M).astype(np.int32), rng.integers(0, 50, n).astype(np.int32)
    else:
        dest, vals = rng.uniform(size=M) > 0.5, rng.uniform(size=n) > 0.5
    if op == "or":
        vals = None
    ref = JA.onehot_update(J(dest), J(idx), J(mask), None if vals is None else J(vals), op=op)
    out = TA.indexed_update(T(dest), T(idx), T(mask), None if vals is None else T(vals), op=op)
    np.testing.assert_array_equal(N(out), np.asarray(ref))


def test_arena_slots_ring_and_ba_gather_match_jax():
    rng = np.random.default_rng(18)
    M, N_, K = 48, 16, 4
    free = rng.uniform(size=M) > 0.5
    for n_req in (8, 40):
        sj, oj = JA.allocate_slots(J(free), n_req)
        st, ot = TA.allocate_slots(T(free), n_req)
        np.testing.assert_array_equal(N(st), np.asarray(sj))
        np.testing.assert_array_equal(N(ot), np.asarray(oj))
    ring_j, ring_t = JA.make_ring(K, N_), TA.make_ring(K, N_)
    for k in range(6):  # wraps the ring
        lm = rng.permutation(M)[:N_].astype(np.int32)
        ov = rng.uniform(size=N_) > 0.3
        ovr = ov & (rng.uniform(size=N_) > 0.3)
        lm[~ov] = 0  # dead lanes share slot 0
        Tcw = np.asarray(JG.se3_exp(J(rng.normal(0, 0.1, 6).astype(np.float32))))
        pts = rng.uniform(0, 100, (N_, 2)).astype(np.float32)
        ptr = pts - 5.0
        ring_j = JA.ring_push(ring_j, J(Tcw), k, J(pts), J(ptr), J(lm), J(ov), J(ovr))
        ring_t = TA.ring_push(ring_t, T(Tcw), k, T(pts), T(ptr), T(lm), T(ov), T(ovr))
    np.testing.assert_array_equal(N(TA.ring_order(ring_t)), np.asarray(JA.ring_order(ring_j)))
    arena_j = JA.make_arena(M)._replace(alive=J(free), triangulated=J(free | (rng.uniform(size=M) > 0.5)))
    arena_t = TA.make_arena(M).replace(alive=T(free), triangulated=T(np.asarray(arena_j.triangulated)))
    gj = JA.gather_ba_problem(ring_j, arena_j)
    gt = TA.gather_ba_problem(ring_t, arena_t)
    for key in gj:
        np.testing.assert_array_equal(N(gt[key]), np.asarray(gj[key]), err_msg=key)
    # parallax bookkeeping + stat means
    arena_j = arena_j._replace(age=J(rng.integers(1, 9, M).astype(np.int32)), tracked=J(free))
    arena_t = arena_t.replace(age=T(np.asarray(arena_j.age)), tracked=T(free))
    lm = rng.permutation(M)[:N_].astype(np.int32)
    msk = rng.uniform(size=N_) > 0.3
    par = rng.uniform(0, 0.05, N_).astype(np.float32)
    aj = JA.parallax_observe(arena_j, J(lm), J(msk), J(par))
    at = TA.parallax_observe(arena_t, T(lm), T(msk), T(par))
    for f in ("parallax_last", "parallax_max", "parallax_min", "parallax_sum", "parallax_n"):
        np.testing.assert_array_equal(N(getattr(at, f)), np.asarray(getattr(aj, f)), err_msg=f)
    for a, b in zip(TA.landmark_stat_means(at), JA.landmark_stat_means(aj)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# ----------------------------------------------------------------------------
# bundle adjustment (window shaped like __graft_entry__.dryrun_multichip)
# ----------------------------------------------------------------------------


def test_ba_solve_matches_jax():
    rng = np.random.default_rng(0)
    K, M = 5, 256
    FX = FY = 300.0
    CX, CY = 80.0, 60.0
    T_cw = np.stack([
        np.asarray(JG.se3_inverse(JG.se3_exp(J(np.float32([0.01 * k, 0.0, -0.3 * k, 0.0, 0.01 * k, 0.0])))))
        for k in range(K)
    ])
    Xw = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(5, 20, M)], -1).astype(np.float32)
    pts = np.zeros((M, K, 2), np.float32)
    mask = np.zeros((M, K), bool)
    for k in range(K):
        Xc = Xw @ T_cw[k, :3, :3].T + T_cw[k, :3, 3]
        uv = np.stack([Xc[:, 0] / Xc[:, 2] * FX + CX, Xc[:, 1] / Xc[:, 2] * FY + CY], -1)
        pts[:, k] = uv + rng.normal(0, 0.2, (M, 2))
        mask[:, k] = (Xc[:, 2] > 1.0) & (rng.uniform(size=M) > 0.1)
    T_noisy = T_cw.copy()
    T_noisy[2:, :3, 3] += rng.normal(0, 0.02, (K - 2, 3)).astype(np.float32)
    Xw_noisy = (Xw + rng.normal(0, 0.05, Xw.shape)).astype(np.float32)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.5
    pts_r = (pts + np.float32([-0.5 * FX / 10.0, 0.0])).astype(np.float32)
    mask_r = mask & (rng.uniform(size=(M, K)) > 0.5)
    lm_valid = rng.uniform(size=M) > 0.05
    args = (T_noisy, Xw_noisy, pts, mask, pts_r, mask_r, np.ones(K, bool), lm_valid)
    params = dict(iters=5)
    rj = JBA.ba_solve(JBA.BAProblem(*map(J, args)), FX, FY, CX, CY, J(T_rl), JBA.BAParams(**params))
    rt = TBA.ba_solve_impl(TBA.BAProblem(*map(T, args)), FX, FY, CX, CY, T(T_rl), TBA.BAParams(**params))
    # Same GN iterates through a float32 Cholesky; the normal sums accumulate in
    # another order, which the Schur complement amplifies mildly.
    np.testing.assert_allclose(N(rt.T_cw), np.asarray(rj.T_cw), atol=2e-4)
    # Points seen from two keyframes are weakly constrained along their ray:
    # that rounding shows as up to ~0.1% of their 5-20 m depth.
    np.testing.assert_allclose(N(rt.Xw), np.asarray(rj.Xw), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(rt.mean_err_px), float(rj.mean_err_px), rtol=1e-3)
    np.testing.assert_allclose(float(rt.mean_err0_px), float(rj.mean_err0_px), rtol=1e-5)
    np.testing.assert_array_equal(N(rt.killed), np.asarray(rj.killed))
    assert int(rt.n_obs) == int(rj.n_obs)
    for e, e0 in ((0.5, 1.0), (30.0, 40.0), (1.0, 0.99), (np.nan, 1.0)):
        assert bool(TBA.ba_accept(torch.tensor(e), torch.tensor(e0), 3.0)) == bool(
            JBA.ba_accept(jnp.float32(e), jnp.float32(e0), 3.0))


# ----------------------------------------------------------------------------
# shared io
# ----------------------------------------------------------------------------


def test_forward_trajectory_matches_jax():
    from visual_odometry_ros_tpu.io.synthetic import forward_trajectory as jft
    from visual_odometry_ros_tpu_torch.io import forward_trajectory as tft

    for kw in (dict(), dict(step=0.22, yaw_rate=0.0015), dict(step=0.8, yaw_rate=0.0015, lateral=0.01)):
        # The same float32 se3_exp in another op order: a few ulps of metres-size entries.
        np.testing.assert_allclose(tft(12, **kw), jft(12, **kw), atol=1e-5)


# ----------------------------------------------------------------------------
# Small library functions: blur, Shi-Tomasi, depth from disparity, pixel
# triangulation, parallax, stacked sampling, the camera's distortion flag
# ----------------------------------------------------------------------------


def _small_fn_case(name):
    """(port result, JAX result, atol) of one small function on seeded inputs."""
    from visual_odometry_ros_tpu import camera as JCAM
    from visual_odometry_ros_tpu_torch import camera as TCAM

    rng = np.random.default_rng(11)
    img = smooth_image(37, 53, 12)
    if name == "gaussian_blur5":  # same taps and order on edge-replicated views
        return N(TP.gaussian_blur5(T(img))), np.asarray(JP.gaussian_blur5(J(img))), 1e-4
    if name == "shi_tomasi_response":  # squared gradients of [0, 255] data: relative 1e-6
        t, j = N(TF.shi_tomasi_response(T(img), 2)), np.asarray(JF.shi_tomasi_response(J(img), 2))
        return t, j, 1e-6 * float(np.abs(j).max())
    if name == "disparity_to_depth":
        disp = np.float32(rng.uniform(-1, 40, (9, 11)))
        valid = disp > 0.5
        jr = JSD.DisparityResult(J(disp), J(valid), J(disp), J(disp), J(valid))
        tr = TSD.DisparityResult(T(disp), T(valid), T(disp), T(disp), T(valid))
        return N(TSD.disparity_to_depth(tr, 386.0)), np.asarray(JSD.disparity_to_depth(jr, 386.0)), 1e-4
    if name == "stereo_depth_from_disparity":
        disp = np.float32(np.concatenate([rng.uniform(0.01, 60, 40), [0.0, 1e-3, -2.0, 5e-4]]))
        zt, vt = TTRI.stereo_depth_from_disparity(718.856, 0.537, T(disp))
        zj, vj = JTRI.stereo_depth_from_disparity(718.856, 0.537, J(disp))
        np.testing.assert_array_equal(N(vt), np.asarray(vj))
        return N(zt), np.asarray(zj), 1e-3  # depths up to 4e4 m: float32 ulps
    if name == "parallax_angle":
        r0, r1 = (np.float32(rng.normal(0, 1, (30, 3)) + [0, 0, 3]) for _ in range(2))
        R = np.asarray(JG.so3_exp(J(np.float32([0.02, -0.05, 0.01]))))
        t = np.stack([N(TTRI.parallax_angle(T(r0), T(r1))), N(TTRI.parallax_angle(T(r0), T(r1), T(R)))])
        j = np.stack([np.asarray(JTRI.parallax_angle(J(r0), J(r1))), np.asarray(JTRI.parallax_angle(J(r0), J(r1), J(R)))])
        return t, j, 1e-5  # arccos near 1 amplifies float32 rounding
    if name == "triangulate_pixels":
        X = np.stack([rng.uniform(-3, 3, 32), rng.uniform(-2, 2, 32), rng.uniform(4, 25, 32)], -1).astype(np.float32)
        T10 = np.asarray(JG.se3_exp(J(np.float32([-0.5, 0.02, 0.1, 0.01, -0.02, 0.005]))))
        X1 = X @ T10[:3, :3].T + T10[:3, 3]
        p0 = X[:, :2] / X[:, 2:] * 500.0 + [320.0, 240.0]
        p1 = X1[:, :2] / X1[:, 2:] * 480.0 + [300.0, 250.0]
        cams = [(JCAM.make_camera(500.0, 500.0, 320.0, 240.0), TCAM.make_camera(500.0, 500.0, 320.0, 240.0)),
                (JCAM.make_camera(480.0, 480.0, 300.0, 250.0), TCAM.make_camera(480.0, 480.0, 300.0, 250.0))]
        t = TTRI.triangulate_pixels(T(np.float32(p0)), T(np.float32(p1)), cams[0][1], cams[1][1], T(T10))
        j = JTRI.triangulate_pixels(J(np.float32(p0)), J(np.float32(p1)), cams[0][0], cams[1][0], J(T10))
        np.testing.assert_allclose(N(t[0]), X, atol=1e-2)  # noise-free views recover the points
        return np.stack([N(a) for a in t]), np.stack([np.asarray(a) for a in j]), 1e-3  # DLT of 25 m depths
    if name == "bilinear_sample_stack":
        imgs = np.stack([smooth_image(20, 24, s) for s in (13, 14, 15)])
        pts = np.float32(rng.uniform(-2, 25, (6, 7, 2)))
        vt, mt = TI.bilinear_sample_stack(T(imgs), T(pts), 1.0)
        vj, mj = JI.bilinear_sample_stack(J(imgs), J(pts), 1.0)
        np.testing.assert_array_equal(N(mt), np.asarray(mj))
        assert vt.shape == (3, 6, 7)
        return N(vt), np.asarray(vj), 1e-4
    if name == "has_distortion":
        t = TCAM.make_camera(500.0, 500.0, 320.0, 240.0).has_distortion
        j = JCAM.make_camera(500.0, 500.0, 320.0, 240.0).has_distortion
        return np.asarray(t), np.asarray(j), 0.0
    raise KeyError(name)


@pytest.mark.parametrize("name", ["gaussian_blur5", "shi_tomasi_response", "disparity_to_depth",
                                  "stereo_depth_from_disparity", "parallax_angle", "triangulate_pixels",
                                  "bilinear_sample_stack", "has_distortion"])
def test_small_functions_match_jax(name):
    t, j, atol = _small_fn_case(name)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=atol, rtol=0)
