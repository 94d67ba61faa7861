"""PnP, mono pose GN and descriptor matching in the port against the JAX
package, on CPU.

Inputs are made with numpy from a seed and handed to both packages. RANSAC
draws cannot match `jax.random`, so the PnP tests hand the port the
reference's draws (`idx`), recomputed from the same key as in `pnp.py`.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.ops import features as JF  # noqa: E402
from visual_odometry_ros_tpu.ops import pnp as JPNP  # noqa: E402
from visual_odometry_ros_tpu.ops import pose_gn as JPG  # noqa: E402
from visual_odometry_ros_tpu.utils import geometry as JG  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import features as TF  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pnp as TPNP  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import pose_gn as TPG  # noqa: E402

torch.set_num_threads(2)
FX = FY = 700.0
CX, CY = 320.0, 240.0
XI = np.array([0.4, -0.15, 0.2, 0.03, 0.08, -0.02], np.float32)


def T(x):
    return torch.as_tensor(np.array(x))


def scene(seed, n=256, outlier_frac=0.0, noise=0.3, planar=False):
    """tests/test_pnp.py:_problem, optionally with every point on the plane
    z = 12 + 0.3 x."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-6, 6, n)
    Y = rng.uniform(-4, 4, n)
    Z = 12.0 + 0.3 * X if planar else rng.uniform(4, 30, n)
    Xw = np.stack([X, Y, Z], -1).astype(np.float32)
    T_cw = np.asarray(JG.se3_exp(jnp.asarray(XI)))
    Xc = Xw @ T_cw[:3, :3].T + T_cw[:3, 3]
    pts = np.stack([Xc[:, 0] / Xc[:, 2] * FX + CX, Xc[:, 1] / Xc[:, 2] * FY + CY], -1).astype(np.float32)
    pts += rng.normal(0, noise, pts.shape).astype(np.float32)
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    pts[out] += rng.uniform(25, 90, (len(out), 2)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return Xw, pts, valid, T_cw


def jax_idx(key, valid, K):
    """The minimal sets `pnp.pnp_ransac` draws for `key` (pnp.py:115-120)."""
    p = jnp.asarray(valid).astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, K)
    idx = jax.vmap(lambda k: jax.random.choice(k, len(valid), shape=(6,), replace=False, p=p))(keys)
    return torch.as_tensor(np.asarray(idx))


def test_pose_only_gn_mono_matches_jax():
    Xw, pts, valid, T_cw = scene(1, outlier_frac=0.2)
    T0 = np.asarray(JG.se3_exp(jnp.asarray(XI + np.array([0.05, -0.03, 0.08, 0.01, -0.005, 0.004], np.float32))))
    params = JPG.PoseGNParams(max_iters=30)
    rj = JPG.pose_only_gn_mono(jnp.asarray(Xw), jnp.asarray(pts), jnp.asarray(valid), FX, FY, CX, CY,
                               jnp.asarray(T0), params)
    rt = TPG.pose_only_gn_mono(T(Xw), T(pts), T(valid), FX, FY, CX, CY, T(T0), TPG.PoseGNParams(max_iters=30))
    # Same residuals and normal equations, sums in another order: 1e-5.
    np.testing.assert_allclose(rt.T10.numpy(), np.asarray(rj.T10), atol=1e-5)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert bool(rt.ok) == bool(rj.ok) and int(rt.n_iter) == int(rj.n_iter)
    np.testing.assert_allclose(float(rt.mean_err), float(rj.mean_err), rtol=1e-4)


def near_scene(seed, n):
    """Points 1.5-4 m in front of the camera within +-1.5 m, 0.3 px noise:
    a well-conditioned DLT (both packages within 1e-4 of float64)."""
    rng = np.random.default_rng(seed)
    T_cw = np.asarray(JG.se3_exp(jnp.asarray(XI)))
    Xc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n), rng.uniform(1.5, 4.0, n)], -1)
    Xw = ((Xc - T_cw[:3, 3]) @ T_cw[:3, :3]).astype(np.float32)
    xn = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 0.3 / FX, (n, 2))
    return Xw, np.stack([xn[:, 0] * FX + CX, xn[:, 1] * FY + CY], -1).astype(np.float32), None, T_cw


@pytest.mark.parametrize("case", ["near_24_points", "far_12_points"])
def test_dlt_pnp_matches_jax_on_non_degenerate_sets(case):
    """32 batched sets of well-spread non-coplanar points, 0.3 px noise.

    near_24_points: T to 1e-4. far_12_points (the corridor's depth range,
    4-30 m): 1e-2, because there the DLT's 12x12 normal matrix has
    lambda_2 / lambda_max < 1e-4, so a float32 eigensolver's null vector,
    and with it T, carries errors of a few 1e-3 in either package (both
    measured against a float64 run of the same algorithm).

    The sign of the null vector is the eigensolver's choice in the
    reference, and with the wrong one an undetected 180-degree-turned
    solution comes out; the port fixes the sign, so it is compared where
    the reference's sign was right, and held to float64 everywhere."""
    if case == "near_24_points":
        (Xw, pts, _, T_cw), k, atol, t_atol = near_scene(2, 32 * 24), 24, 1e-4, 0.01
    else:
        (Xw, pts, _, T_cw), k, atol, t_atol = scene(2, n=384), 12, 1e-2, 0.2
    xn = np.stack([(pts[:, 0] - CX) / FX, (pts[:, 1] - CY) / FY], -1).astype(np.float32)
    idx = np.arange(32 * k).reshape(32, k)
    Tj = np.asarray(JPNP._dlt_pnp(jnp.asarray(Xw[idx]), jnp.asarray(xn[idx])))
    Tt = TPNP._dlt_pnp(T(Xw[idx]), T(xn[idx])).numpy()
    T64 = TPNP._dlt_pnp(T(Xw[idx]).double(), T(xn[idx]).double()).numpy()
    np.testing.assert_allclose(Tt, T64, atol=atol)
    right_sign = np.abs(Tj - T64).reshape(32, -1).max(1) < 0.1
    assert right_sign.sum() >= 16
    np.testing.assert_allclose(Tt[right_sign], Tj[right_sign], atol=atol)
    np.testing.assert_allclose(Tt[:, :3, 3], np.broadcast_to(T_cw[:3, 3], (32, 3)), atol=t_atol)


@pytest.mark.parametrize("case", ["random_outliers", "coplanar_with_prior"])
def test_pnp_ransac_with_injected_draws_matches_jax(case):
    """The reference's 64 draws injected: the same inlier mask, ok and
    count, and T_cw to 1e-4 on the random scene (0.05 px noise, 30%
    outliers). There every clean hypothesis is accurate enough that the
    polish set (its 2x-threshold inliers) is the same whichever one wins.

    Coplanar scene: every DLT hypothesis is degenerate, so which null vector
    `eigh` returns is arbitrary in both packages; a degenerate hypothesis
    still wins (it ties the prior's count), and its polish stops within the
    GN tolerance of the optimum from wherever it started: T_cw to 5e-3, the
    counts and masks exactly."""
    if case == "random_outliers":
        Xw, pts, valid, T_cw = scene(3, outlier_frac=0.3, noise=0.05)
        T_init, atol = None, 1e-4
    else:
        Xw, pts, valid, T_cw = scene(4, planar=True, noise=0.05)
        T_init = np.asarray(JG.se3_exp(jnp.asarray(XI + np.array([0.3, 0.2, -0.4, 0.02, -0.02, 0.01], np.float32))))
        atol = 5e-3
    key = jax.random.key(11)
    rj = JPNP.pnp_ransac(jnp.asarray(Xw), jnp.asarray(pts), jnp.asarray(valid), key, FX, FY, CX, CY,
                         T_init=None if T_init is None else jnp.asarray(T_init))
    rt = TPNP.pnp_ransac(T(Xw), T(pts), T(valid), FX, FY, CX, CY,
                         T_init=None if T_init is None else T(T_init), idx=jax_idx(key, valid, 64))
    assert bool(rj.ok) and bool(rt.ok)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), atol=atol)
    np.testing.assert_allclose(rt.T_cw.numpy()[:3, 3], T_cw[:3, 3], atol=0.02)


def test_dlt_pnp_never_returns_the_turned_solution():
    """Exact projections: the null vector's sign is the eigensolver's
    choice, and with the wrong one the nearest rotation is the solution
    turned 180 degrees about an axis; near the optical axis the centroid
    test misses it (the reference returns t flipped on some of these sets).
    The port fixes the sign, so every set whose float64 solve is right
    comes out right in float32 too."""
    rng = np.random.default_rng(0)
    K = 64
    t = np.array([0.5, -0.25, 1.0], np.float32)
    Xc = np.stack([rng.integers(-6, 7, (K, 6)) * 0.5, rng.integers(-4, 5, (K, 6)) * 0.5,
                   rng.choice([2.0, 4.0, 8.0], (K, 6))], -1).astype(np.float32)
    Xw, xn = Xc - t, (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = t
    ok64 = np.abs(TPNP._dlt_pnp(T(Xw).double(), T(xn).double()).numpy() - T_true).reshape(K, -1).max(1) < 1e-6
    assert ok64.sum() >= 48  # the rest are degenerate draws (coplanar grid points)
    err = np.abs(TPNP._dlt_pnp(T(Xw), T(xn)).numpy() - T_true).reshape(K, -1).max(1)
    assert err[ok64].max() < 5e-2  # float32 error; a turned solution is off by >= 2


def test_pnp_ransac_own_draws_and_garbage():
    """The port's own sampler: a clean solve with outliers, and ok = False
    on uncorrelated observations (tests/test_pnp.py bounds)."""
    Xw, pts, valid, T_cw = scene(5, outlier_frac=0.3)
    gen = torch.Generator().manual_seed(0)
    rt = TPNP.pnp_ransac(T(Xw), T(pts), T(valid), FX, FY, CX, CY, generator=gen)
    dT = np.linalg.inv(rt.T_cw.numpy()) @ T_cw
    assert bool(rt.ok) and np.linalg.norm(dT[:3, 3]) < 1e-2
    rng = np.random.default_rng(6)
    Xg = rng.uniform(-5, 5, (128, 3)).astype(np.float32) + np.array([0, 0, 10], np.float32)
    pg = rng.uniform(0, 640, (128, 2)).astype(np.float32)
    rg = TPNP.pnp_ransac(T(Xg), T(pg), torch.ones(128, dtype=torch.bool), FX, FY, CX, CY, generator=gen)
    assert not bool(rg.ok)


def descriptor_sets(seed):
    """Descriptor bytes with deliberate ties: duplicated rows in both sets
    (equal distances to two candidates), near copies (a few flipped bits)
    that pass the ratio test, and unrelated rows."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, (300, 32)).astype(np.int32)
    db[40] = db[41]  # a tie in b
    da = db[rng.choice(300, 90, replace=False)].copy()
    flip = rng.integers(0, 256, da.shape) & rng.integers(0, 256, da.shape) & rng.integers(0, 256, da.shape)
    da ^= np.where(rng.random(da.shape) < 0.15, flip, 0).astype(np.int32)
    da[10] = da[11]  # a tie in a
    da[20] = db[40]  # equally near two rows of b
    da[30] = db[7]
    da[31] = db[7]  # two rows of a equally near one row of b
    va = rng.random(90) > 0.1
    vb = rng.random(300) > 0.1
    va[[10, 11, 20, 30, 31]] = True
    vb[[7, 40, 41]] = True
    return da, va, db, vb


@pytest.mark.parametrize("max_dist", [60, 256])
def test_hamming_and_matching_equal_jax_with_ties(max_dist):
    da, va, db, vb = descriptor_sets(7)
    dj = np.asarray(JF.hamming_distance_matrix(jnp.asarray(da), jnp.asarray(db)))
    dt = TF.hamming_distance_matrix(T(da), T(db)).numpy()
    np.testing.assert_array_equal(dt, dj)
    mj, okj = JF.match_descriptors(jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb),
                                   max_dist=max_dist)
    mt, okt = TF.match_descriptors(T(da), T(va), T(db), T(vb), max_dist=max_dist)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert okt.sum() > 20  # the near copies match
    assert bool(okt[30]) and not bool(okt[31])  # the tie in a goes to the first row


def test_hamming_of_packed_words_equals_bytes():
    """The reference's popcount over packed uint32 words against the port's
    over the same descriptors' bytes, exactly."""
    rng = np.random.default_rng(8)
    wa = rng.integers(0, 2**32, (40, 8), dtype=np.uint64).astype(np.uint32)
    wb = rng.integers(0, 2**32, (1500, 8), dtype=np.uint64).astype(np.uint32)
    dj = np.asarray(JF.hamming_distance_matrix(jnp.asarray(wa), jnp.asarray(wb)))
    dt = TF.hamming_distance_matrix(TF.desc_to_u8(T(wa.astype(np.int64))), TF.desc_to_u8(T(wb.astype(np.int64))))
    np.testing.assert_array_equal(dt.numpy(), dj)
