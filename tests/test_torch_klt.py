"""KLT parity: the port's plain leg against the JAX jnp leg, and the kernel
semantics (`track_level_ref` / `track_scale_ref`) against the Pallas kernels
in interpret mode, on CPU. The kernels themselves are checked against
these plain versions on the card by tests/test_torch_cuda.py.
"""

from functools import partial

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from visual_odometry_ros_tpu.ops import klt as JK  # noqa: E402
from visual_odometry_ros_tpu.ops import klt_pallas_fp  # noqa: E402
from visual_odometry_ros_tpu.ops.klt_pallas_fp import track_level_fp, track_scale_fp  # noqa: E402
from visual_odometry_ros_tpu.ops.pyramid import build_pyramid_with_gradients as j_pyr  # noqa: E402
from visual_odometry_ros_tpu.ops.pyramid import scharr_gradients as j_scharr  # noqa: E402
from visual_odometry_ros_tpu.utils.interp import bilinear_sample as j_bilinear  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import klt as TK  # noqa: E402
from visual_odometry_ros_tpu_torch.ops import klt_kernels as KK  # noqa: E402
from visual_odometry_ros_tpu_torch.ops.pyramid import build_pyramid_with_gradients as t_pyr  # noqa: E402
from visual_odometry_ros_tpu_torch.ops.pyramid import scharr_gradients as t_scharr  # noqa: E402

torch.set_num_threads(2)


def T(x):
    return torch.as_tensor(np.array(x))


def smooth_noise(H, W, seed=0, smooth=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(2 * smooth + 1, np.float32) / (2 * smooth + 1)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)


def shifted_pair(H=120, W=160, shift=(2.3, -1.7), seed=0, pad=8):
    """img1 is img0 translated by `shift` (true flow = +shift)."""
    base = smooth_noise(H + 2 * pad, W + 2 * pad, seed)
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    img0, _ = j_bilinear(jnp.asarray(base), jnp.stack([jnp.asarray(uu + pad), jnp.asarray(vv + pad)], -1))
    img1, _ = j_bilinear(
        jnp.asarray(base), jnp.stack([jnp.asarray(uu + pad - shift[0]), jnp.asarray(vv + pad - shift[1])], -1)
    )
    return np.asarray(img0), np.asarray(img1)


def grid_features(H, W, margin=20, n=6):
    us = np.linspace(margin, W - margin, n)
    vs = np.linspace(margin, H - margin, n)
    uu, vv = np.meshgrid(us, vs)
    return np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)


def level_both(img0, img1, p0, p1, radius=7, iters=20, epi1d=False, valid=None):
    """(Pallas interpret outputs, plain-version outputs) as numpy."""
    valid = np.ones(len(p0), bool) if valid is None else valid
    kj = jax.device_get(track_level_fp(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid),
        radius=radius, iters=iters, interpret=True, epi1d=epi1d,
    ))
    kt = KK.track_level_ref(T(img0), T(img1), T(p0), T(p1), T(valid), radius, iters, 0.03, 1e-4, epi1d)
    return [np.asarray(a) for a in kj], [a.numpy() for a in kt]


# ----------------------------------------------------------------------------
# Plain leg (port of the jnp leg) against the JAX jnp leg
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_pyr():
    img0, img1 = shifted_pair(shift=(3.4, -2.2), seed=21)
    p0 = grid_features(120, 160, margin=14, n=7)
    return img0, img1, p0


def test_track_one_level_matches_jax(pair_pyr):
    img0, img1, p0 = pair_pyr
    p1 = p0 + np.float32([3.0, -2.0])
    valid = np.ones(len(p0), bool)
    gx, gy = j_scharr(jnp.asarray(img0))
    pj, lj, ej = JK._track_one_level(jnp.asarray(img0), gx, gy, jnp.asarray(img1), jnp.asarray(p0),
                                     jnp.asarray(p1), jnp.asarray(valid), JK._patch_offsets(10), 15, 0.03, 1e-4)
    tgx, tgy = t_scharr(T(img0))
    pt, lt, et = TK._track_one_level(T(img0), tgx, tgy, T(img1), T(p0), T(p1), T(valid),
                                     TK._patch_offsets(10, "cpu"), 15, 0.03, 1e-4)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    # Same iterates; patch sums accumulate in another order (float32).
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-3)


@pytest.mark.parametrize("epi1d", [False, True])
def test_track_with_prior_and_bidirectional_match_jax(pair_pyr, epi1d):
    img0, img1, p0 = pair_pyr
    prior = p0 + np.float32([2.0, 0.0 if epi1d else -1.0])
    valid = np.ones(len(p0), bool)
    params_j = JK.KLTParams(window_radius=10, levels=3, iters=15, iters_coarse=6, max_err=60.0)
    params_t = TK.KLTParams(window_radius=10, levels=3, iters=15, iters_coarse=6, max_err=60.0)
    pyr0j, pyr1j = j_pyr(jnp.asarray(img0), 3), j_pyr(jnp.asarray(img1), 3)
    pyr0t, pyr1t = t_pyr(T(img0), 3), t_pyr(T(img1), 3)
    for jfn, tfn, kw in (
        (JK.track_with_prior_pyr, TK.track_with_prior_pyr, dict(epi1d=epi1d)),
        (JK.track_bidirectional_pyr, TK.track_bidirectional_pyr, dict(fb_scale=5.0, back_levels=1, epi1d=epi1d)),
    ):
        pj, oj = jfn(pyr0j, pyr1j, jnp.asarray(p0), jnp.asarray(prior), jnp.asarray(valid), params_j, **kw)
        pt, ot = tfn(pyr0t, pyr1t, T(p0), T(prior), T(valid), params_t, **kw)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        # Three levels of float32 iterates: 1e-3 px.
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)


def test_track_with_scale_plain_leg_matches_jax(pair_pyr):
    img0, img1, p0 = pair_pyr
    n = len(p0)
    rng = np.random.default_rng(22)
    sc = rng.uniform(0.9, 1.15, n).astype(np.float32)
    p1 = p0 + np.float32([3.2, -2.1])
    gx, gy = j_scharr(jnp.asarray(img0))
    pj, oj = JK.track_with_scale(jnp.asarray(img0), gx, gy, jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p1),
                                 jnp.asarray(sc), jnp.ones(n, bool), radius=11, iters=12, use_pallas=False)
    tgx, tgy = t_scharr(T(img0))
    pt, ot = TK.track_with_scale(T(img0), tgx, tgy, T(img1), T(p0), T(p1), T(sc), torch.ones(n, dtype=torch.bool),
                                 radius=11, iters=12, use_kernel=False)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)


# ----------------------------------------------------------------------------
# Kernel semantics against the Pallas kernels (interpret mode): the five cases
# of tests/test_klt_pallas_fp.py with their contracts, plus new edge cases.
# ----------------------------------------------------------------------------


def test_level_ref_recovers_subpixel_shift():
    shift = (2.3, -1.7)
    img0, img1 = shifted_pair(shift=shift)
    p0 = grid_features(120, 160)
    (pk, lk, ek, prk), (pt, lt, et, prt) = level_both(img0, img1, p0, p0)
    assert prt.all() and lt.all() and lk.all()
    np.testing.assert_allclose(pt - p0, np.broadcast_to(np.float32(shift), p0.shape), atol=0.08)
    assert float(et.mean()) < 2.0
    # In-window math is the Pallas kernel's: float32 rounding only.
    np.testing.assert_allclose(pt, pk, atol=1e-3)


def test_level_ref_matches_jnp_leg():
    img0, img1 = shifted_pair(shift=(1.4, 2.1), seed=3)
    p0 = grid_features(120, 160)
    (pk, lk, _, _), (pt, lt, _, prt) = level_both(img0, img1, p0, p0)
    gx, gy = j_scharr(jnp.asarray(img0))
    pj, lj, _ = JK._track_one_level(jnp.asarray(img0), gx, gy, jnp.asarray(img1), jnp.asarray(p0),
                                    jnp.asarray(p0), jnp.ones(len(p0), bool), JK._patch_offsets(7), 20, 0.03, 1e-4)
    m = lt & np.asarray(lj) & prt
    assert m.sum() >= 30
    # Same optimum as the jnp leg (sub-0.1 px, the Pallas contract).
    np.testing.assert_allclose(pt[m], np.asarray(pj)[m], atol=0.1)
    np.testing.assert_array_equal(lt, lk)


def test_level_ref_epi1d_locks_row():
    img0, img1 = shifted_pair(shift=(3.1, 0.0), seed=5)
    p0 = grid_features(120, 160)
    (pk, lk, _, _), (pt, lt, _, prt) = level_both(img0, img1, p0, p0, epi1d=True)
    m = lt & prt
    assert m.sum() >= 30
    np.testing.assert_allclose(pt[m, 0] - p0[m, 0], 3.1, atol=0.08)
    np.testing.assert_allclose(pt[m, 1], p0[m, 1], atol=1e-5)  # v must not move at all
    np.testing.assert_allclose(pt, pk, atol=1e-3)


def test_scale_ref_matches_jnp_scale_path():
    img0, img1 = shifted_pair(shift=(1.8, -0.9), seed=7)
    p0 = grid_features(120, 160)
    n = len(p0)
    ones = np.ones(n, np.float32)
    pk, ek, ok_k = jax.device_get(track_scale_fp(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p0), jnp.asarray(ones),
        jnp.ones(n, bool), radius=11, iters=20, interpret=True))
    pt, et, ok_t = (a.numpy() for a in KK.track_scale_ref(
        T(img0), T(img1), T(p0), T(p0), T(ones), torch.ones(n, dtype=torch.bool), 11, 20))
    gx, gy = j_scharr(jnp.asarray(img0))
    pj, oj = jax.device_get(JK.track_with_scale(
        jnp.asarray(img0), gx, gy, jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p0), jnp.asarray(ones),
        jnp.ones(n, bool), radius=11, iters=20, use_pallas=False))
    m = ok_t & oj
    assert m.sum() >= 30
    np.testing.assert_allclose(pt[m], pj[m], atol=0.15)  # Pallas contract vs jnp
    np.testing.assert_allclose(pt[m, 0] - p0[m, 0], 1.8, atol=0.1)
    # At s = 1 the resample is the identity, so the Pallas kernel's double
    # interpolation vanishes: float32 rounding only.
    np.testing.assert_allclose(pt, np.asarray(pk), atol=1e-3)
    np.testing.assert_array_equal(ok_t, np.asarray(ok_k))


def test_scale_ref_handles_scaled_patch():
    """img0 is a 1.25x zoom-out of the base texture; scale 1.25 maps template
    offsets back onto it (reference trackWithScale semantics)."""
    H, W, sc = 120, 160, 1.25
    base = smooth_noise(2 * H + 32, 2 * W + 32, seed=11)
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    img1, _ = j_bilinear(jnp.asarray(base), jnp.stack([jnp.asarray(uu + 16.0), jnp.asarray(vv + 16.0)], -1))
    img0, _ = j_bilinear(jnp.asarray(base), jnp.stack([jnp.asarray(uu / sc + 16.0), jnp.asarray(vv / sc + 16.0)], -1))
    img0, img1 = np.asarray(img0), np.asarray(img1)
    p0 = grid_features(H, W, margin=30, n=5)
    p1_true = p0 / sc
    n = len(p0)
    scale = np.full(n, sc, np.float32)
    pt, _, ok_t = (a.numpy() for a in KK.track_scale_ref(
        T(img0), T(img1), T(p0), T(p1_true + 1.0), T(scale), torch.ones(n, dtype=torch.bool), 11, 25))
    gx, gy = j_scharr(jnp.asarray(img0))
    pj, oj = jax.device_get(JK.track_with_scale(
        jnp.asarray(img0), gx, gy, jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p1_true + 1.0),
        jnp.asarray(scale), jnp.ones(n, bool), radius=11, iters=25, use_pallas=False))
    m = ok_t & oj
    assert m.sum() >= 20
    # The Pallas contract: same neighbourhood as the jnp leg (which samples a
    # checkerboard of the scaled patch) and near the geometric answer.
    np.testing.assert_allclose(pt[m], pj[m], atol=0.8)
    np.testing.assert_allclose(pt[m], p1_true[m], atol=1.5)


def test_level_ref_border_features_match_pallas():
    """Features 1-6 px from the border: partial windows stay alive with the
    outside pixels zero-weighted, gradients from edge-replicated reads."""
    img0, img1 = shifted_pair(shift=(0.8, -0.6), seed=31)
    p0 = np.float32([[3.0, 60.0], [5.5, 30.0], [156.0, 80.0], [80.0, 2.5], [90.0, 117.0], [6.0, 6.0],
                     [153.5, 114.2], [40.0, 1.2]])
    (pk, lk, ek, prk), (pt, lt, et, prt) = level_both(img0, img1, p0, p0, radius=7, iters=20)
    np.testing.assert_array_equal(prt, prk)
    np.testing.assert_array_equal(lt, lk)
    assert lt.sum() >= 5
    np.testing.assert_allclose(pt[lt], pk[lt], atol=1e-3)
    np.testing.assert_allclose(et[lt], ek[lt], atol=1e-3)


def test_level_ref_rejects_mostly_outside_windows():
    """A window with at most half its pixels inside the image is rejected (the
    fraction gate), one just over half survives."""
    img0, img1 = shifted_pair(shift=(0.5, 0.5), seed=33)
    # radius 7: the window spans p +- 7; at x = -1 only 7 of 15 columns are inside.
    p0 = np.float32([[-1.0, 60.0], [60.0, -1.5], [-1.0, -1.0], [1.0, 60.0], [158.6, 119.0]])
    (pk, lk, _, prk), (pt, lt, _, prt) = level_both(img0, img1, p0, p0, radius=7, iters=20)
    assert not lt[:3].any() and not lk[:3].any()
    assert lt[3] and lk[3]
    np.testing.assert_array_equal(lt, lk)


def test_level_ref_converges_beyond_4px_in_one_level():
    """Flow of 5 px at one level: the Pallas kernel needs re-anchor restarts
    past its +-4 px drift window; the port converges natively."""
    shift = (4.6, -2.1)
    img0, img1 = shifted_pair(shift=shift, seed=35, pad=12)
    p0 = grid_features(120, 160, margin=24, n=5)
    (pk, lk, _, _), (pt, lt, _, prt) = level_both(img0, img1, p0, p0, radius=10, iters=20)
    assert lt.all()
    np.testing.assert_allclose(pt - p0, np.broadcast_to(np.float32(shift), p0.shape), atol=0.08)
    m = lt & lk
    assert m.sum() >= 20
    np.testing.assert_allclose(pt[m], pk[m], atol=0.05)


def test_wrappers_use_plain_version_on_cpu_and_check_inputs():
    img0, img1 = shifted_pair(shift=(1.0, 1.0), seed=37)
    p0 = T(grid_features(120, 160))
    valid = torch.ones(len(p0), dtype=torch.bool)
    KK.reset_launch_counts()
    out = KK.track_level(T(img0), T(img1), p0, p0.clone(), valid, radius=7, iters=10)
    ref = KK.track_level_ref(T(img0), T(img1), p0, p0.clone(), valid, 7, 10)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    sc = torch.ones(len(p0))
    out = KK.track_scale(T(img0), T(img1), p0, p0.clone(), sc, valid, radius=11, iters=5)
    for a, b in zip(out, KK.track_scale_ref(T(img0), T(img1), p0, p0.clone(), sc, valid, 11, 5)):
        assert torch.equal(a, b)
    assert KK.LAUNCHES == {"klt_pyr": 0, "klt_scale": 0}  # plain versions never count
    with pytest.raises(TypeError):
        KK.track_level(T(img0).double(), T(img1), p0, p0, valid)
    with pytest.raises(ValueError):
        KK.track_level(T(img0), T(img1), p0, p0[:-1].contiguous(), valid)
    with pytest.raises(ValueError):
        KK.track_level(T(img0).t(), T(img1).t(), p0, p0, valid)  # not contiguous
    with pytest.raises(ValueError):
        KK.track_level(T(img0), T(img1), p0, p0, valid, radius=12)
    with pytest.raises(TypeError):
        KK.track_level(T(img0), T(img1), p0, p0, valid.float())


# ----------------------------------------------------------------------------
# The fused climb (`klt_pyr`): its plain version against the JAX package's
# `_pyr_track` kernel leg (Pallas, interpret mode), and the port's kernel leg
# against the level-by-level composition it replaced.
# ----------------------------------------------------------------------------

PYR_PARAMS = dict(window_radius=10, levels=3, iters=15, iters_coarse=6, max_err=60.0)


def climb_inputs(epi1d):
    """120x160 pair, features and prior. Float32 rounding can move the
    |step| < eps stop test by one iteration (a step < 0.03 px at a coarse
    level); on these inputs no feature is that close to it."""
    if epi1d:
        img0, img1 = shifted_pair(shift=(3.1, 0.0), seed=5)
        step = np.float32([2.0, 0.0])
    else:
        img0, img1 = shifted_pair(shift=(2.4, -1.6), seed=21)
        step = np.float32([2.0, -1.0])
    p0 = grid_features(120, 160, margin=14, n=7)
    return img0, img1, p0, p0 + step


def old_level_composition(pyr0, pyr1, p0, p1_init, valid, params, L, epi1d):
    """ops/klt._pyr_track's kernel leg before the fused climb: one
    `track_level` per level with the glue around it."""
    p1 = p1_init / 2.0 ** (L - 1)
    live = valid
    err = torch.zeros(p0.shape[0], dtype=torch.float32)
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        lvl_iters = params.iters if lvl == 0 else (params.iters_coarse or params.iters)
        p1_new, ok_new, err_new, proc = KK.track_level(
            pyr0[lvl][0], pyr1[lvl][0], (p0 / s).contiguous(), p1.contiguous(), live,
            radius=params.window_radius, iters=lvl_iters, eps=params.eps, min_eig=params.min_eig,
            epi1d=epi1d,
        )
        p1 = torch.where(proc[:, None], p1_new, p1)
        if lvl == 0:
            live = live & proc & ok_new
            err = err_new
        if lvl > 0:
            p1 = p1 * 2.0
    return p1, live, err


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("epi1d", [False, True])
def test_track_pyr_ref_matches_pallas_pyr_track(monkeypatch, epi1d, bidir):
    """track_pyr_ref / track_pyr_bidir_ref against the JAX `_pyr_track`
    kernel leg, its Pallas level kernel in interpret mode: flags equal,
    points within 1e-3 px."""
    monkeypatch.setattr(klt_pallas_fp, "track_level_fp", partial(klt_pallas_fp.track_level_fp, interpret=True))
    img0, img1, p0, prior = climb_inputs(epi1d)
    valid = np.ones(len(p0), bool)
    pj = JK.KLTParams(**PYR_PARAMS, use_pallas=True)
    pyr0j, pyr1j = j_pyr(jnp.asarray(img0), 3), j_pyr(jnp.asarray(img1), 3)
    p1j, live1j, _ = JK._pyr_track(pyr0j, pyr1j, jnp.asarray(p0), jnp.asarray(prior), jnp.asarray(valid), pj,
                                   epi1d=epi1d)
    imgs0 = [a[0] for a in t_pyr(T(img0), 3, with_gradients=False)]
    imgs1 = [a[0] for a in t_pyr(T(img1), 3, with_gradients=False)]
    args = (imgs0, imgs1, T(p0), T(prior), T(valid), 10, 15, 6, 0.03, 1e-4, epi1d)
    if bidir:
        p0bj, live0j, _ = JK._pyr_track(pyr1j, pyr0j, p1j, jnp.asarray(p0), live1j, pj, 1, epi1d=epi1d)
        p1t, live1t, _, p0bt, live0t = KK.track_pyr_bidir_ref(*args, back_levels=1)
        np.testing.assert_array_equal(live0t.numpy(), np.asarray(live0j))
        m = live0t.numpy()
        np.testing.assert_allclose(p0bt.numpy()[m], np.asarray(p0bj)[m], atol=1e-3)
    else:
        p1t, live1t, _ = KK.track_pyr_ref(*args)
    np.testing.assert_array_equal(live1t.numpy(), np.asarray(live1j))
    assert live1t.sum() >= 30
    np.testing.assert_allclose(p1t.numpy(), np.asarray(p1j), atol=1e-3)


@pytest.mark.parametrize("epi1d", [False, True])
def test_pyr_track_kernel_leg_equals_level_composition(epi1d):
    """The port's kernel legs on CPU (track_pyr / track_pyr_bidir, one call
    each) give, bit for bit, what one track_level per level gave."""
    img0, img1, p0, prior = climb_inputs(epi1d)
    params = TK.KLTParams(**PYR_PARAMS, use_kernel=True)
    pyr0 = t_pyr(T(img0), 3, with_gradients=False)
    pyr1 = t_pyr(T(img1), 3, with_gradients=False)
    valid = torch.ones(len(p0), dtype=torch.bool)
    valid[5] = False
    p0t, prior_t = T(p0), T(prior)
    for track_levels in (None, 1, 2):
        L = track_levels or 3
        new = TK._pyr_track(pyr0, pyr1, p0t, prior_t, valid, params, track_levels, epi1d=epi1d)
        old = old_level_composition(pyr0, pyr1, p0t, prior_t, valid, params, L, epi1d)
        for a, b in zip(new, old):
            assert torch.equal(a, b)
    # Bidirectional: forward climb, then the backward climb over one level.
    p1, live1, err1, p0b, live0 = KK.track_pyr_bidir(
        [a[0] for a in pyr0], [a[0] for a in pyr1], p0t, prior_t, valid, 10, 15, 6, epi1d=epi1d, back_levels=1)
    f = old_level_composition(pyr0, pyr1, p0t, prior_t, valid, params, 3, epi1d)
    b = old_level_composition(pyr1, pyr0, f[0], p0t, f[1], params, 1, epi1d)
    for x, y in zip((p1, live1, err1, p0b, live0), (*f, b[0], b[1])):
        assert torch.equal(x, y)
    p1_new, ok_new = TK.track_bidirectional_pyr(pyr0, pyr1, p0t, prior_t, valid, params, fb_scale=5.0,
                                                back_levels=1, epi1d=epi1d)
    fb2 = torch.sum((b[0] - p0t) ** 2, dim=-1)
    ok_old = f[1] & b[1] & (f[2] < params.max_err) & (fb2 < (params.fb_thresh * 5.0) ** 2) & TK._in_border(
        f[0], (120, 160), params.border)
    assert torch.equal(p1_new, f[0]) and torch.equal(ok_new, ok_old) and int(ok_old.sum()) >= 30
