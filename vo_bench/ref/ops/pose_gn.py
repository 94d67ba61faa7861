"""Pose-only Gauss-Newton with Huber weights: mono and stereo, each with its
two-pass gate.

The plain PyTorch semantics that the program's `pose_gn` kernel implements
(its `ops/pose_gn.py` `*_ref` versions): one pass (`pose_only_gn_mono`,
`pose_only_gn_stereo`) or the robust two-pass solve with its gate and
arbitration (`pose_only_gn_stereo_robust`, `pose_only_gn_mono_robust`).
The loop runs on the host and checks its stop flag once every
`_CHECK_EVERY` iterations: iterations after the stop are masked no-ops, so
the result equals a loop that stops at once. Nothing here launches a kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import geometry as geo
from ..utils.robust import huber_weight

_CHECK_EVERY = 4


class PoseGNParams(NamedTuple):
    max_iters: int = 100
    huber_delta: float = 0.5
    lam: float = 1e-5  # multiplicative LM damping on the Hessian diagonal
    step_tol: float = 1e-4
    cost_tol: float = 1e-5  # relative |dcost| / cost
    reproj_thresh: float = 1.5  # px, inlier gate for the output mask
    min_inlier_ratio: float = 0.25
    min_inliers: int = 10


class PoseGNResult(NamedTuple):
    T10: torch.Tensor  # refined pose [4, 4]
    inliers: torch.Tensor  # [N] bool
    mean_err: torch.Tensor  # mean reprojection error over valid points (px)
    ok: torch.Tensor  # scalar bool
    n_iter: torch.Tensor


def _project_jacobian(Xc: torch.Tensor, fx, fy):
    """d(pixel)/d(Xc): [N, 2, 3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def _se3_point_jacobian(Xc: torch.Tensor):
    """d(Xc)/d(xi), xi = [v, w] left perturbation: [N, 3, 6] = [I | -[Xc]x]."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    return torch.cat([eye, -geo.skew(Xc)], dim=-1)


def _solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cholesky solve; a non-positive-definite H yields NaN (no host sync),
    as the reference's Cholesky does."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def _pose_gn_core(residual_fn, T_init, valid, params: PoseGNParams, n_rows: int) -> PoseGNResult:
    """Shared damped-GN loop. residual_fn(T) -> (r [N, n_rows], J [N, n_rows, 6])."""
    dev = T_init.device
    w_valid = valid.to(torch.float32)
    n_valid = torch.clamp(torch.sum(w_valid), min=1.0)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    T = T_init
    prev_cost = torch.tensor(float("inf"), device=dev)
    it = torch.tensor(0, dtype=torch.int32, device=dev)
    done = torch.tensor(False, device=dev)
    for k in range(params.max_iters):
        if k % _CHECK_EVERY == 0 and k > 0 and bool(done):
            break
        r, J = residual_fn(T)
        rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
        w = huber_weight(rn, params.huber_delta) * w_valid
        cost = torch.sum(w * rn * rn) / n_valid
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        g = -torch.einsum("nri,nr->i", Jw, r)
        H = H + params.lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
        dxi = _solve6(H, g)
        bad = ~torch.all(torch.isfinite(dxi))
        T_step = torch.where(bad, T, geo.add_front_se3(T, torch.nan_to_num(dxi)))
        converged = (torch.linalg.norm(dxi) < params.step_tol) | (
            torch.abs(prev_cost - cost) < params.cost_tol * (cost + 1e-9)
        )
        # Masked no-op once done: the while loop would not have run this step.
        T = torch.where(done, T, T_step)
        prev_cost = torch.where(done, prev_cost, cost)
        it = torch.where(done, it, it + 1)
        done = done | converged | bad

    r, _ = residual_fn(T)
    err = torch.sqrt(torch.sum(r * r, dim=-1) / (n_rows // 2))
    inliers = valid & (err < params.reproj_thresh)
    # The mean over the valid points only: an invalid point's error adds
    # nothing even where it is not finite (the reference's XLA rewrites its
    # product with the 0/1 weight into a select).
    mean_err = torch.sum(torch.where(valid, err, 0.0)) / n_valid
    n_inl = torch.sum(inliers)
    ok = (
        torch.all(torch.isfinite(T))
        & (n_inl / n_valid >= params.min_inlier_ratio)
        & (n_inl >= params.min_inliers)
        & torch.isfinite(mean_err)
    )
    return PoseGNResult(T, inliers, mean_err, ok, it)


def pose_only_gn_mono(X0, pts1, valid, fx, fy, cx, cy, T_10_init,
                          params: PoseGNParams = PoseGNParams()) -> PoseGNResult:
    """Refine T_10 so that pi(T_10 X0) matches pts1 (2 residual rows per
    point). X0 [N, 3] in frame-0 camera coordinates, pts1 [N, 2] pixels."""

    def residual_fn(T):
        Xc = geo.transform_points(T, X0)
        z = Xc[..., 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        r = torch.stack([Xc[..., 0] * iz * fx + cx, Xc[..., 1] * iz * fy + cy], dim=-1) - pts1
        J = torch.einsum("nij,njk->nik", _project_jacobian(Xc, fx, fy), _se3_point_jacobian(Xc))
        # Behind-camera points contribute nothing.
        front = (z > 0.01)[:, None]
        return torch.where(front, r, 0.0), torch.where(front[:, :, None], J, 0.0)

    return _pose_gn_core(residual_fn, T_10_init, valid, params, n_rows=2)


def pose_only_gn_stereo(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                            T_10_init, params: PoseGNParams = PoseGNParams()) -> PoseGNResult:
    """Stereo pose refinement with 4 residual rows per point (left u, v,
    right u, v). X0 [N, 3] in the previous left-camera frame."""
    R_rl = T_rl[:3, :3]

    def proj_rows(Xc, pts):
        z = Xc[..., 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        return torch.stack([Xc[..., 0] * iz * fx + cx, Xc[..., 1] * iz * fy + cy], dim=-1) - pts

    def residual_fn(T):
        Xl = geo.transform_points(T, X0)
        Xr = geo.transform_points(T_rl, Xl)
        r_l = proj_rows(Xl, pts_l1)
        r_r = proj_rows(Xr, pts_r1)
        Jp = _se3_point_jacobian(Xl)
        J_l = torch.einsum("nij,njk->nik", _project_jacobian(Xl, fx, fy), Jp)
        J_r = torch.einsum("nij,jm,nmk->nik", _project_jacobian(Xr, fx, fy), R_rl, Jp)
        front = (Xl[..., 2] > 0.01) & (Xr[..., 2] > 0.01)
        m_l = (front & valid_l)[:, None]
        m_r = (front & valid_r)[:, None]
        r = torch.cat([torch.where(m_l, r_l, 0.0), torch.where(m_r, r_r, 0.0)], dim=-1)
        J = torch.cat(
            [torch.where(m_l[:, :, None], J_l, 0.0), torch.where(m_r[:, :, None], J_r, 0.0)], dim=-2
        )
        return r, J

    return _pose_gn_core(residual_fn, T_10_init, valid_l, params, n_rows=4)


def _reproj_err_px(T, X0, pts1, fx, fy, cx, cy):
    """Per-point left-view reprojection error (px); behind-camera -> 1e6."""
    Xc = geo.transform_points(T, X0)
    z = Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = Xc[..., 0] * iz * fx + cx
    v = Xc[..., 1] * iz * fy + cy
    err = torch.sqrt((u - pts1[..., 0]) ** 2 + (v - pts1[..., 1]) ** 2)
    return torch.where(z > 0.01, err, 1e6)


def pose_only_gn_stereo_robust(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                                   T_10_init, params: PoseGNParams = PoseGNParams(),
                                   gate_scale: float = 2.0):
    """Two-pass gated pose GN: solve, hard-gate at gate_scale x reproj_thresh
    under the better of {pass-1 pose, prior}, re-solve on survivors, and
    arbitrate on inlier counts over the common point set.
    Returns (PoseGNResult, err_px [N] under the chosen pose)."""
    res1 = pose_only_gn_stereo(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                                   T_10_init, params)
    T1 = torch.where(res1.ok, res1.T10, T_10_init)
    err1 = _reproj_err_px(T1, X0, pts_l1, fx, fy, cx, cy)
    keep = valid_l & (err1 < gate_scale * params.reproj_thresh)
    res2 = pose_only_gn_stereo(X0, pts_l1, pts_r1, keep, valid_r & keep, fx, fy, cx, cy, T_rl,
                                   T1, params)
    err2_all = _reproj_err_px(res2.T10, X0, pts_l1, fx, fy, cx, cy)
    n1 = torch.sum(valid_l & (err1 < params.reproj_thresh))
    n2 = torch.sum(valid_l & (err2_all < params.reproj_thresh))
    use2 = res2.ok & (~res1.ok | (n2 >= n1))
    T = torch.where(use2, res2.T10, torch.where(res1.ok, res1.T10, T_10_init))
    err = _reproj_err_px(T, X0, pts_l1, fx, fy, cx, cy)
    inliers = valid_l & (err < params.reproj_thresh)
    n_fin = torch.sum(inliers)
    n_all = torch.clamp(torch.sum(valid_l), min=1)
    err_prior = _reproj_err_px(T_10_init, X0, pts_l1, fx, fy, cx, cy)
    n_prior = torch.sum(valid_l & (err_prior < params.reproj_thresh))
    ok = (
        (res1.ok | res2.ok)
        & (n_fin >= params.min_inliers)
        & (n_fin / n_all >= params.min_inlier_ratio)
        & (n_fin + 2 >= n_prior)
    )
    mean_err = torch.where(use2, res2.mean_err, res1.mean_err)
    return PoseGNResult(T, inliers, mean_err, ok, res1.n_iter + res2.n_iter), err


def pose_only_gn_mono_robust(X0, pts1, valid, fx, fy, cx, cy, T_10_init,
                                 params: PoseGNParams = PoseGNParams(), gate_scale: float = 2.0):
    """Mono twin of `pose_only_gn_stereo_robust`: solve, hard-gate, re-solve
    on the survivors, arbitrate on inlier counts over the common point set.
    Returns (PoseGNResult, err_px [N] under the chosen pose)."""
    res1 = pose_only_gn_mono(X0, pts1, valid, fx, fy, cx, cy, T_10_init, params)
    T1 = torch.where(res1.ok, res1.T10, T_10_init)
    err1 = _reproj_err_px(T1, X0, pts1, fx, fy, cx, cy)
    keep = valid & (err1 < gate_scale * params.reproj_thresh)
    res2 = pose_only_gn_mono(X0, pts1, keep, fx, fy, cx, cy, T1, params)
    err2_all = _reproj_err_px(res2.T10, X0, pts1, fx, fy, cx, cy)
    n1 = torch.sum(valid & (err1 < params.reproj_thresh))
    n2 = torch.sum(valid & (err2_all < params.reproj_thresh))
    use2 = res2.ok & (~res1.ok | (n2 >= n1))
    T = torch.where(use2, res2.T10, torch.where(res1.ok, res1.T10, T_10_init))
    err = _reproj_err_px(T, X0, pts1, fx, fy, cx, cy)
    inliers = valid & (err < params.reproj_thresh)
    n_fin = torch.sum(inliers)
    n_all = torch.clamp(torch.sum(valid), min=1)
    err_prior = _reproj_err_px(T_10_init, X0, pts1, fx, fy, cx, cy)
    n_prior = torch.sum(valid & (err_prior < params.reproj_thresh))
    ok = (
        (res1.ok | res2.ok)
        & (n_fin >= params.min_inliers)
        & (n_fin / n_all >= params.min_inlier_ratio)
        & (n_fin + 2 >= n_prior)
    )
    mean_err = torch.where(use2, res2.mean_err, res1.mean_err)
    return PoseGNResult(T, inliers, mean_err, ok, res1.n_iter + res2.n_iter), err


def pose_only_gn_mono_many(solves, params: PoseGNParams = PoseGNParams()) -> list:
    """Several independent `pose_only_gn_mono` solves, in turn: `solves`
    are tuples (X0, pts1, valid, fx, fy, cx, cy, T_10_init)."""
    return [pose_only_gn_mono(*s, params) for s in solves]
