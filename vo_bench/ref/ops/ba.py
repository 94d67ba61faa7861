"""Sliding-window bundle adjustment: Schur complement over a dense [M, K]
observation incidence, on one device.

The plain PyTorch semantics that the program's `ba_*` kernels implement
(its `ops/ba.py` `ba_solve_ref`): anchoring at the first window keyframe,
Huber IRLS rows (left and right camera), a Jacobi-equilibrated float32
Cholesky of the reduced camera system, no float64 anywhere; the GN loop on
the host, with one host read per iteration for the stop test. Nothing here
launches a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import geometry as geo
from ..utils.robust import huber_weight


class BAProblem(NamedTuple):
    T_cw: torch.Tensor  # [K, 4, 4] world->camera poses
    Xw: torch.Tensor  # [M, 3] world points
    pts: torch.Tensor  # [M, K, 2] observed pixels (left cam)
    mask: torch.Tensor  # [M, K] bool
    pts_r: torch.Tensor  # [M, K, 2] right-cam pixels
    mask_r: torch.Tensor  # [M, K] bool
    kf_valid: torch.Tensor  # [K] bool
    lm_valid: torch.Tensor  # [M] bool


class BAParams(NamedTuple):
    iters: int = 10
    n_fix: int = 2  # oldest keyframes held fixed
    huber_delta: float = 1.0  # px
    lam: float = 1e-5  # multiplicative diagonal damping
    max_trans_update: float = 50.0  # divergence guard
    kill_dist: float = 3000.0  # landmark kill radius
    min_obs: int = 2  # landmarks need >= 2 window observations


class BAResult(NamedTuple):
    T_cw: torch.Tensor  # [K, 4, 4]
    Xw: torch.Tensor  # [M, 3]
    killed: torch.Tensor  # [M]
    mean_err_px: torch.Tensor  # masked mean reprojection error after the solve
    n_obs: torch.Tensor
    mean_err0_px: torch.Tensor  # the same error before the solve


def _inv3x3(C):
    """Batched closed-form 3x3 inverse via adjugate. C [..., 3, 3]."""
    a00, a01, a02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    a10, a11, a12 = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    a20, a21, a22 = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(
        torch.abs(det) < 1e-12, torch.where(det < 0, -1e-12, 1e-12), det
    )
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def build_observation_terms(T_cr, Xr, pts, mask, pts_r, mask_r, fx, fy, cx, cy, T_rl, huber_delta):
    """Residuals and Jacobian blocks for every (landmark m, keyframe k).
    Returns (w [M,K,4], r [M,K,4], Q [M,K,4,6], Rj [M,K,4,3])."""
    R = T_cr[:, :3, :3]
    t = T_cr[:, :3, 3]
    Xc = torch.einsum("kij,mj->mki", R, Xr) + t[None]  # [M, K, 3]
    z_ok = Xc[..., 2] > 0.05
    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / torch.where(torch.abs(Xc[..., 2]) < 1e-6, 1e-6, Xc[..., 2])
    xiz, yiz = x * iz, y * iz
    r_l = torch.stack([xiz * fx + cx, yiz * fy + cy], dim=-1) - pts

    one = torch.ones_like(iz)
    zero = torch.zeros_like(iz)
    qu = torch.stack(
        [fx * iz, zero, -fx * xiz * iz, -fx * xiz * yiz, fx * (one + xiz * xiz), -fx * yiz], dim=-1
    )
    qv = torch.stack(
        [zero, fy * iz, -fy * yiz * iz, -fy * (one + yiz * yiz), fy * xiz * yiz, fy * xiz], dim=-1
    )
    Q_l = torch.stack([qu, qv], dim=-2)
    Rj_l = torch.stack(
        [
            fx * iz[..., None] * (R[None, :, 0, :] - xiz[..., None] * R[None, :, 2, :]),
            fy * iz[..., None] * (R[None, :, 1, :] - yiz[..., None] * R[None, :, 2, :]),
        ],
        dim=-2,
    )
    m_l = (mask & z_ok).to(torch.float32)

    R_rl = T_rl[:3, :3]
    t_rl = T_rl[:3, 3]
    Xrc = torch.einsum("ij,mkj->mki", R_rl, Xc) + t_rl
    zr_ok = Xrc[..., 2] > 0.05
    xr, yr = Xrc[..., 0], Xrc[..., 1]
    izr = 1.0 / torch.where(torch.abs(Xrc[..., 2]) < 1e-6, 1e-6, Xrc[..., 2])
    r_r = torch.stack([xr * izr * fx + cx, yr * izr * fy + cy], dim=-1) - pts_r
    dpiR = torch.stack(
        [
            fx * izr[..., None] * (R_rl[None, None, 0, :] - (xr * izr)[..., None] * R_rl[None, None, 2, :]),
            fy * izr[..., None] * (R_rl[None, None, 1, :] - (yr * izr)[..., None] * R_rl[None, None, 2, :]),
        ],
        dim=-2,
    )
    Q_r = torch.cat([dpiR, torch.linalg.cross(Xc[..., None, :].expand_as(dpiR), dpiR)], dim=-1)
    Rj_r = torch.sum(dpiR[..., :, :, None] * R[None, :, None, :, :], dim=-2)
    m_r = (mask_r & zr_ok).to(torch.float32)

    r = torch.cat([r_l, r_r], dim=-1)
    Q = torch.cat([Q_l, Q_r], dim=-2)
    Rj = torch.cat([Rj_l, Rj_r], dim=-2)
    rn_l = torch.sqrt(torch.sum(r_l * r_l, dim=-1) + 1e-12)
    rn_r = torch.sqrt(torch.sum(r_r * r_r, dim=-1) + 1e-12)
    w_l = huber_weight(rn_l, huber_delta) * m_l
    w_r = huber_weight(rn_r, huber_delta) * m_r
    w = torch.cat([w_l[..., None].expand(w_l.shape + (2,)), w_r[..., None].expand(w_r.shape + (2,))], dim=-1)
    return w, r, Q, Rj


def assemble_normal_blocks(w, r, Q, Rj):
    """Returns A [K,6,6], a [K,6], C [M,3,3], b [M,3], B [M,K,6,3]."""
    wQ = Q * w[..., None]
    A = torch.einsum("mkra,mkrb->kab", wQ, Q)
    a = -torch.einsum("mkra,mkr->ka", wQ, r)
    wR = Rj * w[..., None]
    C = torch.sum(wR[..., :, :, None] * Rj[..., :, None, :], dim=(-4, -3))
    b = -torch.sum(wR * r[..., None], dim=(-3, -2))
    B = torch.sum(wQ[..., :, :, None] * Rj[..., :, None, :], dim=-3)
    return A, a, C, b, B


def schur_reduce(A, a, C, b, B, lam):
    """Damp and eliminate the landmark block.
    Returns (S [K,K,6,6], s [K,6], Cinv [M,3,3], BCinv [M,K,6,3])."""
    K = A.shape[0]
    M = C.shape[0]
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    A = A + lam * A * eye6
    C = C + lam * C * eye3
    C = C + 1e-6 * eye3
    Cinv = _inv3x3(C)
    BCinv = torch.sum(B[..., :, :, None] * Cinv[:, None, None, :, :], dim=-2)
    X1 = BCinv.permute(1, 2, 0, 3).reshape(K * 6, M * 3)
    X2 = B.permute(0, 3, 1, 2).reshape(M * 3, K * 6)
    S_off = torch.matmul(X1, X2).reshape(K, 6, K, 6).permute(0, 2, 1, 3)
    eyeK = torch.eye(K, dtype=A.dtype, device=A.device)
    S = -S_off + eyeK[:, :, None, None] * A[:, None, :, :]
    sb = torch.matmul(X1, b.reshape(M * 3))
    return S, a - sb.reshape(K, 6), Cinv, BCinv


def equilibrated_system(S, s, opt_mask):
    """solve_reduced's system [6K, 6K]: the fixed and empty slots gated to
    unit rows, Jacobi-equilibrated, + 1e-7 I. Returns (Hn, the right-hand
    side times dinv, dinv)."""
    n = 6 * S.shape[0]
    om = opt_mask.to(S.dtype)
    S = S * (om[:, None] * om[None, :])[:, :, None, None]
    H = S.permute(0, 2, 1, 3).reshape(n, n)
    rhs = (s * om[:, None]).reshape(n)
    keep = om.repeat_interleave(6)
    H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
    dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hn = H * dinv[:, None] * dinv[None, :] + 1e-7 * torch.eye(n, dtype=H.dtype, device=H.device)
    return Hn, rhs * dinv, dinv


def solve_reduced(S, s, opt_mask):
    """Solve the reduced camera system for the optimizable keyframes with a
    Jacobi-equilibrated float32 Cholesky; fixed or empty slots get dx = 0."""
    Hn, z, dinv = equilibrated_system(S, s, opt_mask)
    L, info = torch.linalg.cholesky_ex(Hn)
    L = torch.where(info == 0, L, torch.nan)  # as the reference: NaN, caught by the guard
    y = torch.linalg.solve_triangular(L, z[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0] * dinv
    return x.reshape(S.shape[0], 6) * opt_mask.to(S.dtype)[:, None]


def back_substitute(Cinv, b, B, dx):
    """dy_i = Cinv_i (b_i - sum_j B_ij^T dx_j) — [M, 3]."""
    Btx = torch.sum(B * dx[None, :, :, None], dim=(1, 2))
    return torch.sum(Cinv * (b - Btx)[:, None, :], dim=-1)


def ba_accept(mean_err_px, mean_err0_px, reproj_thresh: float):
    """Window-BA acceptance rule: finite and either materially improved under
    a hard ceiling (6.5x the pose gate) or roughly flat under a tight one
    (2.5x)."""
    improved = mean_err_px <= mean_err0_px * 0.98
    flat = mean_err_px <= mean_err0_px * 1.05 + 0.1
    return torch.isfinite(mean_err_px) & (
        (improved & (mean_err_px < 6.5 * reproj_thresh)) | (flat & (mean_err_px < 2.5 * reproj_thresh))
    )


class _Anchored(NamedTuple):
    """The solve's masks and the anchored start (ops/ba.py of the reference,
    ba_solve_impl's prologue)."""

    mask: torch.Tensor  # [M, K] observation & live keyframe & active landmark
    mask_r: torch.Tensor
    lm_active: torch.Tensor  # [M]
    opt_mask: torch.Tensor  # [K] live keyframes beyond the first n_fix
    T_rw: torch.Tensor
    T_wr: torch.Tensor
    T_cr: torch.Tensor  # [K, 4, 4] poses anchored at window slot 0
    Xr: torch.Tensor  # [M, 3]


def opt_mask(kf_valid: torch.Tensor, params: BAParams) -> torch.Tensor:
    """The slots a solve optimises: live ones past the first n_fix (the
    kernels' `opt_slot`)."""
    return kf_valid & (torch.arange(kf_valid.shape[0], device=kf_valid.device) >= params.n_fix)


def _anchor(problem: BAProblem, params: BAParams) -> _Anchored:
    obs_mask = problem.mask & problem.kf_valid[None, :]
    obs_mask_r = problem.mask_r & problem.kf_valid[None, :]
    lm_active = problem.lm_valid & (torch.sum(obs_mask, dim=1) >= params.min_obs)
    T_rw = problem.T_cw[0]
    T_wr = geo.se3_inverse(T_rw)
    return _Anchored(
        mask=obs_mask & lm_active[:, None], mask_r=obs_mask_r & lm_active[:, None], lm_active=lm_active,
        opt_mask=opt_mask(problem.kf_valid, params),
        T_rw=T_rw, T_wr=T_wr, T_cr=problem.T_cw @ T_wr, Xr=geo.transform_points(T_rw, problem.Xw),
    )


def _write_back(problem: BAProblem, params: BAParams, an: _Anchored, T_cr, Xr, err, n_l, n_r,
                mean_err0) -> BAResult:
    """The solved window back in the world frame (optimised poses
    re-orthonormalised, the others bit-identical), the kill rule and the
    error after the solve, from its sums (err, n_l) and the right-row count."""
    T_cw_new = torch.where(an.opt_mask[:, None, None], geo.se3_project(T_cr @ an.T_rw), problem.T_cw)
    Xw_new = torch.where(an.lm_active[:, None], geo.transform_points(an.T_wr, Xr), problem.Xw)
    killed = an.lm_active & (torch.linalg.norm(Xr, dim=-1) > params.kill_dist)
    return BAResult(T_cw_new, Xw_new, killed, err / torch.clamp(n_l, min=1), n_l + n_r, mean_err0)


def ba_solve(problem: BAProblem, fx, fy, cx, cy, T_rl, params: BAParams = BAParams()) -> BAResult:
    """Up to `params.iters` damped GN iterations of sliding-window BA; stops
    early once the largest pose update is below 1e-5."""
    an = _anchor(problem, params)
    mask, mask_r, lm_active, opt_mask = an.mask, an.mask_r, an.lm_active, an.opt_mask
    T_cr, Xr = an.T_cr, an.Xr

    def err_sums(T_cr_e, Xr_e):
        """The masked left-row reprojection error's sum (px) and count."""
        _, r_, _, _ = build_observation_terms(
            T_cr_e, Xr_e, problem.pts, mask, problem.pts_r, mask_r, fx, fy, cx, cy, T_rl, 1e9
        )
        rn_ = torch.sqrt(torch.sum(r_[..., :2] ** 2, dim=-1))
        return torch.sum(rn_ * mask), torch.sum(mask)

    err0, n0 = err_sums(T_cr, Xr)
    mean_err0 = err0 / torch.clamp(n0, min=1)
    it = 0
    while it < params.iters:
        w, r, Q, Rj = build_observation_terms(
            T_cr, Xr, problem.pts, mask, problem.pts_r, mask_r, fx, fy, cx, cy, T_rl,
            params.huber_delta,
        )
        A, a, C, b, B = assemble_normal_blocks(w, r, Q, Rj)
        S, s, Cinv, _ = schur_reduce(A, a, C, b, B, params.lam)
        # dy comes from the reduced system's dx, so its divergence flag is
        # taken from what it is built of: a non-finite Cinv, b or B on an
        # active landmark makes that landmark's dy non-finite; the test on
        # dy also sees a product that overflows.
        rows_bad = lm_active & ~(torch.isfinite(Cinv).all(dim=(1, 2)) & torch.isfinite(b).all(dim=1)
                                 & torch.isfinite(B).all(dim=(1, 2, 3)))
        dx = solve_reduced(S, s, opt_mask)
        dy = torch.where(lm_active[:, None], back_substitute(Cinv, b, B, dx), 0.0)
        dy_bad = (torch.sum(rows_bad) > 0) | ~torch.all(torch.isfinite(dy))
        bad = (
            ~torch.all(torch.isfinite(dx))
            | dy_bad
            | (torch.amax(torch.linalg.norm(dx[:, :3], dim=-1)) > params.max_trans_update)
        )
        dx = torch.where(bad, 0.0, dx)
        dy = torch.where(bad, 0.0, dy)
        T_cr = torch.where(opt_mask[:, None, None], geo.add_front_se3(T_cr, dx), T_cr)
        Xr = Xr + dy
        it += 1
        if bool(torch.amax(torch.abs(dx)) < 1e-5):
            break

    err, n_l = err_sums(T_cr, Xr)
    n_r = torch.sum(mask_r)
    return _write_back(problem, params, an, T_cr, Xr, err, n_l, n_r, mean_err0)
