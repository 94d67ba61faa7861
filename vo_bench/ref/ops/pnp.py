"""Batched PnP RANSAC: 3D->2D pose from fixed-size hypothesis sets.

Copy of the port's `ops/pnp.py`: K minimal 6-point DLT
hypotheses solved as one batched 12x12 eigenproblem, nearest-rotation
projection per hypothesis, [K, N] reprojection scoring, a pose-only GN
polish on the winner's 2x-threshold inlier set, and the optional prior
hypothesis with its own polish.

The minimal sets come from `torch.multinomial` with the caller's
generator, or are passed in as `idx`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import geometry as geo
from . import pose_gn as PG

# Sampling weight of an invalid point: a draw with fewer than 6 valid points
# still returns 6 indices (as the reference's does) without ever preferring
# an invalid point over a valid one.
_INVALID_WEIGHT = 1e-20


class PnPResult(NamedTuple):
    T_cw: torch.Tensor  # [4, 4] world->camera
    inliers: torch.Tensor  # [N] bool
    ok: torch.Tensor
    n_inliers: torch.Tensor


def _nearest_rotation(Rraw: torch.Tensor):
    """(R in SO(3) nearest to Rraw, singular values of Rraw)."""
    U, S, Vt = torch.linalg.svd(Rraw)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return torch.einsum("...ij,...j,...jk->...ik", U, D, Vt), S


def _dlt_pnp(Xw: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Linear PnP from >= 6 points: [..., n, 3] world, [..., n, 2] normalized.

    Returns T_cw candidates [..., 4, 4]: rotation projected to SO(3), sign of
    the null vector fixed by cheirality of the centroid."""
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    # Rows for u: [X Y Z 1 0 0 0 0 -uX -uY -uZ -u], for v likewise.
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero, -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [..., 2n, 12]
    M = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = torch.linalg.eigh(M)
    p = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue
    P = p.reshape(p.shape[:-1] + (3, 4))
    # The eigensolver returns p or -p as it likes (LAPACK builds and devices
    # differ). Take the sign whose 3x3 block has a positive determinant, as
    # a scaled rotation has: with the other sign, the nearest rotation is
    # the solution turned 180 degrees about an axis, and where that axis
    # lies near the optical axis the cheirality test below cannot tell.
    P = P * torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    Rraw = P[..., :3]
    R, S = _nearest_rotation(Rraw)
    scale = torch.sum(S[..., :2], dim=-1) / 2.0  # mean of the two reliable singular values
    t = P[..., 3] / torch.clamp(scale, min=1e-9)[..., None]
    # Cheirality: the centroid must land in front; otherwise -P is the
    # solution (P and -P are both null vectors).
    cen = torch.mean(Xw, dim=-2)
    z_cen = torch.einsum("...ij,...j->...i", R, cen)[..., 2] + t[..., 2]
    flip = (z_cen < 0)[..., None]
    R2, _ = _nearest_rotation(-Rraw)
    R = torch.where(flip[..., None], R2, R)
    t = torch.where(flip, -t, t)
    return geo.rt_to_se3(R, t)


def _reproj(T, Xw, pts, fx, fy, cx, cy):
    """Reprojection error (px) and depth of Xw [N, 3] under T [..., 4, 4]."""
    Xc = geo.transform_points(T, Xw)
    z = Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = Xc[..., 0] * iz * fx + cx
    v = Xc[..., 1] * iz * fy + cy
    return torch.sqrt((u - pts[..., 0]) ** 2 + (v - pts[..., 1]) ** 2), z


def sample_minimal_sets(valid: torch.Tensor, n_hypotheses: int, generator=None) -> torch.Tensor:
    """[K, 6] point indices, each row 6 distinct points drawn uniformly among
    the valid ones (without replacement)."""
    w = torch.where(valid, 1.0, _INVALID_WEIGHT).to(torch.float32)
    return torch.multinomial(w.expand(n_hypotheses, -1), 6, replacement=False, generator=generator)


def pnp_ransac(Xw, pts, valid, fx, fy, cx, cy, thresh_px: float = 3.0, n_hypotheses: int = 64,
               min_inlier_ratio: float = 0.6,
               gn_params: PG.PoseGNParams = PG.PoseGNParams(max_iters=30), T_init=None,
               generator: torch.Generator | None = None, idx: torch.Tensor | None = None) -> PnPResult:
    """RANSAC linear PnP + GN polish. Xw [N, 3] world, pts [N, 2] pixels.

    T_init (optional [4, 4] T_cw prior) is scored as one more hypothesis and
    polished over all valid points: the linear DLT is degenerate for
    coplanar points, where a GN descent from the prior still converges.
    idx (optional [n_hypotheses, 6]) replaces the draw from `generator`."""
    xn = torch.stack([(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy], dim=-1)
    if idx is None:
        idx = sample_minimal_sets(valid, n_hypotheses, generator)
    idx = idx.to(device=Xw.device, dtype=torch.int64)
    T_h = _dlt_pnp(Xw[idx], xn[idx])  # [K, 4, 4]
    if T_init is not None:
        T_h = torch.cat([T_h, T_init[None]], dim=0)

    err, z = _reproj(T_h, Xw, pts, fx, fy, cx, cy)  # [K, N]
    front = (z > 0.01) & valid[None, :]
    inl = (err < thresh_px) & front
    # Reference retry rule: the polish set is the 2x-threshold inliers.
    inl2 = (err < 2.0 * thresh_px) & front
    best = torch.argmax(torch.sum(inl, dim=1))
    T_best = T_h[best]
    polish = (Xw, pts, inl2[best], fx, fy, cx, cy, T_best)
    if T_init is None:
        res = PG.pose_only_gn_mono(*polish, gn_params)
    else:
        # Polish the prior over ALL valid points too, then keep whichever
        # final pose explains more points.
        res, res_p = PG.pose_only_gn_mono_many([polish, (Xw, pts, valid, fx, fy, cx, cy, T_init)], gn_params)
    T_final = torch.where(res.ok, res.T10, T_best)

    def count_inl(T):
        e, zz = _reproj(T, Xw, pts, fx, fy, cx, cy)
        return torch.sum((e < thresh_px) & (zz > 0.01) & valid)

    if T_init is not None:
        T_prior = torch.where(torch.all(torch.isfinite(res_p.T10)), res_p.T10, T_init)
        T_final = torch.where(count_inl(T_prior) > count_inl(T_final), T_prior, T_final)

    errf, zf = _reproj(T_final, Xw, pts, fx, fy, cx, cy)
    inliers = (errf < thresh_px) & (zf > 0.01) & valid
    n_in = torch.sum(inliers)
    n_valid = torch.clamp(torch.sum(valid), min=1)
    ok = (n_in >= min_inlier_ratio * n_valid) & torch.all(torch.isfinite(T_final))
    return PnPResult(T_final, inliers, ok, n_in)
