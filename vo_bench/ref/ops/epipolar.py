"""Epipolar geometry: essential-matrix RANSAC (batched 8-point), decomposition
with a chirality vote, Sampson and symmetric epipolar distances, and the
1-point steering-angle vote.

Copy of the port's `ops/epipolar.py`. The hypotheses are
a fixed batch of K 8-point solves (the smallest eigenvector of a 9x9 normal
matrix, batched `eigh`), scored by one [K, N] Sampson evaluation, then the
top 8 are refined in parallel by iterated hard-inlier least squares.

The reference draws each hypothesis's 8 points from `jax.random`
(categorical over the valid lanes, with replacement). Here they come from
`torch.multinomial` with the caller's generator, or are passed in as `idx`,
which is how tests hold the two packages to the same draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import geometry as geo
from ..utils.robust import masked_median_histogram
from .triangulate import triangulate

# Sampling weight of an invalid point: with no valid point the draw is
# uniform over all points (the reference's all -1e9 logits), and otherwise
# an invalid point is never preferred over a valid one.
_INVALID_WEIGHT = 1e-20
_TOPK = 8  # seeds refined in parallel


def _to_homog(xn: torch.Tensor) -> torch.Tensor:
    return torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)


def _epipolar_terms(E, xn0, xn1):
    """(E x0 [..., N, 3], E^T x1 [..., N, 3], x1^T E x0 [..., N]) for E [..., 3, 3]."""
    x0 = _to_homog(xn0)
    x1 = _to_homog(xn1)
    Ex0 = torch.einsum("...ij,nj->...ni", E, x0)
    Etx1 = torch.einsum("...ji,nj->...ni", E, x1)
    x1Ex0 = torch.einsum("ni,...ni->...n", x1, Ex0)
    return Ex0, Etx1, x1Ex0


def sampson_distance(E: torch.Tensor, xn0: torch.Tensor, xn1: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance in normalized coordinates. E [..., 3, 3],
    xn0 / xn1 [N, 2]; E's batch dims broadcast against N."""
    Ex0, Etx1, x1Ex0 = _epipolar_terms(E, xn0, xn1)
    denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return x1Ex0**2 / torch.clamp(denom, min=1e-12)


def _eight_point_normal(xn0: torch.Tensor, xn1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point solve: the smallest eigenvector of A^T W A (9x9).
    xn0 / xn1 [..., N, 2], w [..., N]. Returns E [..., 3, 3] (unprojected)."""
    x0, y0 = xn0[..., 0], xn0[..., 1]
    x1, y1 = xn1[..., 0], xn1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], dim=-1)
    M = torch.einsum("...ni,...nj->...ij", A * w[..., None], A)
    _, vecs = torch.linalg.eigh(M)
    e = vecs[..., :, 0]
    return e.reshape(e.shape[:-1] + (3, 3))


def _project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values set to (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return torch.einsum("...ij,j,...jk->...ik", U, d, Vt)


def decompose_essential(E: torch.Tensor):
    """E -> (R_a, R_b, t): the four (R, +-t) candidates (Hartley-Zisserman)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * torch.where(torch.linalg.det(Vt) < 0, -1.0, 1.0)[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def chirality_vote(Ra, Rb, t, xn0, xn1, valid):
    """The (R, t) of the four candidates with the most valid points in front
    of both cameras (the first on a tie). Returns (R, t, votes)."""
    cands_R = torch.stack([Ra, Ra, Rb, Rb])
    cands_t = torch.stack([t, -t, t, -t])
    votes = []
    for R, tt in zip(cands_R, cands_t):
        X0, X1 = triangulate(xn0, xn1, geo.rt_to_se3(R, tt))
        votes.append(torch.sum((X0[..., 2] > 0) & (X1[..., 2] > 0) & valid))
    votes = torch.stack(votes)
    best = torch.argmax(votes)
    return cands_R[best], cands_t[best], votes[best]


class EssentialResult(NamedTuple):
    E: torch.Tensor  # [3, 3]
    R_10: torch.Tensor  # [3, 3] rotation of frame 0 in frame 1
    t_10: torch.Tensor  # [3] unit translation
    inliers: torch.Tensor  # [N] bool
    ok: torch.Tensor  # [] bool
    n_inliers: torch.Tensor


def sample_eight_point_sets(valid: torch.Tensor, n_hypotheses: int, generator=None) -> torch.Tensor:
    """[K, 8] point indices per hypothesis, drawn uniformly among the valid
    points with replacement."""
    w = torch.where(valid, 1.0, _INVALID_WEIGHT).to(torch.float32)
    return torch.multinomial(w.expand(n_hypotheses, -1), 8, replacement=True, generator=generator)


def estimate_essential_ransac(xn0, xn1, valid, thresh_px: float = 1.0, focal: float = 700.0,
                              n_hypotheses: int = 256, refine_iters: int = 5, min_inliers: int = 30,
                              generator: torch.Generator | None = None,
                              idx: torch.Tensor | None = None) -> EssentialResult:
    """Fixed-size RANSAC: K 8-point hypotheses -> Sampson score -> the top 8
    refined by iterated hard-inlier least squares (gate 4x -> 2x -> 1x) ->
    the best refined model -> decomposition + chirality.

    thresh_px is converted to normalized units through `focal`. idx
    (optional [n_hypotheses, 8]) replaces the draw from `generator`."""
    thresh = (thresh_px / focal) ** 2
    if idx is None:
        idx = sample_eight_point_sets(valid, n_hypotheses, generator)
    idx = idx.to(device=xn0.device, dtype=torch.int64)
    w8 = torch.ones(idx.shape, dtype=torch.float32, device=xn0.device)
    E_h = _project_to_essential(_eight_point_normal(xn0[idx], xn1[idx], w8))  # [K, 3, 3]
    scores = torch.sum((sampson_distance(E_h, xn0, xn1) < thresh) & valid[None, :], dim=1)

    # Top seeds, ties to the lower index (as jax.lax.top_k orders them).
    top_idx = torch.sort(scores, descending=True, stable=True).indices[:_TOPK]
    E = E_h[top_idx]
    for i in range(refine_iters + 2):
        c = max(4.0 / 2.0**i, 1.0)
        dd = sampson_distance(E, xn0, xn1)  # [TOPK, N]
        w = ((dd < c * thresh) & valid[None, :]).to(torch.float32)
        E_new = _project_to_essential(_eight_point_normal(xn0[None], xn1[None], w))
        # Per seed: keep the refit only if it does not lose inliers.
        n_old = torch.sum((dd < thresh) & valid[None, :], dim=1)
        n_new = torch.sum((sampson_distance(E_new, xn0, xn1) < thresh) & valid[None, :], dim=1)
        E = torch.where((n_new >= n_old)[:, None, None], E_new, E)
    d_all = sampson_distance(E, xn0, xn1)
    n_all = torch.sum((d_all < thresh) & valid[None, :], dim=1)
    best = torch.argmax(n_all)  # the first maximum, as jnp.argmax
    E_ref = E[best]
    inliers = (d_all[best] < thresh) & valid
    n_in = n_all[best]

    Ra, Rb, t = decompose_essential(E_ref)
    R, tt, votes = chirality_vote(Ra, Rb, t, xn0, xn1, inliers)
    ok = (n_in >= min_inliers) & (votes > 0.6 * torch.clamp(n_in, min=1))
    return EssentialResult(E_ref, R, tt, inliers, ok, n_in)


def steering_angle_histogram(xn0: torch.Tensor, xn1: torch.Tensor, valid: torch.Tensor, bins: int = 400):
    """1-point steering-angle vote for planar motion: per pair
    -2 atan((x0 y1 - y0 x1) / (y0 + y1)), histogram median. Plain atan of
    the ratio, not atan2: the denominator's sign folds into the ratio.
    Returns (median, per-pair angles)."""
    x0, y0 = xn0[..., 0], xn0[..., 1]
    x1, y1 = xn1[..., 0], xn1[..., 1]
    denom = y0 + y1
    psi = -2.0 * torch.arctan((x0 * y1 - y0 * x1) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom))
    return masked_median_histogram(psi, valid, -0.5, 0.5, bins), psi


def essential_from_rt(R_10: torch.Tensor, t_10: torch.Tensor) -> torch.Tensor:
    """E = [t]x R."""
    return geo.skew(t_10) @ R_10


def symmetric_epipolar_distance_px(F: torch.Tensor, pts0: torch.Tensor, pts1: torch.Tensor) -> torch.Tensor:
    """Un-squared symmetric epipolar distance in pixels:
    |p1^T F p0| (1 / ||(F p0)_xy|| + 1 / ||(F^T p1)_xy||)."""
    p0 = _to_homog(pts0)
    p1 = _to_homog(pts1)
    Fp0 = p0 @ F.T
    Ftp1 = p1 @ F
    num = torch.abs(torch.sum(p1 * Fp0, dim=-1))
    n0 = torch.sqrt(torch.clamp(Fp0[:, 0] ** 2 + Fp0[:, 1] ** 2, min=1e-24))
    n1 = torch.sqrt(torch.clamp(Ftp1[:, 0] ** 2 + Ftp1[:, 1] ** 2, min=1e-24))
    return num * (1.0 / n0 + 1.0 / n1)


class OnePointResult(NamedTuple):
    theta: torch.Tensor  # [] median steering angle (rad)
    R_10: torch.Tensor  # [3, 3] yaw about y
    t_10: torch.Tensor  # [3] unit translation on the circular arc
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int32


def one_point_pose(pts0, pts1, valid, fx, fy, cx, cy, thres_px: float = 15.0, bins: int = 400):
    """1-point planar-motion estimate and inlier gate: the histogram-median
    steering angle theta, the circular-arc model R = R_y(theta),
    t = [sin(theta/2), 0, cos(theta/2)], then the symmetric epipolar distance
    in pixels gated at thres_px^2. pts0 / pts1 [N, 2] pixels."""
    xn0 = torch.stack([(pts0[:, 0] - cx) / fx, (pts0[:, 1] - cy) / fy], -1)
    xn1 = torch.stack([(pts1[:, 0] - cx) / fx, (pts1[:, 1] - cy) / fy], -1)
    theta, _ = steering_angle_histogram(xn0, xn1, valid, bins=bins)
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R_10 = torch.stack([torch.stack([c, zero, s]), torch.stack([zero, one, zero]), torch.stack([-s, zero, c])])
    t_10 = torch.stack([torch.sin(theta * 0.5), zero, torch.cos(theta * 0.5)])
    E = essential_from_rt(R_10, t_10)
    Kinv = torch.tensor(
        [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy], [0.0, 0.0, 1.0]],
        dtype=pts0.dtype, device=pts0.device,
    )
    d = symmetric_epipolar_distance_px(Kinv.T @ E @ Kinv, pts0, pts1)
    inliers = valid & (d <= thres_px * thres_px)
    return OnePointResult(theta, R_10, t_10, inliers, torch.sum(inliers).to(torch.int32))
