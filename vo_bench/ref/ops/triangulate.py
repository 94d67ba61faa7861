"""Batched two-view triangulation, closed form.

Copy of the port's `ops/triangulate.py`: the
inhomogeneous DLT least-squares system (4 constraints, 3 unknowns) solved
through the adjugate of its 3x3 normal matrix. For rectified stereo,
depth = fx * baseline / disparity.
"""

from __future__ import annotations

import torch


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 solve via adjugate. A [..., 3, 3], b [..., 3]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
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
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    x = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    y = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    z = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x, y, z], dim=-1)


def triangulate(xn0: torch.Tensor, xn1: torch.Tensor, T_10: torch.Tensor):
    """Triangulate N points from normalized coords in frames 0 and 1;
    T_10 maps frame 0 to frame 1: one pose [4, 4] for all points, or one
    per point [N, 4, 4] (the reference's `vmap` over landmarks). Returns
    (X0 [N, 3], X1 [N, 3])."""
    R = T_10[..., :3, :3]
    t = T_10[..., :3, 3]
    x0, y0 = xn0[..., 0], xn0[..., 1]
    x1, y1 = xn1[..., 0], xn1[..., 1]
    z3 = torch.zeros_like(x0)
    o3 = torch.ones_like(x0)
    r0a = torch.stack([o3, z3, -x0], dim=-1)
    r0b = torch.stack([z3, o3, -y0], dim=-1)
    r1a = x1[..., None] * R[..., 2, :] - R[..., 0, :]
    r1b = y1[..., None] * R[..., 2, :] - R[..., 1, :]
    b1a = t[..., 0] - x1 * t[..., 2]
    b1b = t[..., 1] - y1 * t[..., 2]
    A = torch.stack([r0a, r0b, r1a, r1b], dim=-2)  # [N, 4, 3]
    b = torch.stack([z3, z3, b1a, b1b], dim=-1)  # [N, 4]
    AtA = torch.sum(A[..., :, :, None] * A[..., :, None, :], dim=-3)
    Atb = torch.sum(A * b[..., None], dim=-2)
    X0 = _solve3x3(AtA, Atb)
    return X0, torch.sum(R * X0[..., None, :], dim=-1) + t


