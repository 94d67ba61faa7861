"""SO(3)/SE(3) geometry — batched functions over tensors.

Copy of the port's `utils/geometry.py`; same conventions:
rotations are 3x3 matrices, SE(3) elements 4x4 homogeneous matrices, tangent
vectors xi = [v (3), w (3)] (translation first). Every function broadcasts
over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _eye(n: int, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(shape)


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with small-angle series. [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    W = skew(w)
    WW = W @ W
    return _eye(3, w, W.shape) + a[..., None, None] * W + b[..., None, None] * WW


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues. [..., 3, 3] -> [..., 3]. Safe for angles in [0, pi)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    ) * 0.5
    sin_t = torch.sin(theta)
    scale = torch.where(
        theta < 1e-6, 1.0 + theta * theta / 6.0, theta / torch.clamp(sin_t, min=_EPS)
    )
    return v * scale[..., None]


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V such that t = V @ rho in the SE(3) exponential."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS * _EPS),
    )
    W = skew(w)
    WW = W @ W
    return _eye(3, w, W.shape) + b[..., None, None] * W + c[..., None, None] * WW


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    half = theta * 0.5
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / (theta2 + _EPS * _EPS),
    )
    W = skew(w)
    WW = W @ W
    return _eye(3, w, W.shape) - 0.5 * W + cot[..., None, None] * WW


def rt_to_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    # The bottom row comes from an identity made on the device: a Python
    # scalar written into a CUDA tensor is a host-to-device copy, which syncs.
    T = _eye(4, R, batch + (4, 4)).clone(memory_format=torch.contiguous_format)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi = [v, w] ([..., 6]) -> T ([..., 4, 4])."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (so3_left_jacobian(w) @ v[..., None])[..., 0]
    return rt_to_se3(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """T ([..., 4, 4]) -> xi = [v, w] ([..., 6])."""
    w = so3_log(T[..., :3, :3])
    v = (so3_left_jacobian_inv(w) @ T[..., :3, 3][..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse: [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_se3(Rt, -(Rt @ T[..., :3, 3][..., None])[..., 0])


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a near-rotation: two Newton steps of the polar
    decomposition, R <- R (3I - R^T R) / 2. Long float32 pose chains drift
    out of SO(3) otherwise, and `se3_inverse` assumes orthonormality."""
    eye = _eye(3, R, R.shape)
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = R @ (1.5 * eye - 0.5 * RtR)
    return R


def se3_project(T: torch.Tensor) -> torch.Tensor:
    """`so3_project` on the rotation block; translation untouched."""
    return rt_to_se3(so3_project(T[..., :3, :3]), T[..., :3, 3])


def add_front_se3(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-compose a tangent update: exp(xi) @ T."""
    return se3_exp(xi) @ T


def transform_points(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply SE3 to points: [..., 4, 4] x [..., N, 3] -> [..., N, 3]."""
    return X @ T[..., :3, :3].transpose(-1, -2) + T[..., :3, 3][..., None, :]


# ----------------------------------------------------------------------------
# Quaternions ([w, x, y, z])
# ----------------------------------------------------------------------------


