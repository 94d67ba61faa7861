"""Pinhole camera: intrinsics as 0-d float32 tensors on one device, and the
projection helpers the pipelines use. The reference takes rectified,
undistorted frames only, so it holds no distortion or rectification code."""

from __future__ import annotations

import dataclasses

import torch


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int


def make_camera(fx, fy, cx, cy, width=0, height=0, device="cpu") -> Camera:
    return Camera(fx=_f32(fx, device), fy=_f32(fy, device), cx=_f32(cx, device), cy=_f32(cy, device),
                  width=int(width), height=int(height))


def project_to_pixel(cam: Camera, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2]."""
    z = X[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return torch.stack([X[..., 0] * inv_z * cam.fx + cam.cx, X[..., 1] * inv_z * cam.fy + cam.cy], dim=-1)


def pixel_to_normalized(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> normalized coordinates."""
    return torch.stack([(p[..., 0] - cam.cx) / cam.fx, (p[..., 1] - cam.cy) / cam.fy], dim=-1)
