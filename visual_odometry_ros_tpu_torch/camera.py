"""Pinhole + radial-tangential camera model and stereo rectification.

Counterpart of `visual_odometry_ros_tpu/camera.py`, function for function:
radtan distortion and its fixed-point inverse, projection helpers, image
undistortion maps, the mid-rotation stereo rectification (rectified
f = (fx_l + fx_r) / 2, principal point at the image centre, identity
rectified rotation) and the remap that applies it.

Cameras hold their intrinsics as 0-d float32 tensors on one device, so the
remap grids are built once, on that device, and every frame's rectification
is two gathers there. `remap` goes through `utils/interp.bilinear_sample`
(mask -> 0, and its clamp of the integer index to W-2), never
`F.grid_sample`, so rectified images agree with the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from .utils import geometry as geo
from .utils.interp import bilinear_sample


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. dist = [k1, k2, p1, p2, k3] (OpenCV order)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor
    width: int
    height: int

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])

    @property
    def has_distortion(self) -> bool:
        return True  # as the reference: callers decide from `dist` if needed


def make_camera(fx, fy, cx, cy, dist=None, width=0, height=0, device="cpu") -> Camera:
    dist = torch.zeros(5, dtype=torch.float32) if dist is None else dist
    return Camera(
        fx=_f32(fx, device), fy=_f32(fy, device), cx=_f32(cx, device), cy=_f32(cy, device),
        dist=_f32(dist, device), width=int(width), height=int(height),
    )


# ----------------------------------------------------------------------------
# Distortion model
# ----------------------------------------------------------------------------


def distort_normalized(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coordinates [..., 2]."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    xx, yy = x * x, y * y
    xy2 = 2.0 * x * y
    r2 = xx + yy
    r4 = r2 * r2
    r6 = r4 * r2
    radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * xx)
    yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * yy)
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: Camera, xd: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Invert the distortion by a fixed number of fixed-point steps."""
    xn = xd
    for _ in range(iters):
        xn = xd - (distort_normalized(cam, xn) - xn)
    return xn


# ----------------------------------------------------------------------------
# Projection
# ----------------------------------------------------------------------------


def project_to_pixel(cam: Camera, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2] (no distortion)."""
    z = X[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return torch.stack([X[..., 0] * inv_z * cam.fx + cam.cx, X[..., 1] * inv_z * cam.fy + cam.cy], dim=-1)


def pixel_to_normalized(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> normalized coordinates."""
    return torch.stack([(p[..., 0] - cam.cx) / cam.fx, (p[..., 1] - cam.cy) / cam.fy], dim=-1)


def in_image(cam: Camera, p: torch.Tensor, border: float = 3.0) -> torch.Tensor:
    """Validity mask with a border."""
    u, v = p[..., 0], p[..., 1]
    return (u >= border) & (v >= border) & (u < cam.width - border) & (v < cam.height - border)


def undistort_pixels(cam: Camera, p: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Distorted pixel coordinates -> undistorted pixel coordinates (same K)."""
    xn = undistort_normalized(cam, pixel_to_normalized(cam, p), iters)
    return torch.stack([xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], dim=-1)


# ----------------------------------------------------------------------------
# Undistortion / rectification maps (built once, on the cameras' device)
# ----------------------------------------------------------------------------


def _pixel_grid(width: int, height: int, device) -> torch.Tensor:
    u = torch.arange(width, dtype=torch.float32, device=device)
    v = torch.arange(height, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # [H, W]
    return torch.stack([uu, vv], dim=-1)  # [H, W, 2]


def image_undistort_maps(cam: Camera) -> torch.Tensor:
    """For each undistorted output pixel, the distorted source coordinates [H, W, 2]."""
    xn = pixel_to_normalized(cam, _pixel_grid(cam.width, cam.height, cam.fx.device))
    xd = distort_normalized(cam, xn)
    return torch.stack([xd[..., 0] * cam.fx + cam.cx, xd[..., 1] * cam.fy + cam.cy], dim=-1)


def remap(img: torch.Tensor, map_uv: torch.Tensor) -> torch.Tensor:
    """Bilinear remap: img [H, W], map_uv [H, W, 2]; outside the image -> 0."""
    vals, mask = bilinear_sample(img, map_uv)
    return torch.where(mask, vals, 0.0)


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Stereo pair + rectification products.

    rect: the rectified pinhole camera shared by both views.
    T_lr_rect: rectified extrinsics (identity rotation, baseline translation).
    map_left/map_right: [H, W, 2] remap grids (rectified pixel -> raw source).
    """

    left: Camera
    right: Camera
    T_lr: torch.Tensor
    rect: Camera
    T_lr_rect: torch.Tensor
    map_left: torch.Tensor
    map_right: torch.Tensor

    @property
    def baseline(self) -> torch.Tensor:
        return torch.linalg.norm(self.T_lr_rect[:3, 3])


def make_stereo_camera(left: Camera, right: Camera, T_lr) -> StereoCamera:
    """Rectification: x-axis along the baseline, z-axis the mean optical axis
    re-orthogonalised; rectified K with f = (fx_l + fx_r) / 2 and principal
    point at the image centre; remap grids push rectified rays through each
    raw camera's rotation and distortion model."""
    dev = left.fx.device
    T_lr = _f32(T_lr, dev)
    R_0r = T_lr[:3, :3]
    t_0r = T_lr[:3, 3]

    k_l = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
    k_r = R_0r[:, 2]
    k_n = (k_l + k_r) * 0.5
    k_n = k_n / torch.linalg.norm(k_n)
    i_n = t_0r / torch.linalg.norm(t_0r)
    j_n = torch.linalg.cross(k_n, i_n)
    j_n = j_n / torch.linalg.norm(j_n)
    k_n = torch.linalg.cross(i_n, j_n)
    k_n = k_n / torch.linalg.norm(k_n)
    R_0n = torch.stack([i_n, j_n, k_n], dim=1)  # left (= world 0) -> rectified

    f_n = (left.fx + right.fx) * 0.5
    rect = Camera(
        fx=f_n, fy=f_n, cx=_f32(left.width * 0.5, dev), cy=_f32(left.height * 0.5, dev),
        dist=torch.zeros(5, dtype=torch.float32, device=dev), width=left.width, height=left.height,
    )

    xn_rect = pixel_to_normalized(rect, _pixel_grid(left.width, left.height, dev))  # [H, W, 2]
    rays = torch.cat([xn_rect, torch.ones_like(xn_rect[..., :1])], dim=-1)  # [H, W, 3]
    P0 = rays @ R_0n.T  # rectified ray expressed in the left frame

    def raw_map(cam: Camera, R_c0: torch.Tensor) -> torch.Tensor:
        xc = P0 @ R_c0.T
        xd = distort_normalized(cam, xc[..., :2] / xc[..., 2:3])
        return torch.stack([xd[..., 0] * cam.fx + cam.cx, xd[..., 1] * cam.fy + cam.cy], dim=-1)

    map_left = raw_map(left, torch.eye(3, dtype=torch.float32, device=dev))
    map_right = raw_map(right, R_0r.T)

    # Rectified extrinsics: identity rotation, baseline in the rectified frame.
    T_lr_rect = geo.rt_to_se3(torch.eye(3, dtype=torch.float32, device=dev), R_0n.T @ t_0r)
    return StereoCamera(left=left, right=right, T_lr=T_lr, rect=rect, T_lr_rect=T_lr_rect,
                        map_left=map_left, map_right=map_right)


def rectify_stereo_images(stereo: StereoCamera, img_left: torch.Tensor, img_right: torch.Tensor):
    """Remap both raw images into the rectified frame."""
    return remap(img_left, stereo.map_left), remap(img_right, stereo.map_right)
