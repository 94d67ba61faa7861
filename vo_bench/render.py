"""The benchmark's frames: a corridor world rendered on the device from the seed.

A PyTorch copy of the program's numpy `io/synthetic.CorridorSequence`: the
same four walls and end cap, fronto-parallel panels every 3.5 m, mipmapped
trilinear texture sampling, the nearest plane in front by a z-buffer, and
`fit`'s margins around the trajectory. Geometry runs in float64 and texture
sampling in float32, as in the numpy renderer, so the two agree at a small
size (`tests/test_vo_bench_render.py`). What differs, and why:

- textures are drawn from the run's seed with a `torch.Generator` on the
  device, all planes of a kind in one call;
- panels farther ahead than `cull_m` (or behind the camera) are left out
  of a batch's z-buffer: a corridor of 1.6 km holds ~460 of them, and at
  `cull_m` = 150 m one is a few pixels wide near the vanishing point;
- the trajectory runs straight on average: the yaw rate oscillates, so the
  corridor fitted around a long run stays a corridor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

PANEL_STEP_M = 3.5


def trajectory(n: int, speed: float, yaw_rate: float, yaw_period: int, jitter: float,
               jitter_period: int, rng: np.random.Generator) -> np.ndarray:
    """[n, 4, 4] float64 camera-to-world poses in the corridor's frame (x
    right, y down, z forward). The heading oscillates with peak yaw rate
    `yaw_rate` rad/frame over `yaw_period` frames; the step length is
    `speed` m/frame times 1 + `jitter` sin(...). The two phases come from
    `rng`."""
    phase, jphase = rng.uniform(0.0, 2.0 * math.pi, 2)
    i = np.arange(n, dtype=np.float64)
    heading = -(yaw_rate * yaw_period / (2.0 * math.pi)) * np.cos(2.0 * math.pi * i / yaw_period + phase)
    step = speed * (1.0 + jitter * np.sin(2.0 * math.pi * i / jitter_period + jphase))
    fwd = np.stack([np.sin(heading), np.zeros(n), np.cos(heading)], axis=-1)
    pos = np.concatenate([np.zeros((1, 3)), np.cumsum(step[:-1, None] * fwd[:-1], axis=0)])
    pos[:, 0] -= 0.5 * (pos[:, 0].max() + pos[:, 0].min())  # centred between the walls
    c, s = np.cos(heading), np.sin(heading)
    T = np.zeros((n, 4, 4))
    T[:, 0, 0], T[:, 0, 2] = c, s
    T[:, 1, 1] = 1.0
    T[:, 2, 0], T[:, 2, 2] = -s, c
    T[:, :3, 3] = pos
    T[:, 3, 3] = 1.0
    return T


def smooth_textures(raw: torch.Tensor, smooth: int) -> torch.Tensor:
    """[P, n, n] raw textures smoothed `smooth` times by the numpy
    renderer's 3-tap box along rows, then columns (zero padded, 'same')."""
    k = torch.full((1, 1, 1, 3), 1.0 / 3.0, dtype=raw.dtype, device=raw.device)
    t = raw[:, None]
    for _ in range(smooth):
        t = F.conv2d(t, k, padding=(0, 1))
        t = F.conv2d(t, k.transpose(2, 3), padding=(1, 0))
    return t[:, 0]


def mip_levels(tex: torch.Tensor) -> list:
    """The numpy renderer's `_MipTex` levels of [n, n] `tex`."""
    levels = [tex.to(torch.float32)]
    t = levels[0]
    while t.shape[0] >= 16:
        t = 0.25 * (t[0::2, 0::2] + t[1::2, 0::2] + t[0::2, 1::2] + t[1::2, 1::2])
        levels.append(t)
    return levels


@dataclass
class Plane:
    A: torch.Tensor  # [3, 3] float64 columns e1, e2, origin
    levels: list  # mip levels, float32
    tex_scale: float
    extent: tuple | None  # (s0, s1, t0, t1) or None for an unbounded plane
    z: float | None  # a panel's depth along the corridor (None: always drawn)


def _st(Pinv: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Plane coordinates (s, t) of pixels (u, v) through inverse projections
    Pinv [..., 3, 3] broadcast against u and v."""
    ph = [Pinv[..., k, 0] * u + Pinv[..., k, 1] * v + Pinv[..., k, 2] for k in range(3)]
    w = torch.where(torch.abs(ph[2]) < 1e-12, 1e-12, ph[2])
    return ph[0] / w, ph[1] / w


class _Atlas:
    """Every plane's mip levels in one flat tensor, with each (plane, level)'s
    offset, side and texture scale, so that one pass shades every pixel."""

    def __init__(self, planes: list, device):
        L = max(len(pl.levels) for pl in planes)
        off = np.zeros((len(planes), L), np.int64)
        side = np.full((len(planes), L), 2, np.int64)
        scale = np.ones((len(planes), L))
        flat, pos = [], 0
        for p, pl in enumerate(planes):
            for k, t in enumerate(pl.levels):
                off[p, k], side[p, k], scale[p, k] = pos, t.shape[0], pl.tex_scale / (1 << k)
                flat.append(t.reshape(-1))
                pos += t.numel()
        self.flat = torch.cat(flat).to(device)
        self.off = torch.as_tensor(off, device=device)
        self.side = torch.as_tensor(side, device=device)
        self.scale = torch.as_tensor(scale, device=device)
        self.levels = torch.as_tensor([len(pl.levels) for pl in planes], dtype=torch.float64, device=device)
        self.tex_scale = torch.as_tensor([pl.tex_scale for pl in planes], dtype=torch.float64, device=device)

    def sample(self, p: torch.Tensor, k: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Bilinear sample of a wrapping texture (`_sample_tex_wrap`) of plane
        p at mip level k, per point."""
        n, off, scale = self.side[p, k], self.off[p, k], self.scale[p, k]
        ts = torch.remainder(s * scale, n - 1)
        tt = torch.remainder(t * scale, n - 1)
        i0 = torch.minimum(torch.clamp(torch.floor(ts), min=0).to(torch.int64), n - 2)
        j0 = torch.minimum(torch.clamp(torch.floor(tt), min=0).to(torch.int64), n - 2)
        fi = (ts - i0).to(torch.float32)
        fj = (tt - j0).to(torch.float32)
        base = off + j0 * n + i0
        a, b = self.flat[base], self.flat[base + 1]
        c, d = self.flat[base + n], self.flat[base + n + 1]
        return a * (1 - fi) * (1 - fj) + b * fi * (1 - fj) + c * (1 - fi) * fj + d * fi * fj

    def shade(self, p: torch.Tensor, Pinv: torch.Tensor, x: torch.Tensor, y: torch.Tensor, W: int,
              H: int) -> torch.Tensor:
        """Trilinear minification filtering (`_MipTex.sample`) at pixels
        (x, y) of planes p, each through its own Pinv [n, 3, 3]. The texel
        footprint is numpy.gradient of (s, t) x tex_scale over the pixel grid
        (central inside, one-sided at the border), from the neighbouring
        pixels' (s, t)."""
        f64 = torch.float64
        xl, xr = torch.clamp(x - 1, min=0), torch.clamp(x + 1, max=W - 1)
        yl, yr = torch.clamp(y - 1, min=0), torch.clamp(y + 1, max=H - 1)
        X, Y = x.to(f64), y.to(f64)
        s, t = _st(Pinv, X, Y)
        sxr, txr = _st(Pinv, xr.to(f64), Y)
        sxl, txl = _st(Pinv, xl.to(f64), Y)
        syr, tyr = _st(Pinv, X, yr.to(f64))
        syl, tyl = _st(Pinv, X, yl.to(f64))
        c = self.tex_scale[p]
        dx, dy = (xr - xl).to(f64), (yr - yl).to(f64)
        du = torch.abs((sxr * c - sxl * c) / dx) + torch.abs((syr * c - syl * c) / dy)
        dv = torch.abs((txr * c - txl * c) / dx) + torch.abs((tyr * c - tyl * c) / dy)
        foot = torch.clamp(torch.maximum(du, dv), min=1e-6)
        top = self.levels[p] - 1.0
        lvl = torch.minimum(torch.clamp(torch.log2(foot), min=0.0), top)
        l0 = torch.floor(lvl).to(torch.int64)
        frac = (lvl - l0).to(torch.float32)
        l1 = torch.minimum(l0 + 1, top.to(torch.int64))
        return (1.0 - frac) * self.sample(p, l0, s, t) + frac * self.sample(p, l1, s, t)


class CorridorRenderer:
    """Renders grey frames of a corridor's planes for a pinhole camera at
    width x height, on `device`: a depth pass per plane over the pixels it
    can cover, then one texture sample per pixel, from the plane in front."""

    def __init__(self, planes: list, fx, fy, cx, cy, width: int, height: int, device,
                 cull_m: float = 150.0):
        self.planes = planes
        self.A_np = [pl.A.cpu().numpy() for pl in planes]
        self.atlas = _Atlas(planes, device)
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=torch.float64, device=device)
        self.width, self.height = width, height
        self.device = torch.device(device)
        self.cull_m = cull_m
        self.u = torch.arange(width, dtype=torch.float64, device=device)[None, None, :]
        self.v = torch.arange(height, dtype=torch.float64, device=device)[None, :, None]

    def _box(self, p: int, pl: Plane, T_cw: np.ndarray):
        """The pixel rectangle (x0, x1, y0, y1) that a plane can cover in any
        frame of the batch: the whole frame for an unbounded plane or where a
        corner lies behind a camera, None where it is off every frame."""
        W, H = self.width, self.height
        if pl.extent is None:
            return 0, W, 0, H
        s0, s1, t0, t1 = pl.extent
        C = np.array([[s0, t0, 1.0], [s1, t0, 1.0], [s0, t1, 1.0], [s1, t1, 1.0]]) @ self.A_np[p].T
        Xc = np.einsum("bij,kj->bki", T_cw[:, :3, :3], C) + T_cw[:, None, :3, 3]
        if (Xc[..., 2] <= 0.05).any():
            return 0, W, 0, H
        u = Xc[..., 0] / Xc[..., 2] * self.fx + self.cx
        v = Xc[..., 1] / Xc[..., 2] * self.fy + self.cy
        x0, x1 = max(0, int(np.floor(u.min())) - 1), min(W, int(np.ceil(u.max())) + 2)
        y0, y1 = max(0, int(np.floor(v.min())) - 1), min(H, int(np.ceil(v.max())) + 2)
        if x0 >= x1 or y0 >= y1:
            return None
        return x0, x1, y0, y1

    def render(self, T_cw: torch.Tensor, cam_z: torch.Tensor) -> torch.Tensor:
        """[B, H, W] float32 frames for world-to-camera poses T_cw [B, 4, 4]
        (float64); cam_z [B] the cameras' positions along the corridor, which
        choose the panels drawn. Raises where a pixel sees no plane in front."""
        B, W, H = T_cw.shape[0], self.width, self.height
        R, tv = T_cw[:, :3, :3], T_cw[:, :3, 3]
        T_np = T_cw.cpu().numpy()
        z_lo, z_hi = float(cam_z.min()) - 2.0, float(cam_z.max()) + self.cull_m
        best_z = torch.full((B, H, W), math.inf, dtype=torch.float64, device=self.device)
        best_p = torch.full((B, H, W), -1, dtype=torch.int32, device=self.device)
        e3 = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=self.device)
        r2 = R[:, 2, :]
        Pinv_all = torch.zeros((B, len(self.planes), 3, 3), dtype=torch.float64, device=self.device)
        for p, pl in enumerate(self.planes):
            if pl.z is not None and not z_lo <= pl.z <= z_hi:
                continue
            box = self._box(p, pl, T_np)
            if box is None:
                continue
            x0, x1, y0, y1 = box
            Pinv = torch.linalg.inv(self.K @ (R @ pl.A + tv[:, :, None] * e3[None, None, :]))
            s, t = _st(Pinv[:, None, None], self.u[..., x0:x1], self.v[:, y0:y1])
            origin, e1, e2 = pl.A[:, 2], pl.A[:, 0], pl.A[:, 1]
            # Camera-frame z of the intersection: row 2 of R applied to X(s, t), plus t_z.
            depth = ((r2 @ origin)[:, None, None] + s * (r2 @ e1)[:, None, None]
                     + t * (r2 @ e2)[:, None, None] + tv[:, 2, None, None])
            if pl.extent is not None:
                s0, s1, t0, t1 = pl.extent
                depth = torch.where((s >= s0) & (s <= s1) & (t >= t0) & (t <= t1), depth, -1.0)
            z = torch.where(depth > 0.05, depth, math.inf)
            bz, bp = best_z[:, y0:y1, x0:x1], best_p[:, y0:y1, x0:x1]
            take = z < bz  # strict: on a tie the earlier plane stays, as numpy's argmin keeps it
            bz.copy_(torch.where(take, z, bz))
            bp.copy_(torch.where(take, p, bp))
            Pinv_all[:, p] = Pinv
        n_bad = int((best_p < 0).sum())
        if n_bad:
            raise ValueError(f"{n_bad} pixels see no plane in front: a camera left the corridor")
        flat_p = best_p.reshape(-1).to(torch.int64)
        pix = torch.arange(B * H * W, device=self.device)
        b, rest = pix // (H * W), pix % (H * W)
        img = self.atlas.shade(flat_p, Pinv_all[b, flat_p], rest % W, rest // W, W, H)
        return img.reshape(B, H, W)


def _plane(origin, e1, e2, tex, tex_scale, extent=None, z=None, device="cpu") -> Plane:
    A = torch.tensor(np.stack([e1, e2, origin], axis=1), dtype=torch.float64, device=device)
    return Plane(A, mip_levels(tex), float(tex_scale), extent, z)


def corridor_geometry(poses_T_wc: np.ndarray, wall_m: float = 3.5, floor_m: float = 1.6,
                      ceiling_m: float = 2.6) -> dict:
    """`CorridorSequence.fit`'s box around the trajectory: walls `wall_m`
    beyond the widest pose, the floor `floor_m` below and the ceiling
    `ceiling_m` above the camera (the defaults are `fit`'s margins)."""
    p = poses_T_wc[:, :3, 3]
    return dict(half_width=float(np.max(np.abs(p[:, 0]))) + wall_m, floor_y=float(np.max(p[:, 1])) + floor_m,
                ceil_y=float(-np.min(p[:, 1])) + ceiling_m, length=float(np.max(p[:, 2])) + 25.0)


def panel_layout(half_width: float, length: float) -> list:
    """(origin, z) of each fronto-parallel panel, as `CorridorSequence` places them."""
    out, z_p, k = [], 5.0, 0
    while z_p < length - 10.0:
        side = -1.0 if k % 2 == 0 else 1.0
        inset = 0.45 + 0.35 * ((k * 2654435761) % 3)
        x_c = side * (half_width - inset)
        out.append(([x_c - 0.65, -0.85, z_p], z_p))
        z_p += PANEL_STEP_M
        k += 1
    return out


def build_planes(geom: dict, textures: dict, world: dict, device) -> list:
    """The corridor's planes in the numpy renderer's order: left, right,
    floor, ceiling, end cap, then the panels. textures: "left", "right",
    "floor", "ceiling", "end" [n, n] and "panels" [P, m, m]."""
    hw, fy, cy, L = geom["half_width"], geom["floor_y"], geom["ceil_y"], geom["length"]
    ws, ts, ps = world["wall_tex_scale"], world["tex_scale"], world["panel_tex_scale"]
    planes = [
        _plane([-hw, 0, 0], [0, 0, 1], [0, 1, 0], textures["left"], ws, device=device),
        _plane([hw, 0, 0], [0, 0, 1], [0, 1, 0], textures["right"], ws, device=device),
        _plane([0, fy, 0], [1, 0, 0], [0, 0, 1], textures["floor"], ts, device=device),
        _plane([0, -cy, 0], [1, 0, 0], [0, 0, 1], textures["ceiling"], ts, device=device),
        _plane([0, 0, L], [1, 0, 0], [0, 1, 0], textures["end"], ts, device=device),
    ]
    for k, (origin, z) in enumerate(panel_layout(hw, L)):
        planes.append(_plane(origin, [1, 0, 0], [0, 1, 0], textures["panels"][k], ps,
                             extent=(0.0, 1.3, 0.0, 1.4), z=z, device=device))
    return planes


def seeded_textures(geom: dict, world: dict, gen: torch.Generator, device) -> dict:
    """Every plane's texture from `gen`, uniform in [30, 220) and smoothed as
    the numpy renderer smooths its own: one draw for the walls, one for
    floor, ceiling and end cap, one for all panels."""
    n_pan = len(panel_layout(geom["half_width"], geom["length"]))

    def draw(count, size, smooth):
        raw = torch.rand((count, size, size), generator=gen, device=device, dtype=torch.float32)
        return smooth_textures(30.0 + 190.0 * raw, smooth)

    walls = draw(2, world["wall_tex_size"], world["smooth"])
    rest = draw(3, world["tex_size"], world["smooth"])
    panels = draw(max(n_pan, 1), world["panel_tex_size"], world["panel_smooth"])
    return dict(left=walls[0], right=walls[1], floor=rest[0], ceiling=rest[1], end=rest[2], panels=panels)


def se3_inv(T: np.ndarray) -> np.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros_like(T)
    out[..., :3, :3] = np.swapaxes(R, -1, -2)
    out[..., :3, 3] = -np.einsum("...ji,...j->...i", R, t)
    out[..., 3, 3] = 1.0
    return out
