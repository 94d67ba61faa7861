"""Synthetic stereo/mono sequence renderer with exact ground truth.

The reference validates system-level behavior on KITTI rosbags (SURVEY.md §4);
for hermetic CI we additionally need sequences with analytic ground truth. A
slanted textured plane is rendered through each camera by a plane-induced
homography — giving smoothly varying depth (non-degenerate for BA), exact
poses, and exact depth maps, with no dataset dependency.
"""

from __future__ import annotations

import numpy as np


class ChiralityError(ValueError):
    """Raised when a synthetic render would show behind-camera geometry.

    A camera driven *through* its scene planes would otherwise get
    geometrically-invalid images without complaint, and the pipeline would
    be silently evaluated on garbage. Every renderer fails loudly instead.
    """


def _smooth_texture(rng, tex_size, smooth):
    tex = rng.uniform(30.0, 220.0, (tex_size, tex_size)).astype(np.float32)
    k = np.ones(3, np.float32) / 3
    for _ in range(smooth):
        tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
        tex = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, tex)
    return tex


def _sample_tex_wrap(tex, s, t, tex_scale):
    """Bilinear sample of a wrapping texture at plane coords (s, t)."""
    n = tex.shape[0]
    ts = (s * tex_scale) % (n - 1)
    tt = (t * tex_scale) % (n - 1)
    i0 = np.clip(np.floor(ts).astype(int), 0, n - 2)
    j0 = np.clip(np.floor(tt).astype(int), 0, n - 2)
    fi = (ts - i0).astype(np.float32)
    fj = (tt - j0).astype(np.float32)
    return (
        tex[j0, i0] * (1 - fi) * (1 - fj)
        + tex[j0, i0 + 1] * fi * (1 - fj)
        + tex[j0 + 1, i0] * (1 - fi) * fj
        + tex[j0 + 1, i0 + 1] * fi * fj
    ).astype(np.float32)


class _MipTex:
    """Mipmapped wrapping texture with trilinear minification filtering.

    Point-sampled textures alias badly under minification (far geometry,
    grazing incidence): the per-pixel value decorrelates between frames,
    breaking brightness constancy for reasons that have nothing to do with
    the scene. Measured on the r2 accuracy world: the un-mipped renderer
    alone caused 13/30 pose failures with all adversities OFF; mip filtering
    removes them entirely. Every plane renderer samples through this.
    """

    def __init__(self, tex: np.ndarray):
        self.levels = [tex.astype(np.float32)]
        t = self.levels[0]
        while t.shape[0] >= 16:
            t = 0.25 * (t[0::2, 0::2] + t[1::2, 0::2] + t[0::2, 1::2] + t[1::2, 1::2])
            self.levels.append(t)

    def sample(self, s, t, tex_scale):
        ts = s * tex_scale
        tt = t * tex_scale
        # Texel footprint of one output pixel (forward-difference Jacobian).
        du = np.abs(np.gradient(ts, axis=-1)) + np.abs(np.gradient(ts, axis=-2))
        dv = np.abs(np.gradient(tt, axis=-1)) + np.abs(np.gradient(tt, axis=-2))
        foot = np.maximum(np.maximum(du, dv), 1e-6)
        L = len(self.levels)
        lvl = np.clip(np.log2(foot), 0.0, L - 1.0)
        l0 = np.floor(lvl).astype(int)
        frac = (lvl - l0).astype(np.float32)
        l1 = np.minimum(l0 + 1, L - 1)
        out = np.zeros(s.shape, np.float32)
        for k in range(L):
            m0 = l0 == k
            m1 = l1 == k
            if m0.any():
                out[m0] += (1.0 - frac[m0]) * _sample_tex_wrap(
                    self.levels[k], s[m0], t[m0], tex_scale / (1 << k)
                )
            if m1.any():
                out[m1] += frac[m1] * _sample_tex_wrap(
                    self.levels[k], s[m1], t[m1], tex_scale / (1 << k)
                )
        return out


class Plane:
    """One textured plane X(s, t) = origin + e1*s + e2*t (world coords).

    `extent=(s0, s1, t0, t1)` bounds the plane to a rectangle in its own
    (s, t) coords — outside it the intersection reports depth -1 (invalid),
    so the z-buffer compositor simply doesn't see it. Bounded planes model
    fronto-parallel scene furniture (signs, doorways, crates) mounted inside
    an enclosing box world."""

    def __init__(
        self, origin, e1, e2, seed=3, tex_size=512, tex_scale=60.0, smooth=2, extent=None
    ):
        self.origin = np.asarray(origin, np.float64)
        self.e1 = np.asarray(e1, np.float64)
        self.e2 = np.asarray(e2, np.float64)
        # Columns map [s, t, 1] -> world point.
        self.A = np.stack([self.e1, self.e2, self.origin], axis=1)
        self.tex = _MipTex(_smooth_texture(np.random.default_rng(seed), tex_size, smooth))
        self.tex_scale = tex_scale
        self.extent = extent

    def intersect(self, K, T_cw, uu, vv):
        """Per-pixel ray/plane intersection.

        Returns (img values, depth) where depth is the camera-frame z of the
        intersection (negative = behind the camera; the caller z-buffers).
        """
        R = T_cw[:3, :3].astype(np.float64)
        t = T_cw[:3, 3].astype(np.float64)
        P = K @ (R @ self.A + t[:, None] @ np.array([[0.0, 0.0, 1.0]]))
        ph = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ np.linalg.inv(P).T
        w = ph[..., 2]
        w_safe = np.where(np.abs(w) < 1e-12, 1e-12, w)
        s = ph[..., 0] / w_safe
        tt = ph[..., 1] / w_safe
        Xw = self.origin + s[..., None] * self.e1 + tt[..., None] * self.e2
        depth = Xw @ R[2] + t[2]
        if self.extent is not None:
            s0, s1, t0, t1 = self.extent
            inside = (s >= s0) & (s <= s1) & (tt >= t0) & (tt <= t1)
            depth = np.where(inside, depth, -1.0)
        img = self.tex.sample(s, tt, self.tex_scale)
        return img, depth


class CorridorSequence:
    """Box-corridor world: four walls + end cap, z-buffer composited.

    A single-plane world sits a fixed distance ahead, and a 40 m trajectory
    drives through it. A corridor encloses the whole trajectory: side walls and
    floor/ceiling give near-field structure at the image edges, the end wall
    far-field structure at the center — the depth profile of a real driving
    corridor (the reference's KITTI validation scenes). Rays that escape the
    box (camera outside, or past the end wall) raise ChiralityError instead
    of rendering garbage.

    Geometry is in the first camera's frame (x right, y down, z forward):
    walls at x = ±half_width, floor at y = +floor_y, ceiling at y = -ceil_y,
    end cap at z = length.
    """

    def __init__(
        self,
        width=640,
        height=480,
        fx=500.0,
        fy=500.0,
        cx=320.0,
        cy=240.0,
        baseline=0.5,
        half_width=4.0,
        floor_y=1.6,
        ceil_y=2.6,
        length=90.0,
        tex_size=1024,
        tex_scale=25.0,
        wall_tex_size=None,
        wall_tex_scale=None,
        smooth=2,
    ):
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.baseline = baseline
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        self.T_lr = np.eye(4, dtype=np.float32)
        self.T_lr[0, 3] = baseline
        # Side walls may carry a different (e.g. small, repeating) texture
        # than the floor/ceiling/end cap — building facades repeat, roads
        # don't; a phase-perfect wallpaper over the WHOLE far field would be
        # an aliasing trap no real scene exhibits.
        kw = dict(tex_size=tex_size, tex_scale=tex_scale, smooth=smooth)
        wkw = dict(
            tex_size=wall_tex_size or tex_size,
            tex_scale=wall_tex_scale or tex_scale,
            smooth=smooth,
        )
        self.planes = [
            Plane([-half_width, 0, 0], [0, 0, 1], [0, 1, 0], seed=3, **wkw),  # left wall
            Plane([half_width, 0, 0], [0, 0, 1], [0, 1, 0], seed=11, **wkw),  # right wall
            Plane([0, floor_y, 0], [1, 0, 0], [0, 0, 1], seed=7, **kw),  # floor
            Plane([0, -ceil_y, 0], [1, 0, 0], [0, 0, 1], seed=19, **kw),  # ceiling
            Plane([0, 0, length], [1, 0, 0], [0, 1, 0], seed=23, **kw),  # end cap
        ]
        # Fronto-parallel panels (signs / doorways / crates) staggered along
        # the corridor. A bare box world is a stereo worst case no real scene
        # exhibits: EVERY visible surface at grazing incidence except one
        # far-away end cap, so subpixel disparity is ill-posed everywhere
        # near (measured: coherent 5-20% depth bias on floor/wall births —
        # the r3 adversarial-run collapse). KITTI-like scenes are full of
        # fronto-parallel structure (facades, vehicles, signs); these panels
        # restore that while keeping the grazing surfaces, the repeated wall
        # texture, and every HardSequence adversity in place.
        z_p, k = 5.0, 0
        while z_p < length - 10.0:
            side = -1.0 if k % 2 == 0 else 1.0
            inset = 0.45 + 0.35 * ((k * 2654435761) % 3)  # 0.45/0.80/1.15 m
            x_c = side * (half_width - inset)
            self.planes.append(
                Plane(
                    [x_c - 0.65, -0.85, z_p],
                    [1, 0, 0],
                    [0, 1, 0],
                    seed=101 + k,
                    tex_size=128,
                    tex_scale=85.0,
                    smooth=1,
                    extent=(0.0, 1.3, 0.0, 1.4),
                )
            )
            z_p += 3.5
            k += 1
        self.extent = dict(half_width=half_width, floor_y=floor_y, ceil_y=ceil_y, length=length)
        self._grid = np.meshgrid(
            np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64)
        )

    @classmethod
    def fit(cls, poses_T_wc, margin_side=3.5, margin_floor=1.6, margin_ceil=2.6, margin_end=25.0, **kw):
        """Size a corridor around a trajectory so no pose exits the box."""
        p = np.asarray(poses_T_wc)[:, :3, 3]
        return cls(
            half_width=float(np.max(np.abs(p[:, 0]))) + margin_side,
            floor_y=float(np.max(p[:, 1])) + margin_floor,
            ceil_y=float(-np.min(p[:, 1])) + margin_ceil,
            length=float(np.max(p[:, 2])) + margin_end,
            **kw,
        )

    def _raster(self, T_cw, pix=None):
        if pix is not None:
            uu, vv = pix[..., 0].astype(np.float64), pix[..., 1].astype(np.float64)
        else:
            uu, vv = self._grid
        imgs, depths = [], []
        for pl in self.planes:
            img, depth = pl.intersect(self.K, T_cw, uu, vv)
            imgs.append(img)
            depths.append(depth)
        depths = np.stack(depths)  # [P, H, W]
        imgs = np.stack(imgs)
        valid = depths > 0.05
        z = np.where(valid, depths, np.inf)
        sel = np.argmin(z, axis=0)  # nearest plane in front
        covered = np.any(valid, axis=0)
        if not covered.all():
            n_bad = int((~covered).sum())
            raise ChiralityError(
                f"{n_bad} pixels see no in-front geometry — camera left the corridor "
                f"(extent {self.extent}); the harness world is invalid for this pose"
            )
        take = np.take_along_axis
        img = take(imgs, sel[None], axis=0)[0]
        dep = take(depths, sel[None], axis=0)[0]
        return img.astype(np.float32), dep.astype(np.float32)

    def render(self, T_cw: np.ndarray, pix: np.ndarray | None = None) -> np.ndarray:
        return self._raster(T_cw, pix)[0]

    def depth(self, T_cw: np.ndarray) -> np.ndarray:
        return self._raster(T_cw)[1]

    def stereo_pair(self, T_wc: np.ndarray):
        T_cw_l = np.linalg.inv(T_wc)
        T_cw_r = np.linalg.inv(T_wc @ self.T_lr.astype(np.float64))
        return self.render(T_cw_l), self.render(T_cw_r)


class PlaneSequence:
    """Textured slanted-plane world rendered for a moving stereo rig.

    World: plane through (0, 0, z0) spanned by (1, 0, sx) and (0, 1, sy) —
    depth varies across the image. Texture is smooth random noise (trackable).
    """

    def __init__(
        self,
        width=640,
        height=480,
        fx=500.0,
        fy=500.0,
        cx=320.0,
        cy=240.0,
        baseline=0.5,
        z0=12.0,
        sx=0.25,
        sy=0.12,
        tex_size=4096,
        tex_scale=140.0,  # texture pixels per world unit
        seed=3,
        smooth=2,
    ):
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.baseline = baseline
        self.tex = _MipTex(_smooth_texture(np.random.default_rng(seed), tex_size, smooth))
        self.tex_size = tex_size
        self.tex_scale = tex_scale
        # Plane: X(s, t) = [s, t, z0 + sx*s + sy*t]
        self.z0, self.sx, self.sy = z0, sx, sy
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        self.T_lr = np.eye(4, dtype=np.float32)
        self.T_lr[0, 3] = baseline

    def _homography_cam_from_plane(self, T_cw: np.ndarray) -> np.ndarray:
        """H mapping plane coords (s, t, 1) -> pixel homogeneous coords."""
        R = T_cw[:3, :3].astype(np.float64)
        t = T_cw[:3, 3].astype(np.float64)
        # X_w = A @ [s, t, 1] with A columns: d(X)/ds, d(X)/dt, X(0,0)
        A = np.array(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [self.sx, self.sy, self.z0]], np.float64
        )
        P = self.K @ (R @ A + t[:, None] @ np.array([[0.0, 0.0, 1.0]]))
        return P

    def render(
        self,
        T_cw: np.ndarray,
        pix: np.ndarray | None = None,
        check_mask: np.ndarray | None = None,
    ) -> np.ndarray:
        """Render the plane seen from camera pose T_cw (world->cam).

        pix: optional [H, W, 2] ideal-pinhole pixel coords to evaluate instead
        of the regular grid — lets wrappers render through distorted lenses by
        passing the undistorted location of each output pixel (the plane
        texture is continuous, so off-frame ideal coords are fine).
        check_mask: optional bool [H, W] restricting the chirality guard to
        the pixels a compositing wrapper will actually use.

        Raises ChiralityError if any (checked) pixel's plane intersection
        lies behind the camera — see ChiralityError for why this is loud.
        """
        H = self._homography_cam_from_plane(T_cw)
        Hinv = np.linalg.inv(H)
        if pix is not None:
            uu, vv = pix[..., 0].astype(np.float64), pix[..., 1].astype(np.float64)
        else:
            uu, vv = np.meshgrid(
                np.arange(self.width, dtype=np.float64), np.arange(self.height, dtype=np.float64)
            )
        ph = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ Hinv.T
        s = ph[..., 0] / ph[..., 2]
        t = ph[..., 1] / ph[..., 2]
        # Chirality guard: camera-frame depth of every rendered plane point.
        Xw = np.stack([s, t, self.z0 + self.sx * s + self.sy * t], axis=-1)
        depth = Xw @ T_cw[:3, 2].astype(np.float64) + float(T_cw[2, 3])
        bad = depth <= 0.05
        if check_mask is not None:
            bad = bad & check_mask
        if bad.any():
            raise ChiralityError(
                f"{int(bad.sum())} pixels intersect the plane behind the camera "
                f"(z0={self.z0}); the pose has left the valid viewing volume"
            )
        # Plane coords -> texture, through the minification-filtered sampler.
        return self.tex.sample(s, t, self.tex_scale)

    def depth(self, T_cw: np.ndarray) -> np.ndarray:
        """Exact depth map for pose T_cw (for oracle checks)."""
        H = self._homography_cam_from_plane(T_cw)
        Hinv = np.linalg.inv(H)
        uu, vv = np.meshgrid(
            np.arange(self.width, dtype=np.float64), np.arange(self.height, dtype=np.float64)
        )
        ph = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ Hinv.T
        s = ph[..., 0] / ph[..., 2]
        t = ph[..., 1] / ph[..., 2]
        Xw = np.stack([s, t, self.z0 + self.sx * s + self.sy * t], axis=-1)
        R = T_cw[:3, :3].astype(np.float64)
        tvec = T_cw[:3, 3].astype(np.float64)
        Xc = Xw @ R.T + tvec
        return Xc[..., 2].astype(np.float32)

    def stereo_pair(self, T_wc: np.ndarray):
        """(left, right) images for left-cam pose T_wc (cam->world).

        T_lr is the pose of the right camera in the left frame (reference
        convention), so the right camera's world pose is T_wc @ T_lr.
        """
        T_cw_l = np.linalg.inv(T_wc)
        T_cw_r = np.linalg.inv(T_wc @ self.T_lr.astype(np.float64))
        return self.render(T_cw_l), self.render(T_cw_r)


class TwoPlaneSequence:
    """Split-screen composite of two planes at different depths/slopes.

    A single plane is the degenerate configuration for essential-matrix
    initialization (plane-induced homography ambiguity) — mono bootstrap
    needs non-planar structure, so the left image half sees plane A and the
    right half plane B. Each half remains exactly consistent with its own
    plane geometry.
    """

    def __init__(self, width=640, height=480, **kw):
        za = kw.pop("z0_a", 9.0)
        zb = kw.pop("z0_b", 18.0)
        self.a = PlaneSequence(width=width, height=height, z0=za, sx=0.25, sy=0.1, seed=3, **kw)
        self.b = PlaneSequence(width=width, height=height, z0=zb, sx=-0.35, sy=0.2, seed=11, **kw)
        self.width, self.height = width, height
        self.T_lr = self.a.T_lr

    def render(self, T_cw: np.ndarray) -> np.ndarray:
        half = np.zeros((self.height, self.width), bool)
        half[:, : self.width // 2] = True
        ia = self.a.render(T_cw, check_mask=half)
        ib = self.b.render(T_cw, check_mask=~half)
        out = ia.copy()
        out[:, self.width // 2 :] = ib[:, self.width // 2 :]
        return out

    def stereo_pair(self, T_wc: np.ndarray):
        T_cw_l = np.linalg.inv(T_wc)
        T_cw_r = np.linalg.inv(T_wc @ self.T_lr.astype(np.float64))
        return self.render(T_cw_l), self.render(T_cw_r)


class DistortedStereoSequence:
    """Renders a PlaneSequence through radial-tangential distorted lenses.

    For each distorted-image pixel we invert the radtan model (fixed-point,
    the numpy analog of the reference's per-pixel GN inversion,
    camera.cpp:89-161) to find the ideal-pinhole pixel, then evaluate the
    plane homography there — an exact distorted render, no double resampling.
    Drives the flagDoUndistortion=True path end to end.
    """

    def __init__(self, base: PlaneSequence, dist, iters: int = 30):
        self.base = base
        self.dist = np.asarray(dist, np.float64)
        self.width, self.height = base.width, base.height
        self.T_lr = base.T_lr
        uu, vv = np.meshgrid(
            np.arange(self.width, dtype=np.float64), np.arange(self.height, dtype=np.float64)
        )
        xd = np.stack([(uu - base.cx) / base.fx, (vv - base.cy) / base.fy], axis=-1)
        xn = xd.copy()
        for _ in range(iters):
            xn = xd - (self._distort(xn) - xn)
        self.ideal_pix = np.stack(
            [xn[..., 0] * base.fx + base.cx, xn[..., 1] * base.fy + base.cy], axis=-1
        )

    def _distort(self, xn: np.ndarray) -> np.ndarray:
        k1, k2, p1, p2, k3 = self.dist
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        return np.stack([xd, yd], axis=-1)

    def render(self, T_cw: np.ndarray) -> np.ndarray:
        """Single distorted view (mono streams)."""
        return self.base.render(T_cw, pix=self.ideal_pix)

    def stereo_pair(self, T_wc: np.ndarray):
        T_cw_l = np.linalg.inv(T_wc)
        T_cw_r = np.linalg.inv(T_wc @ self.T_lr.astype(np.float64))
        return (
            self.base.render(T_cw_l, pix=self.ideal_pix),
            self.base.render(T_cw_r, pix=self.ideal_pix),
        )


class HardSequence:
    """Adversarial wrapper for the accuracy procedure (BASELINE.md): exposure
    drift, a moving occluder with independent motion, and repeated texture,
    over a corridor world that stays valid for the whole trajectory.

    - World: CorridorSequence (fit around the trajectory via `fit_trajectory`
      or sized by `length`) — near-field walls, far-field end cap, and a
      loud ChiralityError if the camera ever exits the box.
    - Exposure: per-frame gain/bias drift (sinusoidal, +-15% gain, +-8 bias) —
      breaks brightness constancy the way auto-exposure does on KITTI.
    - Occluder: a textured rectangle sweeping across the view with its own
      motion; tracks crossing it must be killed by the error/consistency
      gates, not dragged.
    - Repeated texture: a small tile (256 px = 2.8 m) wraps many times along
      the SIDE walls (a repeating facade), creating self-similar structure
      that invites KLT mismatches and RANSAC confusion; floor/ceiling/end
      cap carry non-repeating texture (roads and horizons don't tile).
    """

    def __init__(self, width=640, height=480, occluder=True, exposure=True,
                 poses_T_wc=None, **kw):
        kw.setdefault("wall_tex_size", 256)
        kw.setdefault("wall_tex_scale", 90.0)
        if poses_T_wc is not None:
            self.base = CorridorSequence.fit(poses_T_wc, width=width, height=height, **kw)
        else:
            self.base = CorridorSequence(width=width, height=height, **kw)
        self.width, self.height = width, height
        self.T_lr = self.base.T_lr
        self.occluder = occluder
        self.exposure = exposure
        rng = np.random.default_rng(17)
        occ = rng.uniform(20.0, 235.0, (64, 64)).astype(np.float32)
        k = np.ones(3, np.float32) / 3
        occ = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, occ)
        self.occ_tex = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, occ)
        self.frame_idx = 0

    def _post(self, img: np.ndarray, frame: int, cam_offset_px: float) -> np.ndarray:
        out = img
        if self.exposure:
            gain = 1.0 + 0.15 * np.sin(frame * 0.13)
            bias = 8.0 * np.sin(frame * 0.071 + 1.0)
            out = np.clip(out * gain + bias, 0.0, 255.0)
        if self.occluder:
            # Rectangle sweeping left->right, ~12% of image width, with
            # disparity-consistent offset so it has plausible stereo depth.
            w = int(self.width * 0.12)
            h = int(self.height * 0.5)
            x0 = int((frame * 9) % (self.width + w)) - w + int(cam_offset_px)
            y0 = int(self.height * 0.25)
            xs, xe = max(0, x0), min(self.width, x0 + w)
            if xe > xs:
                ys, ye = y0, y0 + h
                ty, tx = np.meshgrid(
                    np.arange(ys, ye) % 64, np.arange(xs, xe) % 64, indexing="ij"
                )
                out = out.copy()
                out[ys:ye, xs:xe] = self.occ_tex[ty, tx]
        return out.astype(np.float32)

    def stereo_pair(self, T_wc: np.ndarray, frame: int | None = None):
        if frame is None:
            frame = self.frame_idx
            self.frame_idx += 1
        il, ir = self.base.stereo_pair(T_wc)
        # Occluder sits ~6 m away -> disparity fx*b/6 px in the right image.
        disp = self.base.fx * self.base.baseline / 6.0
        return self._post(il, frame, 0.0), self._post(ir, frame, -disp)

    def render(self, T_cw: np.ndarray, frame: int | None = None):
        if frame is None:
            frame = self.frame_idx
            self.frame_idx += 1
        return self._post(self.base.render(T_cw), frame, 0.0)


def varied_trajectory(n_frames: int, step=0.3, seed=5):
    """[n, 4, 4] T_wc poses: forward motion with speed variation, S-curves,
    and gentle pitch/roll — a harder path than forward_trajectory."""
    import torch

    from ..utils.geometry import se3_exp

    poses = []
    T = np.eye(4, dtype=np.float32)
    for i in range(n_frames):
        # Frame 0 is the identity (VO starts there; unaligned ATE would
        # otherwise carry a constant first-step offset).
        poses.append(T.copy())
        speed = step * (0.6 + 0.4 * np.sin(i * 0.05))
        yaw = 0.004 * np.sin(i * 0.02)
        pitch = 0.0008 * np.sin(i * 0.043)
        roll = 0.0006 * np.sin(i * 0.031)
        xi = np.array([0.0, 0.0, speed, pitch, yaw, roll], np.float32)
        dT = se3_exp(torch.from_numpy(xi)).numpy()
        T = T @ dT
    return np.stack(poses)


def forward_trajectory(n_frames: int, step=0.25, yaw_rate=0.002, lateral=0.0):
    """[n, 4, 4] T_wc poses: forward (+z) motion with gentle yaw, float32."""
    import torch

    from ..utils.geometry import se3_exp

    # Products in float64, then one rounding to float32, as Python floats
    # multiplied into a float32 array would give.
    i = np.arange(n_frames, dtype=np.float64)
    xi = np.zeros((n_frames, 6), np.float64)
    xi[:, 0] = lateral * i
    xi[:, 2] = step * i
    xi[:, 4] = yaw_rate * i
    return se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy()


def photo_corridor(photo: np.ndarray, crop: int = 256, seed: int = 5, **kw) -> CorridorSequence:
    """CorridorSequence with every plane textured by crops of a REAL
    photograph instead of procedural noise (every ZNCC/KLT/BA threshold was
    tuned on procedural textures; this world de-risks them against natural image statistics — edges, flat regions,
    gradients, real second-order structure — before real KITTI ever appears).

    photo: [H, W] grayscale uint8/float. Each plane gets a different crop
    (flipped/transposed for diversity), contrast-stretched to full range.
    Crops tile via the standard wrap sampler; tiling seams act like building
    edges. Camera intrinsics/extent kwargs pass through to CorridorSequence.
    """
    seq = CorridorSequence(**kw)
    ph = np.asarray(photo, np.float32)
    H, W = ph.shape
    c = min(crop, H, W)
    rng = np.random.default_rng(seed)
    for i, pl in enumerate(seq.planes):
        y0 = int(rng.integers(0, H - c + 1))
        x0 = int(rng.integers(0, W - c + 1))
        tile = ph[y0 : y0 + c, x0 : x0 + c]
        if i % 2 == 1:
            tile = tile.T
        if i % 3 == 1:
            tile = tile[::-1]
        lo, hi = float(tile.min()), float(tile.max())
        tile = (tile - lo) / max(hi - lo, 1.0) * 235.0 + 10.0
        pl.tex = _MipTex(np.ascontiguousarray(tile))
    return seq
