"""Pyramidal inverse-compositional KLT, batched over all features: the
plain PyTorch semantics that the program's `klt_pyr` and `klt_scale`
kernels implement (its `ops/klt_kernels.py` `*_ref` versions), as the
program's "auto" tracker leg runs them. Nothing here launches a kernel.

One level:
  - A feature is *processed* iff it is valid and both its template point p0
    and its seed p1_init lie within the image grown by the window half-extent
    (r px; s*r for the scale variant). Unprocessed features pass p1_init
    through with err 0.
  - Template pixel (i, j) sits at p0 + s*(j - r, i - r); it is valid iff it
    lies in [0, W-1] x [0, H-1]. All sampling is bilinear on the
    edge-replicated image (`_bilinear_edge`). Plain level: value and Scharr
    gradients (edge-replicated, integer grid) are sampled at that point.
    Scale: the template is resampled at unit bank spacing from the
    edge-replicated image and Scharr runs on the resampled grid, so the
    gradients are in bank units, at patch scale.
  - Gates: min-eigenvalue of the template Hessian per valid pixel (x-only
    energy in `epi1d` mode; the scale variant gates at 0, i.e. only
    degenerate patches), and more than half the window inside the image.
  - At most `iters` Gauss-Newton steps, target sampled at p1 + s*(offset),
    stopping once |step| < eps (bank units).
  - live/ok = gates passed and the final point inside the image; err = mean
    absolute residual over pixels valid in both images.

The climb: p1 starts at p1_init / 2^(L-1); level l tracks p0 / 2^l with
`iters_coarse` steps above level 0 and `iters` at level 0; a feature not
processed at a level keeps its estimate; the estimate doubles between
levels; live and err are those of level 0. The backward climb tracks the
forward result back to p0 over `back_levels` levels with the pyramids
swapped, seeded at p0 and valid where the forward track is live.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pyramid import scharr_gradients


class KLTParams(NamedTuple):
    window_radius: int = 10  # 21x21 window
    levels: int = 4
    iters: int = 12
    eps: float = 0.03  # convergence |delta| in px
    min_eig: float = 1e-4  # min-eigenvalue gate (per-pixel normalized)
    max_err: float = 30.0  # mean abs intensity error gate
    fb_thresh: float = 1.0  # bidirectional consistency gate, px
    border: float = 3.0
    iters_coarse: int = 0  # iteration budget for non-finest levels (0 = iters)


def _patch_offsets(radius: int, device) -> torch.Tensor:
    """[(2r+1)^2, 2] (u, v) offsets, row-major over (v, u)."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    ov, ou = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ou.reshape(-1), ov.reshape(-1)], dim=-1)


def _bilinear_edge(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the edge-replicated image at pts [..., 2] (u, v):
    the point is clamped into the image, the cell index to W-2 / H-2, and
    the fraction is taken from the clamped point — so u = W-1 reads column
    W-1, as the kernel's edge-padded slabs do (unlike
    `utils.interp.bilinear_sample`, which reads W-2 there)."""
    H, W = img.shape
    # NaN reads as 0, as fmaxf does in the kernel (dead lanes may carry garbage).
    u = torch.clamp(torch.nan_to_num(pts[..., 0], nan=0.0), 0.0, W - 1.0)
    v = torch.clamp(torch.nan_to_num(pts[..., 1], nan=0.0), 0.0, H - 1.0)
    iu = torch.clamp(torch.floor(u), max=W - 2.0)
    iv = torch.clamp(torch.floor(v), max=H - 2.0)
    du = u - iu
    dv = v - iv
    base = iv.to(torch.int64) * W + iu.to(torch.int64)
    flat = img.reshape(-1)
    I00, I01, I10, I11 = flat[base], flat[base + 1], flat[base + W], flat[base + W + 1]
    top = I00 + du * (I01 - I00)
    bot = I10 + du * (I11 - I10)
    return top + dv * (bot - top)


def _inside(p: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return (p[..., 0] >= 0.0) & (p[..., 1] >= 0.0) & (p[..., 0] <= W - 1.0) & (p[..., 1] <= H - 1.0)


def _processable(p: torch.Tensor, H: int, W: int, margin) -> torch.Tensor:
    return (
        (p[:, 0] >= -margin) & (p[:, 1] >= -margin)
        & (p[:, 0] <= (W - 1.0) + margin) & (p[:, 1] <= (H - 1.0) + margin)
    )


def _gn_loop(img1, T, gx, gy, w0, p1, offs, step_scale, live, iters, eps, epi1d, gxx, gxy, gyy):
    """Masked IC Gauss-Newton: p1 [N, 2]; offs [N or 1, P, 2] target offsets;
    step_scale [N, 1] maps a solve step to image pixels."""
    H, W = img1.shape
    if epi1d:
        inv_gxx = 1.0 / torch.where(gxx < 1e-12, 1e-12, gxx)
    else:
        det = gxx * gyy - gxy * gxy
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    conv = torch.zeros_like(live)
    for _ in range(iters):
        pts1 = p1[:, None, :] + offs
        e = (T - _bilinear_edge(img1, pts1)) * (w0 * _inside(pts1, H, W).to(torch.float32))
        bx = torch.sum(gx * e, dim=1)
        by = torch.sum(gy * e, dim=1)
        if epi1d:
            du = bx * inv_gxx
            dv = torch.zeros_like(du)
        else:
            du = (gyy * bx - gxy * by) * inv_det
            dv = (gxx * by - gxy * bx) * inv_det
        step = torch.stack([du, dv], dim=-1)
        active = (live & ~conv)[:, None]
        p1 = p1 + torch.where(active, step_scale * step, 0.0)
        conv = conv | (torch.sum(step * step, dim=-1) < eps * eps)
    pts1 = p1[:, None, :] + offs
    w = w0 * _inside(pts1, H, W).to(torch.float32)
    err = torch.sum(torch.abs(T - _bilinear_edge(img1, pts1)) * w, dim=1) / torch.clamp(
        torch.sum(w, dim=1), min=1.0
    )
    return p1, err


def _hessian_gates(gx, gy, w0, S, min_eig, epi1d):
    gxx = torch.sum(gx * gx * w0, dim=1)
    gxy = torch.sum(gx * gy * w0, dim=1)
    gyy = torch.sum(gy * gy * w0, dim=1)
    npix = torch.clamp(torch.sum(w0, dim=1), min=1.0)
    if epi1d:
        eig_ok = gxx / npix > min_eig
    else:
        tr = gxx + gyy
        dd = torch.sqrt(torch.clamp((gxx - gyy) ** 2 + 4.0 * gxy * gxy, min=0.0))
        eig_ok = 0.5 * (tr - dd) / npix > min_eig
    frac_ok = npix > 0.5 * float(S * S)
    return gxx, gxy, gyy, eig_ok & frac_ok


def _level(img0, img1, p0, p1_init, valid, radius, iters, eps, min_eig, epi1d):
    H, W = img0.shape
    S = 2 * radius + 1
    off = _patch_offsets(radius, img0.device)
    proc = valid & _processable(p0, H, W, float(radius)) & _processable(p1_init, H, W, float(radius))
    gx0, gy0 = scharr_gradients(img0)
    pts0 = p0[:, None, :] + off[None]
    T = _bilinear_edge(img0, pts0)
    gx = _bilinear_edge(gx0, pts0)
    gy = _bilinear_edge(gy0, pts0)
    w0 = _inside(pts0, H, W).to(torch.float32)
    gxx, gxy, gyy, gates = _hessian_gates(gx, gy, w0, S, min_eig, epi1d)
    live = proc & gates
    ones = torch.ones((p0.shape[0], 1), dtype=torch.float32, device=p0.device)
    p1, err = _gn_loop(img1, T, gx, gy, w0, p1_init, off[None], ones, live, iters, eps, epi1d,
                       gxx, gxy, gyy)
    err = torch.where(proc, err, 0.0)
    return p1, live & _inside(p1, H, W), err, proc


def _climb(imgs0, imgs1, p0, p1_init, valid, radius, iters, iters_coarse, eps, min_eig, epi1d):
    """The coarse-to-fine climb over len(imgs0) levels (level 0 first in the
    lists). Returns (p1, live, err, processed at level 0)."""
    L = len(imgs0)
    p1 = p1_init / 2.0 ** (L - 1)
    live, err, proc = valid, None, None
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        p1_new, ok_new, err_new, proc = _level(
            imgs0[lvl], imgs1[lvl], p0 / s, p1, valid, radius, iters if lvl == 0 else iters_coarse,
            eps, min_eig, epi1d,
        )
        p1 = torch.where(proc[:, None], p1_new, p1)
        if lvl == 0:
            live = valid & proc & ok_new
            err = err_new
        else:
            p1 = p1 * 2.0
    return p1, live, err, proc


def _scale(img0, img1, p0, p1_init, scale_change, valid, radius=11, iters=30, eps=0.01):
    """The scale-compensated refinement. Returns (p1 [N,2], err [N], ok [N])."""
    H, W = img0.shape
    S = 2 * radius + 1
    N = p0.shape[0]
    s = torch.clamp(scale_change, 0.5, 2.0)
    margin = s * float(radius)
    proc = valid & _processable(p0, H, W, margin) & _processable(p1_init, H, W, margin)
    # Template bank on the (S+2)^2 grid (1-px ring for the stencil), sampled
    # from the edge-replicated image.
    offb = _patch_offsets(radius + 1, img0.device)
    posb = p0[:, None, :] + s[:, None, None] * offb[None]
    tb = _bilinear_edge(img0, posb).reshape(N, S + 2, S + 2)
    T = tb[:, 1:-1, 1:-1].reshape(N, -1)
    sx = (3.0 * (tb[:, :-2, :] + tb[:, 2:, :]) + 10.0 * tb[:, 1:-1, :]) / 16.0  # [N, S, S+2]
    gx = ((sx[:, :, 2:] - sx[:, :, :-2]) * 0.5).reshape(N, -1)
    sy = (3.0 * (tb[:, :, :-2] + tb[:, :, 2:]) + 10.0 * tb[:, :, 1:-1]) / 16.0  # [N, S+2, S]
    gy = ((sy[:, 2:, :] - sy[:, :-2, :]) * 0.5).reshape(N, -1)
    offs = s[:, None, None] * _patch_offsets(radius, img0.device)[None]  # [N, P, 2]
    w0 = _inside(p0[:, None, :] + offs, H, W).to(torch.float32)
    gxx, gxy, gyy, gates = _hessian_gates(gx, gy, w0, S, 0.0, False)
    live = proc & gates
    p1, err = _gn_loop(img1, T, gx, gy, w0, p1_init, offs, s[:, None], live, iters, eps, False,
                       gxx, gxy, gyy)
    err = torch.where(proc, err, 0.0)
    return p1, err, live & _inside(p1, H, W)


def _levels(pyr, L):
    return [pyr[lvl][0] for lvl in range(L)]


def _pyr_track(pyr0, pyr1, p0, p1_init, valid, params: KLTParams, track_levels: int | None = None,
               epi1d: bool = False):
    """Coarse-to-fine track p0 (level-0 coords) -> p1 over the first
    `track_levels` levels (all when None). Returns (p1, live, err)."""
    L = min(params.levels, track_levels) if track_levels else params.levels
    out = _climb(_levels(pyr0, L), _levels(pyr1, L), p0, p1_init, valid, params.window_radius,
                 params.iters, params.iters_coarse or params.iters, params.eps, params.min_eig, epi1d)
    return out[:3]


def _in_border(p, shape, border):
    H, W = shape
    return (p[..., 0] >= border) & (p[..., 1] >= border) & (p[..., 0] < W - border) & (p[..., 1] < H - border)


def track_with_prior_pyr(pyr0, pyr1, p0, p1_prior, valid, params: KLTParams = KLTParams(),
                         track_levels: int | None = None, epi1d: bool = False):
    """Prior-seeded forward KLT over prebuilt pyramids. Returns (p1, ok)."""
    shape = pyr1[0][0].shape
    p1, live, err = _pyr_track(pyr0, pyr1, p0, p1_prior, valid, params, track_levels, epi1d=epi1d)
    ok = live & (err < params.max_err) & _in_border(p1, shape, params.border)
    return p1, ok


def track_bidirectional_pyr(pyr0, pyr1, p0, p1_prior, valid, params: KLTParams = KLTParams(),
                            fb_scale: float = 1.0, back_levels: int | None = None,
                            epi1d: bool = False):
    """Forward + backward track with the fb-distance gate. Returns (p1, ok)."""
    shape = pyr1[0][0].shape
    L = params.levels
    Lb = min(L, back_levels) if back_levels else L
    ic = params.iters_coarse or params.iters
    kw = dict(radius=params.window_radius, iters=params.iters, iters_coarse=ic, eps=params.eps,
              min_eig=params.min_eig, epi1d=epi1d)
    p1, live1, err1, _ = _climb(_levels(pyr0, L), _levels(pyr1, L), p0, p1_prior, valid, **kw)
    p0b, live0, _, _ = _climb(_levels(pyr1, Lb), _levels(pyr0, Lb), p1, p0, live1, **kw)
    fb2 = torch.sum((p0b - p0) ** 2, dim=-1)
    thr = (params.fb_thresh * fb_scale) ** 2
    ok = live1 & live0 & (err1 < params.max_err) & (fb2 < thr) & _in_border(p1, shape, params.border)
    return p1, ok


def track_with_scale(img0, img1, p0, p1_init, scale_change, valid, radius: int = 11,
                     iters: int = 30, max_err: float = 30.0):
    """Scale-compensated single-level IC-KLT refinement (trackWithScale).
    Returns (p1 [N, 2], ok [N])."""
    p1, err, ok = _scale(img0, img1, p0, p1_init, scale_change, valid, radius=radius, iters=iters)
    return p1, ok & (err < max_err) & _in_border(p1, img1.shape, 3.0)


def calc_prior(Xw, T_cw_prior, fx, fy, cx, cy):
    """Project world landmarks through a pose prior to seed the tracker.
    Returns (pixels [N, 2], camera-frame depth [N])."""
    Xc = Xw @ T_cw_prior[:3, :3].T + T_cw_prior[:3, 3]
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-6, 1e-6, Xc[..., 2])
    u = Xc[..., 0] / z * fx + cx
    v = Xc[..., 1] / z * fy + cy
    return torch.stack([u, v], dim=-1), Xc[..., 2]
