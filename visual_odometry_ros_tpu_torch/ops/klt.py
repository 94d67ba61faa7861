"""Pyramidal Lucas-Kanade feature tracking, batched over all features.

Counterpart of `visual_odometry_ros_tpu/ops/klt.py`. Two legs, chosen by
`KLTParams.use_kernel` (from `cfg.tracker.use_pallas`):
  - kernel leg: a whole pyramid climb (forward, or forward and backward for
    `track_bidirectional_pyr`) and the scale refinement each go through one
    call of `ops/klt_kernels.py` (one CUDA kernel launch on CUDA tensors,
    the plain version on CPU tensors);
  - plain leg ("off"): the port of the reference's jnp leg (`_track_one_level`
    and the checkerboard `track_with_scale`), for tight CPU parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.interp import bilinear_sample
from . import klt_kernels as KK


class KLTParams(NamedTuple):
    window_radius: int = 10  # 21x21 window
    levels: int = 4
    iters: int = 12
    eps: float = 0.03  # convergence |delta| in px
    min_eig: float = 1e-4  # min-eigenvalue gate (per-pixel normalized)
    max_err: float = 30.0  # mean abs intensity error gate
    fb_thresh: float = 1.0  # bidirectional consistency gate, px
    border: float = 3.0
    use_kernel: bool = False  # route levels through ops/klt_kernels
    iters_coarse: int = 0  # iteration budget for non-finest levels (0 = iters)


def resolve_use_kernel(mode: str | bool) -> bool:
    """`cfg.tracker.use_pallas` policy: "auto"/"on" select the kernel leg
    (CUDA kernel for CUDA tensors, its plain version for CPU tensors); "off"
    selects the port of the jnp leg."""
    if isinstance(mode, bool):
        return mode
    if mode in ("auto", "on"):
        return True
    if mode == "off":
        return False
    raise ValueError(f"use_pallas must be 'auto', 'on' or 'off', got {mode!r}")


def _patch_offsets(radius: int, device, checkerboard: bool = False) -> torch.Tensor:
    off = KK._patch_offsets(radius, device)
    return off[::2] if checkerboard else off


def _track_one_level(img0, gx0, gy0, img1, p0, p1_init, valid, offsets, iters, eps, min_eig,
                     epi1d=False):
    """One pyramid level of batched IC-KLT (plain leg).
    Returns (p1 [N, 2], live [N], err [N])."""
    pts0 = p0[:, None, :] + offsets[None, :, :]
    T, m0 = bilinear_sample(img0, pts0)
    gx, _ = bilinear_sample(gx0, pts0)
    gy, _ = bilinear_sample(gy0, pts0)
    w0 = m0.to(torch.float32)

    gxx = torch.sum(gx * gx * w0, dim=1)
    gxy = torch.sum(gx * gy * w0, dim=1)
    gyy = torch.sum(gy * gy * w0, dim=1)
    npix = torch.clamp(torch.sum(w0, dim=1), min=1.0)
    if epi1d:
        eig_ok = gxx / npix > min_eig
        inv_gxx = 1.0 / torch.where(gxx < 1e-12, 1e-12, gxx)
    else:
        tr = gxx + gyy
        dd = torch.sqrt(torch.clamp((gxx - gyy) ** 2 + 4.0 * gxy * gxy, min=0.0))
        eig_ok = 0.5 * (tr - dd) / npix > min_eig
    det = gxx * gyy - gxy * gxy
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    live = valid & eig_ok

    p1 = p1_init
    conv = torch.zeros_like(valid)
    for _ in range(iters):
        I1p, m1 = bilinear_sample(img1, p1[:, None, :] + offsets[None, :, :])
        e = (T - I1p) * (w0 * m1.to(torch.float32))
        bx = torch.sum(gx * e, dim=1)
        by = torch.sum(gy * e, dim=1)
        if epi1d:
            du = bx * inv_gxx
            dv = torch.zeros_like(du)
        else:
            du = (gyy * bx - gxy * by) * inv_det
            dv = (gxx * by - gxy * bx) * inv_det
        step = torch.stack([du, dv], dim=-1)
        p1 = p1 + torch.where((live & ~conv)[:, None], step, 0.0)
        conv = conv | (torch.sum(step * step, dim=-1) < eps * eps)

    I1p, m1 = bilinear_sample(img1, p1[:, None, :] + offsets[None, :, :])
    w = w0 * m1.to(torch.float32)
    err = torch.sum(torch.abs(T - I1p) * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)
    return p1, live, err


def _kernel_args(pyr0, pyr1, L, p0, p1_init, valid):
    """The first L level images of both pyramids and contiguous point arrays."""
    return ([pyr0[lvl][0] for lvl in range(L)], [pyr1[lvl][0] for lvl in range(L)],
            p0.contiguous(), p1_init.contiguous(), valid.contiguous())


def _kernel_kw(params: KLTParams, epi1d: bool) -> dict:
    return dict(radius=params.window_radius, iters=params.iters, iters_coarse=params.iters_coarse,
                eps=params.eps, min_eig=params.min_eig, epi1d=epi1d)


def _pyr_track(pyr0, pyr1, p0, p1_init, valid, params: KLTParams, track_levels: int | None = None,
               epi1d: bool = False):
    """Coarse-to-fine track p0 (level-0 coords) -> p1. `track_levels` limits
    the climb to the finest levels (prior-seeded passes). The kernel leg is
    one `klt_pyr` launch for the whole climb."""
    L = min(params.levels, track_levels) if track_levels else params.levels
    if params.use_kernel:
        return KK.track_pyr(*_kernel_args(pyr0, pyr1, L, p0, p1_init, valid), **_kernel_kw(params, epi1d))
    offsets = _patch_offsets(params.window_radius, p0.device)
    p1 = p1_init / 2.0 ** (L - 1)
    live = valid
    err = torch.zeros(p0.shape[0], dtype=torch.float32, device=p0.device)
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        img0, gx0, gy0 = pyr0[lvl]
        img1 = pyr1[lvl][0]
        lvl_iters = params.iters if lvl == 0 else (params.iters_coarse or params.iters)
        p1, live, err = _track_one_level(
            img0, gx0, gy0, img1, p0 / s, p1, live, offsets, lvl_iters,
            params.eps, params.min_eig, epi1d=epi1d,
        )
        if lvl > 0:
            p1 = p1 * 2.0
    return p1, live, err


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
    if params.use_kernel:  # both climbs in one klt_pyr launch
        L = params.levels
        p1, live1, err1, p0b, live0 = KK.track_pyr_bidir(
            *_kernel_args(pyr0, pyr1, L, p0, p1_prior, valid), **_kernel_kw(params, epi1d),
            back_levels=min(L, back_levels) if back_levels else L,
        )
    else:
        p1, live1, err1 = _pyr_track(pyr0, pyr1, p0, p1_prior, valid, params, epi1d=epi1d)
        p0b, live0, _ = _pyr_track(pyr1, pyr0, p1, p0, live1, params, back_levels, epi1d=epi1d)
    fb2 = torch.sum((p0b - p0) ** 2, dim=-1)
    thr = (params.fb_thresh * fb_scale) ** 2
    ok = live1 & live0 & (err1 < params.max_err) & (fb2 < thr) & _in_border(p1, shape, params.border)
    return p1, ok


def track_with_scale(img0, du0, dv0, img1, p0, p1_init, scale_change, valid, radius: int = 11,
                     iters: int = 30, max_err: float = 30.0, use_kernel: bool = False):
    """Scale-compensated single-level IC-KLT refinement (trackWithScale).
    Returns (p1 [N, 2], ok [N])."""
    if use_kernel:
        p1, err, ok = KK.track_scale(
            img0, img1, p0.contiguous(), p1_init.contiguous(), scale_change.contiguous(), valid,
            radius=radius, iters=iters,
        )
        return p1, ok & (err < max_err) & _in_border(p1, img1.shape, 3.0)

    base_off = _patch_offsets(radius, p0.device, checkerboard=True)
    offs = base_off[None, :, :] * scale_change[:, None, None]
    pts0 = p0[:, None, :] + offs
    T, m0 = bilinear_sample(img0, pts0)
    gx, _ = bilinear_sample(du0, pts0)
    gy, _ = bilinear_sample(dv0, pts0)
    w0 = m0.to(torch.float32)
    gxx = torch.sum(gx * gx * w0, dim=1)
    gxy = torch.sum(gx * gy * w0, dim=1)
    gyy = torch.sum(gy * gy * w0, dim=1)
    det = gxx * gyy - gxy * gxy
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)

    p1 = p1_init
    conv = torch.zeros_like(valid)
    for _ in range(iters):
        I1p, m1 = bilinear_sample(img1, p1[:, None, :] + offs)
        e = (T - I1p) * (w0 * m1.to(torch.float32))
        bx = torch.sum(gx * e, dim=1)
        by = torch.sum(gy * e, dim=1)
        du = (gyy * bx - gxy * by) * inv_det
        dv = (gxx * by - gxy * bx) * inv_det
        step = torch.stack([du, dv], dim=-1)
        p1 = p1 + torch.where((valid & ~conv)[:, None], step, 0.0)
        conv = conv | (torch.sum(step * step, dim=-1) < 1e-4)

    I1p, m1 = bilinear_sample(img1, p1[:, None, :] + offs)
    w = w0 * m1.to(torch.float32)
    err = torch.sum(torch.abs(T - I1p) * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)
    return p1, valid & (err < max_err) & _in_border(p1, img1.shape, 3.0)


def calc_prior(Xw, T_cw_prior, fx, fy, cx, cy):
    """Project world landmarks through a pose prior to seed the tracker.
    Returns (pixels [N, 2], camera-frame depth [N])."""
    Xc = Xw @ T_cw_prior[:3, :3].T + T_cw_prior[:3, 3]
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-6, 1e-6, Xc[..., 2])
    u = Xc[..., 0] / z * fx + cx
    v = Xc[..., 1] / z * fy + cy
    return torch.stack([u, v], dim=-1), Xc[..., 2]
