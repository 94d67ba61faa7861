"""Batched inverse-compositional KLT: the two hand-written Hopper kernels,
their wrappers, and the plain PyTorch versions that define their semantics.

Replaces `visual_odometry_ros_tpu/ops/klt_pallas_fp.py`:
  - kernel `klt_pyr` (csrc/klt.cu) <- `track_level_fp`, together with the
    level-by-level climb of `ops/klt._pyr_track` around it. One launch
    tracks every feature through all pyramid levels (`track_pyr`), and for
    `track_pyr_bidir` through the backward climb too. `track_level` is its
    one-level case.
  - kernel `klt_scale` <- `track_scale_fp` (`track_scale`): the
    scale-compensated refinement (reference trackWithScale).

Semantics of one level (shared by kernel and plain version):
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
    stopping once |step| < eps (bank units). No drift window: the TPU
    kernel's +-4 px slab and its re-anchor restarts are layout artifacts.
  - live/ok = gates passed and the final point inside the image; err = mean
    absolute residual over pixels valid in both images.

The climb (`_pyr_track`'s glue): p1 starts at p1_init / 2^(L-1); level l
tracks p0 / 2^l with `iters_coarse` steps above level 0 and `iters` at
level 0; a feature not processed at a level keeps its estimate; the
estimate doubles between levels; live and err are those of level 0. The
backward climb tracks the forward result back to p0 over `back_levels`
levels with the pyramids swapped, seeded at p0 and valid where the forward
track is live.

On CPU tensors the wrappers run the plain versions. On CUDA tensors they
launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import time
from pathlib import Path

import torch

from .pyramid import scharr_gradients

MAX_RADIUS = 11  # the kernels keep a (2r+1)^2 <= 23^2 window in registers
MAX_LEVELS = 8  # pyramid levels one klt_pyr launch can climb

# Launch counters: incremented by a wrapper exactly where it launches its
# kernel. The plain versions never touch them.
LAUNCHES = {"klt_pyr": 0, "klt_scale": 0}

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "klt.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_LIB = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build (nvcc -> shared library with a plain C interface -> ctypes)
# ---------------------------------------------------------------------------


class _PyrArgs(ctypes.Structure):
    """`PyrArgs` of csrc/klt.cu, field for field."""

    _fields_ = [
        ("img0", ctypes.c_void_p * MAX_LEVELS),
        ("img1", ctypes.c_void_p * MAX_LEVELS),
        ("H", ctypes.c_int * MAX_LEVELS),
        ("W", ctypes.c_int * MAX_LEVELS),
        ("levels", ctypes.c_int),
        ("back_levels", ctypes.c_int),
        ("p0", ctypes.c_void_p),
        ("p1_init", ctypes.c_void_p),
        ("valid", ctypes.c_void_p),
        ("N", ctypes.c_int),
        ("radius", ctypes.c_int),
        ("iters", ctypes.c_int),
        ("iters_coarse", ctypes.c_int),
        ("eps", ctypes.c_float),
        ("min_eig", ctypes.c_float),
        ("epi1d", ctypes.c_int),
        ("p1_out", ctypes.c_void_p),
        ("err_out", ctypes.c_void_p),
        ("live_out", ctypes.c_void_p),
        ("proc_out", ctypes.c_void_p),
        ("p0b_out", ctypes.c_void_p),
        ("live0_out", ctypes.c_void_p),
    ]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    for c in cand:
        if os.path.exists(c):
            return c
    import shutil

    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the KLT kernels need the CUDA toolkit to build")
    return found


def build() -> ctypes.CDLL:
    """Compile csrc/klt.cu for sm_90a (once per source version) and load it.

    The library lands in `build/kernels/` at the repository root, named by a
    hash of the source. Raises RuntimeError with nvcc's stderr on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libklt_{tag}.so"
    t0 = time.perf_counter()
    if not so.exists():
        tmp = BUILD_DIR / f"libklt_{tag}.{os.getpid()}.tmp.so"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(_SRC),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        (BUILD_DIR / f"libklt_{tag}.ptxas.txt").write_text(proc.stderr)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.klt_pyr_launch.argtypes = [P, P]
    lib.klt_pyr_launch.restype = I
    lib.klt_scale_launch.argtypes = [P, P, I, I, P, P, P, P, I, I, I, F, P, P, P, P]
    lib.klt_scale_launch.restype = I
    BUILD_INFO.update(
        library=str(so),
        seconds=time.perf_counter() - t0,
        ptxas=(BUILD_DIR / f"libklt_{tag}.ptxas.txt").read_text()
        if (BUILD_DIR / f"libklt_{tag}.ptxas.txt").exists() else "",
    )
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the semantics the kernels implement)
# ---------------------------------------------------------------------------
# `counts`, where given, adds up the work these inputs need (templates
# built, Gauss-Newton steps taken, residuals evaluated), in the units a bound
# on the kernel's time is counted in: window pixels, Scharr lattice points,
# and window lines (rows plus columns: a window's points, cells and masks
# are separable, so they are computed once per row and per column).


def _count(counts, key, n, per) -> None:
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(n) * per


def _patch_offsets(radius: int, device) -> torch.Tensor:
    """[(2r+1)^2, 2] (u, v) offsets, row-major over (v, u)."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    ov, ou = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ou.reshape(-1), ov.reshape(-1)], dim=-1)


def _bilinear_edge(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the edge-replicated image at pts [..., 2] (u, v):
    the point is clamped into the image, the cell index to W-2 / H-2, and
    the fraction is taken from the clamped point — so u = W-1 reads column
    W-1, as the TPU kernel's edge-padded slabs do (unlike
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


def _gn_loop(img1, T, gx, gy, w0, p1, offs, step_scale, live, iters, eps, epi1d, gxx, gxy, gyy,
             counts=None, keys=("step_px", "line")):
    """Masked IC Gauss-Newton: p1 [N, 2]; offs [N or 1, P, 2] target offsets;
    step_scale [N, 1] maps a solve step to image pixels. `keys` name the
    counts of a step's pixels and lines."""
    H, W = img1.shape
    S = math.isqrt(T.shape[1])
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
        _count(counts, keys[0], active.sum(), S * S)
        _count(counts, keys[1], active.sum(), 2 * S)
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


def _level_ref(img0, img1, p0, p1_init, valid, radius, iters, eps, min_eig, epi1d, counts=None,
               want_err=True):
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
    # Offsets are integers, so the window shares one bilinear fraction: the
    # gradients are needed on the (S+1)^2 lattice around it only.
    _count(counts, "template_px", proc.sum(), S * S)
    _count(counts, "lattice_px", proc.sum(), (S + 1) ** 2)
    _count(counts, "line", proc.sum(), 2 * S)
    if want_err:
        _count(counts, "err_px", proc.sum(), S * S)
        _count(counts, "line", proc.sum(), 2 * S)
    ones = torch.ones((p0.shape[0], 1), dtype=torch.float32, device=p0.device)
    p1, err = _gn_loop(img1, T, gx, gy, w0, p1_init, off[None], ones, live, iters, eps, epi1d,
                       gxx, gxy, gyy, counts)
    err = torch.where(proc, err, 0.0)
    return p1, live & _inside(p1, H, W), err, proc


def track_level_ref(img0, img1, p0, p1_init, valid, radius=10, iters=12, eps=0.03,
                    min_eig=1e-4, epi1d=False):
    """Plain version of one level (the one-level case of `klt_pyr`).
    Returns (p1 [N,2], live [N], err [N], processed [N])."""
    return _level_ref(img0, img1, p0, p1_init, valid, radius, iters, eps, min_eig, epi1d)


def _climb_ref(imgs0, imgs1, p0, p1_init, valid, radius, iters, iters_coarse, eps, min_eig, epi1d,
               counts=None, want_err=True):
    """The coarse-to-fine climb over len(imgs0) levels (level 0 first in the
    lists). Returns (p1, live, err, processed at level 0)."""
    L = len(imgs0)
    p1 = p1_init / 2.0 ** (L - 1)
    live, err, proc = valid, None, None
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        p1_new, ok_new, err_new, proc = _level_ref(
            imgs0[lvl], imgs1[lvl], p0 / s, p1, valid, radius, iters if lvl == 0 else iters_coarse,
            eps, min_eig, epi1d, counts, want_err and lvl == 0,
        )
        p1 = torch.where(proc[:, None], p1_new, p1)
        if lvl == 0:
            live = valid & proc & ok_new
            err = err_new
        else:
            p1 = p1 * 2.0
    return p1, live, err, proc


def track_pyr_ref(imgs0, imgs1, p0, p1_init, valid, radius=10, iters=12, iters_coarse=None,
                  eps=0.03, min_eig=1e-4, epi1d=False, counts=None):
    """Plain version of `klt_pyr`, forward climb. imgs0/imgs1: the levels of
    the two pyramids, level 0 first. Returns (p1, live, err)."""
    out = _climb_ref(imgs0, imgs1, p0, p1_init, valid, radius, iters, iters_coarse or iters, eps,
                     min_eig, epi1d, counts)
    return out[:3]


def track_pyr_bidir_ref(imgs0, imgs1, p0, p1_init, valid, radius=10, iters=12, iters_coarse=None,
                        eps=0.03, min_eig=1e-4, epi1d=False, back_levels=None, counts=None):
    """Plain version of `klt_pyr` with the backward climb over the first
    `back_levels` levels (all when None). Returns (p1, live1, err1, p0b,
    live0)."""
    ic = iters_coarse or iters
    p1, live1, err1, _ = _climb_ref(imgs0, imgs1, p0, p1_init, valid, radius, iters, ic, eps,
                                    min_eig, epi1d, counts)
    Lb = back_levels or len(imgs0)
    p0b, live0, _, _ = _climb_ref(imgs1[:Lb], imgs0[:Lb], p1, p0, live1, radius, iters, ic, eps,
                                  min_eig, epi1d, counts, want_err=False)
    return p1, live1, err1, p0b, live0


def track_scale_ref(img0, img1, p0, p1_init, scale_change, valid, radius=11, iters=30, eps=0.01,
                    counts=None):
    """Plain version of `klt_scale`. Returns (p1 [N,2], err [N], ok [N])."""
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
    _count(counts, "bank_px", proc.sum(), (S + 2) ** 2)
    _count(counts, "scale_template_px", proc.sum(), S * S)
    _count(counts, "scale_err_px", proc.sum(), S * S)
    # Lines: the bank's, the template mask's and the residual's.
    _count(counts, "scale_line", proc.sum(), 2 * (S + 2) + 2 * S + 2 * S)
    p1, err = _gn_loop(img1, T, gx, gy, w0, p1_init, offs, s[:, None], live, iters, eps, False,
                       gxx, gxy, gyy, counts, ("scale_step_px", "scale_line"))
    err = torch.where(proc, err, 0.0)
    return p1, err, live & _inside(p1, H, W)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, t, dtype, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_common(imgs0, imgs1, p0, p1_init, valid, radius):
    """Checks two pyramids (lists of level images, level 0 first) and the
    point arrays; returns their device."""
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius} outside [1, {MAX_RADIUS}]")
    if not 1 <= len(imgs0) <= MAX_LEVELS or len(imgs1) != len(imgs0):
        raise ValueError(f"expected two pyramids of 1..{MAX_LEVELS} equal levels, "
                         f"got {len(imgs0)} and {len(imgs1)}")
    for lvl, (a, b) in enumerate(zip(imgs0, imgs1)):
        _check(f"img0[{lvl}]", a, torch.float32)
        if a.dim() != 2 or a.shape[0] < 2 or a.shape[1] < 2:
            raise ValueError(f"img0[{lvl}]: expected [H, W] with H, W >= 2, got {tuple(a.shape)}")
        _check(f"img1[{lvl}]", b, torch.float32, a.shape)
    N = p0.shape[0]
    _check("p0", p0, torch.float32, (N, 2))
    _check("p1_init", p1_init, torch.float32, (N, 2))
    _check("valid", valid, torch.bool, (N,))
    devs = {t.device for t in (*imgs0, *imgs1, p0, p1_init, valid)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {sorted(map(str, devs))}")
    dev = p0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(name: str, fn, argv: tuple) -> None:
    """Call the C launcher `fn(*argv)` and count the launch."""
    rc = fn(*argv)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


def _pyr_launch(imgs0, imgs1, p0, p1_init, valid, radius, iters, iters_coarse, eps, min_eig, epi1d,
                back_levels, want_proc):
    """One klt_pyr launch on CUDA tensors. Returns (p1, live, err, proc or
    None, p0b or None, live0 or None)."""
    lib = build()
    dev = p0.device
    N = p0.shape[0]
    L = len(imgs0)
    f32, b8 = torch.float32, torch.bool
    p1 = torch.empty((N, 2), dtype=f32, device=dev)
    err = torch.empty((N,), dtype=f32, device=dev)
    live = torch.empty((N,), dtype=b8, device=dev)
    proc = torch.empty((N,), dtype=b8, device=dev) if want_proc else None
    p0b = torch.empty((N, 2), dtype=f32, device=dev) if back_levels else None
    live0 = torch.empty((N,), dtype=b8, device=dev) if back_levels else None
    if N == 0:
        return p1, live, err, proc, p0b, live0
    pad = [0] * (MAX_LEVELS - L)
    args = _PyrArgs(
        (ctypes.c_void_p * MAX_LEVELS)(*[t.data_ptr() for t in imgs0], *pad),
        (ctypes.c_void_p * MAX_LEVELS)(*[t.data_ptr() for t in imgs1], *pad),
        (ctypes.c_int * MAX_LEVELS)(*[t.shape[0] for t in imgs0], *pad),
        (ctypes.c_int * MAX_LEVELS)(*[t.shape[1] for t in imgs0], *pad),
        L, back_levels, p0.data_ptr(), p1_init.data_ptr(), valid.data_ptr(), N, int(radius),
        int(iters), int(iters_coarse), float(eps), float(min_eig), int(bool(epi1d)),
        p1.data_ptr(), err.data_ptr(), live.data_ptr(),
        None if proc is None else proc.data_ptr(), None if p0b is None else p0b.data_ptr(),
        None if live0 is None else live0.data_ptr(),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("klt_pyr", lib.klt_pyr_launch, (ctypes.byref(args), stream))
    return p1, live, err, proc, p0b, live0


def _scale_launch(img0, img1, p0, p1_init, scale_change, valid, radius, iters, eps):
    """One klt_scale launch on CUDA tensors. Returns (p1, err, ok)."""
    lib = build()
    dev = p0.device
    N = p0.shape[0]
    H, W = img0.shape
    p1 = torch.empty((N, 2), dtype=torch.float32, device=dev)
    err = torch.empty((N,), dtype=torch.float32, device=dev)
    ok = torch.empty((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return p1, err, ok
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        argv = (
            img0.data_ptr(), img1.data_ptr(), H, W, p0.data_ptr(), p1_init.data_ptr(),
            scale_change.data_ptr(), valid.data_ptr(), N, int(radius), int(iters), float(eps),
            p1.data_ptr(), err.data_ptr(), ok.data_ptr(), stream,
        )
        _launch("klt_scale", lib.klt_scale_launch, argv)
    return p1, err, ok


def track_level(img0, img1, p0, p1_init, valid, radius=10, iters=12, eps=0.03, min_eig=1e-4,
                epi1d=False):
    """One pyramid level of batched IC-KLT (see module docstring): `klt_pyr`
    with L = 1.

    img0/img1 [H, W] f32; p0/p1_init [N, 2] f32 (u, v); valid [N] bool.
    Returns (p1 [N, 2], live [N], err [N], processed [N])."""
    dev = _check_common([img0], [img1], p0, p1_init, valid, radius)
    if dev.type == "cpu":
        return track_level_ref(img0, img1, p0, p1_init, valid, radius, iters, eps, min_eig, epi1d)
    p1, live, err, proc, _, _ = _pyr_launch([img0], [img1], p0, p1_init, valid, radius, iters, iters,
                                            eps, min_eig, epi1d, 0, True)
    return p1, live, err, proc


def track_pyr(imgs0, imgs1, p0, p1_init, valid, radius=10, iters=12, iters_coarse=None, eps=0.03,
              min_eig=1e-4, epi1d=False):
    """Coarse-to-fine IC-KLT over two pyramids in one launch (see module
    docstring). imgs0/imgs1: level images, level 0 first; p0 and p1_init in
    level-0 pixels. Returns (p1 [N, 2], live [N], err [N])."""
    dev = _check_common(imgs0, imgs1, p0, p1_init, valid, radius)
    ic = iters_coarse or iters
    if dev.type == "cpu":
        return track_pyr_ref(imgs0, imgs1, p0, p1_init, valid, radius, iters, ic, eps, min_eig,
                             epi1d)
    return _pyr_launch(imgs0, imgs1, p0, p1_init, valid, radius, iters, ic, eps, min_eig, epi1d,
                       0, False)[:3]


def track_pyr_bidir(imgs0, imgs1, p0, p1_init, valid, radius=10, iters=12, iters_coarse=None,
                    eps=0.03, min_eig=1e-4, epi1d=False, back_levels=None):
    """`track_pyr`, then the backward climb from its result over the first
    `back_levels` levels (all when None), in the same launch.
    Returns (p1, live1, err1, p0b, live0)."""
    dev = _check_common(imgs0, imgs1, p0, p1_init, valid, radius)
    ic = iters_coarse or iters
    Lb = back_levels or len(imgs0)
    if not 1 <= Lb <= len(imgs0):
        raise ValueError(f"back_levels {back_levels} outside [1, {len(imgs0)}]")
    if dev.type == "cpu":
        return track_pyr_bidir_ref(imgs0, imgs1, p0, p1_init, valid, radius, iters, ic, eps,
                                   min_eig, epi1d, Lb)
    p1, live1, err1, _, p0b, live0 = _pyr_launch(imgs0, imgs1, p0, p1_init, valid, radius, iters,
                                                 ic, eps, min_eig, epi1d, Lb, False)
    return p1, live1, err1, p0b, live0


def track_scale(img0, img1, p0, p1_init, scale_change, valid, radius=11, iters=30, eps=0.01):
    """Scale-compensated IC-KLT refinement (see module docstring).

    scale_change [N] f32 is the patch scale ratio, clipped to [0.5, 2].
    Returns (p1 [N, 2], err [N], ok [N])."""
    dev = _check_common([img0], [img1], p0, p1_init, valid, radius)
    _check("scale_change", scale_change, torch.float32, (p0.shape[0],))
    if scale_change.device != dev:
        raise ValueError("scale_change must be on the same device as the images")
    if dev.type == "cpu":
        return track_scale_ref(img0, img1, p0, p1_init, scale_change, valid, radius, iters, eps)
    return _scale_launch(img0, img1, p0, p1_init, scale_change, valid, radius, iters, eps)
