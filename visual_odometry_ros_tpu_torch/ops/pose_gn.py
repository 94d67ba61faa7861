"""Pose-only Gauss-Newton with Huber weights: mono and stereo, each with its
two-pass gate.

Counterpart of `visual_odometry_ros_tpu/ops/pose_gn.py`. The reference runs
its solve as a `lax.while_loop` on the device; here one launch of the
hand-written kernel `pose_gn` (csrc/pose_gn.cu) computes a whole solve on
the card: one pass (`pose_only_gn_mono`, `pose_only_gn_stereo`) or the
robust two-pass solve with its gate and arbitration
(`pose_only_gn_stereo_robust`, `pose_only_gn_mono_robust`), outputs left on
the device, no host sync. `pose_only_gn_mono_many` takes several
independent one-pass mono solves in one launch, one block each (PnP's two
polishes); the reference calls `pose_only_gn_mono` once for each.

The plain PyTorch versions (`*_ref`) define the semantics. Their loop runs
on the host and checks its stop flag once every `_CHECK_EVERY` iterations:
iterations after the stop are masked no-ops, so the result equals the while
loop's. On CPU tensors the public functions run the plain versions; on CUDA
tensors they launch the kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import geometry as geo
from ..utils.robust import huber_weight
from .kernels import build, check, one_device
from .kernels import launch as _launch

_CHECK_EVERY = 4
MAX_SOLVES = 8  # kMaxSolves of csrc/pose_gn.cuh: the solves one launch takes


class PoseGNParams(NamedTuple):
    max_iters: int = 100
    huber_delta: float = 0.5
    lam: float = 1e-5  # multiplicative LM damping on the Hessian diagonal
    step_tol: float = 1e-4
    cost_tol: float = 1e-5  # relative |dcost| / cost
    reproj_thresh: float = 1.5  # px, inlier gate for the output mask
    min_inlier_ratio: float = 0.25
    min_inliers: int = 10


class PoseGNResult(NamedTuple):
    T10: torch.Tensor  # refined pose [4, 4]
    inliers: torch.Tensor  # [N] bool
    mean_err: torch.Tensor  # mean reprojection error over valid points (px)
    ok: torch.Tensor  # scalar bool
    n_iter: torch.Tensor


def _project_jacobian(Xc: torch.Tensor, fx, fy):
    """d(pixel)/d(Xc): [N, 2, 3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def _se3_point_jacobian(Xc: torch.Tensor):
    """d(Xc)/d(xi), xi = [v, w] left perturbation: [N, 3, 6] = [I | -[Xc]x]."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    return torch.cat([eye, -geo.skew(Xc)], dim=-1)


def _solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cholesky solve; a non-positive-definite H yields NaN (no host sync),
    as the reference's Cholesky does."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def _pose_gn_core(residual_fn, T_init, valid, params: PoseGNParams, n_rows: int,
                  counts: dict | None = None) -> PoseGNResult:
    """Shared damped-GN loop. residual_fn(T) -> (r [N, n_rows], J [N, n_rows, 6]).
    `counts` (optional, host syncs) gains the work the solve needed: the
    weighted (valid) points times the iterations run, and the N points of
    the final evaluation."""
    dev = T_init.device
    w_valid = valid.to(torch.float32)
    n_valid = torch.clamp(torch.sum(w_valid), min=1.0)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    T = T_init
    prev_cost = torch.tensor(float("inf"), device=dev)
    it = torch.tensor(0, dtype=torch.int32, device=dev)
    done = torch.tensor(False, device=dev)
    for k in range(params.max_iters):
        if k % _CHECK_EVERY == 0 and k > 0 and bool(done):
            break
        r, J = residual_fn(T)
        rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
        w = huber_weight(rn, params.huber_delta) * w_valid
        cost = torch.sum(w * rn * rn) / n_valid
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        g = -torch.einsum("nri,nr->i", Jw, r)
        H = H + params.lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
        dxi = _solve6(H, g)
        bad = ~torch.all(torch.isfinite(dxi))
        T_step = torch.where(bad, T, geo.add_front_se3(T, torch.nan_to_num(dxi)))
        converged = (torch.linalg.norm(dxi) < params.step_tol) | (
            torch.abs(prev_cost - cost) < params.cost_tol * (cost + 1e-9)
        )
        # Masked no-op once done: the while loop would not have run this step.
        T = torch.where(done, T, T_step)
        prev_cost = torch.where(done, prev_cost, cost)
        it = torch.where(done, it, it + 1)
        done = done | converged | bad

    r, _ = residual_fn(T)
    err = torch.sqrt(torch.sum(r * r, dim=-1) / (n_rows // 2))
    inliers = valid & (err < params.reproj_thresh)
    # The mean over the valid points only: an invalid point's error adds
    # nothing even where it is not finite (the reference's XLA rewrites its
    # product with the 0/1 weight into a select).
    mean_err = torch.sum(torch.where(valid, err, 0.0)) / n_valid
    n_inl = torch.sum(inliers)
    ok = (
        torch.all(torch.isfinite(T))
        & (n_inl / n_valid >= params.min_inlier_ratio)
        & (n_inl >= params.min_inliers)
        & torch.isfinite(mean_err)
    )
    if counts is not None:
        rows = "mono" if n_rows == 2 else "stereo"
        for k, v in ((f"pose_point_iter_{rows}", int(valid.sum()) * int(it)),
                     (f"pose_point_eval_{rows}", valid.shape[0])):
            counts[k] = counts.get(k, 0) + v
    return PoseGNResult(T, inliers, mean_err, ok, it)


def pose_only_gn_mono_ref(X0, pts1, valid, fx, fy, cx, cy, T_10_init,
                          params: PoseGNParams = PoseGNParams(), counts: dict | None = None) -> PoseGNResult:
    """Refine T_10 so that pi(T_10 X0) matches pts1 (2 residual rows per
    point). X0 [N, 3] in frame-0 camera coordinates, pts1 [N, 2] pixels."""

    def residual_fn(T):
        Xc = geo.transform_points(T, X0)
        z = Xc[..., 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        r = torch.stack([Xc[..., 0] * iz * fx + cx, Xc[..., 1] * iz * fy + cy], dim=-1) - pts1
        J = torch.einsum("nij,njk->nik", _project_jacobian(Xc, fx, fy), _se3_point_jacobian(Xc))
        # Behind-camera points contribute nothing.
        front = (z > 0.01)[:, None]
        return torch.where(front, r, 0.0), torch.where(front[:, :, None], J, 0.0)

    return _pose_gn_core(residual_fn, T_10_init, valid, params, n_rows=2, counts=counts)


def pose_only_gn_stereo_ref(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                            T_10_init, params: PoseGNParams = PoseGNParams(),
                            counts: dict | None = None) -> PoseGNResult:
    """Stereo pose refinement with 4 residual rows per point (left u, v,
    right u, v). X0 [N, 3] in the previous left-camera frame."""
    R_rl = T_rl[:3, :3]

    def proj_rows(Xc, pts):
        z = Xc[..., 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        return torch.stack([Xc[..., 0] * iz * fx + cx, Xc[..., 1] * iz * fy + cy], dim=-1) - pts

    def residual_fn(T):
        Xl = geo.transform_points(T, X0)
        Xr = geo.transform_points(T_rl, Xl)
        r_l = proj_rows(Xl, pts_l1)
        r_r = proj_rows(Xr, pts_r1)
        Jp = _se3_point_jacobian(Xl)
        J_l = torch.einsum("nij,njk->nik", _project_jacobian(Xl, fx, fy), Jp)
        J_r = torch.einsum("nij,jm,nmk->nik", _project_jacobian(Xr, fx, fy), R_rl, Jp)
        front = (Xl[..., 2] > 0.01) & (Xr[..., 2] > 0.01)
        m_l = (front & valid_l)[:, None]
        m_r = (front & valid_r)[:, None]
        r = torch.cat([torch.where(m_l, r_l, 0.0), torch.where(m_r, r_r, 0.0)], dim=-1)
        J = torch.cat(
            [torch.where(m_l[:, :, None], J_l, 0.0), torch.where(m_r[:, :, None], J_r, 0.0)], dim=-2
        )
        return r, J

    return _pose_gn_core(residual_fn, T_10_init, valid_l, params, n_rows=4, counts=counts)


def _reproj_err_px(T, X0, pts1, fx, fy, cx, cy):
    """Per-point left-view reprojection error (px); behind-camera -> 1e6."""
    Xc = geo.transform_points(T, X0)
    z = Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = Xc[..., 0] * iz * fx + cx
    v = Xc[..., 1] * iz * fy + cy
    err = torch.sqrt((u - pts1[..., 0]) ** 2 + (v - pts1[..., 1]) ** 2)
    return torch.where(z > 0.01, err, 1e6)


def pose_only_gn_stereo_robust_ref(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                                   T_10_init, params: PoseGNParams = PoseGNParams(),
                                   gate_scale: float = 2.0, counts: dict | None = None):
    """Two-pass gated pose GN: solve, hard-gate at gate_scale x reproj_thresh
    under the better of {pass-1 pose, prior}, re-solve on survivors, and
    arbitrate on inlier counts over the common point set. `counts` as in
    `_pose_gn_core`, plus the N points of the gate.
    Returns (PoseGNResult, err_px [N] under the chosen pose)."""
    res1 = pose_only_gn_stereo_ref(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                                   T_10_init, params, counts)
    T1 = torch.where(res1.ok, res1.T10, T_10_init)
    err1 = _reproj_err_px(T1, X0, pts_l1, fx, fy, cx, cy)
    keep = valid_l & (err1 < gate_scale * params.reproj_thresh)
    res2 = pose_only_gn_stereo_ref(X0, pts_l1, pts_r1, keep, valid_r & keep, fx, fy, cx, cy, T_rl,
                                   T1, params, counts)
    err2_all = _reproj_err_px(res2.T10, X0, pts_l1, fx, fy, cx, cy)
    n1 = torch.sum(valid_l & (err1 < params.reproj_thresh))
    n2 = torch.sum(valid_l & (err2_all < params.reproj_thresh))
    use2 = res2.ok & (~res1.ok | (n2 >= n1))
    T = torch.where(use2, res2.T10, torch.where(res1.ok, res1.T10, T_10_init))
    err = _reproj_err_px(T, X0, pts_l1, fx, fy, cx, cy)
    inliers = valid_l & (err < params.reproj_thresh)
    n_fin = torch.sum(inliers)
    n_all = torch.clamp(torch.sum(valid_l), min=1)
    err_prior = _reproj_err_px(T_10_init, X0, pts_l1, fx, fy, cx, cy)
    n_prior = torch.sum(valid_l & (err_prior < params.reproj_thresh))
    ok = (
        (res1.ok | res2.ok)
        & (n_fin >= params.min_inliers)
        & (n_fin / n_all >= params.min_inlier_ratio)
        & (n_fin + 2 >= n_prior)
    )
    mean_err = torch.where(use2, res2.mean_err, res1.mean_err)
    if counts is not None:
        counts["pose_point_gate"] = counts.get("pose_point_gate", 0) + X0.shape[0]
    return PoseGNResult(T, inliers, mean_err, ok, res1.n_iter + res2.n_iter), err


def pose_only_gn_mono_robust_ref(X0, pts1, valid, fx, fy, cx, cy, T_10_init,
                                 params: PoseGNParams = PoseGNParams(), gate_scale: float = 2.0,
                                 counts: dict | None = None):
    """Mono twin of `pose_only_gn_stereo_robust_ref`: solve, hard-gate, re-solve
    on the survivors, arbitrate on inlier counts over the common point set.
    Returns (PoseGNResult, err_px [N] under the chosen pose)."""
    res1 = pose_only_gn_mono_ref(X0, pts1, valid, fx, fy, cx, cy, T_10_init, params, counts)
    T1 = torch.where(res1.ok, res1.T10, T_10_init)
    err1 = _reproj_err_px(T1, X0, pts1, fx, fy, cx, cy)
    keep = valid & (err1 < gate_scale * params.reproj_thresh)
    res2 = pose_only_gn_mono_ref(X0, pts1, keep, fx, fy, cx, cy, T1, params, counts)
    err2_all = _reproj_err_px(res2.T10, X0, pts1, fx, fy, cx, cy)
    n1 = torch.sum(valid & (err1 < params.reproj_thresh))
    n2 = torch.sum(valid & (err2_all < params.reproj_thresh))
    use2 = res2.ok & (~res1.ok | (n2 >= n1))
    T = torch.where(use2, res2.T10, torch.where(res1.ok, res1.T10, T_10_init))
    err = _reproj_err_px(T, X0, pts1, fx, fy, cx, cy)
    inliers = valid & (err < params.reproj_thresh)
    n_fin = torch.sum(inliers)
    n_all = torch.clamp(torch.sum(valid), min=1)
    err_prior = _reproj_err_px(T_10_init, X0, pts1, fx, fy, cx, cy)
    n_prior = torch.sum(valid & (err_prior < params.reproj_thresh))
    ok = (
        (res1.ok | res2.ok)
        & (n_fin >= params.min_inliers)
        & (n_fin / n_all >= params.min_inlier_ratio)
        & (n_fin + 2 >= n_prior)
    )
    mean_err = torch.where(use2, res2.mean_err, res1.mean_err)
    if counts is not None:
        counts["pose_point_gate"] = counts.get("pose_point_gate", 0) + X0.shape[0]
    return PoseGNResult(T, inliers, mean_err, ok, res1.n_iter + res2.n_iter), err


# ---------------------------------------------------------------------------
# The kernel route
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """`pose_gn::Args` of csrc/pose_gn.cuh, field for field."""

    _fields_ = [
        ("X0", ctypes.c_void_p),
        ("pts_l", ctypes.c_void_p),
        ("pts_r", ctypes.c_void_p),
        ("valid_l", ctypes.c_void_p),
        ("valid_r", ctypes.c_void_p),
        ("T_rl", ctypes.c_void_p),
        ("T_init", ctypes.c_void_p),
        ("N", ctypes.c_int),
        ("stereo", ctypes.c_int),
        ("passes", ctypes.c_int),
        ("fx", ctypes.c_float),
        ("fy", ctypes.c_float),
        ("cx", ctypes.c_float),
        ("cy", ctypes.c_float),
        ("max_iters", ctypes.c_int),
        ("huber_delta", ctypes.c_float),
        ("lam", ctypes.c_float),
        ("step_tol", ctypes.c_float),
        ("cost_tol", ctypes.c_float),
        ("reproj_thresh", ctypes.c_float),
        ("min_inlier_ratio", ctypes.c_float),
        ("min_inliers", ctypes.c_int),
        ("gate_thresh", ctypes.c_float),
        ("T_out", ctypes.c_void_p),
        ("inliers", ctypes.c_void_p),
        ("err", ctypes.c_void_p),
        ("mean_err", ctypes.c_void_p),
        ("ok", ctypes.c_void_p),
        ("n_iter", ctypes.c_void_p),
    ]


def _device(X0, pts_l, valid_l, T_init, pts_r=None, valid_r=None, T_rl=None) -> torch.device:
    """Checks the inputs as the kernel takes them (on either device); returns
    their one device."""
    f32 = torch.float32
    check("X0", X0, f32)
    N = X0.shape[0]
    check("X0", X0, f32, (N, 3))
    check("pts", pts_l, f32, (N, 2))
    check("valid", valid_l, torch.bool, (N,))
    check("T_10_init", T_init, f32, (4, 4))
    ts = [X0, pts_l, valid_l, T_init]
    if pts_r is not None:
        check("pts_r1", pts_r, f32, (N, 2))
        check("valid_r", valid_r, torch.bool, (N,))
        check("T_rl", T_rl, f32, (4, 4))
        ts += [pts_r, valid_r, T_rl]
    return one_device(ts)


def _pack(X0, pts_l, pts_r, valid_l, valid_r, T_rl, T_init, fx, fy, cx, cy,
          params: PoseGNParams, passes: int, gate_scale: float):
    """The outputs of one solve, allocated on the inputs' device, and the
    `_Args` that point the kernel at inputs and outputs (pts_r None: mono).
    Returns (PoseGNResult, err [N] or None for one pass, args)."""
    dev = X0.device
    N = X0.shape[0]
    f32 = torch.float32
    T = torch.empty((4, 4), dtype=f32, device=dev)
    inliers = torch.empty((N,), dtype=torch.bool, device=dev)
    mean_err = torch.empty((), dtype=f32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    n_iter = torch.empty((), dtype=torch.int32, device=dev)
    err = torch.empty((N,), dtype=f32, device=dev) if passes == 2 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _Args(
        ptr(X0), ptr(pts_l), ptr(pts_r), ptr(valid_l), ptr(valid_r), ptr(T_rl), ptr(T_init), N,
        int(pts_r is not None), passes, float(fx), float(fy), float(cx), float(cy),
        int(params.max_iters), float(params.huber_delta), float(params.lam), float(params.step_tol),
        float(params.cost_tol), float(params.reproj_thresh), float(params.min_inlier_ratio),
        int(params.min_inliers), float(gate_scale * params.reproj_thresh),
        ptr(T), ptr(inliers), ptr(err), ptr(mean_err), ptr(ok), ptr(n_iter),
    )
    return PoseGNResult(T, inliers, mean_err, ok, n_iter), err, args


def _pg_launch(solves):
    """One pose_gn launch on CUDA tensors: block i takes solves[i] (`_pack`'s
    arguments). Returns [(PoseGNResult, err [N] or None for one pass)], all
    on the device."""
    lib = build()
    packed = [_pack(*s) for s in solves]
    args = (_Args * len(packed))(*(p[2] for p in packed))
    dev = solves[0][0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("pose_gn", lib.pose_gn_launch, (args, len(packed), stream))
    return [(res, err) for res, err, _ in packed]


def pose_only_gn_mono(X0, pts1, valid, fx, fy, cx, cy, T_10_init,
                      params: PoseGNParams = PoseGNParams()) -> PoseGNResult:
    """Refine T_10 so that pi(T_10 X0) matches pts1 (2 residual rows per
    point). X0 [N, 3] in frame-0 camera coordinates, pts1 [N, 2] pixels,
    valid [N] bool, T_10_init [4, 4]; float32, contiguous, one device."""
    if _device(X0, pts1, valid, T_10_init).type == "cpu":
        return pose_only_gn_mono_ref(X0, pts1, valid, fx, fy, cx, cy, T_10_init, params)
    return _pg_launch([(X0, pts1, None, valid, None, None, T_10_init, fx, fy, cx, cy, params, 1, 0.0)])[0][0]


def pose_only_gn_stereo(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl, T_10_init,
                        params: PoseGNParams = PoseGNParams()) -> PoseGNResult:
    """Stereo pose refinement with 4 residual rows per point (left u, v,
    right u, v). X0 [N, 3] in the previous left-camera frame; T_rl maps
    left-camera to right-camera coordinates."""
    if _device(X0, pts_l1, valid_l, T_10_init, pts_r1, valid_r, T_rl).type == "cpu":
        return pose_only_gn_stereo_ref(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                                       T_10_init, params)
    return _pg_launch([(X0, pts_l1, pts_r1, valid_l, valid_r, T_rl, T_10_init, fx, fy, cx, cy, params, 1,
                        0.0)])[0][0]


def pose_only_gn_stereo_robust(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl,
                               T_10_init, params: PoseGNParams = PoseGNParams(),
                               gate_scale: float = 2.0):
    """Two-pass gated pose GN: solve, hard-gate at gate_scale x reproj_thresh
    under the better of {pass-1 pose, prior}, re-solve on survivors, and
    arbitrate on inlier counts over the common point set.
    Returns (PoseGNResult, err_px [N] under the chosen pose)."""
    if _device(X0, pts_l1, valid_l, T_10_init, pts_r1, valid_r, T_rl).type == "cpu":
        return pose_only_gn_stereo_robust_ref(X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy,
                                              T_rl, T_10_init, params, gate_scale)
    return _pg_launch([(X0, pts_l1, pts_r1, valid_l, valid_r, T_rl, T_10_init, fx, fy, cx, cy, params, 2,
                        gate_scale)])[0]


def pose_only_gn_mono_robust(X0, pts1, valid, fx, fy, cx, cy, T_10_init,
                             params: PoseGNParams = PoseGNParams(), gate_scale: float = 2.0):
    """Mono twin of `pose_only_gn_stereo_robust`.
    Returns (PoseGNResult, err_px [N] under the chosen pose)."""
    if _device(X0, pts1, valid, T_10_init).type == "cpu":
        return pose_only_gn_mono_robust_ref(X0, pts1, valid, fx, fy, cx, cy, T_10_init, params,
                                            gate_scale)
    return _pg_launch([(X0, pts1, None, valid, None, None, T_10_init, fx, fy, cx, cy, params, 2,
                        gate_scale)])[0]


def pose_only_gn_mono_many_ref(solves, params: PoseGNParams = PoseGNParams(),
                               counts: dict | None = None) -> list:
    """The plain version of `pose_only_gn_mono_many`: the solves in turn."""
    return [pose_only_gn_mono_ref(*s, params, counts=counts) for s in solves]


def pose_only_gn_mono_many(solves, params: PoseGNParams = PoseGNParams()) -> list:
    """Several independent `pose_only_gn_mono` solves in one launch, one
    block each. `solves`: 1 to MAX_SOLVES tuples (X0, pts1, valid, fx, fy,
    cx, cy, T_10_init), all on one device. Returns their PoseGNResults in
    order, each equal to its own `pose_only_gn_mono` call."""
    if not 1 <= len(solves) <= MAX_SOLVES:
        raise ValueError(f"pose_only_gn_mono_many: 1 to {MAX_SOLVES} solves, got {len(solves)}")
    for s in solves:
        _device(s[0], s[1], s[2], s[7])
    if one_device([s[0] for s in solves]).type == "cpu":
        return pose_only_gn_mono_many_ref(solves, params)
    return [res for res, _ in _pg_launch([(X0, pts1, None, valid, None, None, T_init, fx, fy, cx, cy, params, 1,
                                           0.0) for X0, pts1, valid, fx, fy, cx, cy, T_init in solves])]
