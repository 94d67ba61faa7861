"""Sliding-window bundle adjustment: Schur complement over a dense [M, K]
observation incidence.

Counterpart of `visual_odometry_ros_tpu/ops/ba.py`. Same anchoring at the
first window keyframe, same Huber IRLS rows (left and right camera), same
Jacobi-equilibrated float32 Cholesky of the reduced camera system — no
float64 anywhere. With a process group (`group=`, the counterpart of the
reference's `axis_name`), each rank holds a shard of the landmark axis and
the sums that cross landmarks are all-reduced over the group
(`parallel/dist_ba.py`).

The reference runs its GN loop as a `lax.while_loop` on the device. Here,
on CUDA tensors, the solve is the hand-written kernels `ba_terms`,
`ba_solve` and `ba_backsub`, whose last block decides the apply step
(csrc/ba_gn.cu, algorithm in csrc/ba_gn.cuh), the anchoring and the
write-back included: a single-device
solve enqueues `launches_per_solve(iters)` launches and reads nothing back;
iterations after the stop are no-ops on the device. The plain PyTorch
version, `ba_solve_ref`, defines the semantics and is the CPU route;
`ba_solve_impl` runs it on CPU tensors and the kernels on CUDA tensors, or
raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils import geometry as geo
from ..utils.robust import huber_weight
from . import kernels as KN
from .kernels import launch as _launch


class BAProblem(NamedTuple):
    T_cw: torch.Tensor  # [K, 4, 4] world->camera poses
    Xw: torch.Tensor  # [M, 3] world points
    pts: torch.Tensor  # [M, K, 2] observed pixels (left cam)
    mask: torch.Tensor  # [M, K] bool
    pts_r: torch.Tensor  # [M, K, 2] right-cam pixels
    mask_r: torch.Tensor  # [M, K] bool
    kf_valid: torch.Tensor  # [K] bool
    lm_valid: torch.Tensor  # [M] bool


class BAParams(NamedTuple):
    iters: int = 10
    n_fix: int = 2  # oldest keyframes held fixed
    huber_delta: float = 1.0  # px
    lam: float = 1e-5  # multiplicative diagonal damping
    max_trans_update: float = 50.0  # divergence guard
    kill_dist: float = 3000.0  # landmark kill radius
    min_obs: int = 2  # landmarks need >= 2 window observations


class BAResult(NamedTuple):
    T_cw: torch.Tensor  # [K, 4, 4]
    Xw: torch.Tensor  # [M, 3]
    killed: torch.Tensor  # [M]
    mean_err_px: torch.Tensor  # masked mean reprojection error after the solve
    n_obs: torch.Tensor
    mean_err0_px: torch.Tensor  # the same error before the solve


def _proj_jac(Xc, fx, fy):
    """[..., 3] -> [..., 2, 3] Jacobian of the pinhole projection."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        ],
        dim=-2,
    )


def _inv3x3(C):
    """Batched closed-form 3x3 inverse via adjugate. C [..., 3, 3]."""
    a00, a01, a02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    a10, a11, a12 = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    a20, a21, a22 = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
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
    inv_det = 1.0 / torch.where(
        torch.abs(det) < 1e-12, torch.where(det < 0, -1e-12, 1e-12), det
    )
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def build_observation_terms(T_cr, Xr, pts, mask, pts_r, mask_r, fx, fy, cx, cy, T_rl, huber_delta):
    """Residuals and Jacobian blocks for every (landmark m, keyframe k).
    Returns (w [M,K,4], r [M,K,4], Q [M,K,4,6], Rj [M,K,4,3])."""
    R = T_cr[:, :3, :3]
    t = T_cr[:, :3, 3]
    Xc = torch.einsum("kij,mj->mki", R, Xr) + t[None]  # [M, K, 3]
    z_ok = Xc[..., 2] > 0.05
    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / torch.where(torch.abs(Xc[..., 2]) < 1e-6, 1e-6, Xc[..., 2])
    xiz, yiz = x * iz, y * iz
    r_l = torch.stack([xiz * fx + cx, yiz * fy + cy], dim=-1) - pts

    one = torch.ones_like(iz)
    zero = torch.zeros_like(iz)
    qu = torch.stack(
        [fx * iz, zero, -fx * xiz * iz, -fx * xiz * yiz, fx * (one + xiz * xiz), -fx * yiz], dim=-1
    )
    qv = torch.stack(
        [zero, fy * iz, -fy * yiz * iz, -fy * (one + yiz * yiz), fy * xiz * yiz, fy * xiz], dim=-1
    )
    Q_l = torch.stack([qu, qv], dim=-2)
    Rj_l = torch.stack(
        [
            fx * iz[..., None] * (R[None, :, 0, :] - xiz[..., None] * R[None, :, 2, :]),
            fy * iz[..., None] * (R[None, :, 1, :] - yiz[..., None] * R[None, :, 2, :]),
        ],
        dim=-2,
    )
    m_l = (mask & z_ok).to(torch.float32)

    R_rl = T_rl[:3, :3]
    t_rl = T_rl[:3, 3]
    Xrc = torch.einsum("ij,mkj->mki", R_rl, Xc) + t_rl
    zr_ok = Xrc[..., 2] > 0.05
    xr, yr = Xrc[..., 0], Xrc[..., 1]
    izr = 1.0 / torch.where(torch.abs(Xrc[..., 2]) < 1e-6, 1e-6, Xrc[..., 2])
    r_r = torch.stack([xr * izr * fx + cx, yr * izr * fy + cy], dim=-1) - pts_r
    dpiR = torch.stack(
        [
            fx * izr[..., None] * (R_rl[None, None, 0, :] - (xr * izr)[..., None] * R_rl[None, None, 2, :]),
            fy * izr[..., None] * (R_rl[None, None, 1, :] - (yr * izr)[..., None] * R_rl[None, None, 2, :]),
        ],
        dim=-2,
    )
    Q_r = torch.cat([dpiR, torch.linalg.cross(Xc[..., None, :].expand_as(dpiR), dpiR)], dim=-1)
    Rj_r = torch.sum(dpiR[..., :, :, None] * R[None, :, None, :, :], dim=-2)
    m_r = (mask_r & zr_ok).to(torch.float32)

    r = torch.cat([r_l, r_r], dim=-1)
    Q = torch.cat([Q_l, Q_r], dim=-2)
    Rj = torch.cat([Rj_l, Rj_r], dim=-2)
    rn_l = torch.sqrt(torch.sum(r_l * r_l, dim=-1) + 1e-12)
    rn_r = torch.sqrt(torch.sum(r_r * r_r, dim=-1) + 1e-12)
    w_l = huber_weight(rn_l, huber_delta) * m_l
    w_r = huber_weight(rn_r, huber_delta) * m_r
    w = torch.cat([w_l[..., None].expand(w_l.shape + (2,)), w_r[..., None].expand(w_r.shape + (2,))], dim=-1)
    return w, r, Q, Rj


def assemble_normal_blocks(w, r, Q, Rj):
    """Returns A [K,6,6], a [K,6], C [M,3,3], b [M,3], B [M,K,6,3]."""
    wQ = Q * w[..., None]
    A = torch.einsum("mkra,mkrb->kab", wQ, Q)
    a = -torch.einsum("mkra,mkr->ka", wQ, r)
    wR = Rj * w[..., None]
    C = torch.sum(wR[..., :, :, None] * Rj[..., :, None, :], dim=(-4, -3))
    b = -torch.sum(wR * r[..., None], dim=(-3, -2))
    B = torch.sum(wQ[..., :, :, None] * Rj[..., :, None, :], dim=-3)
    return A, a, C, b, B


def schur_reduce(A, a, C, b, B, lam):
    """Damp and eliminate the landmark block.
    Returns (S [K,K,6,6], s [K,6], Cinv [M,3,3], BCinv [M,K,6,3])."""
    K = A.shape[0]
    M = C.shape[0]
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    A = A + lam * A * eye6
    C = C + lam * C * eye3
    C = C + 1e-6 * eye3
    Cinv = _inv3x3(C)
    BCinv = torch.sum(B[..., :, :, None] * Cinv[:, None, None, :, :], dim=-2)
    X1 = BCinv.permute(1, 2, 0, 3).reshape(K * 6, M * 3)
    X2 = B.permute(0, 3, 1, 2).reshape(M * 3, K * 6)
    S_off = torch.matmul(X1, X2).reshape(K, 6, K, 6).permute(0, 2, 1, 3)
    eyeK = torch.eye(K, dtype=A.dtype, device=A.device)
    S = -S_off + eyeK[:, :, None, None] * A[:, None, :, :]
    sb = torch.matmul(X1, b.reshape(M * 3))
    return S, a - sb.reshape(K, 6), Cinv, BCinv


def equilibrated_system(S, s, opt_mask):
    """solve_reduced's system [6K, 6K]: the fixed and empty slots gated to
    unit rows, Jacobi-equilibrated, + 1e-7 I. Returns (Hn, the right-hand
    side times dinv, dinv)."""
    n = 6 * S.shape[0]
    om = opt_mask.to(S.dtype)
    S = S * (om[:, None] * om[None, :])[:, :, None, None]
    H = S.permute(0, 2, 1, 3).reshape(n, n)
    rhs = (s * om[:, None]).reshape(n)
    keep = om.repeat_interleave(6)
    H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
    dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hn = H * dinv[:, None] * dinv[None, :] + 1e-7 * torch.eye(n, dtype=H.dtype, device=H.device)
    return Hn, rhs * dinv, dinv


def solve_reduced(S, s, opt_mask):
    """Solve the reduced camera system for the optimizable keyframes with a
    Jacobi-equilibrated float32 Cholesky; fixed or empty slots get dx = 0."""
    Hn, z, dinv = equilibrated_system(S, s, opt_mask)
    L, info = torch.linalg.cholesky_ex(Hn)
    L = torch.where(info == 0, L, torch.nan)  # as the reference: NaN, caught by the guard
    y = torch.linalg.solve_triangular(L, z[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0] * dinv
    return x.reshape(S.shape[0], 6) * opt_mask.to(S.dtype)[:, None]


def back_substitute(Cinv, b, B, dx):
    """dy_i = Cinv_i (b_i - sum_j B_ij^T dx_j) — [M, 3]."""
    Btx = torch.sum(B * dx[None, :, :, None], dim=(1, 2))
    return torch.sum(Cinv * (b - Btx)[:, None, :], dim=-1)


def ba_accept(mean_err_px, mean_err0_px, reproj_thresh: float):
    """Window-BA acceptance rule: finite and either materially improved under
    a hard ceiling (6.5x the pose gate) or roughly flat under a tight one
    (2.5x)."""
    improved = mean_err_px <= mean_err0_px * 0.98
    flat = mean_err_px <= mean_err0_px * 1.05 + 0.1
    return torch.isfinite(mean_err_px) & (
        (improved & (mean_err_px < 6.5 * reproj_thresh)) | (flat & (mean_err_px < 2.5 * reproj_thresh))
    )


# All-reduces issued by solves over a process group (the counterpart of
# `kernels.LAUNCHES` for the distributed path): one per call of
# `_all_reduce`, whatever it packs, and the bytes of the buffers reduced.
COLLECTIVES = {"all_reduce": 0, "bytes": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _all_reduce(*xs: torch.Tensor, group) -> tuple:
    """The sums of xs over the ranks of `group`, in one all-reduce: xs are
    packed into one flat float32 buffer, reduced and unpacked to their own
    shapes and dtypes. Without a group, xs themselves. Integer xs are counts,
    exact in float32 below 2**24 (M * K observations)."""
    if group is None:
        return xs
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs])  # a new dense buffer, as NCCL needs
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["bytes"] += flat.numel() * flat.element_size()
    out = []
    for x, part in zip(xs, torch.split(flat, [x.numel() for x in xs])):
        out.append(part.reshape(x.shape).to(x.dtype))
    return tuple(out)


class _Anchored(NamedTuple):
    """The solve's masks and the anchored start (ops/ba.py of the reference,
    ba_solve_impl's prologue)."""

    mask: torch.Tensor  # [M, K] observation & live keyframe & active landmark
    mask_r: torch.Tensor
    lm_active: torch.Tensor  # [M]
    opt_mask: torch.Tensor  # [K] live keyframes beyond the first n_fix
    T_rw: torch.Tensor
    T_wr: torch.Tensor
    T_cr: torch.Tensor  # [K, 4, 4] poses anchored at window slot 0
    Xr: torch.Tensor  # [M, 3]


def opt_mask(kf_valid: torch.Tensor, params: BAParams) -> torch.Tensor:
    """The slots a solve optimises: live ones past the first n_fix (the
    kernels' `opt_slot`)."""
    return kf_valid & (torch.arange(kf_valid.shape[0], device=kf_valid.device) >= params.n_fix)


def n_opt(kf_valid: torch.Tensor, params: BAParams) -> int:
    """How many slots a solve optimises (`opt_mask`'s count; a host read
    where kf_valid lies on the card). A window of K slots all live has the
    most: n_opt(torch.ones(K, dtype=torch.bool), params)."""
    return int(opt_mask(kf_valid, params).sum())


def _anchor(problem: BAProblem, params: BAParams) -> _Anchored:
    obs_mask = problem.mask & problem.kf_valid[None, :]
    obs_mask_r = problem.mask_r & problem.kf_valid[None, :]
    lm_active = problem.lm_valid & (torch.sum(obs_mask, dim=1) >= params.min_obs)
    T_rw = problem.T_cw[0]
    T_wr = geo.se3_inverse(T_rw)
    return _Anchored(
        mask=obs_mask & lm_active[:, None], mask_r=obs_mask_r & lm_active[:, None], lm_active=lm_active,
        opt_mask=opt_mask(problem.kf_valid, params),
        T_rw=T_rw, T_wr=T_wr, T_cr=problem.T_cw @ T_wr, Xr=geo.transform_points(T_rw, problem.Xw),
    )


def _write_back(problem: BAProblem, params: BAParams, an: _Anchored, T_cr, Xr, err, n_l, n_r,
                mean_err0) -> BAResult:
    """The solved window back in the world frame (optimised poses
    re-orthonormalised, the others bit-identical), the kill rule and the
    error after the solve, from its sums (err, n_l) and the right-row count."""
    T_cw_new = torch.where(an.opt_mask[:, None, None], geo.se3_project(T_cr @ an.T_rw), problem.T_cw)
    Xw_new = torch.where(an.lm_active[:, None], geo.transform_points(an.T_wr, Xr), problem.Xw)
    killed = an.lm_active & (torch.linalg.norm(Xr, dim=-1) > params.kill_dist)
    return BAResult(T_cw_new, Xw_new, killed, err / torch.clamp(n_l, min=1), n_l + n_r, mean_err0)


def ba_solve_ref(problem: BAProblem, fx, fy, cx, cy, T_rl, params: BAParams = BAParams(),
                 group=None, info: dict | None = None) -> BAResult:
    """The plain PyTorch version of `ba_solve_impl` (same arguments and
    result): the GN loop on the host, one host read per iteration for the
    stop test. The CPU route, and the reference the kernels are held to."""
    an = _anchor(problem, params)
    mask, mask_r, lm_active, opt_mask = an.mask, an.mask_r, an.lm_active, an.opt_mask
    T_cr, Xr = an.T_cr, an.Xr

    def err_sums(T_cr_e, Xr_e):
        """The masked left-row reprojection error's sum (px) and count."""
        _, r_, _, _ = build_observation_terms(
            T_cr_e, Xr_e, problem.pts, mask, problem.pts_r, mask_r, fx, fy, cx, cy, T_rl, 1e9
        )
        rn_ = torch.sqrt(torch.sum(r_[..., :2] ** 2, dim=-1))
        return torch.sum(rn_ * mask), torch.sum(mask)

    err0, n0 = _all_reduce(*err_sums(T_cr, Xr), group=group)
    mean_err0 = err0 / torch.clamp(n0, min=1)
    it = 0
    while it < params.iters:
        w, r, Q, Rj = build_observation_terms(
            T_cr, Xr, problem.pts, mask, problem.pts_r, mask_r, fx, fy, cx, cy, T_rl,
            params.huber_delta,
        )
        A, a, C, b, B = assemble_normal_blocks(w, r, Q, Rj)
        S, s, Cinv, _ = schur_reduce(A, a, C, b, B, params.lam)
        # dy comes from the reduced system's dx, so its divergence flag is
        # taken from what it is built of, before the reduction: a non-finite
        # Cinv, b or B on an active landmark makes that landmark's dy
        # non-finite. The count travels with (S, s) in one all-reduce.
        rows_bad = lm_active & ~(torch.isfinite(Cinv).all(dim=(1, 2)) & torch.isfinite(b).all(dim=1)
                                 & torch.isfinite(B).all(dim=(1, 2, 3)))
        S, s, n_bad = _all_reduce(S, s, torch.sum(rows_bad), group=group)
        dx = solve_reduced(S, s, opt_mask)
        dy = torch.where(lm_active[:, None], back_substitute(Cinv, b, B, dx), 0.0)
        dy_bad = n_bad > 0
        if group is None:
            # One device holds all of dy: the reference's own test, which
            # also sees a product that overflows.
            dy_bad = dy_bad | ~torch.all(torch.isfinite(dy))
        bad = (
            ~torch.all(torch.isfinite(dx))
            | dy_bad
            | (torch.amax(torch.linalg.norm(dx[:, :3], dim=-1)) > params.max_trans_update)
        )
        dx = torch.where(bad, 0.0, dx)
        dy = torch.where(bad, 0.0, dy)
        T_cr = torch.where(opt_mask[:, None, None], geo.add_front_se3(T_cr, dx), T_cr)
        Xr = Xr + dy
        it += 1
        if bool(torch.amax(torch.abs(dx)) < 1e-5):
            break
    if info is not None:
        info["iters"] = it

    err, n_l, n_r = _all_reduce(*err_sums(T_cr, Xr), torch.sum(mask_r), group=group)
    return _write_back(problem, params, an, T_cr, Xr, err, n_l, n_r, mean_err0)


# ---------------------------------------------------------------------------
# The kernel route
# ---------------------------------------------------------------------------

# csrc/ba_gn.cuh's constants, sizes and `Args`, restated here; `check_layout`
# holds them to the library's own when it is bound (kernels.bind_ba).
MAX_K = 16  # kMaxK: the kernels' largest window
_TL = 16  # kTL landmarks per tile
_TERMS, _ERR_INIT, _ERR_FINAL = 0, 1, 2  # ba_terms modes
_SUM, _SOLVE = 1, 2  # ba_solve phases
# The tile launches run one block on each SM. The host build (CPU tensors)
# runs the H100's 132, so that the CPU tests sum the partials in the card's
# block order.
_HOST_SMS = 132


def _sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of `dev` (the host build's _HOST_SMS on the
    CPU)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else _HOST_SMS


def launches_per_solve(iters: int) -> int:
    """Kernel launches a single-device solve of `iters` iterations enqueues:
    the starting error, three per iteration (ba_terms, ba_solve and
    ba_backsub, whose last block decides the apply step; whether or not the
    loop has stopped: a stopped iteration's launches return at once), the
    final error. A group solve of n iterations run makes 4 n + 2."""
    return 3 * iters + 2


def n_part(n: int) -> int:
    """Floats of one tile block's partial sums over n optimisable slots
    (ba_gn.cuh n_part): A, a, the lower block triangle of S_off, sb, the
    divergence count."""
    return 48 * n + 18 * n * (n + 1) + 1


def n_sys(n: int) -> int:
    """Floats of the kernels' reduced system over n optimisable slots (S's
    lower block triangle, s, the divergence count): the buffer the group path
    all-reduces."""
    return 18 * n * (n + 1) + 6 * n + 1


def blk_rows(n: int) -> int:
    """Rows of the landmark blocks that ba_terms stores for ba_backsub, M
    floats each (ba_gn.cuh blk_rows): Cinv, b, and B per optimisable slot."""
    return 12 + 18 * n


class _Args(ctypes.Structure):
    """`ba_gn::Args` of csrc/ba_gn.cuh, field for field."""

    _fields_ = [
        *((n, ctypes.c_void_p) for n in ("T_cw", "Xw", "pts", "pts_r", "mask", "mask_r", "kf_valid", "lm_valid",
                                         "T_rl")),
        ("M", ctypes.c_int),
        ("K", ctypes.c_int),
        *((n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy", "huber_delta", "lam", "max_trans_update",
                                        "kill_dist")),
        *((n, ctypes.c_int) for n in ("iters", "n_fix", "min_obs", "group", "n_blocks")),
        *((n, ctypes.c_void_p) for n in ("T_out", "X_out", "killed", "T", "X", "half", "stop_at", "live", "active",
                                         "list", "n_act", "part", "err_part", "sys", "dx", "T_new", "blk", "step_bad",
                                         "dx_max", "n_dy", "ticket")),
    ]


def check_layout(lib: ctypes.CDLL) -> None:
    """Raise unless `lib`'s `ba_layout` (csrc/ba_gn.cuh's constants, n_part,
    n_sys and blk_rows at every count of optimisable slots, sizeof(Args) and
    its field offsets) equals what this module restates: a drift would
    corrupt device memory silently."""
    fields = [f for f, _ in _Args._fields_]
    for n in range(MAX_K + 1):
        want = [MAX_K, _TL, _TERMS, _ERR_INIT, _ERR_FINAL, _SUM, _SOLVE, n_part(n), n_sys(n), blk_rows(n),
                ctypes.sizeof(_Args), *(getattr(_Args, f).offset for f in fields)]
        buf = (ctypes.c_int * len(want))()
        got = lib.ba_layout(n, buf, len(want))
        if got != len(want) or list(buf) != want:
            raise RuntimeError(f"ops/ba.py and csrc/ba_gn.cuh disagree on the kernels' layout at {n} optimisable "
                               f"slots: library {list(buf)[:got]} ({got} ints), ops/ba.py {want}")


def _check(problem: BAProblem, T_rl) -> torch.device:
    """Checks the problem as the kernels take it (on either device); returns
    its one device."""
    f32, b8 = torch.float32, torch.bool
    K, M = problem.T_cw.shape[0], problem.Xw.shape[0]
    for name, shape, dtype in (("T_cw", (K, 4, 4), f32), ("Xw", (M, 3), f32), ("pts", (M, K, 2), f32),
                               ("mask", (M, K), b8), ("pts_r", (M, K, 2), f32), ("mask_r", (M, K), b8),
                               ("kf_valid", (K,), b8), ("lm_valid", (M,), b8)):
        KN.check(name, getattr(problem, name), dtype, shape, contiguous=False)
    KN.check("T_rl", T_rl, f32, (4, 4), contiguous=False)
    return KN.one_device([*problem, T_rl])


def _result(outs: dict, e0, e1) -> BAResult:
    """The kernels' result: the written-back window (`outs`) and the error
    sums before, e0 = (error, left rows), and after, e1 = (error, left rows,
    right rows)."""
    return BAResult(outs["T_out"], outs["X_out"], outs["killed"], e1[0] / torch.clamp(e1[1], min=1),
                    (e1[1] + e1[2]).to(torch.int64), e0[0] / torch.clamp(e0[1], min=1))


def _ba_kernels(problem: BAProblem, fx, fy, cx, cy, T_rl, params: BAParams, group, info, lib,
                launch=None, stream=None) -> BAResult:
    """The kernel route: the launch sequence of csrc/ba_gn.cuh through
    `lib`'s three launchers, `launch(name, c_fn, argv)` per launch (default
    `kernels.launch`, which counts it). The first launch anchors the problem
    and the last writes it back. On one device nothing is read back (`info`,
    where given, reads the iteration count once at the end). With a group,
    ba_solve's sum and solve phases sit on both sides of the all-reduce of
    (S, s, n_bad), whose size the host reads once (the count of optimisable
    slots), and the host reads the stop flag once per iteration. The state's
    T and X hold two halves each (the state, and as it was before the last
    step); `bufs["T"]` and `bufs["X"]` view the first."""
    K, M = problem.T_cw.shape[0], problem.Xw.shape[0]
    if K > MAX_K:
        raise ValueError(f"ba kernels: a window of {K} keyframes, at most {MAX_K}")
    dev = problem.T_cw.device
    G = max(1, min(_sm_count(dev), -(-M // _TL)))
    most = n_opt(torch.ones(K, dtype=torch.bool), params)  # the scratch's size: no host read

    def empty(n, dtype=torch.float32):
        return torch.empty(n, dtype=dtype, device=dev)

    ins = {name: t.contiguous() for name, t in zip(BAProblem._fields, problem)}
    ins["T_rl"] = T_rl.contiguous()
    outs = dict(T_out=torch.empty_like(ins["T_cw"]), X_out=torch.empty_like(ins["Xw"]), killed=empty(M, torch.bool))
    stop_at, err_part, sys_ = empty(1, torch.int32), empty(6 * G), empty(n_sys(most))
    bufs = dict(T=empty(2 * 16 * K)[:16 * K], X=empty(2 * 3 * M)[:3 * M], half=empty(1, torch.int32),
                stop_at=stop_at, live=empty(1, torch.int32), active=empty(M, torch.bool), list=empty(M, torch.int32),
                n_act=empty(1, torch.int32), part=empty(G * n_part(most)), err_part=err_part, sys=sys_,
                dx=empty(6 * K), T_new=empty(16 * K), blk=empty(blk_rows(most) * M), step_bad=empty(1, torch.int32),
                dx_max=empty(1), n_dy=empty(1, torch.int32), ticket=empty(1, torch.int32))
    args = _Args(**{k: v.data_ptr() for k, v in {**ins, **outs, **bufs}.items()}, M=M, K=K, fx=float(fx),
                 fy=float(fy), cx=float(cx), cy=float(cy), huber_delta=float(params.huber_delta),
                 lam=float(params.lam), max_trans_update=float(params.max_trans_update),
                 kill_dist=float(params.kill_dist), iters=int(params.iters), n_fix=int(params.n_fix),
                 min_obs=int(params.min_obs), group=int(group is not None), n_blocks=G)
    args.tensors = (ins, outs, bufs)  # what it points at lives as long as it does (a replay of its launches)
    ref = ctypes.byref(args)

    launch = launch or _launch

    def go(name, *argv):
        launch(name, getattr(lib, name + "_launch"), (ref, *argv, stream))

    sums = err_part.view(2, G, 3)
    go("ba_terms", -1, _ERR_INIT)
    if group is not None:
        e0 = _all_reduce(sums[0, :, :2].sum(dim=0), group=group)[0]
        system = sys_[:n_sys(n_opt(ins["kf_valid"], params))]
    for it in range(params.iters):
        go("ba_terms", it, _TERMS)
        if group is None:
            go("ba_solve", it, _SUM | _SOLVE)
        else:
            go("ba_solve", it, _SUM)
            system.copy_(_all_reduce(system, group=group)[0])
            go("ba_solve", it, _SOLVE)
        go("ba_backsub", it)
        if group is not None and int(stop_at) == it + 1:
            break
    go("ba_terms", -1, _ERR_FINAL)
    if info is not None:
        info["iters"] = int(stop_at)
    if group is None:
        e0, e1 = sums.sum(dim=1)
    else:
        e1 = _all_reduce(sums[1].sum(dim=0), group=group)[0]
    return _result(outs, e0, e1)


def ba_solve_impl(problem: BAProblem, fx, fy, cx, cy, T_rl, params: BAParams = BAParams(),
                  group=None, info: dict | None = None) -> BAResult:
    """Up to `params.iters` damped GN iterations of sliding-window BA; stops
    early once the largest pose update is below 1e-5. `info`, where given,
    receives the number of iterations run under "iters".

    The problem's tensors and T_rl (float32 and bool, shapes as BAProblem
    says) lie on one device. On the CPU this is `ba_solve_ref`; on a CUDA
    device the `ba_*` kernels, for windows of at most MAX_K keyframes.

    With a process group, the landmark rows of `problem` (Xw, pts, mask,
    pts_r, mask_r, lm_valid) are this rank's shard and T_cw, kf_valid are
    replicated. Assembly, elimination and back-substitution stay
    shard-local. A solve of n iterations makes n + 2 all-reduces: the
    starting error's sums; per iteration, the reduced camera system (S, s)
    with the dy divergence count (the kernels reduce only the optimisable
    slots' lower block triangle of it, `n_sys`); the final error's sums with
    the observation counts. Every rank then solves the same system
    the same way, so dx, the stop test and the loop's length agree across
    ranks; dy is shard-local and must not feed the stop test."""
    if _check(problem, T_rl).type == "cpu":
        return ba_solve_ref(problem, fx, fy, cx, cy, T_rl, params, group, info)
    lib = KN.build()
    dev = problem.T_cw.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _ba_kernels(problem, fx, fy, cx, cy, T_rl, params, group, info, lib, stream=stream)
