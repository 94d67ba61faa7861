"""Dense rectified-stereo ZNCC disparity and per-feature match verification.

Copy of the port's `ops/stereo_disparity.py`. The
disparity cost volume is built for all D shifts at once ([D, H, W]) and the
verification scans all 2*span+1 window positions of every feature's strip at
once, instead of one Python-level pass per shift.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import interp
from .pyramid import box_filter


class DisparityResult(NamedTuple):
    disparity: torch.Tensor  # [H, W] subpixel disparity (px)
    valid: torch.Tensor  # [H, W] bool
    zncc: torch.Tensor  # [H, W] best-peak score
    inv_depth_std: torch.Tensor  # [H, W]
    ambiguous: torch.Tensor  # [H, W] strong but non-distinct peak


def zncc_disparity(left, right, max_disp: int = 64, radius: int = 4, min_zncc: float = 0.8,
                   peak_margin: float = 0.05, fxb: float = 386.0, px_noise: float = 0.5):
    """Dense disparity left->right with multi-peak rejection and parabolic
    subpixel refinement."""
    H, W = left.shape
    D = max_disp
    dev = left.device
    mu_l = box_filter(left, radius)
    var_l = box_filter(left * left, radius) - mu_l * mu_l
    mu_r = box_filter(right, radius)
    var_r = box_filter(right * right, radius) - mu_r * mu_r

    d = torch.arange(D, device=dev)
    uu = torch.arange(W, device=dev)
    src = (uu[None, :] - d[:, None]) % W  # roll by d along columns: out[u] = in[u - d]

    def roll_d(x):  # [H, W] -> [D, H, W]
        return x[:, src].permute(1, 0, 2)

    cross = box_filter(left[None] * roll_d(right), radius) - mu_l[None] * roll_d(mu_r)
    denom = torch.sqrt(torch.clamp(var_l[None] * roll_d(var_r), min=1e-6))
    scores = torch.where(uu[None, None, :] >= d[:, None, None], cross / denom, -1.0)

    best = torch.argmax(scores, dim=0)
    best_s = torch.amax(scores, dim=0)
    near = torch.abs(d[:, None, None] - best[None]) <= 2
    second_s = torch.amax(torch.where(near, -1.0, scores), dim=0)
    distinct = best_s > second_s + peak_margin

    def gather_d(offset):
        idx = torch.clamp(best + offset, 0, D - 1)
        return torch.gather(scores, 0, idx[None])[0]

    s_m = gather_d(-1)
    s_p = gather_d(1)
    den = torch.clamp(s_m - 2.0 * best_s + s_p, min=1e-9)
    delta = torch.clamp(0.5 * (s_m - s_p) / -den, -0.5, 0.5)
    interior = (best > 0) & (best < D - 1)
    disp = best.to(torch.float32) + torch.where(interior, delta, 0.0)

    textured = (best_s > min_zncc) & (var_l > 25.0)
    valid = distinct & textured & interior
    ambiguous = textured & ~distinct
    disp = torch.where(valid, disp, 0.0)
    sigma = torch.where(valid, px_noise / fxb, float("inf")).to(torch.float32)
    return DisparityResult(disp, valid, best_s, sigma, ambiguous)


def verify_disparity_zncc(left, right, pts_l, disp, valid, radius: int = 4, span: int = 32,
                          min_zncc: float = 0.5, peak_margin: float = 0.03,
                          agree_px: float = 1.5):
    """Full-resolution check of stereo matches: ZNCC-scan the epipolar row
    over disparities disp +- span; the match must correlate, be the in-window
    best (within agree_px), and have no rival local maximum more than 2 px
    away within peak_margin. Returns (ok [N] bool, score at the match [N])."""
    dev = left.device
    H, W = right.shape
    N = pts_l.shape[0]
    R = 2 * radius + 1
    W_s = 2 * (span + radius) + 1
    pad_y, pad_x = radius + 2, span + radius + 2
    pad = (pad_x, pad_x, pad_y, pad_y)
    rightp = torch.nn.functional.pad(right[None, None], pad)[0, 0]
    leftp = torch.nn.functional.pad(left[None, None], pad)[0, 0]

    def slabs(imgp, y0f, x0f, rows_out, cols_out):
        """Bilinear [N, rows_out, cols_out] blocks at float (y0f, x0f) in
        unpadded coords, one shared fraction per feature."""
        ay = torch.floor(y0f)
        ax = torch.floor(x0f)
        fy = (y0f - ay)[:, None, None]
        fx = (x0f - ax)[:, None, None]
        iy = torch.clamp(ay.to(torch.int64) + pad_y, 0, imgp.shape[0] - rows_out - 1)
        ix = torch.clamp(ax.to(torch.int64) + pad_x, 0, imgp.shape[1] - cols_out - 1)
        rr = iy[:, None] + torch.arange(rows_out + 1, device=dev)
        cc = ix[:, None] + torch.arange(cols_out + 1, device=dev)
        S = imgp[rr[:, :, None], cc[:, None, :]]
        return (
            (1 - fy) * (1 - fx) * S[:, :-1, :-1]
            + (1 - fy) * fx * S[:, :-1, 1:]
            + fy * (1 - fx) * S[:, 1:, :-1]
            + fy * fx * S[:, 1:, 1:]
        )

    patch_l = slabs(leftp, pts_l[:, 1] - radius, pts_l[:, 0] - radius, R, R).reshape(N, -1)
    mask_l = (
        (pts_l[:, 0] >= radius + 1)
        & (pts_l[:, 0] <= W - radius - 2)
        & (pts_l[:, 1] >= radius + 1)
        & (pts_l[:, 1] <= H - radius - 2)
    )
    strip = slabs(rightp, pts_l[:, 1] - radius, pts_l[:, 0] - disp - (span + radius), R, W_s)
    u_col = (
        pts_l[:, None, 0] - disp[:, None] - (span + radius)
        + torch.arange(W_s, dtype=torch.float32, device=dev)[None, :]
    )
    col_ok = (u_col >= 0.0) & (u_col <= W - 1.0)  # [N, W_s]
    row_ok = (pts_l[:, 1] - radius >= 0.0) & (pts_l[:, 1] + radius <= H - 1.0)

    # Window at strip column j0 = span - delta, for delta = -span .. span.
    n_d = 2 * span + 1
    j0 = span - torch.arange(-span, span + 1, device=dev)  # [D]
    wins = strip.unfold(2, R, 1)  # [N, R, W_s - R + 1, R]: [n, y, j, x]
    wins = wins[:, :, j0, :].permute(0, 2, 1, 3).reshape(N, n_d, R * R)
    m = col_ok.to(torch.int32).unfold(1, R, 1)[:, j0, :].all(dim=-1)  # [N, D]
    s = interp.zncc(patch_l[:, None, :].expand(N, n_d, R * R), wins, dim=-1)
    scores = torch.where(m & row_ok[:, None], s, -1.0)

    deltas = torch.arange(-span, span + 1, dtype=torch.float32, device=dev)
    s_at = scores[:, span]
    best_i = torch.argmax(scores, dim=-1)
    best_d = deltas[best_i]
    best_s = torch.amax(scores, dim=-1)
    left_n = torch.cat([torch.full_like(scores[:, :1], -2.0), scores[:, :-1]], dim=1)
    right_n = torch.cat([scores[:, 1:], torch.full_like(scores[:, :1], -2.0)], dim=1)
    is_peak = (scores > left_n) & (scores >= right_n)
    far = torch.abs(deltas[None, :] - best_d[:, None]) > 2.0
    rival = torch.any(is_peak & far & (scores > best_s[:, None] - peak_margin), dim=-1)
    ok = (
        valid
        & mask_l
        & (s_at > min_zncc)
        & (torch.abs(best_d) <= agree_px)
        & ~rival
        & (pts_l[:, 0] - disp >= 0.0)
    )
    return ok, s_at
