"""FAST detection, Harris scoring, bucketed selection, rotated-BRIEF
descriptors, Hamming matching.

Copy of the port's `ops/features.py`. Selection breaks score ties
by the lower bin index — the order `jax.lax.top_k` documents — via a stable
sort, so the two packages select and order features alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .pyramid import box_filter, scharr_gradients

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise, (du, dv).
_FAST_RING = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]


def fast_corner_mask(img: torch.Tensor, thresh: float = 20.0) -> torch.Tensor:
    """FAST-9/16: >= 9 contiguous ring pixels all brighter than I+t or all
    darker than I-t (ring reads wrap around the image, as jnp.roll does)."""
    ring = torch.stack([torch.roll(img, shifts=(-dv, -du), dims=(0, 1)) for du, dv in _FAST_RING])
    hi = img + thresh
    lo = img - thresh
    weights = (1 << torch.arange(16, dtype=torch.int64, device=img.device))[:, None, None]

    def arc9(mask16):
        bits = torch.sum(mask16.to(torch.int64) * weights, dim=0)
        m = bits | (bits << 16)
        a = m & (m >> 1)
        b = a & (a >> 2)
        c = b & (b >> 4)
        d = c & (m >> 8)  # 9 consecutive
        return (d & 0xFFFF) != 0

    return arc9(ring > hi[None]) | arc9(ring < lo[None])


def harris_response(img: torch.Tensor, radius: int = 2, k: float = 0.04) -> torch.Tensor:
    gx, gy = scharr_gradients(img)
    sxx = box_filter(gx * gx, radius)
    sxy = box_filter(gx * gy, radius)
    syy = box_filter(gy * gy, radius)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def occupancy_grid(pts, valid, H: int, W: int, gh: int, gw: int) -> torch.Tensor:
    """[gh, gw] count of live features per bin."""
    bu = torch.clamp((pts[:, 0] / (W / gw)).to(torch.int64), 0, gw - 1)
    bv = torch.clamp((pts[:, 1] / (H / gh)).to(torch.int64), 0, gh - 1)
    counts = torch.zeros(gh * gw, dtype=torch.int32, device=pts.device)
    counts = counts.index_add(0, bv * gw + bu, valid.to(torch.int32))
    return counts.reshape(gh, gw)


def select_grid_features(score, occupied, gh: int, gw: int, n_max: int, score_min: float = 1.0,
                         border: int = 8):
    """At most one best corner per empty bin, then the global top `n_max`.
    Returns (pts [n_max, 2] float32, valid [n_max] bool)."""
    H, W = score.shape
    dev = score.device
    bh = -(-H // gh)
    bw = -(-W // gw)
    s = torch.full((bh * gh, bw * gw), float("-inf"), dtype=score.dtype, device=dev)
    s[:H, :W] = score
    uu = torch.arange(bw * gw, device=dev)[None, :]
    vv = torch.arange(bh * gh, device=dev)[:, None]
    s = torch.where((uu < border) | (vv < border) | (uu >= W - border) | (vv >= H - border),
                    float("-inf"), s)
    blocks = s.reshape(gh, bh, gw, bw).permute(0, 2, 1, 3).reshape(gh * gw, bh * bw)
    best, arg = torch.max(blocks, dim=1)
    # torch.max's index of a repeated maximum is not specified; the first one is.
    arg = torch.argmax((blocks == best[:, None]).to(torch.int8), dim=1)
    gi = torch.arange(gh * gw, device=dev)
    u = (gi % gw) * bw + arg % bw
    v = (gi // gw) * bh + arg // bw
    ok = (best > score_min) & ~occupied.reshape(-1)
    key = torch.where(ok, best, float("-inf"))
    if key.shape[0] < n_max:
        pad = n_max - key.shape[0]
        key = torch.cat([key, torch.full((pad,), float("-inf"), dtype=key.dtype, device=dev)])
        u = torch.cat([u, torch.zeros(pad, dtype=u.dtype, device=dev)])
        v = torch.cat([v, torch.zeros(pad, dtype=v.dtype, device=dev)])
    top_val, top_idx = torch.sort(key, descending=True, stable=True)
    top_val, top_idx = top_val[:n_max], top_idx[:n_max]
    pts = torch.stack([u[top_idx].to(torch.float32), v[top_idx].to(torch.float32)], dim=-1)
    return pts, top_val > float("-inf")


def detect_features(img, prev_pts, prev_valid, gh: int = 8, gw: int = 16, n_max: int = 256,
                    fast_thresh: float = 15.0, score_min: float = 100.0, border: int = 8):
    """FAST + Harris re-scoring + bucketing, skipping bins that hold live tracks."""
    corners = fast_corner_mask(img, fast_thresh)
    score = torch.where(corners, harris_response(img), float("-inf"))
    occ = occupancy_grid(prev_pts, prev_valid, img.shape[0], img.shape[1], gh, gw) > 0
    return select_grid_features(score, occ, gh, gw, n_max, score_min, border)


# ----------------------------------------------------------------------------
# ORB descriptors (rotated BRIEF-256). Pattern tables are rebuilt from the same
# seeded numpy draw as the reference, so both packages sample the same pairs.
# ----------------------------------------------------------------------------

_rng = np.random.default_rng(12345)
_BRIEF_PAIRS = np.clip(_rng.normal(0.0, 6.2, size=(256, 2, 2)), -15, 15).astype(np.float32)
_yy, _xx = np.mgrid[-15:16, -15:16]
_circ = (_xx**2 + _yy**2) <= 15**2
_CENT_OFF = np.stack([_xx[_circ], _yy[_circ]], axis=-1).astype(np.float32)  # [P, 2]

_N_ROT = 16
_SLAB_R = 22
_SLAB_S = 2 * _SLAB_R + 1


def _rotated_pair_indices():
    idx = np.zeros((_N_ROT, 2, 256, 2), np.int32)  # [bin, a/b, pair, (y, x)]
    for b in range(_N_ROT):
        th = 2.0 * np.pi * b / _N_ROT
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s], [s, c]], np.float32)
        for k in range(2):
            r = _BRIEF_PAIRS[:, k, :] @ R.T
            idx[b, k, :, 0] = np.clip(np.round(r[:, 1]).astype(np.int32) + _SLAB_R, 0, _SLAB_S - 1)
            idx[b, k, :, 1] = np.clip(np.round(r[:, 0]).astype(np.int32) + _SLAB_R, 0, _SLAB_S - 1)
    return idx


_ROT_IDX = _rotated_pair_indices()
_RIDX = (_ROT_IDX[..., 0] * _SLAB_S + _ROT_IDX[..., 1]).astype(np.int64)  # [B, 2, 256]
_CENT_W = np.zeros((_SLAB_S, _SLAB_S, 2), np.float32)
_CENT_W[_SLAB_R - 15 : _SLAB_R + 16, _SLAB_R - 15 : _SLAB_R + 16, 0] = np.where(_circ, _xx, 0)
_CENT_W[_SLAB_R - 15 : _SLAB_R + 16, _SLAB_R - 15 : _SLAB_R + 16, 1] = np.where(_circ, _yy, 0)


def orb_descriptors(img: torch.Tensor, pts: torch.Tensor):
    """[N, 8] packed 256-bit rotated-BRIEF descriptors (uint32 values held in
    int64) + validity (full pattern support inside the image)."""
    H, W = img.shape
    dev = img.device
    N = pts.shape[0]
    imgp = torch.nn.functional.pad(img[None, None], (_SLAB_R, _SLAB_R + 1, _SLAB_R, _SLAB_R + 1))[0, 0]
    ai = torch.round(pts).to(torch.int64)
    ay = torch.clamp(ai[:, 1], 0, H - 1)
    ax = torch.clamp(ai[:, 0], 0, W - 1)
    r = torch.arange(_SLAB_S, device=dev)
    slab = imgp[(ay[:, None] + r)[:, :, None], (ax[:, None] + r)[:, None, :]]  # [N, S, S]
    cw = torch.as_tensor(_CENT_W, device=dev)
    m10 = torch.einsum("nyx,yx->n", slab, cw[..., 0])
    m01 = torch.einsum("nyx,yx->n", slab, cw[..., 1])
    theta = torch.atan2(m01, m10)
    bin_f = torch.round(theta / (2.0 * np.pi) * _N_ROT).to(torch.int64) % _N_ROT
    flat = slab.reshape(N, -1)
    ridx = torch.as_tensor(_RIDX, device=dev)[bin_f]  # [N, 2, 256]
    Ia = torch.gather(flat, 1, ridx[:, 0])
    Ib = torch.gather(flat, 1, ridx[:, 1])
    bits = (Ia < Ib).to(torch.int64).reshape(N, 8, 32)
    packed = torch.sum(bits << torch.arange(32, dtype=torch.int64, device=dev), dim=-1)
    valid = (
        (pts[:, 0] >= _SLAB_R) & (pts[:, 0] < W - _SLAB_R)
        & (pts[:, 1] >= _SLAB_R) & (pts[:, 1] < H - _SLAB_R)
    )
    return packed, valid


def desc_to_u8(packed: torch.Tensor) -> torch.Tensor:
    """[N, 8] packed words -> [N, 32] int32 bytes, little-endian per word."""
    shifts = torch.arange(4, dtype=torch.int64, device=packed.device) * 8
    b = (packed[..., None] >> shifts) & 0xFF
    return b.reshape(packed.shape[0], 32).to(torch.int32)


# Rows of `db` per step of the distance matrix: bounds the [N, chunk, 32]
# uint8 intermediates (16 MB each at N = 512) whatever the arena size M.
_HAMMING_CHUNK = 1024


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Bit count of every uint8 element (SWAR within the byte)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def hamming_distance_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[N, 32] x [M, 32] descriptor bytes (any integer dtype holding 0..255,
    as `desc_to_u8` gives and the arena stores) -> [N, M] int32 Hamming
    distances. Packed words go through `desc_to_u8` first: the distance does
    not depend on the packing."""
    a = da.to(torch.uint8)[:, None, :]
    b = db.to(torch.uint8)
    out = [
        torch.sum(_popcount_u8(a ^ b[j : j + _HAMMING_CHUNK][None]), dim=-1, dtype=torch.int32)
        for j in range(0, b.shape[0], _HAMMING_CHUNK)
    ]
    return torch.cat(out, dim=1)


def match_descriptors(da, va, db, vb, max_dist: int = 64, ratio: float = 0.9):
    """Mutual nearest-neighbour Hamming matching with the Lowe ratio test.
    Ties resolve to the lowest index, as `argmin` does in both packages.

    Returns (idx_b [N] int64 — the match in b for each a, or -1; mask [N])."""
    big = 10_000
    d = hamming_distance_matrix(da, db)
    d = torch.where(va[:, None] & vb[None, :], d, big)
    # argmin, not torch.min: the index torch.min gives for a repeated minimum
    # is not specified, argmin's is the first.
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    is_best = torch.arange(d.shape[1], device=d.device)[None, :] == best[:, None]
    second_d = torch.min(torch.where(is_best, big, d), dim=1).values
    mutual = torch.argmin(d, dim=0)[best] == torch.arange(d.shape[0], device=d.device)
    ok = (best_d <= max_dist) & (best_d.to(torch.float32) < ratio * second_d.to(torch.float32)) & mutual & va
    return torch.where(ok, best, -1), ok
