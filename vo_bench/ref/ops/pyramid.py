"""Image pyramid, Scharr gradients, whole-image shift alignment.

Copy of the port's `ops/pyramid.py`. Convolutions are
separable shift-and-add over edge-replicated views, in the same tap order
as the reference, so values agree to float32 rounding. Every function takes
[..., H, W] (leading batch dimensions ride along).
"""

from __future__ import annotations

import torch

# 5-tap binomial (Gaussian approx) used for pyramid antialiasing.
_K5 = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
# Scharr 3-tap pair: smoothing [3, 10, 3]/16 and central difference [-1, 0, 1]/2.
_SCHARR_S = [3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0]
_SCHARR_D = [-0.5, 0.0, 0.5]


def _edge_index(n: int, pad: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(-pad, n + pad, device=device), 0, n - 1)


def _sep_conv(img: torch.Tensor, kh, kw) -> torch.Tensor:
    """Separable 2-D convolution with edge replication; zero taps skipped."""
    H, W = img.shape[-2], img.shape[-1]
    ph, pw = len(kh) // 2, len(kw) // 2
    x = img.index_select(-2, _edge_index(H, ph, img.device))
    acc = None
    for i, w in enumerate(kh):
        if w == 0.0:
            continue
        t = x[..., i : i + H, :] * w
        acc = t if acc is None else acc + t
    x = acc.index_select(-1, _edge_index(W, pw, img.device))
    acc = None
    for j, w in enumerate(kw):
        if w == 0.0:
            continue
        t = x[..., :, j : j + W] * w
        acc = t if acc is None else acc + t
    return acc


def _decimate(x: torch.Tensor, dim: int) -> torch.Tensor:
    """out[i] = sum_k K5[k] * in[clip(2i + k - 2)] along `dim`."""
    n = x.shape[dim]
    n_out = (n + 1) // 2
    base = 2 * torch.arange(n_out, device=x.device)
    acc = None
    for k, w in enumerate(_K5):
        t = x.index_select(dim, torch.clamp(base + (k - 2), 0, n - 1)) * w
        acc = t if acc is None else acc + t
    return acc


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Blur + stride-2 decimation with edge replication (one pyramid step)."""
    return _decimate(_decimate(img, -2), -1)


def build_pyramid(img: torch.Tensor, levels: int) -> tuple:
    """Returns `levels` images, level 0 = full resolution."""
    out = [img.to(torch.float32)]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return tuple(out)


def scharr_gradients(img: torch.Tensor):
    """(d/du, d/dv) image gradients in intensity/pixel units."""
    return _sep_conv(img, _SCHARR_S, _SCHARR_D), _sep_conv(img, _SCHARR_D, _SCHARR_S)


def build_pyramid_levels(img: torch.Tensor, levels: int):
    """((img, img, img), ...) per level: the program's pyramid layout
    (img, gx, gy) with gx = gy = img, as its kernel leg builds it (the KLT
    takes template gradients itself), so that a copy of its state fits."""
    return tuple((p, p, p) for p in build_pyramid(img, levels))


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    k = [1.0 / (2 * radius + 1)] * (2 * radius + 1)
    return _sep_conv(img, k, k)


def global_shift_zncc(prev: torch.Tensor, curr: torch.Tensor, radius: int = 8):
    """Dominant whole-image translation prev->curr by dense ZNCC over integer
    2-D shifts in [-radius, radius]^2 (run it on the coarsest level).

    Returns (shift [2] = (du, dv) in this level's pixels, score). All shifts
    are scored at once over strided windows of `curr`."""
    H, W = prev.shape
    a = prev[radius : H - radius, radius : W - radius]
    a = a - torch.mean(a)
    ha, wa = a.shape
    an = torch.sqrt(torch.sum(a * a) + 1e-6)
    # win[dy, dx] = curr[dy : dy + ha, dx : dx + wa]  (shift = (dy, dx) - radius)
    win = curr.unfold(0, ha, 1).unfold(1, wa, 1)  # [2r+1, 2r+1, ha, wa]
    b = win - torch.mean(win, dim=(-2, -1), keepdim=True)
    num = torch.einsum("yx,ijyx->ij", a, b)
    scores = (num / (an * torch.sqrt(torch.sum(b * b, dim=(-2, -1)) + 1e-6))).reshape(-1)
    best = torch.argmax(scores)
    n = 2 * radius + 1
    dv = (best // n).to(torch.float32) - radius
    du = (best % n).to(torch.float32) - radius
    return torch.stack([du, dv]), scores[best]
