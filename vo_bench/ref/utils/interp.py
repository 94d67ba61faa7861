"""Bilinear image sampling with validity masks, and ZNCC.

Copy of the port's `utils/interp.py`. `bilinear_sample`
keeps the reference's exact conventions, which downstream parity depends on
(so it is written out rather than delegated to `F.grid_sample`):
  - the integer index is clamped to [0, W-2] / [0, H-2] but the fraction is
    not recomputed, so u = W-1 exactly reads column W-2 (fraction 0);
  - the mask is inclusive at both ends of [border, W-1-border].
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, pts: torch.Tensor, valid_border: float = 0.0):
    """Sample `img` ([H, W]) at `pts` ([..., 2], (u, v) pixel coords).

    Returns (values [...], mask [...]); mask is False where the 2x2 support
    leaves the image (callers gate on it)."""
    H, W = img.shape[-2], img.shape[-1]
    u = pts[..., 0]
    v = pts[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    mask = (
        (u >= valid_border)
        & (v >= valid_border)
        & (u <= W - 1 - valid_border)
        & (v <= H - 1 - valid_border)
    )
    iu = torch.clamp(u0.to(torch.int64), 0, W - 2)
    iv = torch.clamp(v0.to(torch.int64), 0, H - 2)
    flat = img.reshape(-1)
    base = iv * W + iu
    I00 = flat[base]
    I01 = flat[base + 1]
    I10 = flat[base + W]
    I11 = flat[base + W + 1]
    top = I00 + du * (I01 - I00)
    bot = I10 + du * (I11 - I10)
    return top + dv * (bot - top), mask


def zncc(a: torch.Tensor, b: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """Zero-mean normalized cross-correlation along `dim`."""
    am = a - torch.mean(a, dim=dim, keepdim=True)
    bm = b - torch.mean(b, dim=dim, keepdim=True)
    num = torch.sum(am * bm, dim=dim)
    den = torch.sqrt(torch.sum(am * am, dim=dim) * torch.sum(bm * bm, dim=dim) + eps)
    return num / den
