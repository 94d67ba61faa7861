"""Robust-estimation utilities: Huber weights, masked histograms and medians.

Copy of the port's `utils/robust.py`; fixed shapes, no
host synchronisation.
"""

from __future__ import annotations

import torch


def huber_weight(r_abs: torch.Tensor, delta: float) -> torch.Tensor:
    """w = 1 if |r| <= delta else delta/|r| (IRLS weight for Huber loss)."""
    return torch.where(r_abs <= delta, 1.0, delta / torch.clamp(r_abs, min=1e-12))


def masked_histogram(values: torch.Tensor, mask: torch.Tensor, lo: float, hi: float, bins: int):
    """Fixed-bin histogram of masked values ([N] -> [bins] float32)."""
    idx = torch.clamp(((values - lo) / (hi - lo) * bins).to(torch.int64), 0, bins - 1)
    out = torch.zeros(bins, dtype=torch.float32, device=values.device)
    return out.scatter_add_(0, idx, mask.to(torch.float32))


def masked_median_histogram(values: torch.Tensor, mask: torch.Tensor, lo: float, hi: float, bins: int):
    """Approximate median: the bin centre whose cumulative count first reaches
    half the total."""
    hist = masked_histogram(values, mask, lo, hi, bins)
    cdf = torch.cumsum(hist, dim=0)
    med_bin = torch.argmax((cdf >= 0.5 * torch.sum(hist)).to(torch.int32))
    width = (hi - lo) / bins
    return lo + (med_bin.to(torch.float32) + 0.5) * width


