"""Recursive inverse-depth filtering (SVO / Vogiatzis style), batched over seeds.

Copy of the port's `ops/depth_filter.py`: per seed an
inverse-depth Gaussian (mu, sigma2) and Beta inlier/outlier pseudo-counts
(a, b), updated by the Gaussian x Uniform mixture; the measurement variance
comes from a one-pixel disparity error. Everything is [M]-batched and
branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SQRT_2PI = 2.5066282746310002


class DepthSeeds(NamedTuple):
    mu: torch.Tensor  # [M] inverse-depth mean
    sigma2: torch.Tensor  # [M] inverse-depth variance
    a: torch.Tensor  # [M] Beta inlier count
    b: torch.Tensor  # [M] Beta outlier count
    z_range: torch.Tensor  # [M] inverse-depth search range (1/z_min)


def init_seeds(depth_init: torch.Tensor, depth_min: float = 0.5) -> DepthSeeds:
    """Seeds at a prior mean depth with maximal uncertainty (sigma = z_range / 6)."""
    z_range = 1.0 / depth_min
    mu = 1.0 / torch.clamp(depth_init, min=1e-3)
    sigma = z_range / 6.0
    return DepthSeeds(
        mu=mu,
        sigma2=torch.full_like(mu, sigma * sigma),
        a=torch.full_like(mu, 10.0),
        b=torch.full_like(mu, 10.0),
        z_range=torch.full_like(mu, z_range),
    )


def update_gaussian(mu, sigma2, x, tau2):
    """Product-of-Gaussians fusion of belief (mu, sigma2) with measurement
    (x, tau2). Returns (mean, variance)."""
    denom = sigma2 + tau2
    return (sigma2 * x + tau2 * mu) / denom, sigma2 * tau2 / denom


def update_seeds(seeds: DepthSeeds, x: torch.Tensor, tau2: torch.Tensor, mask: torch.Tensor) -> DepthSeeds:
    """Gaussian x Uniform Beta update. x [M] inverse-depth measurement, tau2
    [M] its variance; lanes where mask is False keep their state."""
    mu, sigma2, a, b, z_range = seeds
    norm_s2 = sigma2 + tau2
    s2 = 1.0 / (1.0 / torch.clamp(sigma2, min=1e-12) + 1.0 / torch.clamp(tau2, min=1e-12))
    m = s2 * (mu / torch.clamp(sigma2, min=1e-12) + x / torch.clamp(tau2, min=1e-12))

    # Likelihood under the inlier Gaussian and the outlier Uniform.
    gauss = torch.exp(-0.5 * (x - mu) ** 2 / torch.clamp(norm_s2, min=1e-12)) / (
        _SQRT_2PI * torch.sqrt(torch.clamp(norm_s2, min=1e-12))
    )
    C1 = a / (a + b) * gauss
    C2 = b / (a + b) * (1.0 / torch.clamp(z_range, min=1e-6))
    norm = torch.clamp(C1 + C2, min=1e-30)
    C1 = C1 / norm
    C2 = C2 / norm

    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0)) + C2 * a * (a + 1.0) / (
        (a + b + 1.0) * (a + b + 2.0)
    )

    mu_new = C1 * m + C2 * mu
    sigma2_new = torch.clamp(C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu) - mu_new * mu_new, min=1e-12)

    # Moment-matched Beta posterior: a' = (e - f) / (f - e / f).
    denom_f = f - e / torch.clamp(f, min=1e-12)
    denom_f = torch.where(torch.abs(denom_f) < 1e-12, 1e-12, denom_f)
    a_new = torch.clamp((e - f) / denom_f, 1e-3, 1e4)
    b_new = torch.clamp(a_new * (1.0 - f) / torch.clamp(f, min=1e-12), 1e-3, 1e4)

    def keep(old, new):
        return torch.where(mask, new, old)

    return DepthSeeds(keep(mu, mu_new), keep(sigma2, sigma2_new), keep(a, a_new), keep(b, b_new), z_range)


def measurement_tau2(z: torch.Tensor, t_norm, fx: float, px_noise: float = 1.0) -> torch.Tensor:
    """Inverse-depth variance of a triangulation at depth z [M] over baseline
    t_norm, from a one-pixel epipolar match error."""
    z = torch.clamp(z, min=1e-3)
    t_norm = torch.as_tensor(t_norm, dtype=z.dtype, device=z.device)
    tau_z = z * z * px_noise / torch.clamp(fx * t_norm, min=1e-6)
    tau_rho = 0.5 * torch.abs(1.0 / torch.clamp(z - tau_z, min=1e-3) - 1.0 / (z + tau_z))
    return tau_rho * tau_rho


def converged(seeds: DepthSeeds, thresh_ratio: float = 200.0) -> torch.Tensor:
    """A seed is accepted once its inverse-depth std is below range / thresh_ratio."""
    return torch.sqrt(seeds.sigma2) < seeds.z_range / thresh_ratio


def inlier_probability(seeds: DepthSeeds) -> torch.Tensor:
    return seeds.a / (seeds.a + seeds.b)
