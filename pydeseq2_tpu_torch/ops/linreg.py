"""Closed-form batched least squares: mu init, rough and moment dispersions.

Port of ``pydeseq2_tpu/ops/linreg.py``. The design X (N, P) is shared by
every gene, so one ``pinv(X)`` turns the per-gene OLS fan-out into one
(G, N) @ (N, P) product. These products stay plain PyTorch (``torch.matmul``
in full f32), as the JAX package left them to XLA outside any kernel.
"""

from __future__ import annotations

import torch


def fit_lin_mu_batch(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    min_mu: float = 0.5,
) -> torch.Tensor:
    """(G, N) OLS estimate of the NB means, clamped below at ``min_mu``."""
    y = counts / size_factors[None, :]
    pinv = torch.linalg.pinv(design_matrix)  # (P, N)
    beta = y @ pinv.T
    mu_hat = size_factors[None, :] * (beta @ design_matrix.T)
    return torch.clamp(mu_hat, min=min_mu)


def fit_rough_dispersions_batch(
    normed_counts: torch.Tensor, design_matrix: torch.Tensor
) -> torch.Tensor:
    """(G,) residual-based rough dispersion estimates."""
    num_samples, num_vars = design_matrix.shape
    pinv = torch.linalg.pinv(design_matrix)
    y_hat = (normed_counts @ pinv.T) @ design_matrix.T
    y_hat = torch.clamp(y_hat, min=1.0)
    alpha_rde = (
        ((normed_counts - y_hat) ** 2 - y_hat) / ((num_samples - num_vars) * y_hat**2)
    ).sum(dim=1)
    return torch.clamp(alpha_rde, min=0.0)


def fit_moments_dispersions_batch(
    normed_counts: torch.Tensor, size_factors: torch.Tensor
) -> torch.Tensor:
    """(G,) method-of-moments dispersions (ddof=1 variance, NaN -> 0)."""
    n = normed_counts.shape[1]
    s_mean_inv = (1.0 / size_factors).mean()
    mu = normed_counts.mean(dim=1)
    sigma = ((normed_counts - mu[:, None]) ** 2).sum(dim=1) / (n - 1)
    raw = (sigma - s_mean_inv * mu) / mu**2
    return torch.nan_to_num(raw)
