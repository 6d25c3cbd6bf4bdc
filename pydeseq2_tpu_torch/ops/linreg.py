"""Closed-form batched least squares: mu init, rough and moment dispersions.

Port of ``pydeseq2_tpu/ops/linreg.py``. The design X (N, P) is shared by
every gene, so one ``pinv(X)`` turns the per-gene OLS fan-out into one
(G, N) @ (N, P) product.

Kernel (``csrc/mom.cu``): :func:`mom_and_mu_coef` replaces the three
programs as the pipelines chain them (``pydeseq2_tpu/ops/linreg.py:23,52,76``
behind ``fused.py:360-380`` and ``fused_stream.py:287-305,576-594``). One
warp per gene: a first pass over the normalised row forms the OLS
coefficients against pinv(X) and the row mean, a second the rough and
moment sums and, when asked, mu; pinv(X) and X are read through L1/L2. It
reads the counts once and writes mu (24 + 24 MB at 100 x 60000 f32), its
bytes bound on the H100. The plain versions below (CPU tensors only) are
the JAX package's expressions.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch import kernels


def ols_pinv(design_matrix: torch.Tensor) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of the design matrix (P, N), computed once."""
    return torch.linalg.pinv(design_matrix)


def fit_lin_mu_batch(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    min_mu: float = 0.5,
) -> torch.Tensor:
    """(G, N) OLS estimate of the NB means, clamped below at ``min_mu``."""
    beta = (counts / size_factors[None, :]) @ ols_pinv(design_matrix).T
    return mu_from_coef(beta, size_factors, design_matrix, min_mu)


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


def mu_from_coef(beta_coef: torch.Tensor, size_factors: torch.Tensor, design_matrix: torch.Tensor,
                 min_mu: float) -> torch.Tensor:
    """(G, N) linear mu ``max(sf * (beta_coef @ X.T), min_mu)`` from the OLS
    coefficients (``pydeseq2_tpu/fused_stream.py:308-314``)."""
    return torch.clamp(size_factors[None, :] * (beta_coef @ design_matrix.T), min=min_mu)


def _mom_plain(counts, size_factors, X, pinv, min_mu, want_mu, normed=False):
    y = counts if normed else counts / size_factors[None, :]
    rough = fit_rough_dispersions_batch(y, X)
    moments = fit_moments_dispersions_batch(y, size_factors)
    coef = y @ pinv.T
    return rough, moments, coef, mu_from_coef(coef, size_factors, X, min_mu) if want_mu else None


def _mom_cuda(counts, size_factors, X, pinv, min_mu, want_mu, normed=False):
    G, N = counts.shape
    P = X.shape[1]
    dev = counts.device
    s_mean_inv = (1.0 / size_factors).mean().reshape(1)
    ops = [t.contiguous() for t in (counts, size_factors, X, pinv, s_mean_inv)]
    counts, size_factors, X, pinv, s_mean_inv = ops
    rough = torch.empty(G, dtype=counts.dtype, device=dev)
    moments = torch.empty_like(rough)
    coef = torch.empty((G, P), dtype=counts.dtype, device=dev)
    mu = torch.empty((G, N), dtype=counts.dtype, device=dev) if want_mu else None
    kernels.check_cuda_operands("mom", *ops, rough, moments, coef, mu)
    kernels.check_p("mom", P)
    if pinv.shape != (P, N):
        raise ValueError(f"mom: pinv has shape {tuple(pinv.shape)}, expected ({P}, {N})")
    kernels.launch(
        "mom",
        [
            int(counts.dtype == torch.float64), P, G, N,
            counts.data_ptr(), size_factors.data_ptr(), X.data_ptr(), pinv.data_ptr(), s_mean_inv.data_ptr(),
            float(min_mu), int(normed), rough.data_ptr(), moments.data_ptr(), coef.data_ptr(), kernels.ptr(mu),
        ],
        dev,
    )
    return rough, moments, coef, mu


def mom_and_mu_coef(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    pinv: torch.Tensor,
    min_mu: float = 0.5,
    want_mu: bool = True,
    normed: bool = False,
):
    """The method-of-moments inputs and the linear mu init in one pass:
    ``(rough (G,), moments (G,), beta_coef (G, P), mu_hat (G, N) or None)``.

    With y = counts / sf: ``rough`` is :func:`fit_rough_dispersions_batch`,
    ``moments`` :func:`fit_moments_dispersions_batch` (both unclamped),
    ``beta_coef = y @ pinv.T`` the OLS coefficients, and with ``want_mu``
    ``mu_hat = max(sf * (beta_coef @ X.T), min_mu)``, which is
    :func:`fit_lin_mu_batch`. ``pinv`` is :func:`ols_pinv` of the design.
    With ``normed``, ``counts`` already holds y (the class API's MoM
    methods receive normalised counts); ``size_factors`` then enter only
    ``moments`` (mean(1/sf)) and mu. CUDA tensors launch the ``mom``
    kernel; CPU tensors take the plain functions.
    """
    fn = _mom_cuda if counts.is_cuda else _mom_plain
    return fn(counts, size_factors, design_matrix, pinv, min_mu, want_mu, normed)
